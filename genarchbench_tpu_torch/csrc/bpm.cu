// Myers 1999 blocked bit-vector edit distance (bpm-edit), one thread
// per pair.
//
// Replaces: genarchbench_tpu/kernels/bpm_pallas.py::_kernel (the Pallas
// TPU kernel launched at bpm_pallas.py:98), which has the semantics of
// kernels/bpm.py::_bpm_distance_device and of the reference's
// BPM_ADVANCE_BLOCK (bpm/edit/edit_bpm.c:47-67).
//
// What bounds it on this card: integer operations.  Each text step
// advances W = ceil(plen/32) words through ~22 dependent 32-bit logic
// and add operations; the inputs (2-bit text codes as int8, PEQ masks)
// are a few MB, read once.  The word chain inside a step is serial
// (PHout/MHout carry from word w to w+1), and the steps are serial, so
// one pair is one long dependency chain: the kernel is bound by issue
// latency long before it reaches the card's int32 rate unless enough
// pairs are in flight.
//
// What the design does about it: one thread per pair, so each thread
// walks its own chain and the card's parallelism is the batch.  Pv and
// Mv live in registers (W is a template parameter, 1..32, fully
// unrolled); wider patterns take the generic-W kernel, which keeps Pv
// and Mv in a device scratch laid out (W, B) so a warp's accesses
// coalesce.  Text is (T, B) int8 and PEQ (W, 4, B) uint32, both
// pairs-minor, so the loads of a warp coalesce like the TPU kernel's
// transposed (T, 8, 128) tiles (bpm_pallas.py:136-139).  Each thread
// loops to its own text length, so no padding steps run.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Step {
  uint32_t pv, mv, ph_out, mh_out;
};

// One word of the advance-block recurrence (bpm.py:90-107).
__device__ __forceinline__ Step advance(uint32_t eq, uint32_t pv,
                                        uint32_t mv, uint32_t ph_in,
                                        uint32_t mh_in, uint32_t mask) {
  uint32_t xv = eq | mv;
  uint32_t eq_ = eq | mh_in;
  uint32_t xh = (((eq_ & pv) + pv) ^ pv) | eq_;
  uint32_t ph = mv | ~(xh | pv);
  uint32_t mh = pv & xh;
  Step s;
  s.ph_out = (ph & mask) != 0u;
  s.mh_out = (mh & mask) != 0u;
  ph = (ph << 1) | ph_in;
  mh = (mh << 1) | mh_in;
  s.pv = mh | ~(xv | ph);
  s.mv = ph & xv;
  return s;
}

__device__ __forceinline__ uint32_t peq_of(const uint32_t* __restrict__ peq,
                                           int w, int c, int b, int B) {
  // codes 0..3 select a column; 4 (N) and anything else match nothing
  return (c >= 0 && c < 4) ? __ldg(peq + ((size_t)w * 4 + c) * B + b) : 0u;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
bpm_kernel(const uint32_t* __restrict__ peq, const int8_t* __restrict__ text,
           const int32_t* __restrict__ plen, const int32_t* __restrict__ tlen,
           int32_t* __restrict__ out, int B, int T) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t pv[W], mv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    pv[w] = 0xFFFFFFFFu;
    mv[w] = 0u;
  }
  const int pl = plen[b];
  const int tl = min(tlen[b], T);
  const uint32_t top = 1u << ((pl - 1) & 31);
  int score = pl;
  for (int t = 0; t < tl; ++t) {
    const int c = text[(size_t)t * B + b];
    uint32_t ph_in = 1u, mh_in = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      Step s = advance(peq_of(peq, w, c, b, B), pv[w], mv[w], ph_in, mh_in,
                       w == W - 1 ? top : 0x80000000u);
      pv[w] = s.pv;
      mv[w] = s.mv;
      ph_in = s.ph_out;
      mh_in = s.mh_out;
    }
    score += (int)ph_in - (int)mh_in;
  }
  out[b] = score;
}

// Any W: Pv at scratch[w * B + b], Mv at scratch[(W + w) * B + b].
__global__ void __launch_bounds__(kThreads)
bpm_kernel_generic(const uint32_t* __restrict__ peq,
                   const int8_t* __restrict__ text,
                   const int32_t* __restrict__ plen,
                   const int32_t* __restrict__ tlen,
                   int32_t* __restrict__ out, uint32_t* __restrict__ scratch,
                   int B, int T, int W) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t* pv = scratch + b;
  uint32_t* mv = scratch + (size_t)W * B + b;
  for (int w = 0; w < W; ++w) {
    pv[(size_t)w * B] = 0xFFFFFFFFu;
    mv[(size_t)w * B] = 0u;
  }
  const int pl = plen[b];
  const int tl = min(tlen[b], T);
  const uint32_t top = 1u << ((pl - 1) & 31);
  int score = pl;
  for (int t = 0; t < tl; ++t) {
    const int c = text[(size_t)t * B + b];
    uint32_t ph_in = 1u, mh_in = 0u;
    for (int w = 0; w < W; ++w) {
      Step s = advance(peq_of(peq, w, c, b, B), pv[(size_t)w * B],
                       mv[(size_t)w * B], ph_in, mh_in,
                       w == W - 1 ? top : 0x80000000u);
      pv[(size_t)w * B] = s.pv;
      mv[(size_t)w * B] = s.mv;
      ph_in = s.ph_out;
      mh_in = s.mh_out;
    }
    score += (int)ph_in - (int)mh_in;
  }
  out[b] = score;
}

template <int W>
void launch(const uint32_t* peq, const int8_t* text, const int32_t* plen,
            const int32_t* tlen, int32_t* out, int B, int T,
            cudaStream_t stream) {
  bpm_kernel<W><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      peq, text, plen, tlen, out, B, T);
}

}  // namespace

#define GENARCH_BPM_CASE(N) \
  case N:                   \
    launch<N>(peq, text, plen, tlen, out, B, T, stream); \
    break;

// peq (W, 4, B) uint32; text (T, B) int8 codes (0-3 bases, 4 = N);
// plen, tlen (B,) int32 (steps past T are not taken); out (B,) int32
// distances.  scratch (2, W, B) uint32 is used only when W > 32.
// Returns cudaGetLastError().
extern "C" int genarch_bpm(const void* peq_, const void* text_,
                           const void* plen_, const void* tlen_, void* out_,
                           void* scratch_, int B, int T, int W,
                           void* stream_) {
  const uint32_t* peq = static_cast<const uint32_t*>(peq_);
  const int8_t* text = static_cast<const int8_t*>(text_);
  const int32_t* plen = static_cast<const int32_t*>(plen_);
  const int32_t* tlen = static_cast<const int32_t*>(tlen_);
  int32_t* out = static_cast<int32_t*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B <= 0) return cudaGetLastError();
  switch (W) {
    GENARCH_BPM_CASE(1) GENARCH_BPM_CASE(2) GENARCH_BPM_CASE(3)
    GENARCH_BPM_CASE(4) GENARCH_BPM_CASE(5) GENARCH_BPM_CASE(6)
    GENARCH_BPM_CASE(7) GENARCH_BPM_CASE(8) GENARCH_BPM_CASE(9)
    GENARCH_BPM_CASE(10) GENARCH_BPM_CASE(11) GENARCH_BPM_CASE(12)
    GENARCH_BPM_CASE(13) GENARCH_BPM_CASE(14) GENARCH_BPM_CASE(15)
    GENARCH_BPM_CASE(16) GENARCH_BPM_CASE(17) GENARCH_BPM_CASE(18)
    GENARCH_BPM_CASE(19) GENARCH_BPM_CASE(20) GENARCH_BPM_CASE(21)
    GENARCH_BPM_CASE(22) GENARCH_BPM_CASE(23) GENARCH_BPM_CASE(24)
    GENARCH_BPM_CASE(25) GENARCH_BPM_CASE(26) GENARCH_BPM_CASE(27)
    GENARCH_BPM_CASE(28) GENARCH_BPM_CASE(29) GENARCH_BPM_CASE(30)
    GENARCH_BPM_CASE(31) GENARCH_BPM_CASE(32)
    default:
      bpm_kernel_generic<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(peq, text, plen, tlen, out,
                                     static_cast<uint32_t*>(scratch_), B, T,
                                     W);
  }
  return cudaGetLastError();
}
