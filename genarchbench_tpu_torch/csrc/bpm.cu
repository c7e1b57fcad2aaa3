// Myers 1999 blocked bit-vector edit distance (bpm-edit): a wavefront
// over text steps, one lane per pattern word.
//
// Replaces: genarchbench_tpu/kernels/bpm_pallas.py::_kernel (the Pallas
// TPU kernel launched at bpm_pallas.py:98), which has the semantics of
// kernels/bpm.py::_bpm_distance_device and of the reference's
// BPM_ADVANCE_BLOCK (bpm/edit/edit_bpm.c:47-67).
//
// What bounds it on this card: latency and instruction count, not
// bytes.  Each text step advances W = ceil(plen/32) words through ~22
// dependent 32-bit logic and add operations, and word w+1 needs word w's
// carries (PHout, MHout) of the same step.  The inputs (text codes as
// int8, PEQ masks) are a few MB, read once.  One thread per pair walks
// a chain of T x W x ~22 dependent operations, and 4096 pairs fill a
// tenth of the SMs.  Spread over lanes, a warp's chain is T/4 + W
// iterations of one shuffle and four word-steps; the instructions that
// move carries and codes between lanes cost as much as the recurrence,
// and the last warps of a launch set its tail.
//
// What the design does about it (bpm_wavefront<S>, W <= 32): a pair
// takes a segment of S lanes, S the power of two at or above W, so a
// warp holds 32/S pairs.  Lane w keeps Pv and Mv of word w in registers
// and the word's PEQ masks in a shared table [code][lane], loaded once,
// so a step's mask is one shared load and not a chain of selects.  At
// iteration k lane w advances the kU = 4 text steps kU(k-w) .. kU(k-w)+3:
// their carries and text codes are what lane w-1 produced one iteration
// earlier, packed as 4 ph bits | 4 mh bits << 4 | 4 code nibbles << 8
// into ONE __shfl_up_sync (width S, so no carry crosses a segment), so
// the shuffle, the loop and the activity test are paid once for four
// steps.  Lane 0 of a segment takes PHin = 1, MHin = 0 and the codes,
// which a first kernel (bpm_pack_codes) packs four steps to 16 bits,
// from a ring of registers it fills kAhead iterations ahead.  Steps past
// the text of a pair still run in its last iteration, but they feed only
// later steps of later words and never reach the score: the lane of
// word W-1 counts the ph and mh bits of the steps below tlen.  A warp
// runs ceil(max tlen / 4) + W - 1 iterations.
// Wider patterns (W > 32) take bpm_generic, one thread per pair with Pv
// and Mv in a device scratch laid out (W, B) so a warp's accesses
// coalesce.  Text is (T, B) int8 and PEQ (W, 4, B) uint32, pairs-minor
// like the TPU kernel's transposed (T, 8, 128) tiles
// (bpm_pallas.py:136-139).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kU = 4;        // text steps a lane advances per iteration
constexpr int kAhead = 4;    // iterations lane 0 of a segment loads ahead
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// text code of step t of pair b, clamped to 0..4 (codes 0..3 select a
// PEQ column; 4 (N) and anything else match nothing), 0 past the text
__device__ __forceinline__ uint32_t code_at(const int8_t* __restrict__ text,
                                            int t, int tl, int b, int B) {
  return t < tl ? min((uint32_t)(uint8_t)__ldg(text + (size_t)t * B + b), 4u)
                : 0u;
}

// codes (ceil(T / kU), B) uint16: the clamped codes of steps kU j ..
// kU j + kU - 1 of pair b as nibbles, step kU j lowest, 0 past T
__global__ void __launch_bounds__(kThreads)
bpm_pack_codes(const int8_t* __restrict__ text, uint16_t* __restrict__ codes,
               int B, int T) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  for (int j = blockIdx.y; j * kU < T; j += gridDim.y) {
    uint32_t v = 0u;
#pragma unroll
    for (int u = 0; u < kU; ++u) v |= code_at(text, j * kU + u, T, b, B) << (4 * u);
    codes[(size_t)j * B + b] = (uint16_t)v;
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
bpm_wavefront(const uint32_t* __restrict__ peq,
              const uint16_t* __restrict__ codes,
              const int32_t* __restrict__ plen,
              const int32_t* __restrict__ tlen, int32_t* __restrict__ out,
              int B, int T, int W) {
  // [warp][code][lane]: PEQ mask of the lane's word for codes 0..3, 0 for 4
  __shared__ uint32_t eqtab[kThreads / 32][5][32];
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int w = lane % S;                        // this lane's word
  const int b = warp * (32 / S) + lane / S;      // this lane's pair
  const bool valid = b < B;
  const int tl = valid ? min(tlen[b], T) : 0;
  const int maxtl = __reduce_max_sync(kFull, tl);
  const int iters = maxtl > 0 ? (maxtl + kU - 1) / kU + W - 1 : 0;

  uint32_t* eq = &eqtab[threadIdx.x >> 5][0][lane];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    eq[32 * c] = valid && w < W ? __ldg(peq + ((size_t)w * 4 + c) * B + b) : 0u;
  eq[32 * 4] = 0u;
  __syncwarp();
  const int pl = valid ? plen[b] : 1;
  const uint32_t mask = w == W - 1 ? 1u << ((pl - 1) & 31) : 0x80000000u;
  uint32_t pv = 0xFFFFFFFFu, mv = 0u;
  uint32_t send = 0u;   // this lane's last iteration: ph bits | mh << 4 | codes << 8
  int score = pl;

  // lane 0: the packed codes of iterations k .. k + kAhead - 1.  Steps
  // past the text of the pair read what the text holds there (0 past T):
  // they never reach the score.
  const int jload = w == 0 && valid ? (T + kU - 1) / kU : 0;
  const uint16_t* next = codes + b;   // lane 0: iteration j's codes at next[j * B]
  uint32_t ring[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) ring[j] = j < jload ? __ldg(next + (size_t)j * B) : 0u;
  next += (size_t)kAhead * B;

  for (int k0 = 0; k0 < iters; k0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int k = k0 + j;
      if (k >= iters) break;
      uint32_t recv = __shfl_up_sync(kFull, send, 1, S);
      if (w == 0) {
        recv = 0xFu | ring[j] << 8;
        ring[j] = k + kAhead < jload ? __ldg(next) : 0u;
        next += B;
      }
      const int t0 = (k - w) * kU;   // the first text step this lane advances
      if (w < W && t0 >= 0 && t0 < tl) {
        uint32_t bits = 0u;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const Step s = advance(eq[32 * ((recv >> (8 + 4 * u)) & 15u)], pv, mv,
                                 (recv >> u) & 1u, (recv >> (4 + u)) & 1u, mask);
          pv = s.pv;
          mv = s.mv;
          bits |= s.ph_out << u | s.mh_out << (4 + u);
        }
        send = bits | (recv & 0xFFFF00u);
        // read at word W-1 only: the steps below tlen
        const uint32_t m = (1u << min(tl - t0, kU)) - 1u;
        score += __popc(bits & m) - __popc((bits >> 4) & m);
      }
    }
  }
  if (valid && w == W - 1) out[b] = score;
}

// Any W: Pv at scratch[w * B + b], Mv at scratch[(W + w) * B + b].
__global__ void __launch_bounds__(kThreads)
bpm_generic(const uint32_t* __restrict__ peq, const int8_t* __restrict__ text,
            const int32_t* __restrict__ plen, const int32_t* __restrict__ tlen,
            int32_t* __restrict__ out, uint32_t* __restrict__ scratch, int B,
            int T, int W) {
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
    const uint32_t c = code_at(text, t, tl, b, B);
    uint32_t ph_in = 1u, mh_in = 0u;
    for (int w = 0; w < W; ++w) {
      const uint32_t e = c < 4 ? __ldg(peq + ((size_t)w * 4 + c) * B + b) : 0u;
      Step s = advance(e, pv[(size_t)w * B], mv[(size_t)w * B], ph_in, mh_in,
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

template <int S>
void launch(const uint32_t* peq, const uint16_t* codes, const int32_t* plen,
            const int32_t* tlen, int32_t* out, int B, int T, int W,
            cudaStream_t stream) {
  const long long threads = (long long)(B + 32 / S - 1) / (32 / S) * 32;
  bpm_wavefront<S><<<(unsigned)((threads + kThreads - 1) / kThreads),
                     kThreads, 0, stream>>>(peq, codes, plen, tlen, out, B, T,
                                            W);
}

}  // namespace

// peq (W, 4, B) uint32; text (T, B) int8 codes (0-3 bases, 4 = N);
// plen, tlen (B,) int32 (steps past T are not taken); out (B,) int32
// distances.  S is the segment width (a power of two, W <= S <= 32) of
// the wavefront kernel, which first packs the text into scratch
// (ceil(T / 4), B) uint16, or 0 for the generic kernel, which uses
// scratch (2, W, B) uint32.  Returns cudaGetLastError().
extern "C" int genarch_bpm(const void* peq_, const void* text_,
                           const void* plen_, const void* tlen_, void* out_,
                           void* scratch_, int B, int T, int W, int S,
                           void* stream_) {
  const auto* peq = static_cast<const uint32_t*>(peq_);
  const auto* text = static_cast<const int8_t*>(text_);
  const auto* plen = static_cast<const int32_t*>(plen_);
  const auto* tlen = static_cast<const int32_t*>(tlen_);
  auto* out = static_cast<int32_t*>(out_);
  auto stream = static_cast<cudaStream_t>(stream_);
  if (B <= 0) return cudaGetLastError();
  const auto* codes = static_cast<const uint16_t*>(scratch_);
  if (S > 0 && T > 0) {
    bpm_pack_codes<<<dim3((B + kThreads - 1) / kThreads,
                          min((T + kU - 1) / kU, 65535)),
                     kThreads, 0, stream>>>(text, static_cast<uint16_t*>(scratch_),
                                            B, T);
  }
  switch (S) {
    case 1: launch<1>(peq, codes, plen, tlen, out, B, T, W, stream); break;
    case 2: launch<2>(peq, codes, plen, tlen, out, B, T, W, stream); break;
    case 4: launch<4>(peq, codes, plen, tlen, out, B, T, W, stream); break;
    case 8: launch<8>(peq, codes, plen, tlen, out, B, T, W, stream); break;
    case 16: launch<16>(peq, codes, plen, tlen, out, B, T, W, stream); break;
    case 32: launch<32>(peq, codes, plen, tlen, out, B, T, W, stream); break;
    default:
      bpm_generic<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          peq, text, plen, tlen, out, static_cast<uint32_t*>(scratch_), B, T,
          W);
  }
  return cudaGetLastError();
}
