// fast-chain's anchor loop on the card: one warp a record, each walking
// its own anchors in order; one launch a plan.
//
// Replaces: no TPU kernel.  The JAX package runs the DP as tiled XLA ops
// (genarchbench_tpu/kernels/fast_chain.py::_fast_chain_device); the
// port's torch-op version of it (kernels/fast_chain.py::
// _fast_chain_device) is this kernel's plain version and still runs CPU
// tensors.  Its semantics are mm2-fast's scalar loop
// (fast-chain/src/host_kernel.cpp:803-866): anchor i scores each
// predecessor j in [st(i), i) that no test skips as min(dq, dr, span_i)
// - (c_lin + (log_dd >> 1)) + score(j); score(i) is the largest of
// those and span_i, its parent the largest j reaching it, or -1 where
// span_i is not beaten (the descending scan's strict sc > max_f).
//
// What bounds it on this card: the chain of a record's anchors, not
// bytes or operations.  Anchor i needs the final score of every
// predecessor in its window, so a record is a sequence of short steps
// (13 predecessors a window on average in the benchmark's sr records).
// Run as batched torch ops, each step of a plan is some 48 launches over
// (B, 128) lanes enqueued by the host, and the card does almost nothing
// in each.  The work (29 int32 operations a window cell, 21 bytes an
// anchor) is small against the card's peaks.
//
// What the design does about it: a warp takes one record and walks its
// anchors in order, so a launch does a whole plan and the card keeps
// thousands of records' chains in flight, one a warp, hiding each
// step's latency behind the others'.  For anchor i the lanes score the
// predecessors i-1-lane, i-33-lane, ... down to st(i), each lane keeping
// its best (ties keep the larger j, which it meets first), and a shuffle
// butterfly takes the warp's maximum, ties to the largest j.  The inputs
// of 32 anchors are loaded at once, a lane each, and broadcast by
// shuffles; their results are written back together.  A record's x, q
// and scores so far live in shared memory where a block's records fit
// in 48 KB (N <= 1024 at kWarps = 4); longer records read their
// predecessors from the input rows and their scores back from the
// output row in device memory.  Rows past a record's anchors hold score
// 0 and parent -1, as the torch version gives: anchors past n have an
// empty window and span 0, and cells past the plan's steps are filled.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;           // records a block
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Params {
  const int* __restrict__ x;       // (B, N) x's low word (uint32 bits)
  const int* __restrict__ q;       // (B, N) qi
  const int* __restrict__ span;    // (B, N) q_span
  const int* __restrict__ st;      // (B, N) window starts
  const int* __restrict__ mdxy;    // (B,) min(max_dist_x, max_dist_y)
  const int* __restrict__ bw;      // (B,)
  const float* __restrict__ avg;   // (B,) avg_qspan
  int* scores;                     // (B, N)
  int* parents;                    // (B, N)
  int B, N, steps;
};

// int32 arithmetic that wraps, as the torch version's does
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

template <bool kShared>
__global__ void __launch_bounds__(32 * kWarps)
fast_chain_kernel(Params p) {
  extern __shared__ int smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + w;
  if (b >= p.B) return;            // whole warps: no block-wide sync below
  const int N = p.N, steps = p.steps;
  const size_t row = static_cast<size_t>(b) * N;
  const int* xr = p.x + row;
  const int* qr = p.q + row;
  const int* spr = p.span + row;
  const int* str = p.st + row;
  int* sc_out = p.scores + row;
  int* pa_out = p.parents + row;
  // the record's store: x, q and the scores of its anchors so far
  int* sx = kShared ? smem + static_cast<size_t>(w) * 3 * N : nullptr;
  const int* xs = kShared ? sx : xr;
  const int* qs = kShared ? sx + N : qr;
  int* ss = kShared ? sx + 2 * N : sc_out;
  const int mdxy = p.mdxy[b], bw = p.bw[b];
  const float avg = p.avg[b];

  for (int i0 = 0; i0 < steps; i0 += 32) {
    const int ia = i0 + lane;
    int ax = 0, aq = 0, asp = 0, ast = 0;
    if (ia < steps) {
      ax = __ldg(xr + ia);
      aq = __ldg(qr + ia);
      asp = __ldg(spr + ia);
      ast = __ldg(str + ia);
      if (kShared) {
        sx[ia] = ax;
        sx[N + ia] = aq;
      }
    }
    __syncwarp();
    int my_sc = 0, my_pa = -1;
    const int m = min(32, steps - i0);
    for (int k = 0; k < m; ++k) {
      const int i = i0 + k;
      const int xi = __shfl_sync(kFull, ax, k);
      const int qi = __shfl_sync(kFull, aq, k);
      const int spi = __shfl_sync(kFull, asp, k);
      const int sti = __shfl_sync(kFull, ast, k);
      int best = spi, bj = -1;
      for (int j = i - 1 - lane; j >= sti; j -= 32) {
        const int dr = wsub(xi, xs[j]);   // the C's uint32 difference
        const int dq = wsub(qi, qs[j]);
        const int d = wsub(dr, dq);
        const int dd = d < 0 ? wsub(0, d) : d;
        if (dr == 0 || dq <= 0 || dq > mdxy || dd > bw) continue;
        // two separately rounded float32 products, truncated
        const int c_lin = __float2int_rz(
            __fmul_rn(__fmul_rn(__int2float_rn(dd), 0.01f), avg));
        const int log_dd = dd > 0 ? 31 - __clz(dd) : 0;
        const int sc = wadd(wsub(min(min(dq, dr), spi),
                                 wadd(c_lin, log_dd >> 1)), ss[j]);
        if (sc > best) {
          best = sc;
          bj = j;
        }
      }
      if (sti < i) {                      // the same on every lane
        for (int off = 16; off; off >>= 1) {
          const int ob = __shfl_xor_sync(kFull, best, off);
          const int oj = __shfl_xor_sync(kFull, bj, off);
          if (ob > best || (ob == best && oj > bj)) {
            best = ob;
            bj = oj;
          }
        }
      }
      if (lane == 0) ss[i] = best;
      if (lane == k) {
        my_sc = best;
        my_pa = bj;
      }
      __syncwarp();
    }
    if (ia < steps) {
      sc_out[ia] = my_sc;
      pa_out[ia] = my_pa;
    }
  }
  for (int i = steps + lane; i < N; i += 32) {
    sc_out[i] = 0;
    pa_out[i] = -1;
  }
}

}  // namespace

// One warp a record, kWarps records a block, on `stream`.  x, q, span, st
// (B, N) int32 planes, a row's anchors first; mdxy, bw (B,) int32, avg
// (B,) float32; scores, parents (B, N) int32, written whole.  The first
// `steps` anchors of each row are run.  smem: 0 to keep a record's store
// in device memory, else the block's store in shared memory, kWarps *
// 3 * N * 4 bytes.
// Returns the first CUDA error (0 on success).
extern "C" int genarch_fast_chain(const void* x, const void* q,
                                  const void* span, const void* st,
                                  const void* mdxy, const void* bw,
                                  const void* avg, void* scores,
                                  void* parents, int B, int N, int steps,
                                  int smem, void* stream_) {
  if (B <= 0) return cudaGetLastError();
  Params p{static_cast<const int*>(x),
           static_cast<const int*>(q),
           static_cast<const int*>(span),
           static_cast<const int*>(st),
           static_cast<const int*>(mdxy),
           static_cast<const int*>(bw),
           static_cast<const float*>(avg),
           static_cast<int*>(scores),
           static_cast<int*>(parents),
           B, N, steps};
  auto stream = static_cast<cudaStream_t>(stream_);
  const int blocks = (B + kWarps - 1) / kWarps;
  if (smem > 0)
    fast_chain_kernel<true><<<blocks, 32 * kWarps, smem, stream>>>(p);
  else
    fast_chain_kernel<false><<<blocks, 32 * kWarps, 0, stream>>>(p);
  return cudaGetLastError();
}
