// BWA-MEM2 banded affine-gap Smith-Waterman (getScores16 semantics),
// one thread block per group of L pairs, one warp per pair.
//
// Replaces: genarchbench_tpu/kernels/bsw_pallas.py::_kernel (the Pallas
// TPU kernel launched at bsw_pallas.py:98), whose row step is
// kernels/bsw.py::_row_factory.row (bsw.py:154-306), itself the
// reference's smithWaterman128_16 (bsw/src/bandedSWA.cpp:3766-4150).
//
// What bounds it on this card: integer operations on a serial row
// recurrence.  A group's rows run in order (row i+1 reads row i's H
// and F and the band that row i narrowed), and within a row the E gap
// chain is a prefix max.  The L pairs of a group share the band
// (beg/end narrowing, the all-zero column test), so each row needs two
// exchanges between the group's warps.  The inputs are a few MB and
// are read once; the DP rows never leave the SM.
//
// What the design does about it: the H and F rows of the group live in
// shared memory (L x C2 x 2 x 4 B, 12-16 KB at the bench shape), and a
// warp sweeps only its pair's band [beg, end] in chunks of 32 columns,
// one column a thread.  The E chain is a warp-shuffle inclusive prefix
// max of max(m - oe_ins, 0) + j*e_ins, carried from chunk to chunk.
// The per-pair reductions (row max and its last column, the score at
// the last query column, the head and tail zero-runs) are warp
// reductions; the group reductions (changed, max head, all-zero row,
// the all-zero column mask behind nbeg/nend) go through small shared
// arrays: each warp ballots its pair's nonzero columns, and after one
// __syncthreads every thread ORs the L masks, so every thread holds the
// group state in registers.  A group stops at its last row or when a
// whole row is zero, after which its state cannot change.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kBig = 1 << 28;
constexpr int kAmbig = 15;   // nibble code of an ambiguous base
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Scoring {
  int match, mismatch, ambig, o_del, e_del, o_ins, e_ins, zdrop, w;
};

__host__ __device__ inline int mask_chunks(int C2) { return (C2 + 31) / 32 + 1; }

__host__ __device__ inline size_t smem_bytes(int L, int C2) {
  // H and F rows, the per-pair nonzero-column masks, three per-pair slots
  return sizeof(int) * ((size_t)2 * L * C2 + (size_t)L * mask_chunks(C2) +
                        (size_t)3 * L);
}

// seq1 (G, L, R) and seq2 (G, L, C2) uint8 codes: bases 0-3, 13/14 the
// reference/query padding, 15 ambiguous.  len1, len2, h0, myband (G, L)
// int32.  out (6, G, L) int32: score, tle, qle, max_off, gscore, gtle.
__global__ void bsw_kernel(const uint8_t* __restrict__ seq1,
                           const uint8_t* __restrict__ seq2,
                           const int32_t* __restrict__ len1,
                           const int32_t* __restrict__ len2,
                           const int32_t* __restrict__ h0,
                           const int32_t* __restrict__ myband,
                           int32_t* __restrict__ out, int G, int L, int R,
                           int C2, Scoring sc) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x >> 5;   // the pair this warp owns
  const int t = threadIdx.x & 31;
  const int g = blockIdx.x;
  const int nmask = mask_chunks(C2);
  int* H = smem + (size_t)lane * C2;
  int* F = smem + (size_t)L * C2 + (size_t)lane * C2;
  unsigned* nz = reinterpret_cast<unsigned*>(smem + (size_t)2 * L * C2);
  int* s_head = reinterpret_cast<int*>(nz + (size_t)L * nmask);
  int* s_changed = s_head + L;
  int* s_zero = s_changed + L;

  const int gl = g * L + lane;
  const int l1 = len1[gl];
  const int qlen = len2[gl];
  const int h0v = h0[gl];
  const int mb = myband[gl];
  const uint8_t* s1row = seq1 + (size_t)gl * R;
  const uint8_t* s2row = seq2 + (size_t)gl * C2;
  const int oe_ins = sc.o_ins + sc.e_ins;
  const int oe_del = sc.o_del + sc.e_del;

  int nrow = 0, ncol = 0;
  for (int k = 0; k < L; ++k) {
    nrow = max(nrow, len1[g * L + k]);
    ncol = max(ncol, len2[g * L + k]);
  }
  nrow = min(nrow, R);   // the rows the reference codes cover
  const int mlen = min(qlen + mb, l1);

  // row 0 (wrapper :3680-3694): H[0] = h0, H[k] = max(h0 - oe_ins - (k-1) e_ins, 0)
  for (int c = t; c < C2; c += 32) {
    const int hv = c == 0 ? h0v : max(h0v - oe_ins - (c - 1) * sc.e_ins, 0);
    H[c] = c < ncol ? hv : 0;
    F[c] = 0;
  }
  __syncwarp();

  int head = 0, tail = qlen, exit0 = 1;
  int max_score = h0v, x = 0, y = 0, max_off = 0, gscore = -1, max_ie = 0;
  int nbeg = 0, nend = ncol;   // group state, the same in every thread

  for (int i = 0; i < nrow; ++i) {
    // group-shared band (kernel :3846-3852)
    const int beg = max(nbeg, i - sc.w);
    const int end = min(min(nend, i + sc.w + 1), ncol);

    // per-pair adaptive band (kernel :3866-3876)
    const int phead = head, ptail = tail;
    head = max(head, i - mb);
    tail = min(min(tail, i + 1 + mb), qlen);
    if (t == 0) {
      s_head[lane] = head;
      s_changed[lane] = head != phead || tail != ptail;
    }
    __syncthreads();
    int changed = 0, maxhead = INT_MIN;
    for (int k = 0; k < L; ++k) {
      changed |= s_changed[k];
      maxhead = max(maxhead, s_head[k]);
    }
    // band-trim zeroing (kernel :3878-3902) applies to [beg, zhi)
    const int zhi = changed ? min(end, maxhead) : beg;
    // per-pair exits (kernel :3906-3915)
    if (i + 1 > mlen || tail == head || head > tail) exit0 = 0;

    // the row (kernel :3921-3995), 32 columns of [beg, end) at a time
    const int s1 = s1row[i];
    const int h10 = beg == 0 ? max(h0v - sc.o_del - (i + 1) * sc.e_del, 0) : 0;
    int carry_s = kNeg;   // inclusive E-chain prefix max up to the chunk
    int carry_h = h10;    // h11 of the column before the chunk
    int h_end = h10;      // h11[end - 1], or h10 for an empty band
    int best = kNeg, best_c = -1;   // row max over columns < tail, last column
    int hq = kNeg;        // h11 at the last query column
    for (int base = beg; base < end; base += 32) {
      const int c = base + t;
      const bool in = c < end;
      int h00 = 0, f11 = 0, s2 = 0;
      if (in) {
        s2 = s2row[c];
        if (!(c < zhi && (head > c || c + 1 > tail))) {
          h00 = H[c];
          f11 = F[c];
        }
      }
      int sbt = s1 == s2 ? sc.match : sc.mismatch;
      if (max(s1, s2) == kAmbig) sbt = sc.ambig;
      const int m11 = h00 == 0 ? 0 : h00 + sbt;
      // E chain: e' = max(max(m - oe_ins, 0), e - e_ins), e(beg) = 0
      int s = in ? max(m11 - oe_ins, 0) + c * sc.e_ins : kNeg;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, s, off);
        if (t >= off) s = max(s, o);
      }
      s = max(s, carry_s);
      int s_exc = __shfl_up_sync(kFull, s, 1);
      if (t == 0) s_exc = carry_s;
      carry_s = __shfl_sync(kFull, s, 31);
      int e11 = c == beg ? 0 : s_exc - (c - 1) * sc.e_ins;
      e11 = max(e11, kNeg / 2);
      const int h11 = max(max(m11, e11), f11);
      const int f21 = max(max(m11 - oe_del, 0), f11 - sc.e_del);
      // H[c] = h11[c-1] (h10 at beg), F[c] = f21; zero outside [head, tail]
      int h_prev = __shfl_up_sync(kFull, h11, 1);
      if (t == 0) h_prev = carry_h;
      carry_h = __shfl_sync(kFull, h11, 31);
      if (base + 32 >= end) h_end = __shfl_sync(kFull, h11, end - 1 - base);
      if (in) {
        const bool z = head > c || c > tail;
        H[c] = z ? 0 : h_prev;
        F[c] = z ? 0 : f21;
        if (c < tail && h11 >= best) {
          best = h11;
          best_c = c;
        }
        if (c == qlen - 1) hq = h11;
      }
    }
    if (t == 0 && end < C2) {   // trailing store (kernel :3994-3995)
      H[end] = h_end;
      F[end] = 0;
    }

    // row max and its last column (kernel :3958-3969)
    const int row_max = __reduce_max_sync(kFull, best);
    const int y_col = __reduce_max_sync(kFull, best == row_max ? best_c : -1);
    const int max_rs = max(row_max, 0);
    const int y1 = row_max >= 0 ? y_col + 1 : 0;
    // gscore at the last query column (kernel :3975-3993)
    const int h11q = __reduce_max_sync(kFull, hq);
    if (qlen - 1 >= beg && qlen - 1 < end && exit0 && qlen <= tail) {
      if (!(gscore > h11q)) max_ie = i + 1;
      gscore = max(gscore, h11q);
    }

    // this pair's nonzero columns of F|H over [beg, end]
    __syncwarp();
    const int nch = end >= beg ? (end - beg) / 32 + 1 : 0;
    int own_first = kBig, own_last = -1;
    for (int k = 0; k < nch; ++k) {
      const int c = beg + 32 * k + t;
      const bool nzc = c <= end && c < C2 && (H[c] != 0 || F[c] != 0);
      const unsigned m = __ballot_sync(kFull, nzc);
      if (t == 0) nz[lane * nmask + k] = m;
      if (nzc) {
        if (c < end) own_first = min(own_first, c);
        own_last = max(own_last, c);
      }
    }
    own_first = __reduce_min_sync(kFull, own_first);
    own_last = __reduce_max_sync(kFull, own_last);
    if (t == 0) s_zero[lane] = max_rs == 0;
    __syncthreads();

    // a whole zero row ends the group before the post-row updates
    // (kernel :3999-4003)
    int allzero = 1;
    for (int k = 0; k < L; ++k) allzero &= s_zero[k];
    if (allzero) break;

    if (max_rs == 0) exit0 = 0;
    const int bmax = max_score;
    if (exit0) max_score = max(bmax, max_rs);
    if (max_score > bmax) {
      x = i + 1;
      y = y1;
      max_off = max(max_off, abs(y1 - (i + 1)));
    }
    // z-drop, vector variant (ZSCORE16 :3380-3394)
    const int zd = (max_score - max_rs) - abs(((i + 1) - x) - (y1 - y));
    if (zd > sc.zdrop) exit0 = 0;

    // group band narrowing from the all-zero columns (kernel :4015-4040)
    int g_first = kBig, g_last = -1;
    for (int k = t; k < nch; k += 32) {
      unsigned m = 0;
      for (int l = 0; l < L; ++l) m |= nz[l * nmask + k];
      if (m) {
        const int c0 = beg + 32 * k;
        g_last = max(g_last, c0 + 31 - __clz(m));
        const int endbit = end - c0;
        const unsigned mf =
            (endbit >= 0 && endbit < 32) ? (m & ~(1u << endbit)) : m;
        if (mf) g_first = min(g_first, c0 + __ffs(mf) - 1);
      }
    }
    g_first = __reduce_min_sync(kFull, g_first);
    g_last = __reduce_max_sync(kFull, g_last);
    const int c_lead = min(g_first, end) - beg;
    if (c_lead >= 1) nbeg = beg + c_lead - 1;
    nend = min(max(g_last, beg - 1) + 2, ncol);

    // per-pair head and tail from the zero-runs (kernel :4044-4110); a
    // pair that has exited counts every column as nonzero
    int fnl = own_first, lnq = own_last;
    if (!exit0) {
      fnl = beg < end ? beg : kBig;
      lnq = end >= beg ? end : -1;
    }
    const int run = min(fnl, end) - beg;
    if (run >= 1) head = beg + run;
    lnq = max(lnq, beg - 1);
    tail = min((end - lnq >= 1 ? lnq : tail) + 2, qlen);
  }

  if (t == 0) {
    const size_t n = (size_t)G * L;
    out[gl] = max_score;
    out[n + gl] = x;
    out[2 * n + gl] = y;
    out[3 * n + gl] = max_off;
    out[4 * n + gl] = gscore;
    out[5 * n + gl] = max_ie;
  }
}

}  // namespace

// Dynamic shared memory one block needs for L pairs of C2 columns.
extern "C" long long genarch_bsw_smem_bytes(int L, int C2) {
  return (long long)smem_bytes(L, C2);
}

// Launches one block of 32*L threads per group on `stream`.  Returns
// the first CUDA error (0 on success).
extern "C" int genarch_bsw(const void* seq1, const void* seq2,
                           const void* len1, const void* len2, const void* h0,
                           const void* myband, void* out, int G, int L, int R,
                           int C2, int match, int mismatch, int ambig,
                           int o_del, int e_del, int o_ins, int e_ins,
                           int zdrop, int w, void* stream) {
  if (G <= 0) return cudaGetLastError();
  const size_t smem = smem_bytes(L, C2);
  cudaError_t err = cudaFuncSetAttribute(
      bsw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  Scoring sc{match, mismatch, ambig, o_del, e_del, o_ins, e_ins, zdrop, w};
  bsw_kernel<<<G, 32 * L, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq1), static_cast<const uint8_t*>(seq2),
      static_cast<const int32_t*>(len1), static_cast<const int32_t*>(len2),
      static_cast<const int32_t*>(h0), static_cast<const int32_t*>(myband),
      static_cast<int32_t*>(out), G, L, R, C2, sc);
  return cudaGetLastError();
}
