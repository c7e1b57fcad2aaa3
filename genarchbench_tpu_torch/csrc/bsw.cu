// BWA-MEM2 banded affine-gap Smith-Waterman (getScores16 semantics),
// one thread block per group of L pairs, one warp per pair.
//
// Replaces: genarchbench_tpu/kernels/bsw_pallas.py::_kernel (the Pallas
// TPU kernel launched at bsw_pallas.py:98), whose row step is
// kernels/bsw.py::_row_factory.row (bsw.py:154-306), itself the
// reference's smithWaterman128_16 (bsw/src/bandedSWA.cpp:3766-4150).
//
// What bounds it on this card: integer instructions.  A group's rows
// run in order (row i+1 reads row i's H and F and the band that row i
// narrowed), and within a row the E gap chain is a prefix max.  The L
// pairs of a group share the band (beg/end narrowing from the columns
// where every pair's H and F are zero, the band-trim test) and stop
// together on a whole zero row, so the warps of a block meet once a row.
// The inputs are a few MB and are read once; the DP rows never leave
// the SM.  Each band cell costs tens of tests, selects and max
// operations per thread, and the SMs dispatch them close to their peak
// rate: the instructions per cell set the time.
//
// What the design does about it (bsw_rows_kernel, C2 <= 256):
//  - a thread owns K = C2/32 consecutive columns of its pair, and holds
//    their H and F (and their query codes, a nibble each) in registers;
//    the reference codes come in 128 rows at a time, four a thread, and
//    a row's code is one shuffle away;
//  - the E chain is a serial running max over a thread's K columns and
//    one warp scan of the threads' carries a row; H[c] = h11[c-1] is a
//    register shift plus one shuffle for the thread's first column;
//  - the row's reductions (row max and its last column, the pair's
//    first and last nonzero F|H column) are taken in the same pass as
//    the stores, each ending in one warp reduction; the score at the
//    last query column stays with the thread that owns that column;
//  - one __syncthreads a row.  Everything the next row needs from the
//    group is per pair and known before the barrier: each warp
//    publishes {row not zero, next row's band changed, first and last
//    nonzero column, next row's head} into a slot chosen by the row's
//    parity, and after the barrier L lanes of every warp reduce the L
//    slots.  The group's band comes from the min of the first and the
//    max of the last nonzero columns.  Two slots suffice: no warp can
//    pass a barrier before every warp has read the slots of the one
//    before it;
//  - blocks take the groups in the order the wrapper gives (longest
//    first), so the longest groups do not set the tail of the launch.
// Wider rows (C2 > 256) take bsw_wide_kernel: H and F in shared memory,
// a warp sweeping its band 32 columns at a time, two barriers a row.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kBig = 1 << 28;
constexpr int kAmbig = 15;   // nibble code of an ambiguous base
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxK = 8;     // register kernel: C2 <= 32 * kMaxK

struct Scoring {
  int match, mismatch, ambig, o_del, e_del, o_ins, e_ins, zdrop, w;
};

// A pair's state across rows: its adaptive band [head, tail], whether
// it may still move its score (exit0), and the score with its cell.
struct Pair {
  int head, tail, exit0, max_score, x, y, max_off;

  // the adaptive band of row i (kernel :3866-3876); whether it moved
  __device__ bool band(int i, int mb, int qlen) {
    const int h = max(head, i - mb), tl = min(min(tail, i + 1 + mb), qlen);
    const bool moved = h != head || tl != tail;
    head = h;
    tail = tl;
    return moved;
  }

  // the per-pair exits at the start of row i (kernel :3906-3915)
  __device__ void exits(int i, int mlen) {
    if (i + 1 > mlen || tail == head || head > tail) exit0 = 0;
  }

  // the updates after row i (kernel :4005-4110) from the row max, the
  // column past its last cell, and the pair's first nonzero F|H column
  // in [beg, end) and last in [beg, end]
  __device__ void after_row(int i, int beg, int end, int max_rs, int y1,
                            int own_first, int own_last, int qlen, int zdrop) {
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
    if (zd > zdrop) exit0 = 0;
    // head and tail from the zero-runs (kernel :4044-4110); a pair that
    // has exited counts every column as nonzero
    if (!exit0) {
      own_first = beg < end ? beg : kBig;
      own_last = end >= beg ? end : -1;
    }
    const int run = min(own_first, end) - beg;
    if (run >= 1) head = beg + run;
    own_last = max(own_last, beg - 1);
    tail = min((end - own_last >= 1 ? own_last : tail) + 2, qlen);
  }
};

__device__ __forceinline__ int subst(const Scoring& sc, int s1, int s2) {
  return max(s1, s2) == kAmbig ? sc.ambig : s1 == s2 ? sc.match : sc.mismatch;
}

// seq1 (G, L, R) and seq2 (G, L, C2) uint8 codes: bases 0-3, 13/14 the
// reference/query padding, 15 ambiguous.  len1, len2, h0, myband (G, L)
// int32.  order (G,) int32: block b runs group order[b].  out (6, G, L)
// int32: score, tle, qle, max_off, gscore, gtle.
template <int K>
__global__ void __launch_bounds__(1024)
bsw_rows_kernel(const uint8_t* __restrict__ seq1,
                const uint8_t* __restrict__ seq2,
                const int32_t* __restrict__ len1,
                const int32_t* __restrict__ len2,
                const int32_t* __restrict__ h0,
                const int32_t* __restrict__ myband,
                const int32_t* __restrict__ order, int32_t* __restrict__ out,
                int G, int L, int R, int C2, Scoring sc) {
  // per warp: {row not zero | band changed << 1, first, last, head}
  __shared__ int4 slot[2][32];
  const int lane = threadIdx.x >> 5;   // the pair this warp owns
  const int t = threadIdx.x & 31;
  const int g = order[blockIdx.x];
  const int gl = g * L + lane;
  const int l1 = len1[gl];
  const int qlen = len2[gl];
  const int h0v = h0[gl];
  const int mb = myband[gl];
  const uint8_t* s1row = seq1 + (size_t)gl * R;
  const uint8_t* s2row = seq2 + (size_t)gl * C2;
  const int oe_ins = sc.o_ins + sc.e_ins;
  const int oe_del = sc.o_del + sc.e_del;
  const int c0 = t * K;                // this thread's first column

  const int nrow = min(__reduce_max_sync(kFull, t < L ? len1[g * L + t] : 0), R);
  const int ncol = __reduce_max_sync(kFull, t < L ? len2[g * L + t] : 0);
  const int mlen = min(qlen + mb, l1);

  // row 0 (wrapper :3680-3694): H[0] = h0, H[k] = max(h0 - oe_ins - (k-1) e_ins, 0)
  int H[K], F[K];
  unsigned s2codes = 0;   // query codes of the K columns, a nibble each
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + k;
    if (c < C2) s2codes |= (unsigned)(s2row[c] & 15) << (4 * k);
    const int hv = c == 0 ? h0v : max(h0v - oe_ins - (c - 1) * sc.e_ins, 0);
    H[k] = c < ncol && c < C2 ? hv : 0;
    F[k] = 0;
  }

  Pair p{0, qlen, 1, h0v, 0, 0, 0};
  int max_ie = 0, gscore = -1;
  int nbeg = 0, nend = ncol;   // group state, the same in every thread
  const bool moved = p.band(0, mb, qlen);
  if (t == 0) slot[0][lane] = make_int4(moved << 1, 0, 0, p.head);
  __syncthreads();
  int changed = 0, maxhead = INT_MIN;
  if (t < L) {
    const int4 s = slot[0][t];
    changed = s.x >> 1;
    maxhead = s.w;
  }
  changed = __reduce_or_sync(kFull, changed);
  maxhead = __reduce_max_sync(kFull, maxhead);

  unsigned s1codes = 0;   // reference codes of rows (i & ~127) + 4t .. + 3
  for (int i = 0; i < nrow; ++i) {
    if ((i & 127) == 0) {
      s1codes = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = i + 4 * t + j;
        if (r < R) s1codes |= (unsigned)s1row[r] << (8 * j);
      }
    }
    const int s1 = (__shfl_sync(kFull, s1codes, (i & 127) >> 2) >> (8 * (i & 3))) & 0xFF;
    // group-shared band (kernel :3846-3852)
    const int beg = max(nbeg, i - sc.w);
    const int end = min(min(nend, i + sc.w + 1), ncol);
    // band-trim zeroing (kernel :3878-3902) applies to [beg, zhi)
    const int zhi = changed ? min(end, maxhead) : beg;
    p.exits(i, mlen);
    const int head = p.head, tail = p.tail;
    const int h10 = beg == 0 ? max(h0v - sc.o_del - (i + 1) * sc.e_del, 0) : 0;

    // the row (kernel :3921-3995).  Columns in [beg, end) are the band;
    // column end (when it exists) takes the trailing store.
    const int endx = end < C2 ? end : -1;
    const int qm1 = qlen - 1;
    // E chain: e' = max(max(m - oe_ins, 0), e - e_ins), e(beg) = 0, as
    // the exclusive prefix max of s[c] = max(m[c] - oe_ins, 0) + c e_ins
    // over [beg, c); columns past the band feed only columns past it.
    // F[c] = f21, zero outside [head, tail], is stored in this pass: the
    // old F is read only here.
    int mf[K], s_exc[K];   // max(m11, f11); the chain before the column
    int run = kNeg;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k;
      const bool zero = c < zhi && (head > c || c + 1 > tail);
      const int h00 = zero ? 0 : H[k];
      const int f11 = zero ? 0 : F[k];
      const int m11 = h00 == 0 ? 0 : h00 + subst(sc, s1, (s2codes >> (4 * k)) & 15);
      mf[k] = max(m11, f11);
      s_exc[k] = run;
      if (c >= beg) run = max(run, max(m11 - oe_ins, 0) + c * sc.e_ins);
      const int f21 = max(max(m11 - oe_del, 0), f11 - sc.e_del);
      const bool in = c >= beg && c < end;
      F[k] = in ? (head > c || c > tail ? 0 : f21) : c == endx ? 0 : F[k];
    }
    // exclusive scan of the threads' maxima (a lane below `off` gets its
    // own value back, which leaves its max unchanged)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      run = max(run, __shfl_up_sync(kFull, run, off));
    int carry = __shfl_up_sync(kFull, run, 1);
    if (t == 0) carry = kNeg;

    int h11[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k;
      const int e11 = c == beg ? 0 : max(max(carry, s_exc[k]) - (c - 1) * sc.e_ins, kNeg / 2);
      h11[k] = max(mf[k], e11);
    }
    // H[c] = h11[c-1] (h10 at beg), zero outside [head, tail]; the
    // trailing store H[end] = h11[end-1] (h10 for an empty band)
    // (kernel :3994-3995).  The row max over columns < tail and its last
    // column, h11 at the last query column, and the pair's first and
    // last nonzero F|H column, all from the values just stored.
    const int h_left = __shfl_up_sync(kFull, h11[K - 1], 1);
    int best = kNeg, best_c = -1, hq = kNeg;
    int own_first = kBig, own_last = -1;   // nonzero F|H in [beg, end), [beg, end]
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k;
      const int hsh = c > beg ? (k == 0 ? h_left : h11[k - 1]) : h10;
      const bool in = c >= beg && c < end;
      H[k] = in ? (head > c || c > tail ? 0 : hsh) : c == endx ? hsh : H[k];
      if (in && c < tail && h11[k] >= best) {
        best = h11[k];
        best_c = c;
      }
      if (c == qm1) hq = h11[k];
      if ((H[k] | F[k]) != 0 && c >= beg && c <= end) {
        if (c < end) own_first = min(own_first, c);
        own_last = c;
      }
    }
    // gscore at the last query column (kernel :3975-3993), kept by the
    // thread that owns the column
    if (qm1 >= beg && qm1 < end && p.exit0 && qlen <= tail) {
      if (!(gscore > hq)) max_ie = i + 1;
      gscore = max(gscore, hq);
    }

    // row max and its last column (kernel :3958-3969)
    const int row_max = __reduce_max_sync(kFull, best);
    const int y_col = __reduce_max_sync(kFull, best == row_max ? best_c : -1);
    own_first = __reduce_min_sync(kFull, own_first);
    own_last = __reduce_max_sync(kFull, own_last);
    const int max_rs = max(row_max, 0);
    const int y1 = row_max >= 0 ? y_col + 1 : 0;

    // The post-row updates.  A whole zero row ends the group before them
    // (kernel :3999-4003), but then max_rs is 0 in every pair, so they
    // change only exit0, head and tail, which no later row reads: they
    // run before the barrier unconditionally, with the next row's band.
    p.after_row(i, beg, end, max_rs, y1, own_first, own_last, qlen, sc.zdrop);
    const bool chg = p.band(i + 1, mb, qlen);

    int4* s = slot[(i + 1) & 1];
    if (t == 0) s[lane] = make_int4((max_rs != 0) | chg << 1, own_first, own_last, p.head);
    __syncthreads();
    int flags = 0, g_first = kBig, g_last = -1;
    maxhead = INT_MIN;
    if (t < L) {
      const int4 v = s[t];
      flags = v.x;
      g_first = v.y;
      g_last = v.z;
      maxhead = v.w;
    }
    flags = __reduce_or_sync(kFull, flags);
    if (!(flags & 1)) break;   // a whole zero row
    changed = flags >> 1;
    maxhead = __reduce_max_sync(kFull, maxhead);
    g_first = __reduce_min_sync(kFull, g_first);
    g_last = __reduce_max_sync(kFull, g_last);
    // group band narrowing from the all-zero columns (kernel :4015-4040)
    const int c_lead = min(g_first, end) - beg;
    if (c_lead >= 1) nbeg = beg + c_lead - 1;
    nend = min(max(g_last, beg - 1) + 2, ncol);
  }

  const size_t n = (size_t)G * L;
  if (t == 0) {
    out[gl] = p.max_score;
    out[n + gl] = p.x;
    out[2 * n + gl] = p.y;
    out[3 * n + gl] = p.max_off;
  }
  // gscore and gtle from the owner of column qlen - 1 (thread 0 if none)
  if (t == (qlen >= 1 && qlen <= 32 * K ? (qlen - 1) / K : 0)) {
    out[4 * n + gl] = gscore;
    out[5 * n + gl] = max_ie;
  }
}

__host__ __device__ inline int mask_chunks(int C2) { return (C2 + 31) / 32 + 1; }

// The wide-row variant, for C2 > 32 * kMaxK: the H and F rows of the
// group live in shared memory (L x C2 x 2 x 4 B, the wrapper's
// wide_smem_bytes with the masks and slots below), and a warp sweeps
// only its pair's band [beg, end] in chunks of 32 columns, one column a
// thread.  Two barriers a row: one for the band-trim test, one after
// the row for the zero row and the all-zero columns, which each warp
// publishes as 32-column ballot masks that every thread ORs.
__global__ void bsw_wide_kernel(const uint8_t* __restrict__ seq1,
                                const uint8_t* __restrict__ seq2,
                                const int32_t* __restrict__ len1,
                                const int32_t* __restrict__ len2,
                                const int32_t* __restrict__ h0,
                                const int32_t* __restrict__ myband,
                                const int32_t* __restrict__ order,
                                int32_t* __restrict__ out, int G, int L,
                                int R, int C2, Scoring sc) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x >> 5;   // the pair this warp owns
  const int t = threadIdx.x & 31;
  const int g = order[blockIdx.x];
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

  for (int c = t; c < C2; c += 32) {
    const int hv = c == 0 ? h0v : max(h0v - oe_ins - (c - 1) * sc.e_ins, 0);
    H[c] = c < ncol ? hv : 0;
    F[c] = 0;
  }
  __syncwarp();

  Pair p{0, qlen, 1, h0v, 0, 0, 0};
  int gscore = -1, max_ie = 0;
  int nbeg = 0, nend = ncol;   // group state, the same in every thread

  for (int i = 0; i < nrow; ++i) {
    const int beg = max(nbeg, i - sc.w);
    const int end = min(min(nend, i + sc.w + 1), ncol);
    const bool moved = p.band(i, mb, qlen);
    if (t == 0) {
      s_head[lane] = p.head;
      s_changed[lane] = moved;
    }
    __syncthreads();
    int changed = 0, maxhead = INT_MIN;
    for (int k = 0; k < L; ++k) {
      changed |= s_changed[k];
      maxhead = max(maxhead, s_head[k]);
    }
    const int zhi = changed ? min(end, maxhead) : beg;
    p.exits(i, mlen);
    const int head = p.head, tail = p.tail;

    const int s1 = s1row[i];
    const int h10 = beg == 0 ? max(h0v - sc.o_del - (i + 1) * sc.e_del, 0) : 0;
    int carry_s = kNeg;   // inclusive E-chain prefix max up to the chunk
    int carry_h = h10;    // h11 of the column before the chunk
    int h_end = h10;      // h11[end - 1], or h10 for an empty band
    int best = kNeg, best_c = -1;
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
      const int m11 = h00 == 0 ? 0 : h00 + subst(sc, s1, s2);
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
    if (t == 0 && end < C2) {
      H[end] = h_end;
      F[end] = 0;
    }

    const int row_max = __reduce_max_sync(kFull, best);
    const int y_col = __reduce_max_sync(kFull, best == row_max ? best_c : -1);
    const int max_rs = max(row_max, 0);
    const int y1 = row_max >= 0 ? y_col + 1 : 0;
    const int h11q = __reduce_max_sync(kFull, hq);
    if (qlen - 1 >= beg && qlen - 1 < end && p.exit0 && qlen <= tail) {
      if (!(gscore > h11q)) max_ie = i + 1;
      gscore = max(gscore, h11q);
    }

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

    int allzero = 1;
    for (int k = 0; k < L; ++k) allzero &= s_zero[k];
    if (allzero) break;

    // the post-row updates (kernel :4005-4110)
    p.after_row(i, beg, end, max_rs, y1, own_first, own_last, qlen, sc.zdrop);

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
  }

  if (t == 0) {
    const size_t n = (size_t)G * L;
    out[gl] = p.max_score;
    out[n + gl] = p.x;
    out[2 * n + gl] = p.y;
    out[3 * n + gl] = p.max_off;
    out[4 * n + gl] = gscore;
    out[5 * n + gl] = max_ie;
  }
}

template <int K>
cudaError_t launch_rows(const uint8_t* seq1, const uint8_t* seq2,
                        const int32_t* len1, const int32_t* len2,
                        const int32_t* h0, const int32_t* myband,
                        const int32_t* order, int32_t* out, int G, int L,
                        int R, int C2, Scoring sc, cudaStream_t stream) {
  bsw_rows_kernel<K><<<G, 32 * L, 0, stream>>>(seq1, seq2, len1, len2, h0,
                                               myband, order, out, G, L, R,
                                               C2, sc);
  return cudaGetLastError();
}

}  // namespace

// Launches one block of 32*L threads per group on `stream`: the register
// kernel with K columns a thread when K is 1..8, else (K = 0) the
// wide-row kernel with `smem` bytes of dynamic shared memory.  Returns
// the first CUDA error (0 on success).
extern "C" int genarch_bsw(const void* seq1_, const void* seq2_,
                           const void* len1_, const void* len2_,
                           const void* h0_, const void* myband_,
                           const void* order_, void* out_, int G, int L,
                           int R, int C2, int K, int smem, int match,
                           int mismatch, int ambig, int o_del, int e_del,
                           int o_ins, int e_ins, int zdrop, int w,
                           void* stream_) {
  if (G <= 0) return cudaGetLastError();
  const auto* seq1 = static_cast<const uint8_t*>(seq1_);
  const auto* seq2 = static_cast<const uint8_t*>(seq2_);
  const auto* len1 = static_cast<const int32_t*>(len1_);
  const auto* len2 = static_cast<const int32_t*>(len2_);
  const auto* h0 = static_cast<const int32_t*>(h0_);
  const auto* myband = static_cast<const int32_t*>(myband_);
  const auto* order = static_cast<const int32_t*>(order_);
  auto* out = static_cast<int32_t*>(out_);
  auto stream = static_cast<cudaStream_t>(stream_);
  const Scoring sc{match, mismatch, ambig, o_del, e_del, o_ins, e_ins, zdrop, w};
  switch (K) {
#define GENARCH_BSW_CASE(N) \
  case N:                   \
    return launch_rows<N>(seq1, seq2, len1, len2, h0, myband, order, out, G, L, R, C2, sc, stream);
    GENARCH_BSW_CASE(1) GENARCH_BSW_CASE(2) GENARCH_BSW_CASE(3)
    GENARCH_BSW_CASE(4) GENARCH_BSW_CASE(5) GENARCH_BSW_CASE(6)
    GENARCH_BSW_CASE(7) GENARCH_BSW_CASE(8)
#undef GENARCH_BSW_CASE
    default:
      break;
  }
  static_assert(kMaxK == 8, "the switch above covers K = 1..kMaxK");
  cudaError_t err = cudaFuncSetAttribute(
      bsw_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bsw_wide_kernel<<<G, 32 * L, smem, stream>>>(seq1, seq2, len1, len2, h0,
                                               myband, order, out, G, L, R,
                                               C2, sc);
  return cudaGetLastError();
}
