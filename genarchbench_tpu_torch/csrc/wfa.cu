// Gap-affine WFA on the card, two kernels a chunk: the score loop
// (complete wavefronts), one warp a pair, each pair stepping to its own
// final score; then the backtrace over the store it wrote, one thread a
// pair (its note is further down).
//
// Replaces: no TPU kernel.  The JAX package runs the loop as a
// lax.while_loop of XLA ops (genarchbench_tpu/kernels/wfa.py::
// _wfa_forward); the port's torch-op version of it
// (kernels/wfa.py::_wfa_forward) is this kernel's plain version and
// still runs CPU tensors.  Its semantics are the reference's
// (affine_wavefront_align.c:325-361 and :120-199, the extension
// affine_wavefront_extend.c:237-255, the adaptive reduction :85-156).
//
// What bounds it on this card: the latency of one pair's dependent
// chain, not bytes or operations.  Score s+1 needs the wavefronts at
// s+1-x, s+1-o-e and s+1-e, and an exact extension is a compare loop of
// data-dependent length.  Run as batched torch ops, each score step is
// some 230 launches over (B, D) lanes x diagonals, every lane stepping
// to the batch's highest score across every diagonal, enqueued by the
// host.
//
// What the design does about it: a warp takes one pair and runs its
// loop extend -> reduce -> end check -> compute s+1 to its own end or
// the score cap, so a launch does a whole chunk and a pair's work is
// its own score times its own wavefront width.  Lanes stride over the
// diagonals [lo, hi] of the wavefront being computed; the only sync
// between steps is __syncwarp.  The M, I and D wavefront rings (slot
// s % (RS + 1) of M, s % RI of I and D), their bounds and the pair's
// bases live in shared memory; where they do not fit (long inputs,
// large penalties) the same kernel keeps the rings and bounds in a
// device scratch, one workspace a pair, and reads the bases from their
// rows.  Wavefront s+1 and its extension are one pass: a lane computes
// diagonal k from the sources, extends it at once by comparing the
// pattern and text bytes 8 at a time (the first set bit of their XOR),
// and writes the backtrace store word code | run << 8 of column s+1, the
// op codes the backtrace reads (C_DE .. C_MM, the I and D choices) and
// the extension run.
//
// The store equals the torch version's at every diagonal in [lo, hi] of
// score s for s <= the pair's final score, including its corners: a
// stored NULL fetched in bounds reads NULL + 1 = -9 as a backtrace
// candidate, diagonals past the store's edges read NULL, and with x = 0
// or e = 0 (or o + e = 0) a source is the slot that score s+1 would
// overwrite in the torch version's ring of RS slots, i.e. wavefront
// s+1-RS.  The extra slot of the M ring (RS + 1) keeps that wavefront
// intact while s+1 is written, and so does RI = RS + 1 when e = 0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNull = -10;          // AFFINE_WAVEFRONT_OFFSET_NULL
constexpr int kNeg = -(1 << 29);    // an absent term of a max
constexpr int kBig = 1 << 29;
constexpr unsigned kFull = 0xFFFFFFFFu;
// op codes of an M cell, in the backtrace's priority order
constexpr int kDE = 0, kDO = 1, kIE = 2, kIO = 3, kMM = 4;

struct Params {
  const uint8_t* pat;   // (B, Lp) pattern codes
  const uint8_t* txt;   // (B, Lt) text codes
  const int* plen;      // (B,)
  const int* tlen;      // (B,)
  int* store;           // (B, Scap, D) code | run << 8
  int* fscore;          // (B,) final score, 0 where unfinished
  int* foff;            // (B,) final offset on the alignment diagonal
  unsigned long long* summary;  // unfinished pairs, max final score,
                                // sum of steps, max steps
  int* gws;             // (B, ws) workspaces, or null: in shared memory
  int B, Lp, Lt, K0, D, Scap, x, o, e, red_len, red_dist;
};

// A wavefront's exists flag and bounds; absent ones read lo 1, hi -1.
struct Wf {
  int ex, lo, hi;
};

__device__ __forceinline__ Wf wf_at(const int* bnd, int slot) {
  const int* b = bnd + 3 * slot;
  const int ex = b[2];
  return Wf{ex, ex ? b[0] : 1, ex ? b[1] : -1};
}

__device__ __forceinline__ void wf_set(int* bnd, int slot, int ex, int lo,
                                       int hi) {
  int* b = bnd + 3 * slot;
  b[0] = lo;
  b[1] = hi;
  b[2] = ex;
}

// bytes row[pos .. pos + 7], row[pos] lowest; bytes at or past `len`
// (the row's length, a multiple of 8) read as 0.  pos < len.
__device__ __forceinline__ uint64_t load8(const uint8_t* row, int pos,
                                          int len) {
  const int a = pos & ~7, r = pos & 7;
  const uint64_t lo = *reinterpret_cast<const uint64_t*>(row + a);
  if (r == 0) return lo;
  const uint64_t hi =
      a + 8 < len ? *reinterpret_cast<const uint64_t*>(row + a + 8) : 0ull;
  return (lo >> (8 * r)) | (hi << (64 - 8 * r));
}

// The run of matches of P[v ..] against T[h ..], at most lim (>= 1).
__device__ __forceinline__ int match_run(const uint8_t* P, int Lp, int v,
                                         const uint8_t* T, int Lt, int h,
                                         int lim) {
  int r = 0;
  while (r < lim) {
    const uint64_t d = load8(P, v + r, Lp) ^ load8(T, h + r, Lt);
    if (d) return min(r + ((__ffsll((long long)d) - 1) >> 3), lim);
    r += 8;
  }
  return lim;
}

// The score whose wavefront a source d back from s+1 reads: s+1-d, or
// for d = 0 the torch version's stale ring slot, wavefront s+1-RS;
// negative where there is none.
__device__ __forceinline__ int source(int sn, int d, int RS) {
  return d == 0 ? sn - RS : sn - d;
}

__global__ void __launch_bounds__(32)
wfa_forward_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int D = p.D, K0 = p.K0;
  const int RS = max(p.x, p.o + p.e) + 1;
  const int RM = RS + 1;                      // M ring slots
  const int RI = p.e == 0 ? RM : p.e + 1;     // I and D ring slots
  const int rows = RM + 2 * RI;
  const int ws = rows * (D + 3);

  int* w = p.gws ? p.gws + (size_t)b * ws : reinterpret_cast<int*>(smem);
  int* Mv = w;
  int* Iv = Mv + (size_t)RM * D;
  int* Dv = Iv + (size_t)RI * D;
  int* Mb = w + (size_t)rows * D;   // (lo, hi, ex) a slot
  int* Ib = Mb + 3 * RM;
  int* Db = Ib + 3 * RI;

  const int pl = p.plen[b], tl = p.tlen[b];
  const uint8_t* P = p.pat + (size_t)b * p.Lp;
  const uint8_t* T = p.txt + (size_t)b * p.Lt;
  if (!p.gws) {   // the bases beside the rings, 16-byte aligned
    uint8_t* sp = smem + (((size_t)ws * 4 + 15) & ~(size_t)15);
    uint8_t* st = sp + p.Lp;
    const auto* gp = reinterpret_cast<const uint64_t*>(P);
    const auto* gt = reinterpret_cast<const uint64_t*>(T);
    for (int i = lane; i < p.Lp / 8; i += 32)
      reinterpret_cast<uint64_t*>(sp)[i] = gp[i];
    for (int i = lane; i < p.Lt / 8; i += 32)
      reinterpret_cast<uint64_t*>(st)[i] = gt[i];
    P = sp;
    T = st;
  }
  for (int i = lane; i < RM; i += 32) wf_set(Mb, i, 0, 1, -1);
  for (int i = lane; i < RI; i += 32) {
    wf_set(Ib, i, 0, 1, -1);
    wf_set(Db, i, 0, 1, -1);
  }
  int* out = p.store + (size_t)b * p.Scap * D;
  const int ak = tl - pl;                 // the alignment diagonal
  const int jak = min(max(ak + K0, 0), D - 1);
  const bool reduce = p.red_len > 0;
  const int oe = p.o + p.e;
  __syncwarp();

  // m[0] = {k = 0: 0}, extended
  int dmin = kBig;   // this lane's least distance to the end, score s
  if (lane == 0) {
    wf_set(Mb, 0, 1, 0, 0);
    const int run = pl > 0 && tl > 0 ? match_run(P, p.Lp, 0, T, p.Lt, 0,
                                                 min(pl, tl))
                                     : 0;
    Mv[K0] = run;
    out[K0] = run << 8;
    dmin = max(pl - run, tl - run);
  }

  int s = 0;
  for (;;) {
    __syncwarp();
    const int tm = s % RM;
    Wf m = wf_at(Mb, tm);
    const int jlo = max(m.lo + K0, 0), jhi = min(m.hi + K0, D - 1);

    // ---- adaptive reduction of m[s] and the i/d bounds of score s ----
    if (reduce && m.ex && m.hi - m.lo + 1 >= p.red_len) {
      const int dm = __reduce_min_sync(kFull, dmin);
      int mn = kBig, mx = -kBig;   // least and greatest diagonal kept
      for (int j = jlo + lane; j <= jhi; j += 32) {
        const int Ms = Mv[(size_t)tm * D + j], k = j - K0;
        if (max(pl - (Ms - k), tl - Ms) - dm <= p.red_dist) {
          mn = min(mn, k);
          mx = max(mx, k);
        }
      }
      mn = __reduce_min_sync(kFull, mn);
      mx = __reduce_max_sync(kFull, mx);
      const int top = min(ak - 1, m.hi);
      const int first = mn < top ? mn : kBig;
      const int nlo = top > m.lo ? max(min(first, top), m.lo) : m.lo;
      const int bot = max(ak + 1, nlo);
      const int last = mx > bot ? mx : -kBig;
      const int nhi = m.hi > bot ? min(max(last, bot), m.hi) : m.hi;
      const int nex = nlo <= nhi;
      const int ti = s % RI;
      const Wf wi = wf_at(Ib, ti), wd = wf_at(Db, ti);
      __syncwarp();
      if (lane == 0) {
        wf_set(Mb, tm, nex, nlo, nhi);
        int lo = wi.ex ? max(wi.lo, nlo) : wi.lo;
        int hi = wi.ex ? min(wi.hi, nhi) : wi.hi;
        wf_set(Ib, ti, wi.ex && lo <= hi, lo, hi);
        lo = wd.ex ? max(wd.lo, nlo) : wd.lo;
        hi = wd.ex ? min(wd.hi, nhi) : wd.hi;
        wf_set(Db, ti, wd.ex && lo <= hi, lo, hi);
      }
      __syncwarp();
      m = Wf{nex, nlo, nhi};
    }

    // ---- end condition (affine_wavefront_utils.c:85-103) ----
    if (m.ex && m.lo <= ak && ak <= m.hi) {
      const int at = jak >= jlo && jak <= jhi ? Mv[(size_t)tm * D + jak]
                                              : kNull;
      if (at >= tl) {
        if (lane == 0) {
          p.fscore[b] = s;
          p.foff[b] = at;
          atomicMax(p.summary + 1, (unsigned long long)s);
          atomicAdd(p.summary + 2, (unsigned long long)(s + 1));
          atomicMax(p.summary + 3, (unsigned long long)(s + 1));
        }
        return;
      }
    }
    if (s + 1 >= p.Scap) {   // unfinished at the cap
      if (lane == 0) {
        p.fscore[b] = 0;
        p.foff[b] = 0;
        atomicAdd(p.summary + 0, 1ull);
        atomicAdd(p.summary + 2, (unsigned long long)p.Scap);
        atomicMax(p.summary + 3, (unsigned long long)p.Scap);
      }
      return;
    }

    // ---- compute wavefront s+1 (affine_wavefront_align.c:283-321) and
    // extend it ----
    const int sn = s + 1;
    const int ss = source(sn, p.x, RS), sg = source(sn, oe, RS),
              si = source(sn, p.e, RS);
    const Wf absent{0, 1, -1};
    const Wf wsub = ss >= 0 ? wf_at(Mb, ss % RM) : absent;
    const Wf wgap = sg >= 0 ? wf_at(Mb, sg % RM) : absent;
    const Wf wie = si >= 0 ? wf_at(Ib, si % RI) : absent;
    const Wf wde = si >= 0 ? wf_at(Db, si % RI) : absent;
    const int compute = wsub.ex | wgap.ex | wie.ex | wde.ex;
    const int lo = min(min(wsub.lo, wgap.lo), min(wie.lo, wde.lo)) - 1;
    const int hi = max(max(wsub.hi, wgap.hi), max(wie.hi, wde.hi)) + 1;
    const int ialloc = compute && (wgap.ex | wie.ex);
    const int dalloc = compute && (wgap.ex | wde.ex);
    const int tn = sn % RM, tni = sn % RI;
    dmin = kBig;
    if (compute) {
      const int* Msub = Mv + (size_t)(ss >= 0 ? ss % RM : 0) * D;
      const int* Mgap = Mv + (size_t)(sg >= 0 ? sg % RM : 0) * D;
      const int* Iext = Iv + (size_t)(si >= 0 ? si % RI : 0) * D;
      const int* Dext = Dv + (size_t)(si >= 0 ? si % RI : 0) * D;
      int* Mn = Mv + (size_t)tn * D;
      int* In = Iv + (size_t)tni * D;
      int* Dn = Dv + (size_t)tni * D;
      int* col = out + (size_t)sn * D;
      const int nlo = max(lo + K0, 0), nhi = min(hi + K0, D - 1);
      for (int j = nlo + lane; j <= nhi; j += 32) {
        const int k = j - K0;
        // conditional fetches: NULL out of the source's bounds or past
        // the store's edges
        const bool in_s = wsub.ex && k >= wsub.lo && k <= wsub.hi;
        const bool in_ig = wgap.ex && k - 1 >= wgap.lo && k - 1 <= wgap.hi;
        const bool in_gd = wgap.ex && k + 1 >= wgap.lo && k + 1 <= wgap.hi;
        const bool in_ii = wie.ex && k - 1 >= wie.lo && k - 1 <= wie.hi;
        const bool in_dd = wde.ex && k + 1 >= wde.lo && k + 1 <= wde.hi;
        const int r_s = in_s ? Msub[j] : kNull;
        const int r_ig = in_ig && j >= 1 ? Mgap[j - 1] : kNull;
        const int r_gd = in_gd && j + 1 < D ? Mgap[j + 1] : kNull;
        const int r_ii = in_ii && j >= 1 ? Iext[j - 1] : kNull;
        const int r_dd = in_dd && j + 1 < D ? Dext[j + 1] : kNull;
        const int ins = max(r_ig, r_ii) + 1;
        const int del = max(r_gd, r_dd);
        const int sub = r_s == kNull ? kNull : r_s + 1;
        const int Msn = max(sub, max(ialloc ? ins : kNeg, dalloc ? del : kNeg));
        // the backtrace's candidates (an in-bounds NULL reads -9)
        const int ie_c = in_ii ? r_ii + 1 : kNull;
        const int io_c = in_ig ? r_ig + 1 : kNull;
        const int mm_c = in_s ? r_s + 1 : kNull;
        const int de_c = r_dd, do_c = r_gd;
        const int best = max(mm_c, max(max(de_c, do_c), max(ie_c, io_c)));
        const int opm = best == de_c ? kDE
                        : best == do_c ? kDO
                        : best == ie_c ? kIE
                        : best == io_c ? kIO
                                       : kMM;
        const int code = opm | (max(ie_c, io_c) != ie_c) << 3 |
                         (max(de_c, do_c) != de_c) << 4;
        // exact extension (affine_wavefront_extend.c:237-255)
        const int v = Msn - k;
        int run = 0;
        if (v >= 0 && Msn >= 0 && v < pl && Msn < tl)
          run = match_run(P, p.Lp, v, T, p.Lt, Msn, min(pl - v, tl - Msn));
        const int Ms = Msn + run;
        Mn[j] = Ms;
        In[j] = ialloc ? ins : kNull;
        Dn[j] = dalloc ? del : kNull;
        col[j] = code | run << 8;
        if (reduce) dmin = min(dmin, max(pl - (Ms - k), tl - Ms));
      }
    }
    if (lane == 0) {
      wf_set(Mb, tn, compute, compute ? lo : 1, compute ? hi : -1);
      wf_set(Ib, tni, ialloc, ialloc ? lo : 1, ialloc ? hi : -1);
      wf_set(Db, tni, dalloc, dalloc ? lo : 1, dalloc ? hi : -1);
    }
    s = sn;
  }
}

}  // namespace

// One warp (one block of 32 threads) a pair on `stream`.  pat (B, Lp)
// and txt (B, Lt) uint8 codes, Lp and Lt multiples of 8; plen, tlen (B,)
// int32; store (B, Scap, D) int32, written at the diagonals [lo, hi] of
// every score up to a pair's final score; fscore, foff (B,) int32;
// summary (4,) uint64, zeroed: unfinished pairs, max final score, the
// sum and the max of the score steps the pairs ran.  gws: (B, ws) int32
// workspaces, or null to keep them in `smem` bytes of dynamic shared
// memory with the bases.
// Returns the first CUDA error (0 on success).
extern "C" int genarch_wfa_forward(const void* pat, const void* txt,
                                   const void* plen, const void* tlen,
                                   void* store, void* fscore, void* foff,
                                   void* summary, void* gws,
                                   int B, int Lp, int Lt, int K0, int D,
                                   int Scap, int x, int o, int e,
                                   int red_len, int red_dist, int smem,
                                   void* stream_) {
  if (B <= 0) return cudaGetLastError();
  Params p{static_cast<const uint8_t*>(pat),
           static_cast<const uint8_t*>(txt),
           static_cast<const int*>(plen),
           static_cast<const int*>(tlen),
           static_cast<int*>(store),
           static_cast<int*>(fscore),
           static_cast<int*>(foff),
           static_cast<unsigned long long*>(summary),
           static_cast<int*>(gws),
           B, Lp, Lt, K0, D, Scap, x, o, e, red_len, red_dist};
  auto stream = static_cast<cudaStream_t>(stream_);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wfa_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  wfa_forward_kernel<<<B, 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Gap-affine WFA's backtrace over the store the score loop wrote: one
// thread a pair, each walking its own store from its final score.
//
// Replaces: no TPU kernel.  The JAX package runs the walk as lock-step
// XLA ops (genarchbench_tpu/kernels/wfa.py::_wfa_backtrace); the port's
// torch-op version of it (kernels/wfa.py::_wfa_backtrace) is this
// kernel's plain version and still runs CPU tensors.  Its semantics are
// the reference's (affine_wavefront_backtrace.c:280-387): the op
// decisions were made by the score loop with the reference's priority
// (del_ext > del_open > ins_ext > ins_open > mismatch) and stored as
// code | run << 8, so a step reads one word.
//
// What bounds it on this card: the latency of one pair's chain of
// dependent loads.  Each step's word gives the next step's (score,
// diagonal), so a pair's walk is some 60 loads in a row, each a trip
// to device memory; the bytes (a word a step) and the operations are
// nothing.  Run as batched torch ops, each step is some 117 launches
// over (B,) lanes, enqueued by the host, every lane stepping as long as
// the batch's longest walk.
//
// What the design does about it: a thread takes one pair and runs its
// whole walk, so a launch does a chunk and the card keeps thousands of
// independent chains in flight at once, one a thread, hiding each
// load's latency behind the others'.  Blocks are small (kBtThreads) so
// that a 4,096-pair chunk spreads over every SM.  A thread writes its
// pair's row of records, zeros after the pair's last step (no memset),
// and reads the store only on an active step: the store is written only
// at the diagonals [lo, hi] of each score up to the pair's final score,
// which is where an active step's (score, diagonal) lies.
namespace {

constexpr int kBtThreads = 32;
constexpr int kOpNone = 0, kOpD = 1, kOpI = 2, kOpX = 3;  // record ops
constexpr int kBtM = 0, kBtI = 1, kBtD = 2;               // the walk's matrix

struct BtParams {
  const int* __restrict__ store;   // (B, Scap, D) code | run << 8
  const int* __restrict__ fscore;  // (B,)
  const int* __restrict__ foff;    // (B,)
  const int* __restrict__ plen;    // (B,)
  const int* __restrict__ tlen;    // (B,)
  int* nmats;                      // (B, T) match runs
  int8_t* ops;                     // (B, T) ops
  int* lanes;                      // (5, B): gap_t, gap_v, fm, fd, fi
  int* summary;                    // (1,) the longest walk
  int B, Scap, D, K0, x, o, e, T;
};

// Whether the walk at diagonal index j and offset off lies inside the
// alignment (affine_wavefront_backtrace.c's valid location).
__device__ __forceinline__ bool valid_loc(int j, int off, int K0, int pl,
                                          int tl) {
  const int v = off - (j - K0);
  return v > 0 && v <= pl && off > 0 && off <= tl;
}

__global__ void __launch_bounds__(kBtThreads)
wfa_backtrace_kernel(BtParams p) {
  const int b = blockIdx.x * kBtThreads + threadIdx.x;
  if (b >= p.B) return;
  const int K0 = p.K0, D = p.D, Scap = p.Scap;
  const int pl = p.plen[b], tl = p.tlen[b];
  const int oe = p.o + p.e;
  const int jak = min(max(tl - pl + K0, 0), D - 1);   // alignment diagonal
  const int* st = p.store + (size_t)b * Scap * D;
  int* nm_row = p.nmats + (size_t)b * p.T;
  int8_t* op_row = p.ops + (size_t)b * p.T;

  int sc = p.fscore[b], j = jak, off = p.foff[b], bty = kBtM;
  bool valid = valid_loc(jak, off, K0, pl, tl);
  int gap_t = -1, gap_v = 0;
  int t = 0;
  for (; t < p.T; ++t) {
    // a finished walk stays finished: every later step records nothing
    if (!(off - (j - K0) > 0 && off > 0 && sc > 0)) break;
    const bool now = valid_loc(j, off, K0, pl, tl);
    if (!valid && now) {   // the one invalid -> valid gap
      gap_t = t;
      gap_v = j - jak;     // > 0 a 'D' run, < 0 an 'I' run
    }
    valid = valid || now;
    const int word = __ldg(st + (size_t)min(max(sc, 0), Scap - 1) * D +
                           min(max(j, 0), D - 1));
    const int opm = word & 7, opi = (word >> 3) & 1, opd = (word >> 4) & 1;
    const int ext = word >> 8;
    const bool isM = bty == kBtM, isI = bty == kBtI, isD = bty == kBtD;
    int nm = 0;
    if (isM) {
      nm = ext;
      off -= ext;
    }
    const bool de = (isM && opm == kDE) || (isD && opd == 0);
    const bool dop = (isM && opm == kDO) || (isD && opd == 1);
    const bool ie = (isM && opm == kIE) || (isI && opi == 0);
    const bool io = (isM && opm == kIO) || (isI && opi == 1);
    const bool mm = isM && opm == kMM;
    int op = de || dop ? kOpD : ie || io ? kOpI : mm ? kOpX : kOpNone;
    if (!valid) op = kOpNone;   // suppressed outside the alignment
    sc = de || ie ? sc - p.e : dop || io ? sc - oe : mm ? sc - p.x : sc;
    j = de || dop ? j + 1 : ie || io ? j - 1 : j;
    if (ie || io || mm) off -= 1;
    bty = de ? kBtD : ie ? kBtI : dop || io || mm ? kBtM : bty;
    nm_row[t] = nm;
    op_row[t] = (int8_t)op;
  }
  const int steps = t;
  for (; t < p.T; ++t) {
    nm_row[t] = 0;
    op_row[t] = 0;
  }
  const int vf = off - (j - K0);
  p.lanes[b] = gap_t;
  p.lanes[p.B + b] = gap_v;
  p.lanes[2 * p.B + b] = sc == 0 ? off : 0;
  p.lanes[3 * p.B + b] = sc != 0 ? max(vf, 0) : 0;
  p.lanes[4 * p.B + b] = sc != 0 ? max(off, 0) : 0;
  atomicMax(p.summary, steps);
}

}  // namespace

// One thread a pair, in blocks of kBtThreads, on `stream`.  store (B,
// Scap, D) int32 as genarch_wfa_forward wrote it; fscore, foff, plen,
// tlen (B,) int32; nmats (B, T) int32 and ops (B, T) int8, written
// whole; lanes (5, B) int32: gap_t, gap_v and the final runs fm, fd,
// fi; summary (1,) int32, zeroed here before the launch: the most steps
// a pair's walk took.
// Returns the first CUDA error (0 on success).
extern "C" int genarch_wfa_backtrace(const void* store, const void* fscore,
                                     const void* foff, const void* plen,
                                     const void* tlen, void* nmats,
                                     void* ops, void* lanes, void* summary,
                                     int B, int Scap, int D, int K0, int x,
                                     int o, int e, int T, void* stream_) {
  if (B <= 0) return cudaGetLastError();
  BtParams p{static_cast<const int*>(store),
             static_cast<const int*>(fscore),
             static_cast<const int*>(foff),
             static_cast<const int*>(plen),
             static_cast<const int*>(tlen),
             static_cast<int*>(nmats),
             static_cast<int8_t*>(ops),
             static_cast<int*>(lanes),
             static_cast<int*>(summary),
             B, Scap, D, K0, x, o, e, T};
  auto stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err = cudaMemsetAsync(summary, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kBtThreads - 1) / kBtThreads;
  wfa_backtrace_kernel<<<blocks, kBtThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
