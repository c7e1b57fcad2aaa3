/* Host helpers of the chain / fast-chain path (kernels/chain.py,
 * kernels/fast_chain.py): window starts, a plan's padded planes, the
 * f32-vs-f64 gap-cost corrections, and the exact scalar chain DP for
 * the records whose corrections cannot be bounded.  Reference
 * semantics: chain/src/host_kernel.cpp:50-93. */

#include <stdint.h>
#include <stdlib.h>

/* Window starts (host_kernel.cpp:56-57): a persistent two-pointer st
 * advanced while x[i] > x[st] + max_dist_x, clamped at i - max_iter.
 * O(total anchors) across all records; record r spans
 * [offs[r], offs[r + 1]) of x and out. */
void chain_window_starts(int64_t n_rec, const int64_t *offs,
                         const uint64_t *x, const int64_t *mdx,
                         int64_t max_iter, int32_t *out) {
    for (int64_t r = 0; r < n_rec; r++) {
        int64_t lo = offs[r], hi = offs[r + 1];
        int64_t st = lo;
        uint64_t m = (uint64_t)mdx[r];
        for (int64_t i = lo; i < hi; i++) {
            while (x[i] > x[st] + m) st++;
            int64_t v = st - lo;
            int64_t lim = (i - lo) - max_iter;
            if (v < lim) v = lim;
            out[i] = (int32_t)v;
        }
    }
}

/* One plan's (5, B, N) int32 planes, into a zeroed `out`: row b holds
 * the n[b] anchors of the record at flat offset off[b] of x, y and st,
 * decoded as x's low word (uint32 bits), qi (y's low word), span (y
 * bits 32-39), sid (y bits 48-55) and the window start; the window-start
 * plane holds i past n[b] (an empty window), the others stay zero,
 * untouched.  The caller checks 0 <= n[b] <= N and off[b] + n[b] <= A. */
void chain_gather_planes(int64_t B, int64_t N, const uint64_t *x,
                         const uint64_t *y, const int32_t *st,
                         const int64_t *off, const int64_t *n,
                         int32_t *out) {
    for (int64_t b = 0; b < B; b++) {
        const uint64_t *xb = x + off[b], *yb = y + off[b];
        const int32_t *sb = st + off[b];
        int32_t *xl = out + b * N, *q = xl + B * N, *sp = q + B * N;
        int32_t *sd = sp + B * N, *w = sd + B * N;
        int64_t m = n[b];
        for (int64_t i = 0; i < m; i++) {
            xl[i] = (int32_t)(uint32_t)xb[i];
            q[i] = (int32_t)(uint32_t)yb[i];
            sp[i] = (int32_t)((yb[i] >> 32) & 0xFF);
            sd[i] = (int32_t)((yb[i] >> 48) & 0xFF);
            w[i] = sb[i];
        }
        for (int64_t i = m; i < N; i++) w[i] = (int32_t)i;
    }
}

/* Gap-cost corrections: for record r the device computes
 *   appr32 = (f32)((f32)dd * 0.01f) * avg32[r]
 * while the reference computes (int)((f64)(dd * .01) * avg)
 * (host_kernel.cpp:74).  The truncations can only differ when the
 * product is within ~4e-3 of an integer, i.e. dd within (4e-3/c) of
 * k/c for c = 0.01*avg, so the scan enumerates the candidate integers
 * k and tests dd = round(k/c) +- 1 instead of every dd.  Writes up to
 * ck (dd, delta) pairs per record; rows needing more, or whose largest
 * product exceeds safe_prod (where the window no longer bounds the f32
 * error), get over[r] = 1 and go to chain_dp_scalar.  Rows with
 * avg < 2 (c < 0.02: one integer may map to more than 3 dd values) are
 * scanned densely. */
void chain_gap_corr(int64_t nb, const float *avg32, int64_t t_size,
                    int64_t ck, double safe_prod, int32_t *corr_dd,
                    int32_t *corr_delta, uint8_t *over) {
    for (int64_t r = 0; r < nb; r++) {
        float a32 = avg32[r];
        double av = (double)a32;
        double c = 0.01 * av;
        over[r] = 0;
        if (av * ((double)(t_size - 1) * 0.01) > safe_prod) {
            over[r] = 1;
            continue;
        }
        if (av < 2.0) {
            int64_t cnt = 0;
            for (int64_t dd = 1; dd < t_size; dd++) {
                float ap = ((float)dd * 0.01f) * a32;
                int32_t ai = (int32_t)ap;
                int32_t ei = (int32_t)((double)dd * 0.01 * av);
                if (ai != ei) {
                    if (cnt < ck) {
                        corr_dd[r * ck + cnt] = (int32_t)dd;
                        corr_delta[r * ck + cnt] = ei - ai;
                    }
                    cnt++;
                }
            }
            over[r] = cnt > ck;
            continue;
        }
        int64_t kmax = (int64_t)(c * (double)(t_size - 1)) + 1;
        int64_t cnt = 0;
        int64_t last_dd = -1;
        for (int64_t k = 1; k <= kmax && cnt <= ck; k++) {
            int64_t dd0 = (int64_t)(((double)k) / c + 0.5);
            for (int64_t dd = dd0 - 1; dd <= dd0 + 1; dd++) {
                if (dd < 1 || dd >= t_size || dd <= last_dd) continue;
                float ap = ((float)dd * 0.01f) * a32;
                int32_t ai = (int32_t)ap;
                int32_t ei = (int32_t)((double)dd * 0.01 * av);
                if (ai != ei) {
                    last_dd = dd;
                    if (cnt < ck) {
                        corr_dd[r * ck + cnt] = (int32_t)dd;
                        corr_delta[r * ck + cnt] = ei - ai;
                    }
                    cnt++;
                }
            }
        }
        over[r] = cnt > ck;
    }
}

/* The exact scalar chain DP with minimap2's skip heuristic
 * (host_kernel.cpp:50-93): per anchor, a descending scan of its window
 * with the strict sc > max_f rule (ties keep the largest j), the t[]
 * skip markers with MAX_SKIP = 25, and the f64 gap cost.  Record b
 * holds the ns[b] anchors at flat offset off[b] of x, y and st_flat,
 * decoded as chain_gather_planes decodes them into rows beside t[];
 * its scores, parents and peaks follow record b - 1's.
 * Returns 0, -1 when out of memory, or -2 when a window start of the
 * record about to be scanned lies outside [0, i].  The caller checks
 * ns[b] >= 0 and off[b] + ns[b] <= the flat length. */
int chain_dp_scalar(int64_t B, const int64_t *ns, const int64_t *off,
                    const float *avg, const int32_t *mdx_a,
                    const int32_t *mdy_a, const int32_t *bw_a,
                    const int32_t *nsegs_a, const uint64_t *x,
                    const uint64_t *y, const int32_t *st_flat,
                    int32_t *scores, int32_t *parents, int32_t *peaks) {
    for (int64_t b = 0, o = 0; b < B; o += ns[b++]) {
        const uint64_t *xb = x + off[b], *yb = y + off[b];
        const int32_t *st = st_flat + off[b];
        int32_t *sc = scores + o, *par = parents + o, *pk = peaks + o;
        int64_t n = ns[b];
        double av = (double)avg[b];
        int32_t mdx = mdx_a[b], mdy = mdy_a[b], bw = bw_a[b];
        int32_t nsegs = nsegs_a[b];
        int32_t *t = (int32_t *)malloc((size_t)(n > 0 ? n : 1)
                                       * (3 * sizeof(int32_t) + 2));
        if (!t) return -1;
        uint32_t *xl = (uint32_t *)(t + n);
        int32_t *q = (int32_t *)(xl + n);
        uint8_t *sp = (uint8_t *)(q + n), *sd = sp + n;
        for (int64_t i = 0; i < n; i++) {
            if (st[i] < 0 || st[i] > i) {
                free(t);
                return -2;
            }
            t[i] = -1;
            xl[i] = (uint32_t)xb[i];
            q[i] = (int32_t)(uint32_t)yb[i];
            sp[i] = (uint8_t)(yb[i] >> 32);
            sd[i] = (uint8_t)(yb[i] >> 48);
        }
        for (int64_t i = 0; i < n; i++) {
            int32_t max_f = sp[i], max_j = -1, nskip = 0;
            for (int64_t j = i - 1; j >= st[i]; j--) {
                int32_t dr = (int32_t)(xl[i] - xl[j]);
                int32_t dq = q[i] - q[j];
                int seq = sd[i] == sd[j];
                if ((seq && dr == 0) || dq <= 0) continue;
                if ((seq && dq > mdy) || dq > mdx) continue;
                int32_t dd = dr - dq;
                if (dd < 0) dd = -dd;
                if (seq && dd > bw) continue;
                if (nsegs > 1 && seq && dr > mdy) continue;
                int32_t log_dd =
                    dd ? 31 - __builtin_clz((uint32_t)dd) : 0;
                int32_t clin = (int32_t)((double)dd * 0.01 * av);
                int32_t gap, bonus = 0;
                if (seq) gap = clin + (log_dd >> 1);
                else if (dr == 0) { gap = 0; bonus = 1; }
                else gap = clin < log_dd ? clin : log_dd;
                int32_t s0 = dq < dr ? dq : dr;
                if ((int32_t)sp[i] < s0) s0 = sp[i];
                int32_t s = s0 + bonus - gap + sc[j];
                if (s > max_f) {
                    max_f = s;
                    max_j = (int32_t)j;
                    if (nskip > 0) nskip--;
                } else if (t[j] == (int32_t)i) {
                    if (++nskip > 25) break;
                }
                if (par[j] >= 0) t[par[j]] = (int32_t)i;
            }
            sc[i] = max_f;
            par[i] = max_j;
            pk[i] = (max_j >= 0 && pk[max_j] > max_f) ? pk[max_j]
                                                      : max_f;
        }
        free(t);
    }
    return 0;
}
