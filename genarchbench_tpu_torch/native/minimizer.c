/* Flye's minimizer deque scan for the kmer-cnt minimizer index
 * (kernels/kmer.py::_minimizer_arrays).  Reference semantics:
 * kmer-cnt/kmer.h:206-260 (yieldMinimizers).  The plain version the
 * tests hold this to is kernels/kmer.py::_deque_scan_py. */

#include <stdint.h>
#include <stdlib.h>

/* Sliding-window minimum over the hashes h[0..n) with the reference's
 * exact rules: strictly-greater back pops (ties stay), equal-hash front
 * skipping after expiry, one emit per front position.  Writes the
 * minimizers' positions to out_pos (room for n) and returns how many
 * there are, or -1 when out of memory. */
int64_t minimizer_scan(const uint64_t *h, int64_t n, int64_t window,
                       int64_t *out_pos) {
    if (n <= 0) return 0;
    int64_t *q = (int64_t *)malloc(sizeof(int64_t) * (size_t)n);
    if (!q) return -1;
    int64_t qh = 0, qt = 0, m = 0, last = -1;
    for (int64_t i = 0; i < n; i++) {
        while (qt > qh && h[q[qt - 1]] > h[i]) qt--;
        q[qt++] = i;
        if (q[qh] <= i - window) {
            while (q[qh] <= i - window) qh++;
            while (qt - qh >= 2 && h[q[qh]] == h[q[qh + 1]]) qh++;
        }
        if (last != q[qh]) { out_pos[m++] = q[qh]; last = q[qh]; }
    }
    free(q);
    return m;
}
