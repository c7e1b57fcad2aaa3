/* SA-IS linear-time suffix array construction (induced sorting).
 *
 * Role: scalable replacement for the prefix-doubling suffix sort in
 * the FM-index artifact build (the reference builds its index with
 * its own O(n) machinery, bwa-mem2 x86_64/src/FMI_search.cpp:162-298;
 * divsufsort there).  Written from scratch following the classic
 * Nong-Zhang-Chan induced-sorting construction.
 *
 * Contract: T[0..n-1] with a UNIQUE SMALLEST sentinel at T[n-1]
 * (callers append 0 and shift real characters to >= 1); values < K.
 * SA receives the full suffix array (SA[0] = n-1, the sentinel).
 * Returns 0 on success, -1 on allocation failure.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define CHR(i) (level ? ((const int64_t *)T)[i] : ((const uint8_t *)T)[i])

static void fill_buckets(const void *T, int level, int64_t n, int64_t K,
                         int64_t *C, int64_t *B, int end) {
    int64_t i, k, s = 0;
    memset(C, 0, (size_t)K * sizeof(int64_t));
    for (i = 0; i < n; i++) C[CHR(i)]++;
    for (k = 0; k < K; k++) {
        s += C[k];
        B[k] = end ? s : s - C[k];
    }
}

static void induce(const void *T, int level, int64_t *SA,
                   const uint8_t *t, int64_t n, int64_t K,
                   int64_t *C, int64_t *B) {
    int64_t i, j;
    /* induce L from bucket heads */
    fill_buckets(T, level, n, K, C, B, 0);
    for (i = 0; i < n; i++) {
        j = SA[i] - 1;
        if (SA[i] > 0 && !t[j]) SA[B[CHR(j)]++] = j;
    }
    /* induce S from bucket ends */
    fill_buckets(T, level, n, K, C, B, 1);
    for (i = n - 1; i >= 0; i--) {
        j = SA[i] - 1;
        if (SA[i] > 0 && t[j]) SA[--B[CHR(j)]] = j;
    }
}

static int sais_rec(const void *T, int level, int64_t *SA,
                    int64_t n, int64_t K) {
    int64_t i, j, m, nm, prev;
    uint8_t *t;
    int64_t *C, *B;
    if (n == 1) { SA[0] = 0; return 0; }

    t = (uint8_t *)malloc((size_t)n);
    C = (int64_t *)malloc((size_t)K * sizeof(int64_t));
    B = (int64_t *)malloc((size_t)K * sizeof(int64_t));
    if (!t || !C || !B) { free(t); free(C); free(B); return -1; }

    t[n - 1] = 1;                            /* sentinel: S-type */
    for (i = n - 2; i >= 0; i--)
        t[i] = (CHR(i) < CHR(i + 1)
                || (CHR(i) == CHR(i + 1) && t[i + 1])) ? 1 : 0;

    /* step 1: place LMS suffixes at bucket ends, induce-sort them */
    fill_buckets(T, level, n, K, C, B, 1);
    for (i = 0; i < n; i++) SA[i] = -1;
    for (i = 1; i < n; i++)
        if (t[i] && !t[i - 1]) SA[--B[CHR(i)]] = i;
    induce(T, level, SA, t, n, K, C, B);

    /* compact the sorted LMS positions into SA[0..m) */
    m = 0;
    for (i = 0; i < n; i++) {
        int64_t p = SA[i];
        if (p > 0 && t[p] && !t[p - 1]) SA[m++] = p;
    }
    for (i = m; i < n; i++) SA[i] = -1;

    /* step 2: name LMS substrings (equal substrings share a name) */
    nm = 0;
    prev = -1;
    for (i = 0; i < m; i++) {
        int64_t p = SA[i], d, diff = 1;
        if (prev >= 0) {
            diff = 0;
            for (d = 0; ; d++) {
                if (CHR(p + d) != CHR(prev + d)
                    || t[p + d] != t[prev + d]) { diff = 1; break; }
                if (d > 0 && t[p + d] && !t[p + d - 1]) break;
            }
        }
        if (diff) { nm++; prev = p; }
        SA[m + p / 2] = nm - 1;
    }
    for (i = n - 1, j = n - 1; i >= m; i--)
        if (SA[i] >= 0) SA[j--] = SA[i];

    /* step 3: sort the reduced string (recursively if names repeat) */
    {
        int64_t *T1 = SA + n - m;
        if (nm < m) {
            if (sais_rec(T1, 1, SA, m, nm) != 0) {
                free(t); free(C); free(B); return -1;
            }
        } else {
            for (i = 0; i < m; i++) SA[T1[i]] = i;
        }
        /* map reduced indices back to LMS text positions */
        for (i = 1, j = 0; i < n; i++)
            if (t[i] && !t[i - 1]) T1[j++] = i;
        for (i = 0; i < m; i++) SA[i] = T1[SA[i]];
    }

    /* step 4: final induced sort from the fully sorted LMS order */
    for (i = m; i < n; i++) SA[i] = -1;
    fill_buckets(T, level, n, K, C, B, 1);
    for (i = m - 1; i >= 0; i--) {
        j = SA[i];
        SA[i] = -1;
        SA[--B[CHR(j)]] = j;
    }
    induce(T, level, SA, t, n, K, C, B);

    free(t); free(C); free(B);
    return 0;
}

int sais_u8(const uint8_t *T, int64_t n, int64_t K, int64_t *SA) {
    if (n <= 0) return -1;
    return sais_rec(T, 0, SA, n, K);
}
