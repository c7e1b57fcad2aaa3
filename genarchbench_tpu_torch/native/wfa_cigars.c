/* WFA RLE-CIGAR assembly from the backtrace's emission-order records.
 *
 * The port's own copy of the JAX package's readers.c::wfa_cigars, with
 * the semantics of kernels/wfa.py::_assemble_cigar: the reference writes
 * ops backwards into its buffer (affine_wavefront_backtrace.c:259,
 * 310-370), then edit_cigar.c:184-200 RLE-encodes; here the
 * forward-order run list is emitted reversed with adjacent runs of one
 * op merged.  Differences from the JAX package's copy: the match runs
 * are int32 (not int16), every write is bounded by `stride`, and all T
 * steps are read (the JAX copy takes a separate step count).
 *
 * Records, row-major (B, T): nmats[b*T + t] the match run of step t,
 * ops[b*T + t] its op (1=D 2=I 3=X, 0 none).  Per lane: gap_t (the step
 * at which the invalid->valid gap is emitted, -1 for none), gap_v (>0 a
 * 'D' run, <0 an 'I' run), and the final fm/fd/fi runs.  Lane b's CIGAR
 * is written at out + b*stride, its length in outlen[b].
 *
 * Returns 0, -1 when out of memory, or b+1 when lane b's CIGAR does not
 * fit in stride bytes. */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

int wfa_cigars(int64_t B, int64_t T,
               const int32_t *nmats, const int8_t *ops,
               const int32_t *gap_t, const int32_t *gap_v,
               const int32_t *fm, const int32_t *fd, const int32_t *fi,
               char *out, int64_t stride, int32_t *outlen) {
    static const char OPC[4] = {'?', 'D', 'I', 'X'};
    int64_t cap = 2 * T + 8;
    int64_t *rc = (int64_t *)malloc((size_t)cap * sizeof(int64_t));
    char *rch = (char *)malloc((size_t)cap);
    if (!rc || !rch) { free(rc); free(rch); return -1; }
    for (int64_t b = 0; b < B; b++) {
        int64_t nr = 0;
        for (int64_t t = 0; t < T; t++) {
            if (t == gap_t[b]) {
                int32_t g = gap_v[b];
                if (g > 0) { rc[nr] = g; rch[nr++] = 'D'; }
                else if (g < 0) { rc[nr] = -(int64_t)g; rch[nr++] = 'I'; }
            }
            int32_t nm = nmats[b * T + t];
            if (nm > 0) { rc[nr] = nm; rch[nr++] = 'M'; }
            int8_t op = ops[b * T + t];
            if (op > 0 && op < 4) { rc[nr] = 1; rch[nr++] = OPC[(int)op]; }
        }
        if (fm[b] > 0) { rc[nr] = fm[b]; rch[nr++] = 'M'; }
        if (fd[b] > 0) { rc[nr] = fd[b]; rch[nr++] = 'D'; }
        if (fi[b] > 0) { rc[nr] = fi[b]; rch[nr++] = 'I'; }
        char *w0 = out + b * stride;
        int64_t len = 0;
        for (int64_t r = nr - 1; r >= 0;) {
            char c = rch[r];
            int64_t cnt = 0;
            while (r >= 0 && rch[r] == c) { cnt += rc[r]; r--; }
            int n = snprintf(w0 + len, (size_t)(stride - len), "%lld%c",
                             (long long)cnt, c);
            if (n < 0 || len + n >= stride) {
                free(rc);
                free(rch);
                return (int)(b + 1);
            }
            len += n;
        }
        outlen[b] = (int32_t)len;
    }
    free(rc);
    free(rch);
    return 0;
}
