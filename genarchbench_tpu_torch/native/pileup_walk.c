/* Medaka's pileup walk for the pileup path (kernels/pileup.py::
 * calculate_pileup).  Reference semantics: pileup/src/medaka_counts.c
 * :375-476 over htslib's mpileup states (resolve_cigar2).  Every
 * read's CIGAR is walked once; for the reference positions in
 * [start, end) it emits one (position, minor column, feature) event per
 * counted base or deletion, and records each position's largest
 * insertion (cov, -1 where no read covers it) and its presence.  The
 * card then turns the events into the count matrix with one scatter-add.
 * The plain version the tests hold this to is kernels/pileup.py::
 * _events_plain (numpy, one read at a time). */

#include <stdint.h>

/* Two passes: with cap == 0 only the events are counted; with cap > 0
 * they are also written (ev_p chunk-relative, ev_j the minor column,
 * ev_f = FEATLEN * quality stratum + base index, deletions at stratum
 * 0), at most cap of them.  Returns the number of events. */
int64_t pileup_events(
    int64_t n_records, const int64_t *rpos, const int32_t *rflag,
    const int32_t *rmapq, const int32_t *rrefid,
    const int64_t *cig_off, const int32_t *cig_op, const int32_t *cig_len,
    const int64_t *seq_off, const uint8_t *nt16, const uint8_t *qual,
    int32_t chrom_id, int64_t start, int64_t end,
    int32_t filter_flags, const int32_t *num2countbase,
    int64_t *cov, uint8_t *present,
    int32_t *ev_p, int32_t *ev_j, int32_t *ev_f, int64_t cap) {
    const int FEATLEN = 10, FWD_DEL = 9, REV_DEL = 8, NUM_HOMOP = 5;
    int64_t m = 0;
    for (int64_t r = 0; r < n_records; r++) {
        if (rrefid[r] != chrom_id || (rflag[r] & filter_flags)
            || rmapq[r] < 1) continue;
        int64_t rp = rpos[r], qp = 0;
        const int32_t *ops = cig_op + cig_off[r];
        const int32_t *lens = cig_len + cig_off[r];
        int64_t nc = cig_off[r + 1] - cig_off[r];
        /* the read's reference span, to skip reads outside the chunk */
        int64_t span = 0;
        for (int64_t c = 0; c < nc; c++)
            if (ops[c] == 0 || ops[c] == 2 || ops[c] == 3
                || ops[c] == 7 || ops[c] == 8) span += lens[c];
        if (rp >= end || rp + span <= start) continue;
        int rev = (rflag[r] & 16) != 0;
        const uint8_t *nt = nt16 + seq_off[r];
        const uint8_t *qu = qual + seq_off[r];
        for (int64_t c = 0; c < nc; c++) {
            int32_t op = ops[c], ln = lens[c];
            if (op == 0 || op == 7 || op == 8) {        /* M = X */
                int32_t nxt_op = c + 1 < nc ? ops[c + 1] : -1;
                int32_t nxt_len = c + 1 < nc ? lens[c + 1] : 0;
                for (int64_t i = 0; i < ln; i++) {
                    int64_t p = rp + i;
                    if (p < start || p >= end) continue;
                    int64_t ind = (i == ln - 1 && nxt_op == 1)
                        ? nxt_len : 0;
                    int64_t o = p - start;
                    present[o] = 1;
                    if (ind > cov[o]) cov[o] = ind;
                    else if (cov[o] < 0) cov[o] = 0;
                    for (int64_t j = 0; j <= ind; j++) {
                        int b = nt[qp + i + j] + (rev ? 16 : 0);
                        int fi = num2countbase[b];
                        if (fi < 0) continue;
                        int qs = qu[qp + i + j];
                        if (qs > NUM_HOMOP) qs = NUM_HOMOP;
                        qs = qs - 1; if (qs < 0) qs = 0;
                        if (m < cap) {
                            ev_p[m] = (int32_t)o; ev_j[m] = (int32_t)j;
                            ev_f[m] = FEATLEN * qs + fi;
                        }
                        m++;
                    }
                }
                rp += ln; qp += ln;
            } else if (op == 1 || op == 4) {            /* I / S */
                qp += ln;
            } else if (op == 2) {                       /* D */
                for (int64_t i = 0; i < ln; i++) {
                    int64_t p = rp + i;
                    if (p < start || p >= end) continue;
                    int64_t o = p - start;
                    present[o] = 1;
                    if (cov[o] < 0) cov[o] = 0;
                    if (m < cap) {
                        ev_p[m] = (int32_t)o; ev_j[m] = 0;
                        ev_f[m] = rev ? REV_DEL : FWD_DEL;
                    }
                    m++;
                }
                rp += ln;
            } else if (op == 3) {                       /* N: refskip */
                for (int64_t i = 0; i < ln; i++) {
                    int64_t p = rp + i;
                    if (p < start || p >= end) continue;
                    int64_t o = p - start;
                    present[o] = 1;
                    if (cov[o] < 0) cov[o] = 0;
                }
                rp += ln;
            }
            /* H, P consume nothing */
        }
    }
    return m;
}
