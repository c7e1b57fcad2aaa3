/* Event detection's peak finder for the abea path (kernels/abea.py::
 * get_events).  Reference semantics: abea/src/events.c:370-470
 * (short_long_peak_detector): two detectors, over the short- and the
 * long-window t-statistics, each a small state machine run once over
 * the samples; a peak of the short detector above its threshold masks
 * the long detector for the short window's length.  Float arithmetic
 * is plain C float, as in the reference.  The plain version the tests
 * hold this to is kernels/abea.py::_peak_detect. */

#include <stdint.h>

/* Writes the peaks' sample positions to peaks_out (room for n) and
 * returns how many there are. */
int64_t peak_detect(const float *t1, const float *t2, int64_t n,
                    float thr1, float thr2, int64_t wl1, int64_t wl2,
                    float peak_height, int64_t *peaks_out) {
    const float *sig[2] = {t1, t2};
    float thr[2] = {thr1, thr2};
    int64_t wl[2] = {wl1, wl2};
    int64_t masked[2] = {0, 0};
    int64_t pos[2] = {-1, -1};
    float val[2] = {3.402823466e+38f, 3.402823466e+38f};
    int valid[2] = {0, 0};
    int64_t pc = 0;
    for (int64_t i = 0; i < n; i++) {
        for (int k = 0; k < 2; k++) {
            if (masked[k] >= i) continue;
            float cur = sig[k][i];
            if (pos[k] == -1) {
                if (cur < val[k]) {
                    val[k] = cur;
                } else if (cur - val[k] > peak_height) {
                    val[k] = cur;
                    pos[k] = i;
                }
            } else {
                if (cur > val[k]) {
                    val[k] = cur;
                    pos[k] = i;
                }
                if (k == 0 && val[k] > thr[k]) {
                    masked[1] = pos[0] + wl[0];
                    pos[1] = -1;
                    val[1] = 3.402823466e+38f;
                    valid[1] = 0;
                }
                if (val[k] - cur > peak_height && val[k] > thr[k])
                    valid[k] = 1;
                if (valid[k] && (i - pos[k]) > wl[k] / 2) {
                    peaks_out[pc++] = pos[k];
                    pos[k] = -1;
                    val[k] = cur;
                    valid[k] = 0;
                }
            }
        }
    }
    return pc;
}
