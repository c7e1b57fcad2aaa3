/* FASTA / FASTQ reader for the port's io/fasta_io.py::read_fasta, the
 * role kseq.h plays in the reference (kmer-cnt's SequenceContainer,
 * kmer-cnt/sequence_container.cpp:81-300).  A two-pass API: scan the
 * sizes, then fill buffers the caller allocated, so Python owns all
 * memory.  gzip input is read through zlib's gzFile, so this source is
 * built into the zlib-linked library beside bgzf_native.c.  The plain
 * version the tests hold this to is io/fasta_io.py::_read_fasta_py.
 *
 * Encodings:
 *   table 0 (dna2bit): ACGTacgt -> 0..3, everything else -> 3
 *   table 1 (dna5):    ACGTacgt -> 0..3, everything else -> 4
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

#define LINE_CAP_INIT (1 << 16)

typedef struct {
    gzFile f;
    char *buf;
    size_t cap;
} reader_t;

static int rd_open(reader_t *r, const char *path) {
    r->f = gzopen(path, "rb");
    if (!r->f) return -1;
    gzbuffer(r->f, 1 << 20);
    r->cap = LINE_CAP_INIT;
    r->buf = (char *)malloc(r->cap);
    return r->buf ? 0 : -1;
}

static void rd_close(reader_t *r) {
    if (r->f) gzclose(r->f);
    free(r->buf);
}

/* read one line (without trailing \n / \r\n); returns length or -1 at EOF */
static int64_t rd_line(reader_t *r) {
    size_t len = 0;
    for (;;) {
        if (len + 4096 > r->cap) {
            r->cap *= 2;
            char *nb = (char *)realloc(r->buf, r->cap);
            if (!nb) return -1;
            r->buf = nb;
        }
        if (!gzgets(r->f, r->buf + len, (int)(r->cap - len)))
            return len ? (int64_t)len : -1;
        len += strlen(r->buf + len);
        if (len && r->buf[len - 1] == '\n') {
            len--;
            if (len && r->buf[len - 1] == '\r') len--;
            r->buf[len] = 0;
            return (int64_t)len;
        }
        if (gzeof(r->f)) return (int64_t)len;
    }
}

static void enc_tables(uint8_t *t2, uint8_t *t5) {
    for (int i = 0; i < 256; i++) { t2[i] = 3; t5[i] = 4; }
    const char *b = "ACGT";
    for (int i = 0; i < 4; i++) {
        t2[(int)b[i]] = (uint8_t)i;  t2[(int)(b[i] + 32)] = (uint8_t)i;
        t5[(int)b[i]] = (uint8_t)i;  t5[(int)(b[i] + 32)] = (uint8_t)i;
    }
}

/* ------------------------------------------------------------------ */
/* FASTA / FASTQ (auto-detected on the first byte, like the Python)    */
/* ------------------------------------------------------------------ */

/* pass 1: kept records (len > min_len), name bytes for them, and
 * bases_out = UNFILTERED total bases — the load pass writes every
 * record's body into the buffer before deciding keep/drop (dropped
 * bodies are overwritten by the next record), so the caller must size
 * `codes` for the unfiltered maximum. */
int64_t fasta_scan(const char *path, int64_t min_len,
                   int64_t *n_out, int64_t *bases_out, int64_t *names_out) {
    reader_t r;
    if (rd_open(&r, path)) return -1;
    int64_t n = 0, bases = 0, names = 0, len;
    int64_t first = rd_line(&r);
    if (first < 0) { rd_close(&r); *n_out = 0; *bases_out = 0; *names_out = 0; return 0; }
    int fastq = r.buf[0] == '@';
    if (fastq) {
        for (;;) {
            /* header already in buf */
            size_t nl = strcspn(r.buf + 1, " \t");
            int64_t slen = rd_line(&r);
            if (slen < 0) break;
            rd_line(&r); rd_line(&r);          /* '+' and quals */
            bases += slen;
            if (slen > min_len) { n++; names += (int64_t)nl + 1; }
            if (rd_line(&r) < 0) break;        /* next header */
        }
    } else {
        int64_t cur = 0, nl = (int64_t)strcspn(r.buf + 1, " \t");
        int have = 1;
        while ((len = rd_line(&r)) >= 0) {
            if (r.buf[0] == '>') {
                bases += cur;
                if (have && cur > min_len) { n++; names += nl + 1; }
                cur = 0; nl = (int64_t)strcspn(r.buf + 1, " \t"); have = 1;
            } else cur += len;
        }
        bases += cur;
        if (have && cur > min_len) { n++; names += nl + 1; }
    }
    rd_close(&r);
    *n_out = n; *bases_out = bases; *names_out = names;
    return 0;
}

/* pass 2: codes (uint8, table-encoded), offsets (n+1), names buffer */
int64_t fasta_load(const char *path, int64_t min_len, int table,
                   uint8_t *codes, int64_t *offsets, char *names) {
    uint8_t t2[256], t5[256];
    enc_tables(t2, t5);
    const uint8_t *enc = table ? t5 : t2;
    reader_t r;
    if (rd_open(&r, path)) return -1;
    int64_t n = 0, w = 0, len;
    char *np = names;
    offsets[0] = 0;
    int64_t first = rd_line(&r);
    if (first < 0) { rd_close(&r); return 0; }
    int fastq = r.buf[0] == '@';
    if (fastq) {
        for (;;) {
            size_t nl = strcspn(r.buf + 1, " \t");
            char name[4096];
            size_t cl = nl < sizeof(name) ? nl : sizeof(name) - 1;
            memcpy(name, r.buf + 1, cl); name[cl] = 0;
            int64_t slen = rd_line(&r);
            if (slen < 0) break;
            if (slen > min_len) {
                for (int64_t i = 0; i < slen; i++)
                    codes[w + i] = enc[(uint8_t)r.buf[i]];
                w += slen; offsets[++n] = w;
                memcpy(np, name, cl); np += cl; *np++ = '\n';
            }
            rd_line(&r); rd_line(&r);
            if (rd_line(&r) < 0) break;
        }
    } else {
        char name[4096]; name[0] = 0;
        size_t nl = strcspn(r.buf + 1, " \t");
        size_t cl = nl < sizeof(name) ? nl : sizeof(name) - 1;
        memcpy(name, r.buf + 1, cl); name[cl] = 0;
        int64_t cur = 0;
        while ((len = rd_line(&r)) >= 0) {
            if (r.buf[0] == '>') {
                if (cur > min_len) {             /* keep: advance w */
                    w += cur; offsets[++n] = w;
                    size_t L = strlen(name);
                    memcpy(np, name, L); np += L; *np++ = '\n';
                }                                /* drop: w stays, codes
                                                    get overwritten */
                cur = 0;
                nl = strcspn(r.buf + 1, " \t");
                cl = nl < sizeof(name) ? nl : sizeof(name) - 1;
                memcpy(name, r.buf + 1, cl); name[cl] = 0;
            } else {
                for (int64_t i = 0; i < len; i++)
                    codes[w + cur + i] = enc[(uint8_t)r.buf[i]];
                cur += len;
            }
        }
        if (cur > min_len) {
            w += cur; offsets[++n] = w;
            size_t L = strlen(name);
            memcpy(np, name, L); np += L; *np++ = '\n';
        }
    }
    rd_close(&r);
    return n;
}
