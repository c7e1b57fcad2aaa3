/* BGZF block decoder for the port's BAM reader (io/bam_io.py::
 * bgzf_read), the role htslib's bgzf.c plays in the reference.  It scans
 * the BGZF framing (gzip members with the BC extra field), inflates
 * every block with raw zlib and concatenates them into the caller's
 * buffer.  Built apart from the port's other helpers because it links
 * zlib (-lz).  The plain version the tests hold this to is
 * io/bam_io.py::bgzf_read_plain.
 *
 *   int64_t bgzf_decompressed_size(const uint8_t*, int64_t);
 *       the total uncompressed size, or -1 on a framing error
 *   int64_t bgzf_decompress(const uint8_t*, int64_t, uint8_t*, int64_t);
 *       inflates every block into out; the bytes written, or -1
 */

#include <stdint.h>
#include <string.h>
#include <zlib.h>

static int64_t block_size_at(const uint8_t *p, int64_t remaining) {
    if (remaining < 18 || p[0] != 0x1f || p[1] != 0x8b) return -1;
    uint16_t xlen = (uint16_t)(p[10] | (p[11] << 8));
    if (remaining < 12 + xlen) return -1;
    const uint8_t *extra = p + 12;
    int64_t e = 0;
    while (e + 4 <= xlen) {
        uint8_t si1 = extra[e], si2 = extra[e + 1];
        uint16_t slen = (uint16_t)(extra[e + 2] | (extra[e + 3] << 8));
        if (si1 == 66 && si2 == 67 && slen >= 2) {
            uint16_t bsize = (uint16_t)(extra[e + 4] | (extra[e + 5] << 8));
            return (int64_t)bsize + 1;
        }
        e += 4 + slen;
    }
    return -1;
}

int64_t bgzf_decompressed_size(const uint8_t *data, int64_t n) {
    int64_t pos = 0, total = 0;
    while (pos < n) {
        int64_t bs = block_size_at(data + pos, n - pos);
        if (bs < 0 || pos + bs > n) return -1;
        /* ISIZE: the member's last 4 bytes */
        const uint8_t *t = data + pos + bs - 4;
        total += (int64_t)(t[0] | (t[1] << 8) | (t[2] << 16)
                           | ((uint32_t)t[3] << 24));
        pos += bs;
    }
    return total;
}

int64_t bgzf_decompress(const uint8_t *data, int64_t n, uint8_t *out,
                        int64_t out_cap) {
    int64_t pos = 0, w = 0;
    while (pos < n) {
        int64_t bs = block_size_at(data + pos, n - pos);
        if (bs < 0 || pos + bs > n) return -1;
        uint16_t xlen = (uint16_t)(data[pos + 10] | (data[pos + 11] << 8));
        const uint8_t *payload = data + pos + 12 + xlen;
        int64_t payload_len = bs - 12 - xlen - 8;
        if (payload_len < 0) return -1;

        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK) return -1;
        zs.next_in = (uint8_t *)payload;
        zs.avail_in = (uInt)payload_len;
        zs.next_out = out + w;
        zs.avail_out = (uInt)(out_cap - w);
        int ret = inflate(&zs, Z_FINISH);
        int64_t produced = (int64_t)zs.total_out;
        inflateEnd(&zs);
        if (ret != Z_STREAM_END && !(ret == Z_BUF_ERROR && produced == 0))
            return -1;
        w += produced;
        pos += bs;
    }
    return w;
}
