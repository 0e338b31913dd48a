/* Fast COLMAP binary parsers (host I/O, not a device kernel).
 *
 * A copy of rain_tpu/native/colmap_fast.c. The reference parses sparse
 * reconstructions with per-record Python struct.unpack loops
 * (scene/colmap_loader.py:65-224); points3D.bin for a large scene holds
 * millions of variable-length records and dominates scene-load time.
 * These C parsers walk the buffers once and fill caller-provided (numpy)
 * arrays; rain_tpu_torch.native builds them with cc and binds them with
 * ctypes. Unlike rain_tpu's, a file that ends before its last
 * record returns -1 (the caller raises) instead of the header's count.
 *
 * COLMAP layouts:
 *   points3D.bin: u64 count, then per point:
 *     u64 id, f64 xyz[3], u8 rgb[3], f64 error, u64 track_len,
 *     (i32 image_id, i32 point2D_idx) * track_len
 *   images.bin: u64 count, then per image:
 *     i32 image_id, f64 qvec[4], f64 tvec[3], i32 camera_id,
 *     null-terminated name, u64 num_points2D, (f64 x, f64 y, i64 id) * n
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static long read_file(const char *path, unsigned char **out) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    unsigned char *buf = (unsigned char *)malloc(size);
    if (!buf) { fclose(f); return -1; }
    if (fread(buf, 1, size, f) != (size_t)size) {
        free(buf); fclose(f); return -1;
    }
    fclose(f);
    *out = buf;
    return size;
}

/* Parse points3D.bin into xyz [cap*3] f64, rgb [cap*3] u8, err [cap] f64.
 * Returns the point count (fills min(count, cap) records), or -1. */
long colmap_parse_points3d(const char *path, double *xyz,
                           unsigned char *rgb, double *err, long cap) {
    unsigned char *buf;
    long size = read_file(path, &buf);
    if (size < 0) return -1;
    if (size < 8) { free(buf); return -1; }
    uint64_t n;
    memcpy(&n, buf, 8);
    long off = 8;
    uint64_t i;
    for (i = 0; i < n && off + 51 <= size; i++) {
        if ((long)i < cap) {
            memcpy(xyz + 3 * i, buf + off + 8, 24);
            memcpy(rgb + 3 * i, buf + off + 32, 3);
            memcpy(err + i, buf + off + 35, 8);
        }
        uint64_t track_len;
        memcpy(&track_len, buf + off + 43, 8);
        off += 51 + 8 * (long)track_len;
    }
    free(buf);
    if (i < n || off > size) return -1; /* truncated */
    return (long)n;
}

/* Parse images.bin. Fills per image: qvec [cap*4] f64, tvec [cap*3] f64,
 * ids [cap*2] i32 (image_id, camera_id), names [cap*256] bytes
 * (null-terminated, truncated at 255). Returns image count or -1. */
long colmap_parse_images(const char *path, double *qvec, double *tvec,
                         int32_t *ids, char *names, long cap) {
    unsigned char *buf;
    long size = read_file(path, &buf);
    if (size < 0) return -1;
    if (size < 8) { free(buf); return -1; }
    uint64_t n;
    memcpy(&n, buf, 8);
    long off = 8;
    uint64_t i;
    for (i = 0; i < n && off + 64 <= size; i++) {
        int32_t image_id, camera_id;
        memcpy(&image_id, buf + off, 4);
        if ((long)i < cap) {
            memcpy(qvec + 4 * i, buf + off + 4, 32);
            memcpy(tvec + 3 * i, buf + off + 36, 24);
        }
        memcpy(&camera_id, buf + off + 60, 4);
        off += 64;
        long name_start = off;
        while (off < size && buf[off] != 0) off++;
        if ((long)i < cap) {
            long len = off - name_start;
            if (len > 255) len = 255;
            memcpy(names + 256 * i, buf + name_start, len);
            names[256 * i + len] = 0;
            ids[2 * i] = image_id;
            ids[2 * i + 1] = camera_id;
        }
        off++; /* skip the null terminator */
        if (off + 8 > size) { off = size + 1; break; }
        uint64_t npts;
        memcpy(&npts, buf + off, 8);
        off += 8 + 24 * (long)npts;
    }
    free(buf);
    if (i < n || off > size) return -1; /* truncated */
    return (long)n;
}
