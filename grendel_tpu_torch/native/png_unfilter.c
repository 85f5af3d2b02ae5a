/* PNG row unfiltering over a whole image (PNG specification, section 9).
 *
 * utils/png.py read_png inflates a PNG's IDAT stream with zlib and hands
 * the rows here: each row is one filter-type byte and row_bytes filtered
 * bytes. Filters 0 (none), 1 (Sub), 2 (Up), 3 (Average) and 4 (Paeth)
 * are undone in place of png.py _unfilter, its plain version, whose
 * Average and Paeth rows run a pixel at a time in numpy: each byte
 * depends on its left neighbour, so the walk is serial, and C walks it at
 * a few cycles a byte. Any bytes per pixel from 1 to 4 (8-bit grey, grey
 * with alpha, RGB, RGBA).
 *
 * Built by grendel_tpu_torch/native/__init__.py with cc and called
 * through ctypes.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c)
{
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc)
        return (uint8_t)a;
    return (uint8_t)(pb <= pc ? b : c);
}

/* raw: height rows of 1 + row_bytes bytes; out: height rows of row_bytes.
 * Returns 0, or 1 + the row whose filter type is not 0-4. */
int gtn_png_unfilter(const uint8_t *raw, uint8_t *out, int32_t height,
                     int64_t row_bytes, int32_t bpp)
{
    for (int32_t y = 0; y < height; y++) {
        const uint8_t *line = raw + (int64_t)y * (row_bytes + 1);
        uint8_t *cur = out + (int64_t)y * row_bytes;
        const uint8_t *prev = y ? cur - row_bytes : NULL;
        int kind = *line++;
        int64_t i;
        switch (kind) {
        case 0:
            memcpy(cur, line, (size_t)row_bytes);
            break;
        case 1:
            for (i = 0; i < row_bytes && i < bpp; i++)
                cur[i] = line[i];
            for (; i < row_bytes; i++)
                cur[i] = (uint8_t)(line[i] + cur[i - bpp]);
            break;
        case 2:
            for (i = 0; i < row_bytes; i++)
                cur[i] = (uint8_t)(line[i] + (prev ? prev[i] : 0));
            break;
        case 3:
            for (i = 0; i < row_bytes; i++) {
                int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
                cur[i] = (uint8_t)(line[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < row_bytes; i++) {
                int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
                int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
                cur[i] = (uint8_t)(line[i] + paeth(a, b, c));
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}
