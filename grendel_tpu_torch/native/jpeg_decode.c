/* A JPEG decoder whose output is bit-equal to libjpeg-turbo's default
 * decode, the one PIL runs for Image.open(...) of a JPEG file.
 *
 * The JAX package decodes its ground truth through PIL
 * (grendel_tpu/data/scene.py decode_image). The machine with the card has
 * no PIL, so the port decodes a JPEG here, on the host, as libjpeg does:
 *   - Huffman-coded baseline (SOF0), extended sequential (SOF1) and
 *     progressive (SOF2) frames of 8-bit samples, one or three
 *     components, with restart markers;
 *   - dequantization and the JDCT_ISLOW integer inverse DCT of
 *     jidctint.c, with its range-limit table;
 *   - fancy (triangle) upsampling of 4:2:2 (h2v1) and 4:2:0 (h2v2)
 *     chroma as in jdsample.c, with its rounding and its edge rules (a
 *     component two samples wide or less is replicated instead);
 *   - jdcolor.c's fixed-point YCbCr -> RGB tables.
 * Block smoothing (jdcoefct.c) acts only on a progressive file whose
 * first ten coefficients are incomplete; such a file, arithmetic coding,
 * 12-bit and lossless frames, four-component (Adobe CMYK or YCCK) files,
 * other sampling factors and truncated data return an error message.
 *
 * Huffman decoding is serial, so the decoder is plain scalar C. Built by
 * grendel_tpu_torch/native/__init__.py with cc, called through ctypes,
 * which releases the interpreter lock: several threads decode at once.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* zigzag index -> natural (row-major) index; the 16 extra entries catch a
 * corrupt run that steps past coefficient 63, as libjpeg's table does */
static const uint8_t NATURAL[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
    int present;
    uint8_t look_len[256];   /* code length of an 8-bit prefix, 0: longer */
    uint8_t look_sym[256];
    int32_t maxcode[18];     /* largest code of each length, -1: none */
    int32_t valoffset[17];
    uint8_t huffval[256];
} Huff;

typedef struct {
    int id, h, v, tq;
    int bw, bh;              /* blocks of the MCU-padded coefficient array */
    int cw, ch;              /* samples of the component (downsampled) */
    int nbw, nbh;            /* blocks covering cw x ch */
    int dc_tbl, ac_tbl, dc_pred, latched;
    int coef_bits[64];       /* progressive: Al of each coefficient, -1 */
    uint16_t qt[64];         /* quantization table latched at its 1st scan */
    int16_t *coef;           /* bw * bh blocks of 64, natural order */
    uint8_t *plane;          /* (bh * 8) rows of bw * 8 samples */
} Comp;

typedef struct {
    const uint8_t *p, *end;
    uint64_t acc;            /* bits, most significant first */
    int nbits;               /* bits in acc */
    int pad;                 /* of them, zeros past a marker or the end */
    int marker;              /* a marker stopped the reads at p */
} Bits;

typedef struct {
    const uint8_t *data;
    size_t size, pos;
    int width, height, nc, progressive, hmax, vmax, mcusx, mcusy;
    int seen_sof, scans, restart_interval, eobrun;
    int jfif, adobe, adobe_transform;
    Comp comp[3];
    uint16_t quant[4][64];
    int quant_present[4];
    Huff dc[4], ac[4];
    Bits b;
    uint8_t idct_limit[1024];
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    uint8_t *rows;           /* upsampled rows of the components */
    jmp_buf fail_jmp;
    char *err;
    int err_len;
} Dec;

static void fail(Dec *d, const char *fmt, ...)
{
    if (d->err && d->err_len > 0) {
        va_list ap;
        va_start(ap, fmt);
        vsnprintf(d->err, (size_t)d->err_len, fmt, ap);
        va_end(ap);
    }
    longjmp(d->fail_jmp, 1);
}

/* ---------------------------------------------------------------- markers */

static int byte_at(Dec *d)
{
    if (d->pos >= d->size)
        fail(d, "truncated JPEG data (ends inside a marker segment)");
    return d->data[d->pos++];
}

static int u16(Dec *d)
{
    int hi = byte_at(d);
    return (hi << 8) | byte_at(d);
}

/* the next marker code at or after pos, skipping garbage and fill bytes */
static int next_marker(Dec *d)
{
    for (;;) {
        while (d->pos < d->size && d->data[d->pos] != 0xFF)
            d->pos++;
        while (d->pos < d->size && d->data[d->pos] == 0xFF)
            d->pos++;
        if (d->pos >= d->size)
            fail(d, "truncated JPEG data (no EOI marker)");
        int m = d->data[d->pos++];
        if (m != 0x00)
            return m;
    }
}

static size_t segment(Dec *d)
{
    int len = u16(d);
    if (len < 2 || d->pos + (size_t)len - 2 > d->size)
        fail(d, "truncated JPEG data (marker segment of %d bytes)", len);
    return d->pos + (size_t)len - 2;
}

static void read_dqt(Dec *d)
{
    size_t end = segment(d);
    while (d->pos < end) {
        int pq_tq = byte_at(d), pq = pq_tq >> 4, tq = pq_tq & 15;
        if (tq > 3 || pq > 1)
            fail(d, "bad quantization table %d (precision %d)", tq, pq);
        for (int k = 0; k < 64; k++)
            d->quant[tq][NATURAL[k]] = (uint16_t)(pq ? u16(d) : byte_at(d));
        d->quant_present[tq] = 1;
    }
    d->pos = end;
}

/* jdhuff.c jpeg_make_d_derived_tbl */
static void read_dht(Dec *d)
{
    size_t end = segment(d);
    while (d->pos < end) {
        int tc_th = byte_at(d), tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3)
            fail(d, "bad Huffman table class %d, id %d", tc, th);
        Huff *h = tc ? &d->ac[th] : &d->dc[th];
        int bits[17], count = 0;
        bits[0] = 0;
        for (int l = 1; l <= 16; l++) {
            bits[l] = byte_at(d);
            count += bits[l];
        }
        if (count > 256)
            fail(d, "bad Huffman table (%d symbols)", count);
        for (int i = 0; i < count; i++)
            h->huffval[i] = (uint8_t)byte_at(d);
        int huffcode[257];
        int code = 0, p = 0;
        for (int l = 1; l <= 16; l++) {
            for (int i = 0; i < bits[l]; i++)
                huffcode[p++] = code++;
            if (code > (1 << l))
                fail(d, "bad Huffman table (code lengths)");
            code <<= 1;
        }
        p = 0;
        for (int l = 1; l <= 16; l++) {
            if (bits[l]) {
                h->valoffset[l] = p - huffcode[p];
                p += bits[l];
                h->maxcode[l] = huffcode[p - 1];
            } else {
                h->maxcode[l] = -1;
            }
        }
        h->maxcode[17] = 0xFFFFF;
        memset(h->look_len, 0, sizeof h->look_len);
        p = 0;
        for (int l = 1; l <= 8; l++) {
            for (int i = 0; i < bits[l]; i++, p++) {
                int look = huffcode[p] << (8 - l);
                for (int r = 0; r < (1 << (8 - l)); r++) {
                    h->look_len[look + r] = (uint8_t)l;
                    h->look_sym[look + r] = h->huffval[p];
                }
            }
        }
        h->present = 1;
    }
    d->pos = end;
}

static void read_sof(Dec *d, int marker)
{
    size_t end = segment(d);
    if (d->seen_sof)
        fail(d, "more than one frame (SOF marker)");
    int precision = byte_at(d);
    d->height = u16(d);
    d->width = u16(d);
    d->nc = byte_at(d);
    if (precision != 8)
        fail(d, "%d-bit JPEG samples are not supported (8-bit only)",
             precision);
    if (d->nc == 4)
        fail(d, "4-component JPEG (Adobe CMYK or YCCK) is not supported");
    if (d->nc != 1 && d->nc != 3)
        fail(d, "%d-component JPEG is not supported", d->nc);
    if (d->width <= 0 || d->height <= 0)
        fail(d, "JPEG frame of %dx%d (a DNL marker) is not supported",
             d->width, d->height);
    d->progressive = marker == 0xC2;
    d->hmax = d->vmax = 1;
    for (int i = 0; i < d->nc; i++) {
        Comp *c = &d->comp[i];
        c->id = byte_at(d);
        int hv = byte_at(d);
        c->h = hv >> 4;
        c->v = hv & 15;
        c->tq = byte_at(d);
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
            fail(d, "bad component %d (sampling %dx%d, table %d)", c->id,
                 c->h, c->v, c->tq);
        if (c->h > d->hmax) d->hmax = c->h;
        if (c->v > d->vmax) d->vmax = c->v;
    }
    d->mcusx = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
    d->mcusy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
    for (int i = 0; i < d->nc; i++) {
        Comp *c = &d->comp[i];
        int rh = d->hmax / c->h, rv = d->vmax / c->v;
        if (d->nc > 1 && (d->hmax % c->h || d->vmax % c->v || rh > 2
                          || rv > 2 || (rh == 1 && rv == 2)))
            fail(d, "chroma sampling %dx%d of %dx%d is not supported (4:4:4,"
                 " 4:2:2 and 4:2:0 are)", c->h, c->v, d->hmax, d->vmax);
        c->bw = d->mcusx * c->h;
        c->bh = d->mcusy * c->v;
        c->cw = (int)(((int64_t)d->width * c->h + d->hmax - 1) / d->hmax);
        c->ch = (int)(((int64_t)d->height * c->v + d->vmax - 1) / d->vmax);
        c->nbw = (c->cw + 7) / 8;
        c->nbh = (c->ch + 7) / 8;
        c->coef = (int16_t *)calloc((size_t)c->bw * c->bh * 64,
                                    sizeof(int16_t));
        c->plane = (uint8_t *)malloc((size_t)c->bw * c->bh * 64);
        if (!c->coef || !c->plane)
            fail(d, "out of memory for a %dx%d JPEG", d->width, d->height);
        for (int k = 0; k < 64; k++)
            c->coef_bits[k] = -1;
    }
    d->seen_sof = 1;
    d->pos = end;
}

static void read_app(Dec *d, int marker)
{
    size_t end = segment(d);
    size_t n = end - d->pos;
    const uint8_t *s = d->data + d->pos;
    if (marker == 0xE0 && n >= 5 && !memcmp(s, "JFIF\0", 5))
        d->jfif = 1;
    if (marker == 0xEE && n >= 12 && !memcmp(s, "Adobe", 5)) {
        d->adobe = 1;
        d->adobe_transform = s[11];
    }
    d->pos = end;
}

/* ------------------------------------------------------------- entropy */

static void bits_start(Dec *d)
{
    d->b.p = d->data + d->pos;
    d->b.end = d->data + d->size;
    d->b.acc = 0;
    d->b.nbits = d->b.pad = d->b.marker = 0;
}

/* jdhuff.c jpeg_fill_bit_buffer: FF 00 is a data byte FF; FF followed by
 * anything else is a marker, at which the reads stop (zeros follow) */
static void fill(Bits *b)
{
    while (b->nbits <= 56) {
        uint64_t byte = 0;
        if (!b->marker && b->p < b->end) {
            byte = *b->p;
            if (byte == 0xFF) {
                const uint8_t *q = b->p + 1;
                while (q < b->end && *q == 0xFF)
                    q++;
                if (q < b->end && *q == 0x00) {
                    b->p = q + 1;
                } else {
                    b->marker = 1;
                    byte = 0;
                    b->pad += 8;
                }
            } else {
                b->p++;
            }
        } else {
            b->pad += 8;
        }
        b->acc |= byte << (56 - b->nbits);
        b->nbits += 8;
    }
}

static inline void consume(Dec *d, int n)
{
    if (n > d->b.nbits - d->b.pad)
        fail(d, "truncated or corrupt JPEG data (entropy-coded data ends "
             "inside a scan)");
    d->b.acc <<= n;
    d->b.nbits -= n;
}

static inline int get_bits(Dec *d, int n)
{
    if (d->b.nbits < n)
        fill(&d->b);
    int v = (int)(d->b.acc >> (64 - n));
    consume(d, n);
    return v;
}

static inline int get_bit(Dec *d)
{
    return get_bits(d, 1);
}

static inline int huff_decode(Dec *d, const Huff *h)
{
    if (d->b.nbits < 16)
        fill(&d->b);
    int look = (int)(d->b.acc >> 56);
    int l = h->look_len[look];
    if (l) {
        consume(d, l);
        return h->look_sym[look];
    }
    for (l = 9; l <= 16; l++) {
        int32_t code = (int32_t)(d->b.acc >> (64 - l));
        if (code <= h->maxcode[l]) {
            consume(d, l);
            return h->huffval[(code + h->valoffset[l]) & 0xFF];
        }
    }
    fail(d, "corrupt JPEG data (bad Huffman code)");
    return 0;
}

/* HUFF_EXTEND */
static inline int extend(int r, int s)
{
    return r < (1 << (s - 1)) ? r + (int)(((unsigned)-1 << s) + 1) : r;
}

static inline int16_t shl(int v, int al)
{
    return (int16_t)(int)((unsigned)v << al);
}

/* jdhuff.c decode_mcu, one block */
static void block_baseline(Dec *d, Comp *c, int16_t *blk)
{
    int s = huff_decode(d, &d->dc[c->dc_tbl]);
    if (s)
        s = extend(get_bits(d, s), s);
    c->dc_pred += s;
    blk[0] = (int16_t)c->dc_pred;
    const Huff *ac = &d->ac[c->ac_tbl];
    for (int k = 1; k < 64; k++) {
        int rs = huff_decode(d, ac), r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            blk[NATURAL[k]] = (int16_t)extend(get_bits(d, s), s);
        } else {
            if (r != 15)
                break;
            k += 15;
        }
    }
}

/* jdphuff.c decode_mcu_DC_first and decode_mcu_DC_refine */
static void block_dc(Dec *d, Comp *c, int16_t *blk, int ah, int al)
{
    if (ah == 0) {
        int s = huff_decode(d, &d->dc[c->dc_tbl]);
        if (s)
            s = extend(get_bits(d, s), s);
        c->dc_pred += s;
        blk[0] = shl(c->dc_pred, al);
    } else if (get_bit(d)) {
        blk[0] = (int16_t)(blk[0] | (1 << al));
    }
}

/* jdphuff.c decode_mcu_AC_first */
static void block_ac_first(Dec *d, Comp *c, int16_t *blk, int ss, int se,
                           int al)
{
    if (d->eobrun > 0) {
        d->eobrun--;
        return;
    }
    const Huff *ac = &d->ac[c->ac_tbl];
    for (int k = ss; k <= se; k++) {
        int rs = huff_decode(d, ac), r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            blk[NATURAL[k]] = shl(extend(get_bits(d, s), s), al);
        } else if (r == 15) {
            k += 15;
        } else {
            d->eobrun = 1 << r;
            if (r)
                d->eobrun += get_bits(d, r);
            d->eobrun--;
            break;
        }
    }
}

static inline void refine(Dec *d, int16_t *coef, int p1, int m1)
{
    if (get_bit(d) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
}

/* jdphuff.c decode_mcu_AC_refine */
static void block_ac_refine(Dec *d, Comp *c, int16_t *blk, int ss, int se,
                            int al)
{
    int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
    int k = ss;
    const Huff *ac = &d->ac[c->ac_tbl];
    if (d->eobrun == 0) {
        for (; k <= se; k++) {
            int rs = huff_decode(d, ac), r = rs >> 4, s = rs & 15;
            if (s) {
                s = get_bit(d) ? p1 : m1;
            } else if (r != 15) {
                d->eobrun = 1 << r;
                if (r)
                    d->eobrun += get_bits(d, r);
                break;
            }
            do {
                int16_t *coef = blk + NATURAL[k];
                if (*coef != 0) {
                    refine(d, coef, p1, m1);
                } else if (--r < 0) {
                    break;
                }
                k++;
            } while (k <= se);
            if (s)
                blk[NATURAL[k]] = (int16_t)s;
        }
    }
    if (d->eobrun > 0) {
        for (; k <= se; k++) {
            int16_t *coef = blk + NATURAL[k];
            if (*coef != 0)
                refine(d, coef, p1, m1);
        }
        d->eobrun--;
    }
}

/* the restart marker expected after restart interval n: the partial byte
 * left in the bit buffer is dropped and the reads go on past the marker */
static void restart(Dec *d, int n)
{
    const uint8_t *q = d->b.p;
    while (q < d->b.end && *q == 0xFF)
        q++;
    if (q == d->b.p || q >= d->b.end || *q != 0xD0 + (n & 7))
        fail(d, "corrupt JPEG data (restart marker %d missing)", n & 7);
    d->pos = (size_t)(q + 1 - d->data);
    bits_start(d);
    for (int i = 0; i < d->nc; i++)
        d->comp[i].dc_pred = 0;
    d->eobrun = 0;
}

static void read_sos(Dec *d)
{
    size_t end = segment(d);
    if (!d->seen_sof)
        fail(d, "scan before the frame header (SOS before SOF)");
    int ns = byte_at(d);
    if (ns < 1 || ns > d->nc)
        fail(d, "bad scan of %d components", ns);
    Comp *sc[3];
    for (int i = 0; i < ns; i++) {
        int id = byte_at(d), tables = byte_at(d), j;
        for (j = 0; j < d->nc && d->comp[j].id != id; j++)
            ;
        if (j == d->nc)
            fail(d, "scan names component %d, not in the frame", id);
        sc[i] = &d->comp[j];
        sc[i]->dc_tbl = tables >> 4;
        sc[i]->ac_tbl = tables & 15;
        if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3)
            fail(d, "bad Huffman table ids in a scan");
    }
    int ss = byte_at(d), se = byte_at(d), a = byte_at(d);
    int ah = a >> 4, al = a & 15;
    d->pos = end;

    if (d->progressive) {
        if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1))
            fail(d, "bad progressive scan (Ss %d, Se %d, %d components)",
                 ss, se, ns);
        if (al > 13 || (ah && ah != al + 1))
            fail(d, "bad progressive scan (Ah %d, Al %d)", ah, al);
    } else if (ss != 0 || se != 63 || ah || al) {
        ss = 0;    /* libjpeg ignores these fields of a sequential scan */
        se = 63;
        ah = al = 0;
    }
    for (int i = 0; i < ns; i++) {
        Comp *c = sc[i];
        if (!c->latched) {
            if (!d->quant_present[c->tq])
                fail(d, "quantization table %d not defined", c->tq);
            memcpy(c->qt, d->quant[c->tq], sizeof c->qt);
            c->latched = 1;
        }
        if (ss == 0 && ah == 0 && !d->dc[c->dc_tbl].present)
            fail(d, "DC Huffman table %d not defined", c->dc_tbl);
        if (se > 0 && !d->ac[c->ac_tbl].present)
            fail(d, "AC Huffman table %d not defined", c->ac_tbl);
        if (d->progressive)
            for (int k = ss; k <= se; k++)
                c->coef_bits[k] = al;
        c->dc_pred = 0;
    }
    d->eobrun = 0;

    /* one MCU is one block in a scan of one component */
    int64_t mcus_x = ns == 1 ? sc[0]->nbw : d->mcusx;
    int64_t mcus = mcus_x * (ns == 1 ? sc[0]->nbh : d->mcusy);
    bits_start(d);
    int rst = 0;
    for (int64_t m = 0; m < mcus; m++) {
        int64_t mx = m % mcus_x, my = m / mcus_x;
        for (int i = 0; i < ns; i++) {
            Comp *c = sc[i];
            int bh = ns == 1 ? 1 : c->v, bw = ns == 1 ? 1 : c->h;
            for (int by = 0; by < bh; by++) {
                for (int bx = 0; bx < bw; bx++) {
                    int64_t col = mx * bw + bx, row = my * bh + by;
                    int16_t *blk = c->coef + (row * c->bw + col) * 64;
                    if (!d->progressive)
                        block_baseline(d, c, blk);
                    else if (ss == 0)
                        block_dc(d, c, blk, ah, al);
                    else if (ah == 0)
                        block_ac_first(d, c, blk, ss, se, al);
                    else
                        block_ac_refine(d, c, blk, ss, se, al);
                }
            }
        }
        if (d->restart_interval && m + 1 < mcus
                && (m + 1) % d->restart_interval == 0)
            restart(d, rst++);
    }
    d->pos = (size_t)(d->b.p - d->data);
    d->scans++;
}

/* ------------------------------------------------------------ samples */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* jidctint.c jpeg_idct_islow: the columns (pass 1) into a workspace, the
 * rows (pass 2) into 8 rows of 8 samples through the range limit */
static void idct_islow(const Dec *d, const int16_t *in, const uint16_t *q,
                       uint8_t *out, int stride)
{
    int ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *ip = in + c;
        const uint16_t *qp = q + c;
        int *wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48]
                && !ip[56]) {
            int dc = (int)((unsigned)(ip[0] * (int)qp[0]) << PASS1_BITS);
            for (int r = 0; r < 8; r++)
                wp[8 * r] = dc;
            continue;
        }
        int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        int64_t tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        tmp0 = (int64_t)ip[56] * qp[56];
        tmp1 = (int64_t)ip[40] * qp[40];
        tmp2 = (int64_t)ip[24] * qp[24];
        tmp3 = (int64_t)ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;

        wp[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
        wp[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
        wp[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
        wp[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
        wp[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
        wp[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
        wp[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
        wp[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    }
    const uint8_t *lim = d->idct_limit;
    const int shift = CONST_BITS + PASS1_BITS + 3;
    for (int r = 0; r < 8; r++) {
        const int *wp = ws + 8 * r;
        uint8_t *op = out + (size_t)r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6]
                && !wp[7]) {
            uint8_t v = lim[(int)DESCALE((int64_t)wp[0], PASS1_BITS + 3)
                            & 1023];
            memset(op, v, 8);
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * ((int64_t)1 << CONST_BITS);
        int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * ((int64_t)1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;

        op[0] = lim[(int)DESCALE(tmp10 + tmp3, shift) & 1023];
        op[7] = lim[(int)DESCALE(tmp10 - tmp3, shift) & 1023];
        op[1] = lim[(int)DESCALE(tmp11 + tmp2, shift) & 1023];
        op[6] = lim[(int)DESCALE(tmp11 - tmp2, shift) & 1023];
        op[2] = lim[(int)DESCALE(tmp12 + tmp1, shift) & 1023];
        op[5] = lim[(int)DESCALE(tmp12 - tmp1, shift) & 1023];
        op[3] = lim[(int)DESCALE(tmp13 + tmp0, shift) & 1023];
        op[4] = lim[(int)DESCALE(tmp13 - tmp0, shift) & 1023];
    }
}

/* jdmaster.c prepare_range_limit_table, the post-IDCT part: x + 128
 * clamped to 0-255 for x in [-512, 511], taken modulo 1024 */
static void init_tables(Dec *d)
{
    for (int i = 0; i < 1024; i++)
        d->idct_limit[i] = (uint8_t)(i < 128 ? i + 128 : i < 512 ? 255
                                     : i < 896 ? 0 : i - 896);
    /* jdcolor.c build_ycc_rgb_table, SCALEBITS 16 */
    const int64_t one_half = (int64_t)1 << 15;
    for (int i = 0; i < 256; i++) {
        int64_t x = i - 128;
        d->cr_r[i] = (int)((91881 * x + one_half) >> 16);      /* 1.40200 */
        d->cb_b[i] = (int)((116130 * x + one_half) >> 16);     /* 1.77200 */
        d->cr_g[i] = -46802 * x;                               /* 0.71414 */
        d->cb_g[i] = -22554 * x + one_half;                    /* 0.34414 */
    }
}

static inline uint8_t clamp255(int v)
{
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

/* one output row y of component c, upsampled to the image's width, into
 * dst (jdsample.c fullsize, h2v1 and h2v2 upsampling, fancy where the
 * component is more than two samples wide) */
static const uint8_t *comp_row(const Dec *d, const Comp *c, int y,
                               uint8_t *dst)
{
    const size_t stride = (size_t)c->bw * 8;
    int rh = d->hmax / c->h, rv = d->vmax / c->v;
    if (d->nc == 1 || (rh == 1 && rv == 1))
        return c->plane + (size_t)y * stride;
    int w = c->cw, r = y / rv;
    const uint8_t *in0 = c->plane + (size_t)r * stride;
    if (w <= 2) {
        /* h2v1_upsample, h2v2_upsample: replicate */
        for (int x = 0; x < d->width; x++)
            dst[x] = in0[x >> 1];
        return dst;
    }
    if (rv == 1) {
        /* h2v1_fancy_upsample */
        for (int cx = 0; cx < w; cx++) {
            int cur = in0[cx] * 3;
            int left = in0[cx > 0 ? cx - 1 : 0];
            int right = in0[cx < w - 1 ? cx + 1 : w - 1];
            int x = 2 * cx;
            if (x < d->width)
                dst[x] = (uint8_t)((cur + left + 1) >> 2);
            if (x + 1 < d->width)
                dst[x + 1] = (uint8_t)((cur + right + 2) >> 2);
        }
        return dst;
    }
    /* h2v2_fancy_upsample: the nearer row (r) and the next nearer one,
     * above for an even output row and below for an odd one, the image's
     * edge rows repeated */
    int r1 = (y & 1) ? (r + 1 < c->ch ? r + 1 : c->ch - 1)
                     : (r > 0 ? r - 1 : 0);
    const uint8_t *in1 = c->plane + (size_t)r1 * stride;
#define COLSUM(i) (in0[i] * 3 + in1[i])
    for (int cx = 0; cx < w; cx++) {
        int cur = COLSUM(cx);
        int left = COLSUM(cx > 0 ? cx - 1 : 0);
        int right = COLSUM(cx < w - 1 ? cx + 1 : w - 1);
        int x = 2 * cx;
        if (x < d->width)
            dst[x] = (uint8_t)((cur * 3 + left + 8) >> 4);
        if (x + 1 < d->width)
            dst[x + 1] = (uint8_t)((cur * 3 + right + 7) >> 4);
    }
#undef COLSUM
    return dst;
}

static void write_samples(Dec *d, uint8_t *out)
{
    for (int i = 0; i < d->nc; i++) {
        Comp *c = &d->comp[i];
        size_t stride = (size_t)c->bw * 8;
        for (int by = 0; by < c->bh; by++)
            for (int bx = 0; bx < c->bw; bx++)
                idct_islow(d, c->coef + ((size_t)by * c->bw + bx) * 64,
                           c->qt, c->plane + (size_t)by * 8 * stride + bx * 8,
                           (int)stride);
    }
    const size_t w = (size_t)d->width;
    if (d->nc == 1) {
        for (int y = 0; y < d->height; y++)
            memcpy(out + y * w, comp_row(d, &d->comp[0], y, NULL), w);
        return;
    }
    /* jdapimin.c default_decompress_parms: a JFIF file is YCbCr; else an
     * Adobe marker's transform 0 means RGB; else component ids R, G, B */
    int rgb = !d->jfif && (d->adobe ? d->adobe_transform == 0
                           : (d->comp[0].id == 'R' && d->comp[1].id == 'G'
                              && d->comp[2].id == 'B'));
    d->rows = (uint8_t *)malloc(3 * w + 2);
    if (!d->rows)
        fail(d, "out of memory");
    for (int y = 0; y < d->height; y++) {
        const uint8_t *p0 = comp_row(d, &d->comp[0], y, d->rows);
        const uint8_t *p1 = comp_row(d, &d->comp[1], y, d->rows + w);
        const uint8_t *p2 = comp_row(d, &d->comp[2], y, d->rows + 2 * w);
        uint8_t *o = out + (size_t)y * w * 3;
        if (rgb) {
            for (size_t x = 0; x < w; x++) {
                o[3 * x] = p0[x];
                o[3 * x + 1] = p1[x];
                o[3 * x + 2] = p2[x];
            }
            continue;
        }
        /* jdcolor.c ycc_rgb_convert */
        for (size_t x = 0; x < w; x++) {
            int yy = p0[x], cb = p1[x], cr = p2[x];
            o[3 * x] = clamp255(yy + d->cr_r[cr]);
            o[3 * x + 1] = clamp255(
                yy + (int)((d->cb_g[cb] + d->cr_g[cr]) >> 16));
            o[3 * x + 2] = clamp255(yy + d->cb_b[cb]);
        }
    }
}

static void decode(Dec *d, uint8_t *out, int64_t out_size)
{
    if (d->size < 4 || d->data[0] != 0xFF || d->data[1] != 0xD8)
        fail(d, "not a JPEG file (no SOI marker)");
    d->pos = 2;
    for (;;) {
        int m = next_marker(d);
        if (m == 0xD9)
            break;
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01)
            continue;
        switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
            read_sof(d, m);
            break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7:
            fail(d, "lossless or hierarchical JPEG (SOF%d) is not "
                 "supported", m - 0xC0);
            break;
        case 0xC9: case 0xCA: case 0xCB: case 0xCC: case 0xCD: case 0xCE:
        case 0xCF:
            fail(d, "arithmetic-coded JPEG is not supported");
            break;
        case 0xC4:
            read_dht(d);
            break;
        case 0xDB:
            read_dqt(d);
            break;
        case 0xDD: {
            size_t end = segment(d);
            d->restart_interval = u16(d);
            d->pos = end;
            break;
        }
        case 0xDA:
            read_sos(d);
            break;
        case 0xE0: case 0xEE:
            read_app(d, m);
            break;
        default:
            d->pos = segment(d);
            break;
        }
    }
    if (!d->seen_sof || !d->scans)
        fail(d, "no image data (no frame or no scan before EOI)");
    int channels = d->nc == 1 ? 1 : 3;
    if (out_size != (int64_t)d->width * d->height * channels)
        fail(d, "output of %lld bytes for a %dx%dx%d image",
             (long long)out_size, d->width, d->height, channels);
    /* jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
     * file while any of the first ten coefficients lacks bits */
    for (int i = 0; d->progressive && i < d->nc; i++)
        for (int k = 0; k < 10; k++)
            if (d->comp[i].coef_bits[k] != 0)
                fail(d, "progressive JPEG with incomplete coefficients "
                     "(libjpeg's block smoothing) is not supported");
    init_tables(d);
    write_samples(d, out);
}

/* Decode the JPEG file data[0:size] into out, (height, width) samples of
 * a grey file or (height, width, 3) RGB of a colour one, row-major, of
 * out_size bytes. Returns 0, or 1 with a message in err (err_len bytes). */
int gtn_jpeg_decode(const uint8_t *data, int64_t size, uint8_t *out,
                    int64_t out_size, char *err, int32_t err_len)
{
    Dec *d = (Dec *)calloc(1, sizeof(Dec));
    if (!d) {
        if (err && err_len > 0)
            snprintf(err, (size_t)err_len, "out of memory");
        return 1;
    }
    d->data = data;
    d->size = (size_t)size;
    d->err = err;
    d->err_len = err_len;
    int rc = 0;
    if (setjmp(d->fail_jmp) == 0)
        decode(d, out, out_size);
    else
        rc = 1;
    for (int i = 0; i < 3; i++) {
        free(d->comp[i].coef);
        free(d->comp[i].plane);
    }
    free(d->rows);
    free(d);
    return rc;
}
