/* Baseline JPEG decoding, the bytes libjpeg(-turbo) gives with its default
 * decompression settings: host code for JPEG cores, JPEG folders and the
 * JPEG tiles of TIFF and MIRAX slides.
 *
 * It takes Huffman-coded sequential DCT frames (SOF0, SOF1) of 8-bit
 * samples with 1 or 3 components, in one interleaved scan or in several,
 * with restart intervals, and abbreviated streams whose tables come from
 * another stream (TIFF's JPEGTables). Each component's sampling factors may
 * be 1 or 2 each way, and each must divide the largest. The steps are
 * libjpeg's:
 *   - jdhuff.c's decoding, coefficients kept as 16-bit integers;
 *   - jidctint.c's JDCT_ISLOW integer IDCT with its wrapping range limit;
 *   - jdsample.c's fancy upsampling: the triangle filters h2v1, h1v2 and
 *     h2v2 with their alternating rounding, the edges replicated at the
 *     component's own width and height (plain replication for h2v1 and h2v2
 *     where that width is 2 or less, as libjpeg does), never merged
 *     upsampling;
 *   - jdcolor.c's fixed-point YCbCr -> RGB tables (16 fraction bits).
 * The colour space follows jdapimin.c's defaults for a JFIF or Adobe file,
 * or the caller's rule for TIFF (codecs.h). Progressive, arithmetic-coded,
 * lossless, hierarchical and 12-bit frames fail with a message naming them,
 * as do 2 and 4 components (CMYK, YCCK).
 *
 * Where libjpeg only warns (a Huffman code that does not exist, data cut
 * short) this decoder fails: a tile it cannot decode as libjpeg would is an
 * error, not a guess. The decoder reads ahead past the end of a scan's data
 * as zeros, but a code that takes one of those bits fails.
 */
#include <pthread.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "codecs.h"

int tpuwsi_fail(char *err, size_t errlen, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(err, errlen, fmt, ap);
  va_end(ap);
  return kFormatError;
}

/* zigzag order, with 16 entries of 63 after the end for corrupt run lengths (jutils.c) */
static const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define LOOK_BITS 9

typedef struct {
  int present;
  uint8_t bits[17];
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << LOOK_BITS]; /* (length << 8) | value; length 0: look further */
} Huff;

typedef struct {
  int id, h, v, tq, td, ta;
  int bw, bh;         /* blocks stored per row and column (padded to whole MCUs) */
  int dw, dh;         /* samples of the component in the image (libjpeg's downsampled size) */
  int quant_latched;  /* the table is fixed at the component's first scan, as in libjpeg */
  uint16_t quant[64];
  int16_t *coef;      /* bw * bh blocks of 64, natural order */
  uint8_t *plane;     /* bw * 8 x bh * 8 samples after the IDCT */
} Component;

typedef struct {
  const uint8_t *p, *end;
  uint64_t acc;
  int nbits, marker;  /* marker: the scan's data has ended; zeros follow */
  int64_t zeros;      /* bits of zeros fed after the end of the scan's data */
  uint16_t quant[4][64];
  int quant_present[4];
  Huff dc[4], ac[4];
  int frame, width, height, ncomp, hmax, vmax, mcux, mcuy, restart_interval;
  int jfif, adobe, adobe_transform;
  Component comp[3];
  char *err;
  size_t errlen;
} Jpeg;

static int fail(Jpeg *j, const char *fmt, ...) __attribute__((format(printf, 2, 3)));
static int fail(Jpeg *j, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(j->err, j->errlen, fmt, ap);
  va_end(ap);
  return kFormatError;
}

static unsigned be16(const uint8_t *p) { return (unsigned)p[0] << 8 | p[1]; }

/* ---- tables ---------------------------------------------------------------------- */

/* jdhuff.c's jpeg_make_d_derived_tbl, with a lookahead table of LOOK_BITS bits */
static int huff_derive(Jpeg *j, Huff *t) {
  int huffsize[257], huffcode[257], p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < t->bits[l]; ++i) {
      if (p >= 256) return fail(j, "bad Huffman table (more than 256 codes)");
      huffsize[p++] = l;
    }
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) return fail(j, "bad Huffman table (codes overflow their length)");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t->bits[l]) {
      t->valoffset[l] = p - huffcode[p];
      p += t->bits[l];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  memset(t->look, 0, sizeof t->look);
  p = 0;
  for (int l = 1; l <= LOOK_BITS; ++l)
    for (int i = 0; i < t->bits[l]; ++i, ++p) {
      int lookbits = huffcode[p] << (LOOK_BITS - l);
      for (int ctr = 1 << (LOOK_BITS - l); ctr > 0; --ctr)
        t->look[lookbits++] = (uint16_t)(l << 8 | t->vals[p]);
    }
  t->present = 1;
  return kOk;
}

static int read_dht(Jpeg *j, const uint8_t *p, size_t n) {
  while (n > 0) {
    if (n < 17) return fail(j, "truncated DHT marker");
    int tc = p[0] >> 4, th = p[0] & 15, count = 0;
    if (tc > 1 || th > 3) return fail(j, "bad DHT table class %d or id %d", tc, th);
    Huff *t = tc ? &j->ac[th] : &j->dc[th];
    memset(t->bits, 0, sizeof t->bits);
    for (int l = 1; l <= 16; ++l) count += (t->bits[l] = p[l]);
    if (count > 256 || (size_t)count > n - 17) return fail(j, "bad DHT marker");
    memset(t->vals, 0, sizeof t->vals);
    memcpy(t->vals, p + 17, (size_t)count);
    if (huff_derive(j, t)) return kFormatError;
    p += 17 + count;
    n -= 17 + (size_t)count;
  }
  return kOk;
}

static int read_dqt(Jpeg *j, const uint8_t *p, size_t n) {
  while (n > 0) {
    int pq = p[0] >> 4, tq = p[0] & 15;
    size_t need = 1 + (pq ? 128 : 64);
    if (tq > 3 || pq > 1 || n < need) return fail(j, "bad DQT marker");
    for (int k = 0; k < 64; ++k)
      j->quant[tq][kNatural[k]] = (uint16_t)(pq ? be16(p + 1 + 2 * k) : p[1 + k]);
    j->quant_present[tq] = 1;
    p += need;
    n -= need;
  }
  return kOk;
}

static int read_sof(Jpeg *j, int marker, const uint8_t *p, size_t n) {
  if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
    return fail(j, "progressive JPEG (SOF%d) is not supported; this decoder takes baseline "
                "and extended sequential Huffman frames only", marker - 0xC0);
  if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
    return fail(j, "lossless JPEG (SOF%d) is not supported", marker - 0xC0);
  if (marker == 0xC5) return fail(j, "hierarchical JPEG (SOF5) is not supported");
  if (marker >= 0xC9)
    return fail(j, "arithmetic-coded JPEG (SOF%d) is not supported; this decoder takes "
                "Huffman coding only", marker - 0xC0);
  if (j->frame) return fail(j, "two frames in one JPEG stream");
  if (n < 6) return fail(j, "truncated SOF marker");
  if (p[0] != 8)
    return fail(j, "%d-bit JPEG samples are not supported; this decoder takes 8-bit samples "
                "only", p[0]);
  j->height = (int)be16(p + 1);
  j->width = (int)be16(p + 3);
  j->ncomp = p[5];
  if (j->ncomp != 1 && j->ncomp != 3)
    return fail(j, "JPEG with %d components is not supported (1 or 3: gray, YCbCr or RGB; "
                "not CMYK or YCCK)", j->ncomp);
  if (n < 6 + 3 * (size_t)j->ncomp) return fail(j, "truncated SOF marker");
  if (j->width <= 0 || j->height <= 0)
    return fail(j, "JPEG frame of %d x %d pixels (a height of 0 needs a DNL marker, which is "
                "not supported)", j->width, j->height);
  j->hmax = j->vmax = 1;
  for (int c = 0; c < j->ncomp; ++c) {
    Component *cp = &j->comp[c];
    cp->id = p[6 + 3 * c];
    cp->h = p[7 + 3 * c] >> 4;
    cp->v = p[7 + 3 * c] & 15;
    cp->tq = p[8 + 3 * c];
    if (cp->h < 1 || cp->h > 2 || cp->v < 1 || cp->v > 2 || cp->tq > 3)
      return fail(j, "JPEG sampling factors %dx%d of component %d are not supported (1 or 2 "
                  "each way)", cp->h, cp->v, c);
    if (cp->h > j->hmax) j->hmax = cp->h;
    if (cp->v > j->vmax) j->vmax = cp->v;
  }
  j->mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
  j->mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
  for (int c = 0; c < j->ncomp; ++c) {
    Component *cp = &j->comp[c];
    cp->bw = j->mcux * cp->h;
    cp->bh = j->mcuy * cp->v;
    cp->dw = (int)(((long)j->width * cp->h + j->hmax - 1) / j->hmax);
    cp->dh = (int)(((long)j->height * cp->v + j->vmax - 1) / j->vmax);
    cp->coef = calloc((size_t)cp->bw * cp->bh * 64, sizeof(int16_t));
    if (cp->coef == NULL) return fail(j, "no memory for a %d x %d JPEG", j->width, j->height);
  }
  j->frame = 1;
  return kOk;
}

/* ---- entropy-coded data -------------------------------------------------------------- */

static inline void fill(Jpeg *j) {
  while (j->nbits <= 56) {
    unsigned byte = 0;
    if (!j->marker && j->p < j->end) {
      byte = *j->p;
      if (byte == 0xFF) {
        if (j->p + 1 < j->end && j->p[1] == 0x00) {
          j->p += 2;
        } else { /* a marker: leave it for the parser, feed zeros */
          j->marker = 1;
          byte = 0;
        }
      } else {
        ++j->p;
      }
    } else if (!j->marker) {
      j->marker = 1; /* the data ran out */
    }
    j->acc |= (uint64_t)byte << (56 - j->nbits);
    j->nbits += 8;
    j->zeros += j->marker ? 8 : 0;
  }
}

static inline int get_bits(Jpeg *j, int n) {
  if (n == 0) return 0;
  if (j->nbits < n) fill(j);
  int v = (int)(j->acc >> (64 - n));
  j->acc <<= n;
  j->nbits -= n;
  return v;
}

/* -1 for a code the table does not have */
static inline int decode_huff(Jpeg *j, const Huff *t) {
  if (j->nbits < 16) fill(j);
  int look = (int)(j->acc >> (64 - LOOK_BITS));
  int entry = t->look[look];
  if (entry >> 8) {
    int l = entry >> 8;
    j->acc <<= l;
    j->nbits -= l;
    return entry & 0xFF;
  }
  int code = 0, l = 0;
  do {
    code = code << 1 | (int)(j->acc >> 63);
    j->acc <<= 1;
    j->nbits -= 1;
    ++l;
  } while (l <= 16 && code > t->maxcode[l]);
  if (l > 16) return -1;
  return t->vals[(code + t->valoffset[l]) & 0xFF];
}

static inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

static int decode_block(Jpeg *j, Component *cp, int *pred, int16_t *block) {
  int s = decode_huff(j, &j->dc[cp->td]);
  if (s < 0 || s > 15) return fail(j, "corrupt JPEG data (bad DC code)");
  if (s) s = extend(get_bits(j, s), s);
  *pred += s;
  block[0] = (int16_t)*pred;
  for (int k = 1; k < 64; ++k) {
    int rs = decode_huff(j, &j->ac[cp->ta]);
    if (rs < 0) return fail(j, "corrupt JPEG data (bad AC code)");
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      block[kNatural[k]] = (int16_t)extend(get_bits(j, s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return kOk;
}

/* fails where a code took bits past the end of the data (they were the zeros fed) */
static int check_ended(Jpeg *j) {
  if (j->zeros > j->nbits) return fail(j, "corrupt or truncated JPEG data (a scan ends early)");
  return kOk;
}

static void reset_bits(Jpeg *j) {
  j->acc = 0;
  j->nbits = 0;
  j->marker = 0;
  j->zeros = 0;
}

/* past the restart marker that should come next; libjpeg skips bytes before a marker too */
static int restart(Jpeg *j, int *expected) {
  if (check_ended(j)) return kFormatError;
  reset_bits(j);
  while (j->p + 1 < j->end && !(j->p[0] == 0xFF && j->p[1] != 0x00 && j->p[1] != 0xFF)) ++j->p;
  if (j->p + 1 >= j->end || j->p[1] != 0xD0 + *expected)
    return fail(j, "corrupt JPEG data (restart marker RST%d missing)", *expected);
  j->p += 2;
  *expected = (*expected + 1) & 7;
  return kOk;
}

static int read_scan(Jpeg *j, const uint8_t *p, size_t n) {
  if (!j->frame) return fail(j, "SOS marker before the frame header");
  if (n < 1 || n < 1 + 2 * (size_t)p[0] + 3) return fail(j, "truncated SOS marker");
  int ns = p[0];
  if (ns < 1 || ns > j->ncomp) return fail(j, "bad SOS marker (%d components)", ns);
  Component *sc[3];
  for (int i = 0; i < ns; ++i) {
    int id = p[1 + 2 * i], c = 0;
    while (c < j->ncomp && j->comp[c].id != id) ++c;
    if (c == j->ncomp) return fail(j, "SOS names component id %d, which the frame lacks", id);
    sc[i] = &j->comp[c];
    sc[i]->td = p[2 + 2 * i] >> 4;
    sc[i]->ta = p[2 + 2 * i] & 15;
    if (sc[i]->td > 3 || sc[i]->ta > 3 || !j->dc[sc[i]->td].present ||
        !j->ac[sc[i]->ta].present)
      return fail(j, "a scan uses a Huffman table that was not defined");
    if (!sc[i]->quant_latched) {
      if (!j->quant_present[sc[i]->tq])
        return fail(j, "a component uses quantization table %d, which was not defined",
                    sc[i]->tq);
      memcpy(sc[i]->quant, j->quant[sc[i]->tq], sizeof sc[i]->quant);
      sc[i]->quant_latched = 1;
    }
  }
  const uint8_t *sel = p + 1 + 2 * ns;
  if (sel[0] != 0 || sel[1] != 63 || sel[2] != 0)
    return fail(j, "scan with spectral selection %d-%d and approximation %d: progressive JPEG "
                "is not supported", sel[0], sel[1], sel[2]);
  j->p = p + n;
  reset_bits(j);
  int pred[3] = {0, 0, 0}, rst = 0, todo = j->restart_interval;
  if (ns == 1) { /* non-interleaved: one block an MCU, over the component's own blocks */
    Component *cp = sc[0];
    int bx = (cp->dw + 7) / 8, by = (cp->dh + 7) / 8;
    for (int y = 0; y < by; ++y)
      for (int x = 0; x < bx; ++x) {
        if (j->restart_interval) {
          if (todo == 0) {
            if (restart(j, &rst)) return kFormatError;
            pred[0] = 0;
            todo = j->restart_interval;
          }
          --todo;
        }
        if (decode_block(j, cp, &pred[0], cp->coef + ((size_t)y * cp->bw + x) * 64))
          return kFormatError;
      }
  } else {
    for (int my = 0; my < j->mcuy; ++my)
      for (int mx = 0; mx < j->mcux; ++mx) {
        if (j->restart_interval) {
          if (todo == 0) {
            if (restart(j, &rst)) return kFormatError;
            pred[0] = pred[1] = pred[2] = 0;
            todo = j->restart_interval;
          }
          --todo;
        }
        for (int i = 0; i < ns; ++i) {
          Component *cp = sc[i];
          for (int v = 0; v < cp->v; ++v)
            for (int h = 0; h < cp->h; ++h) {
              size_t b = (size_t)(my * cp->v + v) * cp->bw + (size_t)mx * cp->h + h;
              if (decode_block(j, cp, &pred[i], cp->coef + b * 64)) return kFormatError;
            }
        }
      }
  }
  if (check_ended(j)) return kFormatError;
  /* on to the marker after the scan's data */
  while (j->p + 1 < j->end &&
         !(j->p[0] == 0xFF && j->p[1] != 0x00 && j->p[1] != 0xFF &&
           (j->p[1] < 0xD0 || j->p[1] > 0xD7)))
    ++j->p;
  return kOk;
}

/* ---- markers ----------------------------------------------------------------------- */

/* Reads markers from SOI up to EOI. A stream of tables alone (abbreviated) ends at its
 * EOI with no frame. */
static int parse(Jpeg *j, const uint8_t *data, size_t len, int want_frame) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return fail(j, "not a JPEG stream (no SOI)");
  const uint8_t *p = data + 2, *end = data + len;
  int scans = 0;
  j->end = end;
  for (;;) {
    while (p < end && *p != 0xFF) ++p; /* libjpeg skips stray bytes before a marker */
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) {
      if (want_frame && scans) break; /* no EOI after the data: libjpeg warns, and so ends */
      return fail(j, "truncated JPEG stream (no EOI)");
    }
    int marker = *p++;
    if (marker == 0xD9) break;
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
    if (end - p < 2) return fail(j, "truncated JPEG marker 0x%02X", marker);
    size_t n = be16(p);
    if (n < 2 || (size_t)(end - p) < n) return fail(j, "truncated JPEG marker 0x%02X", marker);
    const uint8_t *body = p + 2;
    n -= 2;
    p += 2 + n;
    int rc = kOk;
    if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
        marker != 0xCC) {
      rc = read_sof(j, marker, body, n);
    } else if (marker == 0xC4) {
      rc = read_dht(j, body, n);
    } else if (marker == 0xCC) {
      rc = fail(j, "arithmetic-coded JPEG (DAC marker) is not supported");
    } else if (marker == 0xDB) {
      rc = read_dqt(j, body, n);
    } else if (marker == 0xDD) {
      if (n < 2) return fail(j, "truncated DRI marker");
      j->restart_interval = (int)be16(body);
    } else if (marker == 0xDA) {
      if (!want_frame) return fail(j, "a table stream with image data");
      rc = read_scan(j, body, n);
      p = j->p;
      ++scans;
    } else if (marker == 0xE0) { /* jdmarker.c examine_app0 */
      if (n >= 14 && !memcmp(body, "JFIF", 5)) j->jfif = 1;
    } else if (marker == 0xEE) { /* jdmarker.c examine_app14 */
      if (n >= 12 && !memcmp(body, "Adobe", 5)) {
        j->adobe = 1;
        j->adobe_transform = body[11];
      }
    }
    if (rc) return rc;
  }
  if (want_frame && !j->frame) return fail(j, "no frame header in the JPEG stream");
  if (want_frame && !scans) return fail(j, "no image data in the JPEG stream");
  return kOk;
}

/* ---- IDCT (jidctint.c, JDCT_ISLOW) ----------------------------------------------------- */

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
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* jdmaster.c's prepare_range_limit_table, post-IDCT part: index (x & 1023) of a value
 * x centred on 0 */
static uint8_t kRangeLimit[1024];
static void range_limit_init(void) {
  for (int i = 0; i < 1024; ++i) {
    int v;
    if (i < 128) v = i + 128;
    else if (i < 512) v = 255;
    else if (i < 896) v = 0;
    else v = i - 896;
    kRangeLimit[i] = (uint8_t)v;
  }
}

static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out, size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t *ip = in + c;
    const uint16_t *qp = q + c;
    int *wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (ip[0] * (int)qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * (int)qp[16], z3 = ip[48] * (int)qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * (int)qp[0];
    z3 = ip[32] * (int)qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * (int)qp[56];
    tmp1 = ip[40] * (int)qp[40];
    tmp2 = ip[24] * (int)qp[24];
    tmp3 = ip[8] * (int)qp[8];
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
  for (int r = 0; r < 8; ++r) {
    const int *wp = ws + 8 * r;
    uint8_t *o = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = kRangeLimit[(int)DESCALE((int64_t)wp[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
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
    const int sh = CONST_BITS + PASS1_BITS + 3;
    o[0] = kRangeLimit[(int)DESCALE(tmp10 + tmp3, sh) & 1023];
    o[7] = kRangeLimit[(int)DESCALE(tmp10 - tmp3, sh) & 1023];
    o[1] = kRangeLimit[(int)DESCALE(tmp11 + tmp2, sh) & 1023];
    o[6] = kRangeLimit[(int)DESCALE(tmp11 - tmp2, sh) & 1023];
    o[2] = kRangeLimit[(int)DESCALE(tmp12 + tmp1, sh) & 1023];
    o[5] = kRangeLimit[(int)DESCALE(tmp12 - tmp1, sh) & 1023];
    o[3] = kRangeLimit[(int)DESCALE(tmp13 + tmp0, sh) & 1023];
    o[4] = kRangeLimit[(int)DESCALE(tmp13 - tmp0, sh) & 1023];
  }
}

/* ---- upsampling (jdsample.c) and colour (jdcolor.c) ------------------------------------- */

/* One output row (width samples, the frame's width) of component cp. rows: the
 * component's rows as libjpeg's context gives them, the edges replicated at dh. */
static void upsample_row(const Jpeg *j, const Component *cp, int y, uint8_t *o, uint8_t *tmp) {
  const size_t stride = (size_t)cp->bw * 8;
  const int W = j->width, rh = j->hmax / cp->h, rv = j->vmax / cp->v;
  const uint8_t *plane = cp->plane;
  if (rh == 1 && rv == 1) {
    memcpy(o, plane + (size_t)y * stride, (size_t)W);
    return;
  }
  const int r = rv == 2 ? y >> 1 : y;
  const uint8_t *near = plane + (size_t)r * stride;
  if (rv == 2 && (rh == 1 || cp->dw > 2)) {
    int other = (y & 1) ? (r + 1 < cp->dh ? r + 1 : cp->dh - 1) : (r > 0 ? r - 1 : 0);
    const uint8_t *far = plane + (size_t)other * stride;
    if (rh == 1) { /* h1v2_fancy_upsample */
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x) o[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
      return;
    }
    /* h2v2_fancy_upsample: column sums, then 3:1 across with rounding 8 and 7 */
    const int dw = cp->dw;
    int *sum = (int *)(void *)tmp;
    for (int x = 0; x < dw; ++x) sum[x] = near[x] * 3 + far[x];
    uint8_t *row = tmp + sizeof(int) * (size_t)dw;
    row[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
    row[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
    for (int x = 1; x < dw - 1; ++x) {
      row[2 * x] = (uint8_t)((sum[x] * 3 + sum[x - 1] + 8) >> 4);
      row[2 * x + 1] = (uint8_t)((sum[x] * 3 + sum[x + 1] + 7) >> 4);
    }
    row[2 * dw - 2] = (uint8_t)((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
    row[2 * dw - 1] = (uint8_t)((sum[dw - 1] * 4 + 7) >> 4);
    memcpy(o, row, (size_t)W);
    return;
  }
  if (rh == 2 && cp->dw > 2) { /* h2v1_fancy_upsample */
    const int dw = cp->dw;
    uint8_t *row = tmp;
    row[0] = near[0];
    row[1] = (uint8_t)((near[0] * 3 + near[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      row[2 * x] = (uint8_t)((near[x] * 3 + near[x - 1] + 1) >> 2);
      row[2 * x + 1] = (uint8_t)((near[x] * 3 + near[x + 1] + 2) >> 2);
    }
    row[2 * dw - 2] = (uint8_t)((near[dw - 1] * 3 + near[dw - 2] + 1) >> 2);
    row[2 * dw - 1] = near[dw - 1];
    memcpy(o, row, (size_t)W);
    return;
  }
  /* h2v1_upsample / h2v2_upsample: plain replication (the row is r for both halves) */
  for (int x = 0; x < W; ++x) o[x] = near[x >> 1];
}

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))
static int kCrR[256], kCbB[256];
static int64_t kCrG[256], kCbG[256];
static void color_init(void) {
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    kCrR[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    kCbB[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    kCrG[i] = -FIX(0.71414) * x;
    kCbG[i] = -FIX(0.34414) * x + ONE_HALF;
  }
}
static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
static inline uint8_t luma(int r, int g, int b) { /* PIL's RGB -> L */
  return (uint8_t)((r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16);
}

static pthread_once_t tables_once = PTHREAD_ONCE_INIT;
static void tables_init(void) {
  range_limit_init();
  color_init();
}

static void jpeg_free(Jpeg *j) {
  for (int c = 0; c < 3; ++c) {
    free(j->comp[c].coef);
    free(j->comp[c].plane);
  }
}

static int finish(Jpeg *j, int color, int channels, uint8_t *out) {
  for (int c = 0; c < j->ncomp; ++c) {
    Component *cp = &j->comp[c];
    if (j->hmax % cp->h || j->vmax % cp->v)
      return fail(j, "JPEG sampling factors %dx%d do not divide %dx%d", cp->h, cp->v, j->hmax,
                  j->vmax);
    size_t stride = (size_t)cp->bw * 8;
    cp->plane = malloc(stride * cp->bh * 8);
    if (cp->plane == NULL) return fail(j, "no memory for a %d x %d JPEG", j->width, j->height);
    for (int by = 0; by < cp->bh; ++by)
      for (int bx = 0; bx < cp->bw; ++bx)
        idct_islow(cp->coef + ((size_t)by * cp->bw + bx) * 64, cp->quant,
                   cp->plane + (size_t)by * 8 * stride + (size_t)bx * 8, stride);
  }
  int ycc = 0;
  if (j->ncomp == 3) {
    if (color == kJpegColorYCbCr) ycc = 1;
    else if (color == kJpegColorAuto) { /* jdapimin.c default_decompress_parms */
      if (j->jfif) ycc = 1;
      else if (j->adobe) ycc = j->adobe_transform != 0;
      else if (j->comp[0].id == 82 && j->comp[1].id == 71 && j->comp[2].id == 66) ycc = 0;
      else ycc = 1;
    }
  }
  const int W = j->width, H = j->height;
  uint8_t *rows = malloc((size_t)W * 3 + 16);
  uint8_t *tmp = malloc(sizeof(int) * ((size_t)W + 16) + (size_t)W * 2 + 64);
  if (rows == NULL || tmp == NULL) {
    free(rows), free(tmp);
    return fail(j, "no memory for a %d x %d JPEG", W, H);
  }
  for (int y = 0; y < H; ++y) {
    for (int c = 0; c < j->ncomp; ++c) upsample_row(j, &j->comp[c], y, rows + (size_t)c * W, tmp);
    uint8_t *o = out + (size_t)y * W * channels;
    const uint8_t *c0 = rows, *c1 = rows + W, *c2 = rows + 2 * (size_t)W;
    if (j->ncomp == 1) {
      for (int x = 0; x < W; ++x, o += channels) {
        o[0] = c0[x];
        if (channels == 3) o[1] = o[2] = c0[x];
      }
    } else if (ycc) {
      for (int x = 0; x < W; ++x, o += channels) {
        int yy = c0[x], cb = c1[x], cr = c2[x];
        int r = clamp255(yy + kCrR[cr]);
        int g = clamp255(yy + (int)((kCbG[cb] + kCrG[cr]) >> SCALEBITS));
        int b = clamp255(yy + kCbB[cb]);
        if (channels == 3) o[0] = (uint8_t)r, o[1] = (uint8_t)g, o[2] = (uint8_t)b;
        else o[0] = luma(r, g, b);
      }
    } else {
      for (int x = 0; x < W; ++x, o += channels) {
        if (channels == 3) o[0] = c0[x], o[1] = c1[x], o[2] = c2[x];
        else o[0] = luma(c0[x], c1[x], c2[x]);
      }
    }
  }
  free(rows), free(tmp);
  return kOk;
}

int tpuwsi_jpeg_size(const uint8_t *data, size_t len, int *height, int *width, int *components,
                     char *err, size_t errlen) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8)
    return tpuwsi_fail(err, errlen, "not a JPEG file (no SOI marker)");
  const uint8_t *p = data + 2, *end = data + len;
  for (;;) {
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (end - p < 3) return tpuwsi_fail(err, errlen, "no frame header in the JPEG file");
    int marker = *p++;
    if (marker == 0xD8 || marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (marker == 0xD9 || marker == 0xDA)
      return tpuwsi_fail(err, errlen, "no frame header in the JPEG file");
    size_t n = be16(p);
    if (n < 2 || (size_t)(end - p) < n) return tpuwsi_fail(err, errlen, "truncated JPEG marker");
    if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
        marker != 0xCC) {
      if (n < 8) return tpuwsi_fail(err, errlen, "truncated SOF marker");
      *height = (int)be16(p + 3);
      *width = (int)be16(p + 5);
      *components = p[7];
      return kOk;
    }
    p += n;
  }
}

int tpuwsi_jpeg_decode_ex(const uint8_t *data, size_t len, const uint8_t *tables,
                          size_t tables_len, int color, int channels, uint8_t *out, int want_h,
                          int want_w, char *err, size_t errlen) {
  pthread_once(&tables_once, tables_init);
  Jpeg *j = calloc(1, sizeof(Jpeg));
  if (j == NULL) return tpuwsi_fail(err, errlen, "no memory for a JPEG decoder");
  j->err = err;
  j->errlen = errlen;
  int rc = kOk;
  if (tables != NULL && tables_len > 0) rc = parse(j, tables, tables_len, 0);
  if (rc == kOk) rc = parse(j, data, len, 1);
  if (rc == kOk && (j->height != want_h || j->width != want_w))
    rc = fail(j, "JPEG of %d x %d pixels where %d x %d were expected", j->width, j->height,
              want_w, want_h);
  if (rc == kOk) rc = finish(j, color, channels, out);
  jpeg_free(j);
  free(j);
  return rc;
}

int tpuwsi_jpeg_decode(const uint8_t *data, size_t len, int channels, uint8_t *out, int want_h,
                       int want_w, char *err, size_t errlen) {
  return tpuwsi_jpeg_decode_ex(data, len, NULL, 0, kJpegColorAuto, channels, out, want_h, want_w,
                               err, errlen);
}
