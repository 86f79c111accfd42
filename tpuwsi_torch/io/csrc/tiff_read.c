/* Slides for the walker and the sampler: the slide layer (open, levels, region
 * reads, a batch of regions on threads) and the TIFF container (pyramidal
 * TIFF, Aperio SVS, Hamamatsu NDPI). Host code,
 * built with the other codecs (codecs.h) by tpuwsi_torch/io/image.py and
 * called through ctypes, which releases the interpreter lock for each call.
 *
 * TIFF: classic and BigTIFF, little- and big-endian; tiled or striped pages
 * (a missing RowsPerStrip is one strip); compression none, LZW, Deflate (8 and
 * 32946) with the horizontal predictor, and JPEG (7) with the JPEGTables of
 * the page; photometric RGB (JPEG without a colour transform, as Aperio
 * writes it) or YCbCr (JPEG only, to RGB as libtiff's JPEGCOLORMODE_RGB);
 * 3 samples of 8 bits in one plane. The pages that are levels are those
 * tpuwsi's native reader takes (native/tileingest/tileingest.cc, ti_open):
 * the first page is the base; a later page is a level if it is marked
 * reduced or is tiled, is not a mask, is narrower than the base and within
 * 5% of its aspect ratio; the levels after the base are sorted by width and
 * the downsample is the base's width over the level's. A level in JPEG 2000
 * (Aperio 33003 and 33005, 34712) fails at open with kNotImplemented (M1c);
 * any other property of a level outside the list above fails at open with a
 * message naming it. A region is read as that reader reads it: zeros outside
 * the level, the parts of the tiles or strips it covers copied in.
 *
 * Each chunk (tile or strip) a region covers is decoded into a buffer of the
 * region's read and copied out; nothing decoded is kept between reads.
 *
 * tpuwsi_slide_open / _levels / _level / _close, tpuwsi_slide_check (open's
 * refusals from the TIFF's directories alone), tpuwsi_slide_read_region (one
 * region, level-0 origin), tpuwsi_slide_read_regions (a batch on threads).
 */
#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <strings.h>
#include <unistd.h>

#include "codecs.h"

/* ---- TIFF ------------------------------------------------------------------------------ */

enum {
  kNone = 1, kLzw = 5, kJpegOld = 6, kJpeg = 7, kDeflate = 8, kDeflateOld = 32946
};

typedef struct {
  int64_t width, height;
  int tiled;
  int64_t cw, ch;          /* tile width and height; for strips, width and rows per strip */
  int64_t across, nchunks; /* chunks in a row of the level, in all */
  int compression, photometric, predictor;
  uint64_t *offsets, *counts;
  uint8_t *tables; /* JPEGTables */
  size_t tables_len;
} TiffLevel;

typedef struct {
  int fd;
  TiffLevel *levels;
  int nlevels;
} Tiff;

typedef struct { /* a directory's entries, the file's byte order unresolved */
  int fd, big, msb;
  uint64_t n;
  uint8_t *entries;
} Ifd;

int tpuwsi_pread_all(int fd, void *buf, size_t n, uint64_t off) {
  size_t done = 0;
  while (done < n) {
    ssize_t got = pread(fd, (uint8_t *)buf + done, n - done, (off_t)(off + done));
    if (got < 0 && errno == EINTR) continue;
    if (got <= 0) return -1;
    done += (size_t)got;
  }
  return 0;
}

static uint64_t get_u(const uint8_t *p, int bytes, int msb) {
  uint64_t v = 0;
  for (int i = 0; i < bytes; ++i) v |= (uint64_t)p[msb ? bytes - 1 - i : i] << (8 * i);
  return v;
}

static int type_size(int type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: case 13: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
  }
  return 0;
}

static const uint8_t *find_tag(const Ifd *d, int tag) {
  size_t size = d->big ? 20 : 12;
  for (uint64_t i = 0; i < d->n; ++i) {
    const uint8_t *e = d->entries + i * size;
    if ((int)get_u(e, 2, d->msb) == tag) return e;
  }
  return NULL;
}

/* the values of an integer tag → *out (malloc'd), *count; 0 if absent, -1 if unreadable */
static int tag_values(const Ifd *d, int tag, uint64_t **out, uint64_t *count) {
  const uint8_t *e = find_tag(d, tag);
  *out = NULL;
  *count = 0;
  if (e == NULL) return 0;
  int type = (int)get_u(e + 2, 2, d->msb), size = type_size(type);
  if (type != 1 && type != 3 && type != 4 && type != 16 && type != 13 && type != 18) return -1;
  uint64_t n = get_u(e + 4, d->big ? 8 : 4, d->msb);
  const uint8_t *inline_at = e + (d->big ? 12 : 8);
  size_t room = d->big ? 8 : 4;
  if (n == 0 || n > ((uint64_t)1 << 32)) return -1;
  uint8_t *raw = malloc(n * size);
  uint64_t *vals = malloc(n * sizeof(uint64_t));
  if (raw == NULL || vals == NULL) {
    free(raw), free(vals);
    return -1;
  }
  if (n * size <= room) {
    memcpy(raw, inline_at, n * size);
  } else if (tpuwsi_pread_all(d->fd, raw, n * size, get_u(inline_at, (int)room, d->msb))) {
    free(raw), free(vals);
    return -1;
  }
  for (uint64_t i = 0; i < n; ++i) vals[i] = get_u(raw + i * size, size, d->msb);
  free(raw);
  *out = vals;
  *count = n;
  return 1;
}

static int tag_u(const Ifd *d, int tag, uint64_t dflt, uint64_t *v) {
  uint64_t *vals, n;
  int rc = tag_values(d, tag, &vals, &n);
  *v = rc > 0 ? vals[0] : dflt;
  free(vals);
  return rc;
}

static int tag_bytes(const Ifd *d, int tag, uint8_t **out, size_t *len) {
  const uint8_t *e = find_tag(d, tag);
  *out = NULL;
  *len = 0;
  if (e == NULL) return 0;
  int size = type_size((int)get_u(e + 2, 2, d->msb));
  uint64_t n = get_u(e + 4, d->big ? 8 : 4, d->msb) * (uint64_t)size;
  const uint8_t *inline_at = e + (d->big ? 12 : 8);
  size_t room = d->big ? 8 : 4;
  if (size == 0 || n > ((uint64_t)1 << 30) || (*out = malloc(n + 1)) == NULL) return -1;
  if (n <= room) memcpy(*out, inline_at, n);
  else if (tpuwsi_pread_all(d->fd, *out, n, get_u(inline_at, (int)room, d->msb))) return -1;
  *len = n;
  return 1;
}

static int read_ifd(Ifd *d, uint64_t off, uint64_t *next) {
  uint8_t head[8];
  int count_bytes = d->big ? 8 : 2, entry = d->big ? 20 : 12, next_bytes = d->big ? 8 : 4;
  if (tpuwsi_pread_all(d->fd, head, count_bytes, off)) return -1;
  d->n = get_u(head, count_bytes, d->msb);
  if (d->n > 1 << 20) return -1;
  d->entries = malloc(d->n * entry + next_bytes);
  if (d->entries == NULL || tpuwsi_pread_all(d->fd, d->entries, d->n * entry + next_bytes,
                                      off + count_bytes))
    return -1;
  *next = get_u(d->entries + d->n * entry, next_bytes, d->msb);
  return 0;
}

static void tiff_close(Slide *s) {
  Tiff *t = s->impl;
  for (int i = 0; i < t->nlevels; ++i) {
    free(t->levels[i].offsets);
    free(t->levels[i].counts);
    free(t->levels[i].tables);
  }
  free(t->levels);
  if (t->fd >= 0) close(t->fd);
  free(t);
  free(s->levels);
  free(s);
}

/* A directory's level description, checked against what this reader decodes;
 * its chunks' offsets, byte counts and JPEGTables are read unless headers_only.
 * kNotImplemented for JPEG 2000. */
static int describe_level(const Ifd *d, TiffLevel *L, const char *path, int headers_only,
                          char *err, size_t errlen) {
  uint64_t v, *bps = NULL, nbps = 0;
  tag_u(d, 259, 1, &v);
  L->compression = (int)v;
  if (v == 33003 || v == 33005 || v == 34712) {
    snprintf(err, errlen,
             "%s: JPEG 2000 tiles (TIFF compression %d) are not read yet: they need a JPEG "
             "2000 decoder that runs on the card's machine, which has no OpenJPEG (ROADMAP.md, "
             "Queue 1, M1c)", path, (int)v);
    return kNotImplemented;
  }
  if (v == kJpegOld)
    return tpuwsi_fail(err, errlen, "%s: old-style JPEG (TIFF compression 6) is not supported",
                       path);
  if (v != kNone && v != kLzw && v != kJpeg && v != kDeflate && v != kDeflateOld)
    return tpuwsi_fail(err, errlen, "%s: TIFF compression %d is not supported (none, LZW, "
                       "Deflate and JPEG are)", path, (int)v);
  uint64_t spp;
  tag_u(d, 277, 1, &spp);
  if (tag_values(d, 258, &bps, &nbps) < 0) return tpuwsi_fail(err, errlen, "%s: bad BitsPerSample", path);
  int eight = 1;
  for (uint64_t i = 0; i < nbps; ++i) eight &= bps[i] == 8;
  free(bps);
  if (nbps == 0 || !eight)
    return tpuwsi_fail(err, errlen, "%s: TIFF samples that are not 8 bits are not supported",
                       path);
  if (spp != 3)
    return tpuwsi_fail(err, errlen, "%s: TIFF with %d samples a pixel is not supported (3: RGB "
                       "or YCbCr)", path, (int)spp);
  int had = tag_u(d, 262, 2, &v);
  L->photometric = (int)v;
  if (had && v != 2 && v != 6)
    return tpuwsi_fail(err, errlen, "%s: TIFF photometric interpretation %d is not supported "
                       "(RGB or YCbCr)", path, (int)v);
  if (v == 6 && L->compression != kJpeg)
    return tpuwsi_fail(err, errlen, "%s: YCbCr TIFF without JPEG compression is not supported",
                       path);
  tag_u(d, 284, 1, &v);
  if (v != 1) return tpuwsi_fail(err, errlen, "%s: TIFF with separate planes is not supported", path);
  tag_u(d, 266, 1, &v);
  if (v != 1) return tpuwsi_fail(err, errlen, "%s: TIFF fill order %d is not supported", path, (int)v);
  tag_u(d, 274, 1, &v);
  if (v != 1)
    return tpuwsi_fail(err, errlen, "%s: TIFF orientation %d is not supported (top-left only)",
                       path, (int)v);
  tag_u(d, 317, 1, &v);
  L->predictor = (int)v;
  if (v != 1 && !(v == 2 && (L->compression == kLzw || L->compression == kDeflate ||
                             L->compression == kDeflateOld)))
    return tpuwsi_fail(err, errlen, "%s: TIFF predictor %d with compression %d is not "
                       "supported", path, (int)v, L->compression);
  int offsets_tag = L->tiled ? 324 : 273, counts_tag = L->tiled ? 325 : 279;
  uint64_t n_off, n_cnt;
  if (L->tiled) {
    tag_u(d, 322, 0, &v);
    L->cw = (int64_t)v;
    tag_u(d, 323, 0, &v);
    L->ch = (int64_t)v;
    if (L->cw <= 0 || L->ch <= 0) return tpuwsi_fail(err, errlen, "%s: bad TIFF tile size", path);
    L->across = (L->width + L->cw - 1) / L->cw;
    L->nchunks = L->across * ((L->height + L->ch - 1) / L->ch);
  } else {
    tag_u(d, 278, (uint64_t)L->height, &v);
    /* an absent RowsPerStrip means one strip (tileingest.cc clamps libtiff's default) */
    if (v == 0 || v > (uint64_t)L->height) v = (uint64_t)L->height;
    L->cw = L->width;
    L->ch = (int64_t)v;
    L->across = 1;
    L->nchunks = (L->height + L->ch - 1) / L->ch;
  }
  if (headers_only) return kOk;
  if (tag_values(d, offsets_tag, &L->offsets, &n_off) <= 0 ||
      tag_values(d, counts_tag, &L->counts, &n_cnt) <= 0 || n_off < (uint64_t)L->nchunks ||
      n_cnt < (uint64_t)L->nchunks)
    return tpuwsi_fail(err, errlen, "%s: missing or short TIFF %s offsets or byte counts", path,
                       L->tiled ? "tile" : "strip");
  if (L->compression == kJpeg && tag_bytes(d, 347, &L->tables, &L->tables_len) < 0)
    return tpuwsi_fail(err, errlen, "%s: unreadable JPEGTables", path);
  return kOk;
}

/* TIFF LZW (the MSB-first codes of TIFF 6.0, the width growing one code early) */
static int lzw_decode(const uint8_t *in, size_t n, uint8_t *out, size_t want) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) return -2; /* old-style (LSB-first) LZW */
  static __thread uint16_t prefix[4096];
  static __thread uint8_t suffix[4096], first[4096];
  static __thread uint16_t length[4096];
  uint8_t stack[4096];
  size_t o = 0, bitpos = 0, total = n * 8;
  int width = 9, next = 258, old = -1;
  for (int i = 0; i < 256; ++i) prefix[i] = 0, suffix[i] = first[i] = (uint8_t)i, length[i] = 1;
  while (o < want) {
    if (bitpos + width > total) return -1;
    uint32_t acc = 0;
    for (int b = 0; b < width; ++b, ++bitpos)
      acc = acc << 1 | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    int code = (int)acc;
    if (code == 256) {
      width = 9;
      next = 258;
      old = -1;
      continue;
    }
    if (code == 257) break;
    int emit = code, len;
    if (old < 0) {
      if (code > 255) return -1;
    } else {
      if (code > next || next >= 4096) return -1;
      /* the new entry: old's string plus the first byte of code's (old's own where code is new) */
      prefix[next] = (uint16_t)old;
      suffix[next] = code == next ? first[old] : first[code];
      first[next] = first[old];
      length[next] = (uint16_t)(length[old] + 1);
      ++next;
      if (next == 511 || next == 1023 || next == 2047) ++width;
      if (width > 12) width = 12;
    }
    len = length[emit];
    int k = len;
    for (int c = emit; k > 0; c = prefix[c]) stack[--k] = suffix[c];
    size_t take = (size_t)len < want - o ? (size_t)len : want - o;
    memcpy(out + o, stack, take);
    o += take;
    old = code;
  }
  return o == want ? 0 : -1;
}

static int tiff_decode_chunk(Slide *s, int level, int64_t index, uint8_t *out, size_t bytes,
                             char *err, size_t errlen) {
  Tiff *t = s->impl;
  TiffLevel *L = &t->levels[level];
  const int64_t w = L->cw;
  const int64_t rows = (int64_t)(bytes / ((size_t)w * 3));
  const uint64_t n = L->counts[index], off = L->offsets[index];
  if (n == 0 || n > ((uint64_t)1 << 31))
    return tpuwsi_fail(err, errlen, "TIFF %s %ld of level %d has %lu bytes",
                       L->tiled ? "tile" : "strip", (long)index, level, (unsigned long)n);
  uint8_t *raw = malloc(n);
  if (raw == NULL) return tpuwsi_fail(err, errlen, "no memory for %lu bytes", (unsigned long)n);
  if (tpuwsi_pread_all(t->fd, raw, n, off)) {
    free(raw);
    return tpuwsi_fail(err, errlen, "cannot read %lu bytes at %lu: %s", (unsigned long)n,
                       (unsigned long)off, strerror(errno ? errno : EIO));
  }
  int rc = kOk;
  if (L->compression == kJpeg) {
    int fh = 0, fw = 0, nc = 0;
    rc = tpuwsi_jpeg_size(raw, n, &fh, &fw, &nc, err, errlen);
    int fits = fw == w && (L->tiled ? fh == L->ch : fh >= rows);
    if (rc == kOk && !fits)
      rc = tpuwsi_fail(err, errlen, "JPEG of %d x %d pixels in a TIFF %s of %ld x %ld", fw, fh,
                       L->tiled ? "tile" : "strip", (long)w, (long)(L->tiled ? L->ch : rows));
    uint8_t *frame = rc == kOk && fh != rows ? malloc((size_t)fw * fh * 3) : out;
    if (rc == kOk && frame == NULL) rc = tpuwsi_fail(err, errlen, "no memory for a JPEG frame");
    if (rc == kOk)
      rc = tpuwsi_jpeg_decode_ex(raw, n, L->tables, L->tables_len,
                                 L->photometric == 6 ? kJpegColorYCbCr : kJpegColorAsCoded, 3,
                                 frame, fh, fw, err, errlen);
    if (frame != out) {
      if (rc == kOk) memcpy(out, frame, bytes);
      free(frame);
    }
  } else {
    if (L->compression == kNone) {
      if (n < bytes) rc = tpuwsi_fail(err, errlen, "TIFF chunk of %lu bytes, %zu expected",
                                      (unsigned long)n, bytes);
      else memcpy(out, raw, bytes);
    } else if (L->compression == kLzw) {
      int z = lzw_decode(raw, n, out, bytes);
      if (z == -2) rc = tpuwsi_fail(err, errlen, "old-style TIFF LZW is not supported");
      else if (z) rc = tpuwsi_fail(err, errlen, "damaged LZW data in a TIFF chunk");
    } else {
      unsigned long got = bytes;
      int z = uncompress(out, &got, raw, n);
      if ((z != 0 && z != -5) || got != bytes)
        rc = tpuwsi_fail(err, errlen, "damaged Deflate data in a TIFF chunk (zlib error %d, "
                         "%lu of %zu bytes)", z, got, bytes);
    }
    if (rc == kOk && L->predictor == 2)
      for (int64_t r = 0; r < rows; ++r) {
        uint8_t *p = out + (size_t)r * w * 3;
        for (int64_t i = 3; i < w * 3; ++i) p[i] = (uint8_t)(p[i] + p[i - 3]);
      }
  }
  free(raw);
  return rc;
}

typedef struct {
  const TiffLevel *L;
  int64_t cx, cy;        /* the chunk's origin in the level */
  int64_t x0, y0, w;     /* the region's origin and width */
  int64_t ix0, ix1, iy0, iy1; /* the part of the region to copy */
  uint8_t *out;
} Copy;

static void copy_part(const uint8_t *pixels, const Copy *c) {
  const int64_t cw = c->L->cw;
  for (int64_t y = c->iy0; y < c->iy1; ++y)
    memcpy(c->out + ((size_t)(y - c->y0) * c->w + (size_t)(c->ix0 - c->x0)) * 3,
           pixels + ((size_t)(y - c->cy) * cw + (size_t)(c->ix0 - c->cx)) * 3,
           (size_t)(c->ix1 - c->ix0) * 3);
}

static int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
static int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

static int tiff_read_rect(Slide *s, int level, int64_t x0, int64_t y0, int64_t w, int64_t h,
                          uint8_t *out, char *err, size_t errlen) {
  const TiffLevel *L = &((Tiff *)s->impl)->levels[level];
  memset(out, 0, (size_t)w * h * 3);
  const int64_t rx0 = max64(x0, 0), ry0 = max64(y0, 0);
  const int64_t rx1 = min64(x0 + w, L->width), ry1 = min64(y0 + h, L->height);
  if (rx0 >= rx1 || ry0 >= ry1) return kOk;
  uint8_t *pixels = malloc((size_t)L->cw * L->ch * 3);
  if (pixels == NULL) return tpuwsi_fail(err, errlen, "no memory for a TIFF chunk");
  int rc = kOk;
  for (int64_t cy = ry0 / L->ch * L->ch; rc == kOk && cy < ry1; cy += L->ch)
    for (int64_t cx = rx0 / L->cw * L->cw; rc == kOk && cx < rx1; cx += L->cw) {
      const int64_t rows = L->tiled ? L->ch : min64(L->ch, L->height - cy);
      Copy c = {L, cx, cy, x0, y0, w, max64(cx, rx0), min64(cx + L->cw, rx1), max64(cy, ry0),
                min64(cy + rows, ry1), out};
      int64_t index = cy / L->ch * L->across + cx / L->cw;
      rc = tiff_decode_chunk(s, level, index, pixels, (size_t)L->cw * rows * 3, err, errlen);
      if (rc == kOk) copy_part(pixels, &c);
    }
  free(pixels);
  return rc;
}

static int aspect_ok(int64_t w, int64_t h, int64_t bw, int64_t bh) {
  const double base = (double)bw / bh, ar = (double)w / h;
  return !(ar > base * 1.05 || ar < base * 0.95);
}

/* headers_only: the directories alone, enough to check the levels but not to read them */
static Slide *tiff_open(const char *path, int headers_only, int *status, char *err,
                        size_t errlen) {
  Tiff *t = calloc(1, sizeof(Tiff));
  Slide *s = calloc(1, sizeof(Slide));
  Ifd d = {0};
  int rc = kOk;
  if (t == NULL || s == NULL) {
    free(t), free(s);
    *status = tpuwsi_fail(err, errlen, "no memory");
    return NULL;
  }
  s->impl = t;
  s->close = tiff_close;
  s->read_rect = tiff_read_rect;
  t->fd = open(path, O_RDONLY | O_CLOEXEC);
  if (t->fd < 0) {
    snprintf(err, errlen, "%d", errno);
    *status = kOsError;
    tiff_close(s);
    return NULL;
  }
  uint8_t head[16];
  uint64_t off = 0;
  int big = 0, msb = 0;
  if (tpuwsi_pread_all(t->fd, head, 8, 0) ||
      !((head[0] == 'I' && head[1] == 'I') || (head[0] == 'M' && head[1] == 'M'))) {
    rc = tpuwsi_fail(err, errlen, "%s: not a TIFF file", path);
  } else {
    msb = head[0] == 'M';
    int magic = (int)get_u(head + 2, 2, msb);
    big = magic == 43;
    if (magic == 42) {
      off = get_u(head + 4, 4, msb);
    } else if (magic == 43 && !tpuwsi_pread_all(t->fd, head, 16, 0) &&
               get_u(head + 4, 2, msb) == 8) {
      off = get_u(head + 8, 8, msb);
    } else {
      rc = tpuwsi_fail(err, errlen, "%s: not a TIFF file (version %d)", path, magic);
    }
  }
  int64_t base_w = 0, base_h = 0;
  for (int dirs = 0; rc == kOk && off != 0; ++dirs) {
    d = (Ifd){t->fd, big, msb, 0, NULL};
    uint64_t next = 0;
    if (dirs > 65535 || read_ifd(&d, off, &next)) {
      rc = tpuwsi_fail(err, errlen, "%s: unreadable TIFF directory %d", path, dirs);
      break;
    }
    off = next;
    uint64_t w, h, subfile;
    tag_u(&d, 256, 0, &w);
    tag_u(&d, 257, 0, &h);
    int tiled = find_tag(&d, 322) != NULL;
    int take = w > 0 && h > 0;
    if (take && t->nlevels > 0) {
      tag_u(&d, 254, 0, &subfile);
      take = !(subfile & 4) && ((subfile & 1) || tiled) && (int64_t)w < base_w &&
             aspect_ok((int64_t)w, (int64_t)h, base_w, base_h);
    }
    if (take) {
      TiffLevel *grown = realloc(t->levels, sizeof(TiffLevel) * (t->nlevels + 1));
      if (grown == NULL) {
        rc = tpuwsi_fail(err, errlen, "no memory");
        break;
      }
      t->levels = grown;
      TiffLevel *L = &t->levels[t->nlevels++];
      memset(L, 0, sizeof *L);
      L->width = (int64_t)w;
      L->height = (int64_t)h;
      L->tiled = tiled;
      if (t->nlevels == 1) base_w = (int64_t)w, base_h = (int64_t)h;
      rc = describe_level(&d, L, path, headers_only, err, errlen);
    }
    free(d.entries);
    d.entries = NULL;
  }
  if (rc == kOk && t->nlevels == 0) rc = tpuwsi_fail(err, errlen, "%s: a TIFF without an image", path);
  if (rc != kOk) {
    *status = rc;
    tiff_close(s);
    return NULL;
  }
  /* the levels after the base by width, widest first (stable) */
  for (int i = 2; i < t->nlevels; ++i)
    for (int k = i; k > 1 && t->levels[k].width > t->levels[k - 1].width; --k) {
      TiffLevel tmp = t->levels[k];
      t->levels[k] = t->levels[k - 1];
      t->levels[k - 1] = tmp;
    }
  s->nlevels = t->nlevels;
  s->levels = calloc((size_t)s->nlevels, sizeof(SlideLevel));
  if (s->levels == NULL) {
    *status = tpuwsi_fail(err, errlen, "no memory");
    tiff_close(s);
    return NULL;
  }
  for (int i = 0; i < s->nlevels; ++i)
    s->levels[i] = (SlideLevel){t->levels[i].width, t->levels[i].height,
                                (double)base_w / t->levels[i].width};
  return s;
}

/* ---- the C interface ------------------------------------------------------------------- */

Slide *tpuwsi_slide_open(const char *path, int *status, char *err, size_t errlen) {
  *status = kOk;
  const char *dot = strrchr(path, '.');
  if (dot && !strcasecmp(dot, ".mrxs")) return mirax_open(path, status, err, errlen);
  return tiff_open(path, 0, status, err, errlen);
}

int tpuwsi_slide_levels(const Slide *s) { return s->nlevels; }

void tpuwsi_slide_level(const Slide *s, int level, int64_t *width, int64_t *height,
                        double *downsample) {
  *width = s->levels[level].width;
  *height = s->levels[level].height;
  *downsample = s->levels[level].downsample;
}

void tpuwsi_slide_close(Slide *s) {
  if (s) s->close(s);
}

/* tpuwsi_slide_open's refusal of a TIFF's levels (kNotImplemented for JPEG 2000,
 * kFormatError for another property this reader does not decode), from the
 * directories alone: no chunk table is read. A MIRAX slide is not read here (no
 * level of one is refused by name): kOk. */
int tpuwsi_slide_check(const char *path, char *err, size_t errlen) {
  const char *dot = strrchr(path, '.');
  if (dot && !strcasecmp(dot, ".mrxs")) return kOk;
  int status = kOk;
  tpuwsi_slide_close(tiff_open(path, 1, &status, err, errlen));
  return status;
}

/* (x, y) level-0 coordinates, (w, h) pixels of the level: ti_read_region's meaning */
int tpuwsi_slide_read_region(Slide *s, int level, int64_t x, int64_t y, int64_t w, int64_t h,
                             uint8_t *out, char *err, size_t errlen) {
  if (level < 0 || level >= s->nlevels)
    return tpuwsi_fail(err, errlen, "level %d of a slide with %d", level, s->nlevels);
  const double ds = s->levels[level].downsample;
  return s->read_rect(s, level, (int64_t)(x / ds), (int64_t)(y / ds), w, h, out, err, errlen);
}

typedef struct {
  Slide *slide;
  int32_t level, status;
  int64_t x, y, w, h, offset; /* offset: where the region's bytes start in out */
} Region;

typedef struct {
  Region *regions;
  int n, next, failed, first;
  uint8_t *out;
  char *err;
  size_t errlen;
  pthread_mutex_t mu;
} Batch;

static void *batch_worker(void *arg) {
  Batch *b = arg;
  char msg[512];
  for (;;) {
    int i = __atomic_fetch_add(&b->next, 1, __ATOMIC_RELAXED);
    if (i >= b->n) return NULL;
    Region *r = &b->regions[i];
    r->status = tpuwsi_slide_read_region(r->slide, r->level, r->x, r->y, r->w, r->h,
                                         b->out + r->offset, msg, sizeof msg);
    if (r->status != kOk) {
      pthread_mutex_lock(&b->mu);
      ++b->failed;
      if (b->first < 0 || i < b->first) {
        b->first = i;
        snprintf(b->err, b->errlen, "%s", msg);
      }
      pthread_mutex_unlock(&b->mu);
    }
  }
}

/* Reads n regions on `threads` threads; each region's status is set. Returns the
 * number that failed, the first one's message in err. */
int tpuwsi_slide_read_regions(Region *regions, int n, uint8_t *out, int threads, char *err,
                              size_t errlen) {
  Batch b = {regions, n, 0, 0, -1, out, err, errlen, PTHREAD_MUTEX_INITIALIZER};
  if (threads > n) threads = n;
  pthread_t pool[64];
  int started = 0;
  for (; started < threads - 1 && started < 64; ++started)
    if (pthread_create(&pool[started], NULL, batch_worker, &b) != 0) break;
  batch_worker(&b);
  for (int t = 0; t < started; ++t) pthread_join(pool[t], NULL);
  return b.failed;
}
