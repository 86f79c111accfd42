/* MIRAX (.mrxs) slides, read as tpuwsi's native reader reads them
 * (native/tileingest/mirax.cc, after OpenSlide's mirax driver). Host code,
 * built with the other codecs (codecs.h).
 *
 *   NAME.mrxs             the stub file (its content is not read)
 *   NAME/Slidedat.ini     [GENERAL] SLIDE_ID, IMAGENUMBER_X/Y (the camera grid),
 *                         CameraImageDivisionsPerSide (d: tiles per camera side);
 *                         [HIERARCHICAL] HIER_COUNT, NONHIER_COUNT, INDEXFILE,
 *                         HIER_i_NAME/COUNT/VAL_j_SECTION, NONHIER_i_NAME/COUNT;
 *                         each zoom level's section: DIGITIZER_WIDTH/HEIGHT (the
 *                         stored tile), OVERLAP_X/Y, IMAGE_FORMAT (JPEG, PNG, BMP24);
 *                         [DATAFILE] FILE_COUNT, FILE_i
 *   NAME/Index.dat        a 5-byte version, SLIDE_ID, then the int32 offsets of the
 *                         hierarchical and non-hierarchical roots; each root an array
 *                         of int32 page offsets, one per record; a page is int32
 *                         count, int32 next page (0: the end), count x {image, offset,
 *                         length, file}
 *   NAME/Data%04d.dat     the tiles and other blobs
 *
 * Level 0's tiles lie on a grid of IMAGENUMBER_X * d by IMAGENUMBER_Y * d; the
 * level-0 origin of a camera comes from VIMSLIDE_POSITION_BUFFER (9 bytes a
 * camera: flag, int32 x, int32 y), or the same zlib-compressed in
 * StitchingIntensityLayer, else a regular grid spaced by the overlaps; a camera
 * whose flag is 0 is absent and reads as zeros. Zoom level n holds one tile per
 * 2^n x 2^n block of grid cells (its image number the block's top-left cell),
 * painted at position / 2^n, later tiles over earlier ones in the order of the
 * positions (top to bottom, left to right). Level 0 spans its tiles' bounding
 * box, which becomes the origin. A corrupt page chain, an unknown format or a
 * file that is not MIRAX fails at open.
 */
#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include "codecs.h"

/* ---- Slidedat.ini ---------------------------------------------------------------------- */

typedef struct {
  char *section, *key, *value;
} IniEntry;

typedef struct {
  IniEntry *e;
  int n;
} Ini;

static char *trim(char *s) {
  if ((unsigned char)s[0] == 0xEF && (unsigned char)s[1] == 0xBB && (unsigned char)s[2] == 0xBF)
    s += 3;
  while (*s == ' ' || *s == '\t' || *s == '\r' || *s == '\n') ++s;
  char *end = s + strlen(s);
  while (end > s && (end[-1] == ' ' || end[-1] == '\t' || end[-1] == '\r' || end[-1] == '\n'))
    *--end = 0;
  return s;
}

static void ini_free(Ini *ini) {
  for (int i = 0; i < ini->n; ++i) {
    free(ini->e[i].section);
    free(ini->e[i].key);
    free(ini->e[i].value);
  }
  free(ini->e);
}

static int ini_read(const char *path, Ini *ini) {
  FILE *f = fopen(path, "rb");
  if (f == NULL) return -1;
  char line[4096], *section = strdup("");
  int rc = 0;
  while (rc == 0 && fgets(line, sizeof line, f)) {
    char *s = trim(line);
    size_t len = strlen(s);
    if (len == 0 || s[0] == ';' || s[0] == '#') continue;
    if (s[0] == '[' && s[len - 1] == ']') {
      s[len - 1] = 0;
      free(section);
      section = strdup(s + 1);
      continue;
    }
    char *eq = strchr(s, '=');
    if (eq == NULL) continue;
    *eq = 0;
    IniEntry *grown = realloc(ini->e, sizeof(IniEntry) * (ini->n + 1));
    if (grown == NULL) {
      rc = -1;
      break;
    }
    ini->e = grown;
    /* a key given twice keeps its last value, as a std::map assignment would */
    ini->e[ini->n++] = (IniEntry){strdup(section), strdup(trim(s)), strdup(trim(eq + 1))};
  }
  free(section);
  fclose(f);
  return rc;
}

static const char *ini_get(const Ini *ini, const char *section, const char *key) {
  for (int i = ini->n - 1; i >= 0; --i)
    if (!strcmp(ini->e[i].section, section) && !strcmp(ini->e[i].key, key)) return ini->e[i].value;
  return NULL;
}

/* std::stol's meaning: leading spaces, a sign, digits; no digits → dflt */
static long ini_num(const Ini *ini, const char *section, const char *key, long dflt) {
  const char *v = ini_get(ini, section, key);
  if (v == NULL) return dflt;
  char *end;
  errno = 0;
  long x = strtol(v, &end, 10);
  return end == v || errno ? dflt : x;
}

static double ini_real(const Ini *ini, const char *section, const char *key, double dflt) {
  const char *v = ini_get(ini, section, key);
  if (v == NULL) return dflt;
  char *end;
  double x = strtod(v, &end);
  return end == v ? dflt : x;
}

/* ---- Index.dat --------------------------------------------------------------------------- */

typedef struct {
  int32_t image, offset, length, fileno;
} IndexEntry;

static int32_t le32(const uint8_t *p) {
  return (int32_t)((uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                   (uint32_t)p[3] << 24);
}

/* the page chain at root + 4 * record → *out (appended); -1 if it runs off the file
 * or loops */
static int read_record(const uint8_t *idx, size_t size, int32_t root, int record,
                       IndexEntry **out, int *n) {
  size_t at = (size_t)(uint32_t)root + 4 * (size_t)record;
  if (root < 0 || at + 4 > size) return -1;
  int32_t page = le32(idx + at);
  size_t pages_left = size / 8 + 1;
  while (page != 0) {
    if (pages_left-- == 0 || page < 0 || (size_t)page + 8 > size) return -1;
    int32_t count = le32(idx + page), next = le32(idx + page + 4);
    size_t p = (size_t)page + 8;
    if (count < 0 || p + 16 * (size_t)count > size) return -1;
    IndexEntry *grown = realloc(*out, sizeof(IndexEntry) * ((size_t)*n + count + 1));
    if (grown == NULL) return -1;
    *out = grown;
    for (int32_t i = 0; i < count; ++i, p += 16)
      (*out)[(*n)++] = (IndexEntry){le32(idx + p), le32(idx + p + 4), le32(idx + p + 8),
                                    le32(idx + p + 12)};
    page = next;
  }
  return 0;
}

/* ---- the slide ------------------------------------------------------------------------- */

enum { kFmtJpeg, kFmtPng, kFmtBmp24 };

typedef struct {
  int64_t px, py, offset, length;
  int32_t fileno;
} MiraxTile;

typedef struct {
  int64_t tw, th;
  int format;
  MiraxTile *tiles; /* sorted by (py, px) */
  int ntiles;
} MiraxLevel;

typedef struct {
  char **files;
  int *fds; /* -2: not opened yet (a sampler may hold many slides of many files) */
  int nfiles;
  pthread_mutex_t fds_mu;
  MiraxLevel *zoom;
  int nzoom;
} Mirax;

static int parse_format(const char *s, int *out) {
  if (!strcmp(s, "JPEG")) *out = kFmtJpeg;
  else if (!strcmp(s, "PNG")) *out = kFmtPng;
  else if (!strcmp(s, "BMP24")) *out = kFmtBmp24;
  else return -1;
  return 0;
}

static int fd_for(Mirax *m, int fileno) {
  if (fileno < 0 || fileno >= m->nfiles) return -1;
  pthread_mutex_lock(&m->fds_mu);
  if (m->fds[fileno] == -2) m->fds[fileno] = open(m->files[fileno], O_RDONLY | O_CLOEXEC);
  int fd = m->fds[fileno];
  pthread_mutex_unlock(&m->fds_mu);
  return fd;
}

static uint32_t bmp32(const uint8_t *p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
}

/* uncompressed 24-bit BMP, bottom-up (or top-down), BGR → RGB */
static int decode_bmp24(const uint8_t *buf, size_t len, int64_t w, int64_t h, uint8_t *out,
                        char *err, size_t errlen) {
  if (len < 54 || buf[0] != 'B' || buf[1] != 'M')
    return tpuwsi_fail(err, errlen, "not a BMP tile");
  const uint32_t pix = bmp32(buf + 10);
  const int32_t bw = (int32_t)bmp32(buf + 18), bh = (int32_t)bmp32(buf + 22);
  const int bpp = buf[28] | buf[29] << 8;
  if (bw != w || (bh != h && bh != -h) || bpp != 24 || bmp32(buf + 30) != 0)
    return tpuwsi_fail(err, errlen, "BMP tile of %d x %d at %d bits (compression %u), not an "
                       "uncompressed 24-bit %ld x %ld", bw, bh, bpp, bmp32(buf + 30), (long)w,
                       (long)h);
  const size_t stride = ((size_t)w * 3 + 3) & ~(size_t)3;
  if (pix + stride * h > len) return tpuwsi_fail(err, errlen, "truncated BMP tile");
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t *row = buf + pix + stride * (size_t)(bh > 0 ? h - 1 - y : y);
    uint8_t *dst = out + (size_t)y * w * 3;
    for (int64_t x = 0; x < w; ++x) {
      dst[3 * x] = row[3 * x + 2];
      dst[3 * x + 1] = row[3 * x + 1];
      dst[3 * x + 2] = row[3 * x];
    }
  }
  return kOk;
}

static int mirax_decode_tile(Mirax *m, const MiraxLevel *L, int index, uint8_t *out, char *err,
                             size_t errlen) {
  const MiraxTile *t = &L->tiles[index];
  int fd = fd_for(m, t->fileno);
  uint8_t *raw = malloc((size_t)t->length);
  if (raw == NULL) return tpuwsi_fail(err, errlen, "no memory for a MIRAX tile");
  int rc = kOk;
  if (fd < 0 || tpuwsi_pread_all(fd, raw, (size_t)t->length, (uint64_t)t->offset)) {
    rc = tpuwsi_fail(err, errlen, "cannot read %ld bytes of %s at %ld", (long)t->length,
                     m->files[t->fileno < m->nfiles && t->fileno >= 0 ? t->fileno : 0],
                     (long)t->offset);
  } else if (L->format == kFmtJpeg) {
    rc = tpuwsi_jpeg_decode(raw, (size_t)t->length, 3, out, (int)L->th, (int)L->tw, err, errlen);
  } else if (L->format == kFmtPng) {
    rc = tpuwsi_png_decode(raw, (size_t)t->length, 3, out, (int)L->th, (int)L->tw, err, errlen);
  } else {
    rc = decode_bmp24(raw, (size_t)t->length, L->tw, L->th, out, err, errlen);
  }
  free(raw);
  return rc;
}

typedef struct {
  int64_t tw, tx, ty, cx0, cx1, cy0, cy1, x0, y0, w;
  uint8_t *out;
} TileCopy;

static void paint(const uint8_t *rgb, const TileCopy *c) {
  for (int64_t y = c->cy0; y < c->cy1; ++y)
    memcpy(c->out + ((size_t)(y - c->y0) * c->w + (size_t)(c->cx0 - c->x0)) * 3,
           rgb + ((size_t)(y - c->ty) * c->tw + (size_t)(c->cx0 - c->tx)) * 3,
           (size_t)(c->cx1 - c->cx0) * 3);
}

static int64_t lo64(int64_t a, int64_t b) { return a < b ? a : b; }
static int64_t hi64(int64_t a, int64_t b) { return a > b ? a : b; }

static int mirax_read_rect(Slide *s, int level, int64_t x0, int64_t y0, int64_t w, int64_t h,
                           uint8_t *out, char *err, size_t errlen) {
  Mirax *m = s->impl;
  memset(out, 0, (size_t)w * h * 3);
  const MiraxLevel *L = &m->zoom[level];
  const int64_t ds = (int64_t)1 << level;
  const int64_t lo = (y0 - L->th) * ds, hi = (y0 + h) * ds;
  int first = 0, last = L->ntiles; /* the first tile with py > lo */
  while (first < last) {
    int mid = (first + last) / 2;
    if (L->tiles[mid].py <= lo) first = mid + 1;
    else last = mid;
  }
  uint8_t *rgb = malloc((size_t)L->tw * L->th * 3);
  if (rgb == NULL) return tpuwsi_fail(err, errlen, "no memory for a MIRAX tile");
  int rc = kOk;
  for (int i = first; rc == kOk && i < L->ntiles && L->tiles[i].py < hi; ++i) {
    const MiraxTile *t = &L->tiles[i];
    const int64_t tx = t->px / ds, ty = t->py / ds;
    /* the part inside the region and the level: zoomed tiles overhang the slide */
    TileCopy c = {L->tw, tx, ty, hi64(tx, x0),
                  lo64(lo64(tx + L->tw, x0 + w), s->levels[level].width), hi64(ty, y0),
                  lo64(lo64(ty + L->th, y0 + h), s->levels[level].height), x0, y0, w, out};
    if (c.cx0 >= c.cx1 || c.cy0 >= c.cy1) continue;
    rc = mirax_decode_tile(m, L, i, rgb, err, errlen);
    if (rc == kOk) paint(rgb, &c);
  }
  free(rgb);
  return rc;
}

static void mirax_close(Slide *s) {
  Mirax *m = s->impl;
  if (m) {
    for (int i = 0; i < m->nfiles; ++i) {
      if (m->fds && m->fds[i] >= 0) close(m->fds[i]);
      free(m->files[i]);
    }
    free(m->files);
    free(m->fds);
    for (int z = 0; z < m->nzoom; ++z) free(m->zoom[z].tiles);
    free(m->zoom);
    pthread_mutex_destroy(&m->fds_mu);
    free(m);
  }
  free(s->levels);
  free(s);
}

static int by_position(const void *a, const void *b) {
  const MiraxTile *p = a, *q = b;
  if (p->py != q->py) return p->py < q->py ? -1 : 1;
  if (p->px != q->px) return p->px < q->px ? -1 : 1;
  return 0;
}

static Slide *bad(Slide *s, Ini *ini, uint8_t *idx, int *status, char *err, size_t errlen,
                  const char *path, const char *what) {
  *status = tpuwsi_fail(err, errlen, "%s: not a MIRAX slide this reader takes: %s", path, what);
  ini_free(ini);
  free(idx);
  mirax_close(s);
  return NULL;
}

Slide *mirax_open(const char *path, int *status, char *err, size_t errlen) {
  Ini ini = {0};
  uint8_t *idx = NULL;
  Slide *s = calloc(1, sizeof(Slide));
  Mirax *m = s ? calloc(1, sizeof(Mirax)) : NULL;
  if (m == NULL) {
    free(s);
    *status = tpuwsi_fail(err, errlen, "no memory");
    return NULL;
  }
  pthread_mutex_init(&m->fds_mu, NULL);
  s->impl = m;
  s->close = mirax_close;
  s->read_rect = mirax_read_rect;
  if (access(path, F_OK) != 0) { /* the stub: its content is not read, but it must be there */
    snprintf(err, errlen, "%d", errno);
    *status = kOsError;
    mirax_close(s);
    return NULL;
  }
  const char *dot = strrchr(path, '.');
  size_t dirlen = (size_t)(dot - path);
  char dir[4096], file[4352], key[96];
  if (dirlen >= sizeof dir) return bad(s, &ini, idx, status, err, errlen, path, "path too long");
  memcpy(dir, path, dirlen);
  dir[dirlen] = 0;
  snprintf(file, sizeof file, "%s/Slidedat.ini", dir);
  if (ini_read(file, &ini)) return bad(s, &ini, idx, status, err, errlen, path, "no Slidedat.ini");
  const char *G = "GENERAL", *H = "HIERARCHICAL", *D = "DATAFILE";
  const long cam_x = ini_num(&ini, G, "IMAGENUMBER_X", -1), cam_y = ini_num(&ini, G, "IMAGENUMBER_Y", -1);
  long divisions = ini_num(&ini, G, "CameraImageDivisionsPerSide", 1);
  if (cam_x <= 0 || cam_y <= 0)
    return bad(s, &ini, idx, status, err, errlen, path, "no camera grid (IMAGENUMBER_X/Y)");
  if (divisions <= 0) divisions = 1;
  const int64_t gridw = cam_x * divisions;

  long zoom_hier = -1, zoom_levels = 0, zoom_record0 = 0, rec = 0;
  for (long i = 0, n = ini_num(&ini, H, "HIER_COUNT", 0); i < n; ++i) {
    snprintf(key, sizeof key, "HIER_%ld_NAME", i);
    const char *name = ini_get(&ini, H, key);
    snprintf(key, sizeof key, "HIER_%ld_COUNT", i);
    long count = ini_num(&ini, H, key, 0);
    if (name && !strcmp(name, "Slide zoom level")) {
      zoom_hier = i;
      zoom_levels = count;
      zoom_record0 = rec;
    }
    rec += count;
  }
  if (zoom_hier < 0 || zoom_levels <= 0)
    return bad(s, &ini, idx, status, err, errlen, path, "no 'Slide zoom level' hierarchy");

  const long file_count = ini_num(&ini, D, "FILE_COUNT", 0);
  if (file_count <= 0) return bad(s, &ini, idx, status, err, errlen, path, "no data files");
  m->files = calloc((size_t)file_count, sizeof(char *));
  m->fds = malloc(sizeof(int) * (size_t)file_count);
  if (m->files == NULL || m->fds == NULL) return bad(s, &ini, idx, status, err, errlen, path, "no memory");
  for (long i = 0; i < file_count; ++i) {
    snprintf(key, sizeof key, "FILE_%ld", i);
    const char *name = ini_get(&ini, D, key);
    m->fds[i] = -2;
    if (name == NULL || !*name) return bad(s, &ini, idx, status, err, errlen, path, "a data file without a name");
    snprintf(file, sizeof file, "%s/%s", dir, name);
    m->files[i] = strdup(file);
    m->nfiles = (int)i + 1;
  }

  const char *index_name = ini_get(&ini, H, "INDEXFILE");
  snprintf(file, sizeof file, "%s/%s", dir, index_name ? index_name : "Index.dat");
  size_t isize = 0;
  {
    FILE *f = fopen(file, "rb");
    if (f == NULL) return bad(s, &ini, idx, status, err, errlen, path, "no Index.dat");
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    idx = malloc(n > 0 ? (size_t)n : 1);
    if (n < 0 || idx == NULL || fread(idx, 1, (size_t)n, f) != (size_t)n) {
      fclose(f);
      return bad(s, &ini, idx, status, err, errlen, path, "unreadable Index.dat");
    }
    fclose(f);
    isize = (size_t)n;
  }
  const char *slide_id = ini_get(&ini, G, "SLIDE_ID");
  size_t id_len = slide_id ? strlen(slide_id) : 0, head = 5 + id_len;
  if (isize < head + 8) return bad(s, &ini, idx, status, err, errlen, path, "Index.dat too short");
  if (id_len && memcmp(idx + 5, slide_id, id_len))
    return bad(s, &ini, idx, status, err, errlen, path, "Index.dat is another slide's");
  const int32_t hier_root = le32(idx + head), nonhier_root = le32(idx + head + 4);

  snprintf(key, sizeof key, "HIER_%ld_VAL_0_SECTION", zoom_hier);
  const char *sec0 = ini_get(&ini, H, key);
  sec0 = sec0 ? sec0 : "";
  const int64_t t0w = ini_num(&ini, sec0, "DIGITIZER_WIDTH", -1);
  const int64_t t0h = ini_num(&ini, sec0, "DIGITIZER_HEIGHT", -1);
  if (t0w <= 0 || t0h <= 0) return bad(s, &ini, idx, status, err, errlen, path, "no tile size");
  int fmt0;
  const char *f0 = ini_get(&ini, sec0, "IMAGE_FORMAT");
  if (parse_format(f0 ? f0 : "JPEG", &fmt0))
    return bad(s, &ini, idx, status, err, errlen, path,
               "an IMAGE_FORMAT other than JPEG, PNG or BMP24");

  const long ncam = cam_x * cam_y;
  int64_t *cam_px = calloc((size_t)ncam, sizeof(int64_t));
  int64_t *cam_py = calloc((size_t)ncam, sizeof(int64_t));
  uint8_t *cam_ok = calloc((size_t)ncam, 1);
  if (!cam_px || !cam_py || !cam_ok) {
    free(cam_px), free(cam_py), free(cam_ok);
    return bad(s, &ini, idx, status, err, errlen, path, "no memory");
  }
  int have_positions = 0;
  rec = 0;
  for (long i = 0, n = ini_num(&ini, H, "NONHIER_COUNT", 0); i < n && !have_positions; ++i) {
    snprintf(key, sizeof key, "NONHIER_%ld_NAME", i);
    const char *name = ini_get(&ini, H, key);
    snprintf(key, sizeof key, "NONHIER_%ld_COUNT", i);
    long count = ini_num(&ini, H, key, 1);
    int raw_pos = name && !strcmp(name, "VIMSLIDE_POSITION_BUFFER");
    int zlib_pos = name && !strcmp(name, "StitchingIntensityLayer");
    IndexEntry *es = NULL;
    int nes = 0;
    size_t want = 9 * (size_t)ncam;
    if ((raw_pos || zlib_pos) && !read_record(idx, isize, nonhier_root, (int)rec, &es, &nes) &&
        nes > 0) {
      const IndexEntry e = es[0];
      if (e.fileno >= 0 && e.fileno < file_count && e.length > 0 &&
          (!raw_pos || (size_t)e.length >= want)) {
        uint8_t *buf = malloc((size_t)e.length), *pos = buf;
        int fd = fd_for(m, e.fileno);
        int ok = buf && fd >= 0 && !tpuwsi_pread_all(fd, buf, (size_t)e.length, (uint64_t)e.offset);
        if (ok && zlib_pos) {
          unsigned long got = want;
          pos = malloc(want + 1);
          ok = pos && uncompress(pos, &got, buf, (unsigned long)e.length) == 0 && got == want;
        }
        if (ok) {
          for (long c = 0; c < ncam; ++c) {
            cam_ok[c] = pos[9 * c] != 0;
            cam_px[c] = le32(pos + 9 * c + 1);
            cam_py[c] = le32(pos + 9 * c + 5);
          }
          have_positions = 1;
        }
        if (pos != buf) free(pos);
        free(buf);
      }
    }
    free(es);
    rec += count;
  }
  if (!have_positions) {
    const int64_t adv_x = divisions * t0w - (int64_t)ini_real(&ini, sec0, "OVERLAP_X", 0.0);
    const int64_t adv_y = divisions * t0h - (int64_t)ini_real(&ini, sec0, "OVERLAP_Y", 0.0);
    for (long cy = 0; cy < cam_y; ++cy)
      for (long cx = 0; cx < cam_x; ++cx) {
        cam_ok[cy * cam_x + cx] = 1;
        cam_px[cy * cam_x + cx] = cx * adv_x;
        cam_py[cy * cam_x + cx] = cy * adv_y;
      }
  }

  int64_t minx = INT64_MAX, miny = INT64_MAX, maxx = INT64_MIN, maxy = INT64_MIN;
  const char *fail_what = NULL;
  m->zoom = calloc((size_t)zoom_levels, sizeof(MiraxLevel));
  m->nzoom = m->zoom ? (int)zoom_levels : 0;
  if (m->zoom == NULL) fail_what = "no memory";
  for (long z = 0; z < zoom_levels && !fail_what; ++z) {
    snprintf(key, sizeof key, "HIER_%ld_VAL_%ld_SECTION", zoom_hier, z);
    const char *sec = ini_get(&ini, H, key);
    sec = sec ? sec : "";
    MiraxLevel *L = &m->zoom[z];
    L->tw = ini_num(&ini, sec, "DIGITIZER_WIDTH", t0w);
    L->th = ini_num(&ini, sec, "DIGITIZER_HEIGHT", t0h);
    L->format = fmt0;
    const char *f = ini_get(&ini, sec, "IMAGE_FORMAT");
    if (f && parse_format(f, &L->format)) {
      fail_what = "an IMAGE_FORMAT other than JPEG, PNG or BMP24";
      break;
    }
    IndexEntry *es = NULL;
    int nes = 0;
    if (read_record(idx, isize, hier_root, (int)(zoom_record0 + z), &es, &nes)) {
      free(es);
      fail_what = "a corrupt page chain in Index.dat";
      break;
    }
    L->tiles = malloc(sizeof(MiraxTile) * (size_t)(nes + 1));
    for (int k = 0; k < nes && L->tiles; ++k) {
      const IndexEntry e = es[k];
      if (e.image < 0 || e.length <= 0) continue;
      const int64_t gx = e.image % gridw, gy = e.image / gridw;
      const long cam = (long)((gy / divisions) * cam_x + gx / divisions);
      if (cam < 0 || cam >= ncam || !cam_ok[cam]) continue;
      MiraxTile t = {cam_px[cam] + (gx % divisions) * t0w, cam_py[cam] + (gy % divisions) * t0h,
                     e.offset, e.length, e.fileno};
      L->tiles[L->ntiles++] = t;
      if (z == 0) { /* level 0's tiles alone span the slide: zoomed tiles overhang it */
        minx = t.px < minx ? t.px : minx;
        miny = t.py < miny ? t.py : miny;
        maxx = t.px + L->tw > maxx ? t.px + L->tw : maxx;
        maxy = t.py + L->th > maxy ? t.py + L->th : maxy;
      }
    }
    free(es);
    if (L->tiles == NULL) fail_what = "no memory";
  }
  free(cam_px), free(cam_py), free(cam_ok);
  if (!fail_what && minx == INT64_MAX) fail_what = "no tiles";
  if (fail_what) return bad(s, &ini, idx, status, err, errlen, path, fail_what);
  ini_free(&ini);
  free(idx);
  for (int z = 0; z < m->nzoom; ++z) {
    MiraxLevel *L = &m->zoom[z];
    for (int k = 0; k < L->ntiles; ++k) {
      L->tiles[k].px -= minx;
      L->tiles[k].py -= miny;
    }
    /* std::sort is not stable; tiles at one position are a malformed slide */
    qsort(L->tiles, (size_t)L->ntiles, sizeof(MiraxTile), by_position);
  }
  const int64_t w0 = maxx - minx, h0 = maxy - miny;
  s->nlevels = m->nzoom;
  s->levels = calloc((unsigned)m->nzoom, sizeof(SlideLevel));
  if (s->levels == NULL) {
    *status = tpuwsi_fail(err, errlen, "no memory");
    mirax_close(s);
    return NULL;
  }
  for (int z = 0; z < s->nlevels; ++z) {
    const int64_t ds = (int64_t)1 << z;
    s->levels[z] = (SlideLevel){(w0 + ds - 1) / ds, (h0 + ds - 1) / ds, (double)ds};
  }
  return s;
}
