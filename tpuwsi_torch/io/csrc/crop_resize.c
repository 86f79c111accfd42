/* Crop and resize a batch of tiles for the slide walker and the tile
 * sampler: host code, built with the system's C compiler by
 * tpuwsi_torch/io/image.py and called through ctypes, which releases the
 * interpreter lock for the whole call.
 *
 * Tile i is cut from its own source image srcs[i] (height x width x 3 uint8,
 * rows of width * 3 bytes): box[i] = (row, col, rows, cols, region) copies
 * the rows x cols block at (row, col) to the top left of a region x region
 * tile of zeros, which is then resized to out_size x out_size with PIL's
 * default Image.resize filter (Resample.c): the bicubic kernel with
 * a = -0.5, antialiased when shrinking, coefficients normalised to 22-bit
 * fixed point, a horizontal pass rounded to uint8, then a vertical pass. A
 * region of out_size is copied as it is. Both passes are computed as sums of
 * whole rows (the horizontal one on the tile's transpose), so that the inner
 * loops run over contiguous bytes; integer sums, so the order of the terms
 * does not change the bytes. Those loops are compiled for AVX2 and SSE4.1 as
 * well (GCC's target_clones), the CPU choosing at load time. The tiles are shared out among `threads`
 * pthreads; the output is the same for any number of them.
 *
 * tpuwsi_resize_bilinear: one image (h x w x 3) -> out (size x size x 3), the
 *                     same arithmetic in plain loops with PIL's bilinear
 *                     (triangle) kernel (a TMA core, once a slide); returns
 *                     0, or 1 with a message in err.
 * tpuwsi_crop_resize: n tiles -> out (n, out_size, out_size, 3); returns 0,
 *                     or 1 with a message in err.
 */
#include <math.h>
#include <pthread.h>
#include <stdarg.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define PRECISION_BITS (32 - 8 - 2)

static double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

static double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

typedef struct {
  double (*fn)(double);
  double support;
} Filter;

static const Filter kBicubic = {bicubic_filter, 2.0}, kBilinear = {bilinear_filter, 1.0};

/* One axis's taps: first input index, tap count and int coefficients per
 * output pixel (PIL's precompute_coeffs and normalize_coeffs_8bpc). */
typedef struct {
  int in_size, out_size, ksize;
  int *first, *count;
  int32_t *k;
} Coeffs;

static void coeffs_free(Coeffs *c) {
  free(c->first);
  free(c->count);
  free(c->k);
  memset(c, 0, sizeof *c);
}

static int coeffs_make(Coeffs *c, const Filter *f, int in_size, int out_size) {
  double scale = (double)in_size / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = f->support * filterscale;
  int ksize = (int)ceil(support) * 2 + 1;
  double *w = malloc(sizeof(double) * ksize);
  c->in_size = in_size;
  c->out_size = out_size;
  c->ksize = ksize;
  c->first = malloc(sizeof(int) * out_size);
  c->count = malloc(sizeof(int) * out_size);
  c->k = malloc(sizeof(int32_t) * (size_t)out_size * ksize);
  if (!w || !c->first || !c->count || !c->k) {
    free(w);
    coeffs_free(c);
    return 1;
  }
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    int xmax = (int)(center + support + 0.5);
    if (xmin < 0) xmin = 0;
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      w[x] = f->fn((x + xmin - center + 0.5) * ss);
      ww += w[x];
    }
    int32_t *k = c->k + (size_t)xx * ksize;
    for (int x = 0; x < ksize; ++x) {
      double v = x < xmax ? (ww != 0.0 ? w[x] / ww : w[x]) : 0.0;
      k[x] = v < 0 ? (int32_t)(-0.5 + v * (1 << PRECISION_BITS))
                   : (int32_t)(0.5 + v * (1 << PRECISION_BITS));
    }
    c->first[xx] = xmin;
    c->count[xx] = xmax;
  }
  free(w);
  return 0;
}

static inline uint8_t clip8(int32_t in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PRECISION_BITS);
}

typedef struct {
  int n, out_size, status;
  const uint8_t *const *srcs;
  const int64_t *widths;
  const int32_t *boxes;
  uint8_t *out;
  int next; /* the next tile to take, shared by the threads */
  pthread_mutex_t lock;
} Job;

static int take_tile(Job *job) {
  pthread_mutex_lock(&job->lock);
  int i = job->status ? job->n : job->next++;
  pthread_mutex_unlock(&job->lock);
  return i;
}

static void fail(Job *job) {
  pthread_mutex_lock(&job->lock);
  job->status = 1;
  pthread_mutex_unlock(&job->lock);
}

/* acc[0..len) = 2^21 + sum_j k[j] * rows[first + j][0..len): the rows of
 * one output line, every tap a whole row, so the inner loop runs over
 * contiguous bytes (32-bit sums, as PIL's: |coefficients| sum to under 2^23). */
__attribute__((target_clones("avx2", "sse4.1", "default")))
static void taps_to_line(const uint8_t *rows, size_t row_len, const Coeffs *c, int o,
                         int32_t *acc, uint8_t *line) {
  const int32_t *k = c->k + (size_t)o * c->ksize;
  const uint8_t *in = rows + (size_t)c->first[o] * row_len;
  for (size_t i = 0; i < row_len; ++i) acc[i] = 1 << (PRECISION_BITS - 1);
  for (int j = 0; j < c->count[o]; ++j) {
    const uint8_t *r = in + (size_t)j * row_len;
    const int32_t kj = k[j];
    for (size_t i = 0; i < row_len; ++i) acc[i] += r[i] * kj;
  }
  for (size_t i = 0; i < row_len; ++i) line[i] = clip8(acc[i]);
}

static void *worker(void *arg) {
  Job *job = arg;
  const int out_size = job->out_size;
  const size_t out_bytes = (size_t)out_size * out_size * 3;
  /* per thread: the tile transposed (x, y), the horizontal pass's result
   * transposed (xx, y) and as rows (y, xx), one line of sums */
  uint8_t *tile_t = NULL, *mid_t = NULL, *mid = NULL;
  int32_t *acc = NULL;
  int cap = 0;
  Coeffs c = {0};
  for (int i; (i = take_tile(job)) < job->n;) {
    const int32_t *box = job->boxes + 5 * (size_t)i;
    const int row = box[0], col = box[1], rows = box[2], cols = box[3], size = box[4];
    const size_t stride = (size_t)job->widths[i] * 3;
    const uint8_t *src = job->srcs[i] + (size_t)row * stride + (size_t)col * 3;
    uint8_t *dst = job->out + out_bytes * i;
    if (size == out_size) { /* a crop: the block at the top left of zeros */
      memset(dst, 0, out_bytes);
      for (int r = 0; r < rows; ++r)
        memcpy(dst + (size_t)r * size * 3, src + (size_t)r * stride, (size_t)cols * 3);
      continue;
    }
    if (size > cap) {
      int line = size > out_size ? size : out_size;
      free(tile_t);
      free(mid_t);
      free(mid);
      free(acc);
      tile_t = malloc((size_t)size * size * 3);
      mid_t = malloc((size_t)size * out_size * 3);
      mid = malloc((size_t)size * out_size * 3);
      acc = malloc(sizeof(int32_t) * (size_t)line * 3);
      cap = size;
      if (!tile_t || !mid_t || !mid || !acc) {
        cap = 0;
        fail(job);
        break;
      }
    }
    if (c.in_size != size) {
      coeffs_free(&c);
      if (coeffs_make(&c, &kBicubic, size, out_size)) {
        fail(job);
        break;
      }
    }
    /* tile_t[x][y] = tile[y][x], zeros outside the block; in 16 x 16
     * blocks, so that the strided side stays in cache */
    if (rows < size || cols < size) memset(tile_t, 0, (size_t)size * size * 3);
    for (int y0 = 0; y0 < rows; y0 += 16)
      for (int x0 = 0; x0 < cols; x0 += 16)
        for (int x = x0; x < x0 + 16 && x < cols; ++x) {
          uint8_t *t = tile_t + ((size_t)x * size + y0) * 3;
          const uint8_t *s = src + (size_t)y0 * stride + (size_t)x * 3;
          for (int y = y0; y < y0 + 16 && y < rows; ++y, t += 3, s += stride) {
            t[0] = s[0];
            t[1] = s[1];
            t[2] = s[2];
          }
        }
    /* horizontal pass, on the transpose: output column xx from input columns */
    for (int xx = 0; xx < out_size; ++xx)
      taps_to_line(tile_t, (size_t)size * 3, &c, xx, acc, mid_t + (size_t)xx * size * 3);
    /* mid[y][xx] = mid_t[xx][y], in 16 x 16 blocks */
    for (int y0 = 0; y0 < size; y0 += 16)
      for (int x0 = 0; x0 < out_size; x0 += 16)
        for (int y = y0; y < y0 + 16 && y < size; ++y) {
          uint8_t *q = mid + ((size_t)y * out_size + x0) * 3;
          const uint8_t *m = mid_t + ((size_t)x0 * size + y) * 3;
          for (int xx = x0; xx < x0 + 16 && xx < out_size; ++xx, q += 3, m += (size_t)size * 3) {
            q[0] = m[0];
            q[1] = m[1];
            q[2] = m[2];
          }
        }
    /* vertical pass: output row yy from input rows */
    for (int yy = 0; yy < out_size; ++yy)
      taps_to_line(mid, (size_t)out_size * 3, &c, yy, acc, dst + (size_t)yy * out_size * 3);
  }
  coeffs_free(&c);
  free(tile_t);
  free(mid_t);
  free(mid);
  free(acc);
  return NULL;
}

int tpuwsi_crop_resize(int n, const uint8_t *const *srcs, const int64_t *widths,
                       const int32_t *boxes, int out_size, uint8_t *out, int threads, char *err,
                       size_t errlen) {
  Job job = {.n = n, .out_size = out_size, .srcs = srcs, .widths = widths, .boxes = boxes,
             .out = out};
  pthread_mutex_init(&job.lock, NULL);
  if (threads > n) threads = n;
  if (threads < 1) threads = 1;
  pthread_t *ids = malloc(sizeof(pthread_t) * threads);
  int started = 0;
  if (ids)
    for (; started < threads - 1; ++started)
      if (pthread_create(&ids[started], NULL, worker, &job)) break;
  worker(&job); /* the calling thread takes tiles too */
  for (int t = 0; t < started; ++t) pthread_join(ids[t], NULL);
  free(ids);
  pthread_mutex_destroy(&job.lock);
  if (job.status) {
    snprintf(err, errlen, "out of memory resizing %d tiles to %d px", n, out_size);
    return 1;
  }
  return 0;
}

int tpuwsi_resize_bilinear(const uint8_t *src, int h, int w, int size, uint8_t *out,
                           char *err, size_t errlen) {
  const int out_h = size, out_w = size;
  Coeffs cx = {0}, cy = {0};
  uint8_t *mid = malloc((size_t)h * out_w * 3 + 1);
  int fail_mem = mid == NULL || coeffs_make(&cx, &kBilinear, w, out_w) ||
                 coeffs_make(&cy, &kBilinear, h, out_h);
  if (!fail_mem) {
    /* horizontal pass (PIL's ImagingResampleHorizontal_8bpc), then vertical */
    for (int y = 0; y < h; ++y)
      for (int xx = 0; xx < out_w; ++xx) {
        const int32_t *k = cx.k + (size_t)xx * cx.ksize;
        const uint8_t *in = src + ((size_t)y * w + cx.first[xx]) * 3;
        for (int ch = 0; ch < 3; ++ch) {
          int32_t acc = 1 << (PRECISION_BITS - 1);
          for (int j = 0; j < cx.count[xx]; ++j) acc += in[3 * j + ch] * k[j];
          mid[((size_t)y * out_w + xx) * 3 + ch] = clip8(acc);
        }
      }
    for (int yy = 0; yy < out_h; ++yy) {
      const int32_t *k = cy.k + (size_t)yy * cy.ksize;
      for (size_t i = 0; i < (size_t)out_w * 3; ++i) {
        int32_t acc = 1 << (PRECISION_BITS - 1);
        for (int j = 0; j < cy.count[yy]; ++j)
          acc += mid[((size_t)(cy.first[yy] + j) * out_w) * 3 + i] * k[j];
        out[(size_t)yy * out_w * 3 + i] = clip8(acc);
      }
    }
  }
  coeffs_free(&cx);
  coeffs_free(&cy);
  free(mid);
  if (fail_mem) {
    snprintf(err, errlen, "out of memory resizing %d x %d to %d x %d", w, h, out_w, out_h);
    return 1;
  }
  return 0;
}
