/* PNG decoding for the image-folder data loop and MIRAX's PNG tiles: host
 * code, built with the system's C compiler by tpuwsi_torch/io/image.py
 * together with the other codecs (codecs.h) and called through ctypes, which
 * releases the interpreter lock for the whole call.
 *
 * Takes bit depth 8, no interlacing, colour types gray, gray + alpha, RGB,
 * RGBA and palette, and gives RGB or L as PIL's Image.convert does (alpha
 * dropped, no compositing; L from RGB by ITU-R 601-2 luma with PIL's integer
 * rounding; palette indices past the palette's end read as black). Anything
 * else fails with a message. zlib does the inflating and the CRCs.
 *
 * tpuwsi_png_decode:   one file's bytes → out (height, width, channels)
 * tpuwsi_decode_files: n PNG or JPEG files (told apart by their first bytes),
 *                      all of one size, read and decoded on `threads`
 *                      threads → out (n, height, width, channels)
 */
#include <errno.h>
#include <pthread.h>
#include <stdarg.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "codecs.h"

static const char *colour_name(int colour) {
  switch (colour) {
    case 0: return "gray";
    case 2: return "RGB";
    case 3: return "palette";
    case 4: return "gray+alpha";
    case 6: return "RGBA";
  }
  return "?";
}

static uint32_t be32(const uint8_t *p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  return (uint8_t)(pa <= pb && pa <= pc ? a : (pb <= pc ? b : c));
}

/* Undo the scanline filters (PNG specification, section 9): raw holds height
 * rows of a filter-type byte and stride bytes; px gets height rows of stride
 * bytes. Returns 0, or 1 + the first row whose filter type is unknown. */
static int unfilter(const uint8_t *raw, uint8_t *px, const uint8_t *zeros, int height,
                    int stride, int bpp) {
  for (int r = 0; r < height; ++r) {
    const uint8_t *in = raw + (size_t)r * (stride + 1) + 1;
    uint8_t *cur = px + (size_t)r * stride;
    const uint8_t *up = r ? cur - stride : zeros;
    int i;
    switch (in[-1]) {
      case 0: /* None */
        memcpy(cur, in, (size_t)stride);
        break;
      case 1: /* Sub */
        for (i = 0; i < bpp; ++i) cur[i] = in[i];
        for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
        break;
      case 2: /* Up */
        for (i = 0; i < stride; ++i) cur[i] = (uint8_t)(in[i] + up[i]);
        break;
      case 3: /* Average */
        for (i = 0; i < bpp; ++i) cur[i] = (uint8_t)(in[i] + (up[i] >> 1));
        for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + ((cur[i - bpp] + up[i]) >> 1));
        break;
      case 4: /* Paeth: no left neighbour at the start, so the byte above */
        for (i = 0; i < bpp; ++i) cur[i] = (uint8_t)(in[i] + up[i]);
        for (; i < stride; ++i)
          cur[i] = (uint8_t)(in[i] + paeth(cur[i - bpp], up[i], up[i - bpp]));
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

static inline uint8_t luma(const uint8_t *rgb) {
  return (uint8_t)((rgb[0] * 19595u + rgb[1] * 38470u + rgb[2] * 7471u + 0x8000u) >> 16);
}

/* pixels of the file's colour type → RGB (channels 3) or L (channels 1) */
static void convert(const uint8_t *px, uint8_t *out, size_t n, int colour, int bpp,
                    const uint8_t *palette, int channels) {
  for (size_t i = 0; i < n; ++i, px += bpp, out += channels) {
    const uint8_t *rgb = colour == 3 ? palette + 3 * px[0] : px;
    if (colour == 0 || colour == 4) {
      out[0] = px[0];
      if (channels == 3) out[1] = out[2] = px[0];
    } else if (channels == 3) {
      out[0] = rgb[0], out[1] = rgb[1], out[2] = rgb[2];
    } else {
      out[0] = luma(rgb);
    }
  }
}

int tpuwsi_png_decode(const uint8_t *data, size_t len, int channels, uint8_t *out, int want_h,
                      int want_w, char *err, size_t errlen) {
  static const uint8_t signature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len < 8 || memcmp(data, signature, 8) != 0)
    return tpuwsi_fail(err, errlen, "not a PNG file (bad signature)");
  uint8_t palette[256 * 3] = {0};
  int have_header = 0, have_palette = 0, have_end = 0;
  uint32_t width = 0, height = 0;
  int depth = 0, colour = 0, compression = 0, filter_method = 0, interlace = 0;
  uint8_t *idat = NULL;
  size_t idat_len = 0, pos = 8;
  while (pos + 8 <= len) {
    uint32_t length = be32(data + pos);
    const uint8_t *kind = data + pos + 4, *body = data + pos + 8;
    if (length > len - pos - 8 || len - pos - 8 - length < 4) {
      free(idat);
      return tpuwsi_fail(err, errlen, "truncated '%.4s' chunk", (const char *)kind);
    }
    if (crc32(crc32(0, kind, 4), body, length) != be32(body + length)) {
      free(idat);
      return tpuwsi_fail(err, errlen, "CRC mismatch in the %.4s chunk", (const char *)kind);
    }
    if (!memcmp(kind, "IHDR", 4) && length == 13) {
      width = be32(body), height = be32(body + 4);
      depth = body[8], colour = body[9], compression = body[10];
      filter_method = body[11], interlace = body[12];
      have_header = 1;
    } else if (!memcmp(kind, "PLTE", 4)) {
      memcpy(palette, body, length < sizeof palette ? length : sizeof palette);
      have_palette = 1;
    } else if (!memcmp(kind, "IDAT", 4)) {
      uint8_t *grown = realloc(idat, idat_len + length + 1);
      if (grown == NULL) {
        free(idat);
        return tpuwsi_fail(err, errlen, "no memory for the image data");
      }
      idat = grown;
      memcpy(idat + idat_len, body, length);
      idat_len += length;
    } else if (!memcmp(kind, "IEND", 4)) {
      have_end = 1;
      break;
    }
    pos += 12 + (size_t)length;
  }
  int status = kOk;
  int bpp = colour == 0 || colour == 3 ? 1 : colour == 4 ? 2 : colour == 2 ? 3 : 4;
  if (!have_end)
    status = tpuwsi_fail(err, errlen, "no IEND chunk");
  else if (!have_header)
    status = tpuwsi_fail(err, errlen, "no IHDR chunk");
  else if (colour != 0 && colour != 2 && colour != 3 && colour != 4 && colour != 6)
    status = tpuwsi_fail(err, errlen, "unknown colour type %d", colour);
  else if (depth != 8)
    status = tpuwsi_fail(err, errlen, "bit depth %d (%s) is not supported; this decoder takes 8-bit "
                  "samples only", depth, colour_name(colour));
  else if (interlace)
    status = tpuwsi_fail(err, errlen, "Adam7 interlacing is not supported; this decoder takes "
                  "non-interlaced files only");
  else if (compression || filter_method)
    status = tpuwsi_fail(err, errlen, "unknown compression or filter method");
  else if (colour == 3 && !have_palette)
    status = tpuwsi_fail(err, errlen, "palette image without a PLTE chunk");
  else if ((int64_t)height != want_h || (int64_t)width != want_w)
    status = tpuwsi_fail(err, errlen, "%u x %u pixels, not the %d x %d of the others", width, height,
                  want_w, want_h);
  if (status != kOk) {
    free(idat);
    return status;
  }
  size_t stride = (size_t)width * bpp, raw_len = height * (stride + 1);
  uint8_t *raw = malloc(raw_len + 1), *px = malloc(height * stride + 1),
          *zeros = calloc(stride + 1, 1);
  unsigned long got = raw_len + 1; /* one spare byte: a longer stream shows */
  if (raw == NULL || px == NULL || zeros == NULL) {
    status = tpuwsi_fail(err, errlen, "no memory for %u x %u pixels", width, height);
  } else {
    int z = uncompress(raw, &got, idat ? idat : zeros, idat_len);
    if (z != 0 && !(z == -5 && got == raw_len + 1)) /* Z_BUF_ERROR: too long or cut */
      status = tpuwsi_fail(err, errlen, "damaged image data (zlib error %d)", z);
    else if (got != raw_len)
      status = tpuwsi_fail(err, errlen, "image data holds %s%lu bytes, expected %zu",
                    got > raw_len ? "more than " : "", got > raw_len ? raw_len : got, raw_len);
    else {
      int bad = unfilter(raw, px, zeros, (int)height, (int)stride, bpp);
      if (bad)
        status = tpuwsi_fail(err, errlen, "unknown scanline filter type %d",
                      raw[(size_t)(bad - 1) * (stride + 1)]);
      else
        convert(px, out, (size_t)width * height, colour, bpp, palette, channels);
    }
  }
  free(idat), free(raw), free(px), free(zeros);
  return status;
}

struct files_job {
  const char *const *paths;
  int n, channels, height, width;
  uint8_t *out;
  int next;       /* the next file to take, atomically */
  int *status;    /* per file */
  char *messages; /* per file, kMessage bytes each */
};
enum { kMessage = 512 };

static void *decode_files_worker(void *arg) {
  struct files_job *job = arg;
  size_t per_file = (size_t)job->height * job->width * job->channels;
  for (;;) {
    int i = __atomic_fetch_add(&job->next, 1, __ATOMIC_RELAXED);
    if (i >= job->n) return NULL;
    char *msg = job->messages + (size_t)i * kMessage;
    FILE *f = fopen(job->paths[i], "rb");
    uint8_t *data = NULL;
    long len = -1;
    if (f != NULL && fseek(f, 0, SEEK_END) == 0 && (len = ftell(f)) >= 0 &&
        fseek(f, 0, SEEK_SET) == 0 && (data = malloc((size_t)len + 1)) != NULL &&
        fread(data, 1, (size_t)len, f) == (size_t)len) {
      int jpeg = len >= 2 && data[0] == 0xFF && data[1] == 0xD8;
      job->status[i] = (jpeg ? tpuwsi_jpeg_decode : tpuwsi_png_decode)(
          data, (size_t)len, job->channels, job->out + per_file * i, job->height, job->width,
          msg, kMessage);
    } else {
      job->status[i] = kOsError;
      snprintf(msg, kMessage, "%d", errno ? errno : EIO);
    }
    free(data);
    if (f != NULL) fclose(f);
  }
}

/* Returns -1, or the index of the first file that failed, with kFormatError or
 * kOsError in *status and its message (for kOsError the errno) in err. */
int tpuwsi_decode_files(const char *const *paths, int n, int channels, uint8_t *out,
                            int height, int width, int threads, int *status, char *err,
                            size_t errlen) {
  struct files_job job = {paths, n, channels, height, width, out, 0, NULL, NULL};
  job.status = calloc((size_t)n + 1, sizeof(int));
  job.messages = calloc((size_t)n + 1, kMessage);
  if (job.status == NULL || job.messages == NULL) {
    free(job.status), free(job.messages);
    *status = kOsError;
    snprintf(err, errlen, "%d", ENOMEM);
    return 0;
  }
  if (threads > n) threads = n;
  pthread_t pool[64];
  int started = 0;
  for (; started < threads - 1 && started < 64; ++started)
    if (pthread_create(&pool[started], NULL, decode_files_worker, &job) != 0) break;
  decode_files_worker(&job); /* the calling thread is one of them */
  for (int t = 0; t < started; ++t) pthread_join(pool[t], NULL);
  int first = -1;
  for (int i = 0; i < n && first < 0; ++i)
    if (job.status[i] != kOk) {
      first = i;
      *status = job.status[i];
      snprintf(err, errlen, "%s", job.messages + (size_t)i * kMessage);
    }
  free(job.status), free(job.messages);
  return first;
}
