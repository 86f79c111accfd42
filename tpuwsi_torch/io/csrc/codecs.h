/* The slide codecs' shared declarations: jpeg_decode.c, png_decode.c,
 * tiff_read.c and mirax_read.c are built together into one library by
 * tpuwsi_torch/io/image.py and called through ctypes.
 *
 * Every entry point returns kOk, or another status with a message in err. */
#pragma once
#include <stddef.h>
#include <stdint.h>

enum {
  kOk = 0,
  kFormatError = 1,   /* a file this package does not take, or a damaged one */
  kOsError = 2,       /* a file that could not be read: err holds its errno */
  kNotImplemented = 3 /* a known format left for later (JPEG 2000: M1c) */
};

/* How a JPEG's components become RGB. */
enum {
  kJpegColorAuto = 0,    /* libjpeg's defaults: JFIF or Adobe markers, else the component ids */
  kJpegColorYCbCr = 1,   /* YCbCr whatever the markers say (libtiff's JPEGCOLORMODE_RGB) */
  kJpegColorAsCoded = 2  /* no colour transform (TIFF photometric RGB) */
};

int tpuwsi_fail(char *err, size_t errlen, const char *fmt, ...)
    __attribute__((format(printf, 3, 4)));

/* (height, width, components) of a JPEG frame */
int tpuwsi_jpeg_size(const uint8_t *data, size_t len, int *height, int *width, int *components,
                     char *err, size_t errlen);
/* A baseline JPEG → out (height, width, channels), channels 3 (RGB) or 1 (L);
 * `tables` (or NULL) is an abbreviated table stream read first (TIFF's
 * JPEGTables). want_h/want_w must be the frame's size. */
int tpuwsi_jpeg_decode_ex(const uint8_t *data, size_t len, const uint8_t *tables,
                          size_t tables_len, int color, int channels, uint8_t *out, int want_h,
                          int want_w, char *err, size_t errlen);
int tpuwsi_jpeg_decode(const uint8_t *data, size_t len, int channels, uint8_t *out, int want_h,
                       int want_w, char *err, size_t errlen);
int tpuwsi_png_decode(const uint8_t *data, size_t len, int channels, uint8_t *out, int want_h,
                      int want_w, char *err, size_t errlen);

/* zlib (zlib.h: uLong = unsigned long, uInt = unsigned int, Bytef = unsigned char),
 * linked by its soname, so that no zlib header is needed */
extern int uncompress(unsigned char *dest, unsigned long *dest_len, const unsigned char *source,
                      unsigned long source_len);
extern unsigned long crc32(unsigned long crc, const unsigned char *buf, unsigned int len);

/* ---- slides (tiff_read.c: the slide layer and the TIFF container; mirax_read.c) ---- */

typedef struct Slide Slide;
typedef struct {
  int64_t width, height;
  double downsample;
} SlideLevel;

struct Slide {
  int nlevels;
  SlideLevel *levels;
  /* rect (x0, y0, w, h) in the level's pixels → out, RGB, zeros outside the level */
  int (*read_rect)(Slide *s, int level, int64_t x0, int64_t y0, int64_t w, int64_t h,
                   uint8_t *out, char *err, size_t errlen);
  void (*close)(Slide *s);
  void *impl;
};

/* n bytes at off of fd (pread until done); -1 if the file ends or fails first */
int tpuwsi_pread_all(int fd, void *buf, size_t n, uint64_t off);
/* ".mrxs": the stub file; the data are in the directory beside it, named after it */
Slide *mirax_open(const char *path, int *status, char *err, size_t errlen);
