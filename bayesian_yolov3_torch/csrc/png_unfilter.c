/* Undo the five PNG row filters (None, Sub, Up, Average, Paeth) of one
 * non-interlaced image or one Adam7 pass: a host-only helper of
 * data/pipeline.py, built by ops/_build.py with the host C compiler and
 * loaded with ctypes (which releases the GIL for the call, so the loader's
 * threads decode in parallel).
 *
 * raw: rows x (1 + rowbytes) bytes, each row its filter type then its data;
 * out: rows x rowbytes bytes.  bpp is the filter's byte distance: the bytes
 * of one pixel, at least 1 (PNG spec section 9).  Returns 0, 1 + the
 * index of the first row whose filter type is not 0..4, or -1 for a bpp
 * no PNG format has.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#if defined(__SSE2__)
#include <emmintrin.h> /* Up: 16 bytes an addition */
#endif

static inline int paeth(int a, int b, int c) {
  const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  const int bc = pb <= pc ? b : c;
  return (pa <= pb && pa <= pc) ? a : bc;
}

/* One row of Sub (1), Average (3) or Paeth (4).  ftype, bpp and whether a
 * row lies above are constants after inlining: the left neighbours a and c
 * of each byte lane stay in registers, so the loop-carried chain passes
 * through no store and reload, and the loop holds no branch on the filter.
 * Without a row above, b = c = 0.  rowbytes is a multiple of bpp for every
 * PNG format. */
static inline __attribute__((always_inline)) void unfilter_row(
    const int ftype, const uint8_t *in, const uint8_t *up, uint8_t *cur,
    int64_t rowbytes, const int bpp, const int has_up) {
  int a[8] = {0, 0, 0, 0, 0, 0, 0, 0}, c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int64_t i = 0; i < rowbytes; i += bpp) {
#pragma GCC unroll 8
    for (int k = 0; k < bpp; ++k) {
      const int b = has_up ? up[i + k] : 0;
      int pred;
      if (ftype == 1)
        pred = a[k];
      else if (ftype == 3)
        pred = (a[k] + b) >> 1;
      else
        pred = paeth(a[k], b, c[k]);
      const int v = (in[i + k] + pred) & 0xFF;
      cur[i + k] = (uint8_t)v;
      a[k] = v;
      c[k] = b;
    }
  }
}

#define BY_BPP(F, U)                                              \
  switch (bpp) {                                                  \
    case 1: unfilter_row(F, in, up, cur, rowbytes, 1, U); break;  \
    case 2: unfilter_row(F, in, up, cur, rowbytes, 2, U); break;  \
    case 3: unfilter_row(F, in, up, cur, rowbytes, 3, U); break;  \
    case 4: unfilter_row(F, in, up, cur, rowbytes, 4, U); break;  \
    case 6: unfilter_row(F, in, up, cur, rowbytes, 6, U); break;  \
    default: unfilter_row(F, in, up, cur, rowbytes, 8, U); break; \
  }

static void unfilter_sequential(int ftype, const uint8_t *in, const uint8_t *up,
                                uint8_t *cur, int64_t rowbytes, int bpp) {
  if (up) {
    if (ftype == 1) BY_BPP(1, 1) else if (ftype == 3) BY_BPP(3, 1) else BY_BPP(4, 1)
  } else {
    if (ftype == 1) BY_BPP(1, 0) else if (ftype == 3) BY_BPP(3, 0) else BY_BPP(4, 0)
  }
}

int png_unfilter(const uint8_t *raw, uint8_t *out, int64_t rows,
                 int64_t rowbytes, int bpp) {
  if (bpp < 1 || bpp > 8 || bpp == 5 || bpp == 7 || rowbytes % bpp) return -1;
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t ftype = raw[y * (rowbytes + 1)];
    const uint8_t *in = raw + y * (rowbytes + 1) + 1;
    uint8_t *cur = out + y * rowbytes;
    const uint8_t *up = y ? cur - rowbytes : NULL; /* NULL: the zero row */
    if (ftype == 0 || (ftype == 2 && !up)) {
      memcpy(cur, in, (size_t)rowbytes);
    } else if (ftype == 2) {
      int64_t i = 0;
#if defined(__SSE2__)
      for (; i + 16 <= rowbytes; i += 16)
        _mm_storeu_si128((__m128i *)(cur + i),
                         _mm_add_epi8(_mm_loadu_si128((const __m128i *)(in + i)),
                                      _mm_loadu_si128((const __m128i *)(up + i))));
#endif
      for (; i < rowbytes; ++i) cur[i] = (uint8_t)(in[i] + up[i]);
    } else if (ftype <= 4) {
      unfilter_sequential(ftype, in, up, cur, rowbytes, bpp);
    } else {
      return (int)(y + 1);
    }
  }
  return 0;
}
