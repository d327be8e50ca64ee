// PNG row unfiltering on the host (the inverse of the five PNG row filters,
// ISO/IEC 15948 section 9): the compiled counterpart of the Python loop
// ``utils/png._unfilter_plain``, which the tests hold it to. Built with the
// host C++ compiler at first use (``ops/cuda_build.load_host``).
//
// fnx_png_unfilter(in, out, h, rowbytes, bpp)
//   in:  h rows of 1 filter-type byte + rowbytes bytes
//   out: h rows of rowbytes unfiltered bytes
//   bpp: bytes per complete pixel, at least 1
// Returns 0, or -(y + 1) for the first row y with a filter type over 4.
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" int fnx_png_unfilter(const uint8_t* in, uint8_t* out, int h, int rowbytes, int bpp) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = in + (size_t)y * (rowbytes + 1);
    const int ftype = line[0];
    ++line;
    uint8_t* cur = out + (size_t)y * rowbytes;
    switch (ftype) {
      case 0:
        std::memcpy(cur, line, rowbytes);
        break;
      case 1:  // sub
        for (int x = 0; x < rowbytes; ++x)
          cur[x] = (uint8_t)(line[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:  // up
        for (int x = 0; x < rowbytes; ++x)
          cur[x] = (uint8_t)(line[x] + (prev ? prev[x] : 0));
        break;
      case 3:  // average
        for (int x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          cur[x] = (uint8_t)(line[x] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = (uint8_t)(line[x] + pred);
        }
        break;
      default:
        return -(y + 1);
    }
    prev = cur;
  }
  return 0;
}
