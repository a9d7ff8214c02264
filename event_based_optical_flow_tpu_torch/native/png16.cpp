// PNG scanline defilter (RFC 2083 §6) for the self-contained 16-bit
// RGB decoder in flow/io.py (PIL silently truncates 16-bit RGB to 8 bits).
//
// The plain version, flow/io.py's _defilter, runs Average and Paeth rows
// byte by byte in Python, which costs seconds per real DSEC GT frame
// (~1.8M branchy iterations at 640x480).  The defilter is a strictly
// sequential byte recurrence (left + up neighbors), so it belongs in
// native code like the EVT decoders; the two give the same bytes
// (tests/test_torch_native.py).
//
// Input: `raw` = the zlib-inflated IDAT payload, h scanlines of
// (1 filter-type byte + stride image bytes).  Output: `out` = h*stride
// reconstructed bytes.  Returns 0 on success, -1 on a bad filter type
// or bad arguments.

#include <cstdint>
#include <cstdlib>

extern "C" int64_t evf_png_defilter(
    const uint8_t* raw, int64_t raw_len,
    int64_t h, int64_t stride, int64_t bpp,
    uint8_t* out) {
  if (h < 0 || stride <= 0 || bpp <= 0 || bpp > stride) return -1;
  if (raw_len != h * (stride + 1)) return -1;
  for (int64_t i = 0; i < h; ++i) {
    const uint8_t ftype = raw[i * (stride + 1)];
    const uint8_t* line = raw + i * (stride + 1) + 1;
    const uint8_t* prev = i > 0 ? out + (i - 1) * stride : nullptr;
    uint8_t* cur = out + i * stride;
    switch (ftype) {
      case 0:  // None
        for (int64_t j = 0; j < stride; ++j) cur[j] = line[j];
        break;
      case 1:  // Sub
        for (int64_t j = 0; j < stride; ++j) {
          const uint8_t a = j >= bpp ? cur[j - bpp] : 0;
          cur[j] = static_cast<uint8_t>(line[j] + a);
        }
        break;
      case 2:  // Up
        if (prev) {
          for (int64_t j = 0; j < stride; ++j)
            cur[j] = static_cast<uint8_t>(line[j] + prev[j]);
        } else {
          for (int64_t j = 0; j < stride; ++j) cur[j] = line[j];
        }
        break;
      case 3:  // Average
        for (int64_t j = 0; j < stride; ++j) {
          const int a = j >= bpp ? cur[j - bpp] : 0;
          const int b = prev ? prev[j] : 0;
          cur[j] = static_cast<uint8_t>(line[j] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t j = 0; j < stride; ++j) {
          const int a = j >= bpp ? cur[j - bpp] : 0;
          const int b = prev ? prev[j] : 0;
          const int c = (prev && j >= bpp) ? prev[j - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a);
          const int pb = std::abs(p - b);
          const int pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[j] = static_cast<uint8_t>(line[j] + pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}
