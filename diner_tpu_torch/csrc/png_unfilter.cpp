// PNG row defilter, the host half of diner_tpu_torch/image_ops/png.py.
//
// The dataset readers decode several 16-bit depth and confidence PNGs per
// sample, and encoders such as libpng's filter most of their rows with
// Paeth or Average, whose every byte depends on the byte to its left. Python
// inflates the rows with zlib; this undoes the five row filters of the PNG
// specification in one pass. It is called through ctypes, which releases
// the interpreter lock, so the loader's threads decode side by side.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// the neighbour nearest p = a + b - c; ties go to a, then b
inline int paeth(int a, int b, int c) {
    int pa = b > c ? b - c : c - b;   // |p - a|
    int pb = a > c ? a - c : c - a;   // |p - b|
    int pc = a + b - 2 * c;           // p - c
    pc = pc < 0 ? -pc : pc;
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

}  // namespace

// raw: h rows of 1 + stride bytes (the row's filter type, then its filtered
// bytes); out: h rows of stride bytes. bpp is the filters' left distance,
// the bytes of one pixel. Returns 0, or 1 + the first row whose filter type
// is unknown.
extern "C" int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride,
                                int64_t bpp, uint8_t* out) {
    const std::vector<uint8_t> zeros(stride, 0);   // the row above row 0
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* src = raw + y * (stride + 1) + 1;
        const uint8_t* up = y ? out + (y - 1) * stride : zeros.data();
        uint8_t* cur = out + y * stride;
        const int64_t first = bpp < stride ? bpp : stride;  // no left pixel
        switch (src[-1]) {
            case 0:   // None
                memcpy(cur, src, stride);
                break;
            case 1:   // Sub
                memcpy(cur, src, first);
                for (int64_t i = first; i < stride; ++i)
                    cur[i] = uint8_t(src[i] + cur[i - bpp]);
                break;
            case 2:   // Up
                for (int64_t i = 0; i < stride; ++i)
                    cur[i] = uint8_t(src[i] + up[i]);
                break;
            case 3:   // Average
                for (int64_t i = 0; i < first; ++i)
                    cur[i] = uint8_t(src[i] + (up[i] >> 1));
                for (int64_t i = first; i < stride; ++i)
                    cur[i] = uint8_t(src[i] + ((cur[i - bpp] + up[i]) >> 1));
                break;
            case 4:   // Paeth: with no left pixel the predictor is b
                for (int64_t i = 0; i < first; ++i)
                    cur[i] = uint8_t(src[i] + up[i]);
                for (int64_t i = first; i < stride; ++i)
                    cur[i] = uint8_t(src[i] + paeth(cur[i - bpp], up[i],
                                                    up[i - bpp]));
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}
