// PNG scanline unfilter (PNG spec, section 9: filter method 0), host C++
// built with g++ by figdraw_tpu_torch/utils/png.py.
//
// src holds h filtered scanlines of 1 + stride bytes each (the filter type
// byte first); dst receives the h reconstructed rows of stride bytes. bpp
// is the filter unit: the bytes of one pixel, at least 1. Sub, Average and
// Paeth read the reconstructed byte bpp to the left and Up, Average and
// Paeth the reconstructed byte above (zero on the first row), so a row is
// sequential and each row needs the one above: the reason this runs as
// native code rather than numpy. Returns 0, or -1 - the row of the first
// unknown filter type (nothing past it is written).

#include <cstdint>
#include <cstdlib>

extern "C" {

int fd_png_unfilter(const uint8_t* src, uint8_t* dst, int h, int stride, int bpp) {
    const uint8_t* up = nullptr;
    for (int y = 0; y < h; ++y) {
        const uint8_t* in = src + (size_t)y * (stride + 1);
        uint8_t* out = dst + (size_t)y * stride;
        const int ft = in[0];
        ++in;
        switch (ft) {
        case 0:
            for (int i = 0; i < stride; ++i) out[i] = in[i];
            break;
        case 1:
            for (int i = 0; i < stride; ++i)
                out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
            break;
        case 2:
            for (int i = 0; i < stride; ++i)
                out[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
            break;
        case 3:
            for (int i = 0; i < stride; ++i) {
                const int a = i >= bpp ? out[i - bpp] : 0;
                const int b = up ? up[i] : 0;
                out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int i = 0; i < stride; ++i) {
                const int a = i >= bpp ? out[i - bpp] : 0;
                const int b = up ? up[i] : 0;
                const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                const int p = a + b - c;
                const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                out[i] = (uint8_t)(in[i] + pred);
            }
            break;
        default:
            return -1 - y;
        }
        up = out;
    }
    return 0;
}

}  // extern "C"
