// Medial-axis thinning inner loop.
//
// Visits foreground pixels in a precomputed order (increasing distance,
// then cornerness, then tiebreak) and removes each unless the removal
// lookup table says the pixel must be kept (removal would change local
// 8-connectivity, or the pixel has < 3 neighbours).
//
// The loop is inherently sequential — each removal changes the
// neighbourhoods consulted by later visits — which is why it lives in
// native code rather than numpy. The port's copy of native/skeletonize.cpp,
// called via ctypes from imagecfgen_torch/morphomnist/_skeletonize.py.

#include <cstdint>

extern "C" void skeletonize_loop(
    uint8_t* img, int32_t h, int32_t w,
    const int32_t* ii, const int32_t* jj,
    const int32_t* order, int32_t n,
    const uint8_t* keep_table)
{
    for (int32_t t = 0; t < n; ++t) {
        const int32_t o = order[t];
        const int32_t i = ii[o];
        const int32_t j = jj[o];
        int32_t index = 0;
        int32_t bit = 0;
        for (int32_t di = -1; di <= 1; ++di) {
            for (int32_t dj = -1; dj <= 1; ++dj) {
                const int32_t y = i + di;
                const int32_t x = j + dj;
                if (y >= 0 && y < h && x >= 0 && x < w && img[y * w + x]) {
                    index |= 1 << bit;
                }
                ++bit;
            }
        }
        if (!keep_table[index]) {
            img[i * w + j] = 0;
        }
    }
}
