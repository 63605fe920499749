// Batch morphometry engine: exact Euclidean distance transform
// (Felzenszwalb & Huttenlocher 2-pass parabola envelope), deterministic
// medial-axis thinning, and fused skeleton-metric reductions, threaded
// over the image batch with std::thread.
//
// The port's copy of native/morphometry.cpp. The reference measures with a
// multiprocessing.Pool over per-image Python work (its
// morphomnist/measure.py:119-122); here the whole per-image chain runs in
// native code and the batch fans out over hardware threads. Built with g++
// at first use by imagecfgen_torch/ops/_build.py::load_host_library.
//
// Determinism contract (shared with the python engine of
// imagecfgen_torch/morphomnist/_skeletonize.py::medial_axis):
// foreground pixels are removed in increasing order of
//   (squared distance to background, 9 - 3x3 neighbour count,
//    splitmix64(linear index))
// splitmix64 is a bijection on uint64, so the third key is unique and
// the order — hence the skeleton — is identical across the C++ and
// numpy implementations.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = 1e20;

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// 1-D squared distance transform (lower envelope of parabolas).
void dt1d(const double* f, int n, double* d, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; q++) {
    double s;
    while (true) {
      s = ((f[q] + q * (double)q) - (f[v[k]] + v[k] * (double)v[k])) /
          (2.0 * q - 2.0 * v[k]);
      if (s <= z[k]) {
        k--;
      } else {
        break;
      }
    }
    k++;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int q = 0; q < n; q++) {
    while (z[k + 1] < q) k++;
    double dq = q - (double)v[k];
    d[q] = dq * dq + f[v[k]];
  }
}

// Exact squared EDT of a binary image: distance from each foreground
// pixel to the nearest background pixel (0 on background) — matches
// scipy.ndimage.distance_transform_edt squared.
void edt_squared(const uint8_t* bin, int h, int w, double* out) {
  std::vector<double> f(std::max(h, w));
  std::vector<double> d(std::max(h, w));
  std::vector<int> v(std::max(h, w));
  std::vector<double> z(std::max(h, w) + 1);

  // columns
  for (int x = 0; x < w; x++) {
    for (int y = 0; y < h; y++) f[y] = bin[y * w + x] ? kInf : 0.0;
    dt1d(f.data(), h, d.data(), v.data(), z.data());
    for (int y = 0; y < h; y++) out[y * w + x] = d[y];
  }
  // rows
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) f[x] = out[y * w + x];
    dt1d(f.data(), w, d.data(), v.data(), z.data());
    for (int x = 0; x < w; x++) out[y * w + x] = d[x];
  }
}

struct PixKey {
  double d2;
  int32_t corner;
  uint64_t tiebreak;
  int32_t idx;  // linear index into the image
};

// Medial-axis thinning of one binary image. dist2 is its squared EDT.
// skel (h*w) holds the binary input on entry and the skeleton on exit.
void thin_image(uint8_t* skel, int h, int w, const double* dist2,
                const uint8_t* table, std::vector<PixKey>& keys) {
  keys.clear();
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      const int idx = y * w + x;
      if (!skel[idx]) continue;
      int count = 0;
      for (int dy = -1; dy <= 1; dy++) {
        for (int dx = -1; dx <= 1; dx++) {
          const int yy = y + dy, xx = x + dx;
          if (yy >= 0 && yy < h && xx >= 0 && xx < w && skel[yy * w + xx])
            count++;
        }
      }
      keys.push_back(PixKey{dist2[idx], 9 - count, splitmix64((uint64_t)idx),
                            idx});
    }
  }
  std::sort(keys.begin(), keys.end(), [](const PixKey& a, const PixKey& b) {
    if (a.d2 != b.d2) return a.d2 < b.d2;
    if (a.corner != b.corner) return a.corner < b.corner;
    return a.tiebreak < b.tiebreak;
  });
  for (const PixKey& p : keys) {
    const int y = p.idx / w, x = p.idx % w;
    int nbh = 0, bit = 0;
    for (int dy = -1; dy <= 1; dy++) {
      for (int dx = -1; dx <= 1; dx++) {
        const int yy = y + dy, xx = x + dx;
        if (yy >= 0 && yy < h && xx >= 0 && xx < w && skel[yy * w + xx])
          nbh |= 1 << bit;
        bit++;
      }
    }
    if (!table[nbh]) skel[p.idx] = 0;
  }
}

// Skeleton metric reductions: area (fg count), stroke length
// (sqrt-2-weighted lower-half adjacency), thickness sum + skeleton count.
void reduce_metrics(const uint8_t* bin, const uint8_t* skel, int h, int w,
                    const double* dist2, double* out4) {
  const double sqrt2 = std::sqrt(2.0);
  double area = 0.0, length = 0.0, thick = 0.0, count = 0.0;
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      const int idx = y * w + x;
      if (bin[idx]) area += 1.0;
      if (!skel[idx]) continue;
      count += 1.0;
      thick += std::sqrt(dist2[idx]);
      // lower-half mask: (0,+1)=1, (+1,-1)=sqrt2, (+1,0)=1, (+1,+1)=sqrt2
      if (x + 1 < w && skel[idx + 1]) length += 1.0;
      if (y + 1 < h) {
        if (x - 1 >= 0 && skel[idx + w - 1]) length += sqrt2;
        if (skel[idx + w]) length += 1.0;
        if (x + 1 < w && skel[idx + w + 1]) length += sqrt2;
      }
    }
  }
  out4[0] = area;
  out4[1] = length;
  out4[2] = count > 0 ? thick / count : 0.0;
  out4[3] = count;
}

void process_range(const uint8_t* imgs, int b0, int b1, int h, int w,
                   const uint8_t* table, double* dist_out, uint8_t* skel_out,
                   double* metrics_out) {
  const size_t n = (size_t)h * w;
  std::vector<double> dist2(n);
  std::vector<uint8_t> skel_local;
  std::vector<PixKey> keys;
  for (int b = b0; b < b1; b++) {
    const uint8_t* bin = imgs + (size_t)b * n;
    edt_squared(bin, h, w, dist2.data());
    uint8_t* skel;
    if (skel_out) {
      skel = skel_out + (size_t)b * n;
    } else {
      skel_local.resize(n);
      skel = skel_local.data();
    }
    std::memcpy(skel, bin, n);
    thin_image(skel, h, w, dist2.data(), table, keys);
    if (metrics_out) {
      reduce_metrics(bin, skel, h, w, dist2.data(), metrics_out + 4 * b);
    }
    if (dist_out) {
      double* d = dist_out + (size_t)b * n;
      for (size_t i = 0; i < n; i++) d[i] = std::sqrt(dist2[i]);
    }
  }
}

}  // namespace

extern "C" {

// imgs: (B,H,W) uint8 binary. table: 512-entry keep-LUT.
// Outputs (any may be null): dist (B,H,W) double Euclidean distances,
// skel (B,H,W) uint8 skeletons, metrics (B,4) double
// [area_px, stroke_len_px, mean_skel_dist, skel_px_count].
void morphometry_batch(const uint8_t* imgs, int32_t batch, int32_t h,
                       int32_t w, const uint8_t* table, double* dist,
                       uint8_t* skel, double* metrics, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  n_threads = std::min<int32_t>(n_threads, batch);
  if (n_threads <= 1) {
    process_range(imgs, 0, batch, h, w, table, dist, skel, metrics);
    return;
  }
  std::vector<std::thread> threads;
  const int per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    const int b0 = t * per;
    const int b1 = std::min<int>(b0 + per, batch);
    if (b0 >= b1) break;
    threads.emplace_back(process_range, imgs, b0, b1, h, w, table, dist,
                         skel, metrics);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
