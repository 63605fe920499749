// The BiGAN encoder trunk on Hopper: a stack of strided convs, each with bias
// and (optionally) LeakyReLU applied in the kernel's epilogue, on the tensor
// cores.
//
// Replaces the TPU kernel `_pallas_encoder` in
// imagecfgen_tpu/ops/pallas/fused_encoder.py (body `_encoder_kernel` and
// `_conv_block`), which keeps the whole trunk in VMEM and computes each conv
// as K*K parity-sliced MXU matmuls, in f32 or bf16 with f32 accumulation and
// one rounding per layer after the bias and LeakyReLU.
//
// Bound on this card. The full-width MNIST trunk (5 -> 64 -> 128 -> 256 ->
// 512 -> latent 512) costs 28.1 MFLOP a sample against about 23.5 KB of
// traffic at B = 2048 (the 12.1 MB of weights are shared by the batch); the
// AudioMNIST trunk (7 -> 64 -> ... -> 1024 -> 512, six 5x5 convs) 1.43 GFLOP
// a sample. Both are bound by operations, in f32 by a third of the TF32
// rate (three tensor-core products per f32 product), in bf16 by the bf16
// rate. A trunk's first layer is another matter: 64 output channels from
// 2-7 input channels (K = 45-175), so its output's bytes bound it (whale
// 149 MB, ESRF 316 MB: 0.044 and 0.094 ms at 3.35 TB/s) or, in f32 at K =
// 175, barely its operations (audio: 11.4 GFLOP, 0.069 ms).
//
// Design. Each conv is one implicit GEMM, M = B*OH*OW output pixels by N =
// Cout channels over K = KH*KW*Cin taps, launched once per layer on the
// caller's stream, with 3xTF32 for f32 tensors and bf16 for bf16 tensors,
// f32 accumulators and float32 sums promoted out of the tensor cores every K
// slice (tc_gemm.cuh). Intermediates between layers go through device memory
// in the tensors' type (scratch that the caller allocates). The per-layer
// launch plan comes from Python.
//
//   Layers 2 and up (C a multiple of the slice depth) run conv_wgmma
//   (tc_gemm.cuh): a cp.async ring of K slices, the im2col gather walked by
//   increments with 16-byte loads along the input channels, and a split of
//   K over a thread-block cluster for layers with fewer tiles than SMs.
//
//   The first layer runs conv_window, below, as does a later layer of a
//   narrow trunk (--d 8, 16) whose C is no multiple of the slice depth,
//   where its weights and windows fit shared memory; where they do not,
//   the wrapper pads its C with zero channels and it runs conv_wgmma. Its weights are tiny (64 x
//   K) and its K is a few slices, so a block that copied its weights and
//   gathered its A tile per output tile (as the scalar-gather loop before it
//   did: every A element a scalar global load, waited out before each
//   slice's multiply, and the packed weights copied again by each of 4,000
//   to 8,000 blocks) spent its life in the prologue. Here persistent blocks,
//   one an SM, copy the packed weights into shared memory once and walk
//   output tiles of 128 pixels (tr output rows by tw columns of one image).
//   A tile's input window, (tr-1)*stride + KS rows by ((tw-1)*stride + KS)*C
//   elements of each row, zero outside the image, is fetched while the tile
//   before it multiplies, by cp.async copies of up to 16 bytes with
//   zero-fill. The im2col fragments are then read from shared memory
//   through a table of tap offsets, for A from registers (f32: split into hi
//   and lo there), with the weights as B from shared memory through wgmma's
//   descriptors, m64n64. float32 promotes its sum every 16-deep half slice,
//   the large terms a_hi*b_hi added last: at K = 45-175 one sum a 32-deep
//   slice, its terms step by step, still leaned toward zero a sixth as far
//   as one sum over K. The epilogue adds
//   the bias, applies LeakyReLU and leaves each warp's 16 pixels in shared
//   memory, from where they are stored as whole 128-byte lines. The plan
//   (tensor_core.py::plan_window) picks tr and tw to waste the fewest pixel
//   slots and cuts the window's width, not the result, where the window
//   would not fit shared memory.
//
// Built by imagecfgen_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes; the C entry point returns cudaGetLastError().

#include "tc_gemm.cuh"

namespace tcg {

// The tiling of one conv_window layer (tensor_core.py::plan_window).
struct WindowArgs {
  int tr, tw;            // output rows and columns of a tile, tr * tw <= WIN_ROWS
  int tiles_h, tiles_w;  // tiles of an image along its rows and its columns
  int wr, wcc;           // window rows, and elements of a window row
  int wp;                // elements from one window row to the next in shared memory
  int tiles;             // batch * tiles_h * tiles_w
};

constexpr int WIN_THREADS = 256;  // two warpgroups, each 64 pixels of the tile
constexpr int WIN_ROWS = 128;     // pixel slots of a tile
constexpr int WIN_BUFFERS = 2;    // windows in shared memory: the next tile's in flight
constexpr int WIN_STAGE = 16 * 36 * 4;  // a warp's epilogue staging: 16 pixels x 128 bytes, padded

// cp.async of `bytes` (16, 8 or 4), zero-filled where !valid
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src, bool valid, int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Row pitch of a window in shared memory, in elements: a row is fetched in
// copies of up to 16 bytes (E elements) from the aligned element at or
// below its first, so it keeps up to E - 1 more, and whole copies.
template <typename T> __host__ __device__ __forceinline__ int window_pitch(int wcc) {
  constexpr int E = 16 / sizeof(T);
  return (wcc + 2 * E - 2) / E * E;
}

// MINB: the blocks an SM holds (2 where two fit its shared memory). float32
// with one block (its weights take most of the shared memory) builds each
// slice's fragments while the slice before it multiplies; with two, the
// other block hides that.
template <typename T, int MINB>
__global__ void __launch_bounds__(WIN_THREADS, MINB) conv_window(const ConvArgs p, const WindowArgs q) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr bool OVERLAP = F32 && MINB == 1;
  constexpr int BK = Elem<T>::BK;
  constexpr int SLICE_BYTES = Elem<T>::NB * 64 * 128;  // one K slice of B: hi (and lo), 64 channels

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* b_res = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int slices = p.Kp / BK;
  const int win_bytes = (q.wr * q.wp * (int)sizeof(T) + 15) & ~15;
  unsigned char* const windows = b_res + slices * SLICE_BYTES;
  unsigned char* const staging = windows + WIN_BUFFERS * win_bytes;
  float* const bias_s = reinterpret_cast<float*>(staging + 8 * WIN_STAGE);  // 64 channels
  int* const slot_rc = reinterpret_cast<int*>(bias_s + 64);                  // WIN_ROWS slots
  int* const koff = slot_rc + WIN_ROWS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.y * 64;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int rowlen = p.W * p.C;  // elements of an input row
  // the window's copies: the widest (16, 8 or 4 bytes) that no row edge splits
  const int row_bytes = rowlen * (int)sizeof(T);
  const int copy_bytes = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : 4;
  const int E = copy_bytes / (int)sizeof(T);  // elements a copy
  const bool by_copies = row_bytes % 4 == 0;

  // the packed weights, resident for the block's life
  for (int s = 0; s < slices; ++s) copy_b_slice<T, 64, WIN_THREADS>(p, b_res + s * SLICE_BYTES, n0, s, tid);
  cp_async_commit();
  // tap k = (kh, kw, ci) sits at kh * wp + kw * C + ci of a window; past K
  // the weights are zero and any finite element will do
  for (int k = tid; k < p.Kp; k += WIN_THREADS) {
    int off = 0;
    if (k < p.K) {
      const int tap = k / p.C, ci = k - tap * p.C, kh = tap / p.KS;
      off = kh * q.wp + (tap - kh * p.KS) * p.C + ci;
    }
    koff[k] = off;
  }
  if (tid < 64) bias_s[tid] = n0 + tid < p.CO ? to_float(static_cast<const T*>(p.bias)[n0 + tid]) : 0.f;
  if (tid < WIN_ROWS)  // pixel slot -> tile row << 16 | tile column; -1: no pixel
    slot_rc[tid] = tid < q.tr * q.tw ? (tid / q.tw) << 16 | (tid % q.tw) : -1;
  // this thread's two pixel slots (accumulator rows g and g + 8 of its warp):
  // tile row and column (row -1: no pixel) and window offset
  int pr[2], pc[2], base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int slot = (warp >> 2) * 64 + (warp & 3) * 16 + g + h * 8;
    pr[h] = slot < q.tr * q.tw ? slot / q.tw : -1;
    pc[h] = slot < q.tr * q.tw ? slot - pr[h] * q.tw : 0;
    base[h] = pr[h] < 0 ? 0 : pr[h] * p.stride * q.wp + pc[h] * p.stride * p.C;
  }

  // A tile's place: image b, tile row th and column tc of that image.
  // Consecutive tiles of a block are gridDim.x apart: the place advances
  // by the place of that step, carrying, with no division per tile.
  struct Place { int b, th, tc; };
  auto place = [&](int tile) {
    const int per = q.tiles_h * q.tiles_w;
    Place at;
    at.b = tile / per;
    at.th = (tile - at.b * per) / q.tiles_w;
    at.tc = tile - at.b * per - at.th * q.tiles_w;
    return at;
  };
  const Place stride_at = place(gridDim.x);
  auto advance = [&](Place& at) {
    at.tc += stride_at.tc;
    if (at.tc >= q.tiles_w) at.tc -= q.tiles_w, ++at.th;
    at.th += stride_at.th;
    if (at.th >= q.tiles_h) at.th -= q.tiles_h, ++at.b;
    at.b += stride_at.b;
  };
  // The window of a tile: input rows ih0 .. ih0 + wr - 1, elements f0 ..
  // f0 + wcc - 1 of each, zero outside the image, by cp.async with
  // zero-fill (one group a tile), in copies of E elements from the aligned
  // element at or below f0, so that element f0 + c sits at c + shift of its
  // row; no copy straddles an image's edge. Rows of a length no copy divides
  // (a bf16 row of an odd length: no trunk has one) go element by element.
  const int units = q.wp / E;  // copies a window row
  const int step_r = WIN_THREADS / units, step_c = WIN_THREADS - step_r * units;
  const int r0 = tid / units, c0 = tid - r0 * units;  // this thread's first copy
  // where element f0 of a tile's window lands in its row (the shift; E is a power of two)
  auto shift = [&](const Place& at) {
    return by_copies ? ((at.tc * q.tw * p.stride - p.pad) * p.C) & (E - 1) : 0;
  };
  auto fetch = [&](const Place& at, int slot) {
    unsigned char* buf = windows + slot * win_bytes;
    const int b = at.b, ih0 = at.th * q.tr * p.stride - p.pad, f0 = (at.tc * q.tw * p.stride - p.pad) * p.C;
    const T* img = x + (size_t)b * p.H * rowlen;
    if (by_copies) {
      const int fw = f0 - shift(at);  // first element fetched, a multiple of E
      // copy e = r * units + c, all threads over the whole window
      int r = r0, c = c0;
      for (int e = tid; e < q.wr * units; e += WIN_THREADS) {
        const int ih = ih0 + r, f = fw + c * E;
        const bool ok = (unsigned)ih < (unsigned)p.H && f >= 0 && f < rowlen;
        cp_async_n(smem_addr(buf + (r * q.wp + c * E) * (int)sizeof(T)), ok ? img + (size_t)ih * rowlen + f : x,
                   ok, copy_bytes);
        r += step_r;
        c += step_c;
        if (c >= units) c -= units, ++r;
      }
    } else {
      T* dst = reinterpret_cast<T*>(buf);
      for (int r = 0; r < q.wr; ++r) {
        const int ih = ih0 + r;
        for (int c = tid; c < q.wcc; c += WIN_THREADS) {
          const int f = f0 + c;
          dst[r * q.wp + c] = (unsigned)ih < (unsigned)p.H && (unsigned)f < (unsigned)rowlen
                                  ? img[(size_t)ih * rowlen + f] : T(0.f);
        }
      }
    }
    cp_async_commit();
  };

  // bf16: acc, one sum a tile. float32: sum, fed by a fresh tensor-core sum
  // (acc) every half slice.
  float acc[32], sum[32];
  // A fragments of slice s for m64n64 from the window `w`, its pixel
  // offsets moved by `sh`: f32 rows g, g + 8 by columns t, t + 4 of each
  // 8-deep step, split into hi and lo; bf16 the pairs at 2t and 2t + 8 of
  // each 16-deep step
  auto frags = [&](const T* w, int sh, int s, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
    const int b0 = base[0] + sh, b1 = base[1] + sh;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if constexpr (F32) {
        const int k = s * BK + ks * 8 + t;
        const int o0 = koff[k], o1 = koff[k + 4];
        const float v[4] = {to_float(w[b0 + o0]), to_float(w[b1 + o0]), to_float(w[b0 + o1]),
                            to_float(w[b1 + o1])};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[ks][e] = to_tf32(v[e]);
          lo[ks][e] = to_tf32(v[e] - __uint_as_float(hi[ks][e]));
        }
      } else {
        const int k = s * BK + ks * 16 + 2 * t;
        const int o0 = koff[k], o1 = koff[k + 1], o2 = koff[k + 8], o3 = koff[k + 9];
        const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(w);
        hi[ks][0] = pack_bf16(wb[b0 + o0], wb[b0 + o1]);
        hi[ks][1] = pack_bf16(wb[b1 + o0], wb[b1 + o1]);
        hi[ks][2] = pack_bf16(wb[b0 + o2], wb[b0 + o3]);
        hi[ks][3] = pack_bf16(wb[b1 + o2], wb[b1 + o3]);
      }
    }
  };
  // float32: steps 2 * half and 2 * half + 1 of slice s into a fresh acc,
  // the small terms a_lo*b_hi and a_hi*b_lo first, then a_hi*b_hi. The
  // tensor cores truncate as they add, by up to an ulp of the running sum,
  // so the large terms' adds come last and few: one chain of all twelve
  // adds of a slice, step by step, drifted toward zero a sixth as far as one
  // sum over K, and chip_smoke.py's P1 asks a tenth. bf16: all of slice s.
  auto multiply = [&](int s, int half, const uint32_t (&hi)[4][4], const uint32_t (&lo)[4][4]) {
    const uint64_t dh = smem_desc(smem_addr(b_res + s * SLICE_BYTES));
    wgmma_fence();
    if constexpr (F32) {
      const uint64_t dl = smem_desc(smem_addr(b_res + s * SLICE_BYTES + 64 * 128));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ks = 2 * half + j;
        wgmma_tf32(acc, lo[ks], dh + 2 * ks, j > 0);
        wgmma_tf32(acc, hi[ks], dl + 2 * ks, 1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) wgmma_tf32(acc, hi[2 * half + j], dh + 2 * (2 * half + j), 1);
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_bf16(acc, hi[ks], dh + 2 * ks, 1);
    }
    wgmma_commit();
  };
  auto settle = [&]() {
    wgmma_wait<0>();
    fence_operands(acc);
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] += acc[i];
    }
  };

  // tile blockIdx.x + i * gridDim.x uses window i % WIN_BUFFERS; the next
  // WIN_BUFFERS - 1 tiles' windows are in flight while a tile multiplies
  const int step = gridDim.x;
  int tile = blockIdx.x;
  Place at = place(tile), ahead = at;
#pragma unroll
  for (int i = 0; i < WIN_BUFFERS - 1; ++i) {
    if (tile + i * step < q.tiles) fetch(ahead, i);
    else cp_async_commit();  // an empty group keeps the count of groups in flight
    advance(ahead);
  }
  cp_async_wait<WIN_BUFFERS - 2>();  // the weights and the first window
  fence_async_proxy();
  __syncthreads();
  for (int i = 0; tile < q.tiles; tile += step, ++i, advance(at)) {
    const T* w = reinterpret_cast<const T*>(windows + (i % WIN_BUFFERS) * win_bytes);
    const int sh = shift(at);
    if (tile + (WIN_BUFFERS - 1) * step < q.tiles) fetch(ahead, (i + WIN_BUFFERS - 1) % WIN_BUFFERS);
    else cp_async_commit();
    advance(ahead);

#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = sum[j] = 0.f;
    uint32_t h0[4][4], l0[4][4];
    constexpr int HALVES = F32 ? 2 : 1;
    if constexpr (OVERLAP) {  // slice s + 1's fragments are built while slice s multiplies
      uint32_t h1[4][4], l1[4][4];
      frags(w, sh, 0, h0, l0);
      for (int s = 0; s < slices; s += 2) {
        multiply(s, 0, h0, l0);
        if (s + 1 < slices) frags(w, sh, s + 1, h1, l1);
        settle();
#pragma unroll
        for (int half = 1; half < HALVES; ++half) {
          multiply(s, half, h0, l0);
          settle();
        }
        if (s + 1 < slices) {
          multiply(s + 1, 0, h1, l1);
          if (s + 2 < slices) frags(w, sh, s + 2, h0, l0);
          settle();
#pragma unroll
          for (int half = 1; half < HALVES; ++half) {
            multiply(s + 1, half, h1, l1);
            settle();
          }
        }
      }
    } else {
      for (int s = 0; s < slices; ++s) {
        frags(w, sh, s, h0, l0);
#pragma unroll
        for (int half = 0; half < HALVES; ++half) {
          multiply(s, half, h0, l0);
          settle();
        }
      }
    }

    // accumulator j: pixel slot h = (j >> 1) & 1, column 8 * (j >> 2) + 2t + (j & 1).
    // Each warp leaves its 16 pixels' channels (float32: 32 at a time) in
    // its staging area and stores them as whole 128-byte lines, 16 bytes a
    // lane; a layer whose channels are no multiple of 64 stores from the
    // accumulators.
    const int b = at.b, oh0 = at.th * q.tr, ow0 = at.tc * q.tw;
    const float* vals = F32 ? sum : acc;
    auto out = [&](int j, int h, int e) {
      const float v = vals[4 * j + 2 * h + e] + bias_s[8 * j + 2 * t + e];
      return p.act && v < 0.f ? p.slope * v : v;
    };
    if (p.CO % 64 == 0) {
      unsigned char* stage = staging + warp * WIN_STAGE;
      const int slot0 = (warp >> 2) * 64 + (warp & 3) * 16;
#pragma unroll
      for (int half = 0; half < (F32 ? 2 : 1); ++half) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jj = 0; jj < (F32 ? 4 : 8); ++jj) {
            const int j = F32 ? 4 * half + jj : jj;
            if constexpr (F32) {
              *reinterpret_cast<float2*>(stage + ((g + 8 * h) * 36 + 8 * jj + 2 * t) * 4) =
                  make_float2(out(j, h, 0), out(j, h, 1));
            } else {
              *reinterpret_cast<__nv_bfloat162*>(stage + ((g + 8 * h) * 72 + 8 * jj + 2 * t) * 2) =
                  __floats2bfloat162_rn(out(j, h, 0), out(j, h, 1));
            }
          }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // chunk lane + 32 i: pixel (lane >> 3) + 4 i, 16 bytes (lane & 7)
          const int sl = (lane >> 3) + 4 * i, rc = slot_rc[slot0 + sl];
          const int oh = oh0 + (rc >> 16), ow = ow0 + (rc & 0xFFFF);
          if (rc < 0 || oh >= p.OH || ow >= p.OW) continue;
          const size_t m = ((size_t)b * p.OH + oh) * p.OW + ow;
          *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(static_cast<T*>(p.y) + m * p.CO + n0) +
                                    half * 128 + (lane & 7) * 16) =
              *reinterpret_cast<const uint4*>(stage + sl * 144 + (lane & 7) * 16);
        }
        __syncwarp();
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int oh = oh0 + pr[h], ow = ow0 + pc[h];
        if (pr[h] < 0 || oh >= p.OH || ow >= p.OW) continue;
        T* yrow = static_cast<T*>(p.y) + (((size_t)b * p.OH + oh) * p.OW + ow) * p.CO;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n0 + 8 * j + 2 * t + e < p.CO) from_float(yrow + n0 + 8 * j + 2 * t + e, out(j, h, e));
      }
    }
    cp_async_wait<WIN_BUFFERS - 2>();  // the next tile's window has landed
    __syncthreads();     // and nobody reads this one any more
  }
  cp_async_wait<0>();
}

// Shared memory of a conv_window block (tensor_core.py::window_smem's count).
template <typename T> int window_smem(const ConvArgs& a, const WindowArgs& q) {
  const int win_bytes = (q.wr * q.wp * (int)sizeof(T) + 15) & ~15;
  return 1024 + (a.Kp / Elem<T>::BK) * Elem<T>::NB * 64 * 128 + WIN_BUFFERS * win_bytes + 8 * WIN_STAGE +
         (64 + WIN_ROWS) * 4 + a.Kp * 4;
}

// The grid: as many blocks as the card holds at once. The occupancy and the
// shared-memory limit are set once per device and size, not every launch
// (with a query every launch, the MNIST trunk at B = 64 took 0.18-0.20 ms a
// call against 0.13-0.14 for the kernel before this one, with less device
// time). static: each library keeps its own.
template <typename T, int MINB>
static cudaError_t launch_window_blocks(const ConvArgs& a, const WindowArgs& q, int smem, cudaStream_t s) {
  auto kernel = conv_window<T, MINB>;
  static int set_smem = 0, known_dev = -1, known_smem = -1, sms = 0, per_sm = 0;
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev != known_dev) {
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    known_dev = dev;
    known_smem = -1;
    set_smem = 0;
  }
  if (smem > set_smem) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
      return err;
    set_smem = smem;
  }
  if (smem != known_smem) {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WIN_THREADS, smem)) != cudaSuccess)
      return err;
    known_smem = smem;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int co_tiles = (a.CO + 63) / 64;
  const int fill = per_sm * sms / co_tiles;
  const int blocks = q.tiles < fill ? q.tiles : (fill > 0 ? fill : 1);
  kernel<<<dim3((unsigned)blocks, (unsigned)co_tiles), WIN_THREADS, smem, s>>>(a, q);
  return cudaSuccess;
}

// Two blocks an SM where two fit the shared memory, else one.
template <typename T> static cudaError_t launch_window(const ConvArgs& a, const WindowArgs& q, cudaStream_t s) {
  if (a.Kp % Elem<T>::BK != 0 || a.Kp < a.K || q.tr < 1 || q.tw < 1 || q.tr * q.tw > WIN_ROWS)
    return cudaErrorInvalidValue;
  const int smem = window_smem<T>(a, q);
  return 2 * smem <= 227 * 1024 ? launch_window_blocks<T, 2>(a, q, smem, s)
                                : launch_window_blocks<T, 1>(a, q, smem, s);
}

}  // namespace tcg

// Runs layers [first, n_layers) of a conv stack on `stream`.
//   x            NHWC input of layer `first`, shape (batch, H, W, C)
//   bf16         element type of every tensor: 0 float, 1 __nv_bfloat16
//   layer_ints   n_layers x 9 ints: kernel size, stride, padding, Cout, act,
//                packed row stride Kp, then the plan: conv_wgmma (path 1)
//                tile index and K split; conv_window (path 0) the tile's
//                output rows and columns; then the path
//   slopes       n_layers LeakyReLU slopes (read where act != 0)
//   weights      3 * n_layers device pointers per layer: packed kernel
//                (f32: its tf32 hi part), its tf32 lo part (bf16: null), bias
//   outs         n_layers device pointers: NHWC output of each layer
// Returns cudaGetLastError() after the last launch, or the first error.
extern "C" int fused_encoder_run(const void* x, int bf16, int batch, int H, int W, int C,
                                 int n_layers, int first, const int* layer_ints,
                                 const float* slopes, void* const* weights, void* const* outs,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in = x;
  for (int i = first; i < n_layers; ++i) {
    const int* li = layer_ints + 9 * i;
    tcg::ConvArgs a;
    a.KS = li[0];
    a.stride = li[1];
    a.pad = li[2];
    a.CO = li[3];
    a.act = li[4];
    a.Kp = li[5];
    a.batch = batch;
    a.H = H;
    a.W = W;
    a.C = C;
    a.OH = (H + 2 * a.pad - a.KS) / a.stride + 1;
    a.OW = (W + 2 * a.pad - a.KS) / a.stride + 1;
    if (a.OH <= 0 || a.OW <= 0 || a.stride < 1 || a.KS < 1 || a.C < 1 || a.CO < 1)
      return (int)cudaErrorInvalidValue;
    a.K = a.KS * a.KS * C;
    a.slope = slopes[i];
    a.x = in;
    a.w_hi = weights[3 * i];
    a.w_lo = weights[3 * i + 1];
    a.bias = weights[3 * i + 2];
    a.y = outs[i];
    cudaError_t err;
    if (li[8]) {
      a.split = li[7];
      err = tcg::launch_layer(bf16 != 0, li[6], a, s);
    } else {
      a.split = 1;
      tcg::WindowArgs q;
      q.tr = li[6];
      q.tw = li[7];
      q.tiles_h = (a.OH + q.tr - 1) / q.tr;
      q.tiles_w = (a.OW + q.tw - 1) / q.tw;
      q.wr = (q.tr - 1) * a.stride + a.KS;
      q.wcc = ((q.tw - 1) * a.stride + a.KS) * C;
      q.wp = bf16 ? tcg::window_pitch<__nv_bfloat16>(q.wcc) : tcg::window_pitch<float>(q.wcc);
      q.tiles = batch * q.tiles_h * q.tiles_w;
      err = bf16 ? tcg::launch_window<__nv_bfloat16>(a, q, s) : tcg::launch_window<float>(a, q, s);
    }
    if (err != cudaSuccess) return (int)err;
    in = a.y;
    H = a.OH;
    W = a.OW;
    C = a.CO;
  }
  return (int)cudaGetLastError();
}
