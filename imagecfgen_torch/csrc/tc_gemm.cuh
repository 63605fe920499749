// The tensor-core main loop shared by fused_encoder.cu and fused_dense.cu:
// one implicit-GEMM conv layer, y = act(conv(x, w) + b), on Hopper.
//
//   M = batch * OH * OW output pixels, N = CO channels, K = KS * KS * C taps.
//   A (M x K) is gathered on the fly from the NHWC input (zero outside the
//   image and past a ragged batch); B (N x K) is the weight matrix packed
//   K-major by the wrapper (row stride Kp, K padded with zeros to a multiple
//   of the slice depth). A dense layer is the same problem with H = W = 1,
//   KS = 1 and C = K.
//
// Two kernels share the staging and the epilogue:
//   conv_wgmma  layers whose C is a multiple of the slice depth (every layer
//               but a trunk's first; a dense layer with an aligned K):
//               wgmma.mma_async, 64 rows per warpgroup, B (and for bf16 A)
//               read from shared memory through matrix descriptors;
//   conv_mma    the rest (a first layer with 5 or 7 channels, a dense layer
//               with a ragged K): mma.sync on a masked scalar gather.
//
// Types. T = __nv_bfloat16: bf16 products (m64nNk16 / m16n8k16) with f32
// accumulators. T = float: 3xTF32 (m64nNk8 / m16n8k8). Every operand v is
// split into hi = tf32(v) and lo = tf32(v - hi); the weights arrive already
// split (two packed tensors), the gathered activations are split in
// registers (so wgmma takes A from registers in f32), and
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is accumulated in f32, small terms
// first. That keeps f32-level accuracy; single-pass TF32 is never used.
// The epilogue adds the bias, applies LeakyReLU and rounds once to T.
//
// Staging. A ring of STAGES tiles in dynamic shared memory, one K slice of
// 128 bytes per row and stage (32 floats or 64 bf16), filled by 16-byte
// cp.async copies with zero-fill, so loads for later slices are in flight
// while a slice multiplies; one __syncthreads per slice. Rows are 128 bytes
// and the 16-byte chunk c of row r sits at chunk c ^ (r & 7): that is the
// 128-byte-swizzled K-major layout wgmma's descriptors name, and it keeps
// the fragment loads (ld.shared.b32 for TF32, ldmatrix for bf16) and the
// cp.async stores free of bank conflicts. In conv_wgmma a slice lies inside
// one tap: (kh, kw, ci) advance by increments, one predicate per row decides
// validity and the loads are 16 bytes along ci. In conv_mma the A tile is
// gathered with masked scalar loads, all started before the first store. B is
// always copied 16 bytes wide.
//
// Epilogue and split K. A block leaves its f32 tile in shared memory (the
// ring is free by then) and stores it from there, 16 bytes a thread along a
// row. Where a layer has fewer tiles than the card has SMs, the grid's z
// dimension splits the K slices over a thread-block cluster (up to 8
// blocks): after a cluster barrier block r sums rows [r*BM/S, (r+1)*BM/S) of
// all S partial tiles through distributed shared memory in rank order
// before the bias, LeakyReLU and the store: one launch, no scratch in
// device memory, no atomics, the same bits on every run.
//
// The launch plan (tile shape, split, vector or scalar gather) is chosen in
// Python (imagecfgen_torch/ops/tensor_core.py::plan_gemm) and handed in.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tcg {

namespace cg = cooperative_groups;

struct ConvArgs {
  const void* x;     // (batch, H, W, C) NHWC, type T
  const void* w_hi;  // (CO, Kp) K-major, type T; f32: the tf32 hi part
  const void* w_lo;  // f32: the tf32 lo part; bf16: unused
  const void* bias;  // (CO,), type T
  void* y;           // (M, CO), type T
  int batch, H, W, C, OH, OW, CO, KS, stride, pad;
  int K;             // KS * KS * C
  int Kp;            // row stride of the packed weights, a multiple of BK
  int act;           // apply LeakyReLU
  float slope;
  int split;         // blocks along z == cluster size, 1..8
};

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int BK = 32;     // slice depth: 128 bytes per row
  static constexpr int STAGES = 3;
  static constexpr int NB = 2;      // B tiles per stage: hi and lo
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int BK = 64;
  static constexpr int STAGES = 4;
  static constexpr int NB = 1;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, byte) in a tile of 128-byte rows, chunks swizzled.
__device__ __forceinline__ int swz(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// bias + LeakyReLU + the one rounding to T, masked on the ragged edges
template <typename T>
__device__ __forceinline__ void store_out(const ConvArgs& p, int M, int m, int n, float v) {
  if (m >= M || n >= p.CO) return;
  v += to_float(static_cast<const T*>(p.bias)[n]);
  if (p.act) v = v >= 0.f ? v : p.slope * v;
  from_float(static_cast<T*>(p.y) + (size_t)m * p.CO + n, v);
}

// Decode (b, oh, ow) once per row of the tile: the first input pixel of the
// image, and the top-left tap's ih and iw.
template <int BM, int NT>
__device__ __forceinline__ void decode_rows(const ConvArgs& p, int4* rowinfo, int M, int m0,
                                            int tid) {
  for (int r = tid; r < BM; r += NT) {
    const int m = m0 + r;
    int4 info;
    if (m < M) {
      const int b = m / (p.OH * p.OW);
      const int rem = m - b * (p.OH * p.OW);
      const int oh = rem / p.OW;
      const int ow = rem - oh * p.OW;
      info = make_int4(b * p.H * p.W, oh * p.stride - p.pad, ow * p.stride - p.pad, 0);
    } else {  // past a ragged batch: every tap falls outside the image
      info = make_int4(0, -(1 << 28), -(1 << 28), 0);
    }
    rowinfo[r] = info;
  }
}

// cp.async the B tiles (hi, and for f32 lo) of K slice `s` into `b_tile`.
template <typename T, int BN, int NT>
__device__ __forceinline__ void copy_b_slice(const ConvArgs& p, unsigned char* b_tile, int n0,
                                             int s, int tid) {
#pragma unroll
  for (int j = 0; j < Elem<T>::NB; ++j) {
    const T* w = static_cast<const T*>(j == 0 ? p.w_hi : p.w_lo);
#pragma unroll
    for (int i = 0; i < BN * 8 / NT; ++i) {
      const int q = tid + i * NT;
      const int r = q >> 3, c = q & 7;
      const bool ok = n0 + r < p.CO;
      const T* src = ok ? w + ((size_t)(n0 + r) * p.Kp + (size_t)s * Elem<T>::BK) + c * (16 / sizeof(T))
                        : w;
      cp_async16(smem_addr(b_tile + j * BN * 128 + swz(r, c * 16)), src, ok);
    }
  }
}

// The tile a block leaves in shared memory for the epilogue has rows of
// BN + PART_PAD floats: the pad spreads the accumulators' stores over banks.
constexpr int PART_PAD = 4;

// The epilogue of every tile. Each of the S blocks of the cluster (S = 1: the
// block alone) has left its f32 (partial) tile at `part` in its own shared
// memory. Block `rank` sums rows [rank*BM/S, (rank+1)*BM/S) of the S tiles
// in rank order (the same sum on every run), adds the bias, applies LeakyReLU,
// rounds once to T and stores 16 bytes a thread, neighbouring threads on
// neighbouring addresses; columns past a ragged edge, and rows whose length
// is no multiple of 16 bytes, go one by one.
template <typename T, int BM, int BN, int NT>
__device__ __forceinline__ void finish_tile(const ConvArgs& p, cg::cluster_group& cluster,
                                            float* part, int M, int m0, int n0, int tid) {
  constexpr int V = 16 / sizeof(T);  // columns per thread and store
  constexpr int LD = (BN + PART_PAD);
  const int rank = p.split > 1 ? (int)cluster.block_rank() : 0;
  const int rows = (BM + p.split - 1) / p.split;
  const int r_begin = min(BM, rank * rows), r_end = min(BM, r_begin + rows);
  const T* bias = static_cast<const T*>(p.bias);
  for (int i = r_begin * (BN / V) + tid; i < r_end * (BN / V); i += NT) {
    const int r = i / (BN / V), c = (i % (BN / V)) * V;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= p.CO) continue;
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
    for (int q = 0; q < p.split; ++q) {
      const float* src = (p.split > 1 ? cluster.map_shared_rank(part, q) : part) + r * LD + c;
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 f = *reinterpret_cast<const float4*>(src + j);
        v[j] += f.x;
        v[j + 1] += f.y;
        v[j + 2] += f.z;
        v[j + 3] += f.w;
      }
    }
    if (n + V <= p.CO && p.CO % V == 0) {
      __align__(16) T out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float o = v[j] + to_float(bias[n + j]);
        if (p.act) o = o >= 0.f ? o : p.slope * o;
        from_float(out + j, o);
      }
      *reinterpret_cast<uint4*>(static_cast<T*>(p.y) + (size_t)m * p.CO + n) =
          *reinterpret_cast<const uint4*>(out);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) store_out<T>(p, M, m, n + j, v[j]);
    }
  }
}

// One BM x BN output tile over the K slices of blockIdx.z, on mma.sync, with
// the masked scalar gather: for layers whose C is no multiple of the slice
// depth (a trunk's first layer, a dense layer with a ragged K).
// Warps form a (BM / WM) x (BN / WN) grid; each keeps a WM x WN tile of f32
// accumulators in mma fragments.
template <typename T, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
conv_mma(const ConvArgs p) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BK = Elem<T>::BK;
  constexpr int STAGES = Elem<T>::STAGES;
  constexpr int NB = Elem<T>::NB;
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int MT = WM / 16;  // m16 fragments per warp
  constexpr int NF = WN / 8;   // n8 fragments per warp
  constexpr int A_BYTES = BM * 128;
  constexpr int B_BYTES = BN * 128;
  constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  constexpr int ROWS = NT / BK;     // rows gathered per pass
  constexpr int PASSES = BM / ROWS;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile must hold whole fragments");
  static_assert((BN * 8) % NT == 0, "copy passes do not divide");
  static_assert(NT % BK == 0 && BM % ROWS == 0, "scalar gather does not divide");
  static_assert(STAGES * STAGE_BYTES >= BM * (BN + PART_PAD) * 4,
                "the epilogue's tile does not fit the ring");

  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ int4 rowinfo[BM];  // per output pixel: first input pixel, ih0, iw0

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm0 = (warp / (BN / WN)) * WM;
  const int wn0 = (warp % (BN / WN)) * WN;
  const int M = p.batch * p.OH * p.OW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const T* __restrict__ x = static_cast<const T*>(p.x);

  decode_rows<BM, NT>(p, rowinfo, M, m0, tid);
  __syncthreads();

  // this block's K slices
  const int total = p.Kp / BK;
  const int per = (total + p.split - 1) / p.split;
  const int s_begin = blockIdx.z * per;
  const int s_end = min(total, s_begin + per);
  const int nslices = max(0, s_end - s_begin);

  auto load_slice = [&](int s, int stage) {
    unsigned char* a_tile = ring + stage * STAGE_BYTES;
    // one reduction lane per thread, decoded once; every load of the slice
    // is started before the first store, so that they overlap
    const int kk = tid % BK;
    const int k = s * BK + kk;
    const bool kvalid = k < p.K;
    const int tap = kvalid ? k / p.C : 0;
    const int ci = k - tap * p.C;
    const int kh = tap / p.KS;
    const int kw = tap - kh * p.KS;
    T v[PASSES];
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int4 info = rowinfo[tid / BK + i * ROWS];
      const int ih = info.y + kh, iw = info.z + kw;
      const bool ok = kvalid && (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W;
      v[i] = ok ? x[(size_t)(info.x + ih * p.W + iw) * p.C + ci] : T(0.f);
    }
#pragma unroll
    for (int i = 0; i < PASSES; ++i)
      *reinterpret_cast<T*>(a_tile + swz(tid / BK + i * ROWS, kk * (int)sizeof(T))) = v[i];
    copy_b_slice<T, BN, NT>(p, a_tile + A_BYTES, n0, s, tid);
  };

  float acc[MT][NF][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslices) load_slice(s_begin + s, s);
    cp_async_commit();
  }

  for (int it = 0; it < nslices; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice `it` has landed; the stage of slice it - 1 is free
    {
      const int nxt = it + STAGES - 1;
      if (nxt < nslices) load_slice(s_begin + nxt, nxt % STAGES);
      cp_async_commit();
    }
    const unsigned char* a_tile = ring + (it % STAGES) * STAGE_BYTES;
    const unsigned char* b_tile = a_tile + A_BYTES;

    if constexpr (F32) {
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        const int kb0 = (ks * 8 + t) * 4, kb1 = kb0 + 16;
        uint32_t a_hi[MT][4], a_lo[MT][4], b_hi[NF][2], b_lo[NF][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r0 = wm0 + i * 16 + g, r1 = r0 + 8;
          const float v[4] = {
              *reinterpret_cast<const float*>(a_tile + swz(r0, kb0)),
              *reinterpret_cast<const float*>(a_tile + swz(r1, kb0)),
              *reinterpret_cast<const float*>(a_tile + swz(r0, kb1)),
              *reinterpret_cast<const float*>(a_tile + swz(r1, kb1)),
          };
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a_hi[i][e] = to_tf32(v[e]);
            a_lo[i][e] = to_tf32(v[e] - __uint_as_float(a_hi[i][e]));
          }
        }
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int n = wn0 + j * 8 + g;
          b_hi[j][0] = *reinterpret_cast<const uint32_t*>(b_tile + swz(n, kb0));
          b_hi[j][1] = *reinterpret_cast<const uint32_t*>(b_tile + swz(n, kb1));
          b_lo[j][0] = *reinterpret_cast<const uint32_t*>(b_tile + B_BYTES + swz(n, kb0));
          b_lo[j][1] = *reinterpret_cast<const uint32_t*>(b_tile + B_BYTES + swz(n, kb1));
        }
        // small terms first
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], a_lo[i], b_hi[j][0], b_hi[j][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], a_hi[i], b_lo[j][0], b_lo[j][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], a_hi[i], b_hi[j][0], b_hi[j][1]);
      }
    } else {
      const uint32_t a_base = smem_addr(a_tile), b_base = smem_addr(b_tile);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t a[MT][4], b[NF][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = wm0 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(a[i], a_base + swz(r, ks * 32 + (lane >> 4) * 16));
        }
#pragma unroll
        for (int j = 0; j < NF; j += 2) {
          const int n = wn0 + j * 8 + (lane & 7) + (lane >> 4) * 8;
          uint32_t q[4];
          ldmatrix_x4(q, b_base + swz(n, ks * 32 + ((lane >> 3) & 1) * 16));
          b[j][0] = q[0];
          b[j][1] = q[1];
          b[j + 1][0] = q[2];
          b[j + 1][1] = q[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // the tile meets in shared memory (with a K split: in the cluster's
  // distributed shared memory) and leaves in 16-byte stores
  cg::cluster_group cluster = cg::this_cluster();
  float* part = reinterpret_cast<float*>(ring);
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (wm0 + i * 16 + g + h * 8) * (BN + PART_PAD) + wn0 +
                                   j * 8 + 2 * t) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  if (p.split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  finish_tile<T, BM, BN, NT>(p, cluster, part, M, m0, n0, tid);
  if (p.split > 1) cluster.sync();  // no block leaves while its partial tile is being read
}

// ---------------------------------------------------------------- wgmma
// Warpgroup MMA (four warps, 64 rows, B from shared memory through a matrix
// descriptor). The ring's tiles already have the layout the instruction
// wants for K-major operands with the 128-byte swizzle: 8-row groups of
// 128-byte rows, 1024 bytes apart, chunk c of row r at c ^ (r & 7); the
// tiles only have to start on 1024-byte boundaries.

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)  // start address
         | ((uint64_t)1 << 16)              // leading offset: unused with a swizzle
         | ((uint64_t)(1024 >> 4) << 32)    // stride between 8-row groups
         | ((uint64_t)1 << 62);             // 128-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async) become visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// One BM x BN output tile over the K slices of blockIdx.z, on wgmma. Each
// warpgroup (128 threads) owns 64 rows and all BN columns. C % BK == 0.
//   bf16: A and B both come from shared memory; one group of wgmmas stays
//         in flight while the next slice's copies are started.
//   f32:  3xTF32. Each warp reads its 16 x 32 part of the A slice into
//         registers in the instruction's fragment layout, splits it into hi
//         and lo, and runs a_lo*b_hi, a_hi*b_lo, a_hi*b_hi per 8-deep step
//         with A from registers and the packed hi and lo weights from
//         shared memory.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(BM * 2) conv_wgmma(const ConvArgs p) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BK = Elem<T>::BK;
  constexpr int STAGES = Elem<T>::STAGES;
  constexpr int NB = Elem<T>::NB;
  constexpr int INFLIGHT = F32 ? 0 : 1;  // wgmma groups left running across a barrier
  constexpr int AHEAD = STAGES - 1 - INFLIGHT;  // slices loaded ahead of the multiply
  constexpr int NT = BM * 2;
  constexpr int NACC = BN / 2;
  constexpr int A_BYTES = BM * 128;
  constexpr int B_BYTES = BN * 128;
  constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  static_assert(BM % 64 == 0 && (BN == 64 || BN == 128), "tile is not whole warpgroup MMAs");
  static_assert((BM * 8) % NT == 0 && (BN * 8) % NT == 0, "copy passes do not divide");
  static_assert(STAGES * STAGE_BYTES >= BM * (BN + PART_PAD) * 4,
                "the epilogue's tile does not fit the ring");

  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ int4 rowinfo[BM];
  unsigned char* ring = ring_raw + ((1024 - (smem_addr(ring_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg_row0 = (warp >> 2) * 64;           // the warpgroup's rows of the tile
  const int row0 = wg_row0 + (warp & 3) * 16 + g;  // this thread's first accumulator row
  const int M = p.batch * p.OH * p.OW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const T* __restrict__ x = static_cast<const T*>(p.x);

  decode_rows<BM, NT>(p, rowinfo, M, m0, tid);
  __syncthreads();

  const int total = p.Kp / BK;
  const int per = (total + p.split - 1) / p.split;
  const int s_begin = blockIdx.z * per;
  const int s_end = min(total, s_begin + per);
  const int nslices = max(0, s_end - s_begin);

  int ld_kh, ld_kw, ld_ci;
  {
    const int tap = (s_begin * BK) / p.C;
    ld_ci = s_begin * BK - tap * p.C;
    ld_kh = tap / p.KS;
    ld_kw = tap - ld_kh * p.KS;
  }

  auto load_slice = [&](int s, int stage) {
    unsigned char* a_tile = ring + stage * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < BM * 8 / NT; ++i) {
      const int q = tid + i * NT;
      const int r = q >> 3, c = q & 7;
      const int4 info = rowinfo[r];
      const int ih = info.y + ld_kh, iw = info.z + ld_kw;
      const bool ok = (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W;
      const T* src = ok ? x + ((size_t)(info.x + ih * p.W + iw) * p.C + ld_ci) + c * (16 / sizeof(T))
                        : x;
      cp_async16(smem_addr(a_tile + swz(r, c * 16)), src, ok);
    }
    ld_ci += BK;
    if (ld_ci == p.C) {
      ld_ci = 0;
      if (++ld_kw == p.KS) {
        ld_kw = 0;
        ++ld_kh;
      }
    }
    copy_b_slice<T, BN, NT>(p, a_tile + A_BYTES, n0, s, tid);
  };

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nslices) load_slice(s_begin + s, s);
    cp_async_commit();
  }

  for (int it = 0; it < nslices; ++it) {
    cp_async_wait<AHEAD - 1>();
    fence_async_proxy();
    __syncthreads();  // slice `it` has landed; every wgmma on slice it - 1 - INFLIGHT is done
    {
      const int nxt = it + AHEAD;
      if (nxt < nslices) load_slice(s_begin + nxt, nxt % STAGES);
      cp_async_commit();
    }
    const unsigned char* a_tile = ring + (it % STAGES) * STAGE_BYTES;
    const uint64_t desc_b = smem_desc(smem_addr(a_tile + A_BYTES));

    if constexpr (F32) {
      const uint64_t desc_b_lo = smem_desc(smem_addr(a_tile + A_BYTES + B_BYTES));
      uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        const int kb0 = (ks * 8 + t) * 4, kb1 = kb0 + 16;
        const float v[4] = {
            *reinterpret_cast<const float*>(a_tile + swz(row0, kb0)),
            *reinterpret_cast<const float*>(a_tile + swz(row0 + 8, kb0)),
            *reinterpret_cast<const float*>(a_tile + swz(row0, kb1)),
            *reinterpret_cast<const float*>(a_tile + swz(row0 + 8, kb1)),
        };
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a_hi[ks][e] = to_tf32(v[e]);
          a_lo[ks][e] = to_tf32(v[e] - __uint_as_float(a_hi[ks][e]));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {  // 32 bytes of K a step: +2 in the descriptor
        wgmma_tf32(acc, a_lo[ks], desc_b + 2 * ks);
        wgmma_tf32(acc, a_hi[ks], desc_b_lo + 2 * ks);
        wgmma_tf32(acc, a_hi[ks], desc_b + 2 * ks);
      }
    } else {
      const uint64_t desc_a = smem_desc(smem_addr(a_tile + wg_row0 * 128));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) wgmma_bf16(acc, desc_a + 2 * ks, desc_b + 2 * ks);
    }
    wgmma_commit();
    wgmma_wait<INFLIGHT>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // accumulator i: row row0 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * t + (i & 1)
  cg::cluster_group cluster = cg::this_cluster();
  float* part = reinterpret_cast<float*>(ring);
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < NACC; i += 2)
    *reinterpret_cast<float2*>(part + (row0 + ((i >> 1) & 1) * 8) * (BN + PART_PAD) +
                               (i >> 2) * 8 + 2 * t) = make_float2(acc[i], acc[i + 1]);
  if (p.split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  finish_tile<T, BM, BN, NT>(p, cluster, part, M, m0, n0, tid);
  if (p.split > 1) cluster.sync();  // no block leaves while its partial tile is being read
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, int bm, int bn, int threads, int smem, const ConvArgs& a,
                          cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long M = (long long)a.batch * a.OH * a.OW;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + bm - 1) / bm), (unsigned)((a.CO + bn - 1) / bn),
                     (unsigned)a.split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)a.split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T> constexpr int ring_bytes(int bm, int bn) {
  return Elem<T>::STAGES * (bm * 128 + Elem<T>::NB * bn * 128);
}

// The tile shapes of the launch plan, by index (tensor_core.py::TILES).
// Vector gather: the wgmma kernel; scalar gather: the mma.sync kernel.
template <typename T>
cudaError_t launch_typed(int tile, bool vec, const ConvArgs& a, cudaStream_t s) {
  if (vec) {  // + 1024: the ring is moved up to a 1024-byte boundary
    switch (tile) {
      case 0: return launch_kernel(conv_wgmma<T, 128, 128>, 128, 128, 256, ring_bytes<T>(128, 128) + 1024, a, s);
      case 1: return launch_kernel(conv_wgmma<T, 128, 64>, 128, 64, 256, ring_bytes<T>(128, 64) + 1024, a, s);
      case 2: return launch_kernel(conv_wgmma<T, 64, 64>, 64, 64, 128, ring_bytes<T>(64, 64) + 1024, a, s);
      case 3: return launch_kernel(conv_wgmma<T, 256, 128>, 256, 128, 512, ring_bytes<T>(256, 128) + 1024, a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (tile) {
    case 0: return launch_kernel(conv_mma<T, 128, 128, 64, 32>, 128, 128, 256, ring_bytes<T>(128, 128), a, s);
    case 1: return launch_kernel(conv_mma<T, 128, 64, 32, 32>, 128, 64, 256, ring_bytes<T>(128, 64), a, s);
    case 2: return launch_kernel(conv_mma<T, 64, 64, 32, 16>, 64, 64, 256, ring_bytes<T>(64, 64), a, s);
    default: return cudaErrorInvalidValue;
  }
}

// One layer on `stream`. `bf16`: T is __nv_bfloat16, else float.
inline cudaError_t launch_layer(bool bf16, int tile, bool vec, const ConvArgs& a,
                                cudaStream_t stream) {
  if (a.split < 1 || a.split > 8 || a.KS < 1 || a.C < 1 || a.CO < 1) return cudaErrorInvalidValue;
  const int bk = bf16 ? Elem<__nv_bfloat16>::BK : Elem<float>::BK;
  if (a.Kp % bk != 0 || a.Kp < a.K || (vec && a.C % bk != 0)) return cudaErrorInvalidValue;
  return bf16 ? launch_typed<__nv_bfloat16>(tile, vec, a, stream)
              : launch_typed<float>(tile, vec, a, stream);
}

}  // namespace tcg
