// What the three tensor-core kernels of the port share (fused_encoder.cu,
// fused_dense.cu), and the main loop of every conv layer but a trunk's first:
// y = act(conv(x, w) + b) on Hopper as an implicit GEMM.
//
//   M = batch * OH * OW output pixels, N = CO channels, K = KS * KS * C taps.
//   A (M x K) is gathered on the fly from the NHWC input (zero outside the
//   image and past a ragged batch); B (N x K) is the weight matrix packed
//   K-major by the wrapper (row stride Kp, K padded with zeros to a multiple
//   of the slice depth).
//
// The kernels:
//   conv_wgmma   (here) layers whose C is a multiple of the slice depth: every
//                layer of a trunk at the default width but its first;
//                replaces the TPU kernel's `_conv_block` from layer 2 on;
//   conv_window  (fused_encoder.cu) the layers whose C is not (a trunk's first
//                layer: 2, 3, 5 or 7 channels; the second to fourth of a
//                narrow trunk): persistent blocks, the weights resident in
//                shared memory, the im2col fragments built from an input
//                window in shared memory. A layer whose weights and window
//                would not fit there (C = 16 or 48 in f32, say) runs
//                conv_wgmma instead, its input padded by the wrapper with
//                zero channels to the slice depth: the layer before writes
//                them from zero weights and bias;
//   dense_tma    (fused_dense.cu) the dense head: the weight streamed once by
//                TMA, a small batch as the wgmma's n.
//
// Types. T = __nv_bfloat16: bf16 products (m64nNk16) with f32 accumulators.
// T = float: 3xTF32 (m64nNk8). Every operand v is split into hi = tf32(v)
// and lo = tf32(v - hi), and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is accumulated
// in f32, small terms first. That keeps f32-level accuracy; single-pass TF32
// is never used. The epilogue adds the bias, applies LeakyReLU and rounds
// once to T.
//
// Promotion (float32). The tensor cores truncate when they add into a
// float32 accumulator, and along a long K the truncations add up toward zero.
// So a chain of tensor-core sums is kept short and the chains are added with
// float32 FADDs, which round to nearest: every float32 kernel begins a fresh
// accumulator (scale-d 0) every K slice and adds it into a second register
// array after the wgmma wait that float32 makes on every slice anyway;
// conv_window, whose K is only a few slices, every half slice, its large
// terms a_hi*b_hi added last. The
// 512-thread conv_wgmma tile has no registers for that array, and the plan
// gives it bf16 layers only. bf16 keeps one sum: its outputs round to 8 bits,
// hundreds of times the drift, and a promoted bf16 loop measured 13 % slower.
//
// Staging (conv_wgmma). A ring of STAGES tiles in dynamic shared memory, one
// K slice of 128 bytes per row and stage (32 floats or 64 bf16), filled by
// 16-byte cp.async copies with zero-fill, so loads for later slices are in
// flight while a slice multiplies; one __syncthreads per slice. Rows are 128
// bytes and the 16-byte chunk c of row r sits at chunk c ^ (r & 7): that is
// the 128-byte-swizzled K-major layout wgmma's descriptors name (and TMA's
// SWIZZLE_128B writes), and it keeps the fragment loads and the cp.async
// stores free of bank conflicts. A slice lies inside one tap: (kh, kw, ci)
// advance by increments, one predicate per row decides validity and the
// loads are 16 bytes along ci.
//
// Epilogue and split K. A block leaves its f32 tile in shared memory (the
// ring is free by then) and stores it from there, 16 bytes a thread along a
// row. Where a layer has fewer tiles than the card has SMs, the grid's z
// dimension splits the K slices over a thread-block cluster (up to 8
// blocks): after a cluster barrier block r sums rows [r*BM/S, (r+1)*BM/S) of
// all S partial tiles through distributed shared memory in rank order
// before the bias, LeakyReLU and the store: one launch, no scratch in
// device memory, no atomics, the same bits on every run. dense_tma ends the
// same way.
//
// The launch plans are chosen in Python (imagecfgen_torch/ops/tensor_core.py:
// plan_gemm, plan_window, plan_dense) and handed in.

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
// Reads and writes of an accumulator stay after a wgmma wait: the compiler
// does not see that the asynchronous wgmma writes those registers.
template <int N> __device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// generic-proxy writes (cp.async) become visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(add));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(add));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(add));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[8], uint64_t desc_a, uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(add));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, "
      "{%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add));
}

// ------------------------------------------------------- mbarrier and TMA
// A transaction barrier in shared memory: a TMA copy signals the bytes it
// landed, threads arrive, waiters spin on the phase's parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// a 2-D tile of a tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// a barrier of `threads` threads (a warpgroup's), apart from __syncthreads' 0
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
// PROMOTE (float32): every K slice the tensor cores' sum is added into the
// float32 sum that the tile leaves for its epilogue. It doubles the
// accumulator's registers, which fits under the 255 a thread of 256 threads
// or fewer, not under the 128 of 512 threads (tools/tile_registers.py builds
// that case); launch_typed never instantiates it.
template <typename T, int BM, int BN, bool PROMOTE = sizeof(T) == 4>
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

  // acc: the tensor cores' sum; PROMOTE: of the current K slice only, begun
  // afresh by its first wgmma (scale-d 0), and sum: the slices' sum, added in
  // float32 FADDs that round to nearest.
  float acc[NACC], sum[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = sum[i] = 0.f;

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
        wgmma_tf32(acc, a_lo[ks], desc_b + 2 * ks, ks > 0 || !PROMOTE);
        wgmma_tf32(acc, a_hi[ks], desc_b_lo + 2 * ks, 1);
        wgmma_tf32(acc, a_hi[ks], desc_b + 2 * ks, 1);
      }
    } else {
      const uint64_t desc_a = smem_desc(smem_addr(a_tile + wg_row0 * 128));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_bf16(acc, desc_a + 2 * ks, desc_b + 2 * ks, ks > 0 || !PROMOTE);
    }
    wgmma_commit();
    if constexpr (PROMOTE) {
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int i = 0; i < NACC; ++i) sum[i] += acc[i];
    } else {
      wgmma_wait<INFLIGHT>();
    }
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  fence_operands(acc);
  if constexpr (!PROMOTE) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) sum[i] = acc[i];
  }

  // accumulator i: row row0 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * t + (i & 1)
  cg::cluster_group cluster = cg::this_cluster();
  float* part = reinterpret_cast<float*>(ring);
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < NACC; i += 2)
    *reinterpret_cast<float2*>(part + (row0 + ((i >> 1) & 1) * 8) * (BN + PART_PAD) +
                               (i >> 2) * 8 + 2 * t) = make_float2(sum[i], sum[i + 1]);
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

// The tile shapes of conv_wgmma's launch plan, by index (tensor_core.py::TILES);
// + 1024: the ring is moved up to a 1024-byte boundary.
template <typename T>
cudaError_t launch_typed(int tile, const ConvArgs& a, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_kernel(conv_wgmma<T, 128, 128>, 128, 128, 256, ring_bytes<T>(128, 128) + 1024, a, s);
    case 1: return launch_kernel(conv_wgmma<T, 128, 64>, 128, 64, 256, ring_bytes<T>(128, 64) + 1024, a, s);
    case 2: return launch_kernel(conv_wgmma<T, 64, 64>, 64, 64, 128, ring_bytes<T>(64, 64) + 1024, a, s);
    case 3:  // no promoted sum: bf16 only (the plan never gives float32 this tile)
      if constexpr (sizeof(T) == 4) return cudaErrorInvalidValue;
      else return launch_kernel(conv_wgmma<T, 256, 128>, 256, 128, 512, ring_bytes<T>(256, 128) + 1024, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// One conv_wgmma layer on `stream`. `bf16`: T is __nv_bfloat16, else float.
inline cudaError_t launch_layer(bool bf16, int tile, const ConvArgs& a, cudaStream_t stream) {
  if (a.split < 1 || a.split > 8 || a.KS < 1 || a.C < 1 || a.CO < 1) return cudaErrorInvalidValue;
  const int bk = bf16 ? Elem<__nv_bfloat16>::BK : Elem<float>::BK;
  if (a.Kp % bk != 0 || a.Kp < a.K || a.C % bk != 0) return cudaErrorInvalidValue;
  return bf16 ? launch_typed<__nv_bfloat16>(tile, a, stream) : launch_typed<float>(tile, a, stream);
}

}  // namespace tcg
