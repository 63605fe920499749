// A dense layer with bias and LeakyReLU on Hopper: y = lrelu(x @ w^T + b),
// on the tensor cores, in one launch.
//
// Replaces the TPU kernel `_pallas_forward` in
// imagecfgen_tpu/ops/pallas/fused_dense.py (body `_matmul_kernel`), which
// walks (M/128, N/512) output tiles with the K loop as the innermost grid
// dimension, sums 512-deep K tiles into a VMEM accumulator on the MXU (f32
// or bf16 operands, f32 accumulation) and applies the bias and LeakyReLU
// after the last K tile.
//
// Bound on this card. The heads' shapes are a small batch against a large
// weight: M = 7-256 rows of x, K = 4096, N = 1024. At M = 128 the layer does
// 1.074 GFLOP and must move 19.4 MB in f32 (w 16.8 MB of it), 9.7 MB in
// bf16: bf16 is bound by bytes (0.0029 ms at 3.35 TB/s), f32 by operations
// (3xTF32 at a third of the TF32 rate: 0.0065 ms); below M = 128 both are
// bound by the weight's bytes.
//
// Design: the weight is the stream. Operands are swapped (y^T = w x^T): w
// is wgmma's A, 64 rows of it (64 output columns) a block, and the block's
// x rows (up to 128) are the instruction's n, so every x row a block holds
// meets every w row that it streams, and w goes through shared memory once.
// Each block takes a range of K slices (the grid's z, a thread-block
// cluster of up to 8 blocks), so that most SMs stream their own part of w.
// The split is the one that puts the most blocks on the card in one wave:
// the SMs of a GPC hold whole clusters, and an H100 runs only 15 clusters
// of 8 such blocks at once, so the head's 16 column tiles take clusters of
// 6 (96 blocks) rather than a second wave (fused_dense_clusters counts
// them for the plan). A producer warp starts one TMA copy of w's slice (64 rows x 128
// bytes, swizzled as wgmma reads it) and one of x's slice a stage into a ring
// of 5 (f32) or 8 (bf16) stages, most of a block's share in flight at once,
// each completing on its own mbarrier; two consumer warpgroups take the
// slices in turn. bf16: both operands from shared memory through
// descriptors. f32: w read into registers and split into tf32 hi and lo
// there (w streams as stored, once; no packed hi/lo copy), x split in place
// into hi and lo tiles; a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, the float32 sum
// promoted out of the tensor cores every slice. Where x's rows are no whole
// number of 16 bytes (a ragged K) the consumers copy its slices themselves.
// The two consumers' sums meet in shared memory (warpgroup 0's, then 1's
// added), then the cluster's partial tiles in rank order through distributed
// shared memory, every load started before the first add, before the bias,
// LeakyReLU and the only store of y: no scratch buffer, no atomics, the same
// bits on every run.
//
// Built by imagecfgen_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes; the C entry point returns cudaGetLastError(). The
// tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint (no link to libcuda).

#include <cuda.h>
#include <string.h>

#include "tc_gemm.cuh"

namespace tcg {

constexpr int DENSE_WROWS = 64;                // w rows (output columns) a block
constexpr int DENSE_THREADS = 2 * 128 + 32;    // two consumer warpgroups, a producer warp

template <typename T> struct DenseRing;
template <> struct DenseRing<float> { static constexpr int STAGES = 5; };
template <> struct DenseRing<__nv_bfloat16> { static constexpr int STAGES = 8; };

struct DenseArgs {
  const void* x;     // (M, K), row-major
  const void* bias;  // (N,)
  void* y;           // (M, N), row-major
  int M, N, K, Kp;   // Kp: w's packed row length, a multiple of the slice depth
  float slope;
  int split;         // blocks along z == cluster size, 1..8
  int x_tma;         // x's slices by TMA (rows of whole 16-byte chunks), else by the consumers
};

// The x tile of one slice as the consumers leave it for wgmma: f32 split in
// place into hi, lo into the next tile; from global memory where x has no
// tensor map. Chunk c: row c / 8, 16-byte chunk c % 8 of the row.
template <typename T, int NX>
__device__ __forceinline__ void build_x(const DenseArgs& p, unsigned char* xt, int m0, int k0, int wtid) {
  constexpr int E = 16 / sizeof(T);
  for (int c = wtid; c < NX * 8; c += 128) {
    const int r = c >> 3;
    const int off = swz(r, (c & 7) * 16);
    __align__(16) T v[E];
    if (p.x_tma) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(xt + off);
    } else {
      const int m = m0 + r, k = k0 + (c & 7) * E;
      const T* src = static_cast<const T*>(p.x) + (size_t)m * p.K + k;
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = m < p.M && k + e < p.K ? src[e] : T(0.f);
    }
    if constexpr (sizeof(T) == 4) {
      __align__(16) uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = to_tf32(to_float(v[e]));
        lo[e] = to_tf32(to_float(v[e]) - __uint_as_float(hi[e]));
      }
      *reinterpret_cast<uint4*>(xt + off) = *reinterpret_cast<const uint4*>(hi);
      *reinterpret_cast<uint4*>(xt + NX * 128 + off) = *reinterpret_cast<const uint4*>(lo);
    } else {
      *reinterpret_cast<uint4*>(xt + off) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// The epilogue: block `rank` of the cluster sums rows [rank*NX/S, (rank+1)*NX/S)
// of the S partial tiles in rank order, every load of its S tiles started
// before the first add (distributed shared memory is slow to answer), adds
// the bias, applies LeakyReLU, rounds once to T and stores 16 bytes a thread.
template <typename T, int NX>
__device__ __forceinline__ void dense_finish(const DenseArgs& p, cg::cluster_group& cluster, float* part,
                                             int m0, int n0, int tid) {
  constexpr int V = 16 / sizeof(T);  // columns a thread stores
  constexpr int LD = DENSE_WROWS + PART_PAD;
  constexpr int VECS = DENSE_WROWS / V;
  const int rank = p.split > 1 ? (int)cluster.block_rank() : 0;
  const int rows = (NX + p.split - 1) / p.split;
  const int r_begin = min(NX, rank * rows), r_end = min(NX, r_begin + rows);
  const float* src[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) src[q] = q < p.split && p.split > 1 ? cluster.map_shared_rank(part, q) : part;
  const T* bias = static_cast<const T*>(p.bias);
  for (int i = r_begin * VECS + tid; i < r_end * VECS; i += DENSE_THREADS) {
    const int r = i / VECS, c = (i % VECS) * V;
    const int m = m0 + r, n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    float4 f[8][V / 4];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < p.split)
#pragma unroll
        for (int j = 0; j < V / 4; ++j) f[q][j] = *reinterpret_cast<const float4*>(src[q] + r * LD + c + 4 * j);
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < p.split)
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        v[4 * j] += f[q][j].x;
        v[4 * j + 1] += f[q][j].y;
        v[4 * j + 2] += f[q][j].z;
        v[4 * j + 3] += f[q][j].w;
      }
    T* yrow = static_cast<T*>(p.y) + (size_t)m * p.N;
    if (n + V <= p.N && p.N % V == 0) {
      __align__(16) T out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float o = v[j] + to_float(bias[n + j]);
        from_float(out + j, o >= 0.f ? o : p.slope * o);
      }
      *reinterpret_cast<uint4*>(yrow + n) = *reinterpret_cast<const uint4*>(out);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (n + j >= p.N) continue;
        const float o = v[j] + to_float(bias[n + j]);
        from_float(yrow + n + j, o >= 0.f ? o : p.slope * o);
      }
    }
  }
}

// One block: w rows [n0, n0 + 64) by x rows [m0, m0 + NX) over the K slices
// of blockIdx.z.
template <typename T, int NX>
__global__ void __launch_bounds__(DENSE_THREADS, 1)
dense_tma(const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_x,
          const DenseArgs p) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BK = Elem<T>::BK;
  constexpr int STAGES = DenseRing<T>::STAGES;
  constexpr int W_BYTES = DENSE_WROWS * 128;
  constexpr int X_BYTES = NX * 128;
  constexpr int STAGE_BYTES = W_BYTES + (F32 ? 2 : 1) * X_BYTES;
  constexpr int NACC = NX / 2;
  static_assert(STAGES * STAGE_BYTES >= NX * (DENSE_WROWS + PART_PAD) * 4,
                "the partial tile does not fit the ring");

  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ __align__(8) uint64_t loaded[STAGES], empty[STAGES];
  unsigned char* ring = ring_raw + ((1024 - (smem_addr(ring_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * DENSE_WROWS;
  const int m0 = blockIdx.y * NX;
  const int total = p.Kp / BK;
  const int per = (total + p.split - 1) / p.split;
  const int s_begin = blockIdx.z * per;
  const int nslices = max(0, min(total, s_begin + per) - s_begin);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&empty[s], 4);  // the four warps of the warpgroup that read the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  float sum[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) sum[i] = 0.f;
  if (warp == 8) {  // the producer: one lane starts every copy
    if (lane == 0) {
      for (int j = 0; j < nslices; ++j) {
        const int s = j % STAGES, u = j / STAGES;
        if (u > 0) mbar_wait(&empty[s], (u - 1) & 1);
        unsigned char* st = ring + s * STAGE_BYTES;
        const int k = (s_begin + j) * BK;
        mbar_expect_tx(&loaded[s], W_BYTES + (p.x_tma ? X_BYTES : 0));
        tma_load_2d(st, &map_w, &loaded[s], k, n0);
        if (p.x_tma) tma_load_2d(st + W_BYTES, &map_x, &loaded[s], k, m0);
      }
    }
  } else {  // consumer warpgroup wg takes slices wg, wg + 2, ...
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = (warp & 3) * 16 + g;  // this thread's first w row of the tile
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    for (int j = wg; j < nslices; j += 2) {
      const int s = j % STAGES;
      mbar_wait(&loaded[s], (j / STAGES) & 1);
      unsigned char* st = ring + s * STAGE_BYTES;
      unsigned char* xt = st + W_BYTES;
      if (F32 || !p.x_tma) {
        build_x<T, NX>(p, xt, m0, (s_begin + j) * BK, tid & 127);
        fence_async_proxy();
        named_sync(1 + wg, 128);
      }
      const uint64_t dx = smem_desc(smem_addr(xt));
      if constexpr (F32) {
        const uint64_t dx_lo = smem_desc(smem_addr(xt + X_BYTES));
        uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int kb0 = (ks * 8 + t) * 4, kb1 = kb0 + 16;
          const float v[4] = {
              *reinterpret_cast<const float*>(st + swz(row0, kb0)),
              *reinterpret_cast<const float*>(st + swz(row0 + 8, kb0)),
              *reinterpret_cast<const float*>(st + swz(row0, kb1)),
              *reinterpret_cast<const float*>(st + swz(row0 + 8, kb1)),
          };
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a_hi[ks][e] = to_tf32(v[e]);
            a_lo[ks][e] = to_tf32(v[e] - __uint_as_float(a_hi[ks][e]));
          }
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // small terms first; a fresh sum every slice
          wgmma_tf32(acc, a_lo[ks], dx + 2 * ks, ks > 0);
          wgmma_tf32(acc, a_hi[ks], dx_lo + 2 * ks, 1);
          wgmma_tf32(acc, a_hi[ks], dx + 2 * ks, 1);
        }
      } else {
        const uint64_t dw = smem_desc(smem_addr(st));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_bf16(acc, dw + 2 * ks, dx + 2 * ks, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      if constexpr (F32) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) sum[i] += acc[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if constexpr (!F32) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) sum[i] = acc[i];
    }
  }

  // accumulator i: w row row0 + 8 * ((i >> 1) & 1), x row 8 * (i >> 2) + 2t + (i & 1);
  // the tile is left as y's (x row, w row) layout
  constexpr int LD = DENSE_WROWS + PART_PAD;
  float* part = reinterpret_cast<float*>(ring);
  __syncthreads();  // every stage is consumed: the ring is free
  auto put = [&](bool add) {
    const int g = lane >> 2, t = lane & 3;
    const int row0 = (warp & 3) * 16 + g;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      float* dst = part + (8 * (i >> 2) + 2 * t + (i & 1)) * LD + row0 + 8 * ((i >> 1) & 1);
      *dst = add ? *dst + sum[i] : sum[i];
    }
  };
  if (warp < 4) put(false);
  __syncthreads();
  if (warp >= 4 && warp < 8) put(true);
  cg::cluster_group cluster = cg::this_cluster();
  if (p.split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  dense_finish<T, NX>(p, cluster, part, m0, n0, tid);
  if (p.split > 1) cluster.sync();  // no block leaves while its partial tile is being read
}

// static: each library keeps its own `ready` flag
template <typename T, int NX> constexpr int dense_smem() {
  return DenseRing<T>::STAGES * (DENSE_WROWS * 128 + (sizeof(T) == 4 ? 2 : 1) * NX * 128) + 1024;
}

// The launch of a grid of (n tiles, m tiles, split) in clusters of `split`;
// static: each library keeps its own `ready` flag.
template <typename T, int NX>
static cudaError_t dense_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int n_tiles, int m_tiles,
                                int split) {
  static bool ready = false;  // the shared-memory limit is raised once per instantiation
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(dense_tma<T, NX>, cudaFuncAttributeMaxDynamicSharedMemorySize, dense_smem<T, NX>());
    if (err != cudaSuccess) return err;
    ready = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)n_tiles, (unsigned)m_tiles, (unsigned)split);
  cfg->blockDim = dim3(DENSE_THREADS);
  cfg->dynamicSmemBytes = dense_smem<T, NX>();
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)split;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int NX>
static cudaError_t launch_dense(const CUtensorMap& mw, const CUtensorMap& mx, const DenseArgs& a,
                                cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = dense_config<T, NX>(&cfg, attr, (a.N + DENSE_WROWS - 1) / DENSE_WROWS,
                                              (a.M + NX - 1) / NX, a.split);
  if (err != cudaSuccess) return err;
  cfg.stream = stream;
  return cudaLaunchKernelEx(&cfg, dense_tma<T, NX>, mw, mx, a);
}

// How many clusters of `split` blocks the card runs at once: the SMs of a
// GPC hold whole clusters, so on an H100 (132 SMs) only 15 clusters of 8
// fit, not 16, and a 16th waits for a second wave.
template <typename T, int NX> static int dense_clusters(int split) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  if (dense_config<T, NX>(&cfg, attr, 1, 1, split) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, dense_tma<T, NX>, &cfg) != cudaSuccess)
    return -1;
  return n;
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A row-major (rows, cols) tensor with rows `pitch` elements apart, read in
// boxes of one 128-byte slice by `box_rows` rows, 128-byte swizzled; zero
// beyond its edges.
static bool tensor_map(CUtensorMap* map, bool bf16, const void* base, int cols, int rows, int pitch,
                       int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int esize = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T> static int dense_clusters_typed(int nx, int split) {
  switch (nx) {
    case 16: return dense_clusters<T, 16>(split);
    case 32: return dense_clusters<T, 32>(split);
    case 64: return dense_clusters<T, 64>(split);
    case 128: return dense_clusters<T, 128>(split);
    default: return -1;
  }
}

template <typename T>
static cudaError_t launch_dense_typed(int nx, const CUtensorMap& mw, const CUtensorMap& mx, const DenseArgs& a,
                               cudaStream_t s) {
  switch (nx) {
    case 16: return launch_dense<T, 16>(mw, mx, a, s);
    case 32: return launch_dense<T, 32>(mw, mx, a, s);
    case 64: return launch_dense<T, 64>(mw, mx, a, s);
    case 128: return launch_dense<T, 128>(mw, mx, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tcg

// y (M, N) = lrelu(x (M, K) @ w (N, K)^T + b (N,), slope) on `stream`, all
// row-major and of one type (bf16: 0 float, 1 __nv_bfloat16); x contiguous.
// `w` is the weight packed with row stride Kp >= K, a multiple of the slice
// depth, zero beyond K, 16-byte aligned. `nx` (x rows a block: 16, 32, 64
// or 128) and `split` (K split, 1..8) are the launch plan. Returns
// cudaGetLastError() after the launch.
extern "C" int fused_dense_run(const void* x, const void* w, const void* b, void* y, int bf16, int M,
                               int N, int K, int Kp, float slope, int nx, int split, void* stream) {
  const int esize = bf16 ? 2 : 4;
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % (128 / esize) != 0 || split < 1 || split > 8 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  tcg::DenseArgs a;
  a.x = x;
  a.bias = b;
  a.y = y;
  a.M = M;
  a.N = N;
  a.K = K;
  a.Kp = Kp;
  a.slope = slope;
  a.split = split;
  a.x_tma = (K * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  CUtensorMap mw, mx;
  memset(&mw, 0, sizeof(mw));
  memset(&mx, 0, sizeof(mx));
  if (!tcg::tensor_map(&mw, bf16 != 0, w, Kp, N, Kp, tcg::DENSE_WROWS) ||
      (a.x_tma && !tcg::tensor_map(&mx, bf16 != 0, x, K, M, K, nx)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? tcg::launch_dense_typed<__nv_bfloat16>(nx, mw, mx, a, s)
                               : tcg::launch_dense_typed<float>(nx, mw, mx, a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The clusters of `split` blocks (1..8) of the kernel with `nx` x rows a
// block that the card runs at once; -1 on an error. The plan keeps a grid
// within one such wave.
extern "C" int fused_dense_clusters(int bf16, int nx, int split) {
  if (split < 1 || split > 8) return -1;
  return bf16 ? tcg::dense_clusters_typed<__nv_bfloat16>(nx, split) : tcg::dense_clusters_typed<float>(nx, split);
}
