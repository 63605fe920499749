// A dense layer with bias and LeakyReLU on Hopper: y = lrelu(x @ w^T + b).
//
// Replaces the TPU kernel `_pallas_forward` in
// imagecfgen_tpu/ops/pallas/fused_dense.py (body `_matmul_kernel`), which
// walks (M/128, N/512) output tiles with the K loop as the innermost grid
// dimension, sums 512-deep K tiles into a VMEM accumulator on the MXU and
// applies the bias and LeakyReLU after the last K tile.
//
// Bound on this card. At the AudioMNIST classifier head (M = batch 128,
// K = 4096, N = 1024, f32) the layer does 1.074 GFLOP and must move 19.4 MB
// (x 2.1 MB, w 16.8 MB, y 0.5 MB): about 55 FLOP per byte, above the f32
// CUDA cores' ridge of 20 (67 TFLOP/s over 3.35 TB/s). It is bound by
// operations, at 16.0 us on an H100 SXM, and at that size the launch itself
// is a fair share of the time.
//
// Design. Each block computes one 64 x 64 output tile: it stages a 16-deep
// slice of x (rows of the tile) and of w (its columns; w is the port's
// (N, K) dense kernel read as stored, K-major like x) in shared memory, and
// each of its 256 threads keeps a 4 x 4 register tile of f32 accumulators,
// so every value read from shared memory feeds four fused multiply-adds.
// Every load and store is masked, so any M, K and N is taken.
// At the head's shape a 64 x 64 tile gives 2 x 16 = 32 blocks for 132 SMs,
// so the K range is split: the split count is the SM count over the tile
// count, rounded up (5 at this shape, 160 blocks, every SM busy), and no
// split is shallower than 256. With one split the bias and LeakyReLU are
// applied in the GEMM's epilogue before its only store. With more, each
// split stores its partial tile to a scratch buffer that the caller
// allocates, and a second kernel sums the splits in a fixed order (the
// result does not depend on scheduling), adds the bias and applies
// LeakyReLU before the only store of y. Tensor cores (TF32 or bf16 wgmma),
// TMA and double-buffered staging are later work.
//
// Built by imagecfgen_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // reduction depth staged per step
constexpr int TM = 4;    // register tile rows per thread
constexpr int TN = 4;    // register tile columns per thread
constexpr int PAD = 4;   // shared-memory row padding
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads
constexpr int MIN_SPLIT_DEPTH = 256;

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// One 64 x 64 tile of x @ w^T over K range [split * k_chunk, +k_chunk).
// EPILOGUE: add the bias, apply LeakyReLU and store y; otherwise store the
// partial sums at out + split * M * N.
template <bool EPILOGUE>
__global__ void __launch_bounds__(NT)
dense_tile(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, float* __restrict__ out, int M,
           int N, int K, int k_chunk, float slope) {
  constexpr int ROWS = NT / BK;  // tile rows loaded per pass
  static_assert(NT % BK == 0 && BM % ROWS == 0 && BN % ROWS == 0,
                "load tiles do not divide");

  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  // loads: neighbouring threads read neighbouring k of one row
  const int l_k = tid % BK;
  const int l_r = tid / BK;

  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int k = k0 + l_k;
    const bool kvalid = k < k_end;
#pragma unroll
    for (int p = 0; p < BM / ROWS; ++p) {
      const int r = l_r + p * ROWS;
      const int m = m0 + r;
      As[l_k][r] = (kvalid && m < M) ? x[(size_t)m * K + k] : 0.f;
    }
#pragma unroll
    for (int p = 0; p < BN / ROWS; ++p) {
      const int r = l_r + p * ROWS;
      const int n = n0 + r;
      Bs[l_k][r] = (kvalid && n < N) ? w[(size_t)n * K + k] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = EPILOGUE ? out : out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      dst[(size_t)m * N + n] =
          EPILOGUE ? lrelu(acc[i][j] + bias[n], slope) : acc[i][j];
    }
  }
}

// y = lrelu(sum over splits of ws + bias): the epilogue of a split K range.
__global__ void splitk_bias_lrelu(const float* __restrict__ ws,
                                  const float* __restrict__ bias,
                                  float* __restrict__ y, int M, int N,
                                  int splits, float slope) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += ws[(size_t)s * total + i];
    y[i] = lrelu(v + bias[i % N], slope);
  }
}

// The number of K splits and the depth of each (a multiple of BK).
int plan_splits(int M, int N, int K, int* k_chunk) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  int splits = (int)((sms + tiles - 1) / tiles);
  const int deepest = K / MIN_SPLIT_DEPTH;
  if (splits > deepest) splits = deepest;
  if (splits < 1) splits = 1;
  int chunk = (K + splits - 1) / splits;
  chunk = (chunk + BK - 1) / BK * BK;
  if (chunk < BK) chunk = BK;
  *k_chunk = chunk;
  return (K + chunk - 1) / chunk > 1 ? (K + chunk - 1) / chunk : 1;
}

}  // namespace

// Floats of scratch that fused_dense_run needs for this shape (0: none).
extern "C" long long fused_dense_workspace(int M, int N, int K) {
  int chunk = 0;
  const int splits = plan_splits(M, N, K, &chunk);
  return splits > 1 ? (long long)splits * M * N : 0;
}

// y (M, N) = lrelu(x (M, K) @ w (N, K)^T + b (N,), slope) on `stream`, all
// f32, row-major and contiguous. `ws` holds fused_dense_workspace(M, N, K)
// floats (may be null when that is 0). Returns cudaGetLastError() after the
// last launch, or the first error.
extern "C" int fused_dense_run(const float* x, const float* w, const float* b,
                               float* y, float* ws, int M, int N, int K,
                               float slope, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int chunk = 0;
  const int splits = plan_splits(M, N, K, &chunk);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  if (splits == 1) {
    dense_tile<true><<<grid, NT, 0, s>>>(x, w, b, y, M, N, K, chunk, slope);
    return (int)cudaGetLastError();
  }
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  dense_tile<false><<<grid, NT, 0, s>>>(x, w, b, ws, M, N, K, chunk, slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)M * N;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 4096
                               ? (total + threads - 1) / threads
                               : 4096);
  splitk_bias_lrelu<<<blocks, threads, 0, s>>>(ws, b, y, M, N, splits, slope);
  return (int)cudaGetLastError();
}
