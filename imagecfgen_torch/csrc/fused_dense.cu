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
// Bound on this card. At the AudioMNIST classifier head (M = batch 128,
// K = 4096, N = 1024) the layer does 1.074 GFLOP and must move 19.4 MB in
// f32 (x 2.1 MB, w 16.8 MB, y 0.5 MB), 9.7 MB in bf16. In f32 (3xTF32, a
// third of the TF32 rate) it is bound by operations, in bf16 by bytes; at
// that size the launch itself is a fair share of the time.
//
// Design. A dense layer is a 1 x 1 conv over a 1 x 1 image with M = batch
// rows, so it runs the encoder's staged tensor-core main loop (tc_gemm.cuh):
// wgmma.mma_async (3xTF32 for f32 tensors, bf16 for bf16 tensors), a
// cp.async ring of K slices, w packed K-major as stored (the port's (N, K)
// layout; for f32 split once into tf32 hi and lo parts by the wrapper, and
// padded where K is ragged). At the head's shape the whole of M is one tile
// row, 128 x 64 tiles number 16, and K is split over a cluster of 8 blocks
// (128 blocks for 132 SMs) whose partial tiles are summed in rank order
// through distributed shared memory before the bias, LeakyReLU and the only
// store of y: one launch, no scratch buffer, the same bits on every run.
// Shapes with enough tiles take no split. Rows of x whose stride is not a
// multiple of the slice depth (a ragged K) take the masked scalar gather
// with mma.sync, inside the kernel.
//
// Built by imagecfgen_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes; the C entry point returns cudaGetLastError().

#include "tc_gemm.cuh"

// y (M, N) = lrelu(x (M, K) @ w (N, K)^T + b (N,), slope) on `stream`, all
// row-major, contiguous and of one type (bf16: 0 float, 1 __nv_bfloat16).
// `w_hi` (and for f32 `w_lo`) are w packed with row stride Kp >= K, a
// multiple of the slice depth, zero beyond K. `tile`, `split` and `vec` are
// the launch plan. Returns cudaGetLastError() after the launch.
extern "C" int fused_dense_run(const void* x, const void* w_hi, const void* w_lo, const void* b,
                               void* y, int bf16, int M, int N, int K, int Kp, float slope,
                               int tile, int split, int vec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  tcg::ConvArgs a;
  a.x = x;
  a.w_hi = w_hi;
  a.w_lo = w_lo;
  a.bias = b;
  a.y = y;
  a.batch = M;
  a.H = a.W = a.OH = a.OW = 1;
  a.C = K;
  a.CO = N;
  a.KS = 1;
  a.stride = 1;
  a.pad = 0;
  a.K = K;
  a.Kp = Kp;
  a.act = 1;
  a.slope = slope;
  a.split = split;
  const cudaError_t err =
      tcg::launch_layer(bf16 != 0, tile, vec != 0, a, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
