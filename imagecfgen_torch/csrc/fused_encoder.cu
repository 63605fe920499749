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
// rate.
//
// Design. Each conv is one implicit GEMM (tc_gemm.cuh), M = B*OH*OW output
// pixels by N = Cout channels over K = KH*KW*Cin taps, launched once per
// layer on the caller's stream: wgmma.mma_async tensor-core instructions
// (3xTF32 for f32 tensors, bf16 for bf16 tensors, f32 accumulators), a
// cp.async ring of K slices in shared memory, the im2col gather walked by
// increments with 16-byte loads along the input channels, mma.sync on a
// masked scalar gather for the first layer (5 or 7 channels), weights packed
// K-major once by the wrapper, and a split of K over a thread-block cluster,
// reduced through distributed shared memory, for layers with fewer tiles
// than SMs. Intermediates between layers go through device memory in the
// tensors' type (scratch that the caller allocates). The per-layer launch
// plan comes from Python.
//
// Built by imagecfgen_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes; the C entry point returns cudaGetLastError().

#include "tc_gemm.cuh"

// Runs layers [first, n_layers) of a conv stack on `stream`.
//   x            NHWC input of layer `first`, shape (batch, H, W, C)
//   bf16         element type of every tensor: 0 float, 1 __nv_bfloat16
//   layer_ints   n_layers x 9 ints: kernel size, stride, padding, Cout, act,
//                packed row stride Kp, tile index, K split, vector gather
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
    a.split = li[7];
    a.batch = batch;
    a.H = H;
    a.W = W;
    a.C = C;
    a.OH = (H + 2 * a.pad - a.KS) / a.stride + 1;
    a.OW = (W + 2 * a.pad - a.KS) / a.stride + 1;
    if (a.OH <= 0 || a.OW <= 0 || a.stride < 1) return (int)cudaErrorInvalidValue;
    a.K = a.KS * a.KS * C;
    a.slope = slopes[i];
    a.x = in;
    a.w_hi = weights[3 * i];
    a.w_lo = weights[3 * i + 1];
    a.bias = weights[3 * i + 2];
    a.y = outs[i];
    const cudaError_t err = tcg::launch_layer(bf16 != 0, li[6], li[8] != 0, a, s);
    if (err != cudaSuccess) return (int)err;
    in = a.y;
    H = a.OH;
    W = a.OW;
    C = a.CO;
  }
  return (int)cudaGetLastError();
}
