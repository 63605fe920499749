// The MNIST BiGAN encoder trunk on Hopper: a stack of strided convs, each
// with bias and (optionally) LeakyReLU applied in the kernel's epilogue.
//
// Replaces the TPU kernel `_pallas_encoder` in
// imagecfgen_tpu/ops/pallas/fused_encoder.py (body `_encoder_kernel` and
// `_conv_block`), which keeps the whole trunk in VMEM and computes each conv
// as K*K parity-sliced MXU matmuls.
//
// Bound on this card. At the full-width MNIST trunk (5 -> 64 -> 128 -> 256 ->
// 512 -> latent 512) one sample costs 14,064,896 MACs (28.1 MFLOP) against
// about 23.5 KB of traffic (15.7 KB input, 2 KB output, the 12.1 MB of weights
// shared by the batch): about 1,200 FLOP per byte at B = 2048. In f32 on the
// CUDA cores the trunk is bound by operations, not bytes.
//
// Design. Each conv is one implicit GEMM, M = B*OH*OW output pixels by
// N = Cout channels over K = KH*KW*Cin taps, launched once per layer on the
// caller's stream. A block stages a BK-deep slice of the im2col patch
// (gathered on the fly from the NHWC input, zero outside the image and past
// a ragged batch) and of the HWIO weights in shared memory, and each thread
// keeps a TM x TN register tile of f32 accumulators, so every value read from
// shared memory feeds TM or TN fused multiply-adds. The epilogue adds the
// bias and applies LeakyReLU before the only store of the output. Layers
// whose grid would not fill the card twice over take a smaller block tile.
// Intermediates between layers go through device memory (scratch that the
// caller allocates); keeping them on chip, tensor cores (TF32 or bf16 wgmma)
// and TMA are later work.
//
// Built by imagecfgen_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BK = 16;   // reduction depth staged per step
constexpr int APAD = 4;  // shared-memory row padding for the A tile

template <int KS, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv_bias_lrelu(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y,
                int batch, int H, int W, int C, int OH, int OW, int CO,
                int stride, int pad, int act, float slope) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int A_ROWS = NT / BK;     // output pixels loaded per pass
  constexpr int A_PER = BM / A_ROWS;  // A loads per thread and step
  constexpr int B_ROWS = NT / BN;     // weight rows loaded per pass
  constexpr int B_PER = BK / B_ROWS;  // B loads per thread and step
  static_assert(NT % BK == 0 && BM % A_ROWS == 0, "A tile does not divide");
  static_assert(NT % BN == 0 && BK % B_ROWS == 0, "B tile does not divide");

  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int M = batch * OH * OW;
  const int K = KS * KS * C;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loads: each thread owns one reduction lane and A_PER output pixels,
  // decoded once; neighbouring lanes read neighbouring input channels.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  size_t a_base[A_PER];
  int a_ih[A_PER], a_iw[A_PER];
#pragma unroll
  for (int j = 0; j < A_PER; ++j) {
    const int m = m0 + a_m + j * A_ROWS;
    if (m < M) {
      const int b = m / (OH * OW);
      const int r = m - b * (OH * OW);
      const int oh = r / OW;
      const int ow = r - oh * OW;
      a_base[j] = (size_t)b * H * W * C;
      a_ih[j] = oh * stride - pad;
      a_iw[j] = ow * stride - pad;
    } else {  // past a ragged batch: every tap falls outside the image
      a_base[j] = 0;
      a_ih[j] = -(1 << 28);
      a_iw[j] = -(1 << 28);
    }
  }
  // B loads: one output channel, B_PER reduction rows.
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const bool b_nvalid = n0 + b_n < CO;

  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int k = k0 + a_k;
      const bool kvalid = k < K;
      const int tap = kvalid ? k / C : 0;
      const int ci = k - tap * C;
      const int kh = tap / KS;
      const int kw = tap - kh * KS;
#pragma unroll
      for (int j = 0; j < A_PER; ++j) {
        const int ih = a_ih[j] + kh;
        const int iw = a_iw[j] + kw;
        float v = 0.f;
        if (kvalid && (unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W)
          v = x[a_base[j] + ((size_t)ih * W + iw) * C + ci];
        As[a_k][a_m + j * A_ROWS] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int kk = b_k + j * B_ROWS;
      const int k = k0 + kk;
      Bs[kk][b_n] = (b_nvalid && k < K) ? w[(size_t)k * CO + n0 + b_n] : 0.f;
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

  // epilogue: bias + LeakyReLU, masked on the ragged edges
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= CO) continue;
      float v = acc[i][j] + bias[n];
      if (act) v = v >= 0.f ? v : slope * v;
      y[(size_t)m * CO + n] = v;
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_tile(int ks, dim3 grid, cudaStream_t stream, const float* x,
                        const float* w, const float* b, float* y, int batch,
                        int H, int W, int C, int OH, int OW, int CO, int stride,
                        int pad, int act, float slope) {
  const dim3 block((BM / TM) * (BN / TN));
#define FE_LAUNCH(KS)                                                        \
  conv_bias_lrelu<KS, BM, BN, TM, TN><<<grid, block, 0, stream>>>(           \
      x, w, b, y, batch, H, W, C, OH, OW, CO, stride, pad, act, slope);      \
  break;
  switch (ks) {
    case 1: FE_LAUNCH(1)
    case 2: FE_LAUNCH(2)
    case 3: FE_LAUNCH(3)
    case 4: FE_LAUNCH(4)
    case 5: FE_LAUNCH(5)
    default: return cudaErrorInvalidValue;
  }
#undef FE_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Runs layers [first, n_layers) of a conv stack on `stream`.
//   x            NHWC f32 input of layer `first`, shape (batch, H, W, C)
//   layer_ints   n_layers x 5 ints: kernel size, stride, padding, Cout, act
//   slopes       n_layers LeakyReLU slopes (read where act != 0)
//   weights      2 * n_layers device pointers: HWIO kernel, bias, per layer
//   outs         n_layers device pointers: NHWC output of each layer
// Returns cudaGetLastError() after the last launch, or the first error.
extern "C" int fused_encoder_run(const float* x, int batch, int H, int W,
                                 int C, int n_layers, int first,
                                 const int* layer_ints, const float* slopes,
                                 void* const* weights, void* const* outs,
                                 void* stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = x;
  for (int i = first; i < n_layers; ++i) {
    const int* li = layer_ints + 5 * i;
    const int ks = li[0], stride = li[1], pad = li[2], co = li[3], act = li[4];
    const int oh = (H + 2 * pad - ks) / stride + 1;
    const int ow = (W + 2 * pad - ks) / stride + 1;
    if (oh <= 0 || ow <= 0) return cudaErrorInvalidValue;
    const long long M = (long long)batch * oh * ow;
    const float* w = static_cast<const float*>(weights[2 * i]);
    const float* b = static_cast<const float*>(weights[2 * i + 1]);
    float* y = static_cast<float*>(outs[i]);
    const long long big_tiles = ((M + 127) / 128) * ((co + 63) / 64);
    cudaError_t err;
    if (big_tiles >= 2LL * sms) {
      const dim3 grid((unsigned)((M + 127) / 128), (unsigned)((co + 63) / 64));
      err = launch_tile<128, 64, 8, 4>(ks, grid, s, in, w, b, y, batch, H, W, C,
                                       oh, ow, co, stride, pad, act, slopes[i]);
    } else {
      const dim3 grid((unsigned)((M + 63) / 64), (unsigned)((co + 63) / 64));
      err = launch_tile<64, 64, 4, 4>(ks, grid, s, in, w, b, y, batch, H, W, C,
                                      oh, ow, co, stride, pad, act, slopes[i]);
    }
    if (err != cudaSuccess) return (int)err;
    in = y;
    H = oh;
    W = ow;
    C = co;
  }
  return (int)cudaGetLastError();
}
