// One layer of the float fully-connected PNN, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fc_forward_pallas` of the JAX package
// (context_adaptive_neural_network_based_prediction_tpu/ops/pallas/
// fc_forward.py:83, body :47-61).  That kernel runs the whole chain
// 5w^2 -> 1200 -> 1200 -> 1200 -> w^2 in one call, every weight resident in
// the TPU's VMEM.  Here each layer is one launch of
//   out[r, c] = act(sum_k x[r, k] * w[k, c] + b[c]),  act(h) = max(0.1 h, h)
// on layers 0-2 and the identity on layer 3: four launches per forward.
// x (N, K) float32, w (K, D) float32 or bfloat16 (the template parameter;
// bfloat16 is widened to float32 exactly, as the TPU kernel's
// `astype(float32)`), b (D,) float32, out (N, D) float32; f32 accumulation.
// The sum runs over k in order with fused multiply-adds, then the bias is
// added, then the activation: the order of `dot + bias` in the JAX package.
//
// Design.  A tiled SIMT GEMM: a 256-thread block computes a 64 x 64 tile of
// out, each thread a 4 x 4 register tile; the block walks K in steps of 16,
// staging a 64 x 16 tile of x (transposed) and a 16 x 64 tile of w in
// shared memory.  Ragged N, K (80, 320, 1200) and D (16, 64, 1200) are
// masked with bounds checks (zeros in the staged tiles), not padded to 128
// lanes.  The epilogue adds the bias and applies the activation before the
// tile is stored.  No tensor cores (wgmma) and no TMA: that is later work.
//
// What bounds it.  Why not one kernel for the chain: at w = 8 the weights
// are 6.7 MB in bf16 and 13.4 MB in f32, far above a block's 227 KB of
// shared memory, so a layer's activations go through device memory (they
// stay in the 50 MB L2 at N <= 2048).  A layer at N = 1024, K = D = 1200
// does 2.9 G float operations against 15.6 MB moved: the card's f32 rate
// (67 T/s outside the tensor cores) bounds it, about 44 us; the w^2-wide
// last layer and the 80-wide first layer of w = 4 are bound by bytes.  The
// wrapper (ops/fc_forward.py) counts launches per (K, D) in
// `fc_forward.launches`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of x per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // depth of one staged step
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr float SLOPE = 0.1f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
fc_layer_kernel(int n, int k, int d, int act, const float* __restrict__ x,
                const WT* __restrict__ w, const float* __restrict__ b,
                float* __restrict__ out) {
  __shared__ float xs[BK][BM + 4];    // x tile, transposed: xs[kk][row]
  __shared__ float ws[BK][BN + 4];    // w tile: ws[kk][col]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // Stage x[row0 .. +64, k0 .. +16]: 16 consecutive k of a row per 16
    // threads.
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < n && gk < k) ? x[(size_t)gr * k + gk] : 0.0f;
    }
    // Stage w[k0 .. +16, col0 .. +64]: 64 consecutive columns per row.
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < k && gc < d) ? widen(w[(size_t)gk * d + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bb[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= d) continue;
      float v = acc[i][j] + b[c];
      if (act) v = fmaxf(SLOPE * v, v);
      out[(size_t)r * d + c] = v;
    }
  }
}

template <typename WT>
int launch(int n, int k, int d, int act, const void* x, const void* w,
           const void* b, void* out, cudaStream_t stream) {
  const dim3 grid((d + BN - 1) / BN, (n + BM - 1) / BM);
  fc_layer_kernel<WT><<<grid, THREADS, 0, stream>>>(
      n, k, d, act, (const float*)x, (const WT*)w, (const float*)b,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// w_bf16: 0 for float32 weights, 1 for bfloat16; act: 1 applies the
// LeakyReLU.  Returns a cudaError_t (0 on success).
extern "C" int fc_forward(int n, int k, int d, int w_bf16, int act,
                          const void* x, const void* w, const void* b,
                          void* out, void* stream) {
  if (n < 1 || k < 1 || d < 1 || n > 65535 * BM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return w_bf16 ? launch<__nv_bfloat16>(n, k, d, act, x, w, b, out, s)
                : launch<float>(n, k, d, act, x, w, b, out, s);
}

extern "C" const char* fc_forward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
