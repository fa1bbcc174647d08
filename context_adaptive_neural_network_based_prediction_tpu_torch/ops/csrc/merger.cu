// Float channelwise merger of the convolutional PNN, for Hopper (sm_90a).
//
// Replaces the TPU kernel `merger_forward` of the JAX package
// (context_adaptive_neural_network_based_prediction_tpu/ops/pallas/
// merger.py:69, body :46-54).  It computes, for every map m,
//   out[n, o, m] = act(sum_p x[n, p, m] * w[p, o, m] + b[o, m])
// with act(h) = max(0.1 h, h) or the identity, x (N, P, M) float32 (the
// layout the concatenation of the two branches' NHWC features gives, so
// nothing is transposed), w (P, O, M) float32 or bfloat16 (the template
// parameter; bfloat16 is widened to float32 exactly, as the TPU kernel's
// `astype(float32)`), b (O, M) float32, into out (N, O, M) float32: the
// NHWC layout (N, h_out, w_out, M) the transpose convolutions read next.
// The TPU kernel writes (M, N, O); the layout is the port's own.  The sum
// runs over p with fused multiply-adds, four partial sums (one per warp)
// added in a fixed order, then the bias, then the activation.
//
// Design: the float twin of merger_int.cu.  Maps are on a warp's lanes (32
// maps per block), so reads of x[n, p, m] and w[p, o, m] and writes of
// out[n, o, m] are consecutive addresses.  The block's 4 warps split the P
// positions (warp g takes p = g, g + 4, ...), and each thread keeps 4 slots
// x 16 outputs of its map in registers, so a weight read from L2 serves 4
// slots.  The partial sums meet in shared memory (33 KB); the epilogue adds
// the bias, applies the activation and writes 128-byte rows of out.  Grid
// (ceil(M / 32), ceil(N / 4)), 128 threads.
//
// What bounds it.  At the conv PNN's shapes (P = 80, O = 16, N = 1024, M =
// 32 ... 512) a call moves x (N P M floats) and out (N O M): 12.6 MB at M =
// 32 up to 201 MB at M = 512, against 2 N P O M = 84 M ... 1.3 G float
// operations: bytes bound it (3.35 TB/s), about 4-60 us.  The weight panel
// is read once per 4 slots, from L2.  The wrapper (ops/merger.py) counts
// launches per M in `merger.launches`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int O_OUT = 16;   // outputs per map (the merged w/s x w/s)
constexpr int MAPS = 32;    // maps per block, one per lane
constexpr int GROUPS = 4;   // warps per block, each a share of P
constexpr int SLOTS = 4;    // slots n per block
constexpr float SLOPE = 0.1f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename WT>
__global__ void __launch_bounds__(MAPS * GROUPS)
merger_kernel(int n_slots, int p_in, int m_maps, int act,
              const float* __restrict__ x, const WT* __restrict__ w,
              const float* __restrict__ b, float* __restrict__ out) {
  __shared__ float part[GROUPS][SLOTS * O_OUT][MAPS + 1];   // +1: no bank
                                                             // conflicts
  const int lane = threadIdx.x % MAPS;
  const int g = threadIdx.x / MAPS;
  const int m0 = blockIdx.x * MAPS;
  const int m = m0 + lane;
  const int n0 = blockIdx.y * SLOTS;
  const int n_here = min(SLOTS, n_slots - n0);
  float acc[SLOTS][O_OUT];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j)
#pragma unroll
    for (int o = 0; o < O_OUT; ++o) acc[j][o] = 0.0f;
  if (m < m_maps) {
    for (int p = g; p < p_in; p += GROUPS) {
      float wv[O_OUT];
      const WT* wp = w + (size_t)p * O_OUT * m_maps + m;
#pragma unroll
      for (int o = 0; o < O_OUT; ++o) wv[o] = widen(wp[(size_t)o * m_maps]);
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        if (j >= n_here) break;
        const float xv = x[((size_t)(n0 + j) * p_in + p) * m_maps + m];
#pragma unroll
        for (int o = 0; o < O_OUT; ++o) acc[j][o] = fmaf(xv, wv[o], acc[j][o]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j)
#pragma unroll
    for (int o = 0; o < O_OUT; ++o) part[g][j * O_OUT + o][lane] = acc[j][o];
  __syncthreads();
  // Output k of the block: slot n0 + (k / 32) / 16, output (k / 32) % 16,
  // map m0 + k % 32, so consecutive threads write consecutive maps.
  for (int k = threadIdx.x; k < SLOTS * O_OUT * MAPS; k += MAPS * GROUPS) {
    const int ml = k % MAPS, jo = k / MAPS;
    const int j = jo / O_OUT, o = jo % O_OUT;
    if (j >= n_here || m0 + ml >= m_maps) continue;
    float v = part[0][jo][ml];
#pragma unroll
    for (int gg = 1; gg < GROUPS; ++gg) v += part[gg][jo][ml];
    v += b[o * m_maps + m0 + ml];
    if (act) v = fmaxf(SLOPE * v, v);
    out[((size_t)(n0 + j) * O_OUT + o) * m_maps + m0 + ml] = v;
  }
}

template <typename WT>
int launch(int n_slots, int p_in, int m_maps, int act, const void* x,
           const void* w, const void* b, void* out, cudaStream_t stream) {
  const dim3 grid((m_maps + MAPS - 1) / MAPS, (n_slots + SLOTS - 1) / SLOTS);
  merger_kernel<WT><<<grid, MAPS * GROUPS, 0, stream>>>(
      n_slots, p_in, m_maps, act, (const float*)x, (const WT*)w,
      (const float*)b, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// w_bf16: 0 for float32 weights, 1 for bfloat16; act: 1 applies the
// LeakyReLU.  Returns a cudaError_t (0 on success).
extern "C" int merger(int n_slots, int p_in, int o_out, int m_maps,
                      int w_bf16, int act, const void* x, const void* w,
                      const void* b, void* out, void* stream) {
  if (n_slots < 1 || p_in < 1 || m_maps < 1 || o_out != O_OUT ||
      n_slots > 65535 * SLOTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return w_bf16 ? launch<__nv_bfloat16>(n_slots, p_in, m_maps, act, x, w, b,
                                        out, s)
                : launch<float>(n_slots, p_in, m_maps, act, x, w, b, out, s);
}

extern "C" const char* merger_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
