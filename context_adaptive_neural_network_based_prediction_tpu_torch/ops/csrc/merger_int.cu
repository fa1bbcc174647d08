// Integer channelwise merger of the quantized PNN, for Hopper (sm_90a).
//
// Replaces the TPU kernel `merger_int_forward` of the JAX package
// (context_adaptive_neural_network_based_prediction_tpu/ops/pallas/
// merger_int.py:63).  It computes
//   out[m, n, o] = b[o, m] + sum_p x[n, p, m] * w[p, o, m]
// with int16 activations x (N, P, M), int16 weights w (P, O, M) and int32
// biases b (O, M), into int32 out (M, N, O).  Every product and sum is an
// exact int32 operation (the PNN's freeze-time budget keeps each sum of
// products under 2^30 and each bias under 2^30), so the result equals the
// integer dot bit for bit, in any order.
//
// Design.  The TPU kernel puts the maps on its 128-wide lane axis and pads
// them to 128.  Here maps m are on the threads: a block takes 32 maps of
// one slot n, so a warp's reads of x[n, p, m] and w[p, o, m] are
// consecutive addresses.  The block's 16 warps split the P context
// positions between them (warp g takes p = g, g + 16, ...); each thread
// keeps its map's 16 int32 accumulators in registers over its positions.
// The 16 partial sums then meet in shared memory (33 KB), and the block
// writes out[m, n, 0..15] of its 32 maps as contiguous 64-byte rows.
// Grid: (ceil(M / 32), N), 512 threads.  Why split P: a block of one warp
// looping over all 80 positions waits on 80 rounds of loads in a row with
// nothing else on its SM to hide them (measured about 200 us per call at
// every M on the H100); 16 warps of 5 rounds each put sixteen times as
// many loads in flight.
//
// What bounds it.  At the codec's largest shape (N = 31, P = 80, O = 16,
// M = 256) a call moves about 2.4 MB (x 1.27 MB, w 0.66 MB, out 0.51 MB)
// and does about 20 M integer operations (N*P*O*M multiply-adds, counted
// as two each): under a microsecond of the card's memory or int32 rate,
// so a launch is bound by its latency.  The wrapper
// (ops/merger_int.py) counts launches per M in `merger_int.launches`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int O_OUT = 16;   // outputs per map (the PNN's merged w/s x w/s)
constexpr int MAPS = 32;    // maps per block, one per lane
constexpr int GROUPS = 16;  // warps per block, each a share of P

__global__ void __launch_bounds__(MAPS * GROUPS)
merger_int_kernel(int n_slots, int p_in, int m_maps,
                  const int16_t* __restrict__ x,
                  const int16_t* __restrict__ w,
                  const int* __restrict__ b, int* __restrict__ out) {
  __shared__ int part[GROUPS][O_OUT][MAPS + 1];   // +1: no bank conflicts
  const int lane = threadIdx.x % MAPS;
  const int g = threadIdx.x / MAPS;
  const int m0 = blockIdx.x * MAPS;
  const int m = m0 + lane;
  const int n = blockIdx.y;
  int acc[O_OUT];
#pragma unroll
  for (int o = 0; o < O_OUT; ++o) acc[o] = 0;
  if (m < m_maps) {
    const int16_t* xp = x + (size_t)n * p_in * m_maps + m;
#pragma unroll 5
    for (int p = g; p < p_in; p += GROUPS) {
      const int xv = xp[(size_t)p * m_maps];
      const int16_t* wp = w + (size_t)p * O_OUT * m_maps + m;
#pragma unroll
      for (int o = 0; o < O_OUT; ++o) acc[o] += xv * (int)wp[o * m_maps];
    }
  }
#pragma unroll
  for (int o = 0; o < O_OUT; ++o) part[g][o][lane] = acc[o];
  __syncthreads();
  // Output k of the block: map m0 + k / 16, output k % 16, so consecutive
  // threads write consecutive addresses of out[m, n, :].
  for (int k = threadIdx.x; k < MAPS * O_OUT; k += MAPS * GROUPS) {
    const int ml = k / O_OUT, o = k % O_OUT;
    if (m0 + ml >= m_maps) continue;
    int v = b[o * m_maps + m0 + ml];
#pragma unroll
    for (int gg = 0; gg < GROUPS; ++gg) v += part[gg][o][ml];
    out[((size_t)(m0 + ml) * n_slots + n) * O_OUT + o] = v;
  }
}

}  // namespace

extern "C" int merger_int(int n_slots, int p_in, int o_out, int m_maps,
                          const void* x, const void* w, const void* b,
                          void* out, void* stream) {
  if (n_slots < 1 || p_in < 1 || m_maps < 1 || o_out != O_OUT)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m_maps + MAPS - 1) / MAPS, n_slots);
  merger_int_kernel<<<grid, MAPS * GROUPS, 0, (cudaStream_t)stream>>>(
      n_slots, p_in, m_maps, (const int16_t*)x, (const int16_t*)w,
      (const int*)b, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* merger_int_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
