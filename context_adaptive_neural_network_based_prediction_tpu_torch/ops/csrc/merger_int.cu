// Integer channelwise merger of the quantized PNN, for Hopper (sm_90a).
//
// Replaces the TPU kernel `merger_int_forward` of the JAX package
// (context_adaptive_neural_network_based_prediction_tpu/ops/pallas/
// merger_int.py:63).  It computes
//   out[m, n, o] = b[o, m] + sum_p x[n, p, m] * w[p, o, m]
// with int16 activations x (N, P, M), int16 weights and int32 biases b
// (O, M), into int32 out (M, N, O).  Every product and sum is an exact
// int32 operation (the PNN's freeze-time budget keeps each sum of products
// under 2^30 and each bias under 2^30), so the result equals the integer
// dot bit for bit, in any order.
//
// What bounds it.  At the codec's shapes (N = 31 slots, P = 80 context
// positions, O = 16, M = 32 ... 256 maps) a call moves 0.3-2.4 MB and does
// 2.5-20 M integer operations: 0.1-0.7 us of the card's memory or int32
// rate.  So a call is bound by its latency: the launch, and the chain of
// dependent steps inside a block (loads, products, the reduction over
// position groups, the store); and at large M by the weights' traffic from
// L2, since every slot's blocks read all of them (20 MB at M = 256 when a
// block takes one slot).
//
// Design.  The wrapper (ops/merger_int.py) lays the weights out once per
// weight tensor as (P, M, O), so that the 16 outputs of one map and
// position are 32 contiguous bytes.  A block takes MAPS maps of S slots
// (grid (M / MAPS, N / S)): 32 / MAPS lanes per map, each with OPT = 16 *
// MAPS / 32 outputs of each slot in registers, the weights read as 16-byte
// vector loads once for the S slots; the WARPS warps split the P positions
// (warp g takes p = g, g + WARPS, ...), and every load of a warp's
// positions is issued before the products.  The bias is read at the start,
// beside those loads.  One barrier, then each thread sums one output's
// WARPS partials from shared memory and writes out[m, n, :] as 64-byte
// rows.  S is 2 from M = SLOTS2_FROM maps on (half the weight traffic),
// else 1 (twice the blocks).  The shape was chosen by timing in
// `ops/kernel_variants.py merger-int`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int O_OUT = 16;   // outputs per map (the PNN's merged w/s x w/s)
constexpr int MAPS = 16;    // maps per block
constexpr int WARPS = 8;    // warps per block, each a share of P
constexpr int P_MAX = 80;   // positions the unrolled loads cover
constexpr int MIN_BLOCKS = 1;   // blocks an SM must hold (caps registers)
constexpr int SLOTS2_FROM = 128;   // M from which a block takes 2 slots

constexpr int SPLIT = 32 / MAPS;          // lanes per map
constexpr int OPT = O_OUT / SPLIT;        // outputs per thread and slot
constexpr int THREADS = 32 * WARPS;
constexpr int OUTS = MAPS * O_OUT;        // outputs per block and slot
constexpr int PPW = (P_MAX + WARPS - 1) / WARPS;   // positions per warp

// OPT int16 weights as OPT / 2 32-bit words (16- or 8-byte loads).
__device__ __forceinline__ void load_w(const int16_t* p, int (&wd)[OPT / 2]) {
  if constexpr (OPT >= 8) {
#pragma unroll
    for (int i = 0; i < OPT / 8; ++i) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p) + i);
      wd[4 * i] = v.x;
      wd[4 * i + 1] = v.y;
      wd[4 * i + 2] = v.z;
      wd[4 * i + 3] = v.w;
    }
  } else {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    wd[0] = v.x;
    wd[1] = v.y;
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
merger_int_vec_kernel(int n_slots, int p_in, int m_maps,
                      const int16_t* __restrict__ x,
                      const int16_t* __restrict__ w,   // (P, M, O)
                      const int* __restrict__ b, int* __restrict__ out) {
  constexpr int OUT_ITERS = (S * OUTS + THREADS - 1) / THREADS;
  __shared__ __align__(16) int part[WARPS][S * OUTS];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int ml = lane % MAPS, h = lane / MAPS;
  const int m0 = blockIdx.x * MAPS;
  const int m = m0 + ml;
  const int n0 = blockIdx.y * S;

  // Output t of the block is slot n0 + t / OUTS, map m0 + (t % OUTS) / 16,
  // output t % 16.
  int bias[OUT_ITERS];
#pragma unroll
  for (int i = 0; i < OUT_ITERS; ++i) {
    const int t = (threadIdx.x + i * THREADS) % OUTS;
    bias[i] = m0 + t / O_OUT < m_maps
                  ? __ldg(b + (t % O_OUT) * m_maps + m0 + t / O_OUT) : 0;
  }

  int acc[S][OPT];
#pragma unroll
  for (int sl = 0; sl < S; ++sl)
#pragma unroll
    for (int o = 0; o < OPT; ++o) acc[sl][o] = 0;
  if (m < m_maps) {
    const int16_t* wp = w + (size_t)m * O_OUT + h * OPT;
    int xv[S][PPW];
    int wd[PPW][OPT / 2];
#pragma unroll
    for (int j = 0; j < PPW; ++j) {
      const int p = g + j * WARPS;
      if (p < p_in) {
        load_w(wp + (size_t)p * m_maps * O_OUT, wd[j]);
#pragma unroll
        for (int sl = 0; sl < S; ++sl)
          xv[sl][j] = n0 + sl < n_slots
              ? __ldg(x + ((size_t)(n0 + sl) * p_in + p) * m_maps + m) : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < PPW; ++j) {
      if (g + j * WARPS < p_in) {
#pragma unroll
        for (int i = 0; i < OPT / 2; ++i) {
          const int lo = (int)(short)wd[j][i];          // low int16
          const int hi = wd[j][i] >> 16;                // high int16
#pragma unroll
          for (int sl = 0; sl < S; ++sl) {
            acc[sl][2 * i] += xv[sl][j] * lo;
            acc[sl][2 * i + 1] += xv[sl][j] * hi;
          }
        }
      }
    }
  }
#pragma unroll
  for (int sl = 0; sl < S; ++sl) {
    int4* dst = reinterpret_cast<int4*>(
        &part[g][sl * OUTS + ml * O_OUT + h * OPT]);
#pragma unroll
    for (int i = 0; i < OPT / 4; ++i)
      dst[i] = make_int4(acc[sl][4 * i], acc[sl][4 * i + 1],
                         acc[sl][4 * i + 2], acc[sl][4 * i + 3]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < OUT_ITERS; ++i) {
    const int t = threadIdx.x + i * THREADS;
    const int n = n0 + t / OUTS, mm = m0 + (t % OUTS) / O_OUT;
    if (t < S * OUTS && n < n_slots && mm < m_maps) {
      int v = bias[i];
#pragma unroll
      for (int gg = 0; gg < WARPS; ++gg) v += part[gg][t];
      out[((size_t)mm * n_slots + n) * O_OUT + t % O_OUT] = v;
    }
  }
}

}  // namespace

// w is the prepared (P, M, O) layout; x (N, P, M), b (O, M), out (M, N, O).
extern "C" int merger_int(int n_slots, int p_in, int m_maps, const void* x,
                          const void* w, const void* b, void* out,
                          void* stream) {
  if (n_slots < 1 || p_in < 1 || p_in > P_MAX || m_maps < 1)
    return (int)cudaErrorInvalidValue;
  const int gx = (m_maps + MAPS - 1) / MAPS;
  const cudaStream_t st = (cudaStream_t)stream;
  if (m_maps >= SLOTS2_FROM)
    merger_int_vec_kernel<2><<<dim3(gx, (n_slots + 1) / 2), THREADS, 0, st>>>(
        n_slots, p_in, m_maps, (const int16_t*)x, (const int16_t*)w,
        (const int*)b, (int*)out);
  else
    merger_int_vec_kernel<1><<<dim3(gx, n_slots), THREADS, 0, st>>>(
        n_slots, p_in, m_maps, (const int16_t*)x, (const int16_t*)w,
        (const int*)b, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* merger_int_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
