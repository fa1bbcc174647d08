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
// The TPU kernel writes (M, N, O); the layout is the port's own.  Each
// output sums over p in order with fused multiply-adds (in 2 or 4 runs of
// consecutive p, added in order, when a block has few slots), then adds the
// bias, then applies the activation: the result depends on the shape
// alone, never on timing.
//
// What bounds it.  At the conv PNN's shapes (P = 80, O = 16, N = 1024, M =
// 32 ... 512) a call moves x (N P M floats) and out (N O M): 12.6 MB at M =
// 32 up to 201 MB at M = 512, against 2 N P O M = 84 M ... 1.3 G float
// operations, about 6.7 operations per byte, far under the float32 ridge
// (about 20): bytes bound it (3.35 TB/s), about 4-60 us, and the tensor
// cores would not help.
//
// Design.  A block owns 32 consecutive maps (one per lane, so reads of x and
// writes of out are 128-byte rows) and a contiguous range of slots, and
// walks it: the grid is about one wave (map groups x slot chunks), so the
// maps' weight panel (P x 16 x 32, 160 KB in float32, 80 KB in bfloat16)
// is read from L2 once per block and staged in shared memory with
// `cp.async`, overlapped with the first loads of x.  Each of the 16 warps
// takes groups of 2 slots; a thread keeps 2 slots x 16 outputs of its map
// in registers, so each weight read from shared memory (conflict-free:
// lanes on consecutive maps) serves 2 slots.  x is read straight into
// registers, 8 positions ahead of the sums (a second register set), which
// keeps 32 KB of loads in flight per SM.  A block with at most 16 (8)
// slots, where most warps would idle (small M or N), gives each slot group
// 2 (4) warps that split the positions; their partial sums meet in shared
// memory and are added in a fixed order.  (`ops/kernel_variants.py` times
// the alternatives on the card: 8 warps x 4 slots, 4 positions ahead, 16
// slots per block, no split; PERF.md.)  The wrapper (ops/merger.py) counts
// launches per M in `merger.launches`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int O_OUT = 16;     // outputs per map (the merged w/s x w/s)
constexpr int MAPS = 32;      // maps per block, one per lane
constexpr int WARPS = 16;     // warps per block
constexpr int SLOTS = 2;      // slots a thread sums at once
constexpr int PU = 8;         // positions of x loaded ahead
constexpr int MIN_BLOCK_SLOTS = 8;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr float SLOPE = 0.1f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

// Stages w[p, o, m0 .. m0 + 32) for every (p, o) into ws[p][o][32] with
// 16-byte copies, zeros past M (M is a multiple of 8 and w 16-byte
// aligned, so a copy never straddles M).
template <typename WT>
__device__ void stage_weights(WT* ws, const WT* __restrict__ w, int rows,
                              int m_maps, int m0) {
  constexpr int PER16 = 16 / sizeof(WT);            // elements per copy
  const int chunks = rows * (MAPS / PER16);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int row = c / (MAPS / PER16);
    const int e = (c % (MAPS / PER16)) * PER16;
    const int m = m0 + e;
    const WT* src = w + (size_t)row * m_maps + (m < m_maps ? m : 0);
    cp_async16(ws + row * MAPS + e, src, m < m_maps ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Grid (map groups, slot chunks); block y owns slots [y * per, (y + 1) *
// per) of N.  PSPLIT warps share each group of SLOTS slots, warp p-part q
// summing positions [q * pq, (q + 1) * pq); with PSPLIT > 1 the parts meet
// in shared memory and are added in the order q = 0, 1, ... (blocks with
// few slots keep all 16 warps busy that way).
template <typename WT, int PSPLIT>
__global__ void __launch_bounds__(MAPS * WARPS, 1)
merger_staged_kernel(int n_slots, int p_in, int m_maps, int act, int per,
                     const float* __restrict__ x,
                     const WT* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out) {
  constexpr int GROUPS = WARPS / PSPLIT;     // slot groups per pass
  extern __shared__ __align__(16) uint8_t smem_raw[];
  WT* const ws = reinterpret_cast<WT*>(smem_raw);     // [p][o][32]
  // Partial sums [warp][slot][o][32], after the weights (PSPLIT > 1).
  float* const red = reinterpret_cast<float*>(
      smem_raw + (size_t)p_in * O_OUT * MAPS * sizeof(WT));
  const int lane = threadIdx.x % MAPS, warp = threadIdx.x / MAPS;
  const int part = warp % PSPLIT, group = warp / PSPLIT;
  const int m0 = blockIdx.x * MAPS;
  const int m = m0 + lane;
  const bool live = m < m_maps;
  const int s_begin = blockIdx.y * per;
  const int s_end = min(n_slots, s_begin + per);
  const int pq = (p_in + PSPLIT - 1) / PSPLIT;
  const int p_lo = part * pq, p_hi = min(p_in, p_lo + pq);
  const int chunks = (p_hi - p_lo + PU - 1) / PU;

  stage_weights(ws, w, p_in * O_OUT, m_maps, m0);
  float bias[O_OUT];
#pragma unroll
  for (int o = 0; o < O_OUT; ++o) bias[o] = live ? b[o * m_maps + m] : 0.0f;

  // The first group's loads of x fly while the weights arrive.
  const float* xs[SLOTS];
  bool on[SLOTS];
  auto setup = [&](int s0) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      on[j] = live && s0 + j < s_end;
      xs[j] = x + ((size_t)(on[j] ? s0 + j : 0) * p_in) * m_maps + m;
    }
  };
  float xc[PU][SLOTS], xn[PU][SLOTS];
  auto load = [&](float (*dst)[SLOTS], int c) {
#pragma unroll
    for (int q = 0; q < PU; ++q) {
      const int p = p_lo + c * PU + q;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j)
        dst[q][j] = (on[j] && p < p_hi) ? xs[j][(size_t)p * m_maps] : 0.0f;
    }
  };
  int s0 = s_begin + group * SLOTS;
  setup(s0);
  load(xc, 0);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // With PSPLIT > 1 every warp runs the same passes (the partial sums meet
  // at barriers); else a warp stops when its slots run out.
  for (bool first = true;
       (PSPLIT > 1 ? s0 - group * SLOTS : s0) < s_end;
       s0 += GROUPS * SLOTS, first = false) {
    if (!first) {
      setup(s0);
      load(xc, 0);
    }
    float acc[SLOTS][O_OUT];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j)
#pragma unroll
      for (int o = 0; o < O_OUT; ++o) acc[j][o] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) load(xn, c + 1);
#pragma unroll
      for (int q = 0; q < PU; ++q) {
        const int p = p_lo + c * PU + q;
        if (p >= p_hi) break;
        const WT* wp = ws + p * O_OUT * MAPS + lane;
#pragma unroll
        for (int o = 0; o < O_OUT; ++o) {
          const float wv = widen(wp[o * MAPS]);
#pragma unroll
          for (int j = 0; j < SLOTS; ++j)
            acc[j][o] = fmaf(xc[q][j], wv, acc[j][o]);
        }
      }
#pragma unroll
      for (int q = 0; q < PU; ++q)
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) xc[q][j] = xn[q][j];
    }
    if constexpr (PSPLIT > 1) {
      float* mine = red + (size_t)warp * SLOTS * O_OUT * MAPS + lane;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j)
#pragma unroll
        for (int o = 0; o < O_OUT; ++o)
          mine[(j * O_OUT + o) * MAPS] = acc[j][o];
      __syncthreads();
      if (part == 0) {
#pragma unroll
        for (int j = 0; j < SLOTS; ++j)
#pragma unroll
          for (int o = 0; o < O_OUT; ++o)
            for (int q = 1; q < PSPLIT; ++q)
              acc[j][o] += mine[(size_t)q * SLOTS * O_OUT * MAPS +
                                (j * O_OUT + o) * MAPS];
      }
      __syncthreads();
    }
    if (part == 0) {
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        if (!on[j]) continue;
        float* dst = out + (size_t)(s0 + j) * O_OUT * m_maps + m;
#pragma unroll
        for (int o = 0; o < O_OUT; ++o) {
          float v = acc[j][o] + bias[o];
          if (act) v = fmaxf(SLOPE * v, v);
          dst[(size_t)o * m_maps] = v;
        }
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <typename WT, int PSPLIT>
int launch_split(dim3 grid, size_t smem, int n_slots, int p_in, int m_maps,
                 int act, int per, const void* x, const void* w,
                 const void* b, void* out, cudaStream_t stream) {
  auto kernel = merger_staged_kernel<WT, PSPLIT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kernel<<<grid, MAPS * WARPS, smem, stream>>>(
      n_slots, p_in, m_maps, act, per, (const float*)x, (const WT*)w,
      (const float*)b, (float*)out);
  return (int)cudaGetLastError();
}

template <typename WT>
int launch(int n_slots, int p_in, int m_maps, int act, const void* x,
           const void* w, const void* b, void* out, cudaStream_t stream) {
  // About one wave of blocks, each with at least MIN_BLOCK_SLOTS slots;
  // a block with fewer slots than its warps can take splits the positions
  // over 2 or 4 warps per slot group.
  const int groups = (m_maps + MAPS - 1) / MAPS;
  int chunks = max(1, sm_count() / groups);
  chunks = min(chunks, max(1, n_slots / MIN_BLOCK_SLOTS));
  chunks = min(chunks, 65535);
  const int per = (n_slots + chunks - 1) / chunks;
  chunks = (n_slots + per - 1) / per;
  const dim3 grid(groups, chunks);
  const size_t panel = (size_t)p_in * O_OUT * MAPS * sizeof(WT);
  if (per <= WARPS * SLOTS / 2) {
    const size_t smem =
        panel + (size_t)WARPS * SLOTS * O_OUT * MAPS * sizeof(float);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    return per <= WARPS * SLOTS / 4
               ? launch_split<WT, 4>(grid, smem, n_slots, p_in, m_maps, act,
                                     per, x, w, b, out, stream)
               : launch_split<WT, 2>(grid, smem, n_slots, p_in, m_maps, act,
                                     per, x, w, b, out, stream);
  }
  if (panel > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  return launch_split<WT, 1>(grid, panel, n_slots, p_in, m_maps, act, per, x,
                             w, b, out, stream);
}

}  // namespace

// w_bf16: 0 for float32 weights, 1 for bfloat16; act: 1 applies the
// LeakyReLU.  M must be a multiple of 8 and w 16-byte aligned (the weight
// panel is staged in 16-byte copies).  Returns a cudaError_t (0 on
// success).
extern "C" int merger(int n_slots, int p_in, int o_out, int m_maps,
                      int w_bf16, int act, const void* x, const void* w,
                      const void* b, void* out, void* stream) {
  if (n_slots < 1 || p_in < 1 || m_maps < 1 || o_out != O_OUT ||
      m_maps % 8 != 0 || (m_maps + MAPS - 1) / MAPS > 65535)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return w_bf16 ? launch<__nv_bfloat16>(n_slots, p_in, m_maps, act, x, w, b,
                                        out, s)
                : launch<float>(n_slots, p_in, m_maps, act, x, w, b, out, s);
}

extern "C" const char* merger_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
