// Fused unit trial of the wavefront encoder, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_run` of the JAX package
// (context_adaptive_neural_network_based_prediction_tpu/ops/unit_fused.py):
// its single-block form (pallas_call at :785, n = 4 and 8) and its
// mode-group grid form (pallas_call at :870, n = 16 and 32).  One call
// tries every intra mode of b units of size n x n (one per wavefront slot)
// and keeps the cheapest:
//   [1 2 1] reference filter (bilinear at 32x32 when flat) -> planar, DC and
//   33 angular predictions -> residual -> exact forward DST/DCT -> RDOQ-lite
//   (round / round-1 / 0, TU rate, cbf=0 option) -> sign-data hiding per
//   4x4 group -> dequant, inverse transform, reconstruction -> SSE +
//   lambda * bits -> first minimum over ascending mode ids.
//
// What bounds it.  At the encoder's shapes a call is small: up to 31 slots
// x 35 or 36 modes x n^2 pixels (1080p), and a frame needs about 10,500
// calls (124 wavefront steps x 85 z-order sub-stages).  The work of a call
// is a few MFLOP and a few hundred KB, under 0.2 us of the card's rates at
// n = 4 and 8, so a call is bound by its launch and by the chain of
// dependent steps inside it, and the encode by the serial sub-stage chain.
//
// Design, n = 4 and 8 (`trial_small_kernel`; 9,920 of a frame's 10,540
// calls).  One launch.  Each slot gets a cluster of CLUSTER_n blocks (4:
// 124 blocks on the card's 132 SMs instead of 31), each with 9 of the
// slot's 36 mode slots.  A block loads and filters the slot's references
// once, then runs each mode on its own lanes (half a warp at n = 4, a warp
// at n = 8, two pixels a lane), warp-synchronously: no block barrier in a
// mode's chain, transforms through a per-mode shared scratch read as
// 16-byte rows, per-TU and per-coefficient-group sums by shuffles and warp
// reductions (sign hiding from two bit masks a group).  Each lane issues
// the global loads of its modes' table entries first, so they overlap the
// block's own loads.  Each mode's cost is pushed into every block of the
// cluster (st.async, counted on an mbarrier: no release/acquire cluster
// barrier, which costs about 1 us here); every block then takes the first
// minimum itself and the block that holds the winner writes its cost,
// mode, reconstruction, levels and counts from shared memory.  The tables
// reach the kernel as one struct of pointers and scalars passed by value
// (`Tables`, built once per table set by the wrapper), so no scalar
// parameter costs a load.  Cluster size and the rest were chosen by timing
// in `ops/kernel_variants.py trial`.
//
// Design, n = 16 and 32 (`trial_large_kernel`; 620 calls a frame, most of
// the trial's device time).  One launch, the same cluster select as at n =
// 4 and 8.  A mode is 256 or 1024 pixels and its four transforms are most
// of the arithmetic (4 x N^3 multiply-adds), so each mode runs on W warps
// (4 pixels a thread), warp-synchronous but for the mode's own named
// barrier, and the transforms run on the FP64 tensor cores (`mma.sync`
// m8n8k4) from shared memory in doubles: exact, since every product and
// partial sum is an integer below 2^53 (the bounds are written at
// `product`).  Each half-warp holds one 4x4 coefficient group in scan
// order, so sign hiding's flags are ballots.  A cluster of 9 blocks a slot
// at n = 16 (4 modes a block, two blocks an SM), of 3 at n = 32 (12 modes,
// 3 at a time on 768 threads): at one block an SM the card holds fewer
// than 31 clusters of 4 at once (`kernel_variants trial-clusters`).
// Chosen by timing in `ops/kernel_variants.py trial`, which also keeps the
// first design (a block per (slot, mode) and a select kernel, at every n)
// as the "before" row.  What bounds it: each mode is a long chain of
// dependent instructions a thread, and a few modes an SM in flight do not
// hide its latency; the arithmetic is far below the card's rates.
//
// Both: prediction is direct integer angular interpolation ((32-f)*a + f*b
// + 16) >> 5 from the angular gather tables, which equals the reference's
// float32 products of small integers exactly.  Integer sums are exact in
// any order.  The float cost chain repeats the reference's float32
// operations in the same order; the file is compiled with --fmad=false so
// that no a*b+c is contracted.
//
// The PNN mode.  Under the NN policies the PNN's prediction (b, n, n),
// computed before the launch, is the prediction of one mode: mode 18
// (substitution) or the 36th mode, PNNS (switch), as IP_NNMODE says; that
// mode reads it instead of interpolating.  Without a prediction (a null
// pointer) that mode predicts zeros.  A null rate_rows means zero rows.
//
// Outputs, one int32 buffer per call (the wrapper's one allocation):
// cost (b, as float bits) | best (b) | rec (b, n*n) | q (b, n*n) | counts
// (b, 8); the first design (variant tool only) adds its per-mode scratch:
// cost_m (b, 36) | rec_m (b, 36, n*n) | q_m (b, 36, n*n) | cnt_m (b, 36,
// 8).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M_PAD = 36;     // mode slots per unit (35 modes + PNNS)
constexpr int N_INTRA = 35;   // planar, DC and 33 angular modes

// Integer parameters (ip) and float parameters (fp); the order matches
// ops/unit_fused.py:_kernel_tables.
enum {
  IP_NMODES, IP_ROWS, IP_SHIFT1, IP_SHIFT2, IP_QBITS, IP_IQSHIFT,
  IP_IQSCALE, IP_G1_0, IP_G1_1, IP_G2_0, IP_G2_1, IP_CSB0, IP_CSB1, IP_CBF1,
  IP_NNMODE     // mode that takes the PNN prediction: 18, 35 or -1 (none)
};
enum { FP_QSCALE, FP_ERRSCALE, FP_LAM, FP_LAMCBF0, FP_CBF0 };

// The table set of one unit size and QP (ops/unit_fused.py:TableSet lays
// out the same struct): device pointers into one table block, and the
// scalar parameters by value.
struct Tables {
  const int* g0;        // (33, n*n) angular reference index a
  const int* g1;        // (33, n*n) angular reference index b
  const int* frac;      // (33, n*n) 1/32 fraction
  const int* use_filt;  // (35) 1 = predict from filtered references
  const int* tf;        // (n, n) forward matrix (14-bit)
  const int* ti;        // (n, n) inverse matrix (6-bit)
  const int* scan;      // (rows, n*n) raster -> scan position
  const float* sig0;    // (rows, n*n) sig_coeff_flag = 0 bits
  const float* sig1;    // (rows, n*n) sig_coeff_flag = 1 bits
  const int* sig0i;     // (rows, n*n) round(sig0 * 256)
  const int* sig1i;     // (rows, n*n) round(sig1 * 256)
  const int* lastpb;    // (n*n) last-position micro-bits
  const int* iscan;     // (rows, n*n) scan position -> raster
  const int* ang;       // (33, n*n) frac | g0 << 8 | g1 << 16
  int ip[16];           // integer parameters
  float fp[8];          // float parameters
};

__device__ __forceinline__ int level_mbits(int lvl, int g1_0, int g1_1,
                                           int g2_0, int g2_1) {
  // Micro-bits of a nonzero level: greater1/greater2 flags and the
  // Golomb-Rice escape at rice 0, floor(log2) by integer compares.
  const int s = lvl - 3;
  const int m = max(s - 2, 1);
  // The count of j in 1..15 with m >= 2^j: floor(log2(m)), at most 15.
  const int g = min(31 - __clz(m), 15);
  const int golomb = (s < 3) ? s + 1 : 4 + 2 * g;
  int r;
  if (lvl == 1) r = g1_0;
  else if (lvl == 2) r = g1_1 + g2_0;
  else r = g1_1 + g2_1 + golomb * 256;
  return 256 + r;
}

struct Rates {
  int g1_0, g1_1, g2_0, g2_1;
  __device__ float bits(float lvl) const {
    return (float)level_mbits((int)lvl, g1_0, g1_1, g2_0, g2_1) *
           (1.0f / 256.0f);
  }
};

__device__ __forceinline__ float sq(float x) { return x * x; }

__device__ __forceinline__ int rate_row(const int* rr, int k, int b, int s) {
  return rr != nullptr ? rr[k * b + s] : 0;
}

// ---- n = 4 and 8: one launch, a block (or a cluster) per slot ----

constexpr unsigned FULL = 0xffffffffu;
// Thread-block cluster size per slot at n = 4 and 8: the slot's modes are
// split over CLUSTER_n blocks that select over distributed shared memory
// (chosen by timing in `ops/kernel_variants.py trial`).
constexpr int CLUSTER_4 = 4;
constexpr int CLUSTER_8 = 4;

// Sums, maxima and minima over the 16 lanes that share lane bit 4 (a
// half-warp): one 4x4 coefficient group, or at n = 4 one mode.
__device__ __forceinline__ int sum16(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ int max16(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float fmin16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
// N ints of a 16-byte aligned shared-memory row.
template <int N>
__device__ __forceinline__ void load_row(const int* p, int (&r)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const int4 v = *reinterpret_cast<const int4*>(p + j);
    r[j] = v.x;
    r[j + 1] = v.y;
    r[j + 2] = v.z;
    r[j + 3] = v.w;
  }
}

// Over the G lanes of one mode (G = 16: a half-warp; G = 32: the warp).
template <int G>
__device__ __forceinline__ int group_sum(int v) {
  if constexpr (G == 32) return __reduce_add_sync(FULL, v);
  else return sum16(v);
}
template <int G>
__device__ __forceinline__ int group_max(int v) {
  if constexpr (G == 32) return __reduce_max_sync(FULL, v);
  else return max16(v);
}

// ---- cluster helpers (PTX) ----
// The select of a cluster: each block's mode costs are pushed into every
// block of the slot's cluster with st.async, and each block's mbarrier
// counts the bytes that arrive, so no release/acquire cluster barrier (a
// GPU-wide fence on this card) sits between the modes and the select.
// Two relaxed cluster barriers: one arrived at the start (after the
// mbarrier's initialisation and its fence) and waited for before the
// first push, so no push reaches an uninitialised mbarrier (a count that
// arrives before the expected bytes are set only runs ahead: the phase
// cannot complete before the local arrive); one at the end, arrived once
// a block has received all its bytes, so no block exits while a push of
// the cluster is in flight.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for phase 0 of the barrier; more than about 10 s traps (a launch
// error) instead of hanging.
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "0; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// *dst = v in block `rank` of the cluster, completing 4 bytes of its
// barrier `bar` (dst and bar given as this block's addresses).
__device__ __forceinline__ void push_f32(float* dst, float v, uint64_t* bar,
                                         int rank) {
  uint32_t rd, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rd) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];" :: "r"(rd), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// Barrier `id` (1-15; 0 is __syncthreads) over the `count` threads of one
// mode.
__device__ __forceinline__ void bar_named(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// d += a b, one m8n8k4 product of a warp on the FP64 tensor cores.  Lane
// l holds A(l / 4, l % 4), B(l % 4, l / 4) and D(l / 4, 2 (l % 4) + e).
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%4, %5};"
      : "=d"(d[0]), "=d"(d[1]) : "d"(a), "d"(b), "d"(d[0]), "d"(d[1]));
}
// ---- end of cluster helpers ----

// ---- shared by both kernels: a slot's set-up and its select ----

// The parameters of one slot, the same for every mode: the table set's
// scalars and the slot's rate-state deltas (rate_rows null: zero rows).
struct SlotParams {
  int shift1, shift2, dsig0, dsig1, dcbf0, dcbf1, iq, iq_scale;
  Rates rt;
  float QS, ES, LAM, qstep, inv_qstep, dsig0f, dsig1f;
  __device__ __forceinline__ SlotParams(const Tables& T, const int* rr,
                                        int b, int s)
      : shift1(T.ip[IP_SHIFT1]), shift2(T.ip[IP_SHIFT2]),
        dsig0(rate_row(rr, 0, b, s)), dsig1(rate_row(rr, 1, b, s)),
        dcbf0(rate_row(rr, 6, b, s)), dcbf1(rate_row(rr, 7, b, s)),
        iq(T.ip[IP_IQSHIFT]), iq_scale(T.ip[IP_IQSCALE]),
        rt{T.ip[IP_G1_0] + rate_row(rr, 2, b, s),
           T.ip[IP_G1_1] + rate_row(rr, 3, b, s),
           T.ip[IP_G2_0] + rate_row(rr, 4, b, s),
           T.ip[IP_G2_1] + rate_row(rr, 5, b, s)},
        QS(T.fp[FP_QSCALE]), ES(T.fp[FP_ERRSCALE]), LAM(T.fp[FP_LAM]),
        qstep(ldexpf(1.0f, T.ip[IP_QBITS])),
        inv_qstep(ldexpf(1.0f, -T.ip[IP_QBITS])),
        dsig0f((float)dsig0 * (1.0f / 256.0f)),
        dsig1f((float)dsig1 * (1.0f / 256.0f)) {}
};

// Loads slot s's references (raw: the top row, then the left column, 2N +
// 1 each), original and PNN prediction (zeros without one) into shared
// memory, NT threads; `each(i)` runs for every pixel i too (the kernel's
// own staging).
template <int N, int NT, typename F>
__device__ __forceinline__ void load_slot(
    const int* __restrict__ ref_top, const int* __restrict__ ref_left,
    const int* __restrict__ orig, const int* __restrict__ nn_pred, int s,
    int tid, int* raw, int* og, int* nnp, F each) {
  constexpr int S = 2 * N + 1, NN = N * N;
  for (int i = tid; i < 2 * S; i += NT)
    raw[i] = i < S ? ref_top[s * S + i] : ref_left[s * S + i - S];
  for (int i = tid; i < NN; i += NT) {
    og[i] = orig[s * NN + i];
    nnp[i] = nn_pred != nullptr ? nn_pred[s * NN + i] : 0;
    each(i);
  }
}

// After a block barrier behind load_slot: the filtered references in flt
// ([1 2 1], or at 32x32 the bilinear filter when both sides are
// near-linear) and, from thread 0, the DC value in *dc.
template <int N, int NT>
__device__ __forceinline__ void filter_slot(const int* raw, int* flt,
                                            int* dc, int tid) {
  constexpr int LEFT = 2 * N + 1;
  constexpr int LOG2N = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  bool strong = false;
  if constexpr (N == 32) {
    const int c0 = raw[0], tr = raw[2 * N], tn = raw[N];
    const int bl = raw[LEFT + 2 * N], ln = raw[LEFT + N];
    strong = abs(bl + c0 - 2 * ln) < 8 && abs(c0 + tr - 2 * tn) < 8;
  }
  for (int i = tid; i < 2 * LEFT; i += NT) {
    const bool left = i >= LEFT;
    const int j = left ? i - LEFT : i;
    int v;
    if (strong) {
      const int c0 = raw[0];
      const int end = left ? raw[LEFT + 2 * N] : raw[2 * N];
      v = j == 0 ? c0 : j == 2 * N ? end
                     : ((2 * N - j) * c0 + j * end + 32) >> 6;
    } else if (j == 0) {
      v = (raw[LEFT + 1] + 2 * raw[0] + raw[1] + 2) >> 2;
    } else if (j == 2 * N) {
      v = raw[i];
    } else if (!left) {
      v = (raw[j - 1] + 2 * raw[j] + raw[j + 1] + 2) >> 2;
    } else {
      const int a = j == 1 ? raw[0] : raw[LEFT + j - 1];
      v = (a + 2 * raw[LEFT + j] + raw[LEFT + j + 1] + 2) >> 2;
    }
    flt[i] = v;
  }
  if (tid == 0) {
    int sum = 0;
    for (int i = 1; i <= N; ++i) sum += raw[i] + raw[LEFT + i];
    *dc = (sum + N) >> (LOG2N + 1);
  }
}

// The first minimum over ascending mode ids, then the winner's data, once
// each of the block's modes has left its cost, reconstruction, levels and
// counts in row `pass * SLOTS + slot` of the block's shared arrays (mode
// id rank * MPC + row).  In a cluster every block gathers the slot's
// costs in cost_all (pushed by the cluster's blocks, its own included,
// from the thread with `leader`); one warp takes the first minimum
// (strict <), and the block that holds the winner writes it to slot s of
// the outputs.
template <int N, int CL, int MPC, int SLOTS, int PASSES, int NT,
          typename RecT>
__device__ __forceinline__ void select_slot(
    int s, int n_modes, int rank, int slot, bool leader,
    const float* cost_s, float* cost_all, uint64_t* costs_in, int* s_best,
    const RecT* rec_s, const int* q_s, const int* cnt_s,
    float* __restrict__ cost, int* __restrict__ best, int* __restrict__ rec,
    int* __restrict__ q, int* __restrict__ cnt) {
  constexpr int NN = N * N;
  const int tid = threadIdx.x;
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    cluster_wait();
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int row = pass * SLOTS + slot;
      if (leader && row < MPC)
        for (int r = 0; r < CL; ++r)
          push_f32(&cost_all[rank * MPC + row], cost_s[row], costs_in, r);
    }
    if (tid < 32) mbar_wait0(costs_in);
  }
  const float* costs = CL == 1 ? cost_s : cost_all;
  if (tid < 32) {
    const float inf = __int_as_float(0x7f800000);
    const float c0 = tid < n_modes ? costs[tid] : inf;
    const float c1 = tid + 32 < n_modes ? costs[tid + 32] : inf;
    float v = fminf(c0, c1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
    int id = c0 == v ? tid : c1 == v ? tid + 32 : M_PAD;
    id = __reduce_min_sync(FULL, id);
    if (tid == 0) *s_best = id < M_PAD ? id : 0;
  }
  __syncthreads();
  if constexpr (CL > 1) {
    // This block has all its bytes (warp 0 waited for them); when every
    // block has arrived, no push of the cluster is in flight.
    cluster_arrive_relaxed();
    cluster_wait();
  }
  const int bi = *s_best;
  if (bi / MPC != rank) return;
  const int br = bi % MPC;
  if (tid == 0) {
    cost[s] = costs[bi];
    best[s] = bi;
  }
  for (int p = tid; p < NN; p += NT) {
    rec[s * NN + p] = rec_s[br * NN + p];
    q[s * NN + p] = q_s[br * NN + p];
  }
  if (tid < 8) cnt[s * 8 + tid] = cnt_s[br * 8 + tid];
}

// The shape of the n = 4 / 8 kernel: G lanes a mode, KPL pixels a lane,
// MPC modes a block (CL blocks a slot), SLOTS modes a pass, WARPS warps.
template <int N, int CL>
struct Small {
  static constexpr int NN = N * N;
  static constexpr int G = N == 4 ? 16 : 32;
  static constexpr int KPL = NN / G;
  static constexpr int MPC = M_PAD / CL;
  static constexpr int WARPS_NEED = (MPC * G + 31) / 32;
  static constexpr int WARPS = WARPS_NEED < 18 ? WARPS_NEED : 18;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int SLOTS = WARPS * 32 / G;
  static constexpr int PASSES = (MPC + SLOTS - 1) / SLOTS;
  static_assert(MPC * CL == M_PAD, "cluster size divides 36");
};

// A mode's table entries for one lane's pixels, loaded at the start.
template <int KPL>
struct ModeTab {
  int frac[KPL], a[KPL], b[KPL], scan[KPL], cgscan[KPL];
  int sig0i[KPL], sig1i[KPL], lastpb[KPL];
  float sig0[KPL], sig1[KPL];
  int filt;
  float mode_bits;
};

// The trial of b units of size N (4 or 8): one block per slot, or a
// cluster of CL blocks per slot, each with MPC of the 36 mode slots.  A
// block loads its slot's references, original, PNN prediction and the
// transform matrices into shared memory and filters the references once;
// every lane first issues the global loads of its modes' table entries,
// so they overlap that.  Each mode then runs on its own G lanes (a
// half-warp at N = 4; a warp at N = 8, two pixels a lane),
// warp-synchronously: transforms through a per-mode shared scratch and
// __syncwarp, per-TU and per-coefficient-group sums by shuffles and warp
// reductions, no block barrier.  Each mode leaves its cost,
// reconstruction, levels and bin counts in shared memory; in a cluster it
// also pushes its cost into every block of the cluster.  One warp of each
// block then takes the first minimum of the slot's 36 costs (strict <,
// ascending mode ids), and the block that holds the winner writes it.
// CL = 1 (a block a slot, two passes at N = 8) is kept for the variant
// tool's comparison.  Lane pixels: lane
// l, register k holds pixel (4k + i / 4, 4 (l / 16) + i % 4) at N = 8 and
// (i / 4, i % 4) at N = 4, i = l % 16, so a half-warp holds one 4x4
// coefficient group.
template <int N, int CL>
__global__ void __launch_bounds__(Small<N, CL>::THREADS)
trial_small_kernel(int b, const int* __restrict__ ref_top,
                   const int* __restrict__ ref_left,
                   const int* __restrict__ orig,
                   const float* __restrict__ mode_bits,
                   const int* __restrict__ rate_rows,
                   const int* __restrict__ nn_pred, const Tables T,
                   float* __restrict__ cost, int* __restrict__ best,
                   int* __restrict__ rec, int* __restrict__ q,
                   int* __restrict__ cnt) {
  using K = Small<N, CL>;
  constexpr int NN = K::NN, G = K::G, KPL = K::KPL, MPC = K::MPC;
  constexpr int SLOTS = K::SLOTS, PASSES = K::PASSES;
  constexpr int NT = K::THREADS;
  constexpr int ROWS = SLOTS * PASSES;          // mode rows a block keeps
  constexpr int R = 2 * (2 * N + 1);
  constexpr int LEFT = 2 * N + 1;
  constexpr int LOG2N = N == 4 ? 2 : 3;

  __shared__ int raw[R];
  __shared__ int flt[R];
  __shared__ int og[NN];
  __shared__ int nnp[NN];
  __shared__ __align__(16) int tfs[N][N];      // forward matrix
  __shared__ __align__(16) int tit[N][N];      // inverse matrix, transposed
  __shared__ __align__(16) int scr[SLOTS][2][NN];
  __shared__ int rec_s[ROWS][NN];
  __shared__ int q_s[ROWS][NN];
  __shared__ int cnt_s[ROWS][8];
  __shared__ float cost_s[ROWS];
  __shared__ float cost_all[M_PAD];             // the slot's mode costs
  __shared__ __align__(8) uint64_t costs_in;    // mbarrier of cost_all
  __shared__ int s_dc;
  __shared__ int s_best;

  const int rank = CL > 1 ? cluster_rank() : 0;
  const int s = blockIdx.x / CL;
  const int tid = threadIdx.x;
  const int n_modes = T.ip[IP_NMODES];
  const int lane = tid & 31;
  const int gl = lane & (G - 1);                // lane within the mode
  const int slot = (tid >> 5) * (32 / G) + lane / G;
  const int i16 = lane & 15;                    // place in its 4x4 group
  const int cgx = G == 32 ? lane >> 4 : 0;

  // ---- this lane's table entries, for every pass ----
  ModeTab<KPL> tab[PASSES];
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    // Slots past the block's modes, or past the last mode, repeat the
    // last mode (their results are never read), so every lane takes part
    // in every shuffle.
    const int m = min(rank * MPC + min(pass * SLOTS + slot, MPC - 1),
                      n_modes - 1);
    const int rows_mode = T.ip[IP_ROWS] == 1 ? 0 : m;
    const bool angular = m >= 2 && m < N_INTRA;
    ModeTab<KPL>& t = tab[pass];
    t.filt = m < N_INTRA ? __ldg(T.use_filt + m) : 0;
    t.mode_bits = __ldg(mode_bits + s * n_modes + m);
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int p = (4 * k + (i16 >> 2)) * N + 4 * cgx + (i16 & 3);
      const int ta = (angular ? m - 2 : 0) * NN + p;
      t.frac[k] = __ldg(T.frac + ta);
      t.a[k] = __ldg(T.g0 + ta);
      t.b[k] = __ldg(T.g1 + ta);
      const int rp = rows_mode * NN + p;
      t.scan[k] = __ldg(T.scan + rp);
      t.cgscan[k] = __ldg(T.scan + rows_mode * NN + 4 * k * N + 4 * cgx);
      t.sig0[k] = __ldg(T.sig0 + rp);
      t.sig1[k] = __ldg(T.sig1 + rp);
      t.sig0i[k] = __ldg(T.sig0i + rp);
      t.sig1i[k] = __ldg(T.sig1i + rp);
      t.lastpb[k] = __ldg(T.lastpb + p);
    }
  }

  if constexpr (CL > 1) {
    if (tid == 0) mbar_init_tx(&costs_in, M_PAD * 4);
    __syncwarp();                    // .aligned: the warp arrives together
    cluster_arrive_relaxed();
  }

  // ---- the slot's references, original and prediction; filtering ----
  load_slot<N, NT>(ref_top, ref_left, orig, nn_pred, s, tid, raw, og, nnp,
                   [&](int i) {
                     tfs[i / N][i % N] = T.tf[i];
                     tit[i % N][i / N] = T.ti[i];
                   });
  __syncthreads();
  filter_slot<N, NT>(raw, flt, &s_dc, tid);
  __syncthreads();
  const SlotParams P(T, rate_rows, b, s);
  const int dc = s_dc;
  int* bufA = scr[slot][0];
  int* bufB = scr[slot][1];

#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    const int row = pass * SLOTS + slot;        // the mode's result row
    const int m = min(rank * MPC + min(row, MPC - 1), n_modes - 1);
    const ModeTab<KPL>& t = tab[pass];
    const bool is_nn = m == T.ip[IP_NNMODE] || m >= N_INTRA;
    const int* src = !is_nn && t.filt ? flt : raw;

    int px[KPL], pr[KPL], c[KPL], L[KPL];
    float ld[KPL];
    // ---- prediction and residual ----
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int y = 4 * k + (i16 >> 2), x = 4 * cgx + (i16 & 3);
      const int p = y * N + x;
      px[k] = p;
      int v;
      if (is_nn) {
        v = nnp[p];
      } else if (m == 0) {
        const int Lf = src[LEFT + 1 + y], TR = src[N + 1];
        const int Tp = src[1 + x], BL = src[LEFT + N + 1];
        v = ((Lf << LOG2N) + N + (x + 1) * (TR - Lf) + (Tp << LOG2N) +
             (y + 1) * (BL - Tp)) >> (LOG2N + 1);
      } else if (m == 1) {
        v = dc;
        if (y == 0 && x == 0)
          v = (raw[1] + raw[LEFT + 1] + 2 * dc + 2) >> 2;
        else if (y == 0)
          v = (raw[1 + x] + 3 * dc + 2) >> 2;
        else if (x == 0)
          v = (raw[LEFT + 1 + y] + 3 * dc + 2) >> 2;
      } else {
        const int f = t.frac[k];
        v = ((32 - f) * src[t.a[k]] + f * src[t.b[k]] + 16) >> 5;
        if (m == 26 && x == 0)
          v = min(max(v + ((raw[LEFT + 1 + y] - raw[LEFT]) >> 1), 0), 255);
        if (m == 10 && y == 0)
          v = min(max(v + ((raw[1 + x] - raw[0]) >> 1), 0), 255);
      }
      pr[k] = v;
      bufA[p] = og[p] - v;
    }
    __syncwarp();
    // ---- forward transform: rows, then columns in int64 ----
    // Every pass reads rows of the scratch and of a matrix as 16-byte
    // vectors: the row pass stores its output transposed, so that the
    // column pass reads rows too.
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int y = px[k] / N, x = px[k] % N;
      int r[N], t[N];
      load_row<N>(bufA + y * N, r);
      load_row<N>(tfs[x], t);
      int a = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) a += r[j] * t[j];
      bufB[x * N + y] = (a + (1 << (P.shift1 - 1))) >> P.shift1;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int y = px[k] / N, l = px[k] % N;
      int r[N], t[N];
      load_row<N>(bufB + l * N, r);
      load_row<N>(tfs[y], t);
      long long a = 0;
#pragma unroll
      for (int i = 0; i < N; ++i) a += (long long)t[i] * r[i];
      c[k] = (int)((a + (1LL << (P.shift2 - 1))) >> P.shift2);
    }

    // ---- RDOQ-lite per coefficient ----
    int last_l = -1;
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const float ldf = fabsf((float)c[k]) * P.QS;
      const float ma = fminf(floorf(ldf * P.inv_qstep + 0.5f), 32767.0f);
      const float lo = fmaxf(ma - 1.0f, 1.0f);
      const float d0 = sq(ldf) * P.ES;
      const float cost0 = d0 + P.LAM * (t.sig0[k] + P.dsig0f);
      const float cost_hi = sq(ldf - ma * P.qstep) * P.ES +
                            P.LAM * (t.sig1[k] + P.dsig1f + P.rt.bits(ma));
      const float cost_lo = sq(ldf - lo * P.qstep) * P.ES +
                            P.LAM * (t.sig1[k] + P.dsig1f + P.rt.bits(lo));
      const bool pick_lo = cost_lo < cost_hi;
      const float lvl_nz = pick_lo ? lo : ma;
      const float cost_nz = pick_lo ? cost_lo : cost_hi;
      L[k] = (ma > 0.0f && cost_nz < cost0) ? (int)lvl_nz : 0;
      ld[k] = ldf;
      if (L[k] > 0) last_l = max(last_l, t.scan[k]);
    }
    const int last = group_max<G>(last_l);
    const int lastcg = last >> 4;

    // ---- TU rate and distortion of the decided levels ----
    bool paid[KPL];
    int mb_l = 0, dc_l = 0, dz_l = 0;
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      bool sp = t.scan[k] < last;
      if (N > 4) {
        // Coefficient group k * 2 + lane / 16: its scan index and whether
        // it holds a nonzero level.
        const bool cgnz = (__ballot_sync(FULL, L[k] > 0) >> (lane & 16)) &
                          0xffffu;
        const int cgi = t.cgscan[k] >> 4;
        sp = sp && (cgi == 0 || cgi == lastcg || cgnz);
        if (i16 == 0 && cgi > 0 && cgi < lastcg)
          mb_l += cgnz ? T.ip[IP_CSB1] : T.ip[IP_CSB0];
      }
      paid[k] = sp;
      if (sp) mb_l += L[k] > 0 ? t.sig1i[k] + P.dsig1 : t.sig0i[k] + P.dsig0;
      if (L[k] > 0) mb_l += level_mbits(L[k], P.rt.g1_0, P.rt.g1_1, P.rt.g2_0,
                                        P.rt.g2_1);
      if (t.scan[k] == max(last, 0)) mb_l += t.lastpb[k];
      const float d0 = sq(ld[k]) * P.ES;
      const float dc_el = L[k] > 0 ? sq(ld[k] - (float)L[k] * P.qstep) * P.ES
                                   : d0;
      dc_l += __float2int_rn(dc_el * 4.0f);
      dz_l += __float2int_rn(d0 * 4.0f);
    }
    const int mb = T.ip[IP_CBF1] + P.dcbf1 + group_sum<G>(mb_l);
    const float bits_coded = (float)mb * (1.0f / 256.0f);
    const float d_coded = (float)group_sum<G>(dc_l) * 0.25f;
    const float d_zero = (float)group_sum<G>(dz_l) * 0.25f;
    const float cbf0_extra = (float)P.dcbf0 * (1.0f / 256.0f);
    const float zero_cost = d_zero + (T.fp[FP_LAMCBF0] + P.LAM * cbf0_extra);
    const bool keep = last >= 0 && d_coded + P.LAM * bits_coded < zero_cost;
    const float tu_bits = keep ? bits_coded : T.fp[FP_CBF0] + cbf0_extra;

    // ---- sign-data hiding per 4x4 coefficient group (a half-warp) ----
    int hid_l = 0;
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int Lk = keep ? L[k] : 0;
      const float ldf = ld[k];
      const float lf = (float)Lk;
      const float up = Lk > 0
          ? (sq(ldf - (lf + 1.0f) * P.qstep) - sq(ldf - lf * P.qstep)) * P.ES +
                P.LAM * (P.rt.bits(lf + 1.0f) - P.rt.bits(lf))
          : 1e30f;
      const float dn = Lk >= 2
          ? (sq(ldf - (lf - 1.0f) * P.qstep) - sq(ldf - lf * P.qstep)) * P.ES +
                P.LAM * (P.rt.bits(lf - 1.0f) - P.rt.bits(lf))
          : 1e30f;
      // The group's 16 scan positions w are distinct, so a sum of one
      // bit per lane is a mask: bits 0-15 the nonzero levels, 16-31 the
      // negative coefficients, by w.
      const int w = t.scan[k] & 15;
      const unsigned masks = (unsigned)sum16(
          (Lk > 0 ? 1 << w : 0) | (int)((c[k] < 0 ? 1u : 0u) << (16 + w)));
      const unsigned nz = masks & 0xffffu;
      const int firstp = nz ? __ffs(nz) - 1 : 16;        // least w
      const int lastp = nz ? 31 - __clz(nz) : -1;         // largest w
      const float bag = fminf(up, dn);
      const float minv = fmin16(bag);
      const bool span_ok = lastp - firstp >= 4;
      const int cf = min(max(firstp, 0), 15);
      const int neg_first = (masks >> (16 + cf)) & 1;      // sign at cf < 0
      // Bits 0-15: the w whose change costs least; 16-20: the count of
      // odd levels, whose parity is the parity of the levels' sum.
      const int pp = sum16((bag == minv ? 1 << w : 0) | (Lk & 1) << 16);
      const int pick = __ffs(pp & 0xffff) - 1;             // least such w
      const bool mismatch = span_ok && ((pp >> 16) & 1) != neg_first;
      L[k] = Lk + ((mismatch && w == pick) ? (up <= dn ? 1 : -1) : 0);
      if (span_ok && i16 == 0) ++hid_l;
    }

    // ---- levels, dequantisation, inverse transform, reconstruction ----
    __syncwarp();                    // bufA/bufB reads above are done
    // Dequantised levels stored transposed, as the column pass reads them.
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int qv = ((c[k] > 0) - (c[k] < 0)) * L[k];
      q_s[row][px[k]] = qv;
      const int d = P.iq > 0 ? (qv * P.iq_scale + (1 << (P.iq - 1))) >> P.iq
                           : qv * P.iq_scale * (1 << -P.iq);
      bufA[(px[k] % N) * N + px[k] / N] = min(max(d, -32768), 32767);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int i = px[k] / N, l = px[k] % N;
      int r[N], t[N];
      load_row<N>(bufA + l * N, r);
      load_row<N>(tit[i], t);
      int a = 0;
#pragma unroll
      for (int kk = 0; kk < N; ++kk) a += t[kk] * r[kk];
      bufB[px[k]] = min(max((a + 64) >> 7, -32768), 32767);
    }
    __syncwarp();
    int sse_l = 0, c03 = 0, c46 = 0;
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int i = px[k] / N, x = px[k] % N;
      int r[N], t[N];
      load_row<N>(bufB + i * N, r);
      load_row<N>(tit[x], t);
      int a = 0;
#pragma unroll
      for (int kk = 0; kk < N; ++kk) a += r[kk] * t[kk];
      const int res = min(max((a + (1 << 11)) >> 12, -32768), 32767);
      const int rv = min(max(pr[k] + res, 0), 255);
      rec_s[row][px[k]] = rv;
      const int e = rv - og[px[k]];
      sse_l += e * e;
      // CABAC bin counts of this mode's TU (row order of rate_rows), 8
      // bits a count: c03 = counts 0-3, c46 = counts 4, 5, the nonzero
      // levels and the hidden signs.
      const int Lv = L[k];
      c03 += (paid[k] && Lv == 0) | (paid[k] && Lv > 0) << 8 |
             (Lv == 1) << 16 | (Lv >= 2) << 24;
      c46 += (Lv == 2) | (Lv >= 3) << 8 | (Lv > 0) << 16;
    }
    c46 += hid_l << 24;
    const int sse = group_sum<G>(sse_l);
    c03 = group_sum<G>(c03);
    c46 = group_sum<G>(c46);
    if (gl == 0) {
      const float tu = tu_bits - (float)(c46 >> 24);
      cost_s[row] = (float)sse + P.LAM * (tu + t.mode_bits);
      cnt_s[row][0] = c03 & 255;
      cnt_s[row][1] = (c03 >> 8) & 255;
      cnt_s[row][2] = (c03 >> 16) & 255;
      cnt_s[row][3] = (c03 >> 24) & 255;
      cnt_s[row][4] = c46 & 255;
      cnt_s[row][5] = (c46 >> 8) & 255;
      cnt_s[row][6] = ((c46 >> 16) & 255) > 0;
      cnt_s[row][7] = 1;
    }
    __syncwarp();                    // scratch reused by the next pass
  }

  select_slot<N, CL, MPC, SLOTS, PASSES, NT>(
      s, n_modes, rank, slot, gl == 0, cost_s, cost_all, &costs_in, &s_best,
      &rec_s[0][0], &q_s[0][0], &cnt_s[0][0], cost, best, rec, q, cnt);
}

// ---- n = 16 and 32: one launch, a cluster per slot ----

// Cluster size per slot, warps a mode, the most threads a block and the
// least blocks an SM (a register budget) at n = 16 and 32 (chosen by
// timing in `ops/kernel_variants.py trial`, which reads these lines).
constexpr int CLUSTER_16 = 9;
constexpr int CLUSTER_32 = 3;
constexpr int WARPS_16 = 2;
constexpr int WARPS_32 = 8;
constexpr int MAX_THREADS_16 = 384;
constexpr int MAX_THREADS_32 = 768;
constexpr int MIN_BLOCKS_16 = 2;
constexpr int MIN_BLOCKS_32 = 1;

constexpr int align16(int x) { return (x + 15) / 16 * 16; }

// The shape of the n = 16 / 32 kernel: W warps (G threads) a mode, KPL
// pixels a thread, MPC modes a block (CL blocks a slot), SLOTS modes at a
// time in PASSES passes; then its shared memory, all of it dynamic.  The
// matrices and the transforms' buffers hold doubles (the tensor cores'
// operands).
template <int N, int W, int CL>
struct Large {
  static constexpr int NN = N * N;
  static constexpr int G = 32 * W;
  static constexpr int KPL = NN / G;
  static constexpr int MPC = M_PAD / CL;
  static constexpr int MAXT = N == 16 ? MAX_THREADS_16 : MAX_THREADS_32;
  static constexpr int MINB = N == 16 ? MIN_BLOCKS_16 : MIN_BLOCKS_32;
  static constexpr int PASSES = (MPC * G + MAXT - 1) / MAXT;
  static constexpr int SLOTS = (MPC + PASSES - 1) / PASSES;
  static constexpr int ROWS = SLOTS * PASSES;
  static constexpr int THREADS = SLOTS * G;
  static constexpr int R = 2 * (2 * N + 1);
  // The row stride (elements) of every transform operand: each fragment
  // load of a warp, 8 rows x 4 columns or 4 rows x 8 doubles, hits
  // distinct banks.
  static constexpr int LD = N + 4;
  static constexpr int O_TF = 0;                          // double [N][LD]
  static constexpr int O_TI = O_TF + 8 * N * LD;          // double [N][LD]
  static constexpr int O_OG = O_TI + 8 * N * LD;          // int [NN]
  static constexpr int O_NNP = O_OG + 4 * NN;             // int [NN]
  // Buffers A and B of each mode slot: double [SLOTS][N][LD] each.
  static constexpr int O_BA = O_NNP + 4 * NN;
  static constexpr int O_BB = O_BA + 8 * SLOTS * N * LD;
  static constexpr int O_TAB = O_BB + 8 * SLOTS * N * LD;  // int [5][NN]
  static constexpr int O_REC = O_TAB + 4 * 5 * NN;              // u8 [ROWS][NN]
  static constexpr int O_Q = O_REC + align16(ROWS * NN);        // int [ROWS][NN]
  static constexpr int O_RAW = O_Q + 4 * ROWS * NN;             // int [R]
  static constexpr int O_FLT = O_RAW + align16(4 * R);          // int [R]
  static constexpr int O_CNT = O_FLT + align16(4 * R);          // int [ROWS][8]
  static constexpr int O_COST = O_CNT + 32 * ROWS;              // float [ROWS]
  static constexpr int O_CALL = O_COST + align16(4 * ROWS);     // float [M_PAD]
  static constexpr int O_RED = O_CALL + align16(4 * M_PAD);     // int [SLOTS][24 W]
  static constexpr int O_BAR = O_RED + 4 * SLOTS * 24 * W;      // mbarrier
  static constexpr int O_MISC = O_BAR + 16;                     // int dc, best
  static constexpr int SMEM = O_MISC + 16;
  static_assert(MPC * CL == M_PAD, "cluster size divides 36");
  static_assert(KPL * G == NN && THREADS <= 1024 && SLOTS <= 15, "shape");
};

// The output tiles (8 x 8) of warp w of a mode in an N x N product: TR
// tile rows x TC tile columns, from tile (row0, col0).
template <int N, int W>
struct Tiles {
  static constexpr int NT = N / 8;
  static constexpr int TPW = NT * NT / W;
  static constexpr int TC = TPW < NT ? TPW : NT;
  static constexpr int TR = TPW / TC;
  static constexpr int PER_ROW = NT / TC;
  static_assert(TR * TC * W == NT * NT, "tiles divide among warps");
};

// The four transform passes, each an N x N x N product:
//   forward rows  a(y, k) = sum_x r(y, x) Tf(k, x)      (r: residual)
//   forward cols  c(k, l) = sum_i Tf(k, i) a'(i, l)     (a' = a rounded)
//   inverse cols  e(i, l) = sum_k Ti(k, i) d(k, l)      (d: dequantised)
//   inverse rows  s(i, x) = sum_k e'(i, k) Ti(k, x)     (e' = e rounded)
// each followed by (sum + 2^(shift-1)) >> shift and a clip.  Worst-case
// magnitudes, from the tables (max |Tf| = 23120, max |Ti| = 90, the
// largest sum of |Tf| over a row 2^18 at n = 16 and 2^19 at n = 32, of
// |Ti| over a column 940 / 1862) and the clips, at n = 32 (n = 16 in
// brackets; tests/test_torch_trial_transforms.py recomputes them):
//   forward rows: |r| <= 255, products < 2^23, every partial sum <= 255 *
//     2^19 < 2^27 [2^26]; |a'| <= 32640 after >> 12 [>> 11]
//   forward cols: products <= 32640 * 23120 < 2^30, partial sums <= 32640
//     * 2^19 < 2^34 [2^33]
//   inverse cols: |d| <= 32768 (clip), products < 2^22, partial sums <=
//     32768 * 1862 < 2^26 [32768 * 940 < 2^25]
//   inverse rows: |e'| <= 32768 (clip): the same bounds.
// Every operand, product and partial sum is an integer below 2^53, so the
// FP64 tensor cores give the exact sum in any order.

// out(r, c) = clip((sum_k A(r, k) B(k, c) + 2^(shift-1)) >> shift) over the
// output tiles of warp wg of a mode, A(r, k) = a[r * ars + k * acs], B(k,
// c) = b[k * brs + c * bcs], on the FP64 tensor cores: per step of 4 in k
// each warp loads TR fragments of A and TC of B (a double a lane each) and
// issues TR x TC products.  The rounding shift is floor((sum +
// 2^(shift-1)) 2^-shift): an integer below 2^51 and a power-of-two scale,
// floored exactly by adding 1.5 * 2^52 rounding down; the result stays a
// double for the next pass.
template <int N, int W>
__device__ __forceinline__ void product(const double* a, int ars, int acs,
                                        const double* b, int brs, int bcs,
                                        double* out, int os, int wg,
                                        int lane, int shift, double lo,
                                        double hi) {
  using TL = Tiles<N, W>;
  constexpr int TR = TL::TR, TC = TL::TC;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (wg / TL::PER_ROW) * TR * 8;
  const int c0 = (wg % TL::PER_ROW) * TC * 8;
  double acc[TR][TC][2];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 4) {
    double fa[TR], fb[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      fa[i] = a[(r0 + 8 * i + g) * ars + (k0 + t) * acs];
#pragma unroll
    for (int j = 0; j < TC; ++j)
      fb[j] = b[(k0 + t) * brs + (c0 + 8 * j + g) * bcs];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) mma_f64(acc[i][j], fa[i], fb[j]);
  }
  const double rnd = (double)(1 << (shift - 1));
  const double scale = 1.0 / (double)(1 << shift);
  constexpr double MAGIC = 6755399441055744.0;        // 1.5 * 2^52
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      double v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = __dadd_rd((acc[i][j][e] + rnd) * scale, MAGIC) - MAGIC;
        v[e] = fmin(fmax(v[e], lo), hi);
      }
      *reinterpret_cast<double2*>(
          &out[(r0 + 8 * i + g) * os + c0 + 8 * j + 2 * t]) =
          make_double2(v[0], v[1]);
    }
}

// Exact conversions between int and float of integers below 2^22 in
// magnitude, through the float adder (the conversion units run at a
// quarter of its rate).
__device__ __forceinline__ float i2f_small(int i) {
  return __int_as_float(0x4B400000 + i) - 12582912.0f;
}
__device__ __forceinline__ int f2i_small(float x) {
  return __float_as_int(x + 12582912.0f) - 0x4B400000;
}
// Rates::bits with those conversions (levels up to 32768, micro-bits far
// below 2^22).
__device__ __forceinline__ float bits_small(const Rates& rt, float lvl) {
  return i2f_small(level_mbits(f2i_small(lvl), rt.g1_0, rt.g1_1, rt.g2_0,
                               rt.g2_1)) * (1.0f / 256.0f);
}

// The barrier of one mode's W warps.
template <int W>
__device__ __forceinline__ void mode_sync(int id) {
  if constexpr (W == 1) __syncwarp();
  else bar_named(id, 32 * W);
}

// Sums (or the maximum, K = 1) over the threads of one mode: a warp
// reduction, then with W > 1 one word a warp in `red` (W x K) and the
// mode's barrier.
template <int W, int K>
__device__ __forceinline__ void mode_sum(int (&v)[K], int* red, int wg,
                                         int lane, int id) {
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = __reduce_add_sync(FULL, v[j]);
  if constexpr (W > 1) {
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < K; ++j) red[wg * K + j] = v[j];
    bar_named(id, 32 * W);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = 0;
      for (int w = 0; w < W; ++w) v[j] += red[w * K + j];
    }
  }
}
template <int W>
__device__ __forceinline__ int mode_max(int v, int* red, int wg, int lane,
                                        int id) {
  v = __reduce_max_sync(FULL, v);
  if constexpr (W > 1) {
    if (lane == 0) red[wg] = v;
    bar_named(id, 32 * W);
    v = red[0];
    for (int w = 1; w < W; ++w) v = max(v, red[w]);
  }
  return v;
}

// The 16 flags of this half-warp's lanes (lane i16 -> bit i16).
__device__ __forceinline__ unsigned half_ballot(bool p, int lane) {
  return (__ballot_sync(FULL, p) >> (lane & 16)) & 0xffffu;
}

// The trial of b units of size N (16 or 32): a cluster of CL blocks per
// slot, each with MPC of the 36 mode slots, SLOTS modes at a time.  A block
// loads its slot's references, original and PNN prediction and the two
// matrices (as doubles for the tensor cores) into shared memory and filters
// the references once; each thread loads its pixels' rate tables (the
// scan is the same for every mode at n > 8: one row) into registers, and
// the angular table entries of its next mode one pass ahead (one packed
// word a pixel).  Each mode then runs on its own W warps, KPL pixels a
// thread, with no block barrier: the mode's barriers are __syncwarp (W =
// 1) or a named barrier of its warps; the four transforms are products
// over two per-mode shared buffers (A: residual, coefficients, e'; B: a',
// dequantised levels, the residual's reconstruction); per-TU sums by warp
// reductions and one shared word a warp; per-group flags (sign hiding) by
// ballots, its minimum by half-warp shuffles.  Each mode leaves its cost,
// reconstruction, levels and counts in shared memory and pushes its cost
// into every block of the cluster; each block then takes the first minimum
// (strict <, ascending mode ids) and the block that holds the winner
// writes it.  Thread pixels, in scan order: thread gt of a mode, register
// k holds scan position (k * 2W + gt / 16) * 16 + gt % 16 (the raster
// pixel from the `iscan` table), so a half-warp holds one 4x4 coefficient
// group, lane i16 its scan position i16 (the scan keeps a group's 16
// positions together, which `unit_fused._kernel_tables` checks).
template <int N, int W, int CL>
__global__ void __launch_bounds__(Large<N, W, CL>::THREADS,
                                  Large<N, W, CL>::MINB)
trial_large_kernel(int b, const int* __restrict__ ref_top,
                   const int* __restrict__ ref_left,
                   const int* __restrict__ orig,
                   const float* __restrict__ mode_bits,
                   const int* __restrict__ rate_rows,
                   const int* __restrict__ nn_pred, const Tables T,
                   float* __restrict__ cost, int* __restrict__ best,
                   int* __restrict__ rec, int* __restrict__ q,
                   int* __restrict__ cnt) {
  using K = Large<N, W, CL>;
  constexpr int NN = N * N, G = K::G, KPL = K::KPL, MPC = K::MPC;
  constexpr int SLOTS = K::SLOTS, PASSES = K::PASSES, NT = K::THREADS;
  constexpr int LD = K::LD;
  constexpr int LEFT = 2 * N + 1;
  constexpr int LOG2N = N == 16 ? 4 : 5;

  extern __shared__ __align__(16) unsigned char smem[];
  double* tfs = reinterpret_cast<double*>(smem + K::O_TF);
  double* tis = reinterpret_cast<double*>(smem + K::O_TI);
  int* og = reinterpret_cast<int*>(smem + K::O_OG);
  int* nnp = reinterpret_cast<int*>(smem + K::O_NNP);
  unsigned char* rec_s = smem + K::O_REC;
  int* q_s = reinterpret_cast<int*>(smem + K::O_Q);
  int* raw = reinterpret_cast<int*>(smem + K::O_RAW);
  int* flt = reinterpret_cast<int*>(smem + K::O_FLT);
  int* cnt_s = reinterpret_cast<int*>(smem + K::O_CNT);
  float* cost_s = reinterpret_cast<float*>(smem + K::O_COST);
  float* cost_all = reinterpret_cast<float*>(smem + K::O_CALL);
  uint64_t* costs_in = reinterpret_cast<uint64_t*>(smem + K::O_BAR);
  int* misc = reinterpret_cast<int*>(smem + K::O_MISC);
  // The rate tables of every thread's pixels, [KPL][G] each (the same for
  // every mode slot): lane-consecutive, so each load is one wavefront.
  int* tab = reinterpret_cast<int*>(smem + K::O_TAB);
  const float* t_sig0 = reinterpret_cast<const float*>(tab);
  const float* t_sig1 = t_sig0 + NN;
  const int* t_sig0i = tab + 2 * NN;
  const int* t_sig1i = tab + 3 * NN;
  const int* t_lastpb = tab + 4 * NN;

  const int rank = cluster_rank();
  const int s = blockIdx.x / CL;
  const int tid = threadIdx.x;
  const int n_modes = T.ip[IP_NMODES];
  const int lane = tid & 31;
  const int grp = tid / G;                      // the block's mode slot
  const int gt = tid % G;                       // thread within the mode
  const int wg = gt >> 5;                       // warp within the mode
  const int hw = gt >> 4;                       // half-warp within the mode
  const int i16 = lane & 15;                    // scan position in its group
  const int bar_id = 1 + grp;
  double* bufA = reinterpret_cast<double*>(smem + K::O_BA) + grp * N * LD;
  double* bufB = reinterpret_cast<double*>(smem + K::O_BB) + grp * N * LD;
  int* red = reinterpret_cast<int*>(smem + K::O_RED) + grp * 24 * W;
  // The mode of a pass.  Slots past the block's modes, or past the last
  // mode, repeat the last mode (their results are never read).
  auto mode_of = [&](int pass) {
    return min(rank * MPC + min(pass * SLOTS + grp, MPC - 1), n_modes - 1);
  };

  // ---- this thread's pixels (rate tables: row 0, every mode's) ----
  // Register k holds scan position (k * 2W + hw) * 16 + i16: coefficient
  // group k * 2W + hw (scan order), place i16 in it.
  int px[KPL], ang[KPL];
#pragma unroll
  for (int k = 0; k < KPL; ++k)
    px[k] = __ldg(T.iscan + (k * 2 * W + hw) * 16 + i16);
  // The angular entries (frac | a << 8 | b << 16) of a mode's pixels.
  auto load_ang = [&](int m) {
    const bool angular = m >= 2 && m < N_INTRA;
#pragma unroll
    for (int k = 0; k < KPL; ++k)
      ang[k] = angular ? __ldg(T.ang + (m - 2) * NN + px[k]) : 0;
  };
  load_ang(mode_of(0));

  if (tid == 0) mbar_init_tx(costs_in, M_PAD * 4);
  __syncwarp();                      // .aligned: the warp arrives together
  cluster_arrive_relaxed();

  // ---- the slot's references, original and prediction; the matrices ----
  load_slot<N, NT>(ref_top, ref_left, orig, nn_pred, s, tid, raw, og, nnp,
                   [&](int i) {
    tfs[(i / N) * LD + i % N] = (double)T.tf[i];
    tis[(i / N) * LD + i % N] = (double)T.ti[i];
    // Entry k * G + gt: thread gt's register k (scan position (k * 2W +
    // gt / 16) * 16 + gt % 16).
    const int p = __ldg(T.iscan + ((i / G) * 2 * W + (i % G) / 16) * 16 +
                        i % 16);
    tab[i] = __float_as_int(__ldg(T.sig0 + p));
    tab[NN + i] = __float_as_int(__ldg(T.sig1 + p));
    tab[2 * NN + i] = __ldg(T.sig0i + p);
    tab[3 * NN + i] = __ldg(T.sig1i + p);
    tab[4 * NN + i] = __ldg(T.lastpb + p);
  });
  __syncthreads();
  filter_slot<N, NT>(raw, flt, misc, tid);
  __syncthreads();

  const SlotParams P(T, rate_rows, b, s);
  const int dc = misc[0];
  constexpr double BIG = 2147483647.0;

  for (int pass = 0; pass < PASSES; ++pass) {
    const int row = pass * SLOTS + grp;         // the mode's result row
    const int m = mode_of(pass);
    const bool is_nn = m == T.ip[IP_NNMODE] || m >= N_INTRA;
    const int filt = m < N_INTRA ? __ldg(T.use_filt + m) : 0;
    const int* src = !is_nn && filt ? flt : raw;
    const float mbits = __ldg(mode_bits + s * n_modes + m);

    int pr[KPL], c[KPL], L[KPL];
    float ld[KPL];
    // ---- prediction and residual ----
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int p = px[k], y = p / N, x = p % N;
      int v;
      if (is_nn) {
        v = nnp[p];
      } else if (m == 0) {
        const int Lf = src[LEFT + 1 + y], TR = src[N + 1];
        const int Tp = src[1 + x], BL = src[LEFT + N + 1];
        v = ((Lf << LOG2N) + N + (x + 1) * (TR - Lf) + (Tp << LOG2N) +
             (y + 1) * (BL - Tp)) >> (LOG2N + 1);
      } else if (m == 1) {
        v = dc;
        if constexpr (N <= 16) {
          if (y == 0 && x == 0)
            v = (raw[1] + raw[LEFT + 1] + 2 * dc + 2) >> 2;
          else if (y == 0)
            v = (raw[1 + x] + 3 * dc + 2) >> 2;
          else if (x == 0)
            v = (raw[LEFT + 1 + y] + 3 * dc + 2) >> 2;
        }
      } else {
        const int f = ang[k] & 31;
        v = ((32 - f) * src[(ang[k] >> 8) & 255] + f * src[ang[k] >> 16] +
             16) >> 5;
        if constexpr (N <= 16) {
          if (m == 26 && x == 0)
            v = min(max(v + ((raw[LEFT + 1 + y] - raw[LEFT]) >> 1), 0), 255);
          if (m == 10 && y == 0)
            v = min(max(v + ((raw[1 + x] - raw[0]) >> 1), 0), 255);
        }
      }
      pr[k] = v;
      bufA[y * LD + x] = (double)(og[p] - v);
    }
    if (pass + 1 < PASSES) load_ang(mode_of(pass + 1));
    mode_sync<W>(bar_id);
    // ---- forward transform: rows (A -> B), then columns (B -> A) ----
    product<N, W>(bufA, LD, 1, tfs, 1, LD, bufB, LD, wg, lane, P.shift1,
                  -BIG, BIG);
    mode_sync<W>(bar_id);
    product<N, W>(tfs, LD, 1, bufB, LD, 1, bufA, LD, wg, lane, P.shift2, -BIG,
                  BIG);
    mode_sync<W>(bar_id);

    // ---- RDOQ-lite per coefficient ----
    // A warp whose every rounded level is 0 keeps level 0 without the
    // cost comparisons (the same result).
    float ma[KPL];
    bool any_ma = false;
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      c[k] = __double2int_rn(bufA[(px[k] / N) * LD + px[k] % N]);
      ld[k] = fabsf(i2f_small(c[k])) * P.QS;
      ma[k] = fminf(floorf(ld[k] * P.inv_qstep + 0.5f), 32767.0f);
      L[k] = 0;
      any_ma = any_ma || ma[k] > 0.0f;
    }
    int last_l = -1;
    if (__any_sync(FULL, any_ma)) {
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const float ldf = ld[k];
        const float lo = fmaxf(ma[k] - 1.0f, 1.0f);
        const float d0 = sq(ldf) * P.ES;
        const float s1 = t_sig1[k * G + gt];
        const float cost0 = d0 + P.LAM * (t_sig0[k * G + gt] + P.dsig0f);
        const float cost_hi = sq(ldf - ma[k] * P.qstep) * P.ES +
                              P.LAM * (s1 + P.dsig1f + bits_small(P.rt, ma[k]));
        const float cost_lo = sq(ldf - lo * P.qstep) * P.ES +
                              P.LAM * (s1 + P.dsig1f + bits_small(P.rt, lo));
        const bool pick_lo = cost_lo < cost_hi;
        const float lvl_nz = pick_lo ? lo : ma[k];
        const float cost_nz = pick_lo ? cost_lo : cost_hi;
        L[k] = (ma[k] > 0.0f && cost_nz < cost0) ? f2i_small(lvl_nz) : 0;
        if (L[k] > 0) last_l = (k * 2 * W + hw) * 16 + i16;   // grows with k
      }
    }
    const int last = mode_max<W>(last_l, red, wg, lane, bar_id);
    const int lastcg = last >> 4;
    const float cbf0_extra = (float)P.dcbf0 * (1.0f / 256.0f);
    if (last < 0) {
      // Every level is 0: the TU is not coded, nothing is hidden and the
      // inverse transform is 0, so the reconstruction is the prediction
      // and every bin count but the last is 0 (the same result).
      int sse[1] = {0};
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const int p = px[k];
        const int rv = min(max(pr[k], 0), 255);
        rec_s[row * NN + p] = (unsigned char)rv;
        q_s[row * NN + p] = 0;
        sse[0] += (rv - og[p]) * (rv - og[p]);
      }
      mode_sum<W, 1>(sse, red + 16 * W, wg, lane, bar_id);
      if (gt == 0) {
        cost_s[row] = (float)sse[0] +
                      P.LAM * ((T.fp[FP_CBF0] + cbf0_extra) + mbits);
        for (int j = 0; j < 8; ++j) cnt_s[row * 8 + j] = j == 7;
      }
      continue;
    }

    // ---- TU rate and distortion of the decided levels ----
    bool paid[KPL];
    int sums[3] = {0, 0, 0};                    // micro-bits, 4 d_coded, 4 d_zero
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      // Coefficient group cgi (scan order) of this half-warp: whether it
      // holds a nonzero level.
      const int cgi = k * 2 * W + hw;
      const int scan = cgi * 16 + i16;
      const bool cgnz = half_ballot(L[k] > 0, lane) != 0;
      const bool sp = scan < last && (cgi == 0 || cgi == lastcg || cgnz);
      if (i16 == 0 && cgi > 0 && cgi < lastcg)
        sums[0] += cgnz ? T.ip[IP_CSB1] : T.ip[IP_CSB0];
      paid[k] = sp;
      if (sp)
        sums[0] += L[k] > 0 ? t_sig1i[k * G + gt] + P.dsig1
                            : t_sig0i[k * G + gt] + P.dsig0;
      if (L[k] > 0)
        sums[0] += level_mbits(L[k], P.rt.g1_0, P.rt.g1_1, P.rt.g2_0,
                               P.rt.g2_1);
      if (scan == max(last, 0)) sums[0] += t_lastpb[k * G + gt];
      const float d0 = sq(ld[k]) * P.ES;
      const float dc_el =
          L[k] > 0 ? sq(ld[k] - i2f_small(L[k]) * P.qstep) * P.ES : d0;
      sums[1] += __float2int_rn(dc_el * 4.0f);
      sums[2] += __float2int_rn(d0 * 4.0f);
    }
    mode_sum<W, 3>(sums, red + 8 * W, wg, lane, bar_id);
    const int mb = T.ip[IP_CBF1] + P.dcbf1 + sums[0];
    const float bits_coded = (float)mb * (1.0f / 256.0f);
    const float d_coded = (float)sums[1] * 0.25f;
    const float d_zero = (float)sums[2] * 0.25f;
    const float zero_cost = d_zero + (T.fp[FP_LAMCBF0] + P.LAM * cbf0_extra);
    const bool keep = last >= 0 && d_coded + P.LAM * bits_coded < zero_cost;
    const float tu_bits = keep ? bits_coded : T.fp[FP_CBF0] + cbf0_extra;

    // ---- sign-data hiding per 4x4 coefficient group (a half-warp) ----
    // Lane i16 of a half-warp holds the group's scan position w = i16, so
    // a ballot's 16 bits are the group's flags by w.  A group changes
    // only if its nonzero levels span 4 or more positions; a warp with no
    // such group skips the costs (no level changes).  The groups' minima
    // are taken together, one shuffle round for all of them at a time.
    int hid_l = 0;
    if (!keep) {
#pragma unroll
      for (int k = 0; k < KPL; ++k) L[k] = 0;
    } else {
      unsigned span = 0;                        // bit k: group k spans >= 4
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const unsigned nz = half_ballot(L[k] > 0, lane);
        const int firstp = nz ? __ffs(nz) - 1 : 16;      // least w
        const int lastp = nz ? 31 - __clz(nz) : -1;       // largest w
        if (lastp - firstp >= 4) span |= 1u << k;
      }
      if (__any_sync(FULL, span != 0)) {
        float up[KPL], dn[KPL], mn[KPL];
#pragma unroll
        for (int k = 0; k < KPL; ++k) {
          const float ldf = ld[k];
          const float lf = i2f_small(L[k]);
          const float here = sq(ldf - lf * P.qstep);
          const float bh = bits_small(P.rt, lf);
          up[k] = L[k] > 0
              ? (sq(ldf - (lf + 1.0f) * P.qstep) - here) * P.ES +
                    P.LAM * (bits_small(P.rt, lf + 1.0f) - bh)
              : 1e30f;
          dn[k] = L[k] >= 2
              ? (sq(ldf - (lf - 1.0f) * P.qstep) - here) * P.ES +
                    P.LAM * (bits_small(P.rt, lf - 1.0f) - bh)
              : 1e30f;
          mn[k] = fminf(up[k], dn[k]);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
#pragma unroll
          for (int k = 0; k < KPL; ++k)
            mn[k] = fminf(mn[k], __shfl_xor_sync(FULL, mn[k], o));
#pragma unroll
        for (int k = 0; k < KPL; ++k) {
          const unsigned nz = half_ballot(L[k] > 0, lane);
          const unsigned neg = half_ballot(c[k] < 0, lane);
          const unsigned odd = half_ballot(L[k] & 1, lane);
          const unsigned at_min =
              half_ballot(fminf(up[k], dn[k]) == mn[k], lane);
          const bool span_ok = (span >> k) & 1;
          const int cf = nz ? __ffs(nz) - 1 : 15;         // first nonzero w
          // The levels' sum is odd iff an odd count of them is odd; the
          // sign at the first nonzero w; the least w of the cheapest change.
          const bool mismatch =
              span_ok && (int)(__popc(odd) & 1) != (int)((neg >> cf) & 1);
          const int pick = __ffs(at_min) - 1;
          L[k] += (mismatch && i16 == pick) ? (up[k] <= dn[k] ? 1 : -1) : 0;
          if (span_ok && i16 == 0) ++hid_l;
        }
      }
    }

    // ---- levels, dequantisation, inverse transform, reconstruction ----
    // B is free: its last reads (the forward columns) were before the
    // barrier after them.
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int p = px[k];
      const int qv = ((c[k] > 0) - (c[k] < 0)) * L[k];
      q_s[row * NN + p] = qv;
      const int d = P.iq > 0 ? (qv * P.iq_scale + (1 << (P.iq - 1))) >> P.iq
                           : qv * P.iq_scale * (1 << -P.iq);
      bufB[(p / N) * LD + p % N] = (double)min(max(d, -32768), 32767);
    }
    mode_sync<W>(bar_id);
    product<N, W>(tis, 1, LD, bufB, LD, 1, bufA, LD, wg, lane, 7, -32768.0,
                  32767.0);
    mode_sync<W>(bar_id);
    product<N, W>(bufA, LD, 1, tis, LD, 1, bufB, LD, wg, lane, 12, -32768.0,
                  32767.0);
    mode_sync<W>(bar_id);
    // Sums: SSE, then the CABAC bin counts of this mode's TU (row order of
    // rate_rows) two to a word (16 bits each), the last word the nonzero
    // levels and the hidden signs.
    int fin[5] = {0, 0, 0, 0, hid_l << 16};
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int p = px[k];
      const int rv =
          min(max(pr[k] + __double2int_rn(bufB[(p / N) * LD + p % N]), 0),
              255);
      rec_s[row * NN + p] = (unsigned char)rv;
      const int e = rv - og[p];
      fin[0] += e * e;
      const int Lv = L[k];
      fin[1] += (paid[k] && Lv == 0) | (paid[k] && Lv > 0) << 16;
      fin[2] += (Lv == 1) | (Lv >= 2) << 16;
      fin[3] += (Lv == 2) | (Lv >= 3) << 16;
      fin[4] += Lv > 0;
    }
    mode_sum<W, 5>(fin, red + 16 * W, wg, lane, bar_id);
    if (gt == 0) {
      const float tu = tu_bits - (float)(fin[4] >> 16);
      cost_s[row] = (float)fin[0] + P.LAM * (tu + mbits);
      int* cr = cnt_s + row * 8;
      cr[0] = fin[1] & 0xffff;
      cr[1] = fin[1] >> 16;
      cr[2] = fin[2] & 0xffff;
      cr[3] = fin[2] >> 16;
      cr[4] = fin[3] & 0xffff;
      cr[5] = fin[3] >> 16;
      cr[6] = (fin[4] & 0xffff) > 0;
      cr[7] = 1;
    }
  }

  select_slot<N, CL, MPC, SLOTS, PASSES, NT>(
      s, n_modes, rank, grp, gt == 0, cost_s, cost_all, costs_in, misc + 1,
      rec_s, q_s, cnt_s, cost, best, rec, q, cnt);
}

// ---- the first design, at every n (a block per (slot, mode), then
// a select kernel), reached only from `ops/kernel_variants.py` ----

template <int N>
__global__ void __launch_bounds__(256)
trial_modes_kernel(int b, const int* __restrict__ ref_top,
                   const int* __restrict__ ref_left,
                   const int* __restrict__ orig,
                   const float* __restrict__ mode_bits,
                   const int* __restrict__ rate_rows,
                   const int* __restrict__ nn_pred, const Tables T,
                   float* __restrict__ cost_m, int* __restrict__ rec_m,
                   int* __restrict__ q_m, int* __restrict__ cnt_m) {
  constexpr int NN = N * N;
  constexpr int S = 2 * N + 1;        // references per side
  constexpr int R = 2 * S;            // [top (corner first) | left]
  constexpr int LEFT = S;
  constexpr int LOG2N = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  constexpr int NCG = NN / 16;        // 4x4 coefficient groups
  constexpr int CGW = N / 4;

  const int s = blockIdx.x;           // slot
  const int m = blockIdx.y;           // mode
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int n_modes = T.ip[IP_NMODES];

  __shared__ int raw[R], flt[R];
  __shared__ int pred[NN];
  __shared__ int bufx[NN];            // residual -> coefficients -> e1
  __shared__ int bufy[NN];            // row pass -> dequantised levels
  __shared__ int lvl[NN];
  __shared__ float ldfs[NN], up[NN], dn[NN];
  __shared__ unsigned char paid[NN];
  __shared__ int cgnz[NCG];
  __shared__ int acc[16];
  __shared__ int s_keep;
  __shared__ float s_tu_bits;
  enum { A_LAST, A_SIG, A_LVL, A_LB, A_CSB, A_DC, A_DZ, A_HID, A_SSE,
         A_C0, A_C1, A_C2, A_C3, A_C4, A_C5, A_C6 };

  // ---- references and their [1 2 1] / bilinear filtering ----
  for (int i = tid; i < R; i += nth)
    raw[i] = i < LEFT ? ref_top[s * S + i] : ref_left[s * S + i - LEFT];
  for (int i = tid; i < NCG; i += nth) cgnz[i] = 0;
  if (tid < 16) acc[tid] = tid == A_LAST ? -1 : 0;
  __syncthreads();
  bool strong = false;
  if (N == 32) {
    const int c0 = raw[0], tr = raw[2 * N], tn = raw[N];
    const int bl = raw[LEFT + 2 * N], ln = raw[LEFT + N];
    strong = abs(bl + c0 - 2 * ln) < 8 && abs(c0 + tr - 2 * tn) < 8;
  }
  for (int i = tid; i < R; i += nth) {
    const bool left = i >= LEFT;
    const int j = left ? i - LEFT : i;
    int v;
    if (strong) {
      const int c0 = raw[0];
      const int end = left ? raw[LEFT + 2 * N] : raw[2 * N];
      v = j == 0 ? c0 : j == 2 * N ? end
                     : ((2 * N - j) * c0 + j * end + 32) >> 6;
    } else if (j == 0) {
      v = (raw[LEFT + 1] + 2 * raw[0] + raw[1] + 2) >> 2;
    } else if (j == 2 * N) {
      v = raw[i];
    } else if (!left) {
      v = (raw[j - 1] + 2 * raw[j] + raw[j + 1] + 2) >> 2;
    } else {
      const int a = j == 1 ? raw[0] : raw[LEFT + j - 1];
      v = (a + 2 * raw[LEFT + j] + raw[LEFT + j + 1] + 2) >> 2;
    }
    flt[i] = v;
  }
  __syncthreads();

  // ---- prediction of mode m and residual ----
  const bool is_nn = m == T.ip[IP_NNMODE] || m >= N_INTRA;
  const int* src = !is_nn && T.use_filt[m] ? flt : raw;
  int dc = 0;
  if (m == 1) {
    for (int i = 1; i <= N; ++i) dc += raw[i] + raw[LEFT + i];
    dc = (dc + N) >> (LOG2N + 1);
  }
  for (int p = tid; p < NN; p += nth) {
    const int y = p / N, x = p % N;
    int v;
    if (is_nn) {
      v = nn_pred != nullptr ? nn_pred[s * NN + p] : 0;
    } else if (m == 0) {
      const int L = src[LEFT + 1 + y], TR = src[N + 1];
      const int Tp = src[1 + x], BL = src[LEFT + N + 1];
      v = ((L << LOG2N) + N + (x + 1) * (TR - L) + (Tp << LOG2N) +
           (y + 1) * (BL - Tp)) >> (LOG2N + 1);
    } else if (m == 1) {
      v = dc;
      if (N <= 16) {
        if (y == 0 && x == 0)
          v = (raw[1] + raw[LEFT + 1] + 2 * dc + 2) >> 2;
        else if (y == 0)
          v = (raw[1 + x] + 3 * dc + 2) >> 2;
        else if (x == 0)
          v = (raw[LEFT + 1 + y] + 3 * dc + 2) >> 2;
      }
    } else {
      const int t = (m - 2) * NN + p;
      const int f = T.frac[t];
      v = ((32 - f) * src[T.g0[t]] + f * src[T.g1[t]] + 16) >> 5;
      if (N <= 16 && m == 26 && x == 0)
        v = min(max(v + ((raw[LEFT + 1 + y] - raw[LEFT]) >> 1), 0), 255);
      if (N <= 16 && m == 10 && y == 0)
        v = min(max(v + ((raw[1 + x] - raw[0]) >> 1), 0), 255);
    }
    pred[p] = v;
    bufx[p] = orig[s * NN + p] - v;
  }
  __syncthreads();

  // ---- forward transform: rows, then columns in int64 ----
  const int shift1 = T.ip[IP_SHIFT1], shift2 = T.ip[IP_SHIFT2];
  for (int p = tid; p < NN; p += nth) {
    const int y = p / N, k = p % N;
    int a = 0;
    for (int x = 0; x < N; ++x) a += bufx[y * N + x] * T.tf[k * N + x];
    bufy[p] = (a + (1 << (shift1 - 1))) >> shift1;
  }
  __syncthreads();
  for (int p = tid; p < NN; p += nth) {
    const int k = p / N, l = p % N;
    long long a = 0;
    for (int i = 0; i < N; ++i)
      a += (long long)T.tf[k * N + i] * bufy[i * N + l];
    bufx[p] = (int)((a + (1LL << (shift2 - 1))) >> shift2);
  }
  __syncthreads();

  // ---- RDOQ-lite per coefficient ----
  const int rows_mode = T.ip[IP_ROWS] == 1 ? 0 : m;
  const int* scan = T.scan + rows_mode * NN;
  const float* sig0 = T.sig0 + rows_mode * NN;
  const float* sig1 = T.sig1 + rows_mode * NN;
  const int* sig0i = T.sig0i + rows_mode * NN;
  const int* sig1i = T.sig1i + rows_mode * NN;
  const int dsig0 = rate_row(rate_rows, 0, b, s);
  const int dsig1 = rate_row(rate_rows, 1, b, s);
  const Rates rt{T.ip[IP_G1_0] + rate_row(rate_rows, 2, b, s),
                 T.ip[IP_G1_1] + rate_row(rate_rows, 3, b, s),
                 T.ip[IP_G2_0] + rate_row(rate_rows, 4, b, s),
                 T.ip[IP_G2_1] + rate_row(rate_rows, 5, b, s)};
  const int dcbf0 = rate_row(rate_rows, 6, b, s);
  const int dcbf1 = rate_row(rate_rows, 7, b, s);
  const float QS = T.fp[FP_QSCALE], ES = T.fp[FP_ERRSCALE];
  const float LAM = T.fp[FP_LAM];
  const int qbits = T.ip[IP_QBITS];
  const float qstep = ldexpf(1.0f, qbits);
  const float inv_qstep = ldexpf(1.0f, -qbits);
  const float dsig0f = (float)dsig0 * (1.0f / 256.0f);
  const float dsig1f = (float)dsig1 * (1.0f / 256.0f);
  for (int p = tid; p < NN; p += nth) {
    const float ldf = fabsf((float)bufx[p]) * QS;
    const float ma = fminf(floorf(ldf * inv_qstep + 0.5f), 32767.0f);
    const float lo = fmaxf(ma - 1.0f, 1.0f);
    const float d0 = sq(ldf) * ES;
    const float cost0 = d0 + LAM * (sig0[p] + dsig0f);
    const float cost_hi = sq(ldf - ma * qstep) * ES +
                          LAM * (sig1[p] + dsig1f + rt.bits(ma));
    const float cost_lo = sq(ldf - lo * qstep) * ES +
                          LAM * (sig1[p] + dsig1f + rt.bits(lo));
    const bool pick_lo = cost_lo < cost_hi;
    const float lvl_nz = pick_lo ? lo : ma;
    const float cost_nz = pick_lo ? cost_lo : cost_hi;
    const int L = (ma > 0.0f && cost_nz < cost0) ? (int)lvl_nz : 0;
    lvl[p] = L;
    ldfs[p] = ldf;
    if (L > 0) {
      atomicMax(&acc[A_LAST], scan[p]);
      atomicOr(&cgnz[((p / N) >> 2) * CGW + ((p % N) >> 2)], 1);
    }
  }
  __syncthreads();

  // ---- TU rate and distortion of the decided levels ----
  const int last = acc[A_LAST];
  const int lastcg = last >> 4;
  for (int p = tid; p < NN; p += nth) {
    const int y = p / N, x = p % N;
    const int cg = (y >> 2) * CGW + (x >> 2);
    bool sp = scan[p] < last;
    if (NCG > 1) {
      const int cgi = scan[(y & ~3) * N + (x & ~3)] >> 4;
      sp = sp && (cgi == 0 || cgi == lastcg || cgnz[cg]);
    }
    paid[p] = sp;
    const int L = lvl[p];
    const float ldf = ldfs[p];
    const float d0 = sq(ldf) * ES;
    if (sp) atomicAdd(&acc[A_SIG], L > 0 ? sig1i[p] + dsig1 : sig0i[p] + dsig0);
    if (L > 0)
      atomicAdd(&acc[A_LVL],
                level_mbits(L, rt.g1_0, rt.g1_1, rt.g2_0, rt.g2_1));
    if (scan[p] == max(last, 0)) atomicAdd(&acc[A_LB], T.lastpb[p]);
    const float dc_el = L > 0 ? sq(ldf - (float)L * qstep) * ES : d0;
    atomicAdd(&acc[A_DC], __float2int_rn(dc_el * 4.0f));
    atomicAdd(&acc[A_DZ], __float2int_rn(d0 * 4.0f));
  }
  if (NCG > 1) {
    for (int cg = tid; cg < NCG; cg += nth) {
      const int cgi = scan[(cg / CGW) * 4 * N + (cg % CGW) * 4] >> 4;
      if (cgi > 0 && cgi < lastcg)
        atomicAdd(&acc[A_CSB], cgnz[cg] ? T.ip[IP_CSB1] : T.ip[IP_CSB0]);
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int mb = T.ip[IP_CBF1] + dcbf1 + acc[A_LB] + acc[A_CSB] +
                   acc[A_SIG] + acc[A_LVL];
    const float bits_coded = (float)mb * (1.0f / 256.0f);
    const float d_coded = (float)acc[A_DC] * 0.25f;
    const float d_zero = (float)acc[A_DZ] * 0.25f;
    const float cbf0_extra = (float)dcbf0 * (1.0f / 256.0f);
    const float zero_cost = d_zero + (T.fp[FP_LAMCBF0] + LAM * cbf0_extra);
    const int keep = last >= 0 && d_coded + LAM * bits_coded < zero_cost;
    s_keep = keep;
    s_tu_bits = keep ? bits_coded : T.fp[FP_CBF0] + cbf0_extra;
  }
  __syncthreads();

  // ---- sign-data hiding per 4x4 coefficient group ----
  const bool keep = s_keep;
  for (int p = tid; p < NN; p += nth) {
    const int L = keep ? lvl[p] : 0;
    lvl[p] = L;
    const float ldf = ldfs[p];
    const float lf = (float)L;
    up[p] = L > 0 ? (sq(ldf - (lf + 1.0f) * qstep) - sq(ldf - lf * qstep)) *
                            ES + LAM * (rt.bits(lf + 1.0f) - rt.bits(lf))
                  : 1e30f;
    dn[p] = L >= 2 ? (sq(ldf - (lf - 1.0f) * qstep) - sq(ldf - lf * qstep)) *
                             ES + LAM * (rt.bits(lf - 1.0f) - rt.bits(lf))
                   : 1e30f;
  }
  __syncthreads();
  for (int cg = tid; cg < NCG; cg += nth) {
    const int base = (cg / CGW) * 4 * N + (cg % CGW) * 4;
    int firstp = 16, lastp = -1, par = 0;
    float minv = 3.0e38f;
    for (int i = 0; i < 16; ++i) {
      const int p = base + (i >> 2) * N + (i & 3);
      const int w = scan[p] & 15;
      if (lvl[p] > 0) {
        firstp = min(firstp, w);
        lastp = max(lastp, w);
      }
      par += lvl[p];
      minv = fminf(minv, fminf(up[p], dn[p]));
    }
    const bool span_ok = lastp - firstp >= 4;
    const int cf = min(max(firstp, 0), 15);
    int sfirst = 0, pick = 16;
    for (int i = 0; i < 16; ++i) {
      const int p = base + (i >> 2) * N + (i & 3);
      const int w = scan[p] & 15;
      if (w == cf) sfirst += (bufx[p] > 0) - (bufx[p] < 0);
      if (fminf(up[p], dn[p]) == minv) pick = min(pick, w);
    }
    const bool mismatch = span_ok && (par & 1) != (sfirst < 0 ? 1 : 0);
    if (mismatch) {
      const int pk = min(max(pick, 0), 15);
      for (int i = 0; i < 16; ++i) {
        const int p = base + (i >> 2) * N + (i & 3);
        if ((scan[p] & 15) == pk) lvl[p] += up[p] <= dn[p] ? 1 : -1;
      }
    }
    if (span_ok) atomicAdd(&acc[A_HID], 1);
  }
  __syncthreads();

  // ---- levels, dequantisation, inverse transform, reconstruction ----
  const int iq = T.ip[IP_IQSHIFT], iq_scale = T.ip[IP_IQSCALE];
  const size_t out0 = (size_t)(s * M_PAD + m) * NN;
  for (int p = tid; p < NN; p += nth) {
    const int c = bufx[p];
    const int q = ((c > 0) - (c < 0)) * lvl[p];
    q_m[out0 + p] = q;
    int d = iq > 0 ? (q * iq_scale + (1 << (iq - 1))) >> iq
                   : q * iq_scale * (1 << -iq);
    bufy[p] = min(max(d, -32768), 32767);
  }
  __syncthreads();
  for (int p = tid; p < NN; p += nth) {
    const int i = p / N, l = p % N;
    int a = 0;
    for (int k = 0; k < N; ++k) a += T.ti[k * N + i] * bufy[k * N + l];
    bufx[p] = min(max((a + 64) >> 7, -32768), 32767);
  }
  __syncthreads();
  for (int p = tid; p < NN; p += nth) {
    const int i = p / N, x = p % N;
    int a = 0;
    for (int k = 0; k < N; ++k) a += bufx[i * N + k] * T.ti[k * N + x];
    const int r = min(max((a + (1 << 11)) >> 12, -32768), 32767);
    const int rec = min(max(pred[p] + r, 0), 255);
    rec_m[out0 + p] = rec;
    const int e = rec - orig[s * NN + p];
    atomicAdd(&acc[A_SSE], e * e);
    // CABAC bin counts of this mode's TU (row order of rate_rows).
    const int L = lvl[p];
    if (paid[p]) atomicAdd(&acc[L > 0 ? A_C1 : A_C0], 1);
    if (L == 1) atomicAdd(&acc[A_C2], 1);
    if (L >= 2) atomicAdd(&acc[A_C3], 1);
    if (L == 2) atomicAdd(&acc[A_C4], 1);
    if (L >= 3) atomicAdd(&acc[A_C5], 1);
    if (L > 0) atomicOr(&acc[A_C6], 1);
  }
  __syncthreads();
  if (tid == 0) {
    const float tu_bits = s_tu_bits - (float)acc[A_HID];
    cost_m[s * M_PAD + m] =
        (float)acc[A_SSE] + LAM * (tu_bits + mode_bits[s * n_modes + m]);
    int* cnt = cnt_m + (size_t)(s * M_PAD + m) * 8;
    cnt[0] = acc[A_C0];
    cnt[1] = acc[A_C1];
    cnt[2] = acc[A_C2];
    cnt[3] = acc[A_C3];
    cnt[4] = acc[A_C4];
    cnt[5] = acc[A_C5];
    cnt[6] = acc[A_C6];
    cnt[7] = 1;
  }
}

// First minimum over ascending mode ids per slot, then gather.
__global__ void select_kernel(int nn, int n_modes,
                              const float* __restrict__ cost_m,
                              const int* __restrict__ rec_m,
                              const int* __restrict__ q_m,
                              const int* __restrict__ cnt_m,
                              float* __restrict__ cost,
                              int* __restrict__ best, int* __restrict__ rec,
                              int* __restrict__ q, int* __restrict__ cnt) {
  const int s = blockIdx.x;
  __shared__ int sb;
  if (threadIdx.x == 0) {
    float mv = cost_m[s * M_PAD];
    int bi = 0;
    for (int m = 1; m < n_modes; ++m) {
      const float c = cost_m[s * M_PAD + m];
      if (c < mv) {
        mv = c;
        bi = m;
      }
    }
    sb = bi;
    cost[s] = mv;
    best[s] = bi;
  }
  __syncthreads();
  const size_t src = (size_t)(s * M_PAD + sb) * nn;
  for (int p = threadIdx.x; p < nn; p += blockDim.x) {
    rec[(size_t)s * nn + p] = rec_m[src + p];
    q[(size_t)s * nn + p] = q_m[src + p];
  }
  if (threadIdx.x < 8)
    cnt[s * 8 + threadIdx.x] =
        cnt_m[(size_t)(s * M_PAD + sb) * 8 + threadIdx.x];
}

template <int N>
void launch_modes(int b, cudaStream_t st, const int* rt, const int* rl,
                  const int* orig, const float* mb, const int* rr,
                  const int* nnp, const Tables& T, int* out) {
  const int n_modes = T.ip[IP_NMODES];
  const int nn = N * N;
  float* cost = reinterpret_cast<float*>(out);
  int* best = out + b;
  int* rec = best + b;
  int* q = rec + (size_t)b * nn;
  int* cnt = q + (size_t)b * nn;
  float* cost_m = reinterpret_cast<float*>(cnt + (size_t)b * 8);
  int* rec_m = reinterpret_cast<int*>(cost_m) + (size_t)b * M_PAD;
  int* q_m = rec_m + (size_t)b * M_PAD * nn;
  int* cnt_m = q_m + (size_t)b * M_PAD * nn;
  const int threads = N * N < 256 ? N * N : 256;
  trial_modes_kernel<N><<<dim3(b, n_modes), threads, 0, st>>>(
      b, rt, rl, orig, mb, rr, nnp, T, cost_m, rec_m, q_m, cnt_m);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  select_kernel<<<b, 256, 0, st>>>(nn, n_modes, cost_m, rec_m, q_m, cnt_m,
                                   cost, best, rec, q, cnt);
}

template <int N, int CL>
cudaError_t launch_small(int b, cudaStream_t st, const int* rt, const int* rl,
                         const int* orig, const float* mb, const int* rr,
                         const int* nnp, const Tables& T, int* out) {
  const int nn = N * N;
  float* cost = reinterpret_cast<float*>(out);
  int* best = out + b;
  int* rec = best + b;
  int* q = rec + (size_t)b * nn;
  int* cnt = q + (size_t)b * nn;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * CL);
  cfg.blockDim = dim3(Small<N, CL>::THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, trial_small_kernel<N, CL>, b, rt, rl, orig,
                            mb, rr, nnp, T, cost, best, rec, q, cnt);
}

// Shared memory above 48 KB and clusters above 8 blocks need the kernel's
// attributes set, once per process; the launch checks the result.
template <int N, int W, int CL>
cudaError_t large_attributes() {
  cudaError_t e = cudaFuncSetAttribute(
      trial_large_kernel<N, W, CL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Large<N, W, CL>::SMEM);
  if (e == cudaSuccess && CL > 8)
    e = cudaFuncSetAttribute(trial_large_kernel<N, W, CL>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return e;
}

template <int N, int W, int CL>
cudaError_t launch_large(int b, cudaStream_t st, const int* rt,
                         const int* rl, const int* orig, const float* mb,
                         const int* rr, const int* nnp, const Tables& T,
                         int* out) {
  using K = Large<N, W, CL>;
  static const cudaError_t attributes = large_attributes<N, W, CL>();
  if (attributes != cudaSuccess) return attributes;
  const int nn = N * N;
  float* cost = reinterpret_cast<float*>(out);
  int* best = out + b;
  int* rec = best + b;
  int* q = rec + (size_t)b * nn;
  int* cnt = q + (size_t)b * nn;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * CL);
  cfg.blockDim = dim3(K::THREADS);
  cfg.dynamicSmemBytes = K::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, trial_large_kernel<N, W, CL>, b, rt, rl,
                            orig, mb, rr, nnp, T, cost, best, rec, q, cnt);
}

}  // namespace

// `tables` is a host pointer to the table set's Tables struct; `out` the
// call's output buffer (layout above); `rate_rows` and `nn_pred` may be
// null.
extern "C" int unit_trial(int n, int b, const void* ref_top,
                          const void* ref_left, const void* orig,
                          const void* mode_bits, const void* rate_rows,
                          const void* nn_pred, const void* tables, void* out,
                          void* stream) {
  const Tables& T = *static_cast<const Tables*>(tables);
  const int n_modes = T.ip[IP_NMODES];
  if (b < 1 || n_modes < 1 || n_modes > M_PAD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* rt = (const int*)ref_top;
  const int* rl = (const int*)ref_left;
  const int* og = (const int*)orig;
  const float* mb = (const float*)mode_bits;
  const int* rr = (const int*)rate_rows;
  const int* nnp = (const int*)nn_pred;
  int* o = (int*)out;
  cudaError_t e = cudaSuccess;
  switch (n) {
    case 4:
      e = launch_small<4, CLUSTER_4>(b, st, rt, rl, og, mb, rr, nnp, T, o);
      break;
    case 8:
      e = launch_small<8, CLUSTER_8>(b, st, rt, rl, og, mb, rr, nnp, T, o);
      break;
    case 16:
      e = launch_large<16, WARPS_16, CLUSTER_16>(b, st, rt, rl, og, mb, rr,
                                                 nnp, T, o);
      break;
    case 32:
      e = launch_large<32, WARPS_32, CLUSTER_32>(b, st, rt, rl, og, mb, rr,
                                                 nnp, T, o);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

extern "C" const char* unit_trial_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
