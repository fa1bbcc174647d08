// Fused unit trial of the wavefront encoder, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_run` of the JAX package
// (context_adaptive_neural_network_based_prediction_tpu/ops/unit_fused.py):
// its single-block form (pallas_call at :785, n = 4 and 8) and its
// mode-group grid form (pallas_call at :870, n = 16 and 32).  One launch
// tries every intra mode of b units of size n x n (one per wavefront slot)
// and keeps the cheapest:
//   [1 2 1] reference filter (bilinear at 32x32 when flat) -> planar, DC and
//   33 angular predictions -> residual -> exact forward DST/DCT -> RDOQ-lite
//   (round / round-1 / 0, TU rate, cbf=0 option) -> sign-data hiding per
//   4x4 group -> dequant, inverse transform, reconstruction -> SSE +
//   lambda * bits -> first minimum over ascending mode ids.
//
// Design.  The TPU kernel turns prediction and transforms into matrix
// products on a (pixels, modes x slots) layout because that is what its
// matrix unit runs well.  Here a block of threads does one (slot, mode)
// trial: grid (b, n_modes), n*n pixels (at most 256 threads, looping), all
// working arrays in shared memory (about 30 KB at n = 32).  Prediction is
// direct integer angular interpolation ((32-f)*a + f*b + 16) >> 5 from the
// angular gather tables, which equals the reference's float32 products of
// small integers exactly.  Transforms are integer row and column passes
// (the column pass of the forward transform in int64), equal to the
// reference's hi/lo-split products.  Per-TU sums are integer shared-memory
// atomics, so their order does not matter.  The float cost chain repeats
// the reference's float32 operations in the same order; the file is
// compiled with --fmad=false so that no a*b+c is contracted.  A second
// small kernel takes each slot's first minimum (strict <, ascending mode
// ids) and gathers its reconstruction, levels and bin counts.
//
// The PNN mode.  Under the NN policies the PNN's prediction (b, n, n),
// computed before the launch, is the prediction of one mode: mode 18
// (substitution) or the 36th mode, PNNS (switch), as IP_NNMODE says; the
// block of that mode loads it instead of interpolating.  Without a
// prediction (a null pointer) that mode predicts zeros.  Nothing else of
// the trial depends on the policy.
//
// What bounds it.  At the encoder's shapes a launch is small: 31 slots x
// 35 modes x n^2 pixels (1080p), and a frame needs about 10,500 launches
// (124 wavefront steps x 85 z-order sub-stages).  The work per launch is a
// few MFLOP and a few hundred KB, so the kernel is bound by launch latency
// and by the serial sub-stage chain, not by bytes or operations.  Later
// work: one persistent launch per step or CUDA graphs over the sub-stages,
// and wgmma for the 32x32 transforms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M_PAD = 36;     // mode slots per unit (35 modes + PNNS)
constexpr int N_INTRA = 35;   // planar, DC and 33 angular modes

// Integer parameters (k_iparams) and float parameters (k_fparams); the
// order matches ops/unit_fused.py:_kernel_tables.
enum {
  IP_NMODES, IP_ROWS, IP_SHIFT1, IP_SHIFT2, IP_QBITS, IP_IQSHIFT,
  IP_IQSCALE, IP_G1_0, IP_G1_1, IP_G2_0, IP_G2_1, IP_CSB0, IP_CSB1, IP_CBF1,
  IP_NNMODE     // mode that takes the PNN prediction: 18, 35 or -1 (none)
};
enum { FP_QSCALE, FP_ERRSCALE, FP_LAM, FP_LAMCBF0, FP_CBF0 };

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
  const int* ip;        // integer parameters
  const float* fp;      // float parameters
};

__device__ __forceinline__ int level_mbits(int lvl, int g1_0, int g1_1,
                                           int g2_0, int g2_1) {
  // Micro-bits of a nonzero level: greater1/greater2 flags and the
  // Golomb-Rice escape at rice 0, floor(log2) by integer compares.
  int s = lvl - 3;
  int m = max(s - 2, 1);
  int g = 0;
  for (int j = 1; j < 16; ++j) g += (m >= (1 << j)) ? 1 : 0;
  int golomb = (s < 3) ? s + 1 : 4 + 2 * g;
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

template <int N>
__global__ void __launch_bounds__(256)
trial_modes_kernel(int b, const int* __restrict__ ref_top,
                   const int* __restrict__ ref_left,
                   const int* __restrict__ orig,
                   const float* __restrict__ mode_bits,
                   const int* __restrict__ rate_rows,
                   const int* __restrict__ nn_pred, Tables T,
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
  const int dsig0 = rate_rows[0 * b + s], dsig1 = rate_rows[1 * b + s];
  const Rates rt{T.ip[IP_G1_0] + rate_rows[2 * b + s],
                 T.ip[IP_G1_1] + rate_rows[3 * b + s],
                 T.ip[IP_G2_0] + rate_rows[4 * b + s],
                 T.ip[IP_G2_1] + rate_rows[5 * b + s]};
  const int dcbf0 = rate_rows[6 * b + s], dcbf1 = rate_rows[7 * b + s];
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
void launch_modes(dim3 grid, cudaStream_t st, int b, const int* rt,
                  const int* rl, const int* orig, const float* mb,
                  const int* rr, const int* nnp, const Tables& T,
                  float* cost_m, int* rec_m, int* q_m, int* cnt_m) {
  const int threads = N * N < 256 ? N * N : 256;
  trial_modes_kernel<N><<<grid, threads, 0, st>>>(
      b, rt, rl, orig, mb, rr, nnp, T, cost_m, rec_m, q_m, cnt_m);
}

}  // namespace

extern "C" int unit_trial(
    int n, int b, int n_modes, const void* ref_top, const void* ref_left,
    const void* orig, const void* mode_bits, const void* rate_rows,
    const void* nn_pred, const void* g0, const void* g1, const void* frac,
    const void* use_filt, const void* tf, const void* ti, const void* scan, const void* sig0,
    const void* sig1, const void* sig0i, const void* sig1i,
    const void* lastpb, const void* iparams, const void* fparams,
    void* cost_m, void* rec_m, void* q_m, void* cnt_m, void* cost,
    void* best, void* rec, void* q, void* cnt, void* stream) {
  if (b < 1 || n_modes < 1 || n_modes > M_PAD) return (int)cudaErrorInvalidValue;
  const Tables T{(const int*)g0,    (const int*)g1,     (const int*)frac,
                 (const int*)use_filt, (const int*)tf,  (const int*)ti,
                 (const int*)scan,  (const float*)sig0, (const float*)sig1,
                 (const int*)sig0i, (const int*)sig1i,  (const int*)lastpb,
                 (const int*)iparams, (const float*)fparams};
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(b, n_modes);
  const int* rt = (const int*)ref_top;
  const int* rl = (const int*)ref_left;
  const int* og = (const int*)orig;
  const float* mb = (const float*)mode_bits;
  const int* rr = (const int*)rate_rows;
  const int* nnp = (const int*)nn_pred;
  float* cm = (float*)cost_m;
  int* recm = (int*)rec_m;
  int* qm = (int*)q_m;
  int* cntm = (int*)cnt_m;
  switch (n) {
    case 4:
      launch_modes<4>(grid, st, b, rt, rl, og, mb, rr, nnp, T, cm, recm, qm,
                     cntm);
      break;
    case 8:
      launch_modes<8>(grid, st, b, rt, rl, og, mb, rr, nnp, T, cm, recm, qm,
                     cntm);
      break;
    case 16:
      launch_modes<16>(grid, st, b, rt, rl, og, mb, rr, nnp, T, cm, recm, qm,
                      cntm);
      break;
    case 32:
      launch_modes<32>(grid, st, b, rt, rl, og, mb, rr, nnp, T, cm, recm, qm,
                      cntm);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  select_kernel<<<b, 256, 0, st>>>(n * n, n_modes, cm, recm, qm, cntm,
                                   (float*)cost, (int*)best, (int*)rec,
                                   (int*)q, (int*)cnt);
  return (int)cudaGetLastError();
}

extern "C" const char* unit_trial_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
