// One step of the v1 wavefront encoder, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its v1 step
// (parallel/wavefront.py `step` / `encode_block`) to XLA, and the port
// ran it as some 260 plain PyTorch ops a step (`parallel/wavefront._step`,
// still the CPU path and the reference of this kernel).  At the batches
// the v1 encoder is run at (thousands of blocks a step) those ops were
// the card's time: generic elementwise kernels over (blocks, 35, n, n)
// int64 and float64 tensors, the transforms as float64 GEMMs.  This
// kernel does the same step in one launch, bit for bit:
//
//   clamped reference gather -> HM fill -> [1 2 1] filter -> 35 modes
//   (n <= 16 edge filters; filtered or unfiltered references per mode) ->
//   forward transform -> plain scalar quantisation -> dequantisation
//   (16-bit clip) -> inverse transform -> clamp to [0, 255] -> cost =
//   SSE + lambda * (rate proxy + 4 + mode bits) -> first minimum over
//   ascending modes -> commit reconstruction, mode and levels.
//
// Exactness.  Every integer stage is exact in int32 (n <= 32, 8-bit
// video).  Each row of the 6-bit DCT matrix has an L1 norm of at most
// 64 n, so with residuals in [-255, 255]:
//   forward stage 1: |sum| <= 255 * 64 n < 2^19; after >> (log2 n - 1)
//     the values lie in [-32640, 32640];
//   forward stage 2: |sum| <= 32640 * 64 n < 2^27; |coeff| <= 32640;
//   quantiser: |coeff| * qscale + qadd <= 32640 * 26214 + (171 << 18)
//     < 2^30 (taken in uint32 all the same), and the levels stay below
//     2^15 (the rate table's size and an int16);
//   dequantiser: |level| * 72 << 7 < 2^29, clipped to 16 bits;
//   inverse stages: |sum| <= 32768 * 90 n < 2^27.
// The transforms are even-odd butterflies of the matrix products (HM's
// partial butterflies): only the order of integer adds differs, which
// changes nothing.  The rate proxy sums float32 table entries in float64,
// exact in any order (each entry is 0 or >= 3 with at most 22 fractional
// bits, every sum below 2^15), rounds once to float32 and adds 4.  The
// cost's add, product and add are separate float32 roundings in the
// plain step's order (built with --fmad=false, written with _rn
// intrinsics).  Ties go to the lowest mode.
//
// Roofline.  A block tries 35 modes; each costs a two-stage forward and a
// two-stage inverse transform, 4 n^3 multiply-adds as matrix products
// (16,384 at n = 16), so a block is 573,440 MACs = 1.15 M int32
// operations at n = 16, against about 3.4 KB of traffic (references,
// source, reconstruction, levels).  It is compute-bound: at the card's
// int32 rate (33.45 T ops/s, benchmark/roofline.py) a 1056x1920 frame of
// 7,920 blocks is 0.27 ms.  The butterflies do about a third of those
// multiply-adds.
//
// Design (throughput: a step has up to thousands of independent blocks).
// One thread block codes one block of the diagonal; the grid is exactly
// the step's blocks (the caller sizes it from the schedule, so pad slots
// are never launched; a block off the frame would return at once).  The
// 35 modes go to teams of n threads (32 / n teams a warp): a team codes
// one mode at a time, lane i owning row i of the prediction, the residual
// and the forward first stage, then column i through the forward second
// stage, the quantiser, the dequantiser and the inverse first stage, and
// row i again in the inverse second stage; the two transposes go through
// a padded n x (n + 1) tile in shared memory (conflict-free by rows and
// by columns).  A team keeps the levels and reconstruction of its
// cheapest mode so far in shared memory; at the end one thread picks the
// cheapest team (lowest mode on a tie) and all threads write its block
// out.  Teams a block: 40 at n = 4, 36 at n = 8, 12 at n = 16 (three
// rounds), 5 at n = 32 (seven rounds), so 35 modes fill the rounds.  At
// n = 16 and 3840 blocks a step, 6 warps (80 registers) took 21.4 ms for
// the 250 steps of 64 1056x1920 frames, 4 warps the same, 9 warps (two
// rounds, 96 registers) 23.9 ms (H100 SXM, 700 W).  Static shared memory
// stays under 48 KB at every n.  The kernel
// launches on the caller's stream, allocates nothing and does not
// synchronise; the launcher returns the launch's error code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_MODES = 35;
constexpr int DC_MODE = 1;
constexpr int HOR_MODE = 10;
constexpr int VER_MODE = 26;
constexpr int DC_FILL = 128;
constexpr int MAX_FILTERED = 16;   // HM: edge filters up to 16x16

__constant__ int kAngle[9] = {0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ int kInvAngle[9] = {0, 4096, 1638, 910, 630, 482, 390, 315,
                                 256};

// |64 sqrt(2) cos(j pi / 64)| as HEVC rounds it (j = 0: the DC row's 64).
__host__ __device__ constexpr int cos_coeff(int j) {
  switch (j) {
    case 0: return 64;   case 1: return 90;   case 2: return 90;
    case 3: return 90;   case 4: return 89;   case 5: return 88;
    case 6: return 87;   case 7: return 85;   case 8: return 83;
    case 9: return 82;   case 10: return 80;  case 11: return 78;
    case 12: return 75;  case 13: return 73;  case 14: return 70;
    case 15: return 67;  case 16: return 64;  case 17: return 61;
    case 18: return 57;  case 19: return 54;  case 20: return 50;
    case 21: return 46;  case 22: return 43;  case 23: return 38;
    case 24: return 36;  case 25: return 31;  case 26: return 25;
    case 27: return 22;  case 28: return 18;  case 29: return 13;
    case 30: return 9;   case 31: return 4;   default: return 0;
  }
}

// The 6-bit HEVC DCT matrix of size n, T_n[k][x] = T_32[k * 32 / n][x].
template <int N>
__host__ __device__ constexpr int dct(int k, int x) {
  const int j = (k * (32 / N) * (2 * x + 1)) % 128;
  return j <= 32 ? cos_coeff(j) : j < 64 ? -cos_coeff(64 - j)
         : j <= 96 ? -cos_coeff(j - 64) : cos_coeff(128 - j);
}

// out[k] = sum_x T_N[k][x] in[x], as an even-odd butterfly.
template <int N>
__device__ __forceinline__ void fwd1d(const int (&in)[N], int (&out)[N]) {
  if constexpr (N == 2) {
    out[0] = 64 * (in[0] + in[1]);
    out[1] = 64 * (in[0] - in[1]);
  } else {
    constexpr int H = N / 2;
    int e[H], o[H], ee[H];
#pragma unroll
    for (int x = 0; x < H; ++x) {
      e[x] = in[x] + in[N - 1 - x];
      o[x] = in[x] - in[N - 1 - x];
    }
    fwd1d<H>(e, ee);
#pragma unroll
    for (int m = 0; m < H; ++m) {
      int acc = 0;
#pragma unroll
      for (int x = 0; x < H; ++x) acc += dct<N>(2 * m + 1, x) * o[x];
      out[2 * m] = ee[m];
      out[2 * m + 1] = acc;
    }
  }
}

// out[x] = sum_k T_N[k][x] in[k], as an even-odd butterfly.
template <int N>
__device__ __forceinline__ void inv1d(const int (&in)[N], int (&out)[N]) {
  if constexpr (N == 2) {
    out[0] = 64 * (in[0] + in[1]);
    out[1] = 64 * (in[0] - in[1]);
  } else {
    constexpr int H = N / 2;
    int ev[H], e[H];
#pragma unroll
    for (int m = 0; m < H; ++m) ev[m] = in[2 * m];
    inv1d<H>(ev, e);
#pragma unroll
    for (int x = 0; x < H; ++x) {
      int o = 0;
#pragma unroll
      for (int m = 0; m < H; ++m) o += dct<N>(2 * m + 1, x) * in[2 * m + 1];
      out[x] = e[x] + o;
      out[N - 1 - x] = e[x] - o;
    }
  }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct StepArgs {
  const int* frame;        // (NF * plane,) source, int32
  int* recon;              // (NF * plane,) reconstruction, int32
  int* modes;              // (NF * cells,) int32
  int* qcoeffs;            // (NF * cells, n * n) int32
  const float* rate;       // (32768,) rate proxy per |level|
  const float* mode_bits;  // (35, 35) [left mode][mode]
  unsigned long long use_filtered;   // bit m: mode m reads filtered refs
  float lam;
  int t, nf, width, height, top, has_halo, nbx, nby, plane, cells;
  int qscale, qbits, qadd, dq_scale, dq_shift;
};

template <int N> __host__ __device__ constexpr int warps_for() {
  return N == 4 ? 5 : N == 8 ? 9 : N == 16 ? 6 : 5;
}

template <int N, int TEAMS>
struct Smem {
  int orig[N * (N + 1)];          // the source block, rows of N + 1
  int ref[2][2][2 * N + 1];       // [filtered][top, left] references
  int dc[2];                      // DC value per reference set
  int left_mode, win;
  float cost[TEAMS];
  int mode[TEAMS];
  int tile[TEAMS][N * (N + 1)];   // a team's transposes
  int main_ref[TEAMS][3 * N + 1]; // a team's angular main reference
  short best_q[TEAMS][N * N];     // a team's cheapest levels so far
  unsigned char best_rec[TEAMS][N * N];
};

template <int N>
__global__ void __launch_bounds__(warps_for<N>() * 32)
v1_step_kernel(const StepArgs a) {
  constexpr int WARPS = warps_for<N>();
  constexpr int TPW = 32 / N;                 // teams a warp
  constexpr int TEAMS = WARPS * TPW;
  constexpr int ROUNDS = (N_MODES + TEAMS - 1) / TEAMS;
  constexpr int S = N + 1;
  constexpr int LOG2N = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  constexpr int THREADS = WARPS * 32;
  __shared__ Smem<N, TEAMS> s;

  // The block: slot (k, frame f) of step t, k along the diagonal.
  const int f = blockIdx.x % a.nf;
  const int d = a.t - (a.nbx - 1);
  const int by = (d > 0 ? (d + 1) / 2 : 0)
                 + static_cast<int>(blockIdx.x) / a.nf;
  const int bx = a.t - 2 * by;
  if (by >= a.nby || bx < 0 || bx >= a.nbx) return;
  const int y = by * N, x = bx * N, w = a.width;
  const int row_max = a.height - 1 + a.top;
  const int* rec_f = a.recon + static_cast<size_t>(f) * a.plane;
  const int* src = a.frame + static_cast<size_t>(f) * a.plane
                   + (y + a.top) * w + x;
  const bool ha = by > 0 || a.has_halo;
  const bool hl = bx > 0;
  const bool har = ha && bx < a.nbx - 1;
  const int tid = threadIdx.x;

  // References (parallel/wavefront._refs): the clamped gathers, HM's fill.
  const int top_row = clampi(y - 1 + a.top, 0, row_max) * w;
  const int left_x = clampi(x - 1, 0, w - 1);
  auto raw_top = [&](int j) {
    return rec_f[top_row + clampi(x - 1 + j, 0, w - 1)];
  };
  auto raw_left = [&](int j) {
    return rec_f[clampi(y + j + a.top, 0, row_max) * w + left_x];
  };
  for (int j = tid; j <= 2 * N; j += THREADS) {
    int v;
    if (ha) {
      v = raw_top(j <= N || har ? j : N);
      if (!hl && j == 0) v = raw_top(1);
    } else {
      v = hl ? raw_left(0) : DC_FILL;
    }
    s.ref[0][0][j] = v;
    if (j == 0) {
      s.ref[0][1][0] = v;                        // the shared corner
    } else {
      const int i = j - 1;                       // the left column's row
      int u = DC_FILL;
      if (hl) u = raw_left(i < N ? i : N - 1);
      else if (ha) u = raw_top(1);
      s.ref[0][1][j] = u;
    }
  }
  for (int e = tid; e < N * N; e += THREADS)
    s.orig[(e / N) * S + e % N] = src[(e / N) * w + e % N];
  if (tid == 0) {
    s.left_mode = hl ? a.modes[static_cast<size_t>(f) * a.cells
                               + by * a.nbx + bx - 1]
                     : DC_MODE;
  }
  __syncthreads();
  // [1 2 1] filter with unfiltered ends (parallel/wavefront._filter).
  for (int j = tid; j <= 2 * N; j += THREADS) {
    const int* rt = s.ref[0][0];
    const int* rl = s.ref[0][1];
    const int corner = rt[0];
    if (j == 0) {
      const int c = (rl[1] + 2 * corner + rt[1] + 2) >> 2;
      s.ref[1][0][0] = c;
      s.ref[1][1][0] = c;
    } else if (j == 2 * N) {
      s.ref[1][0][j] = rt[j];
      s.ref[1][1][j] = rl[j];
    } else {
      const int lm = j == 1 ? corner : rl[j - 1];
      s.ref[1][0][j] = (rt[j - 1] + 2 * rt[j] + rt[j + 1] + 2) >> 2;
      s.ref[1][1][j] = (lm + 2 * rl[j] + rl[j + 1] + 2) >> 2;
    }
  }
  __syncthreads();
  if (tid < 2) {
    int sum = N;
    for (int j = 1; j <= N; ++j) sum += s.ref[tid][0][j] + s.ref[tid][1][j];
    s.dc[tid] = sum / (2 * N);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int team = warp * TPW + lane / N;
  const int r = lane % N;           // the team's lane: a row, a column
  int* tile = s.tile[team];
  int* rm = s.main_ref[team];
  const int left_mode = s.left_mode;
  float best_cost = __int_as_float(0x7f800000);   // +inf
  int best_mode = N_MODES;

  for (int round = 0; round < ROUNDS; ++round) {
    if (warp * TPW + round * TEAMS >= N_MODES) break;   // the whole warp idle
    const int m_id = team + round * TEAMS;
    const bool active = m_id < N_MODES;
    const int m = active ? m_id : N_MODES - 1;
    const int fl = static_cast<int>((a.use_filtered >> m) & 1ull);
    const int* rt = s.ref[fl][0];
    const int* rl = s.ref[fl][1];
    const bool angular = m > DC_MODE;
    const bool is_ver = m >= 18;
    const int am = is_ver ? m - VER_MODE : HOR_MODE - m;
    const int angle = angular ? (am < 0 ? -kAngle[-am] : kAngle[am]) : 0;
    if (angular) {
      // refMain[k], k in [-N, 2N], at rm[k + N] (intra._angular_tables).
      const int* main_ = is_ver ? rt : rl;
      const int* side = is_ver ? rl : rt;
      const int inv = kInvAngle[am < 0 ? -am : am];
      for (int j = r; j <= 3 * N; j += N) {
        const int k = j - N;
        int v = main_[k < 0 ? 0 : k];
        if (k < 0 && angle < 0) {
          const int idx = (128 + (-k) * inv) >> 8;
          v = side[idx < 2 * N ? idx : 2 * N];
        }
        rm[j] = v;
      }
    }
    __syncwarp();

    // Prediction of row r (intra.predict_all_modes).
    int pred[N];
    if (m == 0) {
      const int l = rl[r + 1], tr = rt[N + 1], bl = rl[N + 1];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int tp = rt[c + 1];
        pred[c] = ((l << LOG2N) + N + (c + 1) * (tr - l) + (tp << LOG2N)
                   + (r + 1) * (bl - tp)) >> (LOG2N + 1);
      }
    } else if (m == DC_MODE) {
      const int dc = s.dc[fl];
#pragma unroll
      for (int c = 0; c < N; ++c) pred[c] = dc;
      if (N <= MAX_FILTERED) {
        if (r == 0) {
#pragma unroll
          for (int c = 1; c < N; ++c) pred[c] = (rt[c + 1] + 3 * dc + 2) >> 2;
          pred[0] = (rt[1] + rl[1] + 2 * dc + 2) >> 2;
        } else {
          pred[0] = (rl[r + 1] + 3 * dc + 2) >> 2;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int yy = is_ver ? r : c, xx = is_ver ? c : r;
        const int delta = (yy + 1) * angle;
        const int fr = delta & 31;
        const int k0 = xx + (delta >> 5) + 1;
        const int k1 = k0 + 1 < 2 * N ? k0 + 1 : 2 * N;
        pred[c] = ((32 - fr) * rm[k0 + N] + fr * rm[k1 + N] + 16) >> 5;
      }
      if (N <= MAX_FILTERED) {
        if (m == VER_MODE)
          pred[0] = clampi(pred[0] + ((rl[r + 1] - rl[0]) >> 1), 0, 255);
        if (m == HOR_MODE && r == 0) {
#pragma unroll
          for (int c = 0; c < N; ++c)
            pred[c] = clampi(pred[c] + ((rt[c + 1] - rt[0]) >> 1), 0, 255);
        }
      }
    }

    // Forward transform, first stage on row r.
    {
      int res[N], out[N];
#pragma unroll
      for (int c = 0; c < N; ++c) res[c] = s.orig[r * S + c] - pred[c];
      fwd1d<N>(res, out);
      constexpr int SH1 = LOG2N - 1;
#pragma unroll
      for (int k = 0; k < N; ++k)
        tile[r * S + k] = (out[k] + (1 << (SH1 - 1))) >> SH1;
    }
    __syncwarp();
    // Second stage on column r, the quantiser, the dequantiser and the
    // inverse first stage.
    int q[N];
    double bits = 0.0;
    {
      int col[N], cf[N];
#pragma unroll
      for (int i = 0; i < N; ++i) col[i] = tile[i * S + r];
      fwd1d<N>(col, cf);
      constexpr int SH2 = LOG2N + 6;
      int dq[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int c = (cf[k] + (1 << (SH2 - 1))) >> SH2;
        const unsigned mag = (static_cast<unsigned>(c < 0 ? -c : c)
                              * static_cast<unsigned>(a.qscale)
                              + static_cast<unsigned>(a.qadd)) >> a.qbits;
        const int lv = c < 0 ? -static_cast<int>(mag) : static_cast<int>(mag);
        q[k] = lv;
        if (mag) bits += static_cast<double>(__ldg(a.rate + mag));
        const int v = a.dq_shift > 0
            ? (lv * a.dq_scale + (1 << (a.dq_shift - 1))) >> a.dq_shift
            : lv * a.dq_scale * (1 << -a.dq_shift);
        dq[k] = clampi(v, -32768, 32767);
      }
      int e[N];
      inv1d<N>(dq, e);
      __syncwarp();                            // every column read
#pragma unroll
      for (int i = 0; i < N; ++i)
        tile[i * S + r] = clampi((e[i] + 64) >> 7, -32768, 32767);
    }
    __syncwarp();
    // Inverse second stage on row r, the reconstruction and its SSE.
    int rec[N];
    int sse = 0;
    {
      int er[N], out[N];
#pragma unroll
      for (int k = 0; k < N; ++k) er[k] = tile[r * S + k];
      inv1d<N>(er, out);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int res = clampi((out[c] + 2048) >> 12, -32768, 32767);
        rec[c] = clampi(pred[c] + res, 0, 255);
        const int dd = rec[c] - s.orig[r * S + c];
        sse += dd * dd;
      }
    }
#pragma unroll
    for (int o = N / 2; o > 0; o /= 2) {
      sse += __shfl_xor_sync(0xffffffffu, sse, o);
      bits += __shfl_xor_sync(0xffffffffu, bits, o);
    }
    const float coeff_bits = __fadd_rn(__double2float_rn(bits), 4.0f);
    const float mbits = __ldg(a.mode_bits + left_mode * N_MODES + m);
    const float cost = __fadd_rn(
        __int2float_rn(sse), __fmul_rn(a.lam, __fadd_rn(coeff_bits, mbits)));
    if (active && cost < best_cost) {
      best_cost = cost;
      best_mode = m;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        s.best_rec[team][r * N + c] = static_cast<unsigned char>(rec[c]);
        s.best_q[team][c * N + r] = static_cast<short>(q[c]);
      }
    }
    __syncwarp();                              // the tile is free again
  }

  if (r == 0) {
    s.cost[team] = best_cost;
    s.mode[team] = best_mode;
  }
  __syncthreads();
  if (tid == 0) {
    int bt = 0;
    for (int tm = 1; tm < TEAMS; ++tm) {
      if (s.cost[tm] < s.cost[bt]
          || (s.cost[tm] == s.cost[bt] && s.mode[tm] < s.mode[bt]))
        bt = tm;
    }
    s.win = bt;
  }
  __syncthreads();
  const int wt = s.win;
  const size_t cell = static_cast<size_t>(f) * a.cells + by * a.nbx + bx;
  int* rec_out = a.recon + static_cast<size_t>(f) * a.plane
                 + (y + a.top) * w + x;
  int* q_out = a.qcoeffs + cell * (N * N);
  for (int e = tid; e < N * N; e += THREADS) {
    rec_out[(e / N) * w + e % N] = s.best_rec[wt][e];
    q_out[e] = s.best_q[wt][e];
  }
  if (tid == 0) a.modes[cell] = s.mode[wt];
}

template <int N>
cudaError_t launch(const StepArgs& a, int blocks, cudaStream_t stream) {
  void* args[] = {const_cast<StepArgs*>(&a)};
  return cudaLaunchKernel(v1_step_kernel<N>, dim3(blocks),
                          dim3(warps_for<N>() * 32), args, 0, stream);
}

}  // namespace

extern "C" {

// One step t: `blocks` = the step's blocks on the frame x NF (the grid).
// Returns the launch's cudaError_t (0 on success); 1 (cudaErrorInvalidValue)
// for a block size other than 4, 8, 16 or 32.
int v1_step(int n, int blocks, int t, int nf, int width, int height,
            int top, int has_halo, int nbx, int nby, int plane, int cells,
            int qscale, int qbits, int qadd, int dq_scale, int dq_shift,
            unsigned long long use_filtered, float lam, const void* frame,
            void* recon, void* modes, void* qcoeffs, const void* rate,
            const void* mode_bits, void* stream) {
  StepArgs a;
  a.frame = static_cast<const int*>(frame);
  a.recon = static_cast<int*>(recon);
  a.modes = static_cast<int*>(modes);
  a.qcoeffs = static_cast<int*>(qcoeffs);
  a.rate = static_cast<const float*>(rate);
  a.mode_bits = static_cast<const float*>(mode_bits);
  a.use_filtered = use_filtered;
  a.lam = lam;
  a.t = t;
  a.nf = nf;
  a.width = width;
  a.height = height;
  a.top = top;
  a.has_halo = has_halo;
  a.nbx = nbx;
  a.nby = nby;
  a.plane = plane;
  a.cells = cells;
  a.qscale = qscale;
  a.qbits = qbits;
  a.qadd = qadd;
  a.dq_scale = dq_scale;
  a.dq_shift = dq_shift;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n) {
    case 4: err = launch<4>(a, blocks, st); break;
    case 8: err = launch<8>(a, blocks, st); break;
    case 16: err = launch<16>(a, blocks, st); break;
    case 32: err = launch<32>(a, blocks, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

const char* v1_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
