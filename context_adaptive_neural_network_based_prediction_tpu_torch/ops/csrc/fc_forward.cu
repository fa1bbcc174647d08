// One layer of the float fully-connected PNN, for Hopper (sm_90a), on the
// tensor cores in split TF32.
//
// Replaces the TPU kernel `fc_forward_pallas` of the JAX package
// (context_adaptive_neural_network_based_prediction_tpu/ops/pallas/
// fc_forward.py:83, body :47-61).  That kernel runs the whole chain
// 5w^2 -> 1200 -> 1200 -> 1200 -> w^2 in one call, every weight resident in
// the TPU's VMEM.  Here each layer is one call of
//   out[r, c] = act(sum_k x[r, k] * w[k, c] + b[c]),  act(h) = max(0.1 h, h)
// on layers 0-2 and the identity on layer 3: four calls per forward.  x (N,
// K) float32, b (D,) float32, out (N, D) float32.  The weight comes
// prepared by the wrapper (ops/fc_forward.py), once per weight tensor: its
// transpose (D, K), split into w_hi = tf32(w^T) and w_lo = tf32(w^T - w_hi)
// (TF32: float32 rounded to 10 mantissa bits, nearest, ties away).  A
// bfloat16 weight is exact in TF32, so it has w_hi only.
//
// Arithmetic.  One TF32 product keeps about 1e-3; the split keeps float32's
// accuracy: with x = x_hi + x_lo split the same way in registers,
//   x w ~ x_lo w_hi + x_hi w_lo + x_hi w_hi
// (x_lo w_lo, about 2^-22 of the product, is dropped), three tensor-core
// products with float32 accumulation (two for bfloat16 weights).  Then the
// bias, then the activation: the order of `dot + bias` in the JAX package.
//
// Design.  A block computes a 64 x BN tile of out (BN = 32, 64, 96, 128 or
// 192, one wgmma m64nBNk8 per product; the wrapper picks BN and the K
// splits from the shape so that the card's SMs are filled): warps 0-3 are
// one consumer warpgroup, warp 4 the producer.  The producer
// keeps a ring of STAGES shared-memory stages full with TMA: per stage a
// 64 x 32 tile of x and BN x 32 tiles of w_hi (and w_lo), 128-byte
// swizzled, zero-filled by TMA past the ragged edges (K = 80, D = 16, any
// N).  The consumer reads its x fragment of a stage from shared memory
// into registers, splits it into hi and lo there (A from registers), and
// issues `wgmma.mma_async` m64nNk8 .tf32 with B (the weights, K-major as
// TF32 requires) from shared memory; the next stage's fragment is read and
// split while the current products run (two register sets, one wgmma group
// in flight).  When the tiles do not fill the card (small N, D = w^2) the
// K range is split over blockIdx.z: each split writes its partial tile to a
// workspace and a second kernel sums the splits in a fixed order, then adds
// the bias and the activation, so a result never depends on timing.
//
// What bounds it.  A layer at N = 1024, K = D = 1200 does 2.9 G float
// operations, three times that on the tensor cores, against 15.6 MB moved:
// the TF32 rate (495 T/s, so 3 x 2.9 G in 18 us) bounds it, not bytes.  The
// first layer (K = 80, 320) and the last (D = 16, 64) are small; the last
// is split over K.  Measured on an H100 (`ops/kernel_variants.py`,
// PERF.md): the products of a stage run at the TF32 rate, but for about
// 0.45 us per stage the tensor cores wait, whatever the loads, the split or
// the wait depth, so the big layer reaches about 40% of the TF32 rate.  The
// wrapper counts one launch per layer call, per (K, D), in
// `fc_forward.launches`.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;            // rows of x per block: one warpgroup
constexpr int BK = 32;            // floats of K per stage: one 128-byte row
constexpr int THREADS = 128 + 32; // the consumer warpgroup, the producer warp
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr float SLOPE = 0.1f;

// ------------------------------------------------------------ PTX helpers --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.  A
// wait of more than about 10 s traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// 2D TMA load of the box at (c0 = inner, c1 = outer) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows,
// 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// d (64 x N, N / 2 floats a thread) += a (64 x 8 TF32, registers) * b (8 x
// N TF32, shared memory, K-major): one `wgmma.mma_async` m64nNk8.
template <int N>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void mma<32>(float* d, const uint32_t* a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma<64>(float* d, const uint32_t* a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma<96>(float* d, const uint32_t* a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma<128>(float* d, const uint32_t* a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma<192>(float* d, const uint32_t* a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------------------- the kernel --

// The x fragment of one stage for this thread (4 k-steps of 8), split:
// hi[s][i], lo[s][i] in the wgmma register layout of A (m64 k8 TF32: row
// g or g + 8 of the warp's 16, column t or t + 4).
struct Frag {
  uint32_t hi[4][4];
  uint32_t lo[4][4];
};

// xs: the warpgroup's 64 rows of the stage's x tile (128-byte rows,
// 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8)).
__device__ __forceinline__ void load_frag(Frag& f, const float* xs, int warp,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + g + 8 * (i & 1);
      const int chunk = (2 * s + (i >> 1)) ^ g;
      const float v = xs[r * BK + chunk * 4 + t];
      f.hi[s][i] = tf32_rna(v);
      f.lo[s][i] = tf32_rna(v - __uint_as_float(f.hi[s][i]));
    }
}

// The stage's products: per k-step, x_lo w_hi, x_hi w_lo, x_hi w_hi.
template <int BN, bool SPLIT_W>
__device__ __forceinline__ void issue(float* acc, const Frag& f,
                                      uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint64_t dh = smem_desc(b_hi + s * 32);
    mma<BN>(acc, f.lo[s], dh);
    if constexpr (SPLIT_W) mma<BN>(acc, f.hi[s], smem_desc(b_lo + s * 32));
    mma<BN>(acc, f.hi[s], dh);
  }
}

// One consumer warpgroup (64 rows of x) and one producer warp.  Grid
// (ceil(D / BN), ceil(N / 64), splits).
// Split z takes k-tiles [z * kt_per, min((z + 1) * kt_per, ceil(K / 32))).
// With one split the epilogue adds the bias and the activation and writes
// out; with more it writes the raw partial tile to part[z] (N, D).
template <int BN, bool SPLIT_W>
__global__ void __launch_bounds__(THREADS, 1)
fc_tc_kernel(const __grid_constant__ CUtensorMap map_x,
             const __grid_constant__ CUtensorMap map_hi,
             const __grid_constant__ CUtensorMap map_lo, int n, int k, int d,
             int act, int stages, int kt_per, const float* __restrict__ b,
             float* __restrict__ out, float* __restrict__ part) {
  constexpr uint32_t A_BYTES = BM * BK * 4;
  constexpr uint32_t B_BYTES = BN * BK * 4;
  constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES * (SPLIT_W ? 2 : 1);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;     // 1024-byte aligned
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bars = base + stages * STAGE_BYTES;  // full[s], empty[s]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int kt_all = (k + BK - 1) / BK;
  const int kt0 = blockIdx.z * kt_per;
  const int kts = min(kt_per, kt_all - kt0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (MAX_STAGES + s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int i = 0; i < kts; ++i) {
        const int s = i % stages, round = i / stages;
        if (round > 0) mbar_wait(bars + 8 * (MAX_STAGES + s), (round - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t st = base + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
        const int kc = (kt0 + i) * BK;
        tma_load(st, &map_x, kc, row0, full);
        tma_load(st + A_BYTES, &map_hi, kc, col0, full);
        if constexpr (SPLIT_W)
          tma_load(st + A_BYTES + B_BYTES, &map_lo, kc, col0, full);
      }
    }
    return;
  }

  // The consumer warpgroup.
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
  Frag f0, f1;
  auto stage_x = [&](int i) {
    return reinterpret_cast<const float*>(smem + (i % stages) * STAGE_BYTES);
  };
  auto b_hi = [&](int i) {
    return base + (i % stages) * STAGE_BYTES + A_BYTES;
  };
  auto wait_full = [&](int i) {
    mbar_wait(bars + 8 * (i % stages), (i / stages) & 1);
  };
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + i % stages));
  };
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) reg_fence(acc[e]);

  // One wgmma group in flight: stage i's products run while stage i + 1's
  // fragment is read and split into the other register set.
  int i = 0;
  wait_full(0);
  load_frag(f0, stage_x(0), warp, lane);
  while (true) {
    wgmma_fence();
    issue<BN, SPLIT_W>(acc, f0, b_hi(i), b_hi(i) + B_BYTES);
    wgmma_commit();
    if (i > 0) {
      wgmma_wait<1>();
      release(i - 1);
    }
    if (++i == kts) break;
    wait_full(i);
    load_frag(f1, stage_x(i), warp, lane);
    wgmma_fence();
    issue<BN, SPLIT_W>(acc, f1, b_hi(i), b_hi(i) + B_BYTES);
    wgmma_commit();
    wgmma_wait<1>();
    release(i - 1);
    if (++i == kts) break;
    wait_full(i);
    load_frag(f0, stage_x(i), warp, lane);
  }
  wgmma_wait<0>();
  release(kts - 1);
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) reg_fence(acc[e]);

  // Epilogue.  acc[4 q + v] is row g + 8 (v >> 1) of the warp's 16, column
  // 8 q + 2 t + (v & 1).
  const int g = lane >> 2, t = lane & 3;
  float* const dst = gridDim.z > 1 ? part + (size_t)blockIdx.z * n * d : out;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const int r = row0 + warp * 16 + g + 8 * ((e >> 1) & 1);
    const int c = col0 + 8 * (e >> 2) + 2 * t + (e & 1);
    if (r >= n || c >= d) continue;
    float v = acc[e];
    if (gridDim.z == 1) {
      v += b[c];
      if (act) v = fmaxf(SLOPE * v, v);
    }
    dst[(size_t)r * d + c] = v;
  }
}

// out[r, c] = act(sum over z in order of part[z, r, c] + b[c]).
__global__ void fc_split_reduce_kernel(int n, int d, int splits, int act,
                                       const float* __restrict__ part,
                                       const float* __restrict__ b,
                                       float* __restrict__ out) {
  const size_t total = (size_t)n * d;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = part[e];
    for (int z = 1; z < splits; ++z) v += part[(size_t)z * total + e];
    v += b[e % d];
    if (act) v = fmaxf(SLOPE * v, v);
    out[e] = v;
  }
}

// ------------------------------------------------------------------- host --

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) float32 matrix, boxes of box_rows x 32 floats,
// 128-byte swizzle, zeros past the edges.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
  EncodeFn fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool SPLIT_W>
int launch(int n, int k, int d, int act, int splits, const void* x,
           const void* w_hi, const void* w_lo, const void* b, void* out,
           void* part, cudaStream_t stream) {
  constexpr int STAGE_BYTES = (BM + BN * (SPLIT_W ? 2 : 1)) * BK * 4;
  const int stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - 64) / STAGE_BYTES);
  const int smem = stages * STAGE_BYTES + 1024 + 16 * MAX_STAGES;
  auto kernel = fc_tc_kernel<BN, SPLIT_W>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap mx, mh, ml;
  if (!make_map(&mx, x, n, k, BM) || !make_map(&mh, w_hi, d, k, BN) ||
      !make_map(&ml, SPLIT_W ? w_lo : w_hi, d, k, BN))
    return (int)cudaErrorInvalidValue;
  const int kt_all = (k + BK - 1) / BK;
  const int kt_per = (kt_all + splits - 1) / splits;
  const dim3 grid((d + BN - 1) / BN, (n + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, smem, stream>>>(
      mx, mh, ml, n, k, d, act, stages, kt_per, (const float*)b,
      (float*)out, (float*)part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long total = (long long)n * d;
  const int blocks = (int)(total < 1024 * 256 ? (total + 255) / 256 : 1024);
  fc_split_reduce_kernel<<<blocks, 256, 0, stream>>>(
      n, d, splits, act, (const float*)part, (const float*)b, (float*)out);
  return (int)cudaGetLastError();
}

template <bool SPLIT_W>
int by_columns(int bn, int n, int k, int d, int act, int splits,
               const void* x, const void* w_hi, const void* w_lo,
               const void* b, void* out, void* part, cudaStream_t s) {
  switch (bn) {
#define FC_CASE(BN)                                                        \
  case BN:                                                                 \
    return launch<BN, SPLIT_W>(n, k, d, act, splits, x, w_hi, w_lo, b, out, \
                               part, s);
    FC_CASE(32) FC_CASE(64) FC_CASE(96) FC_CASE(128) FC_CASE(192)
#undef FC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One layer: x (N, K) float32, w_hi and w_lo (D, K) float32 (w_lo null for
// a bfloat16 weight: two products instead of three), b (D,), out (N, D);
// act: 1 applies the LeakyReLU.  bn: the tile's columns (32, 64, 96, 128
// or 192); splits: the K splits, with part (splits, N, D) float32 as
// workspace when above 1.  K must be a multiple of 4 and every pointer
// 16-byte aligned (TMA).  Returns a cudaError_t (0 on success).
extern "C" int fc_forward(int n, int k, int d, int act, int bn, int splits,
                          const void* x, const void* w_hi,
                          const void* w_lo, const void* b, void* out,
                          void* part, void* stream) {
  const int kt_all = (k + BK - 1) / BK;
  if (n < 1 || k < 1 || d < 1 || k % 4 != 0 || splits < 1 ||
      splits > kt_all || (splits > 1 && !part) || (n + BM - 1) / BM > 65535 ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, w_hi, w_lo})
    if (p && (reinterpret_cast<uintptr_t>(p) & 15))
      return (int)cudaErrorMisalignedAddress;
  // Every split must own at least one k-tile.
  const int kt_per = (kt_all + splits - 1) / splits;
  if ((splits - 1) * kt_per >= kt_all) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return w_lo ? by_columns<true>(bn, n, k, d, act, splits, x, w_hi, w_lo, b,
                                 out, part, s)
              : by_columns<false>(bn, n, k, d, act, splits, x, w_hi, w_lo, b,
                                  out, part, s);
}

extern "C" const char* fc_forward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
