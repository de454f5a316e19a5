// Dense flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (omg_tpu/ops/flash_attention.py,
// `pl.pallas_call` at :249) reached through `flash_attention` (K1) and, with a
// shard's query rows against the all-gathered K/V, through
// `flash_attention_seq_sharded` (K1b): softmax(q k^T * D^-0.5) v over
// q [B, H, Nq, D] and k/v [B, H, Nk, D], no mask, no causal structure, fp32
// scores, fp32 online-softmax state and fp32 output accumulators.
//
// What bounds it on the card: the tensor cores, and at D = 64 the exp2 unit
// nearly as much. One (batch, head) at N = 4096, D = 64 is 4*N*N*D =
// 4.3 GFLOP over 2 MB of q/k/v/o, ~2000 flop per byte of device memory (K/V
// re-reads hit the 50 MB L2), far above the H100's ~295 flop/byte ridge.
// But a 128 x 128 tile of scores takes as long in the SM's 16 exp2/clock as
// its two products take in the tensor cores, so the design keeps the tensor
// cores fed and runs the softmax under them:
//   * Both products run on `wgmma.mma_async` (the only instruction that
//     reaches Hopper's full bf16 rate): S = Q K^T as m64n128k16 with Q and K
//     from shared memory, O += P V as m64n64k16 with P from registers and V
//     from shared memory in its MN-major (row-major [keys, D]) layout.
//   * Scores, probabilities and the O accumulator never leave registers: the
//     online softmax works on the wgmma accumulator layout (each row lives
//     in the 4 threads of a quad; row max and sum by two shuffles), P is
//     rounded to bf16 in place and becomes the A operand of the next wgmma,
//     and O is rescaled in registers.
//   * Warp specialization: one producer warp (in its own warpgroup, which
//     gives its registers to the consumers with `setmaxnreg`) issues every
//     load with TMA: Q once, K and V tiles of 128 keys into a 2-stage ring
//     in shared memory, with full and empty mbarriers per stage for K and
//     for V, so loads run ahead of the products.
//   * Each consumer warpgroup owns 64 query rows: three per CTA at D = 64
//     (192 rows; as FA3 does, this gives the softmax more warps to hide
//     in), two at D = 128 (their S, P and O fill 240 registers). Within
//     one, tile t issues S_t and then O += P_{t-1} V_{t-1}, and the softmax
//     of S_t runs under that second product (FA3's intra-warpgroup
//     pipelining). Between them, named barriers make them take turns at
//     issuing (FA3's pingpong), so one's softmax runs under another's
//     products. Keys whose running max grows by less than 2^8 keep the old
//     max (exact: O and l share it), so O is rescaled only when some row
//     of the warp needs it.
//   * A 64-row variant (one consumer warpgroup, two CTAs per SM) serves
//     D = 64 grids that fill the SMs' waves better in 64-row steps, e.g.
//     K1b's 4-way [2,20,256,1024]; `launch_plan` picks by waves.
//
// Loads and edges:
//   * Tensor maps are 4-D over (D, N, H, B) with the caller's byte strides,
//     so the fused-QKV chunk views go in with no copy; 128-byte swizzle, which
//     the wgmma descriptors read back. D = 128 is loaded as two 64-column
//     boxes (a swizzled box is at most 128 bytes wide).
//   * TMA zero-fills rows past N. A zero key scores 0, not -inf, so keys
//     >= Nk of the last tile are set to -inf before the softmax; query rows
//     >= Nq are computed on zeros and never written.
//   * A row with no real key yet (running max -inf) gets a correction factor
//     of 0 and zero probabilities, never inf - inf; Nk = 0 writes zeros.
//
// The launch plan (query rows per CTA, grid, the three tensor maps' dims,
// byte strides and boxes, o's strides) is computed in Python by
// `ops/flash_attention.py:launch_plan` and passed in as 43 int64 (layout
// below). Plain C entry points (loaded with ctypes), launched on the caller's
// stream; no -lcuda: cuTensorMapEncodeTiled is reached through the runtime's
// driver entry point.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;            // keys per K/V tile
constexpr int STAGES = 2;          // K/V ring depth
constexpr int PRODUCER_REGS = 24;  // the producer warpgroup after setmaxnreg.dec

// Own error codes (cudaError_t values are positive).
constexpr int ERR_PLAN = -1;           // D / rows not instantiated
constexpr int ERR_DRIVER_ENTRY = -2;   // cuTensorMapEncodeTiled not found
constexpr int ERR_REGS = -3;           // entry register count != the setmaxnreg plan
constexpr int ERR_ENCODE = -1000;      // - CUresult of a failed encode

template <int D, int NCONS>
struct Cfg {
  static constexpr int ROWS = 64 * NCONS;             // query rows per CTA
  static constexpr int NSUB = D / 64;                 // 64-column (128-byte) sub-tiles
  static constexpr int THREADS = 128 * (NCONS + 1);   // consumers, then the producer warpgroup
  static constexpr int MIN_BLOCKS = NCONS == 1 ? 2 : 1;
  // Registers per thread at entry (the launch bound's share of the 64K file)
  // and the consumers' count after the producer releases its surplus.
  static constexpr int ENTRY_REGS = (65536 / (THREADS * MIN_BLOCKS)) & ~7;
  static constexpr int CONSUMER_REGS =
      ENTRY_REGS + (((ENTRY_REGS - PRODUCER_REGS) / NCONS) & ~7);
  static constexpr int Q_BYTES = ROWS * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  // Tile bases are multiples of 1024 bytes (the 128-byte swizzle's period).
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + Q_BYTES;
  static constexpr int v_off = k_off + STAGES * KV_BYTES;
  static constexpr int bar_off = v_off + STAGES * KV_BYTES;
  static constexpr int SMEM = bar_off + 8 * (1 + 4 * STAGES) + 1024;  // + alignment slack
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. (A guard that
// traps after a bound on the polls costs the consumers their registers:
// ptxas then spills and serializes the wgmmas.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define OMG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define OMG_F16(d, i) OMG_F4(d, i), OMG_F4(d, i + 4), OMG_F4(d, i + 8), OMG_F4(d, i + 12)

// d[64] (+)= A[64x16] B[16x128]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : OMG_F16(d, 0), OMG_F16(d, 16), OMG_F16(d, 32), OMG_F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A[64x16] B[16x64]; A in registers (4 x bf16x2 per thread), B
// MN-major in shared memory (trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : OMG_F16(d, 0), OMG_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef OMG_F16
#undef OMG_F4

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// S = Q K^T for one 128-key tile, issued and committed as one group: D in
// k16 steps, each 32 bytes along the swizzled 128-byte rows, or on to the
// next 64-column sub-tile. Each group gets its own wgmma.fence, with no
// other instruction writing its operands in between (else ptxas
// serializes the wgmmas).
template <int D, int ROWS>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_wg, uint32_t k_t) {
  uint64_t da[D / 16], db[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    da[kk] = desc_sw128(q_wg + (kk / 4) * ROWS * 128 + (kk % 4) * 32, 16, 1024);
    db[kk] = desc_sw128(k_t + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024);
  }
  fence_regs(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n128k16_ss(sc, da[kk], db[kk], kk > 0);
  wg_commit();
  fence_regs(sc);
}

// O += P V for one tile, issued and committed as one group: V [keys, 64
// cols] per sub-tile is MN-major; a k16 step is two 8-key swizzle atoms,
// 2048 bytes.
template <int NSUB>
__device__ __forceinline__ void issue_pv(float (&o)[NSUB][32], uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_t) {
  uint64_t db[BN / 16][NSUB];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NSUB; ++c)
      db[kk][c] = desc_sw128(v_t + c * BN * 128 + kk * 2048, 1024, 1024);
  fence_regs(pa);
#pragma unroll
  for (int c = 0; c < NSUB; ++c) fence_regs(o[c]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NSUB; ++c) wgmma_m64n64k16_rs(o[c], pa[kk], db[kk][c]);
  wg_commit();
#pragma unroll
  for (int c = 0; c < NSUB; ++c) fence_regs(o[c]);
  fence_regs(pa);
}

// Max or sum of row R's 32 values in a tile (sc[4j + 2R + e]): eight
// independent chains and a tree, not one chain of 32 dependent ops (only
// one warp per consumer warpgroup shares a scheduler, so latency shows).
template <int R, bool MAX>
__device__ __forceinline__ float row_reduce(const float (&sc)[64]) {
  float a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = sc[4 * (k / 2) + 2 * R + (k % 2)];
#pragma unroll
  for (int j = 4; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = (2 * j + e) % 8;
      const float x = sc[4 * j + 2 * R + e];
      a[k] = MAX ? fmaxf(a[k], x) : a[k] + x;
    }
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int k = 0; k < w; ++k) a[k] = MAX ? fmaxf(a[k], a[k + w]) : a[k] + a[k + w];
  return a[0];
}

// Online softmax of one tile of raw scores in the exp2 domain, in place on
// the accumulator layout (this thread's rows r and r + 8): masks keys past
// the end, updates the running max m and this thread's share of the sums
// l, leaves the unnormalized probabilities in sc and returns the factor
// that rescales O.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int keys_left, int cpair,
                                             float scale_log2) {
  if (keys_left < BN) {  // TMA zero-filled these keys: a score of 0, not -inf
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (8 * (i / 4) + cpair + (i & 1) >= keys_left) sc[i] = -INFINITY;
  }
  float mx[2] = {row_reduce<0, true>(sc), row_reduce<1, true>(sc)};
  float sub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = mx[r] * scale_log2;
    if (m[r] == -INFINITY || mn > m[r] + 8.f) {
      corr[r] = m[r] == -INFINITY ? 0.f : fast_exp2(m[r] - mn);
      m[r] = mn;
    } else {
      corr[r] = 1.f;
    }
    sub[r] = m[r] == -INFINITY ? 0.f : m[r];  // no real key yet: exp2(-inf - 0) = 0
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -sub[(i / 2) & 1]));
  l[0] = l[0] * corr[0] + row_reduce<0, false>(sc);
  l[1] = l[1] * corr[1] + row_reduce<1, false>(sc);
}

// P in bf16 as wgmma A fragments: k16 step kk takes the accumulator's
// column blocks 2kk and 2kk + 1.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

// Pingpong between the consumer warpgroups (FA3's inter-warpgroup
// scheduling): warpgroup w issues its next products only after w - 1 has
// issued its own (the last passes to the first), so the softmax of one
// runs under the wgmmas of another. Named barrier 1 + w is w's turn.
template <int NCONS>
__device__ __forceinline__ void turn_wait(int wg) {
  if constexpr (NCONS >= 2) asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
template <int NCONS>
__device__ __forceinline__ void turn_pass(int wg) {
  if constexpr (NCONS >= 2)
    asm volatile("bar.arrive %0, 256;" ::"r"(1 + (wg + 1) % NCONS) : "memory");
}

template <int NSUB>
__device__ __forceinline__ void rescale(float (&o)[NSUB][32], const float (&corr)[2]) {
#pragma unroll
  for (int c = 0; c < NSUB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i / 2) & 1];
}

// ---------------------------------------------------------------- the kernel

template <int D, int NCONS>
__global__ void __launch_bounds__(Cfg<D, NCONS>::THREADS, Cfg<D, NCONS>::MIN_BLOCKS)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o, int H, int Nq, int Nk,
                 int64_t ob, int64_t oh, int64_t on, float scale_log2) {
  using C = Cfg<D, NCONS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + C::q_off;
  const uint32_t k_s = base + C::k_off;
  const uint32_t v_s = base + C::v_off;
  // mbarriers: q_full, then k_full, v_full, k_empty, v_empty per stage
  const uint32_t q_full = base + C::bar_off;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * C::ROWS;
  const int n_tiles = Nk > 0 ? (Nk + BN - 1) / BN : 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * NCONS);  // lane 0 of every consumer warp
      mbar_init(v_empty + 8 * s, 4 * NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NCONS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONS * 128) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NSUB; ++c)
        tma_load_4d(q_s + c * C::ROWS * 128, &qmap, q_full, 64 * c, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t ph = (t / STAGES) & 1;
        mbar_wait(k_empty + 8 * s, ph ^ 1);  // round 0 passes at once
        mbar_expect_tx(k_full + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NSUB; ++c)
          tma_load_4d(k_s + s * C::KV_BYTES + c * BN * 128, &kmap, k_full + 8 * s, 64 * c,
                      t * BN, h, b);
        mbar_wait(v_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(v_full + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NSUB; ++c)
          tma_load_4d(v_s + s * C::KV_BYTES + c * BN * 128, &vmap, v_full + 8 * s, 64 * c,
                      t * BN, h, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int cpair = 2 * (lane % 4);  // first of this thread's two columns per 8
    // Accumulator layout (m64nN, fp32): thread holds rows r and r + 8,
    // r = 16 * warp + lane / 4; for each 8-column block j, d[4j + 0/1] are
    // (r, 8j + cpair + 0/1) and d[4j + 2/3] are (r + 8, 8j + cpair + 0/1).
    float o_acc[C::NSUB][32];
#pragma unroll
    for (int c = 0; c < C::NSUB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[c][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units) of rows r, r + 8
    float l[2] = {0.f, 0.f};              // this thread's share of the running sums
    uint32_t pa[BN / 16][4];              // P of the last tile, bf16 A fragments
    float corr[2];                        // rescales O from the last tile's max to this one's

    if (wg == NCONS - 1) turn_pass<NCONS>(wg);  // warpgroup 0 goes first
    mbar_wait(q_full, 0);
    const uint32_t q_wg = q_s + wg * 64 * 128;
    // Tile 0: S_0 and its softmax. No wgmma sits in a branch (ptxas would
    // serialize them), so Nk = 0 runs this one tile with every key masked.
    {
      float sc[64];
      mbar_wait(k_full, 0);
      turn_wait<NCONS>(wg);
      issue_qk<D, C::ROWS>(sc, q_wg, k_s);
      turn_pass<NCONS>(wg);
      wg_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty);  // this warp is done with K_0
      softmax_tile(sc, m, l, corr, Nk, cpair, scale_log2);
      pack_p(sc, pa);
    }
    // Tile t issues S_t = Q K_t^T, rescales O while that runs, and issues
    // O += P_{t-1} V_{t-1}; the softmax of S_t then runs on the ALUs while
    // the second product holds the tensor cores (FA3's intra-warpgroup
    // pipelining), and one warpgroup's softmax also overlaps the others'
    // products.
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int sp = (t - 1) % STAGES;
      float sc[64];
      mbar_wait(k_full + 8 * s, (t / STAGES) & 1);
      turn_wait<NCONS>(wg);
      issue_qk<D, C::ROWS>(sc, q_wg, k_s + s * C::KV_BYTES);
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) rescale(o_acc, corr);
      mbar_wait(v_full + 8 * sp, ((t - 1) / STAGES) & 1);
      issue_pv<C::NSUB>(o_acc, pa, v_s + sp * C::KV_BYTES);
      turn_pass<NCONS>(wg);
      wg_wait<1>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty + 8 * s);  // done with K_t
      softmax_tile(sc, m, l, corr, Nk - t * BN, cpair, scale_log2);
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < C::NSUB; ++c) fence_regs(o_acc[c]);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + 8 * sp);  // and with V_{t-1}
      pack_p(sc, pa);  // P_{t-1} is no longer read
    }
    {  // O += P V of the last tile
      const int t = n_tiles - 1;
      const int s = t % STAGES;
      rescale(o_acc, corr);
      mbar_wait(v_full + 8 * s, (t / STAGES) & 1);
      turn_wait<NCONS>(wg);
      issue_pv<C::NSUB>(o_acc, pa, v_s + s * C::KV_BYTES);
      if (wg + 1 < NCONS) turn_pass<NCONS>(wg);  // passes balance the waits
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < C::NSUB; ++c) fence_regs(o_acc[c]);
    }

    // Epilogue: full row sums, 1/l, bf16, rows < Nq only.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const int row1 = row0 + 8;
    __nv_bfloat16* out = o + b * ob + h * oh;
#pragma unroll
    for (int c = 0; c < C::NSUB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + cpair;
        if (row0 < Nq)
          *reinterpret_cast<__nv_bfloat162*>(out + row0 * on + col) =
              __floats2bfloat162_rn(o_acc[c][4 * j] * inv[0], o_acc[c][4 * j + 1] * inv[0]);
        if (row1 < Nq)
          *reinterpret_cast<__nv_bfloat162*>(out + row1 * on + col) =
              __floats2bfloat162_rn(o_acc[c][4 * j + 2] * inv[1], o_acc[c][4 * j + 3] * inv[1]);
      }
  }
}

// ---------------------------------------------------------------- host side

// The plan, 43 int64 (ops/flash_attention.py `LaunchPlan.pack`):
//   [0] D  [1] rows per CTA  [2] grid x  [3] grid y  [4] H  [5] Nq  [6] Nk
//   [7..9] o element strides (batch, head, row)
//   [10 + 11 i ..], i = q, k, v: dims (D, N, H, B), byte strides (row, head,
//   batch), box (64, rows, 1, 1)
constexpr int MAP_AT = 10;
constexpr int MAP_LEN = 11;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

int encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, const int64_t* spec) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(spec[i]);
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(spec[4 + i]);
  for (int i = 0; i < 4; ++i) box[i] = static_cast<cuuint32_t>(spec[7 + i]);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE - static_cast<int>(r);
}

// The three tensor maps. With Nk = 0 q's map stands in for k's and v's (a
// map needs at least one row): the kernel loads one tile of q rows there
// and masks every key of it.
int encode_maps(const void* q, const void* k, const void* v, const int64_t* plan,
                CUtensorMap* maps) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_DRIVER_ENTRY;
  const void* ptrs[3] = {q, k, v};
  int64_t specs[3][MAP_LEN];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < MAP_LEN; ++j) specs[i][j] = plan[MAP_AT + MAP_LEN * i + j];
  if (plan[6] == 0) {  // Nk = 0: q's rows, strides and pointer with K/V's box
    for (int i = 1; i < 3; ++i) {
      for (int j = 0; j < 7; ++j) specs[i][j] = specs[0][j];
      ptrs[i] = q;
    }
  }
  for (int i = 0; i < 3; ++i) {
    const int err = encode(fn, &maps[i], ptrs[i], specs[i]);
    if (err != 0) return err;
  }
  return 0;
}

// Once per instantiation and device: the shared-memory opt-in, and a check
// that the kernel enters with the register count the setmaxnreg plan
// assumes (with fewer, setmaxnreg.inc would wait for registers forever).
template <int D, int NCONS>
int prepare() {
  using C = Cfg<D, NCONS>;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && ready[dev]) return 0;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D, NCONS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_kernel<D, NCONS>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs != C::ENTRY_REGS) return ERR_REGS;
  if (dev < 64) ready[dev] = true;
  return 0;
}

template <int D, int NCONS>
int launch(const CUtensorMap* maps, void* o, const int64_t* plan, float scale,
           cudaStream_t stream) {
  using C = Cfg<D, NCONS>;
  const int err = prepare<D, NCONS>();
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(plan[2]), static_cast<unsigned>(plan[3]));
  const float log2e = 1.4426950408889634f;
  flash_fwd_kernel<D, NCONS><<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), static_cast<int>(plan[4]),
      static_cast<int>(plan[5]), static_cast<int>(plan[6]), plan[7], plan[8], plan[9],
      scale * log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// softmax(q k^T * scale) v by the plan (see above). Returns 0, a cudaError_t
// (> 0) or one of the kernel's own codes (< 0: -1 plan, -2 no driver entry
// point, -3 register count, -1000 - CUresult of a failed tensor-map encode).
extern "C" int omg_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       const int64_t* plan, float scale, void* stream) {
  CUtensorMap maps[3];
  const int err = encode_maps(q, k, v, plan, maps);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t d = plan[0], rows = plan[1];
  if (d == 64 && rows == 192) return launch<64, 3>(maps, o, plan, scale, s);
  if (d == 64 && rows == 64) return launch<64, 1>(maps, o, plan, scale, s);
  if (d == 128 && rows == 128) return launch<128, 2>(maps, o, plan, scale, s);
  return ERR_PLAN;
}

// The tensor-map encoding alone (the host work a launch adds for TMA);
// for measuring it, never on the path.
extern "C" int omg_flash_attention_encode(const void* q, const void* k, const void* v,
                                          const int64_t* plan) {
  CUtensorMap maps[3];
  return encode_maps(q, k, v, plan, maps);
}
