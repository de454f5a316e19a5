// Dense flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel `_flash_kernel` reached through
// `flash_attention` in omg_tpu/ops/flash_attention.py: softmax(q k^T * D^-0.5) v
// over q [B, H, Nq, D] and k/v [B, H, Nk, D], no mask, no causal structure,
// fp32 scores, fp32 online-softmax state and fp32 output accumulators.
//
// What bounds it on the card: the tensor cores, not device memory. One
// (batch, head) at N = 4096, D = 64 is 4*N*N*D = 4.3 GFLOP over 2 MB of
// q/k/v/o; each query tile re-reads the head's K/V, but from the 50 MB L2,
// so device memory sees ~2000 flop per byte, far above the H100's ~295
// flop/byte ridge. What must stay off device memory is the N x N score
// matrix (the plain path writes 4 bytes per score, 4.7 GB per 7-lane
// 4096-token layer). The design: one CTA owns 64 query rows of one
// (batch, head) and streams K/V through shared memory in 64-key tiles;
// scores never leave the SM. Both products run on the tensor cores through
// WMMA bf16 fragments (mma.sync underneath), four warps of 16 query rows
// each. This first version stages scores, probabilities and the output
// accumulator through shared memory, so the online-softmax row rescale
// needs no knowledge of the fragment layout; that staging, not bandwidth,
// is what holds it to a small share of the bf16 peak. wgmma, TMA and a
// register-resident accumulator are later work.
//
// Differences from the TPU kernel, by design:
//   * The ragged edge is masked by bounds (key col < Nk, query row < Nq)
//     instead of padding the sequence to a 512-multiple; padded query rows
//     are never written and keys past Nk are zero-filled in shared memory.
//   * NaN safety does not rest on every tile holding a real key: a row whose
//     running max is still -inf gets a correction factor of 0 and zero
//     probabilities, so an all-masked tile can never produce inf - inf.
//   * Any strides: q/k/v/o take four element strides each, so the
//     [B, N, H, D] -> [B, H, N, D] head split of the fused QKV product needs
//     no copy. The innermost stride must be 1 and rows 16-byte aligned.
//
// Plain C entry point (loaded with ctypes), launched on the caller's stream;
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // query rows per CTA (16 per warp)
constexpr int BK = 64;        // keys per K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int S_LD = BK + 4;  // fp32 score row stride (multiple of 4)
static_assert(BQ == BK, "load_tile stages BK rows, the Q tile included");
constexpr int P_LD = BK + 8;  // bf16 probability row stride (multiple of 8)

__host__ __device__ constexpr int align32(int bytes) { return (bytes + 31) & ~31; }

template <int D>
struct Smem {
  static constexpr int KV_LD = D + 8;  // bf16 row stride of the Q/K/V tiles
  static constexpr int O_LD = D + 4;   // fp32 row stride of the accumulator
  static constexpr int q_off = 0;
  static constexpr int k_off = align32(q_off + BQ * KV_LD * 2);
  static constexpr int v_off = align32(k_off + BK * KV_LD * 2);
  static constexpr int s_off = align32(v_off + BK * KV_LD * 2);
  static constexpr int p_off = align32(s_off + BQ * S_LD * 4);
  static constexpr int o_off = align32(p_off + BQ * P_LD * 2);
  static constexpr int bytes = align32(o_off + BQ * O_LD * 4);
};

// Copy rows [row0, row0 + 64) of one (b, h) slice into a padded bf16 tile;
// rows at or past n are zero-filled so they never feed NaN into a product.
template <int D>
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                          int64_t row_stride, int row0, int n) {
  constexpr int VEC = 8;                 // 8 bf16 = 16 bytes per load
  constexpr int PER_ROW = D / VEC;
  constexpr int LD = Smem<D>::KV_LD;
  for (int i = threadIdx.x; i < BK * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 int H, int Nq, int Nk,
                 int64_t qb, int64_t qh, int64_t qn,
                 int64_t kb, int64_t kh, int64_t kn,
                 int64_t vb, int64_t vh, int64_t vn,
                 int64_t ob, int64_t oh, int64_t on,
                 float scale_log2) {
  using L = Smem<D>;
  constexpr int KV_LD = L::KV_LD;
  constexpr int O_LD = L::O_LD;
  constexpr int DT = D / 16;             // 16-wide tiles along the head dim

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* s_s = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* o_s = reinterpret_cast<float*>(smem + L::o_off);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;

  const __nv_bfloat16* qp = q + b * qb + h * qh;
  const __nv_bfloat16* kp = k + b * kb + h * kh;
  const __nv_bfloat16* vp = v + b * vb + h * vh;

  load_tile<D>(q_s, qp, qn, q0, Nq);
  float* o_w = o_s + warp * 16 * O_LD;
  for (int i = lane; i < 16 * D; i += 32) o_w[(i / D) * O_LD + (i % D)] = 0.f;
  __syncthreads();

  // This warp's 16 query rows stay in registers for the whole key loop.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    wmma::load_matrix_sync(qf[d], q_s + warp * 16 * KV_LD + d * 16, KV_LD);

  float* s_w = s_s + warp * 16 * S_LD;
  __nv_bfloat16* p_w = p_s + warp * 16 * P_LD;
  // Softmax bookkeeping: two lanes per query row, each owning half the keys
  // of a tile and half the head dim of the accumulator.
  const int row = lane >> 1;
  const int half = lane & 1;
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int kt = 0; kt < Nk; kt += BK) {
    __syncthreads();                     // every warp is done with the last tile
    load_tile<D>(k_s, kp, kn, kt, Nk);
    load_tile<D>(v_s, vp, vn, kt, Nk);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys (K read as a column-major B operand).
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, k_s + n * 16 * KV_LD + d * 16, KV_LD);
        wmma::mma_sync(acc, qf[d], kf, acc);
      }
      wmma::store_matrix_sync(s_w + n * 16, acc, S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax in the exp2 domain, keys past Nk masked by bounds.
    const float* srow = s_w + row * S_LD + half * (BK / 2);
    float sv[BK / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int col = kt + half * (BK / 2) + j;
      sv[j] = col < Nk ? srow[j] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const bool dead = m_new == -INFINITY;  // no real key seen yet
    const float corr = (m_i == -INFINITY) ? 0.f : exp2f(m_i - m_new);
    float sum = 0.f;
    __nv_bfloat16* prow = p_w + row * P_LD + half * (BK / 2);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float p = dead ? 0.f : exp2f(sv[j] - m_new);
      sum += p;
      prow[j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * corr + sum;
    m_i = m_new;
    float* orow = o_w + row * O_LD + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
    __syncwarp();

    // O += P V for 16 rows x D (V read as a row-major B operand).
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_w + n * 16, O_LD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, p_w + kk * 16, P_LD);
        wmma::load_matrix_sync(vf, v_s + kk * 16 * KV_LD + n * 16, KV_LD);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(o_w + n * 16, acc, O_LD, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Normalize and write the rows that exist; padded query rows are dropped.
  const int qrow = q0 + warp * 16 + row;
  if (qrow < Nq) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    const float* orow = o_w + row * O_LD + half * (D / 2);
    __nv_bfloat16* dst = o + b * ob + h * oh + (int64_t)qrow * on + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Nq, int Nk, const int64_t* st,
                   float scale, cudaStream_t stream) {
  const int bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Nq + BQ - 1) / BQ, B * H);
  const float log2e = 1.4426950408889634f;
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Nq, Nk,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11],
      scale * log2e);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, row) for q, k, v, o in order;
// the head-dim stride is 1 for all four.
extern "C" int omg_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int Nq, int Nk, int D,
                                       const int64_t* strides, float scale,
                                       void* stream) {
  if (B * H > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(launch<64>(q, k, v, o, B, H, Nq, Nk, strides, scale, s));
  if (D == 128) return static_cast<int>(launch<128>(q, k, v, o, B, H, Nq, Nk, strides, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
