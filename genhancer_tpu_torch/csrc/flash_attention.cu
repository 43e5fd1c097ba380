// Flash attention for long sequences (forward K5, backward K5b) for Hopper,
// sm_90a.
//
// Replaces the Pallas kernels of genhancer_tpu/core/pallas/flash_attention.py:
//   * _fwd_kernel:55  (K5)  exact unmasked softmax attention over [B, L, H, D]
//                           plus each row's log-sum-exp (lse = max + log sum),
//                           float32 [B, H, L];
//   * _dq_kernel:156, _dkv_kernel:175 (K5b)  dq, and dk/dv, recomputing
//                           p = exp(s - lse) from the saved lse.
// The caller has already rotated q and k (no RoPE here).  The DiT's joint
// attention at L >= 600 (every video mode but next-frame) and the SigLIP-384
// tower (L = 729, D = 72) run through it.
//
// The TPU kernel keeps the whole of K and V for one (batch, head) in VMEM and
// blocks only the query axis.  Here K and V stream through shared memory in
// 64-row tiles, so there is no length ceiling (the TPU's VMEM limit, and the
// query-chunked fallback it needs past it, have no counterpart).
//
// Rounding points kept from the TPU kernel:
//   * forward: s = (q k^T) * scale in float32; p = exp(s - max) * (1 / sum),
//     a reciprocal then a multiply, rounded to the input type before the PV
//     product, which accumulates in float32; o is rounded once.  Normalising
//     before PV needs the row's max and sum first, so the bf16 kernel makes
//     two passes over K: the first computes the row max and sum (online, in
//     float32), the second recomputes s and does PV with normalised p.  That
//     costs one more QK^T (1.5x the forward's products) and keeps the TPU's
//     rounding.  The float32 kernel is the single-pass one of K2: p is not
//     rounded there, so where 1/sum is applied only moves float32 ulps.
//   * backward: as K2b (attention_tiles.cuh), except dv = p^T dO with p in
//     float32 (the DV_F32 variant: a hi/lo bf16 split on the tensor cores).
// Both are visible in the mean error against the plain version: rounding p
// at K2's or K2b's point moves about half of o or dv by one bf16 ulp
// (chip_smoke.py and tests/test_torch_cuda.py hold o and dv to 2e-4 of the
// mean, and check that K2's kernel and K2b's plain dv miss that bound).
//
// What bounds it on this card: at the sliding-window training shape (B = 16,
// L = 964, H = 24, D = 128) one (batch, head) does 6 L^2 D = 0.71 GFLOP in
// the forward over 4 L D 2 = 1 MB, far above the H100's 295 flop/byte ridge:
// the tensor cores should bound it.  This first kernel uses WMMA (mma.sync
// 16x16x16) with the logits round-tripping through shared memory, one
// 4-warp block per (batch, head, 64-row q tile); wgmma, TMA and keeping the
// softmax in registers are later work.
//
// Plain C interface (ctypes): the entry points return cudaGetLastError().

#include "attention_tiles.cuh"

namespace {
namespace flash {

// Shared memory of fwd_tc: Q, K, V tiles, this tile's float32 logits and
// bf16 probabilities, and the row max / sum / reciprocal.
__host__ __device__ constexpr size_t fwd_smem_bytes(int D) {
  return (size_t)3 * 64 * tc::ldx(D) * sizeof(bf16) + (size_t)tc::BQ * tc::LDS * sizeof(float) +
         (size_t)tc::BQ * tc::LDP * sizeof(bf16) + 3 * tc::BQ * sizeof(float);
}

// Two-pass forward for bfloat16 (see the head of this file).
__global__ void __launch_bounds__(tc::THREADS) fwd_tc(Params p) {
  using namespace tc;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int D = p.D, L = p.L, Dp = dpad(D), ld = ldx(D), nf = Dp / 16;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + 64 * ld;
  bf16* sV = sK + 64 * ld;
  float* sS = reinterpret_cast<float*>(sV + 64 * ld);  // this tile's logits
  bf16* sP = reinterpret_cast<bf16*>(sS + BQ * LDS);    // this tile's probabilities
  float* sM = reinterpret_cast<float*>(sP + BQ * LDP);  // row max
  float* sL = sM + BQ;     // row sum of exp(s - max)
  float* sInv = sL + BQ;   // 1 / row sum

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr0 = warp * 16;  // this warp's first q row in the block
  // softmax work split: two lanes per row of this warp, 32 columns each
  const int r = wr0 + (lane >> 1), c0 = (lane & 1) * 32;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  if (tid < BQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  load_rows<false, bf16>(sQ, ld, qb, p.q_sl, q0, BQ, L, D, Dp, nullptr, nullptr);
  __syncthreads();

  // pass 1: the row max and sum of exp(s - max), online over the K tiles
  for (int k0 = 0; k0 < L; k0 += BK) {
    const int nk = min(BK, L - k0);
    load_rows<false, bf16>(sK, ld, kb, p.k_sl, k0, BK, L, D, Dp, nullptr, nullptr);
    __syncthreads();
    rows_times_tile_t(sS + wr0 * LDS, sQ + wr0 * ld, sK, ld, nf);
    __syncwarp();
    const float* srow = sS + r * LDS;
    float mx = -INFINITY;
    for (int c = c0; c < c0 + 32; ++c) mx = fmaxf(mx, c < nk ? srow[c] * p.scale : -INFINITY);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = sM[r];
    const float m_new = fmaxf(m_old, mx);  // finite: every tile has a valid column
    float sum = 0.f;
    for (int c = c0; c < c0 + 32; ++c)
      if (c < nk) sum += expf(srow[c] * p.scale - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();  // both lanes of the row have read sM[r]
    if ((lane & 1) == 0) {
      sL[r] = sL[r] * expf(m_old - m_new) + sum;
      sM[r] = m_new;
    }
    __syncthreads();  // the next tile overwrites sK
  }
  if (tid < BQ) sInv[tid] = 1.f / sL[tid];
  __syncthreads();

  // pass 2: p = exp(s - max) * (1 / sum), rounded to bf16; O += P V
  FragC o[DMAX / 16];
#pragma unroll
  for (int j = 0; j < DMAX / 16; ++j) wmma::fill_fragment(o[j], 0.f);
  const float m_row = sM[r], inv_row = sInv[r];
  for (int k0 = 0; k0 < L; k0 += BK) {
    const int nk = min(BK, L - k0);
    load_rows<false, bf16>(sK, ld, kb, p.k_sl, k0, BK, L, D, Dp, nullptr, nullptr);
    load_rows<false, bf16>(sV, ld, vb, p.v_sl, k0, BK, L, D, Dp, nullptr, nullptr);
    __syncthreads();
    rows_times_tile_t(sS + wr0 * LDS, sQ + wr0 * ld, sK, ld, nf);
    __syncwarp();
    const float* srow = sS + r * LDS;
    bf16* prow = sP + r * LDP;
    for (int c = c0; c < c0 + 32; ++c)
      prow[c] = __float2bfloat16(c < nk ? expf(srow[c] * p.scale - m_row) * inv_row : 0.f);
    __syncwarp();
    for (int kk = 0; kk * 16 < nk; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, sP + wr0 * LDP + kk * 16, LDP);
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) {
        if (j < nf) {
          FragV vf;
          wmma::load_matrix_sync(vf, sV + (kk * 16) * ld + j * 16, ld);
          wmma::mma_sync(o[j], a, vf, o[j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites sK and sV
  }

  // O -> global (already normalised), staged through the free sK/sV region
  float* sO = reinterpret_cast<float*>(sK) + warp * 16 * Dp;
#pragma unroll
  for (int j = 0; j < DMAX / 16; ++j) {
    if (j < nf) wmma::store_matrix_sync(sO + j * 16, o[j], Dp, wmma::mem_row_major);
  }
  __syncwarp();
  if (p.lse != nullptr && lane < 16 && q0 + wr0 + lane < L)
    p.lse[((int64_t)b * p.H + h) * L + q0 + wr0 + lane] =
        sM[wr0 + lane] + logf(sL[wr0 + lane]);
  bf16* ob = static_cast<bf16*>(p.o);
  for (int idx = lane; idx < 16 * D; idx += 32) {
    const int rr = idx / D, d = idx - rr * D;
    const int l = q0 + wr0 + rr;
    if (l < L) ob[(((int64_t)b * L + l) * p.H + h) * D + d] = __float2bfloat16(sO[rr * Dp + d]);
  }
}

int dispatch_fwd(int dtype, const Params& p, cudaStream_t stream) {
  if (p.D % 8 != 0 || p.D > DMAX || p.L < 1 || p.B < 1 || p.H < 1 || p.B > 65535 ||
      p.H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch(fp::kernel<false>, fp::BQ, fp::THREADS, fp::smem_bytes(p.D),
                  fp::smem_bytes(DMAX), p, stream);
  if (dtype == 1)
    return launch(fwd_tc, tc::BQ, tc::THREADS, fwd_smem_bytes(p.D), fwd_smem_bytes(DMAX), p,
                  stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; D is contiguous.
// o: [B, L, H, D] contiguous output; lse: null, or [B, H, L] float32 that
// receives each row's log-sum-exp (the forward under autograd).
extern "C" int genhancer_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o, void* lse, int64_t q_sb,
    int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
    int64_t v_sl, int64_t v_sh, int B, int L, int H, int D, float scale, void* stream) {
  const Params p{q, k, v, nullptr, nullptr, o, static_cast<float*>(lse), q_sb, q_sl, q_sh,
                 k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, B, L, H, D, scale};
  return flash::dispatch_fwd(dtype, p, static_cast<cudaStream_t>(stream));
}

// Backward.  o, dout: the forward's output and its cotangent, [B, L, H, D]
// contiguous; lse: the forward's [B, H, L]; di: [B, H, L] float32 scratch;
// dq, dk, dv: [B, L, H, D] contiguous outputs.  q, k, v as in the forward.
extern "C" int genhancer_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* di, void* dq, void* dk, void* dv, int64_t q_sb, int64_t q_sl,
    int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl,
    int64_t v_sh, int B, int L, int H, int D, float scale, void* stream) {
  const BwdParams p{q, k, v, dout, nullptr, nullptr, static_cast<const float*>(lse),
                    static_cast<const float*>(di), dq, dk, dv, q_sb, q_sl, q_sh, k_sb, k_sl,
                    k_sh, v_sb, v_sl, v_sh, B, L, H, D, scale};
  return dispatch_bwd<false, true>(dtype, o, p, static_cast<cudaStream_t>(stream));
}
