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
// tower (L = 729, D = 72) run through it.  The TPU kernel keeps the whole of
// K and V for one (batch, head) in VMEM; here tiles stream through shared
// memory, so there is no length ceiling.
//
// Rounding points kept from the TPU kernel:
//   * forward: s = (q k^T) * scale in float32; p = exp(s - max) * (1 / sum),
//     a reciprocal then a multiply, rounded to bf16 before the PV product,
//     which accumulates in float32; o is rounded once.  Normalising before
//     PV needs the row's max and sum first, so the bf16 kernel makes two
//     passes over K: the first takes the row max and sum online, the second
//     recomputes s and does PV with normalised p;
//   * backward: p = exp(s - lse); dp = dO V^T; ds = p (dp - D_i) rounded to
//     bf16 for dq = ds K * scale and dk = ds^T Q * scale (the scale after the
//     product); dv = p^T dO with p unrounded float32 (_dkv_kernel:203-205),
//     on the tensor cores as p_hi^T dO + p_lo^T dO, p_hi = bf16(p),
//     p_lo = bf16(p - p_hi), within about 2^-16 of p's float32 product.
// Rounding p at K2's or K2b's point instead moves about half of o or dv by
// one bf16 ulp; chip_smoke.py and tests/test_torch_cuda.py hold o and dv to
// 2e-4 of the mean and check that K2's kernel and K2b's plain dv miss it.
// The exponentials are exp2f with log2(e) folded into the scale (and into
// lse in the backward); lse is written back in natural units.
//
// What bounds it on this card: the function is 2 products of 2 B H L^2 D
// flops forward and 5 backward (S, dP, dV, dK, dQ) over a few bytes per
// row, far above the H100's 295 flop/byte ridge: the tensor cores bound it
// (at the sliding-window shape B = 16, L = 964, H = 24, D = 128: 0.18 ms
// forward, 0.46 ms backward at 989 TFLOP/s).  The bf16 kernels run 3
// products forward (QK^T twice, PV) and 8 backward (S and dP in both
// kernels, dV twice for p's hi/lo split, dK, dQ: dq stays its own kernel,
// without atomics, so the gradient is deterministic).  Their design:
//   * every product is a warpgroup wgmma (m64nNk16, bf16 in, float32
//     accumulators in registers); products whose A is a previous product's
//     result (P V, P^T dO, dS^T Q, dS K) take A from registers and B from
//     shared memory with the transpose bit (flash_sm90.cuh);
//   * one block per (b, h, 128 rows): two consumer warpgroups of 64 rows
//     and one producer warp that streams the other operand's tiles by TMA
//     through a two-stage ring of shared-memory buffers, each with a "full"
//     and an "empty" mbarrier, while the resident tile stays put; the
//     producer warpgroup hands its registers to the consumers (setmaxnreg);
//   * the tensor maps read [B, L, H, D] through its real strides (the DiT's
//     q/k/v views need no copy); rows past L and columns past D arrive as
//     zeros (the head dim is padded to 64 or 128 in shared memory);
//   * the softmax runs on the accumulator fragments: a row lives in the
//     four threads of a quad, so two shuffles reduce it, and no logit or
//     probability tile is written to shared memory.
// float32 keeps the scalar kernels of attention_tiles.cuh (fp::): the
// tensor cores would round float32 to TF32, and no training path runs the
// DiT in float32.
//
// Plain C interface (ctypes): the entry points return cudaGetLastError(),
// or sm90::TMAP_ERROR + the driver's CUresult when a tensor map does not
// encode.

#include "attention_tiles.cuh"
#include "flash_sm90.cuh"

namespace {
namespace sm90 {

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- K5

constexpr int FWD_BQ = 128;  // q rows per block, 64 per consumer warpgroup
constexpr int FWD_BK = 128;  // k/v rows per streamed tile
constexpr int FWD_STAGES = 2;

template <int DP>
struct FwdSmem {
  bf16 q[FWD_BQ * DP];
  bf16 k[FWD_STAGES][FWD_BK * DP];
  bf16 v[FWD_STAGES][FWD_BK * DP];
  bf16 o[2][64 * (DP + 8)];  // epilogue staging, one per consumer warpgroup
  uint64_t q_full, k_full[FWD_STAGES], k_empty[FWD_STAGES], v_full[FWD_STAGES],
      v_empty[FWD_STAGES];
};

struct FwdMaps {
  CUtensorMap q, k, v;
};

struct FwdArgs {
  bf16* o;     // [B, L, H, D] contiguous
  float* lse;  // [B, H, L] or null
  int L, H, D;
  float scale_log2;  // scale * log2(e)
};

// s (a [64, N] accumulator of the tile from column k0) times scale_log2;
// columns at or past L to -inf
template <int N>
__device__ __forceinline__ void scale_mask(float* s, int k0, int c2, int L, float sl2) {
  const bool ragged = k0 + N > L;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = !ragged || k0 + 8 * j + c2 + e < L;
      s[4 * j + e] = ok ? s[4 * j + e] * sl2 : -INFINITY;
      s[4 * j + 2 + e] = ok ? s[4 * j + 2 + e] * sl2 : -INFINITY;
    }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<DP>& sm = *reinterpret_cast<FwdSmem<DP>*>(align1024(smem_raw));
  const int q0 = blockIdx.x * FWD_BQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (a.L + FWD_BK - 1) / FWD_BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], CONSUMER_WARPS);
      mbar_init(&sm.v_empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: Q once; K for pass 1, then K and V for pass 2, through the rings
    reg_dealloc<40>();
    if (tid == 0) {
      constexpr uint32_t TILE = FWD_BK * DP * sizeof(bf16);
      mbar_arrive_tx(&sm.q_full, FWD_BQ * DP * sizeof(bf16));
      tma_rows<DP>(sm.q, FWD_BQ, &maps.q, &sm.q_full, h, q0, b);
      for (int it = 0; it < 2 * nk; ++it) {
        const int j = it < nk ? it : it - nk;
        const int s = it % FWD_STAGES;
        mbar_wait(&sm.k_empty[s], ((it / FWD_STAGES) & 1) ^ 1);
        mbar_arrive_tx(&sm.k_full[s], TILE);
        tma_rows<DP>(sm.k[s], FWD_BK, &maps.k, &sm.k_full[s], h, j * FWD_BK, b);
        if (it >= nk) {
          const int sv = j % FWD_STAGES;
          mbar_wait(&sm.v_empty[sv], ((j / FWD_STAGES) & 1) ^ 1);
          mbar_arrive_tx(&sm.v_full[sv], TILE);
          tma_rows<DP>(sm.v[sv], FWD_BK, &maps.v, &sm.v_full[sv], h, j * FWD_BK, b);
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int warp = tid / 32, lane = tid % 32, c2 = 2 * (lane % 4);
    const int ksteps = (a.D + 15) / 16;
    const float sl2 = a.scale_log2;
    const uint32_t sq = smem_u32(sm.q);
    float s[FWD_BK / 2];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r and r + 8
    mbar_wait(&sm.q_full, 0);

    // pass 1: row max and this thread's share of the sum, online
    for (int it = 0; it < nk; ++it) {
      const int st = it % FWD_STAGES;
      mbar_wait(&sm.k_full[st], (it / FWD_STAGES) & 1);
      wg_fence();
      issue_rows_t<FWD_BK, DP>(s, sq, FWD_BQ, wg * 64, smem_u32(sm.k[st]), FWD_BK, ksteps);
      wg_commit();
      wg_wait_all();
      fence_regs<FWD_BK / 2>(s);
      if (lane == 0) mbar_arrive(&sm.k_empty[st]);
      scale_mask<FWD_BK>(s, it * FWD_BK, c2, a.L, sl2);
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int j = 0; j < FWD_BK / 8; ++j) {
        x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      x0 = quad_max(x0);  // finite: every tile has a column < L
      x1 = quad_max(x1);
      float e0 = 0.f, e1 = 0.f;
#pragma unroll
      for (int j = 0; j < FWD_BK / 8; ++j) {
        e0 += exp2f(s[4 * j] - x0) + exp2f(s[4 * j + 1] - x0);
        e1 += exp2f(s[4 * j + 2] - x1) + exp2f(s[4 * j + 3] - x1);
      }
      l0 = l0 * exp2f(m0 - x0) + e0;
      l1 = l1 * exp2f(m1 - x1) + e1;
      m0 = x0;
      m1 = x1;
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;

    // pass 2: p = exp(s - max) * (1 / sum) rounded to bf16 in registers; O += P V
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    uint32_t p[FWD_BK / 16][4];
    for (int it = 0; it < nk; ++it) {
      const int ring = nk + it, st = ring % FWD_STAGES;
      mbar_wait(&sm.k_full[st], (ring / FWD_STAGES) & 1);
      wg_fence();
      issue_rows_t<FWD_BK, DP>(s, sq, FWD_BQ, wg * 64, smem_u32(sm.k[st]), FWD_BK, ksteps);
      wg_commit();
      wg_wait_all();
      fence_regs<FWD_BK / 2>(s);
      if (lane == 0) mbar_arrive(&sm.k_empty[st]);
      scale_mask<FWD_BK>(s, it * FWD_BK, c2, a.L, sl2);
#pragma unroll
      for (int j = 0; j < FWD_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = exp2f(s[4 * j + e] - m0) * inv0;
          s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - m1) * inv1;
        }
      to_a<FWD_BK / 16>(p, s);
      const int sv = it % FWD_STAGES;
      mbar_wait(&sm.v_full[sv], (it / FWD_STAGES) & 1);
      wg_fence();
      issue_times_tile<DP, FWD_BK / 16>(o, p, smem_u32(sm.v[sv]), FWD_BK);
      wg_commit();
      wg_wait_all();
      fence_regs<DP / 2>(o);
      fence_regs<FWD_BK / 4>(&p[0][0]);
      if (lane == 0) mbar_arrive(&sm.v_empty[sv]);
    }

    const int r = q0 + wg * 64 + warp * 16 + lane / 4;
    if (a.lse != nullptr && lane % 4 == 0) {
      float* lse = a.lse + ((int64_t)b * a.H + h) * a.L;
      if (r < a.L) lse[r] = (m0 + log2f(l0)) * LN2;
      if (r + 8 < a.L) lse[r + 8] = (m1 + log2f(l1)) * LN2;
    }
    store_tile<DP>(o, 1.f, sm.o[wg], a.o + ((int64_t)b * a.L * a.H + h) * a.D, q0 + wg * 64,
                   a.L, (int64_t)a.H * a.D, a.D, wg, tid);
  }
}

// ---------------------------------------------------------------- K5b

struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

struct BwdArgs {
  const float* lse;  // [B, H, L]
  const float* di;   // [B, H, L]
  bf16* dq;          // [B, L, H, D] contiguous
  bf16* dk;
  bf16* dv;
  int L, H, D;
  float scale, scale_log2;
};

constexpr int KV_ROWS = 128;  // kv rows per dk/dv block, 64 per consumer warpgroup
constexpr int KV_BQ = 64;     // q (and dO) rows per streamed tile
constexpr int Q_ROWS = 128;   // q rows per dq block
constexpr int Q_BK = 64;      // k (and v) rows per streamed tile
constexpr int BWD_STAGES = 2;

template <int DP>
struct DkdvSmem {
  bf16 k[KV_ROWS * DP];
  bf16 v[KV_ROWS * DP];
  bf16 q[BWD_STAGES][KV_BQ * DP];
  bf16 dout[BWD_STAGES][KV_BQ * DP];
  bf16 stage[2][64 * (DP + 8)];
  float lse[BWD_STAGES][KV_BQ];  // times log2(e); +inf past L, so p = 0 there
  float di[BWD_STAGES][KV_BQ];
  uint64_t kv_full, full[BWD_STAGES], empty[BWD_STAGES];
};

// dK and dV of 128 kv rows: walks the q tiles, S^T = K Q^T and dP^T = V dO^T
// per tile; dK and dV stay in float32 registers throughout.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  DkdvSmem<DP>& sm = *reinterpret_cast<DkdvSmem<DP>*>(align1024(smem_raw));
  const int k0 = blockIdx.x * KV_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nq = (a.L + KV_BQ - 1) / KV_BQ;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp: TMA bytes and lse/D_i stores
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<40>();
    if (tid < 32) {
      const int lane = tid;
      const int64_t row0 = ((int64_t)b * a.H + h) * a.L;
      if (lane == 0) {
        mbar_arrive_tx(&sm.kv_full, 2 * KV_ROWS * DP * sizeof(bf16));
        tma_rows<DP>(sm.k, KV_ROWS, &maps.k, &sm.kv_full, h, k0, b);
        tma_rows<DP>(sm.v, KV_ROWS, &maps.v, &sm.kv_full, h, k0, b);
      }
      for (int it = 0; it < nq; ++it) {
        const int s = it % BWD_STAGES;
        mbar_wait(&sm.empty[s], ((it / BWD_STAGES) & 1) ^ 1);
        for (int i = lane; i < KV_BQ; i += 32) {
          const int l = it * KV_BQ + i;
          sm.lse[s][i] = l < a.L ? a.lse[row0 + l] * LOG2E : INFINITY;
          sm.di[s][i] = l < a.L ? a.di[row0 + l] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_tx(&sm.full[s], 2 * KV_BQ * DP * sizeof(bf16));
          tma_rows<DP>(sm.q[s], KV_BQ, &maps.q, &sm.full[s], h, it * KV_BQ, b);
          tma_rows<DP>(sm.dout[s], KV_BQ, &maps.dout, &sm.full[s], h, it * KV_BQ, b);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int warp = tid / 32, lane = tid % 32, c2 = 2 * (lane % 4);
    (void)warp;
    const int ksteps = (a.D + 15) / 16;
    const float sl2 = a.scale_log2;
    const uint32_t sk = smem_u32(sm.k), sv = smem_u32(sm.v);
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it < nq; ++it) {
      const int s = it % BWD_STAGES;
      mbar_wait(&sm.full[s], (it / BWD_STAGES) & 1);
      const uint32_t sq = smem_u32(sm.q[s]), sdo = smem_u32(sm.dout[s]);
      // S^T = K Q^T and dP^T = V dO^T: 64 kv rows of this warpgroup, 64 q columns
      float st[KV_BQ / 2], dpt[KV_BQ / 2];
      wg_fence();
      issue_rows_t<KV_BQ, DP>(st, sk, KV_ROWS, wg * 64, sq, KV_BQ, ksteps);
      issue_rows_t<KV_BQ, DP>(dpt, sv, KV_ROWS, wg * 64, sdo, KV_BQ, ksteps);
      wg_commit();
      wg_wait_all();
      fence_regs<KV_BQ / 2>(st);
      fence_regs<KV_BQ / 2>(dpt);
      // p^T = exp(s^T scale - lse) and ds^T = p^T (dp^T - D_i), lse and D_i by column
#pragma unroll
      for (int j = 0; j < KV_BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lse2 = sm.lse[s][8 * j + c2 + e], dd = sm.di[s][8 * j + c2 + e];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 4 * j + 2 * half + e;
            const float pr = exp2f(st[i] * sl2 - lse2);
            st[i] = pr;
            dpt[i] = pr * (dpt[i] - dd);
          }
        }
      uint32_t ds[KV_BQ / 16][4], phi[KV_BQ / 16][4], plo[KV_BQ / 16][4];
      to_a<KV_BQ / 16>(ds, dpt);
      to_a<KV_BQ / 16>(phi, st);
#pragma unroll
      for (int i = 0; i < KV_BQ / 2; ++i) st[i] -= __bfloat162float(__float2bfloat16(st[i]));
      to_a<KV_BQ / 16>(plo, st);
      // dV += P_hi^T dO + P_lo^T dO; dK += dS^T Q
      wg_fence();
      issue_times_tile<DP, KV_BQ / 16>(dv, phi, sdo, KV_BQ);
      issue_times_tile<DP, KV_BQ / 16>(dv, plo, sdo, KV_BQ);
      issue_times_tile<DP, KV_BQ / 16>(dk, ds, sq, KV_BQ);
      wg_commit();
      wg_wait_all();
      fence_regs<DP / 2>(dv);
      fence_regs<DP / 2>(dk);
      fence_regs<KV_BQ / 4>(&phi[0][0]);
      fence_regs<KV_BQ / 4>(&plo[0][0]);
      fence_regs<KV_BQ / 4>(&ds[0][0]);
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }
    const int64_t off = ((int64_t)b * a.L * a.H + h) * a.D, rs = (int64_t)a.H * a.D;
    store_tile<DP>(dk, a.scale, sm.stage[wg], a.dk + off, k0 + wg * 64, a.L, rs, a.D, wg, tid);
    store_tile<DP>(dv, 1.f, sm.stage[wg], a.dv + off, k0 + wg * 64, a.L, rs, a.D, wg, tid);
  }
}

template <int DP>
struct DqSmem {
  bf16 q[Q_ROWS * DP];
  bf16 dout[Q_ROWS * DP];
  bf16 k[BWD_STAGES][Q_BK * DP];
  bf16 v[BWD_STAGES][Q_BK * DP];
  bf16 stage[2][64 * (DP + 8)];
  uint64_t qdo_full, full[BWD_STAGES], empty[BWD_STAGES];
};

// dQ of 128 q rows: walks the kv tiles, S = Q K^T and dP = dO V^T per tile.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem<DP>& sm = *reinterpret_cast<DqSmem<DP>*>(align1024(smem_raw));
  const int q0 = blockIdx.x * Q_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nk = (a.L + Q_BK - 1) / Q_BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.qdo_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<40>();
    if (tid == 0) {
      mbar_arrive_tx(&sm.qdo_full, 2 * Q_ROWS * DP * sizeof(bf16));
      tma_rows<DP>(sm.q, Q_ROWS, &maps.q, &sm.qdo_full, h, q0, b);
      tma_rows<DP>(sm.dout, Q_ROWS, &maps.dout, &sm.qdo_full, h, q0, b);
      for (int it = 0; it < nk; ++it) {
        const int s = it % BWD_STAGES;
        mbar_wait(&sm.empty[s], ((it / BWD_STAGES) & 1) ^ 1);
        mbar_arrive_tx(&sm.full[s], 2 * Q_BK * DP * sizeof(bf16));
        tma_rows<DP>(sm.k[s], Q_BK, &maps.k, &sm.full[s], h, it * Q_BK, b);
        tma_rows<DP>(sm.v[s], Q_BK, &maps.v, &sm.full[s], h, it * Q_BK, b);
      }
    }
  } else {
    reg_alloc<232>();
    const int warp = tid / 32, lane = tid % 32, c2 = 2 * (lane % 4);
    const int ksteps = (a.D + 15) / 16;
    const float sl2 = a.scale_log2;
    const uint32_t sq = smem_u32(sm.q), sdo = smem_u32(sm.dout);
    // this thread's rows r and r + 8: lse (times log2 e; +inf past L) and D_i
    const int r = q0 + wg * 64 + warp * 16 + lane / 4;
    const int64_t row0 = ((int64_t)b * a.H + h) * a.L;
    const float lse0 = r < a.L ? a.lse[row0 + r] * LOG2E : INFINITY;
    const float lse1 = r + 8 < a.L ? a.lse[row0 + r + 8] * LOG2E : INFINITY;
    const float di0 = r < a.L ? a.di[row0 + r] : 0.f;
    const float di1 = r + 8 < a.L ? a.di[row0 + r + 8] : 0.f;
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    mbar_wait(&sm.qdo_full, 0);
    for (int it = 0; it < nk; ++it) {
      const int s = it % BWD_STAGES;
      mbar_wait(&sm.full[s], (it / BWD_STAGES) & 1);
      const uint32_t sk = smem_u32(sm.k[s]), sv = smem_u32(sm.v[s]);
      float sc[Q_BK / 2], dp[Q_BK / 2];
      wg_fence();
      issue_rows_t<Q_BK, DP>(sc, sq, Q_ROWS, wg * 64, sk, Q_BK, ksteps);
      issue_rows_t<Q_BK, DP>(dp, sdo, Q_ROWS, wg * 64, sv, Q_BK, ksteps);
      wg_commit();
      wg_wait_all();
      fence_regs<Q_BK / 2>(sc);
      fence_regs<Q_BK / 2>(dp);
#pragma unroll
      for (int j = 0; j < Q_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[4 * j + e] = exp2f(sc[4 * j + e] * sl2 - lse0) * (dp[4 * j + e] - di0);
          dp[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] * sl2 - lse1) * (dp[4 * j + 2 + e] - di1);
        }
      // ds = 0 in columns at or past L, on the last tile only: s = 0 there,
      // and exp2(0 - lse) overflows where a row's lse is very negative
      if ((it + 1) * Q_BK > a.L) {
#pragma unroll
        for (int j = 0; j < Q_BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (it * Q_BK + 8 * j + c2 + e >= a.L) dp[4 * j + e] = dp[4 * j + 2 + e] = 0.f;
      }
      uint32_t ds[Q_BK / 16][4];
      to_a<Q_BK / 16>(ds, dp);
      wg_fence();
      issue_times_tile<DP, Q_BK / 16>(dq, ds, sk, Q_BK);  // dQ += dS K
      wg_commit();
      wg_wait_all();
      fence_regs<DP / 2>(dq);
      fence_regs<Q_BK / 4>(&ds[0][0]);
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }
    store_tile<DP>(dq, a.scale, sm.stage[wg], a.dq + ((int64_t)b * a.L * a.H + h) * a.D,
                   q0 + wg * 64, a.L, (int64_t)a.H * a.D, a.D, wg, tid);
  }
}

// ---------------------------------------------------------------- host

// one warp-specialised kernel: dynamic shared memory above 48 KB (plus the
// 1024 bytes align1024 may skip), then the launch
template <typename Smem, typename Maps, typename Args>
int launch_ws(void (*kernel)(Maps, Args), dim3 grid, const Maps& maps, const Args& args,
              cudaStream_t stream) {
  const size_t smem = sizeof(Smem) + 1024;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(maps, args);
  return (int)cudaGetLastError();
}

template <int DP>
int fwd(const Params& p, cudaStream_t stream) {
  FwdMaps maps;
  int rc = encode_rows(&maps.q, p.q, p.B, p.L, p.H, p.D, p.q_sb, p.q_sl, p.q_sh, FWD_BQ);
  if (rc == 0) rc = encode_rows(&maps.k, p.k, p.B, p.L, p.H, p.D, p.k_sb, p.k_sl, p.k_sh, FWD_BK);
  if (rc == 0) rc = encode_rows(&maps.v, p.v, p.B, p.L, p.H, p.D, p.v_sb, p.v_sl, p.v_sh, FWD_BK);
  if (rc != 0) return rc;
  const FwdArgs args{static_cast<bf16*>(p.o), p.lse, p.L, p.H, p.D, p.scale * LOG2E};
  const dim3 grid((p.L + FWD_BQ - 1) / FWD_BQ, p.H, p.B);
  return launch_ws<FwdSmem<DP>>(fwd_kernel<DP>, grid, maps, args, stream);
}

// tensor maps over q, k, v and dO with `kv_box` rows for K and V boxes and
// `q_box` for Q and dO
inline int bwd_maps(BwdMaps* m, const BwdParams& p, int q_box, int kv_box) {
  const int64_t rs = (int64_t)p.H * p.D;  // dO is contiguous
  int rc = encode_rows(&m->q, p.q, p.B, p.L, p.H, p.D, p.q_sb, p.q_sl, p.q_sh, q_box);
  if (rc == 0) rc = encode_rows(&m->k, p.k, p.B, p.L, p.H, p.D, p.k_sb, p.k_sl, p.k_sh, kv_box);
  if (rc == 0) rc = encode_rows(&m->v, p.v, p.B, p.L, p.H, p.D, p.v_sb, p.v_sl, p.v_sh, kv_box);
  if (rc == 0)
    rc = encode_rows(&m->dout, p.dout, p.B, p.L, p.H, p.D, (int64_t)p.L * rs, rs, p.D, q_box);
  return rc;
}

template <int DP>
int bwd(const BwdParams& p, cudaStream_t stream) {
  BwdMaps kv_maps, q_maps;
  int rc = bwd_maps(&kv_maps, p, KV_BQ, KV_ROWS);
  if (rc == 0) rc = bwd_maps(&q_maps, p, Q_ROWS, Q_BK);
  if (rc != 0) return rc;
  const BwdArgs args{p.lse, p.di, static_cast<bf16*>(p.dq), static_cast<bf16*>(p.dk),
                     static_cast<bf16*>(p.dv), p.L, p.H, p.D, p.scale, p.scale * LOG2E};
  rc = launch_ws<DkdvSmem<DP>>(dkdv_kernel<DP>, dim3((p.L + KV_ROWS - 1) / KV_ROWS, p.H, p.B),
                               kv_maps, args, stream);
  if (rc != 0) return rc;
  return launch_ws<DqSmem<DP>>(dq_kernel<DP>, dim3((p.L + Q_ROWS - 1) / Q_ROWS, p.H, p.B),
                               q_maps, args, stream);
}

}  // namespace sm90

namespace flash {

// The head dim is padded to 64 or 128 in shared memory (the width of the
// 128-byte swizzle); every D the wrappers take (a multiple of 8 up to 128)
// has one of the two.
int dispatch_fwd(int dtype, const Params& p, cudaStream_t stream) {
  if (bad_shape(p.D, p.L, p.B, p.H)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch(fp::kernel<false>, fp::BQ, fp::THREADS, fp::smem_bytes(p.D),
                  fp::smem_bytes(DMAX), p, stream);
  if (dtype == 1) return p.D <= 64 ? sm90::fwd<64>(p, stream) : sm90::fwd<128>(p, stream);
  return (int)cudaErrorInvalidValue;
}

int dispatch_bwd_flash(int dtype, const void* o, const BwdParams& p, cudaStream_t stream) {
  if (dtype != 1) return dispatch_bwd<false>(dtype, o, p, stream);  // float32 (or refused)
  if (bad_shape(p.D, p.L, p.B, p.H)) return (int)cudaErrorInvalidValue;
  const int rc = launch_dot_rows(dtype, o, p, stream);
  if (rc != 0) return rc;
  return p.D <= 64 ? sm90::bwd<64>(p, stream) : sm90::bwd<128>(p, stream);
}

}  // namespace flash
}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; D is contiguous
// (bfloat16: base pointers and strides 16-byte aligned, for the TMA).
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
  return flash::dispatch_bwd_flash(dtype, o, p, static_cast<cudaStream_t>(stream));
}
