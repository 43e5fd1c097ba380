// The warp-specialised bf16 attention kernels for Hopper (sm_90a), built on
// flash_sm90.cuh, shared by two libraries:
//   * flash_attention.cu: K5 (fwd_kernel) and K5b (dkdv_kernel, dq_kernel
//     with dV from p in float32), every length;
//   * short_attention.cu: K1 and K2 (short_fwd_kernel, the same forward
//     body, after K1's RoPE pass), K1b (dkdv_kernel, short_dq_kernel with dV
//     from p rounded to bf16 and the un-rotation of dq and dk in the
//     epilogue) and K2b (the same without the un-rotation), L <= 600.
// The kernels see q and k already rotated: attention itself is the same
// function for all of them, and the forward's rounding point is the TPU
// kernels' (p normalised in float32, then rounded to bf16).  The head of
// flash_attention.cu sets out the design; short_attention.cu what K1, K2,
// K1b and K2b add.

#pragma once

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

// ---------------------------------------------------------------- forward (K1, K2, K5)

constexpr int FWD_BK = 128;  // k/v rows per streamed tile
constexpr int FWD_STAGES = 2;

// NWG consumer warpgroups of 64 q rows each, then the producer warpgroup
template <int DP, int NWG>
struct FwdSmem {
  bf16 q[64 * NWG * DP];
  bf16 k[FWD_STAGES][FWD_BK * DP];
  bf16 v[FWD_STAGES][FWD_BK * DP];
  bf16 o[NWG][64 * (DP + 8)];  // epilogue staging, one per consumer warpgroup
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

// One block per (b, h, 64 NWG q rows).  With NWG = 2 the producer hands its
// registers to the consumers (setmaxnreg); with NWG = 1 the block has 256
// threads and the 255-register ceiling needs no hand-over.
template <int DP, int NWG>
__device__ __forceinline__ void fwd_body(const FwdMaps& maps, const FwdArgs& a) {
  constexpr int BQ = 64 * NWG;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<DP, NWG>& sm = *reinterpret_cast<FwdSmem<DP, NWG>*>(align1024(smem_raw));
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (a.L + FWD_BK - 1) / FWD_BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 4 * NWG);
      mbar_init(&sm.v_empty[s], 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // producer: Q once; K for pass 1, then K and V for pass 2, through the rings
    if constexpr (NWG > 1) reg_dealloc<40>();
    if (tid == 0) {
      constexpr uint32_t TILE = FWD_BK * DP * sizeof(bf16);
      mbar_arrive_tx(&sm.q_full, BQ * DP * sizeof(bf16));
      tma_rows<DP>(sm.q, BQ, &maps.q, &sm.q_full, h, q0, b);
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
    if constexpr (NWG > 1) reg_alloc<232>();
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
      issue_rows_t<FWD_BK, DP>(s, sq, BQ, wg * 64, smem_u32(sm.k[st]), FWD_BK, ksteps);
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
      issue_rows_t<FWD_BK, DP>(s, sq, BQ, wg * 64, smem_u32(sm.k[st]), FWD_BK, ksteps);
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

// K5
template <int DP, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    fwd_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs a) {
  fwd_body<DP, NWG>(maps, a);
}

// K1 and K2: the same body under its own name, so that a profile tells the
// short-sequence forward from K5
template <int DP, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    short_fwd_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs a) {
  fwd_body<DP, NWG>(maps, a);
}

// ---------------------------------------------------------------- backward (K1b, K2b, K5b)

struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

struct BwdArgs {
  const float* lse;  // [B, H, L]
  const float* di;   // [B, H, L]
  const float* cos;  // [B, L, D/2] contiguous, only with ROPE
  const float* sin;
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

// the (b, h) slice's [L, D/2] rotation tables, or null
__device__ __forceinline__ const float* table_of(const float* t, int b, int L, int D) {
  return t == nullptr ? nullptr : t + (int64_t)b * L * (D / 2);
}

// dK and dV of 128 kv rows: walks the q tiles, S^T = K Q^T and dP^T = V dO^T
// per tile; dK and dV stay in float32 registers throughout.  EXACT_DV: dV
// from p in float32, as p_hi^T dO + p_lo^T dO (K5b); else from p rounded to
// bf16, one product (K1b, K2b).  ROPE: dK is un-rotated in the epilogue (K1b).
template <int DP, bool EXACT_DV, bool ROPE>
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
    const int lane = tid % 32, c2 = 2 * (lane % 4);
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
      uint32_t ds[KV_BQ / 16][4], phi[KV_BQ / 16][4];
      to_a<KV_BQ / 16>(ds, dpt);
      to_a<KV_BQ / 16>(phi, st);  // p rounded to bf16
      if constexpr (EXACT_DV) {
        // dV += P_hi^T dO + P_lo^T dO; dK += dS^T Q
        uint32_t plo[KV_BQ / 16][4];
#pragma unroll
        for (int i = 0; i < KV_BQ / 2; ++i) st[i] -= __bfloat162float(__float2bfloat16(st[i]));
        to_a<KV_BQ / 16>(plo, st);
        wg_fence();
        issue_times_tile<DP, KV_BQ / 16>(dv, phi, sdo, KV_BQ);
        issue_times_tile<DP, KV_BQ / 16>(dv, plo, sdo, KV_BQ);
        issue_times_tile<DP, KV_BQ / 16>(dk, ds, sq, KV_BQ);
        wg_commit();
        wg_wait_all();
        fence_regs<KV_BQ / 4>(&plo[0][0]);
      } else {
        // dV += bf16(P)^T dO; dK += dS^T Q
        wg_fence();
        issue_times_tile<DP, KV_BQ / 16>(dv, phi, sdo, KV_BQ);
        issue_times_tile<DP, KV_BQ / 16>(dk, ds, sq, KV_BQ);
        wg_commit();
        wg_wait_all();
      }
      fence_regs<DP / 2>(dv);
      fence_regs<DP / 2>(dk);
      fence_regs<KV_BQ / 4>(&phi[0][0]);
      fence_regs<KV_BQ / 4>(&ds[0][0]);
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }
    const int64_t off = ((int64_t)b * a.L * a.H + h) * a.D, rs = (int64_t)a.H * a.D;
    store_tile<DP, ROPE>(dk, a.scale, sm.stage[wg], a.dk + off, k0 + wg * 64, a.L, rs, a.D, wg,
                         tid, table_of(a.cos, b, a.L, a.D), table_of(a.sin, b, a.L, a.D));
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
// ROPE: dQ is un-rotated in the epilogue (K1b).
template <int DP, bool ROPE>
__device__ __forceinline__ void dq_body(const BwdMaps& maps, const BwdArgs& a) {
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
    store_tile<DP, ROPE>(dq, a.scale, sm.stage[wg], a.dq + ((int64_t)b * a.L * a.H + h) * a.D,
                         q0 + wg * 64, a.L, (int64_t)a.H * a.D, a.D, wg, tid,
                         table_of(a.cos, b, a.L, a.D), table_of(a.sin, b, a.L, a.D));
  }
}

// K5b's dq
template <int DP, bool ROPE>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  dq_body<DP, ROPE>(maps, a);
}

// K1b's and K2b's dq: the same body under its own name, so that a profile
// tells the short-sequence backward from K5b
template <int DP, bool ROPE>
__global__ void __launch_bounds__(THREADS, 1)
    short_dq_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  dq_body<DP, ROPE>(maps, a);
}

// ---------------------------------------------------------------- host

// one warp-specialised kernel: dynamic shared memory above 48 KB (plus the
// 1024 bytes align1024 may skip), then the launch
template <typename Smem, typename Maps, typename Args>
int launch_ws(void (*kernel)(Maps, Args), dim3 grid, int threads, const Maps& maps,
              const Args& args, cudaStream_t stream) {
  const size_t smem = sizeof(Smem) + 1024;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(maps, args);
  return (int)cudaGetLastError();
}

// The forward over (q, k, v) of p, with 64 NWG q rows per block: K1/K2's
// kernel if SHORT, else K5's.
template <int DP, int NWG, bool SHORT>
int fwd(const Params& p, cudaStream_t stream) {
  constexpr int BQ = 64 * NWG;
  FwdMaps maps;
  int rc = encode_rows(&maps.q, p.q, p.B, p.L, p.H, p.D, p.q_sb, p.q_sl, p.q_sh, BQ);
  if (rc == 0) rc = encode_rows(&maps.k, p.k, p.B, p.L, p.H, p.D, p.k_sb, p.k_sl, p.k_sh, FWD_BK);
  if (rc == 0) rc = encode_rows(&maps.v, p.v, p.B, p.L, p.H, p.D, p.v_sb, p.v_sl, p.v_sh, FWD_BK);
  if (rc != 0) return rc;
  const FwdArgs args{static_cast<bf16*>(p.o), p.lse, p.L, p.H, p.D, p.scale * LOG2E};
  const dim3 grid((p.L + BQ - 1) / BQ, p.H, p.B);
  if constexpr (SHORT)
    return launch_ws<FwdSmem<DP, NWG>>(short_fwd_kernel<DP, NWG>, grid, 128 * (NWG + 1), maps,
                                       args, stream);
  else
    return launch_ws<FwdSmem<DP, NWG>>(fwd_kernel<DP, NWG>, grid, 128 * (NWG + 1), maps, args,
                                       stream);
}

// the head dim padded to 64 or 128 in shared memory (the width of the
// 128-byte swizzle): every D the wrappers take (a multiple of 8 up to 128)
// has one of the two
template <int NWG, bool SHORT>
int fwd_padded(const Params& p, cudaStream_t stream) {
  return p.D <= 64 ? fwd<64, NWG, SHORT>(p, stream) : fwd<128, NWG, SHORT>(p, stream);
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

// dk/dv, then dq; p.di must already hold D_i (launch_dot_rows)
template <int DP, bool EXACT_DV, bool ROPE>
int bwd(const BwdParams& p, cudaStream_t stream) {
  BwdMaps kv_maps, q_maps;
  int rc = bwd_maps(&kv_maps, p, KV_BQ, KV_ROWS);
  if (rc == 0) rc = bwd_maps(&q_maps, p, Q_ROWS, Q_BK);
  if (rc != 0) return rc;
  const BwdArgs args{p.lse, p.di, p.cos, p.sin, static_cast<bf16*>(p.dq),
                     static_cast<bf16*>(p.dk), static_cast<bf16*>(p.dv), p.L, p.H, p.D,
                     p.scale, p.scale * LOG2E};
  rc = launch_ws<DkdvSmem<DP>>(dkdv_kernel<DP, EXACT_DV, ROPE>,
                               dim3((p.L + KV_ROWS - 1) / KV_ROWS, p.H, p.B), THREADS, kv_maps,
                               args, stream);
  if (rc != 0) return rc;
  // EXACT_DV is K5b's; K1b and K2b round p
  const dim3 grid((p.L + Q_ROWS - 1) / Q_ROWS, p.H, p.B);
  if constexpr (EXACT_DV)
    return launch_ws<DqSmem<DP>>(dq_kernel<DP, ROPE>, grid, THREADS, q_maps, args, stream);
  else
    return launch_ws<DqSmem<DP>>(short_dq_kernel<DP, ROPE>, grid, THREADS, q_maps, args, stream);
}

// D_i, then bwd at the padded head dim
template <bool EXACT_DV, bool ROPE>
int bwd_padded(const void* o, const BwdParams& p, cudaStream_t stream) {
  const int rc = launch_dot_rows(1, o, p, stream);
  if (rc != 0) return rc;
  return p.D <= 64 ? bwd<64, EXACT_DV, ROPE>(p, stream) : bwd<128, EXACT_DV, ROPE>(p, stream);
}

}  // namespace sm90
}  // namespace
