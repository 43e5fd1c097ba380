// Device code shared by the attention kernels of this package: their
// parameters, the float32 backward of K1b/K2b and K5b (fp::, scalar FMA),
// the backward's D_i pass (dot_rows) and the shape check.  In bf16 every
// kernel (K1, K2, K1b, K2b, K5, K5b) runs the wgmma/TMA kernels of
// attention_sm90.cuh; the float32 forward (K1, K2, K5) runs the split-TF32
// wgmma kernel of attention_tf32.cuh.
// Each .cu includes it once and compiles into its own shared library, so
// everything here stays in an anonymous namespace.
//
// None of these kernels rotates q or k: K1's forward runs the RoPE pass of
// short_attention.cu first, and K1b reads the rotated pair K1 wrote.  The
// float32 K1b backward un-rotates dq and dk as it stores them (store_pair).
// The float32 backward runs on the CUDA cores; no main path runs it (the
// training paths' attention is bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int DMAX = 128;  // head dim ceiling (multiple of 8 up to this)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;           // [B, L, H, D] contiguous
  float* lse;        // [B, H, L] row log-sum-exp of the scaled logits, or null
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int B, L, H, D;
  float scale;
};

// Rows [row0, row0 + nrows) of one (batch, head) slice into shared memory,
// row stride ld, columns [0, Dp) with Dp >= D; rows at or past L and columns
// at or past D are zero.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int64_t s_l, int row0,
                                          int nrows, int L, int D, int Dp) {
  const int half = Dp / 2;
  for (int idx = threadIdx.x; idx < nrows * half; idx += blockDim.x) {
    const int r = idx / half;
    const int i = idx - r * half;
    const int l = row0 + r;
    T e = from_f32<T>(0.f), o = e;
    if (l < L && 2 * i < D) {
      const T* p = src + (int64_t)l * s_l + 2 * i;
      e = p[0];
      o = p[1];
    }
    dst[r * ld + 2 * i] = e;
    dst[r * ld + 2 * i + 1] = o;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// Backward (bf16 K2b; K1b, K2b, K5b in float32): FlashAttention-2's split
// ---------------------------------------------------------------------------
//
// Replaces _bwd_kernel:112 (K1b) and _bwd_kernel_norope:125 (K2b) of
// genhancer_tpu/core/pallas/short_attention.py, which share _bwd_body:90,
// and (float32) _dq_kernel:156 / _dkv_kernel:175 of flash_attention.py.
// The TPU runs one program per batch element with the whole [H, L, L]
// logits in VMEM; here the work is split so that no block needs more than
// one 64-row tile of each operand and nothing is summed across blocks (the
// bf16 K1b, K2b and K5b split it the same way in attention_sm90.cuh):
//   1. dot_rows: D_i = sum_d dO * O in float32, [B, H, L];
//   2. dkdv: one block per (batch, head, k tile) walks the q tiles,
//      recomputes p = exp(s * scale - lse) from the forward's row
//      log-sum-exp and accumulates dK and dV in float32 registers;
//   3. dq: one block per (batch, head, q tile) walks the k tiles and
//      accumulates dQ.
// No atomics, and no ceiling on L.  Rounding points, as the TPU kernel:
//   * q and k arrive rotated (K1's rq and rk, rounded to T by its RoPE pass);
//   * dO enters dp = dO V^T and dv = p^T dO as stored (type T);
//   * p is rounded to T before p^T dO;
//   * ds = p (dp - D_i) is rounded to T before ds rk and ds^T rq;
//   * d_rq, d_rk are scaled in float32 and rounded to T, then (K1b)
//     un-rotated with (cos, -sin) in float32 and rounded to T again;
//   * dv is rounded to T once.
// (K5b keeps p in float32 for dv; its float32 kernels here never round p.)
// What bounds it: like the forward, a few MFLOP per (batch, head) at the
// training shape (B=16, L=257, H=16, D=64) — the backward does 2.5x the
// forward's products, which the bf16 kernels run on the tensor cores;
// float32 runs scalar FMA here (no TF32).

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // [B, L, H, D] contiguous
  const float* cos;  // [B, L, D/2] contiguous, only with ROPE
  const float* sin;
  const float* lse;  // [B, H, L] from the forward
  const float* di;   // [B, H, L] from dot_rows
  void* dq;          // [B, L, H, D] contiguous
  void* dk;
  void* dv;
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int B, L, H, D;
  float scale;
};

// One warp per (b, l, h) row: D_i = sum_d dO * O in float32 -> di[b, h, l].
template <typename T>
__global__ void dot_rows(const T* o, const T* dout, float* di, int B, int L, int H, int D) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (int64_t)B * L * H) return;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(orow[d]), to_f32(drow[d]), s);
  s = warp_sum(s);
  if (lane == 0) {
    const int64_t b = row / ((int64_t)L * H);
    const int64_t rem = row - b * L * H;
    const int64_t l = rem / H, h = rem - l * H;
    di[(b * H + h) * L + l] = s;
  }
}

// One finished gradient pair: x = acc * mult (float32), rounded to T; with
// ROPE the pair is then un-rotated with (cos, -sin) in float32 and rounded
// to T again, as _bwd_kernel's _apply_rope_full(d.astype(T), cos, -sin),
// each operation rounded on its own as PyTorch's apply_rope does.
template <bool ROPE, typename T>
__device__ __forceinline__ void store_pair(T* out, float e, float o, float mult, const float* cos_b,
                                           const float* sin_b, int l, int i, int D) {
  e = to_f32(from_f32<T>(e * mult));
  o = to_f32(from_f32<T>(o * mult));
  if (ROPE) {
    const float c = cos_b[(int64_t)l * (D / 2) + i];
    const float s = sin_b[(int64_t)l * (D / 2) + i];
    const float re = __fadd_rn(__fmul_rn(c, e), __fmul_rn(s, o));
    o = __fsub_rn(__fmul_rn(c, o), __fmul_rn(s, e));
    e = re;
  }
  out[2 * i] = from_f32<T>(e);
  out[2 * i + 1] = from_f32<T>(o);
}

namespace fp {
constexpr int THREADS = 128;  // 4 warps
constexpr int BT = 32;        // rows per tile; thread t owns row t/4 and pairs t%4 + 4j

__host__ __device__ constexpr size_t bwd_smem_bytes(int D) {
  return ((size_t)4 * BT * (D + 1) + (size_t)2 * BT * (BT + 1) + 2 * BT) * sizeof(float);
}

// dst[r, c] for c = cq + 4i of this thread's row r: p and ds of one tile.
// x_rows: the owned operand row r (rotated k or q), y: streamed tile.
template <bool OWN_K>
__device__ __forceinline__ void p_ds_row(float* sP, float* sDS, const float* sX, const float* sY,
                                         const float* sU, const float* sW, const float* lse,
                                         const float* di, int r, int cq, int D, float scale,
                                         bool own_valid, int other0, int L) {
  const int ld = D + 1, lp = BT + 1;
#pragma unroll
  for (int i = 0; i < BT / 4; ++i) {
    const int c = cq + 4 * i;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < D; ++d) {
      s = fmaf(sX[r * ld + d], sY[c * ld + d], s);
      dp = fmaf(sU[r * ld + d], sW[c * ld + d], dp);
    }
    // own rows are k rows (p^T): lse and D_i are per q column; else per own row
    const float m = OWN_K ? lse[c] : lse[r];
    const float dd = OWN_K ? di[c] : di[r];
    const float pr = (own_valid && other0 + c < L) ? expf(s * scale - m) : 0.f;
    sP[r * lp + c] = pr;
    sDS[r * lp + c] = pr * (dp - dd);
  }
}

template <bool ROPE>
__global__ void __launch_bounds__(THREADS) bwd_dkdv(BwdParams p) {
  extern __shared__ float smem[];
  const int D = p.D, L = p.L, H = p.H, ld = D + 1, lp = BT + 1;
  float* sK = smem;
  float* sV = sK + BT * ld;
  float* sQ = sV + BT * ld;
  float* sO = sQ + BT * ld;
  float* sP = sO + BT * ld;
  float* sDS = sP + BT * lp;
  float* sLse = sDS + BT * lp;
  float* sDi = sLse + BT;
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 2, cq = tid & 3;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t rs = (int64_t)H * D;
  const float* ob = static_cast<const float*>(p.dout) + ((int64_t)b * L * H + h) * D;
  const float* cos_b = ROPE ? p.cos + (int64_t)b * L * (D / 2) : nullptr;
  const float* sin_b = ROPE ? p.sin + (int64_t)b * L * (D / 2) : nullptr;
  const float* lse_b = p.lse + ((int64_t)b * H + h) * L;
  const float* di_b = p.di + ((int64_t)b * H + h) * L;

  load_rows<float>(sK, ld, kb, p.k_sl, k0, BT, L, D, D);
  load_rows<float>(sV, ld, vb, p.v_sl, k0, BT, L, D, D);
  float ak[DMAX / 8][2], av[DMAX / 8][2];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) ak[j][0] = ak[j][1] = av[j][0] = av[j][1] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    load_rows<float>(sQ, ld, qb, p.q_sl, q0, BT, L, D, D);
    load_rows<float>(sO, ld, ob, rs, q0, BT, L, D, D);
    if (tid < BT) {
      const int l = q0 + tid;
      sLse[tid] = l < L ? lse_b[l] : 0.f;
      sDi[tid] = l < L ? di_b[l] : 0.f;
    }
    __syncthreads();
    p_ds_row<true>(sP, sDS, sK, sQ, sV, sO, sLse, sDi, r, cq, D, p.scale, k0 + r < L, q0, L);
    __syncthreads();
    for (int c = 0; c < BT; ++c) {
      const float pv = sP[r * lp + c], dsv = sDS[r * lp + c];
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        const int d = 2 * (cq + 4 * j);
        if (d < D) {
          av[j][0] = fmaf(pv, sO[c * ld + d], av[j][0]);
          av[j][1] = fmaf(pv, sO[c * ld + d + 1], av[j][1]);
          ak[j][0] = fmaf(dsv, sQ[c * ld + d], ak[j][0]);
          ak[j][1] = fmaf(dsv, sQ[c * ld + d + 1], ak[j][1]);
        }
      }
    }
    __syncthreads();
  }
  const int l = k0 + r;
  if (l >= L) return;
  float* dkr = static_cast<float*>(p.dk) + ((int64_t)b * L + l) * rs + (int64_t)h * D;
  float* dvr = static_cast<float*>(p.dv) + ((int64_t)b * L + l) * rs + (int64_t)h * D;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    const int i = cq + 4 * j;
    if (2 * i < D) {
      store_pair<ROPE, float>(dkr, ak[j][0], ak[j][1], p.scale, cos_b, sin_b, l, i, D);
      store_pair<false, float>(dvr, av[j][0], av[j][1], 1.f, nullptr, nullptr, l, i, D);
    }
  }
}

template <bool ROPE>
__global__ void __launch_bounds__(THREADS) bwd_dq(BwdParams p) {
  extern __shared__ float smem[];
  const int D = p.D, L = p.L, H = p.H, ld = D + 1, lp = BT + 1;
  float* sQ = smem;
  float* sO = sQ + BT * ld;
  float* sK = sO + BT * ld;
  float* sV = sK + BT * ld;
  float* sP = sV + BT * ld;
  float* sDS = sP + BT * lp;
  float* sLse = sDS + BT * lp;
  float* sDi = sLse + BT;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 2, cq = tid & 3;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t rs = (int64_t)H * D;
  const float* ob = static_cast<const float*>(p.dout) + ((int64_t)b * L * H + h) * D;
  const float* cos_b = ROPE ? p.cos + (int64_t)b * L * (D / 2) : nullptr;
  const float* sin_b = ROPE ? p.sin + (int64_t)b * L * (D / 2) : nullptr;
  const float* lse_b = p.lse + ((int64_t)b * H + h) * L;
  const float* di_b = p.di + ((int64_t)b * H + h) * L;

  load_rows<float>(sQ, ld, qb, p.q_sl, q0, BT, L, D, D);
  load_rows<float>(sO, ld, ob, rs, q0, BT, L, D, D);
  if (tid < BT) {
    const int l = q0 + tid;
    sLse[tid] = l < L ? lse_b[l] : 0.f;
    sDi[tid] = l < L ? di_b[l] : 0.f;
  }
  float aq[DMAX / 8][2];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) aq[j][0] = aq[j][1] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BT) {
    load_rows<float>(sK, ld, kb, p.k_sl, k0, BT, L, D, D);
    load_rows<float>(sV, ld, vb, p.v_sl, k0, BT, L, D, D);
    __syncthreads();
    p_ds_row<false>(sP, sDS, sQ, sK, sO, sV, sLse, sDi, r, cq, D, p.scale, q0 + r < L, k0, L);
    __syncthreads();
    for (int c = 0; c < BT; ++c) {
      const float dsv = sDS[r * lp + c];
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        const int d = 2 * (cq + 4 * j);
        if (d < D) {
          aq[j][0] = fmaf(dsv, sK[c * ld + d], aq[j][0]);
          aq[j][1] = fmaf(dsv, sK[c * ld + d + 1], aq[j][1]);
        }
      }
    }
    __syncthreads();
  }
  const int l = q0 + r;
  if (l >= L) return;
  float* dqr = static_cast<float*>(p.dq) + ((int64_t)b * L + l) * rs + (int64_t)h * D;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    const int i = cq + 4 * j;
    if (2 * i < D) store_pair<ROPE, float>(dqr, aq[j][0], aq[j][1], p.scale, cos_b, sin_b, l, i, D);
  }
}
}  // namespace fp

// shapes no kernel here takes: D a multiple of 8 up to DMAX, non-empty
// B, L, H within the grid's y and z
inline bool bad_shape(int D, int L, int B, int H) {
  return D % 8 != 0 || D > DMAX || L < 1 || B < 1 || H < 1 || B > 65535 || H > 65535;
}

template <typename Kernel, typename P>
int launch(Kernel kernel, int bq, int threads, size_t smem, size_t smem_max, const P& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_max);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.L + bq - 1) / bq, p.H, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// D_i = sum_d dO * O per row (dot_rows) into p.di: the backward's first pass.
inline int launch_dot_rows(int dtype, const void* o, const BwdParams& p, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.B * p.L * p.H;
  const int blocks = (int)((rows + 7) / 8);  // 8 warps of 32, one row each
  float* di = const_cast<float*>(p.di);
  if (dtype == 0) {
    dot_rows<float><<<blocks, 256, 0, stream>>>(static_cast<const float*>(o),
                                                static_cast<const float*>(p.dout), di, p.B,
                                                p.L, p.H, p.D);
  } else if (dtype == 1) {
    dot_rows<bf16><<<blocks, 256, 0, stream>>>(static_cast<const bf16*>(o),
                                               static_cast<const bf16*>(p.dout), di, p.B, p.L,
                                               p.H, p.D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The launches, shapes checked by the caller (bad_shape).

namespace fp {
// D_i, dk/dv, dq; ROPE un-rotates dq and dk as they are stored (K1b)
template <bool ROPE>
int bwd(const void* o, const BwdParams& p, cudaStream_t stream) {
  int rc = launch_dot_rows(0, o, p, stream);
  if (rc == 0)
    rc = launch(bwd_dkdv<ROPE>, BT, THREADS, bwd_smem_bytes(p.D), bwd_smem_bytes(DMAX), p, stream);
  if (rc == 0)
    rc = launch(bwd_dq<ROPE>, BT, THREADS, bwd_smem_bytes(p.D), bwd_smem_bytes(DMAX), p, stream);
  return rc;
}
}  // namespace fp

}  // namespace
