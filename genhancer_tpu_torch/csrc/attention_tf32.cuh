// The float32 attention forward for Hopper (sm_90a): split TF32 on wgmma.
// One body serves K2 in float32 (the MMVP-VLM eval's tower), K1 in float32
// (after short_attention.cu's RoPE pass) and K5 in float32
// (flash_attention.cu); the float32 backward stays the scalar fp:: kernels
// of attention_tiles.cuh, which read the lse written here.
//
// Replaces, in float32, _fwd_kernel_norope:84 and _fwd_kernel:76 of
// genhancer_tpu/core/pallas/short_attention.py and _fwd_kernel:55 of
// flash_attention.py.  In float32 the TPU body's p.astype(v.dtype) is a
// no-op, so p has no rounding point: one pass over K with an online
// softmax and a final division by the row sum is the same function.
//
// Float32 on the tensor cores.  wgmma has no float32 product; its TF32 one
// keeps 10 of float32's 23 mantissa bits.  The split product restores
// them: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded
// to nearest (cvt.rna.tf32.f32, so nothing depends on what the tensor core
// does with the low 13 bits of a raw float32), and
//     a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b
// (lo_a lo_b is below float32's own rounding).  S = Q K^T and each k/v
// tile's P V run as these three wgmma, into float32 accumulators that the
// registers then join: S's hi hi in two halves of D and its cross terms
// apart, each tile's P V into O, so no chain of tensor-core sums runs over
// a whole row or grows large.  That is float32's accuracy at 3x the TF32
// work (495 TFLOP/s dense, so ~165 of float32 against the CUDA cores' 67).
// Dropping one cross term moves o's mean
// error from ~4e-7 to ~2e-4 of its mean, which a max bound of 1e-4 cannot
// see: chip_smoke.py and tests/test_torch_cuda.py hold o to a mean error
// of 1e-5 of exact float32 and check that controls dropping a term (the
// plain emulation short_attention.split_tf32_attention_ref) miss it.
//
// What bounds it: 2 products of 2 B H L^2 D flops, i.e. 6 TF32 products,
// at the eval's B = 50, H = 16, D = 64: 0.082 ms at L = 257 and 0.413 ms at
// L = 577 at 495 TFLOP/s, against 0.063 and 0.141 ms of bytes: the tensor
// cores.  The design:
//   * one block per (b, h, 64 NWG q rows): NWG consumer warpgroups, no
//     producer; every thread loads and splits;
//   * the k/v tiles stream through a two-stage ring of split tiles in
//     shared memory: while the tensor cores run tile t's products, the
//     threads load tile t + 1 from device memory (16-byte loads where the
//     bases and strides allow, else 4-byte ones: any B/L/H strides), split
//     it and store hi and lo into the other stage, in the layout the TMA's
//     128-byte swizzle would leave (so flash_sm90.cuh's descriptors read
//     it); one fence.proxy.async and one barrier per tile;
//   * TF32 wgmma reads both shared-memory operands K-major only (no
//     transpose bit): Q and K rows are D-contiguous, as S = Q K^T wants;
//     V is stored transposed, kv-contiguous, by the pass that splits it;
//   * p becomes wgmma's A operand in registers without a shuffle.  The
//     accumulator holds columns 8j + 2c + {0, 1} of each row (c = lane % 4);
//     a k8 TF32 A fragment wants columns c and c + 4.  So a0..a3 take
//     d[4j], d[4j + 2], d[4j + 1], d[4j + 3], and the split pass stores kv
//     row 8j + i of V^T at column 8j + (i >> 1) + 4 (i & 1): the order
//     0 2 4 6 1 3 5 7, under which the product sums the same terms
//     (tests/test_torch_tf32_split.py checks the algebra);
//   * the head dim is padded to 64 or 128 in shared memory; D = 64 (the
//     towers) takes two warpgroups and 64-row kv tiles, D up to 128 one
//     warpgroup and 32-row kv tiles, each 192 KB of shared memory: Q hi and
//     lo, two stages of K hi and lo and of V^T hi and lo.  (At the eval's
//     shapes one warpgroup with 32-row tiles, two blocks to an SM, and one
//     warpgroup with 64-row tiles were both slower at L = 577:
//     scripts/torch_k2_f32_probe.py, PERF.md.)  Rows
//     past L and columns past D are stored as zeros, and the products run
//     over all DP columns, so no branch splits a group of wgmma (with a
//     branch there and no register fence around the group, ptxas
//     serialized them); columns past L go to -inf before the row max.
// lse (natural units) is written for rows < L when asked, for the float32
// backward.

#pragma once

#include "attention_sm90.cuh"  // scale_mask, quad_max, quad_sum; flash_sm90.cuh

namespace {
namespace tf32 {

using sm90::desc_kmajor;
using sm90::fence_regs;
using sm90::smem_u32;

__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 rounded to nearest (ties away)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// byte offset of the 16-byte unit u (columns 4u .. 4u + 3) of row r in a
// K-major float32 tile of `rows` rows: 32-column chunks of `rows` x 128
// bytes, each row's units XOR-ed with r % 8 (the 128-byte swizzle; tiles
// start on 1024-byte boundaries)
__device__ __forceinline__ uint32_t unit_off(int rows, int r, int u) {
  return (u >> 3) * rows * 128 + r * 128 + (((u & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void store_split(float* hi, float* lo, uint32_t off, float4 x) {
  uint4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(reinterpret_cast<char*>(hi) + off) = h;
  *reinterpret_cast<uint4*>(reinterpret_cast<char*>(lo) + off) = l;
}

// Rows [row0, row0 + ROWS) of one (b, h) slice (row stride s_l, D
// contiguous), split into the K-major tiles hi and lo [ROWS, DP]; rows at
// or past L and columns at or past D are zero.  All loads first.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void split_rows(float* hi, float* lo, const float* src, int64_t s_l,
                                           int row0, int L, int D, bool vec) {
  constexpr int UPR = DP / 4, ITER = ROWS * UPR / NT;
  static_assert(ITER * NT == ROWS * UPR, "tile split evenly over the threads");
  float4 x[ITER];
#pragma unroll
  for (int j = 0; j < ITER; ++j) {
    const int i = threadIdx.x + j * NT, r = i / UPR, u = i % UPR, l = row0 + r;
    x[j] = (l < L && 4 * u < D) ? load4(src + (int64_t)l * s_l + 4 * u, vec)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < ITER; ++j) {
    const int i = threadIdx.x + j * NT;
    store_split(hi, lo, unit_off(ROWS, i / UPR, i % UPR), x[j]);
  }
}

// kv rows [row0, row0 + BK) of V, split into the K-major tiles of V^T
// [DP, BK] (kv contiguous), kv row 8g + i at column 8g + (i >> 1) + 4 (i & 1).
// A thread takes rows 8g + e, 8g + e + 2, +4, +6 at columns 4 dq .. 4 dq + 3:
// for each of those four d, one 16-byte unit of V^T (columns 8g + 4e ..
// 8g + 4e + 3).  Eight neighbouring threads share dq and cover eight units
// of one row, so the stores meet no bank conflict.
template <int BK, int DP, int NT>
__device__ __forceinline__ void split_vt(float* hi, float* lo, const float* src, int64_t s_l,
                                         int row0, int L, int D, bool vec) {
  constexpr int UNITS = (BK / 4) * (DP / 4), ITER = UNITS / NT;
  static_assert(ITER * NT == UNITS, "tile split evenly over the threads");
#pragma unroll
  for (int j = 0; j < ITER; ++j) {
    const int i = threadIdx.x + j * NT;
    const int e = i & 1, g = (i >> 1) % (BK / 8), dq = i / (BK / 4);
    float4 x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int l = row0 + 8 * g + 2 * t + e;
      x[t] = (l < L && 4 * dq < D) ? load4(src + (int64_t)l * s_l + 4 * dq, vec)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int u = 2 * g + e;
    store_split(hi, lo, unit_off(DP, 4 * dq + 0, u), make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
    store_split(hi, lo, unit_off(DP, 4 * dq + 1, u), make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
    store_split(hi, lo, unit_off(DP, 4 * dq + 2, u), make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
    store_split(hi, lo, unit_off(DP, 4 * dq + 3, u), make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
  }
}

// ---------------------------------------------------------------- wgmma, TF32

// D[64 x 32] (+)= A[64 x 8] B[8 x 32] in TF32, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64] in TF32, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64] in TF32, A from registers (four tf32),
// B from shared memory (K-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 8] B[8 x 128] in TF32, A from registers (four tf32),
// B from shared memory (K-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  static_assert(N == 32 || N == 64, "wgmma width");
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, accumulate);
  else wgmma_ss_n64(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) wgmma_rs_n64(d, a, b, accumulate);
  else wgmma_rs_n128(d, a, b, accumulate);
}

// ---------------------------------------------------------------- the kernel

template <int DP, int NWG, int BK>
struct Smem {
  float q_hi[64 * NWG * DP];
  float q_lo[64 * NWG * DP];
  float k_hi[2][BK * DP];
  float k_lo[2][BK * DP];
  float vt_hi[2][DP * BK];  // V^T, kv permuted within each group of 8
  float vt_lo[2][DP * BK];
};

// One block of 128 NWG threads per (b, h, 64 NWG q rows); warpgroup wg owns
// rows 64 wg .. 64 wg + 63 of the block.
template <int DP, int NWG, int BK>
__global__ void __launch_bounds__(128 * NWG, 1) fwd_kernel(const Params p, const int vec) {
  constexpr int BQ = 64 * NWG, NT = 128 * NWG;
  extern __shared__ unsigned char smem_raw[];
  Smem<DP, NWG, BK>& sm = *reinterpret_cast<Smem<DP, NWG, BK>*>(sm90::align1024(smem_raw));
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L, D = p.D, nk = (L + BK - 1) / BK;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  split_rows<BQ, DP, NT>(sm.q_hi, sm.q_lo, qb, p.q_sl, q0, L, D, vec);
  split_rows<BK, DP, NT>(sm.k_hi[0], sm.k_lo[0], kb, p.k_sl, 0, L, D, vec);
  split_vt<BK, DP, NT>(sm.vt_hi[0], sm.vt_lo[0], vb, p.v_sl, 0, L, D, vec);
  fence_async_shared();
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, c2 = 2 * (lane % 4);
  const float sl2 = p.scale * sm90::LOG2E;
  const uint32_t qh = smem_u32(sm.q_hi), ql = smem_u32(sm.q_lo);
  // S (in three parts, see below), this tile's P V, O
  float s[BK / 2], s2[BK / 2], sx[BK / 2], t[DP / 2], o[DP / 2];
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r and r + 8, log2 units

  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    const bool more = it + 1 < nk;
    const uint32_t kh = smem_u32(sm.k_hi[st]), kl = smem_u32(sm.k_lo[st]);
    // S = Qhi Khi^T + Qhi Klo^T + Qlo Khi^T over all DP columns (those past
    // D are zeros: no branch between the wgmma of one group), in three
    // accumulators joined in registers: Qhi Khi^T over the first and the
    // second half of D, and the two cross terms.  Each wgmma adds to its
    // accumulator at the accumulator's precision, so one chain of 3 DP/8
    // steps over |q.k| in the thousands moved S by ~1e-4: the lse moved
    // with it, and the float32 backward, which recomputes S exactly, saw
    // its p off by that much.
    fence_regs<BK / 2>(s);
    fence_regs<BK / 2>(s2);
    fence_regs<BK / 2>(sx);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint64_t dqh = desc_kmajor(qh, BQ, wg * 64, kk), dql = desc_kmajor(ql, BQ, wg * 64, kk);
      const uint64_t dkh = desc_kmajor(kh, BK, 0, kk), dkl = desc_kmajor(kl, BK, 0, kk);
      if (kk < DP / 16) mma_ss<BK>(s, dqh, dkh, kk > 0);
      else mma_ss<BK>(s2, dqh, dkh, kk > DP / 16);
      mma_ss<BK>(sx, dqh, dkl, kk > 0);
      mma_ss<BK>(sx, dql, dkh, 1);
    }
    sm90::wg_commit();
    fence_regs<BK / 2>(s);
    fence_regs<BK / 2>(s2);
    fence_regs<BK / 2>(sx);
    if (more)  // the next K tile while the products run
      split_rows<BK, DP, NT>(sm.k_hi[st ^ 1], sm.k_lo[st ^ 1], kb, p.k_sl, (it + 1) * BK, L, D,
                             vec);
    sm90::wg_wait_all();
    fence_regs<BK / 2>(s);
    fence_regs<BK / 2>(s2);
    fence_regs<BK / 2>(sx);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = s[i] + s2[i] + sx[i];

    // online softmax on the accumulator: a row lives in the four threads of a quad
    sm90::scale_mask<BK>(s, it * BK, c2, L, sl2);
    float x0 = m0, x1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
      x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    x0 = sm90::quad_max(x0);  // finite: every tile has a column < L
    x1 = sm90::quad_max(x1);
    const float a0 = exp2f(m0 - x0), a1 = exp2f(m1 - x1);  // 0 on the first tile
    m0 = x0;
    m1 = x1;
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - x0);
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - x1);
        e0 += s[4 * j + e];
        e1 += s[4 * j + 2 + e];
      }
    l0 = l0 * a0 + e0;  // this thread's share; the quad's sum at the end
    l1 = l1 * a1 + e1;
    // p as the A fragments of the BK/8 k8 steps, hi and lo: (r, c), (r + 8,
    // c), (r, c + 4), (r + 8, c + 4) <- kv columns 2c, 2c, 2c + 1, 2c + 1
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      split(s[4 * j], ph[j][0], pl[j][0]);
      split(s[4 * j + 2], ph[j][1], pl[j][1]);
      split(s[4 * j + 1], ph[j][2], pl[j][2]);
      split(s[4 * j + 3], ph[j][3], pl[j][3]);
    }
    // T = Phi Vhi + Phi Vlo + Plo Vhi, then O = O alpha + T in registers:
    // the tensor cores' float32 sums run over one tile, not the whole row
    const uint32_t vh = smem_u32(sm.vt_hi[st]), vl = smem_u32(sm.vt_lo[st]);
    fence_regs<DP / 2>(t);
    sm90::wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint64_t dvh = desc_kmajor(vh, DP, 0, j), dvl = desc_kmajor(vl, DP, 0, j);
      mma_rs<DP>(t, ph[j], dvh, j > 0);
      mma_rs<DP>(t, ph[j], dvl, 1);
      mma_rs<DP>(t, pl[j], dvh, 1);
    }
    sm90::wg_commit();
    fence_regs<DP / 2>(t);
    if (more)  // the next V tile while the products run
      split_vt<BK, DP, NT>(sm.vt_hi[st ^ 1], sm.vt_lo[st ^ 1], vb, p.v_sl, (it + 1) * BK, L, D,
                           vec);
    sm90::wg_wait_all();
    fence_regs<DP / 2>(t);
    fence_regs<BK / 2>(&ph[0][0]);
    fence_regs<BK / 2>(&pl[0][0]);
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[4 * i] = fmaf(o[4 * i], a0, t[4 * i]);
      o[4 * i + 1] = fmaf(o[4 * i + 1], a0, t[4 * i + 1]);
      o[4 * i + 2] = fmaf(o[4 * i + 2], a1, t[4 * i + 2]);
      o[4 * i + 3] = fmaf(o[4 * i + 3], a1, t[4 * i + 3]);
    }
    fence_async_shared();
    __syncthreads();  // the next stage is whole; this one may be written again
  }

  l0 = sm90::quad_sum(l0);
  l1 = sm90::quad_sum(l1);
  const int r = q0 + wg * 64 + warp * 16 + lane / 4;
  if (p.lse != nullptr && lane % 4 == 0) {
    float* lse = p.lse + ((int64_t)b * p.H + h) * L;
    if (r < L) lse[r] = (m0 + log2f(l0)) * sm90::LN2;
    if (r + 8 < L) lse[r + 8] = (m1 + log2f(l1)) * sm90::LN2;
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int64_t rs = (int64_t)p.H * D;
  float* ob = static_cast<float*>(p.o) + ((int64_t)b * L * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + c2;
    if (col >= D) continue;
    if (r < L)
      *reinterpret_cast<float2*>(ob + r * rs + col) = make_float2(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (r + 8 < L)
      *reinterpret_cast<float2*>(ob + (r + 8) * rs + col) =
          make_float2(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

// ---------------------------------------------------------------- host

inline bool aligned16(const void* base, int64_t sb, int64_t sl, int64_t sh) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && sb % 4 == 0 && sl % 4 == 0 &&
         sh % 4 == 0;
}

template <int DP, int NWG, int BK>
int launch(const Params& p, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<DP, NWG, BK>) + 1024;  // + what align1024 may skip
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DP, NWG, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.L + 64 * NWG - 1) / (64 * NWG), p.H, p.B);
  fwd_kernel<DP, NWG, BK><<<grid, 128 * NWG, smem, stream>>>(p, vec);
  return (int)cudaGetLastError();
}

// The float32 forward over (q, k, v) of p (D contiguous, any B/L/H strides;
// shapes checked by the caller, bad_shape): o and, if p.lse, the row lse.
inline int fwd(const Params& p, cudaStream_t stream) {
  const int vec = aligned16(p.q, p.q_sb, p.q_sl, p.q_sh) && aligned16(p.k, p.k_sb, p.k_sl, p.k_sh) &&
                  aligned16(p.v, p.v_sb, p.v_sl, p.v_sh);
  return p.D <= 64 ? launch<64, 2, 64>(p, vec, stream) : launch<128, 1, 32>(p, vec, stream);
}

}  // namespace tf32
}  // namespace
