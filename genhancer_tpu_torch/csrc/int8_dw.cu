// Int8 weight gradient with per-(t-block, column) quantization (K8) for
// Hopper, sm_90a.
//
// Replaces the Pallas kernel _dw_kernel:53 of
// genhancer_tpu/core/pallas/int8_dw.py (launched from int8_dw:83), which
// core/quant.py _dw:282 reaches under dit_quant: int8_dw.  For g [T, O] and
// x [T, I] (bfloat16 or float32):
//   for each t-block k of 512 rows [512k, min(512k + 512, T)):
//     sg[k, o] = max(max_t |g[t, o]|, 1e-12) / 127,  gq = clip(rint(g / sg))
//     sx[k, i] = max(max_t |x[t, i]|, 1e-12) / 127,  xq = clip(rint(x / sx))
//     p[o, i]  = sum_t gq[t, o] * xq[t, i]           (int32, exact)
//     dW[o, i] += (float(p) * sg[k, o]) * sx[k, i]    (float32, k in order)
// The 512-row blocks are part of the result (they set the scales); the O/I
// tiling is free.  Divisions are IEEE and rintf rounds half to even, so the
// codes match the plain version bit for bit and dW differs from it only by
// the float32 rounding of the partial sums' products, added in the same
// order.
//
// What bounds it: the int8 products, 2*T*O*I operations (1,979 TOPS int8
// peak) against 2-4 bytes per element of g and x read once and dW written
// once.  The design, two launches per call:
//   1. colquant: one block per (64 columns, t-block) takes the column maxima
//      of the block's rows and writes the int8 codes and the scales to a
//      workspace ([nT*512, C] int8 with zero rows past T, and [nT, C]);
//   2. dw: one block of 4 warps per 64x64 tile of dW; for each t-block, WMMA
//      s8 16x16x16 products with int32 accumulators over 32-row slabs staged
//      in shared memory, then the tile's partial is scaled and added to
//      float32 accumulators held in registers, in t-block order.
// No double buffering and no wgmma yet: a simple, exact kernel first.
//
// Plain C interface (ctypes): the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBlockT = 512;   // rows per quantization block (the JAX default)
constexpr int kTile = 64;      // dW tile edge (O and I)
constexpr int kSlab = 32;      // rows of g and x staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// grid (cols / 64, nT), 256 threads: 64 columns x 4 row phases.
template <typename T>
__global__ void __launch_bounds__(256) colquant_kernel(const T* __restrict__ a, int64_t rows,
                                                       int cols, int8_t* __restrict__ aq,
                                                       float* __restrict__ sa) {
  __shared__ float red[4][64];
  const int col = blockIdx.x * 64 + (threadIdx.x & 63);
  const int phase = threadIdx.x >> 6;
  const int64_t t0 = (int64_t)blockIdx.y * kBlockT;
  const int64_t t1 = min(t0 + kBlockT, rows);
  float amax = 0.0f;
  for (int64_t t = t0 + phase; t < t1; t += 4)
    amax = fmaxf(amax, fabsf(to_f32(a[t * cols + col])));
  red[phase][threadIdx.x & 63] = amax;
  __syncthreads();
  amax = fmaxf(fmaxf(red[0][threadIdx.x & 63], red[1][threadIdx.x & 63]),
               fmaxf(red[2][threadIdx.x & 63], red[3][threadIdx.x & 63]));
  const float sc = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  if (phase == 0) sa[(int64_t)blockIdx.y * cols + col] = sc;
  for (int64_t t = t0 + phase; t < t0 + kBlockT; t += 4) {
    int8_t code = 0;   // rows past T are zero: q(0) = 0 adds nothing
    if (t < t1) {
      const float r = rintf(__fdiv_rn(to_f32(a[t * cols + col]), sc));
      code = (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
    }
    aq[t * cols + col] = code;
  }
}

// Stage a [32 rows, 64 columns] int8 slab as four 16-column groups, each
// 32 rows x 32 bytes (16 codes + 16 bytes of padding), so every WMMA
// fragment starts 256-bit aligned.
__device__ __forceinline__ void stage(const int8_t* __restrict__ src, int64_t ld,
                                      int8_t* __restrict__ dst) {
  const int row = threadIdx.x >> 2, group = threadIdx.x & 3;
  const int4 v = *reinterpret_cast<const int4*>(src + row * ld + group * 16);
  *reinterpret_cast<int4*>(dst + group * (kSlab * 32) + row * 32) = v;
}

// grid (I / 64, O / 64), 128 threads (4 warps, each a 32x32 quarter).
template <typename TO>
__global__ void __launch_bounds__(128) dw_kernel(const int8_t* __restrict__ gq,
                                                 const float* __restrict__ sg,
                                                 const int8_t* __restrict__ xq,
                                                 const float* __restrict__ sx, int n_t,
                                                 int n_o, int n_i, TO* __restrict__ dw) {
  __shared__ __align__(128) int8_t sa[4 * kSlab * 32];
  __shared__ __align__(128) int8_t sb[4 * kSlab * 32];
  __shared__ __align__(128) int sc[kTile * kTile];
  const int o0 = blockIdx.y * kTile, i0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, wo = warp >> 1, wi = warp & 1;
  float acc[kTile * kTile / 128];
#pragma unroll
  for (int j = 0; j < kTile * kTile / 128; ++j) acc[j] = 0.0f;

  for (int k = 0; k < n_t; ++k) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> c[2][2];
#pragma unroll
    for (int fi = 0; fi < 2; ++fi)
#pragma unroll
      for (int fj = 0; fj < 2; ++fj) wmma::fill_fragment(c[fi][fj], 0);
    for (int s = 0; s < kBlockT; s += kSlab) {
      const int64_t t = (int64_t)k * kBlockT + s;
      stage(gq + t * n_o + o0, n_o, sa);
      stage(xq + t * n_i + i0, n_i, sb);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlab; kk += 16) {
        // A[m = o][k = t] sits at group(o) + t * 32 + o % 16: column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[2];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::load_matrix_sync(fa[f], sa + (wo * 2 + f) * (kSlab * 32) + kk * 32, 32);
          wmma::load_matrix_sync(fb[f], sb + (wi * 2 + f) * (kSlab * 32) + kk * 32, 32);
        }
#pragma unroll
        for (int fi = 0; fi < 2; ++fi)
#pragma unroll
          for (int fj = 0; fj < 2; ++fj) wmma::mma_sync(c[fi][fj], fa[fi], fb[fj], c[fi][fj]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int fi = 0; fi < 2; ++fi)
#pragma unroll
      for (int fj = 0; fj < 2; ++fj)
        wmma::store_matrix_sync(sc + (wo * 32 + fi * 16) * kTile + wi * 32 + fj * 16,
                                c[fi][fj], kTile, wmma::mem_row_major);
    __syncthreads();
    const float* sgk = sg + (int64_t)k * n_o + o0;
    const float* sxk = sx + (int64_t)k * n_i + i0;
#pragma unroll
    for (int j = 0; j < kTile * kTile / 128; ++j) {
      const int e = threadIdx.x + 128 * j, o = e >> 6, i = e & 63;
      acc[j] = __fadd_rn(acc[j], __fmul_rn(__fmul_rn((float)sc[e], sgk[o]), sxk[i]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kTile * kTile / 128; ++j) {
    const int e = threadIdx.x + 128 * j, o = e >> 6, i = e & 63;
    dw[(int64_t)(o0 + o) * n_i + i0 + i] = from_f32<TO>(acc[j]);
  }
}

template <typename T>
int quantize(const void* a, int64_t rows, int cols, int n_t, int8_t* aq, float* sa,
             cudaStream_t st) {
  colquant_kernel<T><<<dim3(cols / 64, n_t), 256, 0, st>>>(static_cast<const T*>(a), rows, cols,
                                                          aq, sa);
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype (g and x), out_dtype (dW): 0 = float32, 1 = bfloat16.  g [T, O] and
// x [T, I] contiguous, O and I multiples of 64; dw [O, I].  The workspace
// holds nT = ceil(T / 512) blocks: gq int8 [nT * 512, O], xq int8
// [nT * 512, I], sg float32 [nT, O], sx float32 [nT, I], each 16-byte aligned.
extern "C" int genhancer_int8_dw(int in_dtype, int out_dtype, const void* g, const void* x,
                                 int64_t rows, int n_o, int n_i, void* gq, void* sg, void* xq,
                                 void* sx, void* dw, void* stream) {
  if (rows <= 0 || n_o <= 0 || n_i <= 0 || n_o % kTile || n_i % kTile || in_dtype < 0 ||
      in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int n_t = (int)((rows + kBlockT - 1) / kBlockT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t *gqq = static_cast<int8_t*>(gq), *xqq = static_cast<int8_t*>(xq);
  float *sgg = static_cast<float*>(sg), *sxx = static_cast<float*>(sx);
  int rc = in_dtype == 0 ? quantize<float>(g, rows, n_o, n_t, gqq, sgg, st)
                         : quantize<bf16>(g, rows, n_o, n_t, gqq, sgg, st);
  if (rc) return rc;
  rc = in_dtype == 0 ? quantize<float>(x, rows, n_i, n_t, xqq, sxx, st)
                     : quantize<bf16>(x, rows, n_i, n_t, xqq, sxx, st);
  if (rc) return rc;
  const dim3 grid(n_i / kTile, n_o / kTile);
  if (out_dtype == 0)
    dw_kernel<float><<<grid, 128, 0, st>>>(gqq, sgg, xqq, sxx, n_t, n_o, n_i,
                                           static_cast<float*>(dw));
  else
    dw_kernel<bf16><<<grid, 128, 0, st>>>(gqq, sgg, xqq, sxx, n_t, n_o, n_i,
                                          static_cast<bf16*>(dw));
  return (int)cudaGetLastError();
}
