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
// codes match the plain version bit for bit, the int32 sums are exact, and
// each float32 operation is rounded on its own (__fmul_rn, __fadd_rn) in the
// plain version's order: dW equals the plain version's bit for bit.
//
// What bounds it: the int8 products, 2*T*O*I operations (1,979 TOPS int8
// peak), against 2-4 bytes per element of g and x read once and dW written
// once (at T = 6304, O = 12288, I = 3072: 0.24 ms of operations against
// 0.07 ms of bytes).  The design, two launches per call:
//   1. colquant_kernel: one block per (512-row t-block, strip of 128 bytes
//      of columns: 64 bfloat16 or 32 float32) of g or of x, one grid over
//      both.  It reads its tile once with 16-byte loads into shared memory,
//      takes the column maxima there and writes the codes transposed
//      (each a product with the column's reciprocal scale, the IEEE division
//      where that product lies next to a rounding boundary),
//      gqT int8 [O, Tp] and xqT int8 [I, Tp] with t contiguous (Tp = T
//      rounded up to 128, zero codes past T), 64 bytes along t per thread,
//      and the scales sg [nT, O], sx [nT, I].  The transpose is what the
//      product needs: wgmma reads 8-bit operands K-major only.
//   2. dw_kernel: persistent, one block per SM walking 128 x 128 tiles of
//      dW (I fastest, so neighbouring blocks share gqT rows in L2).  A
//      producer warp streams [128 rows, 128 codes] boxes of gqT and xqT by
//      TMA (128-byte swizzle) through a six-stage ring with full/empty
//      mbarriers, running ahead into the next tile while the consumers
//      store the last one.  Two consumer warpgroups each own a 64 x 128
//      slice: wgmma m64n128k32 s8 x s8 -> s32 from shared memory, 64 int32
//      and 64 float32 accumulators per thread (setmaxnreg 232; a 64 x 256
//      slice would not fit).  At each 512-row boundary a consumer waits on
//      its wgmmas, folds the int32 sums into the float32 ones with block
//      k's scales (which the producer sends with the block's last chunk,
//      by bulk copy) and restarts the int32 sums (wgmma's scale-d = 0); the
//      ragged last chunk runs only the k32 steps that hold rows below T
//      (T = 32: one).  dW leaves the registers straight to device memory in
//      its dtype.
//
// Plain C interface (ctypes): the entry point returns cudaGetLastError(),
// or sm90::TMAP_ERROR + the driver's CUresult when a tensor map does not
// encode.

#include <math.h>

#include "flash_sm90.cuh"

namespace {

using sm90::bf16;

constexpr int kBlockT = 512;   // rows per quantization block (the JAX default)
constexpr int kChunk = 128;    // t per streamed box: 128 bytes of codes
constexpr int kTile = 128;     // dW tile edge (O and I)
constexpr int kStages = 6;     // ring depth: 6 x 32 KB of shared memory
constexpr int kThreads = 384;  // two consumer warpgroups, then the producer warpgroup

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------- quantization

constexpr int kQuantThreads = 256;
constexpr int kStripBytes = 128;  // one row of a block's tile
constexpr int kGroupT = 64;       // codes one thread writes along t

// amax[e] = max(amax[e], |element e|) over the 16 bytes of v: 4 float32 or
// 8 bfloat16 (a bfloat16 is the high half of its float32)
__device__ __forceinline__ void abs_max(float* amax, const uint4& v, float) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) amax[k] = fmaxf(amax[k], fabsf(__uint_as_float(w[k])));
}
__device__ __forceinline__ void abs_max(float* amax, const uint4& v, bf16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    amax[2 * k] = fmaxf(amax[2 * k], fabsf(__uint_as_float(w[k] << 16)));
    amax[2 * k + 1] = fmaxf(amax[2 * k + 1], fabsf(__uint_as_float(w[k] & 0xffff0000u)));
  }
}

__device__ __forceinline__ int8_t code_of(float a, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(a, s)), -127.0f), 127.0f);
}

// code_of(a, s) from r = 1 / s rounded once per column: a r is within 2^-23
// relative of a / s, less than 2^-16 for |a / s| <= 128, so rint gives the
// same integer unless a r lies within 2^-12 of a half-way point (ok = false
// there; the caller redoes those with code_of)
__device__ __forceinline__ int8_t code_fast(float a, float r, bool& ok) {
  const float y = __fmul_rn(a, r), k = rintf(y);
  ok = fabsf(__fsub_rn(y, k)) < 0.5f - 0x1p-12f;
  return (int8_t)fminf(fmaxf(k, -127.0f), 127.0f);
}

// grid (n_o / C + n_i / C, nT), 256 threads; C = 128 / sizeof(T) columns per
// strip.  Thread (phase, vec) loads rows phase + 32j, columns 8 vec.. (16
// bytes) of the strip; the codes go out by warp, one column per lane.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads) colquant_kernel(
    const T* __restrict__ g, const T* __restrict__ x, int64_t rows, int64_t tp, int n_o, int n_i,
    int8_t* __restrict__ gq, float* __restrict__ sg, int8_t* __restrict__ xq,
    float* __restrict__ sx) {
  constexpr int C = kStripBytes / sizeof(T);  // columns per strip
  constexpr int V = 16 / sizeof(T);           // columns per 16-byte vector
  constexpr int VPR = C / V;                  // vectors per row (8)
  constexpr int RSTEP = kQuantThreads / VPR;  // rows between a thread's loads (32)
  constexpr int NV = kBlockT / RSTEP;         // loads per thread (16)
  constexpr int WARPS = kQuantThreads / 32;
  extern __shared__ __align__(16) unsigned char tile_raw[];  // [512][C] of T
  T* tile = reinterpret_cast<T*>(tile_raw);
  __shared__ float red[WARPS][C];
  __shared__ float scale[C], recip[C];

  const int strips_g = n_o / C;
  const bool is_g = (int)blockIdx.x < strips_g;
  const T* src = is_g ? g : x;
  const int cols = is_g ? n_o : n_i;
  const int col0 = (is_g ? blockIdx.x : blockIdx.x - strips_g) * C;
  const int64_t t0 = (int64_t)blockIdx.y * kBlockT;
  const int real = (int)min((int64_t)kBlockT, rows - t0);  // rows below T
  const int held = (int)min((int64_t)kBlockT, tp - t0);    // rows of the workspace
  const int tid = threadIdx.x, vec = tid % VPR, phase = tid / VPR;
  const int warp = tid / 32, lane = tid % 32;

  // every load first, so that they are all in flight; rows past T are zero
  uint4 v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int r = phase + j * RSTEP;
    v[j] = r < real ? __ldg(reinterpret_cast<const uint4*>(src + (t0 + r) * cols + col0 + vec * V))
                    : make_uint4(0u, 0u, 0u, 0u);
  }
  float amax[V];
#pragma unroll
  for (int e = 0; e < V; ++e) amax[e] = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int r = phase + j * RSTEP;
    if (r < held) *reinterpret_cast<uint4*>(tile + r * C + vec * V) = v[j];
    abs_max(amax, v[j], T());
  }
  // lanes l, l ^ 8, l ^ 16, l ^ 24 hold the same columns
#pragma unroll
  for (int e = 0; e < V; ++e) {
    amax[e] = fmaxf(amax[e], __shfl_xor_sync(0xffffffffu, amax[e], 8));
    amax[e] = fmaxf(amax[e], __shfl_xor_sync(0xffffffffu, amax[e], 16));
  }
  if (lane < VPR)
#pragma unroll
    for (int e = 0; e < V; ++e) red[warp][lane * V + e] = amax[e];
  __syncthreads();
  if (tid < C) {
    float m = red[0][tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w][tid]);
    const float s = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
    scale[tid] = s;
    recip[tid] = __frcp_rn(s);
    (is_g ? sg : sx)[(int64_t)blockIdx.y * cols + col0 + tid] = s;
  }
  __syncthreads();

  // codes: item = (32-column group, 64-row group), one column per lane
  int8_t* dst = is_g ? gq : xq;
  const int items = (C / 32) * (held / kGroupT);
  for (int item = warp; item < items; item += WARPS) {
    const int col = (item % (C / 32)) * 32 + lane, r0 = (item / (C / 32)) * kGroupT;
    const float s = scale[col], r = recip[col];
    uint32_t w[kGroupT / 4];
#pragma unroll
    for (int q = 0; q < kGroupT / 4; ++q) {
      float a[4];
      uint32_t word = 0;
      bool ok = true;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        a[b] = to_f32(tile[(r0 + 4 * q + b) * C + col]);
        bool ok_b;
        word |= (uint32_t)(uint8_t)code_fast(a[b], r, ok_b) << (8 * b);
        ok = ok && ok_b;
      }
      if (!ok) {  // a code next to a rounding boundary: the IEEE division decides
        word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) word |= (uint32_t)(uint8_t)code_of(a[b], s) << (8 * b);
      }
      w[q] = word;
    }
    uint4* out = reinterpret_cast<uint4*>(dst + (int64_t)(col0 + col) * tp + t0 + r0);
#pragma unroll
    for (int q = 0; q < kGroupT / 16; ++q)
      out[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  }
}

// ---------------------------------------------------------------- product

struct DwSmem {
  int8_t a[kStages][kTile * kChunk];  // gqT rows o0.., one chunk of t
  int8_t b[kStages][kTile * kChunk];  // xqT rows i0..
  float sg[kStages][kTile];           // with a block's last chunk: its scales
  float sx[kStages][kTile];
  uint64_t full[kStages], empty[kStages];
};

struct DwMaps {
  CUtensorMap g, x;  // gqT [O, Tp] and xqT [I, Tp], boxes [128 rows, 128 codes]
};

struct DwArgs {
  const float* sg;  // [nT, O]
  const float* sx;  // [nT, I]
  void* dw;         // [O, I]
  int64_t rows;     // T
  int n_o, n_i, n_t, n_chunks, tiles_i, n_tiles;
};

// a [rows, tp] int8 array as a 2-D tensor map read in boxes of [128 rows,
// 128 codes] with the 128-byte swizzle (one K-major wgmma chunk, as a
// [rows, 64] bf16 box of flash_sm90.cuh).  Returns 0 or TMAP_ERROR + CUresult.
int encode_codes(CUtensorMap* map, const void* base, int rows, int64_t tp) {
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return sm90::TMAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)tp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)tp};
  const cuuint32_t box[2] = {kChunk, kTile};
  const cuuint32_t estrides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : sm90::TMAP_ERROR + (int)r;
}

// one box at (t0, row0) of a 2-D map into dst; completion counts on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int t0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(t0), "r"(row0)
      : "memory");
}

// `bytes` (a multiple of 16) from src to dst; completion counts on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// until at most one committed wgmma group of this warpgroup is in flight
__device__ __forceinline__ void wg_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// the int32 accumulators, as sm90::fence_regs does for float32 ones
__device__ __forceinline__ void fence_acc(int* r) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 32] B[32 x 128], int8 from shared memory (both
// K-major), int32 accumulators; the fragment layout is float32's
__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void store2(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* out, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}

// grid min(tiles, SMs) x 384 threads; tiles t = blockIdx.x + n gridDim.x
template <typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    dw_kernel(const __grid_constant__ DwMaps maps, const DwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  DwSmem& sm = *reinterpret_cast<DwSmem*>(sm90::align1024(smem_raw));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: every chunk of every tile of this block, through the ring
    sm90::reg_dealloc<40>();
    if (tid == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        const int o0 = tile / a.tiles_i * kTile, i0 = tile % a.tiles_i * kTile;
        for (int c = 0; c < a.n_chunks; ++c, ++it) {
          constexpr int kPerBlock = kBlockT / kChunk;  // chunks per 512-row block
          const int s = it % kStages, k = c / kPerBlock;
          const bool last = c % kPerBlock == kPerBlock - 1 || c == a.n_chunks - 1;
          sm90::mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
          sm90::mbar_arrive_tx(&sm.full[s], 2 * kTile * kChunk + (last ? 2 * kTile * 4 : 0));
          tma_load_2d(sm.a[s], &maps.g, &sm.full[s], c * kChunk, o0);
          tma_load_2d(sm.b[s], &maps.x, &sm.full[s], c * kChunk, i0);
          if (last) {
            bulk_load(sm.sg[s], a.sg + (int64_t)k * a.n_o + o0, kTile * 4, &sm.full[s]);
            bulk_load(sm.sx[s], a.sx + (int64_t)k * a.n_i + i0, kTile * 4, &sm.full[s]);
          }
        }
      }
    }
    return;
  }

  sm90::reg_alloc<232>();
  const int warp = tid / 32, lane = tid % 32, c2 = 2 * (lane % 4);
  const int row = 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row, row + 8
  int acc[64];
  float sum[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int o0 = tile / a.tiles_i * kTile, i0 = tile % a.tiles_i * kTile;
#pragma unroll
    for (int j = 0; j < 64; ++j) sum[j] = 0.0f;
    for (int k = 0; k < a.n_t; ++k) {
      const int c_begin = k * (kBlockT / kChunk);
      const int c_end = min(c_begin + kBlockT / kChunk, a.n_chunks);
      int prev = -1;  // the stage of the previous chunk, not yet released
      for (int c = c_begin; c < c_end; ++c, ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&sm.full[s], (it / kStages) & 1);
        // k32 steps holding rows below T (4 but in the ragged last chunk)
        const int64_t left = a.rows - (int64_t)c * kChunk;
        const int ksteps = left >= kChunk ? 4 : (int)(left + 31) / 32;
        const uint32_t ta = sm90::smem_u32(sm.a[s]), tb = sm90::smem_u32(sm.b[s]);
        const int first = c == c_begin;  // the block's first k32 step overwrites p
        fence_acc(acc);
        sm90::wg_fence();
        if (ksteps == 4) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_s8_n128(acc, sm90::desc_kmajor(ta, kTile, 64 * wg, kk),
                          sm90::desc_kmajor(tb, kTile, 0, kk), !first || kk > 0);
        } else {
          for (int kk = 0; kk < ksteps; ++kk)
            wgmma_s8_n128(acc, sm90::desc_kmajor(ta, kTile, 64 * wg, kk),
                          sm90::desc_kmajor(tb, kTile, 0, kk), !first || kk > 0);
        }
        sm90::wg_commit();
        if (c + 1 < c_end) {
          wg_wait_1();  // the previous chunk's products are done
          fence_acc(acc);
          if (prev >= 0 && lane == 0) sm90::mbar_arrive(&sm.empty[prev]);
          prev = s;
          continue;
        }
        // the block's last chunk, which brought the block's scales: fold p into sum
        sm90::wg_wait_all();
        fence_acc(acc);
        if (prev >= 0 && lane == 0) sm90::mbar_arrive(&sm.empty[prev]);
        const float g0 = sm.sg[s][row], g1 = sm.sg[s][row + 8];
        float2 xs[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          xs[j] = *reinterpret_cast<const float2*>(&sm.sx[s][8 * j + c2]);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);  // this warp has read the stage
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          sum[4 * j] = __fadd_rn(sum[4 * j], __fmul_rn(__fmul_rn((float)acc[4 * j], g0), xs[j].x));
          sum[4 * j + 1] =
              __fadd_rn(sum[4 * j + 1], __fmul_rn(__fmul_rn((float)acc[4 * j + 1], g0), xs[j].y));
          sum[4 * j + 2] =
              __fadd_rn(sum[4 * j + 2], __fmul_rn(__fmul_rn((float)acc[4 * j + 2], g1), xs[j].x));
          sum[4 * j + 3] =
              __fadd_rn(sum[4 * j + 3], __fmul_rn(__fmul_rn((float)acc[4 * j + 3], g1), xs[j].y));
        }
      }
    }
    TO* out = static_cast<TO*>(a.dw) + (int64_t)(o0 + row) * a.n_i + i0 + c2;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      store2(out + 8 * j, sum[4 * j], sum[4 * j + 1]);
      store2(out + 8 * (int64_t)a.n_i + 8 * j, sum[4 * j + 2], sum[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------- host

template <typename T>
int quantize(const void* g, const void* x, int64_t rows, int64_t tp, int n_o, int n_i, int n_t,
             int8_t* gq, float* sg, int8_t* xq, float* sx, cudaStream_t st) {
  constexpr int C = kStripBytes / sizeof(T);
  constexpr int smem = kBlockT * kStripBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      colquant_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  colquant_kernel<T><<<dim3(n_o / C + n_i / C, n_t), kQuantThreads, smem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), rows, tp, n_o, n_i, gq, sg, xq, sx);
  return (int)cudaGetLastError();
}

template <typename TO>
int product(const DwMaps& maps, const DwArgs& args, cudaStream_t st) {
  const size_t smem = sizeof(DwSmem) + 1024;  // align1024 may skip up to 1 KB
  cudaError_t err =
      cudaFuncSetAttribute(dw_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = args.n_tiles < sms ? args.n_tiles : sms;
  dw_kernel<TO><<<grid, kThreads, smem, st>>>(maps, args);
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype (g and x), out_dtype (dW): 0 = float32, 1 = bfloat16.  g [T, O] and
// x [T, I] contiguous, O and I multiples of 128; dw [O, I].  The workspace,
// with nT = ceil(T / 512) and Tp = T rounded up to 128: gq int8 [O, Tp], xq
// int8 [I, Tp] (the codes K-major: t contiguous, zero past T), sg float32
// [nT, O], sx float32 [nT, I], each 16-byte aligned.
extern "C" int genhancer_int8_dw(int in_dtype, int out_dtype, const void* g, const void* x,
                                 int64_t rows, int n_o, int n_i, void* gq, void* sg, void* xq,
                                 void* sx, void* dw, void* stream) {
  if (rows <= 0 || rows > (int64_t)1 << 30 || n_o <= 0 || n_i <= 0 || n_o % kTile ||
      n_i % kTile || in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int n_t = (int)((rows + kBlockT - 1) / kBlockT);
  const int64_t tp = (rows + kChunk - 1) / kChunk * kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t *gqq = static_cast<int8_t*>(gq), *xqq = static_cast<int8_t*>(xq);
  float *sgg = static_cast<float*>(sg), *sxx = static_cast<float*>(sx);
  int rc = in_dtype == 0 ? quantize<float>(g, x, rows, tp, n_o, n_i, n_t, gqq, sgg, xqq, sxx, st)
                         : quantize<bf16>(g, x, rows, tp, n_o, n_i, n_t, gqq, sgg, xqq, sxx, st);
  if (rc) return rc;
  DwMaps maps;
  rc = encode_codes(&maps.g, gq, n_o, tp);
  if (rc == 0) rc = encode_codes(&maps.x, xq, n_i, tp);
  if (rc) return rc;
  const DwArgs args{sgg, sxx, dw, rows, n_o, n_i, n_t, (int)(tp / kChunk), n_i / kTile,
                    (n_o / kTile) * (n_i / kTile)};
  return out_dtype == 0 ? product<float>(maps, args, st) : product<bf16>(maps, args, st);
}
