// Building blocks of the Hopper (sm_90a) attention kernels of
// attention_sm90.cuh (K1, K2, K5 forward; K1b, K5b backward): tensor maps and
// TMA loads, mbarrier rings, warpgroup register hand-over, and wgmma on bf16
// with float32 accumulators.
//
// Tiles live in shared memory as the TMA's 128-byte swizzle leaves them: a
// [rows, DP] bf16 tile (DP = 64 or 128, the head dim padded) is DP/64
// "chunks" of [rows, 64], each row 128 bytes, chunk c at c * rows * 128
// bytes.  Every tile starts on a 1024-byte boundary, so the swizzle the TMA
// applies and the one wgmma's descriptors assume are both functions of the
// address alone.  The same tile serves as
//   * a K-major operand (the reduction runs along D): QK^T, K Q^T, V dO^T,
//     dO V^T — desc_kmajor;
//   * an MN-major B operand (the reduction runs along the rows): P V,
//     P^T dO, dS^T Q, dS K — desc_mnmajor, with wgmma's transpose bit.
//
// Register fragments (per warpgroup of 128 threads, warp w, lane l, c = l%4):
// a float32 accumulator of m64nN holds, for j < N/8, d[4j + e] at
// (row 16w + l/4, col 8j + 2c + e) and d[4j + 2 + e] at (row 16w + l/4 + 8,
// same col), e in {0, 1}.  The bf16 A operand of one k16 step holds the same
// rows at cols 2c + e and 8 + 2c + e, so the accumulator of a product becomes
// the A operand of the next one without leaving the registers (to_a).

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace sm90 {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 384;    // two consumer warpgroups, then one producer warpgroup
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// returned by the entry points when a tensor map does not encode: this code
// plus the driver's CUresult (the wrappers name it)
constexpr int TMAP_ERROR = 10000;

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A [B, L, H, D] bf16 array with element strides (sb, sl, sh, 1) as a 4-D
// tensor map (D, H, L, B innermost first), read in boxes of [rows, 64]: one
// 128-byte-swizzled chunk of `rows` rows of one (b, h).  Rows at or past L
// and columns at or past D read as zero.  Returns 0 or TMAP_ERROR + CUresult.
inline int encode_rows(CUtensorMap* map, const void* base, int B, int L, int H, int D,
                       int64_t sb, int64_t sl, int64_t sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return TMAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERROR + (int)r;
}

// ---------------------------------------------------------------- barriers, TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (the 128-byte swizzle's period)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and expect `bytes` more from the TMA in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one [rows, 64] box at (d0, h, l0, b) into dst; completion counts on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int d0,
                                         int h, int l0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0), "r"(h), "r"(l0), "r"(b)
      : "memory");
}

// rows [l0, l0 + rows) of one (b, h) as DP/64 chunks; the caller has set the
// barrier's expected bytes
template <int DP>
__device__ __forceinline__ void tma_rows(bf16* dst, int rows, const CUtensorMap* map,
                                         uint64_t* bar, int h, int l0, int b) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c) tma_load(dst + c * rows * 64, map, bar, c * 64, h, l0, b);
}

// a named barrier over the 128 threads of consumer warpgroup wg (id 0 is
// __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------- wgmma

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// k16 step kk (columns 16kk..16kk+15) of the rows from row0 of a K-major
// tile of `rows` rows: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows, int row0, int kk) {
  return make_desc(tile + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32, 16, 1024);
}

// k16 step kk (rows 16kk..16kk+15) of a tile read as the MN-major B operand
// [rows, DP]: 64-column chunks rows * 128 bytes apart, 8-row groups 1024
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows, int kk) {
  return make_desc(tile + kk * 16 * 128, rows * 128, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from reading (or reusing) registers that an
// asynchronous wgmma still owns: call after wg_wait_all on every accumulator
// and register operand of the group.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 A operand of k16 step kk from a float32 accumulator of the
// previous product (see the head of this file): a[kk][0..3]
template <int KSTEPS>
__device__ __forceinline__ void to_a(uint32_t (*a)[4], const float* d) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (four bf16x2), B from
// shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (four bf16x2), B from
// shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, accumulate);
  else wgmma_ss_n128(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t b) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// D[64 x N] = A B^T over the first `ksteps` k16 steps of D, A the 64 rows
// from a_row0 of a K-major tile of a_rows rows, B the first N rows of a
// K-major tile of b_rows rows.  Issued, not waited for.
template <int N, int DP>
__device__ __forceinline__ void issue_rows_t(float* d, uint32_t a_tile, int a_rows, int a_row0,
                                             uint32_t b_tile, int b_rows, int ksteps) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    if (kk < ksteps)
      mma_ss<N>(d, desc_kmajor(a_tile, a_rows, a_row0, kk), desc_kmajor(b_tile, b_rows, 0, kk),
                kk > 0);
}

// D[64 x DP] += A B, A the bf16 registers of KSTEPS k16 steps, B the
// MN-major tile of b_rows (= 16 KSTEPS) rows.  Issued, not waited for.
template <int DP, int KSTEPS>
__device__ __forceinline__ void issue_times_tile(float* d, uint32_t (*a)[4], uint32_t b_tile,
                                                 int b_rows) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) mma_rs<DP>(d, a[kk], desc_mnmajor(b_tile, b_rows, kk));
}

// A finished [64, DP] float32 accumulator of consumer warpgroup wg, times
// mult in float32 and rounded to bf16, into rows l0.. (those < L) of one
// (b, h) of a contiguous [B, L, H, D] array (row stride H * D).  With ROPE
// each (2i, 2i+1) pair, which one thread holds, is then un-rotated with
// (cos, -sin) in float32 from the [L, D/2] tables of this batch element and
// rounded again (_bwd_kernel's _apply_rope_full(d.astype(T), cos, -sin)),
// each operation rounded on its own as PyTorch's apply_rope does.  Staged
// through `stage` ([64, DP + 8] bf16) so that each thread stores 16 bytes.
template <int DP, bool ROPE = false>
__device__ __forceinline__ void store_tile(const float* acc, float mult, bf16* stage, bf16* out,
                                           int l0, int L, int64_t row_stride, int D, int wg,
                                           int tid, const float* cos_b = nullptr,
                                           const float* sin_b = nullptr) {
  constexpr int LD = DP + 8;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      float e = acc[4 * j + 2 * half] * mult, o = acc[4 * j + 2 * half + 1] * mult;
      if constexpr (ROPE) {
        const int l = l0 + r, i = 4 * j + c2 / 2;
        if (l < L && 2 * i < D) {
          e = __bfloat162float(__float2bfloat16(e));
          o = __bfloat162float(__float2bfloat16(o));
          const float c = cos_b[(int64_t)l * (D / 2) + i], s = sin_b[(int64_t)l * (D / 2) + i];
          const float re = __fadd_rn(__fmul_rn(c, e), __fmul_rn(s, o));
          o = __fsub_rn(__fmul_rn(c, o), __fmul_rn(s, e));
          e = re;
        }
      }
      *reinterpret_cast<uint32_t*>(stage + r * LD + 8 * j + c2) = pack_bf16(e, o);
    }
  wg_sync(wg);
  const int vpr = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < 64 * vpr; i += 128) {
    const int r = i / vpr, v = i - r * vpr;
    if (l0 + r < L)
      *reinterpret_cast<uint4*>(out + (int64_t)(l0 + r) * row_stride + v * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + v * 8);
  }
  wg_sync(wg);  // the stage may be written again
}

}  // namespace sm90
}  // namespace
