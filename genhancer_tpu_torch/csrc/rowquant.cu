// Per-row symmetric int8 quantization (K7) for Hopper, sm_90a.
//
// Replaces the Pallas kernels _kernel:37 and _kernel_cs:45 of
// genhancer_tpu/core/pallas/rowquant.py (launched from rowquant:60), which
// core/quant.py quantize_activation_rows:44 reaches.  For each row r of a
// [T, C] matrix x (bfloat16 or float32), optionally times a per-column
// float32 scale cs (the backward's g * ws):
//   xf    = float(x[r, :]) (* cs)                 one rounded multiply
//   s[r]  = max(max|xf|, 1e-12) / 127             IEEE division
//   q[r,:] = clip(rint(xf / s[r]), -127, 127)     as int8, half to even
// The codes and scales are bit-identical to the plain version and to
// jnp.round(x / s) in eager JAX.
//
// What bounds it: HBM bandwidth, one read of x (2 or 4 bytes per element)
// and one int8 write, against a few operations per element; at [6304, 3072]
// bfloat16 that is 58 MB, 0.0174 ms.  The row maximum must be complete
// before any code, so each row is loaded once into registers and stays
// there: a thread holds a few 8-element units (16 bytes of bfloat16, 32 of
// float32: 16-byte loads), takes their maximum on the raw bits (|x| orders
// as an unsigned integer; bfloat16 pairs stay packed), and after the row's
// reduction writes each unit's 8 codes as one 8-byte store.  Unit i of a
// row is on thread i % W of the W threads that share the row, so that each
// load instruction of a warp reads 512 or 1024 contiguous bytes.  Three
// bodies, chosen on the host by core/kernels/rowquant.py rowquant_tiling
// and passed to the entry point:
//   * rowquant_warp_kernel (rows of up to 32 x 4 units: the tower's 1024
//     columns): one warp per row, up to 8 rows per block; the maximum by
//     one warp reduction, no block barrier.
//   * rowquant_block_kernel (wider rows: the DiT's 3072 and up, the
//     tower's 4096): one block per row, 3 or 4 units a thread (in
//     development builds a warp per row holding 12 or 16 units a lane was
//     well below this at 3072 and 4096 columns: short per-thread work lets
//     the rows of neighbouring blocks overlap each other's arithmetic), or,
//     where the rows are too few to fill the card (T below twice the SM
//     count), a cluster of 2-8 blocks per row whose maxima meet in
//     distributed shared memory: each block writes its maximum into every
//     peer's shared memory, then one cluster barrier (the cluster's start
//     is awaited by a relaxed arrive issued before the loads).
//   * rowquant_scalar_kernel (a base not 16-byte aligned, C not a multiple
//     of 8, or a row wider than the block body holds): one block per row,
//     element by element, re-reading x (from L2) for the codes.
// The codes: with r = 1 / s rounded once per row, x / s and x r differ by
// less than 2^-16 for |x / s| <= 127.5, so rint(x r) is rint(x / s) unless
// x r lies within 2^-12 of a half-way point (K8's code_fast,
// csrc/int8_dw.cu).  x r is rounded by adding 1.5 * 2^23, whose low byte is
// then the int8 code (round half to even, the FPU's own rounding; no clamp:
// |x r| < 127.5 for any finite row).  A unit with an element near a
// half-way point, or not finite, is redone after the row's stores with the
// IEEE division, re-read from L1/L2, so the unrolled loop has no division.
// With column scales the products x cs are taken unit by unit, for the
// maximum and again for the codes, from cs read through L1.
//
// Plain C interface (ctypes): the entry point returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments (or a tiling) the bodies do not take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kUnit = 8;             // elements per unit
constexpr int kWarpThreads = 256;    // the warp body's largest block (8 rows)
constexpr int kBlockThreads = 512;   // the block body's largest block
constexpr int kScalarThreads = 256;
constexpr int kMaxCluster = 8;
constexpr float kMagic = 12582912.0f;   // 1.5 * 2^23: y + kMagic rounds y to an integer

// 8 consecutive elements of a row as raw 32-bit words: 4 of bfloat16 pairs
// (element 2k in the low half of word k) or 8 of float32
template <typename T>
struct Unit {
  static constexpr int kWords = 2 * sizeof(T);
  uint32_t w[kWords];
};

template <typename T>
__device__ __forceinline__ void load_unit(Unit<T>& u, const T* row, int i) {
  const uint4* p = reinterpret_cast<const uint4*>(row + kUnit * i);
#pragma unroll
  for (int k = 0; k < Unit<T>::kWords / 4; ++k) {
    const uint4 v = __ldg(p + k);
    u.w[4 * k] = v.x;
    u.w[4 * k + 1] = v.y;
    u.w[4 * k + 2] = v.z;
    u.w[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ float elem(const Unit<bf16>& u, int e) {
  const uint32_t w = u.w[e >> 1];
  return __uint_as_float(e & 1 ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float elem(const Unit<float>& u, int e) {
  return __uint_as_float(u.w[e]);
}

__device__ __forceinline__ void load_cs(float (&c)[kUnit], const float* cs, int i) {
  const float4* p = reinterpret_cast<const float4*>(cs + kUnit * i);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  c[0] = a.x, c[1] = a.y, c[2] = a.z, c[3] = a.w;
  c[4] = b.x, c[5] = b.y, c[6] = b.z, c[7] = b.w;
}

// This thread's units i = first + j * stride (j < NV) of a row, in
// registers; a unit past the row (i >= n) is zero.  Every load is issued
// before any is used.
template <typename T, int NV>
__device__ __forceinline__ void load_units(Unit<T> (&u)[NV], const T* row, int first, int stride,
                                           int n) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int k = 0; k < Unit<T>::kWords; ++k) u[j].w[k] = 0;
    if (first + j * stride < n) load_unit(u[j], row, first + j * stride);
  }
}

// a unit times the column scales of its columns: float32 products
template <typename T>
__device__ __forceinline__ Unit<float> scaled(const Unit<T>& u, const float* cs, int i) {
  float c[kUnit];
  load_cs(c, cs, i);
  Unit<float> p;
#pragma unroll
  for (int e = 0; e < kUnit; ++e) p.w[e] = __float_as_uint(__fmul_rn(elem(u, e), c[e]));
  return p;
}

// max |element| of a unit as the bits of a non-negative float, which order
// as unsigned integers: bfloat16 pairs compared packed
__device__ __forceinline__ uint32_t unit_amax(const Unit<bf16>& u) {
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < Unit<bf16>::kWords; ++k) m = __vmaxu2(m, u.w[k] & 0x7fff7fffu);
  return max(m >> 16, m & 0xffffu) << 16;
}
__device__ __forceinline__ uint32_t unit_amax(const Unit<float>& u) {
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < Unit<float>::kWords; ++k) m = max(m, u.w[k] & 0x7fffffffu);
  return m;
}

// With column scales, each unit's products are taken in a branch of its
// own, here and for the codes: the compiler then keeps one unit's scales in
// registers at a time, where a branch-free loop hoists all of them (at 6
// units, 48 more registers a thread: half the blocks per SM).
template <typename T, bool CS, int NV>
__device__ __forceinline__ uint32_t units_amax(const Unit<T> (&u)[NV], const float* cs, int first,
                                               int stride, int n) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = first + j * stride;
    if constexpr (CS) {
      if (i < n) m = max(m, unit_amax(scaled(u[j], cs, i)));
    } else {
      m = max(m, unit_amax(u[j]));
    }
  }
  return m;
}

// the bits of a r + 1.5 * 2^23: its low byte is rint(a r) as an int8 when
// |a r| < 2^22; ok stays true only where that is rint(a / s) (a r not within
// 2^-12 of a half-way point, and finite)
__device__ __forceinline__ uint32_t code_fast(float a, float r, bool& ok) {
  const float y = __fmul_rn(a, r);
  const float t = __fadd_rn(y, kMagic);
  ok &= fabsf(__fsub_rn(y, __fsub_rn(t, kMagic))) < 0.5f - 0x1p-12f;
  return __float_as_uint(t);
}

__device__ __forceinline__ int8_t code_of(float a, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(a, s)), -127.0f), 127.0f);
}

// bytes 0 of b0..b3, in order
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

template <typename U>
__device__ __forceinline__ uint2 unit_codes(const U& u, float r, bool& ok) {
  uint32_t b[kUnit];
#pragma unroll
  for (int e = 0; e < kUnit; ++e) b[e] = code_fast(elem(u, e), r, ok);
  return make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
}

template <typename U>
__device__ __forceinline__ uint2 unit_codes_ieee(const U& u, float s) {
  uint32_t b[kUnit];
#pragma unroll
  for (int e = 0; e < kUnit; ++e) b[e] = (uint8_t)code_of(elem(u, e), s);
  return make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
}

// unit i's codes again by the IEEE division, its elements re-read
template <typename T, bool CS>
__device__ __noinline__ void recode_unit(const T* row, const float* cs, int8_t* qrow, int i,
                                         float s) {
  Unit<T> u;
  load_unit(u, row, i);
  uint2 codes;
  if constexpr (CS) {
    codes = unit_codes_ieee(scaled(u, cs, i), s);
  } else {
    codes = unit_codes_ieee(u, s);
  }
  reinterpret_cast<uint2*>(qrow)[i] = codes;
}

__device__ __forceinline__ float row_scale(uint32_t amax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax_bits), 1e-12f), 127.0f);
}

// The codes of this thread's units, kept since the loads; the units with
// an element near a half-way point are redone afterwards, in a loop of
// their own, so that the unrolled loop holds no division.
template <typename T, bool CS, int NV>
__device__ __forceinline__ void store_codes(const Unit<T> (&u)[NV], const T* row, const float* cs,
                                            int8_t* qrow, int first, int stride, int n, float s) {
  const float r = __frcp_rn(s);
  uint32_t redo = 0;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = first + j * stride;
    bool ok = true;
    if constexpr (CS) {
      if (i < n) {
        reinterpret_cast<uint2*>(qrow)[i] = unit_codes(scaled(u[j], cs, i), r, ok);
        redo |= (uint32_t)!ok << j;
      }
    } else {   // computed for every unit, stored for those in the row
      const uint2 codes = unit_codes(u[j], r, ok);
      if (i < n) {
        reinterpret_cast<uint2*>(qrow)[i] = codes;
        redo |= (uint32_t)!ok << j;
      }
    }
  }
  while (redo) {
    const int j = __ffs(redo) - 1;
    redo &= redo - 1;
    recode_unit<T, CS>(row, cs, qrow, first + j * stride, s);
  }
}

// the block's maximum of m (bits of non-negative floats); red: one word per warp
__device__ __forceinline__ uint32_t block_max(uint32_t m, uint32_t* red) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = max(m, red[w]);
  return m;
}

// One warp per row, blockDim.x / 32 rows per block; lane l holds units
// l + 32 j.
template <typename T, bool CS, int NV>
__global__ void __launch_bounds__(kWarpThreads) rowquant_warp_kernel(
    const T* __restrict__ x, const float* __restrict__ cs, int8_t* __restrict__ q,
    float* __restrict__ s, int rows, int cols) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;   // a whole warp: this body has no block barrier
  const int lane = threadIdx.x & 31, n = cols / kUnit;
  const T* xr = x + row * cols;
  Unit<T> u[NV];
  load_units(u, xr, lane, 32, n);
  const float sc =
      row_scale(__reduce_max_sync(0xffffffffu, units_amax<T, CS, NV>(u, cs, lane, 32, n)));
  store_codes<T, CS, NV>(u, xr, cs, q + row * cols, lane, 32, n, sc);
  if (lane == 0) s[row] = sc;
}

// One row per cluster of `cluster` blocks (1: a plain launch); thread t of
// block k holds units k blockDim.x + t + j (cluster blockDim.x).
template <typename T, bool CS, int NV>
__global__ void __launch_bounds__(kBlockThreads) rowquant_block_kernel(
    const T* __restrict__ x, const float* __restrict__ cs, int8_t* __restrict__ q,
    float* __restrict__ s, int cols, int cluster) {
  __shared__ uint32_t red[kBlockThreads / 32];
  __shared__ uint32_t peer_max[kMaxCluster];
  // the start of every block of the cluster, awaited before the first
  // remote store: arrived at here, before the loads
  if (cluster > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int row = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const int n = cols / kUnit, first = rank * blockDim.x + threadIdx.x;
  const int stride = cluster * blockDim.x;
  const T* xr = x + (int64_t)row * cols;
  Unit<T> u[NV];
  load_units(u, xr, first, stride, n);
  uint32_t m = block_max(units_amax<T, CS, NV>(u, cs, first, stride, n), red);
  if (cluster > 1) {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if ((int)threadIdx.x < cluster)
      *cg::this_cluster().map_shared_rank(&peer_max[rank], (int)threadIdx.x) = m;
    // release the remote stores, acquire the peers'; after this barrier no
    // block touches another's shared memory, so any may exit
    asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
    for (int k = 0; k < cluster; ++k) m = max(m, peer_max[k]);
  }
  const float sc = row_scale(m);
  store_codes<T, CS, NV>(u, xr, cs, q + (int64_t)row * cols, first, stride, n, sc);
  if (first == 0) s[row] = sc;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// One block per row, any alignment and any C: the maximum, then the codes
// from x re-read.
template <typename T, bool CS>
__global__ void __launch_bounds__(kScalarThreads) rowquant_scalar_kernel(
    const T* __restrict__ x, const float* __restrict__ cs, int8_t* __restrict__ q,
    float* __restrict__ s, int cols) {
  __shared__ uint32_t red[kScalarThreads / 32];
  const int64_t base = (int64_t)blockIdx.x * cols;
  uint32_t m = 0;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float v = CS ? __fmul_rn(to_f32(x[base + c]), cs[c]) : to_f32(x[base + c]);
    m = max(m, __float_as_uint(v) & 0x7fffffffu);
  }
  const float sc = row_scale(block_max(m, red)), r = __frcp_rn(sc);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float v = CS ? __fmul_rn(to_f32(x[base + c]), cs[c]) : to_f32(x[base + c]);
    bool ok = true;
    const int8_t code = (int8_t)code_fast(v, r, ok);
    q[base + c] = ok ? code : code_of(v, sc);
  }
  if (threadIdx.x == 0) s[blockIdx.x] = sc;
}

// the body numbers of core/kernels/rowquant.py BODIES
enum Body { kWarp = 0, kBlock = 1, kScalar = 2 };

struct Args {
  const void* x;
  const float* cs;
  int8_t* q;
  float* s;
  int rows, cols, threads, cluster;
  cudaStream_t stream;
};

template <typename T, bool CS, int NV>
int launch_warp(const Args& a) {
  const int per_block = a.threads / 32;
  const unsigned blocks = (unsigned)(((int64_t)a.rows + per_block - 1) / per_block);
  rowquant_warp_kernel<T, CS, NV><<<blocks, a.threads, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.cs, a.q, a.s, a.rows, a.cols);
  return (int)cudaGetLastError();
}

template <typename T, bool CS, int NV>
int launch_block(const Args& a) {
  const T* x = static_cast<const T*>(a.x);
  if (a.cluster == 1) {
    rowquant_block_kernel<T, CS, NV><<<a.rows, a.threads, 0, a.stream>>>(x, a.cs, a.q, a.s,
                                                                         a.cols, 1);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.rows * a.cluster);
  cfg.blockDim = dim3(a.threads);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int rc = (int)cudaLaunchKernelEx(&cfg, rowquant_block_kernel<T, CS, NV>, x, a.cs, a.q,
                                         a.s, a.cols, a.cluster);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// the instantiated units per thread (rowquant.py WARP_UNITS, BLOCK_UNITS):
// 1-4 in the warp body, 3-16 in the block body, at most 16 16-byte vectors
template <typename T, bool CS>
int launch(Body body, int units, const Args& a) {
  if (body == kScalar) {
    rowquant_scalar_kernel<T, CS><<<a.rows, a.threads, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.cs, a.q, a.s, a.cols);
    return (int)cudaGetLastError();
  }
  if (body == kWarp) {
    switch (units) {
      case 1: return launch_warp<T, CS, 1>(a);
      case 2: return launch_warp<T, CS, 2>(a);
      case 3: return launch_warp<T, CS, 3>(a);
      case 4: return launch_warp<T, CS, 4>(a);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (units) {
    case 3: return launch_block<T, CS, 3>(a);
    case 4: return launch_block<T, CS, 4>(a);
    case 6: return launch_block<T, CS, 6>(a);
    case 8: return launch_block<T, CS, 8>(a);
  }
  if constexpr (sizeof(T) == 2) {   // 12 and 16 units of float32 would be 24 and 32 vectors
    if (units == 12) return launch_block<T, CS, 12>(a);
    if (units == 16) return launch_block<T, CS, 16>(a);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// whether the tiling reaches every unit of every row within the bodies' limits
bool tiling_ok(int body, int units, const Args& a, bool has_cs) {
  if (body == kScalar) return a.threads == kScalarThreads && a.cluster == 1;
  if (body != kWarp && body != kBlock) return false;
  if (a.cols % kUnit || !aligned16(a.x) || (has_cs && !aligned16(a.cs)) || a.threads % 32 ||
      a.threads <= 0)
    return false;
  const int64_t n = a.cols / kUnit;
  if (body == kWarp) return a.threads <= kWarpThreads && a.cluster == 1 && 32 * units >= n;
  return a.threads <= kBlockThreads &&
         (a.cluster == 1 || a.cluster == 2 || a.cluster == 4 || a.cluster == kMaxCluster) &&
         (int64_t)a.cluster * a.threads * units >= n;
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  x [rows, cols] contiguous; cs: device
// float32 [cols] or null; q: int8 [rows, cols], 8-byte aligned; s: float32
// [rows].  (body, threads, cluster, units): rowquant_tiling's choice.
extern "C" int genhancer_rowquant(int x_dtype, const void* x, const void* cs, void* q, void* s,
                                  int64_t rows, int cols, int body, int threads, int cluster,
                                  int units, void* stream) {
  if (rows < 0 || rows > 0x7fffffff || cols <= 0 || x_dtype < 0 || x_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(cs), static_cast<int8_t*>(q), static_cast<float*>(s),
               (int)rows, cols, threads, cluster, static_cast<cudaStream_t>(stream)};
  if (!tiling_ok(body, units, a, cs != nullptr) || (int64_t)rows * cluster > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Body b = static_cast<Body>(body);
  if (x_dtype == 0)
    return cs ? launch<float, true>(b, units, a) : launch<float, false>(b, units, a);
  return cs ? launch<bf16, true>(b, units, a) : launch<bf16, false>(b, units, a);
}
