// Per-row symmetric int8 quantization (K7) for Hopper, sm_90a.
//
// Replaces the Pallas kernels _kernel:37 and _kernel_cs:45 of
// genhancer_tpu/core/pallas/rowquant.py (launched from rowquant:60), which
// core/quant.py quantize_activation_rows:44 reaches.  For each row r of a
// [T, C] matrix x (bfloat16 or float32), optionally times a per-column
// float32 scale cs (the backward's g * ws):
//   xf    = float(x[r, :]) (* cs)
//   s[r]  = max(max|xf|, 1e-12) / 127
//   q[r,:] = clip(rint(xf / s[r]), -127, 127)     as int8
// The division is IEEE (__fdiv_rn, no reciprocal) and rintf rounds half to
// even, so the codes and scales are bit-identical to the plain version and
// to jnp.round(x / s) in eager JAX.
//
// What bounds it: HBM bandwidth — one read of x (2 or 4 bytes per element)
// and one int8 write, against a few flops per element.  The row maximum must
// be complete before any element can be scaled, so a plain implementation
// reads x twice.  The design: one block per row; the first pass keeps the
// row (as float32, after the column scale) in shared memory while it takes
// the maximum, the second pass scales from shared memory, so x is read once.
// Rows too wide for shared memory (more than 48k columns) re-read x from
// global memory in the second pass instead.  No configured model reaches
// that body — the widest row any path quantizes is the DiT's 21504 — it is
// there only so that the kernel accepts any C, and chip_smoke.py's
// [5, 60000] case holds it against the plain version.
//
// Plain C interface (ctypes): the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kMaxStaged = 48 * 1024;   // float32 row elements kept in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__device__ __forceinline__ int8_t quant(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  return (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
}

template <typename T, bool CS, bool STAGED>
__global__ void __launch_bounds__(kThreads) rowquant_kernel(const T* __restrict__ x,
                                                            const float* __restrict__ cs,
                                                            int8_t* __restrict__ q,
                                                            float* __restrict__ s, int cols) {
  extern __shared__ float row_f32[];
  __shared__ float red[32];
  const int64_t base = (int64_t)blockIdx.x * cols;
  float amax = 0.0f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float v = to_f32(x[base + c]);
    if (CS) v = __fmul_rn(v, cs[c]);
    if (STAGED) row_f32[c] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = block_max(amax, red);
  const float sc = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float v;
    if (STAGED) {
      v = row_f32[c];
    } else {
      v = to_f32(x[base + c]);
      if (CS) v = __fmul_rn(v, cs[c]);
    }
    q[base + c] = quant(v, sc);
  }
  if (threadIdx.x == 0) s[blockIdx.x] = sc;
}

template <typename T, bool CS>
int launch(const void* x, const float* cs, int8_t* q, float* s, int64_t rows, int cols,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (cols <= kMaxStaged) {
    const size_t smem = (size_t)cols * sizeof(float);
    auto kern = rowquant_kernel<T, CS, true>;
    // the dynamic row and the static reduction buffer share the block's
    // shared memory: opt in past the 48 KB default for any row size
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<(unsigned)rows, kThreads, smem, stream>>>(xt, cs, q, s, cols);
  } else {
    rowquant_kernel<T, CS, false><<<(unsigned)rows, kThreads, 0, stream>>>(xt, cs, q, s, cols);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  x [rows, cols] contiguous; cs: device
// float32 [cols] or null; q: int8 [rows, cols]; s: float32 [rows].
extern "C" int genhancer_rowquant(int x_dtype, const void* x, const void* cs, void* q, void* s,
                                  int64_t rows, int cols, void* stream) {
  if (rows < 0 || rows > 0x7fffffff || cols <= 0 || x_dtype < 0 || x_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const float* c = static_cast<const float*>(cs);
  int8_t* qq = static_cast<int8_t*>(q);
  float* ss = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return c ? launch<float, true>(x, c, qq, ss, rows, cols, st)
             : launch<float, false>(x, c, qq, ss, rows, cols, st);
  return c ? launch<bf16, true>(x, c, qq, ss, rows, cols, st)
           : launch<bf16, false>(x, c, qq, ss, rows, cols, st);
}
