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
// Rounding p before it is normalised, or at K1b's or K2b's point (p rounded
// before dV), instead moves about half of o or dv by one bf16 ulp;
// chip_smoke.py and tests/test_torch_cuda.py hold o and dv to 2e-4 of the
// mean and check that controls rounding p there miss it.
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
// The kernels live in attention_sm90.cuh, which K1, K2 and K1b
// (short_attention.cu) share; this file holds K5/K5b's entry points.
// float32 runs the split-TF32 wgmma forward of attention_tf32.cuh (three
// TF32 products per product, float32's accuracy; one TF32 product alone
// would keep 10 mantissa bits) and the scalar backward of
// attention_tiles.cuh (fp::): no training path runs the DiT in float32.
//
// Plain C interface (ctypes): the entry points return cudaGetLastError(),
// or sm90::TMAP_ERROR + the driver's CUresult when a tensor map does not
// encode.

#include "attention_sm90.cuh"
#include "attention_tf32.cuh"

namespace {
namespace flash {

int dispatch_fwd(int dtype, const Params& p, cudaStream_t stream) {
  if (bad_shape(p.D, p.L, p.B, p.H)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return tf32::fwd(p, stream);
  if (dtype == 1) return sm90::fwd_padded<2, false>(p, stream);
  return (int)cudaErrorInvalidValue;
}

int dispatch_bwd(int dtype, const void* o, const BwdParams& p, cudaStream_t stream) {
  if (bad_shape(p.D, p.L, p.B, p.H)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return fp::bwd<false>(o, p, stream);
  if (dtype == 1) return sm90::bwd_padded<true, false>(o, p, stream);
  return (int)cudaErrorInvalidValue;
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
  const Params p{q, k, v, o, static_cast<float*>(lse), q_sb, q_sl, q_sh,
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
  return flash::dispatch_bwd(dtype, o, p, static_cast<cudaStream_t>(stream));
}
