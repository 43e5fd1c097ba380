// Fused short-sequence attention (forward and backward) for Hopper, sm_90a.
//
// Replaces the Pallas kernels of genhancer_tpu/core/pallas/short_attention.py:
//   * _fwd_kernel:76        (K1) interleaved-pair RoPE on q and k + exact
//                           unmasked softmax attention — every DiT block;
//   * _fwd_kernel_norope:84 (K2) the same without RoPE — every tower layer.
//
// Semantics kept from the TPU kernel: RoPE rotates each (2i, 2i+1) pair of q
// and k in float32 with cos/sin read from [B, L, D/2] float32 tables and
// rounds the result back to the input type before the products; logits are
// float32 times 1/sqrt(D); probabilities are rounded to the input type before
// the PV product, which accumulates in float32; the output is rounded to the
// input type.  (The kernel rounds the probabilities before normalisation,
// the TPU kernel after: the two differ by about one bf16 ulp of the output.)
//
// What bounds it on this card: at the serving shapes (L = 197..257,
// D = 64..128) one (batch, head) does 4*L*L*D flops over 4*L*D*2 bytes of
// q, k, v and o — a few MFLOP per block and a few hundred flops per byte.
// The work is too small and too short to fill the tensor cores; launch
// latency, blocks in flight, shared-memory traffic and the softmax's scalar
// work bound it.  The design answers that:
//   * one block per (batch, head, q tile), so even B=1 spreads
//     H * ceil(L/BQ) blocks over the 132 SMs;
//   * K and V stream through shared memory in 64-row tiles with an online
//     (running-max) float32 softmax, so there is no length ceiling and the
//     L x L logits never leave the SM;
//   * q, k, v are read through their B, L and H strides with D contiguous,
//     so the views that split a fused qkv projection need no copy;
//   * RoPE is applied while a tile is loaded, from the half-width tables.
// bfloat16 (the serving path) runs QK^T and PV on the tensor cores through
// WMMA (mma.sync, 16x16x16, float32 accumulators); each warp owns 16 q rows
// and keeps its O tile in registers.  float32 runs a scalar FMA kernel (the
// tensor cores would round float32 inputs to TF32).  wgmma and TMA are later
// work.
//
// Plain C interface (ctypes): the entry points return cudaGetLastError().

#include "attention_tiles.cuh"


// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; D is contiguous.
// lse: null, or [B, H, L] float32 that receives each row's log-sum-exp (the
// forward under autograd, for the backward).
extern "C" int genhancer_fused_rope_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* cos, const void* sin,
    void* o, void* lse, int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl,
    int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh, int B, int L, int H, int D,
    float scale, void* stream) {
  const Params p{q, k, v, static_cast<const float*>(cos), static_cast<const float*>(sin), o,
                 static_cast<float*>(lse), q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                 B, L, H, D, scale};
  return dispatch<true>(dtype, p, static_cast<cudaStream_t>(stream));
}

extern "C" int genhancer_fused_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o, void* lse, int64_t q_sb,
    int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
    int64_t v_sl, int64_t v_sh, int B, int L, int H, int D, float scale, void* stream) {
  const Params p{q, k, v, nullptr, nullptr, o, static_cast<float*>(lse), q_sb, q_sl, q_sh,
                 k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, B, L, H, D, scale};
  return dispatch<false>(dtype, p, static_cast<cudaStream_t>(stream));
}

// Backward.  o, dout: the forward's output and its cotangent, [B, L, H, D]
// contiguous; lse: the forward's [B, H, L]; di: [B, H, L] float32 scratch;
// dq, dk, dv: [B, L, H, D] contiguous outputs.  q, k, v as in the forward.
extern "C" int genhancer_fused_rope_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* cos, const void* sin, const void* lse, void* di, void* dq, void* dk, void* dv,
    int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh,
    int64_t v_sb, int64_t v_sl, int64_t v_sh, int B, int L, int H, int D, float scale,
    void* stream) {
  const BwdParams p{q, k, v, dout, static_cast<const float*>(cos),
                    static_cast<const float*>(sin), static_cast<const float*>(lse),
                    static_cast<const float*>(di), dq, dk, dv, q_sb, q_sl, q_sh, k_sb, k_sl,
                    k_sh, v_sb, v_sl, v_sh, B, L, H, D, scale};
  return dispatch_bwd<true>(dtype, o, p, static_cast<cudaStream_t>(stream));
}

extern "C" int genhancer_fused_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* di, void* dq, void* dk, void* dv, int64_t q_sb, int64_t q_sl,
    int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl,
    int64_t v_sh, int B, int L, int H, int D, float scale, void* stream) {
  const BwdParams p{q, k, v, dout, nullptr, nullptr, static_cast<const float*>(lse),
                    static_cast<const float*>(di), dq, dk, dv, q_sb, q_sl, q_sh, k_sb, k_sl,
                    k_sh, v_sb, v_sl, v_sh, B, L, H, D, scale};
  return dispatch_bwd<false>(dtype, o, p, static_cast<cudaStream_t>(stream));
}
