// Attention half-block forward: y = x + OutProj(MHA(LN1 x)) + b_out.
//
// Replaces the Pallas kernel mvlpt_tpu/ops/block.py:_attn_fwd_kernel
// (called by _attn_fwd and attn_block_infer), with its rounding points:
// LN output rounded to T; qkv = T(xh Wqkv + b); q scaled in fp32 then
// rounded; fp32 scores + additive mask; exact fp32 softmax rounded to T;
// o = T(p v); y = T(x + T(o Wout + b_out)).
//
// The TPU program keeps one image's half-block in VMEM, its (H, S, S)
// fp32 scores included. Here that is far beyond a block's 227 KB of
// shared memory, so the work is four launches: LayerNorm rows; the qkv
// product with a bias epilogue; an attention core over (batch*head)
// rows (fma_attn.cuh, which streams K and V by key chunks, so it takes
// any S); the out-projection with a bias + residual epilogue. qkv and o
// go through device memory.
//
// The tensor-parallel entry mvlpt_attn_fwd_part replaces the same body's
// part=True mode (mvlpt_tpu/ops/block.py:_attn_tp_fwd): the weights hold
// this rank's H_loc heads (qkv (W, 3 Wl), out-projection (Wl, W), Wl =
// H_loc D), the LN runs over the full width W, and the out-projection
// writes the fp32 partial product without bias or residual; the caller
// sums the partials over the model group and finishes the block.
//
// Bound at the flagship image shapes (B=32, S=201, W=768, H=12), per
// layer in bf16: about 34.3 GFLOP (35 us at 989 TFLOP/s) against about
// 85 MB moved with the residuals (25 us at 3.35 TB/s): bound by
// operations, nearly all of them in the two products. At the text
// tower's packed rows (15 rows of 7 classes x 18 tokens with the
// synthetic vocab: S=126, W=512, H=8, block-causal mask) the needed work
// is about 3.8 GFLOP (3.9 us) against 15.7 MB (4.7 us): bound by bytes.
// Both dtypes run on the CUDA cores: common.cuh's GEMM and the core sum
// every product in order with fp32 FMAs, so this version sits far above
// both bounds. A tensor-core route (wgmma products, an mma.sync core)
// ran about 12x faster at the eval shape, but its sums put one bf16
// element of y a rounding away from the twin there, past the bf16 bound
// of chip_smoke.py (PERF.md, section 6).
#include "common.cuh"
#include "fma_attn.cuh"

using namespace mvlpt;

namespace {

// H heads of D each (Wl = H D, the qkv width 3 Wl); the LN and the output
// are over the model width W. part: fp32 partial out-projection into y,
// without out_b or the residual. probs, mu and rstd may be null.
template <typename T>
int attn_fwd_impl(const void* x, const void* ln_scale, const void* ln_bias, const void* qkv_w,
                  const void* qkv_b, const void* out_w, const void* out_b, const float* mask,
                  void* xh, void* qkv, void* o, void* probs, float* mu, float* rstd, void* y,
                  int B, int S, int W, int H, int D, float eps, bool part, cudaStream_t st) {
  const int M = B * S, Wl = H * D;
  MVLPT_TRY(launch_ln_fwd<T>(x, ln_scale, ln_bias, xh, mu, rstd, M, W, eps, st));
  MVLPT_TRY((launch_gemm<T, false, EPI_BIAS>(xh, qkv_w, M, 3 * Wl, W,
                                             EpiArgs{qkv_b, nullptr, nullptr, qkv, nullptr}, st)));
  const fma_core::AttnRows rows{qkv, (const T*)qkv + Wl, (const T*)qkv + 2 * Wl, o, H,
                                (long long)S * 3 * Wl, (long long)S * Wl, D, 3 * Wl, D, Wl};
  const int rc = fma_core::launch_fma_attn_fwd<T>(rows, B * H, mask, probs, S, D,
                                                  (float)pow((double)D, -0.5), true, st);
  if (rc != 0) return rc;
  if (part)
    MVLPT_TRY((launch_gemm<T, false, EPI_F32>(o, out_w, M, W, Wl,
                                              EpiArgs{nullptr, nullptr, nullptr, y, nullptr}, st)));
  else
    MVLPT_TRY((launch_gemm<T, false, EPI_BIAS_RESID>(o, out_w, M, W, Wl,
                                                     EpiArgs{out_b, x, nullptr, y, nullptr}, st)));
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. probs, mu and rstd may be null
// (no-residual mode); xh, qkv and o are caller-allocated scratch.
extern "C" int mvlpt_attn_fwd(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                              const void* qkv_w, const void* qkv_b, const void* out_w,
                              const void* out_b, const void* mask, void* xh, void* qkv, void* o,
                              void* probs, void* mu, void* rstd, void* y, int B, int S, int W,
                              int H, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int D = W / H;
  if (dtype == 0)
    return attn_fwd_impl<float>(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                                (const float*)mask, xh, qkv, o, probs, (float*)mu, (float*)rstd,
                                y, B, S, W, H, D, eps, false, st);
  if (dtype == 1)
    return attn_fwd_impl<__nv_bfloat16>(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                               (const float*)mask, xh, qkv, o, probs, (float*)mu, (float*)rstd, y,
                               B, S, W, H, D, eps, false, st);
  return (int)cudaErrorInvalidValue;
}

// Tensor-parallel part: H local heads of D each; qkv_w (W, 3HD), qkv_b
// (3HD), out_w (HD, W); ypart (B, S, W) fp32; qkv (B, S, 3HD), probs
// (B, H, S, S), mu and rstd (B, S) are kept for the backward; xh (B, S,
// W) and o (B, S, HD) are caller-allocated scratch.
extern "C" int mvlpt_attn_fwd_part(int dtype, const void* x, const void* ln_scale,
                                   const void* ln_bias, const void* qkv_w, const void* qkv_b,
                                   const void* out_w, const void* mask, void* xh, void* qkv,
                                   void* o, void* probs, void* mu, void* rstd, void* ypart, int B,
                                   int S, int W, int H, int D, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return attn_fwd_impl<float>(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, nullptr,
                                (const float*)mask, xh, qkv, o, probs, (float*)mu, (float*)rstd,
                                ypart, B, S, W, H, D, eps, true, st);
  if (dtype == 1)
    return attn_fwd_impl<__nv_bfloat16>(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, nullptr,
                               (const float*)mask, xh, qkv, o, probs, (float*)mu, (float*)rstd,
                               ypart, B, S, W, H, D, eps, true, st);
  return (int)cudaErrorInvalidValue;
}

