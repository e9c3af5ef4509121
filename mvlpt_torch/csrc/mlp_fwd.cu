// MLP half-block forward: y = x + Proj(QuickGELU(FC(LN2 x))) + b_proj.
//
// Replaces the Pallas kernel mvlpt_tpu/ops/block.py:_mlp_fwd_kernel
// (called by _mlp_fwd and mlp_block_infer), with its rounding points:
// LN output rounded to T; hpre = T(xh Wfc + b_fc); QuickGELU evaluated
// on the rounded hpre in fp32, then rounded; y = T(x + T(a Wproj + b)).
//
// Three launches: LayerNorm rows; the FC GEMM whose epilogue adds the
// bias, rounds, stores hpre (when kept for the backward) and applies
// QuickGELU; the projection GEMM with a bias + residual epilogue. The
// activation goes through device memory.
//
// The tensor-parallel entry mvlpt_mlp_fwd_part replaces the same body's
// part=True mode (mvlpt_tpu/ops/block.py:_mlp_tp_fwd): fc and proj hold
// this rank's W4 = 4W/tp hidden units, and the projection writes the
// fp32 partial product without bias or residual, for the caller to sum
// over the model group.
//
// Bound at the flagship image shapes (B=32, S=201, W=768, 4W=3072),
// per layer in bf16: about 60.7 GFLOP (61 us at 989 TFLOP/s) against
// about 69 MB moved with hpre (21 us at 3.35 TB/s): bound by
// operations. At the text tower's packed rows (S=126, W=512; see
// attn_fwd.cu) about 7.6 GFLOP (7.6 us) against 15.8 MB (4.7 us): bound
// by operations. So the products take two routes by dtype
// (ops/block.MLP_ROUTES): bf16 on the tensor cores through wgmma.cuh's
// GEMM (wgmma fed by TMA), fp32 through common.cuh's GEMM on the CUDA
// cores. bf16 with W or 4W off the multiples of 64 (the soak's 32-wide
// text tower) takes common.cuh's GEMM on bf16 operands
// (ops/block.BF16_CUDA_CORES), at the same rounding points.
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

using namespace mvlpt;

namespace {

// part: fp32 partial projection into y, without proj_b or the residual.
// tc: the tensor cores' route (bf16 only); else the CUDA cores'.
template <typename T, bool tc = std::is_same_v<T, __nv_bfloat16>>
int mlp_fwd_impl(const void* x, const void* ln_scale, const void* ln_bias, const void* fc_w,
                 const void* fc_b, const void* proj_w, const void* proj_b, void* xh, void* hpre,
                 void* act, float* mu, float* rstd, void* y, int M, int W, int W4, float eps,
                 bool part, cudaStream_t st) {
  MVLPT_TRY(launch_ln_fwd<T>(x, ln_scale, ln_bias, xh, mu, rstd, M, W, eps, st));
  MVLPT_TRY((wg::gemm<T, EPI_BIAS_GELU, false, tc>(
      xh, fc_w, M, W4, W, EpiArgs{fc_b, nullptr, nullptr, act, hpre}, st)));
  if (part)
    MVLPT_TRY((wg::gemm<T, EPI_F32, false, tc>(
        act, proj_w, M, W, W4, EpiArgs{nullptr, nullptr, nullptr, y, nullptr}, st)));
  else
    MVLPT_TRY((wg::gemm<T, EPI_BIAS_RESID, false, tc>(
        act, proj_w, M, W, W4, EpiArgs{proj_b, x, nullptr, y, nullptr}, st)));
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (tensor cores), 2 = bfloat16 (CUDA
// cores). hpre, mu and rstd may be null
// (no-residual mode); xh (M, W) and act (M, 4W) are scratch.
extern "C" int mvlpt_mlp_fwd(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                             const void* fc_w, const void* fc_b, const void* proj_w,
                             const void* proj_b, void* xh, void* hpre, void* act, void* mu,
                             void* rstd, void* y, int M, int W, int W4, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return mlp_fwd_impl<float>(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, xh, hpre, act,
                               (float*)mu, (float*)rstd, y, M, W, W4, eps, false, st);
  if (dtype == 1)
    return mlp_fwd_impl<__nv_bfloat16>(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, xh,
                                       hpre, act, (float*)mu, (float*)rstd, y, M, W, W4, eps,
                                       false, st);
  if (dtype == 2)
    return mlp_fwd_impl<__nv_bfloat16, false>(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b,
                                              xh, hpre, act, (float*)mu, (float*)rstd, y, M, W,
                                              W4, eps, false, st);
  return (int)cudaErrorInvalidValue;
}

// Tensor-parallel part: fc_w (W, W4), fc_b (W4), proj_w (W4, W) over this
// rank's W4 hidden units; ypart (M, W) fp32; hpre (M, W4), mu and rstd
// (M) are kept for the backward; xh (M, W) and act (M, W4) are scratch.
extern "C" int mvlpt_mlp_fwd_part(int dtype, const void* x, const void* ln_scale,
                                  const void* ln_bias, const void* fc_w, const void* fc_b,
                                  const void* proj_w, void* xh, void* hpre, void* act, void* mu,
                                  void* rstd, void* ypart, int M, int W, int W4, float eps,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return mlp_fwd_impl<float>(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, nullptr, xh, hpre, act,
                               (float*)mu, (float*)rstd, ypart, M, W, W4, eps, true, st);
  if (dtype == 1)
    return mlp_fwd_impl<__nv_bfloat16>(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, nullptr, xh,
                                       hpre, act, (float*)mu, (float*)rstd, ypart, M, W, W4, eps,
                                       true, st);
  if (dtype == 2)
    return mlp_fwd_impl<__nv_bfloat16, false>(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, nullptr,
                                              xh, hpre, act, (float*)mu, (float*)rstd, ypart, M,
                                              W, W4, eps, true, st);
  return (int)cudaErrorInvalidValue;
}
