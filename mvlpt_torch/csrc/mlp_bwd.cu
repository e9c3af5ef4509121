// MLP half-block backward, dx only (the backbone is frozen).
//
// Replaces the Pallas kernel mvlpt_tpu/ops/block.py:_mlp_bwd_kernel
// (called by _mlp_bwd), with its rounding points:
//   da = gy Wproj^T in fp32; dh = T(da * QuickGELU'(hpre));
//   dxh = dh Wfc^T in fp32; dx = T(gy + T(LayerNorm input cotangent)).
//
// Three launches: the da GEMM whose epilogue applies QuickGELU' from
// the saved hpre and rounds; the dxh GEMM with an fp32 epilogue; the
// LayerNorm backward rows.
//
// The tensor-parallel entry mvlpt_mlp_bwd_part replaces the same body's
// part=True mode (mvlpt_tpu/ops/block.py:_mlp_tp_bwd): over this rank's
// W4 = 4W/tp hidden units it writes the fp32 partial dxh and stops; the
// caller sums it over the model group and runs the LayerNorm backward.
//
// Bound at the flagship image shapes (B=32, S=201, W=768, 4W=3072),
// per layer in bf16: about 60.7 GFLOP (61 us at 989 TFLOP/s) against
// the bytes of x, gy, hpre, the weights and dx (about 79 MB, 23 us at
// 3.35 TB/s): bound by operations. At the text tower's packed rows
// (S=126, W=512; see attn_fwd.cu) about 7.6 GFLOP (7.6 us) against
// 17.8 MB (5.3 us): bound by operations. Products run on the CUDA
// cores in fp32 here.
#include "common.cuh"

using namespace mvlpt;

namespace {

// part: stop at the fp32 dxh (no LayerNorm backward, x/mu/rstd unused).
template <typename T>
int mlp_bwd_impl(const void* x, const float* mu, const float* rstd, const void* hpre,
                 const void* ln_scale, const void* fc_w, const void* proj_w, const void* gy,
                 void* dh, float* dxh, void* dx, int M, int W, int W4, bool part,
                 cudaStream_t st) {
  // da[m, j] = sum_n gy[m, n] Wproj[j, n]: Wproj is (W4, W), so B^T.
  MVLPT_TRY((launch_gemm<T, true, EPI_GELU_BWD>(gy, proj_w, M, W4, W,
                                                EpiArgs{nullptr, nullptr, hpre, dh, nullptr},
                                                st)));
  // dxh[m, n] = sum_j dh[m, j] Wfc[n, j]: Wfc is (W, W4), so B^T.
  MVLPT_TRY((launch_gemm<T, true, EPI_F32>(dh, fc_w, M, W, W4,
                                           EpiArgs{nullptr, nullptr, nullptr, dxh, nullptr},
                                           st)));
  if (!part) MVLPT_TRY(launch_ln_bwd<T>(x, mu, rstd, ln_scale, dxh, gy, dx, M, W, st));
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dh (M, 4W) and dxh (M, W, fp32)
// are caller-allocated scratch.
extern "C" int mvlpt_mlp_bwd(int dtype, const void* x, const void* mu, const void* rstd,
                             const void* hpre, const void* ln_scale, const void* fc_w,
                             const void* proj_w, const void* gy, void* dh, void* dxh, void* dx,
                             int M, int W, int W4, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return mlp_bwd_impl<float>(x, (const float*)mu, (const float*)rstd, hpre, ln_scale, fc_w,
                               proj_w, gy, dh, (float*)dxh, dx, M, W, W4, false, st);
  if (dtype == 1)
    return mlp_bwd_impl<__nv_bfloat16>(x, (const float*)mu, (const float*)rstd, hpre, ln_scale,
                                       fc_w, proj_w, gy, dh, (float*)dxh, dx, M, W, W4, false,
                                       st);
  return (int)cudaErrorInvalidValue;
}

// Tensor-parallel part: hpre (M, W4), fc_w (W, W4), proj_w (W4, W) over
// this rank's W4 hidden units, gy (M, W) -> the fp32 partial dxh (M, W).
// dh (M, W4) is caller-allocated scratch.
extern "C" int mvlpt_mlp_bwd_part(int dtype, const void* hpre, const void* fc_w,
                                  const void* proj_w, const void* gy, void* dh, void* dxh, int M,
                                  int W, int W4, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return mlp_bwd_impl<float>(nullptr, nullptr, nullptr, hpre, nullptr, fc_w, proj_w, gy, dh,
                               (float*)dxh, nullptr, M, W, W4, true, st);
  if (dtype == 1)
    return mlp_bwd_impl<__nv_bfloat16>(nullptr, nullptr, nullptr, hpre, nullptr, fc_w, proj_w,
                                       gy, dh, (float*)dxh, nullptr, M, W, W4, true, st);
  return (int)cudaErrorInvalidValue;
}
