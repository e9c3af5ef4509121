// MLP half-block backward, dx only (the backbone is frozen).
//
// Replaces the Pallas kernel mvlpt_tpu/ops/block.py:_mlp_bwd_kernel
// (called by _mlp_bwd), with its rounding points:
//   da = gy Wproj^T in fp32; dh = T(da * QuickGELU'(hpre));
//   dxh = dh Wfc^T in fp32; dx = T(gy + T(LayerNorm input cotangent)).
//
// Three launches: the da GEMM whose epilogue applies QuickGELU' from
// the saved hpre and rounds; the dxh GEMM with an fp32 epilogue; the
// LayerNorm backward rows. dh and dxh go through device memory.
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
// 17.8 MB (5.3 us): bound by operations. So the products take two routes
// by dtype (ops/block.MLP_ROUTES), as the forward's do: bf16 on the
// tensor cores through wgmma.cuh's GEMM with B read K-major (both
// products read a weight transposed: Wproj (4W, W) as an (N = 4W,
// K = W) matrix, Wfc (W, 4W) as an (N = W, K = 4W) one; TMA brings their
// slabs in A's layout and no weight is copied), the QuickGELU' epilogue
// in the GEMM's; fp32 through common.cuh's GEMM on the CUDA cores.
#include "common.cuh"
#include "wgmma.cuh"

using namespace mvlpt;

namespace {

// part: stop at the fp32 dxh (no LayerNorm backward, x/mu/rstd unused).
template <typename T>
int mlp_bwd_impl(const void* x, const float* mu, const float* rstd, const void* hpre,
                 const void* ln_scale, const void* fc_w, const void* proj_w, const void* gy,
                 void* dh, float* dxh, void* dx, int M, int W, int W4, bool part,
                 cudaStream_t st) {
  // da[m, j] = sum_n gy[m, n] Wproj[j, n], then dh = T(da QuickGELU'(hpre)).
  MVLPT_TRY((wg::gemm<T, EPI_GELU_BWD, true>(gy, proj_w, M, W4, W,
                                             EpiArgs{nullptr, nullptr, hpre, dh, nullptr}, st)));
  // dxh[m, n] = sum_j dh[m, j] Wfc[n, j].
  MVLPT_TRY((wg::gemm<T, EPI_F32, true>(dh, fc_w, M, W, W4,
                                        EpiArgs{nullptr, nullptr, nullptr, dxh, nullptr}, st)));
  if (!part) MVLPT_TRY(launch_ln_bwd<T>(x, mu, rstd, ln_scale, dxh, gy, dx, M, W, st));
  return 0;
}

// The K-major wgmma GEMM alone, in tiles of BN or (BN = 0) as the
// backward launches it.
template <int EPI>
cudaError_t gemm_kmajor(int bn, const void* A, const void* B, int M, int N, int K, EpiArgs ep,
                        cudaStream_t st) {
  if (bn == 0) return wg::launch_gemm_bf16<EPI, true>(A, B, M, N, K, ep, st);
  if (bn == 128) return wg::launch_gemm_bf16_tiles<EPI, 128, true>(A, B, M, N, K, ep, st);
  if (bn == 256) return wg::launch_gemm_bf16_tiles<EPI, 256, true>(A, B, M, N, K, ep, st);
  return cudaErrorInvalidValue;
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

// The backward's bf16 GEMM on its own, for a check of its K-major layout
// and a timing of its tiles: out = A (M, K) B^T for a row-major bf16 B
// (N, K), with epi 1 (EPI_F32: out fp32 (M, N)) or 5 (EPI_GELU_BWD: aux
// the bf16 hpre (M, N), out bf16 (M, N)); bn = 128 or 256 picks the
// tile width, 0 the backward's own choice.
extern "C" int mvlpt_gemm_kmajor(int epi, int bn, const void* A, const void* B, const void* aux,
                                 void* out, int M, int N, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const EpiArgs ep{nullptr, nullptr, aux, out, nullptr};
  if (epi == EPI_F32) return (int)gemm_kmajor<EPI_F32>(bn, A, B, M, N, K, ep, st);
  if (epi == EPI_GELU_BWD) return (int)gemm_kmajor<EPI_GELU_BWD>(bn, A, B, M, N, K, ep, st);
  return (int)cudaErrorInvalidValue;
}
