// Attention half-block forward: y = x + OutProj(MHA(LN1 x)) + b_out.
//
// Replaces the Pallas kernel mvlpt_tpu/ops/block.py:_attn_fwd_kernel
// (called by _attn_fwd and attn_block_infer), with its rounding points:
// LN output rounded to T; qkv = T(xh Wqkv + b); q scaled in fp32 then
// rounded; fp32 scores + additive mask; fp32 softmax rounded to T;
// o = T(p v); y = T(x + T(o Wout + b_out)).
//
// The TPU program keeps one image's half-block in VMEM. Here the score
// tensor alone (12 x 201 x 201 fp32, about 1.9 MB an image at ViT-B/16)
// is far beyond a block's 227 KB of shared memory, so the work is four
// launches: LayerNorm rows; the qkv GEMM with a bias epilogue; an
// attention core with one block per (query tile, head, image) that holds
// the head's K and V in shared memory; the out-projection GEMM with a
// bias + residual epilogue. qkv and o go through device memory.
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
// operations. At the text tower's packed rows (15 rows of 7 classes x
// 18 tokens with the synthetic vocab: S=126, W=512, H=8, block-causal
// mask) the needed work is about 3.8 GFLOP (3.9 us) against 15.7 MB
// (4.7 us): bound by bytes. This version runs its products on the CUDA
// cores in fp32, not on the tensor cores, so it sits far above both.
#include "common.cuh"

using namespace mvlpt;

namespace {

constexpr int QT = 32;        // query rows per block
constexpr int THREADS = 256;  // 8 warps, one query row per warp at a time

size_t core_smem(int S, int D) {
  return sizeof(float) * ((size_t)S * (D + 1) + (size_t)S * D + (size_t)QT * D + (size_t)QT * S);
}

// qkv: (B, S, 3W) with q | k | v column blocks, head h at [h*D, (h+1)*D).
// o: (B, S, W); probs: (B, H, S, S) or null; mask: (S, S) fp32 or null.
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_core_fwd(const T* __restrict__ qkv, const float* __restrict__ mask, T* __restrict__ o,
              T* __restrict__ probs, int S, int H, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int W = H * D, W3 = 3 * W;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  float* Ks = smem;              // S x (D+1), padded against bank conflicts
  float* Vs = Ks + S * (D + 1);  // S x D
  float* Qs = Vs + S * D;        // QT x D, scaled and rounded
  float* Ps = Qs + QT * D;       // QT x S, scores then probabilities
  const T* base = qkv + (size_t)b * S * W3 + h * D;

  for (int idx = threadIdx.x; idx < S * D; idx += THREADS) {
    const int j = idx / D, d = idx - j * D;
    const T* row = base + (size_t)j * W3 + d;
    Ks[j * (D + 1) + d] = to_f(row[W]);
    Vs[j * D + d] = to_f(row[2 * W]);
  }
  for (int idx = threadIdx.x; idx < QT * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    Qs[idx] = qi < S ? rnd<T>(to_f(base[(size_t)qi * W3 + d]) * scale) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < QT; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= S) break;
    const float* qrow = Qs + r * D;
    float* prow = Ps + r * S;
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float* krow = Ks + j * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
      if (mask != nullptr) s += mask[(size_t)qi * S + j];
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    T* pg = probs != nullptr ? probs + (((size_t)b * H + h) * S + qi) * S : nullptr;
    for (int j = lane; j < S; j += 32) {
      const T p = from_f<T>(prow[j] / sum);
      prow[j] = to_f(p);
      if (pg != nullptr) pg[j] = p;
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(prow[j], Vs[j * D + d], acc);
      o[((size_t)b * S + qi) * W + h * D + d] = from_f<T>(acc);
    }
  }
}

// H heads of D each (Wl = H D, the qkv width 3 Wl); the LN and the output
// are over the model width W. part: fp32 partial out-projection into y,
// without out_b or the residual.
template <typename T>
int attn_fwd_impl(const void* x, const void* ln_scale, const void* ln_bias, const void* qkv_w,
                  const void* qkv_b, const void* out_w, const void* out_b, const float* mask,
                  void* xh, void* qkv, void* o, void* probs, float* mu, float* rstd, void* y,
                  int B, int S, int W, int H, int D, float eps, bool part, cudaStream_t st) {
  const int M = B * S, Wl = H * D;
  MVLPT_TRY(launch_ln_fwd<T>(x, ln_scale, ln_bias, xh, mu, rstd, M, W, eps, st));
  MVLPT_TRY((launch_gemm<T, false, EPI_BIAS>(xh, qkv_w, M, 3 * Wl, W,
                                             EpiArgs{qkv_b, nullptr, nullptr, qkv, nullptr}, st)));
  const size_t smem = core_smem(S, D);
  if (smem > kMaxDynSmem) return (int)cudaErrorInvalidConfiguration;
  MVLPT_TRY(cudaFuncSetAttribute(attn_core_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem));
  dim3 grid((S + QT - 1) / QT, H, B);
  attn_core_fwd<T><<<grid, THREADS, smem, st>>>((const T*)qkv, mask, (T*)o, (T*)probs, S, H, D,
                                                (float)pow((double)D, -0.5));
  MVLPT_TRY(cudaGetLastError());
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
                                        (const float*)mask, xh, qkv, o, probs, (float*)mu,
                                        (float*)rstd, y, B, S, W, H, D, eps, false, st);
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
                                        (const float*)mask, xh, qkv, o, probs, (float*)mu,
                                        (float*)rstd, ypart, B, S, W, H, D, eps, true, st);
  return (int)cudaErrorInvalidValue;
}
