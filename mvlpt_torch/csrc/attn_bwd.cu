// Attention half-block backward, dx only (the backbone is frozen).
//
// Replaces the Pallas kernel mvlpt_tpu/ops/block.py:_attn_bwd_kernel
// (called by _attn_bwd), with its rounding points:
//   do = T(gy Wout^T); dv = T(p^T do); dp = do v^T in fp32;
//   ds = T(p * (dp - sum_k dp * p) * scale); dq = T(ds k); dk = T(ds^T q);
//   dxh = [dq | dk | dv] Wqkv^T in fp32;
//   dx = T(gy + T(LayerNorm input cotangent of dxh)).
//
// Five launches: the do GEMM; a dq kernel with one block per (query
// tile, head, image) that holds the head's K and V and writes ds to a
// scratch tensor; a dk/dv kernel with one block per (key tile, head,
// image) that holds the head's q and do and reads p and ds by column;
// the dxh GEMM with an fp32 epilogue; the LayerNorm backward rows.
//
// The tensor-parallel entry mvlpt_attn_bwd_part replaces the same body's
// part=True mode (mvlpt_tpu/ops/block.py:_attn_tp_bwd): over this rank's
// H_loc heads (qkv (B, S, 3 Wl), probabilities (B, H_loc, S, S), weights
// Wqkv (W, 3 Wl) and Wout (Wl, W)) it writes the fp32 partial dxh and
// stops: the LayerNorm backward needs the dxh summed over the model
// group, so the caller runs it after the reduction.
//
// Bound at the flagship image shapes (B=32, S=201, W=768, H=12), per
// layer in bf16: about 38.3 GFLOP (39 us at 989 TFLOP/s) against the
// bytes of x, gy, qkv, probs, the weights and dx (about 95 MB, 28 us at
// 3.35 TB/s): bound by operations. At the text tower's packed rows
// (S=126, W=512, H=8; see attn_fwd.cu) about 3.8 GFLOP (3.9 us) against
// 17.5 MB (5.2 us): bound by bytes. Products run on the CUDA cores in
// fp32 here.
#include "common.cuh"

using namespace mvlpt;

namespace {

constexpr int QT = 32;        // query rows per dq block
constexpr int KT = 32;        // key rows per dk/dv block
constexpr int THREADS = 256;  // 8 warps

size_t dq_smem(int S, int D) {
  return sizeof(float) * (2 * (size_t)S * (D + 1) + (size_t)QT * D + (size_t)QT * S);
}

size_t dkv_smem(int S, int D) {
  return sizeof(float) * (2 * (size_t)S * D + 2 * (size_t)KT * S);
}

// Per query row: dp, ds (rounded; also written to ds_g) and dq.
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq(const T* __restrict__ qkv, const T* __restrict__ probs, const T* __restrict__ dout,
            T* __restrict__ ds_g, T* __restrict__ dqkv, int S, int H, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int W = H * D, W3 = 3 * W;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  float* Ks = smem;                // S x (D+1)
  float* Vs = Ks + S * (D + 1);    // S x (D+1)
  float* dOs = Vs + S * (D + 1);   // QT x D
  float* Ds = dOs + QT * D;        // QT x S: dp, then ds
  const T* base = qkv + (size_t)b * S * W3 + h * D;

  for (int idx = threadIdx.x; idx < S * D; idx += THREADS) {
    const int j = idx / D, d = idx - j * D;
    const T* row = base + (size_t)j * W3 + d;
    Ks[j * (D + 1) + d] = to_f(row[W]);
    Vs[j * (D + 1) + d] = to_f(row[2 * W]);
  }
  for (int idx = threadIdx.x; idx < QT * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    dOs[idx] = qi < S ? to_f(dout[((size_t)b * S + qi) * W + h * D + d]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < QT; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= S) break;
    const size_t prow_off = (((size_t)b * H + h) * S + qi) * S;
    const T* pg = probs + prow_off;
    const float* dorow = dOs + r * D;
    float* drow = Ds + r * S;
    float t = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float* vrow = Vs + j * (D + 1);
      float dp = 0.f;
      for (int d = 0; d < D; ++d) dp = fmaf(dorow[d], vrow[d], dp);
      drow[j] = dp;
      t += dp * to_f(pg[j]);
    }
    t = warp_sum(t);
    for (int j = lane; j < S; j += 32) {
      const float p = to_f(pg[j]);
      const T ds = from_f<T>(p * (drow[j] - t) * scale);
      drow[j] = to_f(ds);
      ds_g[prow_off + j] = ds;
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(drow[j], Ks[j * (D + 1) + d], acc);
      dqkv[((size_t)b * S + qi) * W3 + h * D + d] = from_f<T>(acc);
    }
  }
}

// Per key row k: dv = T(sum_q p[q,k] do[q]), dk = T(sum_q ds[q,k] q[q]).
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkv(const T* __restrict__ qkv, const T* __restrict__ probs, const T* __restrict__ ds_g,
             const T* __restrict__ dout, T* __restrict__ dqkv, int S, int H, int D) {
  extern __shared__ __align__(16) float smem[];
  const int W = H * D, W3 = 3 * W;
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  float* Qs = smem;            // S x D, unscaled q
  float* dOs = Qs + S * D;     // S x D
  float* Pt = dOs + S * D;     // KT x S, p transposed
  float* DSt = Pt + KT * S;    // KT x S, ds transposed
  const T* base = qkv + (size_t)b * S * W3 + h * D;

  for (int idx = threadIdx.x; idx < S * D; idx += THREADS) {
    const int q = idx / D, d = idx - q * D;
    Qs[idx] = to_f(base[(size_t)q * W3 + d]);
    dOs[idx] = to_f(dout[((size_t)b * S + q) * W + h * D + d]);
  }
  const size_t head_off = ((size_t)b * H + h) * S * S;
  for (int idx = threadIdx.x; idx < KT * S; idx += THREADS) {
    const int q = idx / KT, kk = idx - q * KT;
    const int k = k0 + kk;
    const bool in = k < S;
    Pt[kk * S + q] = in ? to_f(probs[head_off + (size_t)q * S + k]) : 0.f;
    DSt[kk * S + q] = in ? to_f(ds_g[head_off + (size_t)q * S + k]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kk = warp; kk < KT; kk += THREADS / 32) {
    const int k = k0 + kk;
    if (k >= S) break;
    const float* pcol = Pt + kk * S;
    const float* dscol = DSt + kk * S;
    T* out = dqkv + ((size_t)b * S + k) * W3 + h * D;
    for (int d = lane; d < D; d += 32) {
      float dv = 0.f, dk = 0.f;
      for (int q = 0; q < S; ++q) {
        dv = fmaf(pcol[q], dOs[q * D + d], dv);
        dk = fmaf(dscol[q], Qs[q * D + d], dk);
      }
      out[W + d] = from_f<T>(dk);
      out[2 * W + d] = from_f<T>(dv);
    }
  }
}

// H heads of D each (Wl = H D); gy and dxh are over the model width W.
// part: stop at the fp32 dxh (no LayerNorm backward, x/mu/rstd unused).
template <typename T>
int attn_bwd_impl(const void* x, const float* mu, const float* rstd, const void* qkv,
                  const void* probs, const void* ln_scale, const void* qkv_w, const void* out_w,
                  const void* gy, void* dout, void* ds, void* dqkv, float* dxh, void* dx, int B,
                  int S, int W, int H, int D, bool part, cudaStream_t st) {
  const int M = B * S, Wl = H * D;
  // do[m, i] = sum_n gy[m, n] Wout[i, n]: Wout is (Wl, W), so B^T.
  MVLPT_TRY((launch_gemm<T, true, EPI_ROUND>(gy, out_w, M, Wl, W,
                                             EpiArgs{nullptr, nullptr, nullptr, dout, nullptr},
                                             st)));
  const size_t smem_q = dq_smem(S, D), smem_kv = dkv_smem(S, D);
  if (smem_q > kMaxDynSmem || smem_kv > kMaxDynSmem) return (int)cudaErrorInvalidConfiguration;
  MVLPT_TRY(cudaFuncSetAttribute(attn_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_q));
  MVLPT_TRY(cudaFuncSetAttribute(attn_bwd_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_kv));
  attn_bwd_dq<T><<<dim3((S + QT - 1) / QT, H, B), THREADS, smem_q, st>>>(
      (const T*)qkv, (const T*)probs, (const T*)dout, (T*)ds, (T*)dqkv, S, H, D,
      (float)pow((double)D, -0.5));
  MVLPT_TRY(cudaGetLastError());
  attn_bwd_dkv<T><<<dim3((S + KT - 1) / KT, H, B), THREADS, smem_kv, st>>>(
      (const T*)qkv, (const T*)probs, (const T*)ds, (const T*)dout, (T*)dqkv, S, H, D);
  MVLPT_TRY(cudaGetLastError());
  // dxh[m, n] = sum_k dqkv[m, k] Wqkv[n, k]: Wqkv is (W, 3Wl), so B^T.
  MVLPT_TRY((launch_gemm<T, true, EPI_F32>(dqkv, qkv_w, M, W, 3 * Wl,
                                           EpiArgs{nullptr, nullptr, nullptr, dxh, nullptr},
                                           st)));
  if (!part) MVLPT_TRY(launch_ln_bwd<T>(x, mu, rstd, ln_scale, dxh, gy, dx, M, W, st));
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dout (M, W), ds (B, H, S, S),
// dqkv (M, 3W) and dxh (M, W, fp32) are caller-allocated scratch.
extern "C" int mvlpt_attn_bwd(int dtype, const void* x, const void* mu, const void* rstd,
                              const void* qkv, const void* probs, const void* ln_scale,
                              const void* qkv_w, const void* out_w, const void* gy, void* dout,
                              void* ds, void* dqkv, void* dxh, void* dx, int B, int S, int W,
                              int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int D = W / H;
  if (dtype == 0)
    return attn_bwd_impl<float>(x, (const float*)mu, (const float*)rstd, qkv, probs, ln_scale,
                                qkv_w, out_w, gy, dout, ds, dqkv, (float*)dxh, dx, B, S, W, H, D,
                                false, st);
  if (dtype == 1)
    return attn_bwd_impl<__nv_bfloat16>(x, (const float*)mu, (const float*)rstd, qkv, probs,
                                        ln_scale, qkv_w, out_w, gy, dout, ds, dqkv, (float*)dxh,
                                        dx, B, S, W, H, D, false, st);
  return (int)cudaErrorInvalidValue;
}

// Tensor-parallel part: H local heads of D each; qkv (B, S, 3HD), probs
// (B, H, S, S), qkv_w (W, 3HD), out_w (HD, W), gy (B, S, W) -> the fp32
// partial dxh (B, S, W). dout (B, S, HD), ds (B, H, S, S) and dqkv (B,
// S, 3HD) are caller-allocated scratch.
extern "C" int mvlpt_attn_bwd_part(int dtype, const void* qkv, const void* probs,
                                   const void* qkv_w, const void* out_w, const void* gy,
                                   void* dout, void* ds, void* dqkv, void* dxh, int B, int S,
                                   int W, int H, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return attn_bwd_impl<float>(nullptr, nullptr, nullptr, qkv, probs, nullptr, qkv_w, out_w, gy,
                                dout, ds, dqkv, (float*)dxh, nullptr, B, S, W, H, D, true, st);
  if (dtype == 1)
    return attn_bwd_impl<__nv_bfloat16>(nullptr, nullptr, nullptr, qkv, probs, nullptr, qkv_w,
                                        out_w, gy, dout, ds, dqkv, (float*)dxh, nullptr, B, S, W,
                                        H, D, true, st);
  return (int)cudaErrorInvalidValue;
}
