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
// tile, head, image) that writes ds to a scratch tensor; a dk/dv kernel
// with one block per (key tile, head, image) that reads p and ds by
// column; the dxh GEMM with an fp32 epilogue; the LayerNorm backward rows.
// The two attention kernels pass their operand rows through shared memory
// in fixed-size chunks (k and v by key chunks for dq; q and do by query
// chunks for dk/dv), so shared memory does not grow as S x D; the dq
// kernel keeps each query row's S-long dp/ds row and takes fewer query
// rows a block as S grows (fma_attn.cuh's fma_rows), so it takes any S whose one row
// fits a block (about 24,900 at D = 64).
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
#include "fma_attn.cuh"

using namespace mvlpt;

namespace {

using fma_core::FMA_KC;
using fma_core::FMA_THREADS;
using fma_core::fma_rows;

constexpr int KT = 32;  // key rows per dk/dv block

inline size_t dq_fixed(int D) { return 2 * (size_t)FMA_KC * (D + 1); }
inline size_t dq_row(int S, int D) { return 2 * (size_t)D + S; }
inline size_t dkv_words(int D) {
  return 2 * (size_t)FMA_KC * D + 2 * (size_t)KT * (FMA_KC + 1) + 2 * (size_t)KT * D;
}

// Per query row: dp, ds (rounded; also written to ds_g) and dq.
template <typename T>
__global__ void __launch_bounds__(FMA_THREADS)
attn_bwd_dq(const T* __restrict__ qkv, const T* __restrict__ probs, const T* __restrict__ dout,
            T* __restrict__ ds_g, T* __restrict__ dqkv, int S, int H, int D, float scale,
            int qt) {
  extern __shared__ __align__(16) float smem[];
  const int W = H * D, W3 = 3 * W;
  const int q0 = blockIdx.x * qt, h = blockIdx.y, b = blockIdx.z;
  float* Kc = smem;                  // FMA_KC x (D+1)
  float* Vc = Kc + FMA_KC * (D + 1);  // FMA_KC x (D+1)
  float* dOs = Vc + FMA_KC * (D + 1);  // qt x D
  float* dQ = dOs + qt * D;           // qt x D, the dq accumulators
  float* Ds = dQ + qt * D;            // qt x S: dp, then ds
  const T* base = qkv + (size_t)b * S * W3 + h * D;

  for (int idx = threadIdx.x; idx < qt * D; idx += FMA_THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    dOs[idx] = qi < S ? to_f(dout[((size_t)b * S + qi) * W + h * D + d]) : 0.f;
    dQ[idx] = 0.f;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // dp = do v^T, a key chunk at a time.
  for (int k0 = 0; k0 < S; k0 += FMA_KC) {
    const int nk = min(FMA_KC, S - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += FMA_THREADS) {
      const int j = idx / D, d = idx - j * D;
      Vc[j * (D + 1) + d] = to_f(base[(size_t)(k0 + j) * W3 + 2 * W + d]);
    }
    __syncthreads();
    for (int r = warp; r < qt; r += FMA_THREADS / 32) {
      if (q0 + r >= S) break;
      const float* dorow = dOs + r * D;
      for (int j = lane; j < nk; j += 32) {
        const float* vrow = Vc + j * (D + 1);
        float dp = 0.f;
        for (int d = 0; d < D; ++d) dp = fmaf(dorow[d], vrow[d], dp);
        Ds[r * S + k0 + j] = dp;
      }
    }
  }

  // ds = T(p (dp - rowsum(dp p)) scale) over each whole row.
  for (int r = warp; r < qt; r += FMA_THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= S) break;
    const size_t prow_off = (((size_t)b * H + h) * S + qi) * S;
    const T* pg = probs + prow_off;
    float* drow = Ds + r * S;
    float t = 0.f;
    for (int j = lane; j < S; j += 32) t += drow[j] * to_f(pg[j]);
    t = warp_sum(t);
    for (int j = lane; j < S; j += 32) {
      const float p = to_f(pg[j]);
      const T ds = from_f<T>(p * (drow[j] - t) * scale);
      drow[j] = to_f(ds);
      ds_g[prow_off + j] = ds;
    }
  }

  // dq = ds k, a key chunk at a time.
  for (int k0 = 0; k0 < S; k0 += FMA_KC) {
    const int nk = min(FMA_KC, S - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += FMA_THREADS) {
      const int j = idx / D, d = idx - j * D;
      Kc[j * (D + 1) + d] = to_f(base[(size_t)(k0 + j) * W3 + W + d]);
    }
    __syncthreads();
    for (int r = warp; r < qt; r += FMA_THREADS / 32) {
      if (q0 + r >= S) break;
      const float* drow = Ds + r * S + k0;
      for (int d = lane; d < D; d += 32) {
        float acc = dQ[r * D + d];
        for (int j = 0; j < nk; ++j) acc = fmaf(drow[j], Kc[j * (D + 1) + d], acc);
        dQ[r * D + d] = acc;
      }
    }
  }
  for (int r = warp; r < qt; r += FMA_THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= S) break;
    for (int d = lane; d < D; d += 32)
      dqkv[((size_t)b * S + qi) * W3 + h * D + d] = from_f<T>(dQ[r * D + d]);
  }
}

// Per key row k: dv = T(sum_q p[q,k] do[q]), dk = T(sum_q ds[q,k] q[q]),
// the queries a chunk of FMA_KC at a time.
template <typename T>
__global__ void __launch_bounds__(FMA_THREADS)
attn_bwd_dkv(const T* __restrict__ qkv, const T* __restrict__ probs, const T* __restrict__ ds_g,
             const T* __restrict__ dout, T* __restrict__ dqkv, int S, int H, int D) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QC = FMA_KC, PT = QC + 1;  // query chunk; padded row of Pt and DSt
  const int W = H * D, W3 = 3 * W;
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  float* Qc = smem;             // QC x D, unscaled q
  float* dOc = Qc + QC * D;     // QC x D
  float* Pt = dOc + QC * D;     // KT x PT, p transposed
  float* DSt = Pt + KT * PT;    // KT x PT, ds transposed
  float* dK = DSt + KT * PT;    // KT x D, the dk accumulators
  float* dV = dK + KT * D;      // KT x D, the dv accumulators
  const T* base = qkv + (size_t)b * S * W3 + h * D;
  const size_t head_off = ((size_t)b * H + h) * S * S;
  for (int idx = threadIdx.x; idx < KT * D; idx += FMA_THREADS) dK[idx] = dV[idx] = 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int c0 = 0; c0 < S; c0 += QC) {
    const int nq = min(QC, S - c0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nq * D; idx += FMA_THREADS) {
      const int q = idx / D, d = idx - q * D;
      Qc[idx] = to_f(base[(size_t)(c0 + q) * W3 + d]);
      dOc[idx] = to_f(dout[((size_t)b * S + c0 + q) * W + h * D + d]);
    }
    for (int idx = threadIdx.x; idx < KT * nq; idx += FMA_THREADS) {
      const int q = idx / KT, kk = idx - q * KT;
      const int k = k0 + kk;
      const bool in = k < S;
      const size_t g = head_off + (size_t)(c0 + q) * S + k;
      Pt[kk * PT + q] = in ? to_f(probs[g]) : 0.f;
      DSt[kk * PT + q] = in ? to_f(ds_g[g]) : 0.f;
    }
    __syncthreads();
    for (int kk = warp; kk < KT; kk += FMA_THREADS / 32) {
      if (k0 + kk >= S) break;
      const float* pcol = Pt + kk * PT;
      const float* dscol = DSt + kk * PT;
      for (int d = lane; d < D; d += 32) {
        float dv = dV[kk * D + d], dk = dK[kk * D + d];
        for (int q = 0; q < nq; ++q) {
          dv = fmaf(pcol[q], dOc[q * D + d], dv);
          dk = fmaf(dscol[q], Qc[q * D + d], dk);
        }
        dV[kk * D + d] = dv;
        dK[kk * D + d] = dk;
      }
    }
  }
  for (int kk = warp; kk < KT; kk += FMA_THREADS / 32) {
    const int k = k0 + kk;
    if (k >= S) break;
    T* out = dqkv + ((size_t)b * S + k) * W3 + h * D;
    for (int d = lane; d < D; d += 32) {
      out[W + d] = from_f<T>(dK[kk * D + d]);
      out[2 * W + d] = from_f<T>(dV[kk * D + d]);
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
  const int qt = fma_rows(dq_fixed(D), dq_row(S, D));
  if (qt < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t smem_q = sizeof(float) * (dq_fixed(D) + (size_t)qt * dq_row(S, D));
  const size_t smem_kv = sizeof(float) * dkv_words(D);
  if (smem_kv > kMaxDynSmem) return (int)cudaErrorInvalidConfiguration;
  MVLPT_TRY(cudaFuncSetAttribute(attn_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_q));
  MVLPT_TRY(cudaFuncSetAttribute(attn_bwd_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_kv));
  attn_bwd_dq<T><<<dim3((S + qt - 1) / qt, H, B), FMA_THREADS, smem_q, st>>>(
      (const T*)qkv, (const T*)probs, (const T*)dout, (T*)ds, (T*)dqkv, S, H, D,
      (float)pow((double)D, -0.5), qt);
  MVLPT_TRY(cudaGetLastError());
  attn_bwd_dkv<T><<<dim3((S + KT - 1) / KT, H, B), FMA_THREADS, smem_kv, st>>>(
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
