// Shared pieces of the fused half-block kernels (ops/block.py):
// dtype conversion with the JAX package's rounding points, warp
// reductions, the LayerNorm forward/backward row kernels and a tiled
// shared-memory GEMM with fp32 accumulation and fused epilogues.
//
// Each of attn_fwd.cu, attn_bwd.cu, mlp_fwd.cu and mlp_bwd.cu includes
// this header and is built into its own shared library with a plain C
// interface; every entry point returns a cudaError_t as int.
//
// The GEMM is a first, simple version: 64x64 output tiles, K in steps
// of 16 through shared memory, 4x4 outputs per thread, fp32 FMAs on the
// CUDA cores, so at the flagship shapes it is bound by operations far
// below the card's bf16 tensor-core rate. mlp_fwd.cu and mlp_bwd.cu take
// it for fp32 only; their bf16 products go to wgmma.cuh's tensor-core
// GEMM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace mvlpt {

// ------------------------------------------------------------ dtypes

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as astype()
}

// Round an fp32 value to T and back: the compute-dtype rounding point.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float sigmoidf_(float z) { return 1.f / (1.f + expf(-z)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// --------------------------------------------------------- LayerNorm
// One warp per row of W features; fp32 statistics (two-pass variance),
// output rounded to T. mu/rstd may be null (no-residual mode).

constexpr int LN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
              const T* __restrict__ bias, T* __restrict__ xh,
              float* __restrict__ mu_out, float* __restrict__ rstd_out,
              int M, int W, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * W;
  float s = 0.f;
  for (int i = lane; i < W; i += 32) s += to_f(xr[i]);
  const float mu = warp_sum(s) / W;
  float v = 0.f;
  for (int i = lane; i < W; i += 32) {
    const float d = to_f(xr[i]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / W + eps);
  T* out = xh + (size_t)row * W;
  for (int i = lane; i < W; i += 32)
    out[i] = from_f<T>((to_f(xr[i]) - mu) * rstd * to_f(scale[i]) + to_f(bias[i]));
  if (lane == 0 && mu_out != nullptr) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// LayerNorm input cotangent with frozen scale/bias, plus the residual:
// dx = gy + round(rstd * (g - mean(g) - xn * mean(g * xn))), g = dxh * scale.
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mu,
              const float* __restrict__ rstd, const T* __restrict__ scale,
              const float* __restrict__ dxh, const T* __restrict__ gy,
              T* __restrict__ dx, int M, int W) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t off = (size_t)row * W;
  const float m = mu[row], r = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < W; i += 32) {
    const float g = dxh[off + i] * to_f(scale[i]);
    const float xn = (to_f(x[off + i]) - m) * r;
    s1 += g;
    s2 += g * xn;
  }
  const float m1 = warp_sum(s1) / W, m2 = warp_sum(s2) / W;
  for (int i = lane; i < W; i += 32) {
    const float g = dxh[off + i] * to_f(scale[i]);
    const float xn = (to_f(x[off + i]) - m) * r;
    const float d = rnd<T>(r * (g - m1 - xn * m2));
    dx[off + i] = from_f<T>(to_f(gy[off + i]) + d);
  }
}

template <typename T>
inline cudaError_t launch_ln_fwd(const void* x, const void* scale, const void* bias,
                                 void* xh, float* mu, float* rstd, int M, int W,
                                 float eps, cudaStream_t st) {
  const int rows = LN_THREADS / 32;
  ln_fwd_kernel<T><<<(M + rows - 1) / rows, LN_THREADS, 0, st>>>(
      (const T*)x, (const T*)scale, (const T*)bias, (T*)xh, mu, rstd, M, W, eps);
  return cudaGetLastError();
}

template <typename T>
inline cudaError_t launch_ln_bwd(const void* x, const float* mu, const float* rstd,
                                 const void* scale, const float* dxh, const void* gy,
                                 void* dx, int M, int W, cudaStream_t st) {
  const int rows = LN_THREADS / 32;
  ln_bwd_kernel<T><<<(M + rows - 1) / rows, LN_THREADS, 0, st>>>(
      (const T*)x, mu, rstd, (const T*)scale, dxh, (const T*)gy, (T*)dx, M, W);
  return cudaGetLastError();
}

// -------------------------------------------------------------- GEMM
// C[M, N] = A[M, K] @ op(B), A row-major in T. op(B) = B for a (K, N)
// row-major B, or B^T for an (N, K) row-major B (B_TRANS). The fp32
// accumulator goes through one of the epilogues below.

enum Epilogue {
  EPI_ROUND = 0,       // out = T(acc)
  EPI_F32 = 1,         // out = acc (fp32 output)
  EPI_BIAS = 2,        // out = T(acc + bias[n])
  EPI_BIAS_RESID = 3,  // out = T(resid + T(acc + bias[n]))
  EPI_BIAS_GELU = 4,   // h = T(acc + bias[n]); out2 = h (if set); out = T(h * sigmoid(1.702 h))
  EPI_GELU_BWD = 5,    // h = aux; s = sigmoid(1.702 h); out = T(acc * (s + 1.702 h s (1 - s)))
};

struct EpiArgs {
  const void* bias;
  const void* resid;
  const void* aux;
  void* out;
  void* out2;
};

constexpr int GEMM_BM = 64, GEMM_BN = 64, GEMM_BK = 16, GEMM_THREADS = 256;

template <typename T, int EPI>
__device__ __forceinline__ void epi_store(const EpiArgs& ep, int m, int n, int N, float acc) {
  const size_t o = (size_t)m * N + n;
  if constexpr (EPI == EPI_F32) {
    ((float*)ep.out)[o] = acc;
  } else if constexpr (EPI == EPI_ROUND) {
    ((T*)ep.out)[o] = from_f<T>(acc);
  } else if constexpr (EPI == EPI_BIAS) {
    ((T*)ep.out)[o] = from_f<T>(acc + to_f(((const T*)ep.bias)[n]));
  } else if constexpr (EPI == EPI_BIAS_RESID) {
    const float r = rnd<T>(acc + to_f(((const T*)ep.bias)[n]));
    ((T*)ep.out)[o] = from_f<T>(to_f(((const T*)ep.resid)[o]) + r);
  } else if constexpr (EPI == EPI_BIAS_GELU) {
    const float h = rnd<T>(acc + to_f(((const T*)ep.bias)[n]));
    if (ep.out2 != nullptr) ((T*)ep.out2)[o] = from_f<T>(h);
    ((T*)ep.out)[o] = from_f<T>(h * sigmoidf_(1.702f * h));
  } else {  // EPI_GELU_BWD
    const float h = to_f(((const T*)ep.aux)[o]);
    const float s = sigmoidf_(1.702f * h);
    ((T*)ep.out)[o] = from_f<T>(acc * (s + 1.702f * h * s * (1.f - s)));
  }
}

template <typename T, bool B_TRANS, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, int M, int N, int K,
            EpiArgs ep) {
  __shared__ __align__(16) float As[GEMM_BK][GEMM_BM + 4];
  __shared__ __align__(16) float Bs[GEMM_BK][GEMM_BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * GEMM_THREADS;  // 0 .. 1023
      const int r = idx / GEMM_BK, c = idx % GEMM_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f(A[(size_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      if constexpr (!B_TRANS) {
        const int r = idx / GEMM_BN, c = idx % GEMM_BN;
        const int gk = k0 + r, gn = n0 + c;
        Bs[r][c] = (gk < K && gn < N) ? to_f(B[(size_t)gk * N + gn]) : 0.f;
      } else {
        const int r = idx / GEMM_BK, c = idx % GEMM_BK;
        const int gn = n0 + r, gk = k0 + c;
        Bs[c][r] = (gn < N && gk < K) ? to_f(B[(size_t)gn * K + gk]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) epi_store<T, EPI>(ep, m, n, N, acc[i][j]);
    }
  }
}

template <typename T, bool B_TRANS, int EPI>
inline cudaError_t launch_gemm(const void* A, const void* B, int M, int N, int K,
                               EpiArgs ep, cudaStream_t st) {
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_kernel<T, B_TRANS, EPI><<<grid, GEMM_THREADS, 0, st>>>((const T*)A, (const T*)B, M,
                                                             N, K, ep);
  return cudaGetLastError();
}

// Largest dynamic shared memory one block may use on Hopper.
constexpr size_t kMaxDynSmem = 232448;

}  // namespace mvlpt

#define MVLPT_TRY(expr)                 \
  do {                                  \
    cudaError_t err_ = (expr);          \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

extern "C" const char* mvlpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
