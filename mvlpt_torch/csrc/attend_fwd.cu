// Standalone fused attention forward: o = softmax(q k^T * scale + mask) v.
//
// Replaces the Pallas kernel mvlpt_tpu/ops/attention.py:_fwd_kernel
// (called by _attend_fwd), with its rounding points: s = q k^T on the
// unscaled q, accumulated in fp32; then s * scale + mask in fp32, with
// scale = D^-1/2; fp32 softmax; p rounded to T; o = T(p v), accumulated
// in fp32. (The half-block kernel of attn_fwd.cu scales and rounds q
// before the product instead.)
//
// The TPU program holds G (batch*head) rows of q, k, v and their fp32
// scores in VMEM, with S padded to a multiple of 128 and finfo.min on the
// padded keys. Padded keys take no probability there, so the real rows
// equal an unpadded call's: this kernel does not pad, and masks the
// ragged edge by bounds. One block per (batch*head row, tile of QT
// queries) holds that row's K and V in shared memory as fp32 and walks
// its queries one warp at a time (scores, softmax, p v). Past the shared
// memory of one block (S above 348 at D = 64) it refuses to launch.
//
// Bound: the function reads q, k, v and writes o. At the image eval shape
// (N = B*H = 1200, S = 201, D = 64, bf16) that is 123.5 MB, 36.9 us at
// 3.35 TB/s, against 12.4 GFLOP of products, 12.5 us at 989 TFLOP/s:
// bound by bytes. This first version runs its products as fp32 FMAs on
// the CUDA cores and reads K and V once for each query tile, so it sits
// far above that bound.
#include "common.cuh"

using namespace mvlpt;

namespace {

constexpr int QT = 32;        // query rows per block
constexpr int THREADS = 256;  // 8 warps, one query row per warp at a time

size_t fwd_smem(int S, int D) {
  return sizeof(float) * ((size_t)S * (D + 1) + (size_t)S * D + (size_t)QT * D + (size_t)QT * S);
}

// q, k, v, o: (N, S, D) contiguous; mask: (S, S) fp32 or null.
template <typename T>
__global__ void __launch_bounds__(THREADS)
attend_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ mask, T* __restrict__ o, int S, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.y * QT;
  const size_t base = (size_t)blockIdx.x * S * D;
  float* Ks = smem;              // S x (D+1), padded against bank conflicts
  float* Vs = Ks + S * (D + 1);  // S x D
  float* Qs = Vs + S * D;        // QT x D
  float* Ps = Qs + QT * D;       // QT x S: scores, then probabilities

  for (int idx = threadIdx.x; idx < S * D; idx += THREADS) {
    const int j = idx / D, d = idx - j * D;
    Ks[j * (D + 1) + d] = to_f(k[base + idx]);
    Vs[idx] = to_f(v[base + idx]);
  }
  for (int idx = threadIdx.x; idx < QT * D; idx += THREADS)
    Qs[idx] = q0 + idx / D < S ? to_f(q[base + (size_t)q0 * D + idx]) : 0.f;
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
      s = __fmul_rn(s, scale);  // scale, then add the mask: no fused multiply-add
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
    for (int j = lane; j < S; j += 32) prow[j] = rnd<T>(prow[j] / sum);
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(prow[j], Vs[j * D + d], acc);
      o[base + (size_t)qi * D + d] = from_f<T>(acc);
    }
  }
}

template <typename T>
int attend_fwd_impl(const void* q, const void* k, const void* v, const float* mask, void* o,
                    int N, int S, int D, cudaStream_t st) {
  const size_t smem = fwd_smem(S, D);
  if (smem > kMaxDynSmem) return (int)cudaErrorInvalidConfiguration;
  MVLPT_TRY(cudaFuncSetAttribute(attend_fwd_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  dim3 grid(N, (S + QT - 1) / QT);
  attend_fwd_kernel<T><<<grid, THREADS, smem, st>>>((const T*)q, (const T*)k, (const T*)v, mask,
                                                    (T*)o, S, D, (float)pow((double)D, -0.5));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null (no mask).
extern "C" int mvlpt_attend_fwd(int dtype, const void* q, const void* k, const void* v,
                                const void* mask, void* o, int N, int S, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return attend_fwd_impl<float>(q, k, v, (const float*)mask, o, N, S, D, st);
  if (dtype == 1)
    return attend_fwd_impl<__nv_bfloat16>(q, k, v, (const float*)mask, o, N, S, D, st);
  return (int)cudaErrorInvalidValue;
}
