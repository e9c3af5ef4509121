// Standalone fused attention backward: dq, dk, dv of
// o = softmax(q k^T * scale + mask) v, recomputing the probabilities.
//
// Replaces the Pallas kernel mvlpt_tpu/ops/attention.py:_bwd_kernel
// (called by _attend_bwd), with its rounding points:
//   p = softmax(q k^T * scale + mask), recomputed in fp32 as attend_fwd.cu;
//   dv = T(T(p)^T do); dp = do v^T, kept in fp32;
//   ds = T(p * (dp - rowsum(dp * p)) * scale), from the unrounded p;
//   dq = T(ds k); dk = T(ds^T q), accumulated in fp32.
//
// The TPU program does this for G whole (batch*head) rows in VMEM. Here
// dk and dv reduce over queries and dq over keys, and blocks run in no
// order, so the work is two launches with no atomics (results do not
// change from run to run):
//   1. one block per (row, query tile) holds the row's K and V, recomputes
//      p, takes dp, ds and dq, and writes T(p) and ds to (N, S, S) scratch;
//   2. one block per (row, key tile) holds the row's q and do and reads
//      T(p) and ds by column for dv and dk.
// Past the shared memory of one block (S above 278 at D = 64) it refuses
// to launch.
//
// Bound: the function reads q, k, v, do and writes dq, dk, dv. At the
// image train shape (N = B*H = 384, S = 201, D = 64, bf16) that is
// 69.2 MB, 20.7 us at 3.35 TB/s, against 9.9 GFLOP (the recomputed
// scores and four products), 10.0 us at 989 TFLOP/s: bound by bytes. This
// first version runs its products as fp32 FMAs on the CUDA cores and
// moves the two scratch tensors through device memory.
#include "common.cuh"

using namespace mvlpt;

namespace {

constexpr int QT = 32;        // query rows per dq block
constexpr int KT = 32;        // key rows per dk/dv block
constexpr int THREADS = 256;  // 8 warps

size_t dq_smem(int S, int D) {
  return sizeof(float) * (2 * (size_t)S * (D + 1) + 2 * (size_t)QT * D + 2 * (size_t)QT * S);
}

size_t dkv_smem(int S, int D) {
  return sizeof(float) * (2 * (size_t)S * D + 2 * (size_t)KT * S);
}

// Per query row: p, dp, ds (rounded), dq; T(p) and ds go to scratch.
template <typename T>
__global__ void __launch_bounds__(THREADS)
attend_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ mask, const T* __restrict__ dout, T* __restrict__ p_g,
              T* __restrict__ ds_g, T* __restrict__ dq, int S, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.y * QT;
  const size_t base = (size_t)blockIdx.x * S * D;
  float* Ks = smem;                // S x (D+1)
  float* Vs = Ks + S * (D + 1);    // S x (D+1)
  float* Qs = Vs + S * (D + 1);    // QT x D
  float* dOs = Qs + QT * D;        // QT x D
  float* Ps = dOs + QT * D;        // QT x S: scores, then fp32 probabilities
  float* DPs = Ps + QT * S;        // QT x S: dp, then rounded ds

  for (int idx = threadIdx.x; idx < S * D; idx += THREADS) {
    const int j = idx / D, d = idx - j * D;
    Ks[j * (D + 1) + d] = to_f(k[base + idx]);
    Vs[j * (D + 1) + d] = to_f(v[base + idx]);
  }
  for (int idx = threadIdx.x; idx < QT * D; idx += THREADS) {
    const bool in = q0 + idx / D < S;
    const size_t g = base + (size_t)q0 * D + idx;
    Qs[idx] = in ? to_f(q[g]) : 0.f;
    dOs[idx] = in ? to_f(dout[g]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < QT; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= S) break;
    const float* qrow = Qs + r * D;
    const float* dorow = dOs + r * D;
    float* prow = Ps + r * S;
    float* drow = DPs + r * S;
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float* krow = Ks + j * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
      s = __fmul_rn(s, scale);
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
    float t = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = prow[j] / sum;
      const float* vrow = Vs + j * (D + 1);
      float dp = 0.f;
      for (int d = 0; d < D; ++d) dp = fmaf(dorow[d], vrow[d], dp);
      prow[j] = p;
      drow[j] = dp;
      t += dp * p;
    }
    t = warp_sum(t);
    const size_t prow_off = ((size_t)blockIdx.x * S + qi) * S;
    for (int j = lane; j < S; j += 32) {
      const float p = prow[j];
      const T ds = from_f<T>(__fmul_rn(p * (drow[j] - t), scale));
      drow[j] = to_f(ds);
      ds_g[prow_off + j] = ds;
      p_g[prow_off + j] = from_f<T>(p);
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(drow[j], Ks[j * (D + 1) + d], acc);
      dq[base + (size_t)qi * D + d] = from_f<T>(acc);
    }
  }
}

// Per key row k: dv = T(sum_q T(p)[q,k] do[q]), dk = T(sum_q ds[q,k] q[q]).
template <typename T>
__global__ void __launch_bounds__(THREADS)
attend_bwd_dkv(const T* __restrict__ q, const T* __restrict__ dout, const T* __restrict__ p_g,
               const T* __restrict__ ds_g, T* __restrict__ dk, T* __restrict__ dv, int S,
               int D) {
  extern __shared__ __align__(16) float smem[];
  const int k0 = blockIdx.y * KT;
  const size_t base = (size_t)blockIdx.x * S * D;
  float* Qs = smem;            // S x D
  float* dOs = Qs + S * D;     // S x D
  float* Pt = dOs + S * D;     // KT x S, T(p) transposed
  float* DSt = Pt + KT * S;    // KT x S, ds transposed

  for (int idx = threadIdx.x; idx < S * D; idx += THREADS) {
    Qs[idx] = to_f(q[base + idx]);
    dOs[idx] = to_f(dout[base + idx]);
  }
  const size_t row_off = (size_t)blockIdx.x * S * S;
  for (int idx = threadIdx.x; idx < KT * S; idx += THREADS) {
    const int qi = idx / KT, kk = idx - qi * KT;
    const int kj = k0 + kk;
    const bool in = kj < S;
    Pt[kk * S + qi] = in ? to_f(p_g[row_off + (size_t)qi * S + kj]) : 0.f;
    DSt[kk * S + qi] = in ? to_f(ds_g[row_off + (size_t)qi * S + kj]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kk = warp; kk < KT; kk += THREADS / 32) {
    const int kj = k0 + kk;
    if (kj >= S) break;
    const float* pcol = Pt + kk * S;
    const float* dscol = DSt + kk * S;
    for (int d = lane; d < D; d += 32) {
      float accv = 0.f, acck = 0.f;
      for (int qi = 0; qi < S; ++qi) {
        accv = fmaf(pcol[qi], dOs[qi * D + d], accv);
        acck = fmaf(dscol[qi], Qs[qi * D + d], acck);
      }
      dk[base + (size_t)kj * D + d] = from_f<T>(acck);
      dv[base + (size_t)kj * D + d] = from_f<T>(accv);
    }
  }
}

template <typename T>
int attend_bwd_impl(const void* q, const void* k, const void* v, const float* mask,
                    const void* dout, void* p, void* ds, void* dq, void* dk, void* dv, int N,
                    int S, int D, cudaStream_t st) {
  const size_t smem_q = dq_smem(S, D), smem_kv = dkv_smem(S, D);
  if (smem_q > kMaxDynSmem || smem_kv > kMaxDynSmem) return (int)cudaErrorInvalidConfiguration;
  MVLPT_TRY(cudaFuncSetAttribute(attend_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_q));
  MVLPT_TRY(cudaFuncSetAttribute(attend_bwd_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_kv));
  attend_bwd_dq<T><<<dim3(N, (S + QT - 1) / QT), THREADS, smem_q, st>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (const T*)dout, (T*)p, (T*)ds, (T*)dq, S, D,
      (float)pow((double)D, -0.5));
  MVLPT_TRY(cudaGetLastError());
  attend_bwd_dkv<T><<<dim3(N, (S + KT - 1) / KT), THREADS, smem_kv, st>>>(
      (const T*)q, (const T*)dout, (const T*)p, (const T*)ds, (T*)dk, (T*)dv, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null (no mask); p and ds
// are caller-allocated (N, S, S) scratch in the compute dtype.
extern "C" int mvlpt_attend_bwd(int dtype, const void* q, const void* k, const void* v,
                                const void* mask, const void* dout, void* p, void* ds, void* dq,
                                void* dk, void* dv, int N, int S, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return attend_bwd_impl<float>(q, k, v, (const float*)mask, dout, p, ds, dq, dk, dv, N, S, D,
                                  st);
  if (dtype == 1)
    return attend_bwd_impl<__nv_bfloat16>(q, k, v, (const float*)mask, dout, p, ds, dq, dk, dv,
                                          N, S, D, st);
  return (int)cudaErrorInvalidValue;
}
