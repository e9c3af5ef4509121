// The CUDA-core attention forward core: o = T(T(softmax(s)) v) over
// (batch, head) rows, fp32 FMAs, any head width D and any S that one
// query row fits in a block's shared memory (about 49,700 at D = 64).
//
// It serves the routes that do not run on the tensor cores: the fp32
// routes of the half-block forward (attn_fwd.cu) and of the standalone
// attention (attend_fwd.cu), and the standalone bf16 forward past its
// tensor-core buckets. Two score conventions, with their rounding points:
//   scale_q (half-block, mvlpt_tpu/ops/block.py:_attn_fwd_kernel):
//     q_s = T(q scale) in fp32; s = q_s k^T + mask;
//   otherwise (standalone, mvlpt_tpu/ops/attention.py:_fwd_kernel):
//     s = fl(q k^T * scale) + mask, no fused multiply-add.
// Then an exact fp32 softmax over the whole row (its max, expf, sum,
// divide), p rounded to T (and stored to probs, where given), o = T(p v)
// accumulated in fp32.
//
// One block per (batch*head row, tile of qt queries). K and V pass
// through shared memory in chunks of FMA_KC keys (pass 1 for the scores,
// pass 2 for p v), so shared memory does not grow as S x D; each query
// row keeps its S-long score row, and qt shrinks as S grows so the block
// still fits (fma_rows). The sums run over the keys in order, as before
// the chunking, so the results do not depend on FMA_KC.
#pragma once

#include "common.cuh"

namespace mvlpt {
namespace fma_core {
// Internal linkage: each kernel library keeps its own kernels (see
// wgmma.cuh).
namespace {

constexpr int FMA_KC = 64;       // keys (or queries) staged a chunk
constexpr int FMA_QT = 32;       // query rows a block, at most
constexpr int FMA_THREADS = 256;  // 8 warps, one query row per warp at a time

// Query rows a block can hold: FMA_QT, or fewer once `row_words` fp32
// words a row beside `fixed_words` exceed one block's shared memory; 0
// when not even one row fits.
inline int fma_rows(size_t fixed_words, size_t row_words) {
  const size_t budget = kMaxDynSmem / sizeof(float);
  if (fixed_words + row_words > budget) return 0;
  const size_t qt = (budget - fixed_words) / row_words;
  return qt < (size_t)FMA_QT ? (int)qt : FMA_QT;
}

// Where the rows of (batch*head) row bh = b * heads + h live: q, k, v
// (and o) hold token t of it at base + b * img + h * head + t * ld.
struct AttnRows {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads;
  long long in_img, out_img;
  int in_head, in_ld, out_head, out_ld;
};

inline size_t fma_fwd_fixed(int D) { return (size_t)FMA_KC * (D + 1) + (size_t)FMA_KC * D; }
inline size_t fma_fwd_row(int S, int D) { return 2 * (size_t)D + S; }

// probs: (N, S, S) in T or null; mask: (S, S) fp32 or null.
template <typename T>
__global__ void __launch_bounds__(FMA_THREADS)
fma_attn_fwd(AttnRows rows, const float* __restrict__ mask, T* __restrict__ probs, int S, int D,
             float scale, bool scale_q, int qt) {
  extern __shared__ __align__(16) float smem[];
  float* Kc = smem;                  // FMA_KC x (D+1), padded against bank conflicts
  float* Vc = Kc + FMA_KC * (D + 1);  // FMA_KC x D
  float* Qs = Vc + FMA_KC * D;        // qt x D
  float* Os = Qs + qt * D;            // qt x D, the p v accumulators
  float* Ps = Os + qt * D;            // qt x S: scores, then probabilities
  const int bh = blockIdx.x, q0 = blockIdx.y * qt;
  const int b = bh / rows.heads, h = bh - b * rows.heads;
  const size_t in_base = (size_t)b * rows.in_img + (size_t)h * rows.in_head;
  const T* qg = (const T*)rows.q + in_base;
  const T* kg = (const T*)rows.k + in_base;
  const T* vg = (const T*)rows.v + in_base;
  const int ld = rows.in_ld;

  for (int idx = threadIdx.x; idx < qt * D; idx += FMA_THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    const float qv = qi < S ? to_f(qg[(size_t)qi * ld + d]) : 0.f;
    Qs[idx] = scale_q ? rnd<T>(qv * scale) : qv;
    Os[idx] = 0.f;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Pass 1: the scores, a key chunk at a time.
  for (int k0 = 0; k0 < S; k0 += FMA_KC) {
    const int nk = min(FMA_KC, S - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += FMA_THREADS) {
      const int j = idx / D, d = idx - j * D;
      Kc[j * (D + 1) + d] = to_f(kg[(size_t)(k0 + j) * ld + d]);
    }
    __syncthreads();
    for (int r = warp; r < qt; r += FMA_THREADS / 32) {
      const int qi = q0 + r;
      if (qi >= S) break;
      const float* qrow = Qs + r * D;
      for (int j = lane; j < nk; j += 32) {
        const float* krow = Kc + j * (D + 1);
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
        if (!scale_q) s = __fmul_rn(s, scale);  // scale, then add the mask: no fused multiply-add
        if (mask != nullptr) s += mask[(size_t)qi * S + k0 + j];
        Ps[r * S + k0 + j] = s;
      }
    }
  }

  // The exact softmax of each whole row, p rounded to T.
  for (int r = warp; r < qt; r += FMA_THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= S) break;
    float* prow = Ps + r * S;
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) mx = fmaxf(mx, prow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    T* pg = probs != nullptr ? probs + ((size_t)bh * S + qi) * S : nullptr;
    for (int j = lane; j < S; j += 32) {
      const T p = from_f<T>(prow[j] / sum);
      prow[j] = to_f(p);
      if (pg != nullptr) pg[j] = p;
    }
  }

  // Pass 2: o += p v, a key chunk at a time.
  for (int k0 = 0; k0 < S; k0 += FMA_KC) {
    const int nk = min(FMA_KC, S - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += FMA_THREADS) {
      const int j = idx / D, d = idx - j * D;
      Vc[idx] = to_f(vg[(size_t)(k0 + j) * ld + d]);
    }
    __syncthreads();
    for (int r = warp; r < qt; r += FMA_THREADS / 32) {
      if (q0 + r >= S) break;
      const float* prow = Ps + r * S + k0;
      for (int d = lane; d < D; d += 32) {
        float acc = Os[r * D + d];
        for (int j = 0; j < nk; ++j) acc = fmaf(prow[j], Vc[j * D + d], acc);
        Os[r * D + d] = acc;
      }
    }
  }

  T* og = (T*)rows.o + (size_t)b * rows.out_img + (size_t)h * rows.out_head;
  for (int r = warp; r < qt; r += FMA_THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= S) break;
    for (int d = lane; d < D; d += 32)
      og[(size_t)qi * rows.out_ld + d] = from_f<T>(Os[r * D + d]);
  }
}

// N (batch*head) rows of S tokens; see fma_attn_fwd. The shared-memory
// attribute is set once for each T, to a block's most, so a launch (in a
// captured CUDA graph too) makes no runtime call but its own.
template <typename T>
int launch_fma_attn_fwd(const AttnRows& rows, int N, const float* mask, void* probs, int S, int D,
                        float scale, bool scale_q, cudaStream_t st) {
  static bool smem_set = false;
  const int qt = fma_rows(fma_fwd_fixed(D), fma_fwd_row(S, D));
  if (qt < 1 || S < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (fma_fwd_fixed(D) + (size_t)qt * fma_fwd_row(S, D));
  if (!smem_set) {
    MVLPT_TRY(cudaFuncSetAttribute(fma_attn_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kMaxDynSmem));
    smem_set = true;
  }
  fma_attn_fwd<T><<<dim3(N, (S + qt - 1) / qt), FMA_THREADS, smem, st>>>(
      rows, mask, (T*)probs, S, D, scale, scale_q, qt);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fma_core
}  // namespace mvlpt
