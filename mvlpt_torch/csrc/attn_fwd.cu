// Attention half-block forward: y = x + OutProj(MHA(LN1 x)) + b_out.
//
// Replaces the Pallas kernel mvlpt_tpu/ops/block.py:_attn_fwd_kernel
// (called by _attn_fwd and attn_block_infer), with its rounding points:
// LN output rounded to T; qkv = T(xh Wqkv + b); q scaled in fp32 then
// rounded; fp32 scores + additive mask; exact fp32 softmax rounded to T;
// o = T(p v); y = T(x + T(o Wout + b_out)).
//
// The TPU program keeps one image's half-block in VMEM, its (H, S, S)
// fp32 scores included. Here that is far beyond a block's 227 KB of
// shared memory, so the work is four launches: LayerNorm rows; the qkv
// product with a bias epilogue; an attention core over (batch*head)
// rows; the out-projection with a bias + residual epilogue. qkv and o
// go through device memory.
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
// operations, nearly all of them in the two products. At the text
// tower's packed rows (15 rows of 7 classes x 18 tokens with the
// synthetic vocab: S=126, W=512, H=8, block-causal mask) the needed work
// is about 3.8 GFLOP (3.9 us) against 15.7 MB (4.7 us): bound by bytes.
// So the launches take two routes by dtype (ops/block.ATTN_FWD_ROUTES):
//   bf16, tensor cores: both products on wgmma.cuh's GEMM (wgmma fed by
//     TMA, the weights read MN-major where they lie; the qkv product
//     through the EPI_BIAS epilogue), the core on mma.sync (attn_core_tc
//     below). D = 64 only.
//   fp32, CUDA cores: common.cuh's GEMM and fma_attn.cuh's core, every
//     product summed in order with fp32 FMAs (TF32 would not hold fp32's
//     tolerance).
#include <type_traits>

#include "common.cuh"
#include "fma_attn.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

using namespace mvlpt;

namespace {

// ------------------------------------------ bf16 attention core, mma.sync
//
// o = T(T(softmax(s)) v) over (batch*head) rows, read in place from qkv
// (B, S, 3 Wl): row b, head h holds q at column h D, k at Wl + h D, v at
// 2 Wl + h D, every token a row of stride 3 Wl; o (B, S, Wl) takes head h
// at column h D. probs (B, H, S, S) is written where asked (PROBS).
//
// The scores follow the standalone core's convention (mma.cuh,
// softmax_rows): s = fl(q k^T * 0.125) + mask, the product in fp32 on the
// tensor cores, scaled by __fmul_rn, then the mask added. At D = 64 the
// scale is a power of two, so T(q * 0.125) is exact and T(q * 0.125) k^T
// equals (q k^T) * 0.125 bit for bit (barring subnormals): the
// half-block's scores, which the plain twin forms from the rounded q.
//
// A block of WARPS warps takes one (batch*head) row and a share of its
// 16-query groups (mma::row_shares), a warp a group at a time, q in A
// fragments. K and V pass through shared memory (rows skewed as mma.cuh
// lays them out) in windows of up to KW_MAX keys: a row of S <= KW_MAX is
// staged once for every group of the block; past it the block walks the
// windows in step, a barrier on each side of a window's staging. No score
// row is held anywhere: each warp works on 16 x KC chunks of scores.
//   Pass 1 (K only) gives each row's max and its sum of exp(s - max):
//     each lane keeps a running max and a sum rescaled to it over its
//     own columns, and the four lanes of a row combine theirs at the end.
//   Pass 2 (K and V) recomputes the scores, forms p = T(exp(s - max) /
//     sum) with the IEEE-rounded divide (mma::div_rn), packs p from the
//     accumulators straight into A fragments for p v (mma::pack_a), and,
//     with PROBS, writes p through a warp's staging tile in shared
//     memory, so that each store of a warp covers 32 neighbouring keys of
//     one row (a probs row of odd S is only 2-byte aligned, so no wider
//     store would do).
// Keys at or past S get -inf; query rows past S are computed on zero q and
// never stored. Shared memory does not grow with S: no S ceiling.
namespace core {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int KC = 32;          // keys a chunk: four score tiles, two k steps of p v
constexpr int KW_MAX = 256;     // keys a window of K and V in shared memory
constexpr int PROW = KC + 8;    // a warp's probs staging row, in bf16 (80 bytes: no bank conflict)
constexpr float SCALE = 0.125f;  // 64^-1/2

// Keys a window: S rounded up to a chunk, at most KW_MAX.
inline int window(int S) {
  const int w = (S + KC - 1) / KC * KC;
  return w < KW_MAX ? w : KW_MAX;
}

// K and V windows, and the warps' probs staging where probs are written.
inline size_t smem_bytes(int kw, bool probs) {
  return sizeof(bf16) * (2 * (size_t)kw * mma::ROW + (probs ? (size_t)WARPS * 16 * PROW : 0));
}

// The 16 x 8 NJ scores of query rows q0.. against the keys at c0.. of the
// staged window (key0 = the first one's index in the row): element e of
// tile j is row q0 + g + 8 (e / 2), key key0 + 8 j + c + e % 2.
template <int NJ>
__device__ __forceinline__ void chunk_scores(float (&s)[NJ][4],
                                             const uint32_t (&qa)[mma::D / 16][4],
                                             const bf16* Ks, int c0, int key0,
                                             const float* mask, int q0, int S, int lane) {
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma::row_tile(s[j], qa, Ks, c0 / 8 + j, lane);
  const bool edge = key0 + 8 * NJ > S;  // the tiles hold keys at or past S
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + g + 8 * (e >> 1), col = key0 + 8 * j + c + (e & 1);
      float v = __fmul_rn(s[j][e], SCALE);  // scale, then add the mask: no fused multiply-add
      if (edge && col >= S) v = -INFINITY;
      else if (mask != nullptr && r < S) v += mask[(size_t)r * S + col];
      s[j][e] = v;
    }
}

// p's 16 x 16 half hf of a KC chunk, as the A fragment pa, into the
// warp's staging tile ps (A fragment layout, mma.cuh: a0, a2 row g; a1,
// a3 row g + 8).
__device__ __forceinline__ void stage_probs(bf16* ps, const uint32_t (&pa)[4], int hf, int lane) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  uint32_t* row0 = reinterpret_cast<uint32_t*>(ps + g * PROW + 16 * hf + c);
  uint32_t* row1 = reinterpret_cast<uint32_t*>(ps + (g + 8) * PROW + 16 * hf + c);
  row0[0] = pa[0];
  row1[0] = pa[1];
  row0[4] = pa[2];
  row1[4] = pa[3];
}

// The staged 16 x KC chunk into rows q0.. of a probs row block (stride S)
// at key0: each store of the warp covers 32 neighbouring keys of a row.
__device__ __forceinline__ void store_probs(bf16* pb, const bf16* ps, int q0, int key0, int S,
                                            int lane) {
  __syncwarp();
  const int col = key0 + lane, rows = min(16, S - q0);
  if (col < S) {
    bf16* dst = pb + (size_t)q0 * S + col;
    const bf16* src = ps + lane;
#pragma unroll 4
    for (int r = 0; r < rows; ++r, dst += S, src += PROW) *dst = *src;
  }
  __syncwarp();
}

template <bool PROBS>
__global__ void __launch_bounds__(THREADS)
attn_core_tc(const bf16* __restrict__ qkv, const float* __restrict__ mask, bf16* __restrict__ o,
             bf16* __restrict__ probs, int S, int H, int Wl, int kw) {
  using namespace mvlpt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kw * ROW;
  bf16* ps = Vs + kw * ROW + warp * 16 * PROW;  // this warp's probs staging
  const int ld = 3 * Wl;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const bf16* q = qkv + (size_t)b * S * ld + h * D;
  const bf16* k = q + Wl;
  const bf16* v = q + 2 * Wl;
  bf16* ob = o + (size_t)b * S * Wl + h * D;
  bf16* pb = PROBS ? probs + (size_t)bh * S * S : nullptr;
  const int nwin = (S + kw - 1) / kw, groups = (S + 15) / 16;

  // Keys [k0, k0 + kw) of K (and V) into shared memory, zero past S up to
  // a whole chunk; every thread of the block takes part.
  auto stage = [&](int k0, bool with_v) {
    const int n = min(kw, S - k0), rows = (n + KC - 1) / KC * KC;
    stage_rows(Ks, k + (size_t)k0 * ld, n, rows, threadIdx.x, THREADS, ld);
    if (with_v) stage_rows(Vs, v + (size_t)k0 * ld, n, rows, threadIdx.x, THREADS, ld);
    cp_async_wait();
    __syncthreads();
  };
  if (nwin == 1) stage(0, true);

  // The loop runs alike in every warp of the block (its bound depends on
  // the block only), so the windows' barriers meet; a warp past the last
  // group idles through them.
  for (int base = blockIdx.y * WARPS; base < groups; base += gridDim.y * WARPS) {
    const int q0 = (base + warp) * 16;
    const bool active = q0 < S;
    uint32_t qa[D / 16][4];
    load_a_rows(qa, q, q0, S, lane, ld);

    // Pass 1: per lane, the running max m and the sum l of exp(s - m)
    // over its columns, rows g (index 0) and g + 8 (1).
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int w = 0; w < nwin; ++w) {
      const int k0 = w * kw, n = min(kw, S - k0);
      if (nwin > 1) {
        __syncthreads();  // every warp is done with the last window
        stage(k0, false);
      }
      if (!active) continue;
      for (int c0 = 0; c0 < n; c0 += KC) {
        float s[4][4];
        chunk_scores<4>(s, qa, Ks, c0, k0 + c0, mask, q0, S, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float cm = m[i];
#pragma unroll
          for (int j = 0; j < 4; ++j) cm = fmaxf(cm, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
          if (cm == -INFINITY) continue;  // every key so far past S: nothing to add
          float add = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) add += expf(s[j][2 * i] - cm) + expf(s[j][2 * i + 1] - cm);
          l[i] = l[i] * expf(m[i] - cm) + add;
          m[i] = cm;
        }
      }
    }
    // The four lanes of a row: its max, and the sum rescaled to it.
    float mx[2], sum[2], rs[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(m[i]);
      sum[i] = quad_sum(m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - mx[i]));
      rs[i] = rcp(sum[i]);
    }

    // Pass 2: p = T(exp(s - max) / sum), probs, o = T(p v).
    float acc[D / 8][4] = {};
    for (int w = 0; w < nwin; ++w) {
      const int k0 = w * kw, n = min(kw, S - k0);
      if (nwin > 1) {
        __syncthreads();
        stage(k0, true);
      }
      if (!active) continue;
      for (int c0 = 0; c0 < n; c0 += KC) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // 16 keys at a time: one k step of p v
          float s[2][4];
          chunk_scores<2>(s, qa, Ks, c0 + 16 * hf, k0 + c0 + 16 * hf, mask, q0, S, lane);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = div_rn(expf(s[j][e] - mx[e >> 1]), sum[e >> 1], rs[e >> 1]);
          uint32_t pa[4];
          pack_a(pa, s[0], s[1]);
          acc_rows16(acc, pa, Vs, c0 + 16 * hf, lane);
          if constexpr (PROBS) stage_probs(ps, pa, hf, lane);
        }
        if constexpr (PROBS) store_probs(pb, ps, q0, k0 + c0, S, lane);
      }
    }
    if (active) store_rows(ob, acc, q0, S, lane, Wl);
  }
}

// The shared-memory attribute is set once, for the largest window, and
// the SM count read once: both hold for the process (one card a process),
// and the launch then makes no runtime call before the kernel's.
template <bool PROBS>
int launch(const void* qkv, const float* mask, void* o, void* probs, int B, int S, int H, int Wl,
           cudaStream_t st) {
  static bool smem_set = false;
  static int sms = 0;
  if (!smem_set) {
    MVLPT_TRY(cudaFuncSetAttribute(attn_core_tc<PROBS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(KW_MAX, PROBS)));
    smem_set = true;
  }
  if (sms == 0) MVLPT_TRY(mma::sm_count(&sms));
  const int kw = window(S);
  attn_core_tc<PROBS><<<dim3(B * H, mma::row_shares(B * H, S, WARPS, sms)), THREADS,
                        smem_bytes(kw, PROBS), st>>>((const bf16*)qkv, mask, (bf16*)o,
                                                     (bf16*)probs, S, H, Wl, kw);
  return (int)cudaGetLastError();
}

}  // namespace core

// ------------------------------------------------------- the half-block

// H heads of D each (Wl = H D, the qkv width 3 Wl); the LN and the output
// are over the model width W. part: fp32 partial out-projection into y,
// without out_b or the residual. probs, mu and rstd may be null.
template <typename T>
int attn_fwd_impl(const void* x, const void* ln_scale, const void* ln_bias, const void* qkv_w,
                  const void* qkv_b, const void* out_w, const void* out_b, const float* mask,
                  void* xh, void* qkv, void* o, void* probs, float* mu, float* rstd, void* y,
                  int B, int S, int W, int H, int D, float eps, bool part, cudaStream_t st) {
  constexpr bool tc = std::is_same_v<T, __nv_bfloat16>;
  if (tc && D != mma::D) return (int)cudaErrorInvalidValue;  // the wrappers raise first
  const int M = B * S, Wl = H * D;
  MVLPT_TRY(launch_ln_fwd<T>(x, ln_scale, ln_bias, xh, mu, rstd, M, W, eps, st));
  MVLPT_TRY((wg::gemm<T, EPI_BIAS>(xh, qkv_w, M, 3 * Wl, W,
                                   EpiArgs{qkv_b, nullptr, nullptr, qkv, nullptr}, st)));
  int rc;
  if constexpr (tc) {
    rc = probs != nullptr ? core::launch<true>(qkv, mask, o, probs, B, S, H, Wl, st)
                          : core::launch<false>(qkv, mask, o, nullptr, B, S, H, Wl, st);
  } else {
    const fma_core::AttnRows rows{qkv, (const T*)qkv + Wl, (const T*)qkv + 2 * Wl, o, H,
                                  (long long)S * 3 * Wl, (long long)S * Wl, D, 3 * Wl, D, Wl};
    rc = fma_core::launch_fma_attn_fwd<T>(rows, B * H, mask, probs, S, D,
                                          (float)pow((double)D, -0.5), true, st);
  }
  if (rc != 0) return rc;
  if (part)
    MVLPT_TRY((wg::gemm<T, EPI_F32>(o, out_w, M, W, Wl,
                                    EpiArgs{nullptr, nullptr, nullptr, y, nullptr}, st)));
  else
    MVLPT_TRY((wg::gemm<T, EPI_BIAS_RESID>(o, out_w, M, W, Wl,
                                           EpiArgs{out_b, x, nullptr, y, nullptr}, st)));
  return 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores, D = 64).
// probs, mu and rstd may be null (no-residual mode); xh, qkv and o are
// caller-allocated scratch.
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
                               (const float*)mask, xh, qkv, o, probs, (float*)mu, (float*)rstd, y,
                               B, S, W, H, D, eps, false, st);
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
                               (const float*)mask, xh, qkv, o, probs, (float*)mu, (float*)rstd,
                               ypart, B, S, W, H, D, eps, true, st);
  return (int)cudaErrorInvalidValue;
}
