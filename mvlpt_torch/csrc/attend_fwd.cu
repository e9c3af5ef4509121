// Standalone fused attention forward: o = softmax(q k^T * scale + mask) v.
//
// Replaces the Pallas kernel mvlpt_tpu/ops/attention.py:_fwd_kernel
// (called by _attend_fwd), with its rounding points: s = q k^T on the
// unscaled q, accumulated in fp32; then s * scale + mask in fp32, with
// scale = D^-1/2 and no fused multiply-add; an exact fp32 softmax (max,
// expf, sum, divide); p rounded to T; o = T(p v), accumulated in fp32.
// (The half-block kernel of attn_fwd.cu scales and rounds q before the
// product instead.)
//
// The TPU program holds G (batch*head) rows of q, k, v and their fp32
// scores in VMEM, with S padded to a multiple of 128 and finfo.min on the
// padded keys. Padded keys take no probability there, so the real rows
// equal an unpadded call's. Two routes, by dtype and S:
//
// bfloat16: tensor cores (attend_fwd_tc). One block of 4 warps per
//   (batch*head row, share of its query groups) stages that row's K and
//   V once as bf16 in shared memory (16-byte cp.async, rows skewed
//   against bank conflicts). Each warp takes 16 queries at a time: q k^T
//   with mma.sync m16n8k16, the whole 16 x S score row in registers
//   (the kernel is templated on NT key tiles of 8, S <= 8 NT, so the
//   array has a compile-time length; above S = 208 the row sits in the
//   warp's own shared memory instead, as registers would spill); padded
//   keys get -inf; the row max and sum over the four lanes of a row; p
//   divided, rounded to bf16 and packed from the accumulator fragments
//   straight into the A fragments of p v, so p never leaves registers.
//   D = 64 only; S <= 352 (the buckets).
// CUDA cores (fma_attn.cuh's core, fp32 FMAs; TF32 would not hold fp32's
//   tolerance), templated on T with the rounding points above: every
//   fp32 call, and a bf16 call past the largest bucket, chosen openly by
//   shape (ops/attention.route_of). One block per (row, tile of queries)
//   streams the row's K and V through shared memory in key chunks and
//   keeps each query's fp32 score row, taking fewer queries a block as S
//   grows: any S whose one score row fits a block (about 49,700 at
//   D = 64).
//
// Bound: the function reads q, k, v and writes o. At the image eval shape
// (N = B*H = 1200, S = 201, D = 64, bf16) that is 123.5 MB, 36.9 us at
// 3.35 TB/s, against 12.4 GFLOP of products, 12.5 us at 989 TFLOP/s:
// bound by bytes. The tensor-core route reads each of q, k, v once from
// device memory; its products are cheap beside that.
#include "common.cuh"
#include "fma_attn.cuh"
#include "mma.cuh"

using namespace mvlpt;

namespace {

// ------------------------------------------------ bf16, tensor cores

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int FWD_NT[] = {10, 16, 26, 35, 44};  // buckets: S <= 80, 128, 208, 280, 352
// Up to this bucket a warp's score row lives in registers; above it, in
// the warp's shared memory (ScoreRow), where ptxas would otherwise spill.
// At S <= 208 a shared row made the forward slower than the register row.
constexpr int FWD_REG_NT = 26;

template <int NT>
constexpr bool fwd_row_shared = NT > FWD_REG_NT;

template <int NT>
constexpr int fwd_smem() {
  return 2 * 16 * ((NT + 1) / 2) * mma::ROW * (int)sizeof(__nv_bfloat16) +
         (fwd_row_shared<NT> ? TC_WARPS * mma::row_floats<NT> * (int)sizeof(float) : 0);
}

template <int NT>
__global__ void __launch_bounds__(TC_THREADS)
attend_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
              __nv_bfloat16* __restrict__ o, int S, float scale) {
  using namespace mvlpt::mma;
  constexpr int KC = (NT + 1) / 2;  // key chunks of 16, the k steps of p v
  constexpr int ROWS = 16 * KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + ROWS * ROW;
  float* rows_buf = reinterpret_cast<float*>(Vs + ROWS * ROW);  // fwd_row_shared only
  const size_t base = (size_t)blockIdx.x * S * D;
  stage_rows(Ks, k + base, S, ROWS, threadIdx.x, TC_THREADS);
  stage_rows(Vs, v + base, S, ROWS, threadIdx.x, TC_THREADS);
  cp_async_wait();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (S + 15) / 16;
  for (int grp = blockIdx.y * TC_WARPS + warp; grp < groups; grp += gridDim.y * TC_WARPS) {
    const int q0 = grp * 16;
    uint32_t qa[D / 16][4];
    load_a_rows(qa, q + base, q0, S, lane);

    ScoreRow<NT, fwd_row_shared<NT>> sc(rows_buf + warp * row_floats<NT>, lane);
    float mx[2], sum[2];
    softmax_rows<NT>(sc, mx, sum, qa, Ks, mask, q0, S, scale, lane);

    // o = T(p) v: each key chunk's probabilities, divided and rounded,
    // are the A fragment of one k step.
    const float rs[2] = {rcp(sum[0]), rcp(sum[1])};
    float acc[D / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const bool full = 2 * kc + 1 < NT;  // an odd NT leaves the last chunk's right half empty
      const int jh = full ? 2 * kc + 1 : 2 * kc;
      float lo[4], hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo[e] = div_rn(sc(2 * kc, e), sum[e >> 1], rs[e >> 1]);
        hi[e] = full ? div_rn(sc(jh, e), sum[e >> 1], rs[e >> 1]) : 0.f;
      }
      uint32_t pa[4];
      pack_a(pa, lo, hi);
      acc_rows16(acc, pa, Vs, 16 * kc, lane);
    }
    store_rows(o + base, acc, q0, S, lane);
  }
}

template <int NT>
int launch_fwd_tc(const void* q, const void* k, const void* v, const float* mask, void* o, int N,
                  int S, cudaStream_t st) {
  constexpr int smem = fwd_smem<NT>();
  MVLPT_TRY(cudaFuncSetAttribute(attend_fwd_tc<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem));
  attend_fwd_tc<NT><<<dim3(N, mma::row_shares(N, S, TC_WARPS)), TC_THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, mask,
      (__nv_bfloat16*)o, S, 0.125f);  // 64^-1/2
  return (int)cudaGetLastError();
}

// T on the CUDA cores (fma_attn.cuh), q, k, v, o (N, S, D) contiguous.
template <typename T>
int attend_fwd_fma(const void* q, const void* k, const void* v, const float* mask, void* o, int N,
                   int S, int D, cudaStream_t st) {
  const fma_core::AttnRows rows{q, k, v, o, 1, (long long)S * D, (long long)S * D, 0, D, 0, D};
  return fma_core::launch_fma_attn_fwd<T>(rows, N, mask, nullptr, S, D,
                                          (float)pow((double)D, -0.5), false, st);
}

int attend_fwd_bf16(const void* q, const void* k, const void* v, const float* mask, void* o,
                    int N, int S, int D, cudaStream_t st) {
  if (D != mma::D || S < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) return (int)cudaErrorMisalignedAddress;
  if (S <= 8 * FWD_NT[0]) return launch_fwd_tc<FWD_NT[0]>(q, k, v, mask, o, N, S, st);
  if (S <= 8 * FWD_NT[1]) return launch_fwd_tc<FWD_NT[1]>(q, k, v, mask, o, N, S, st);
  if (S <= 8 * FWD_NT[2]) return launch_fwd_tc<FWD_NT[2]>(q, k, v, mask, o, N, S, st);
  if (S <= 8 * FWD_NT[3]) return launch_fwd_tc<FWD_NT[3]>(q, k, v, mask, o, N, S, st);
  if (S <= 8 * FWD_NT[4]) return launch_fwd_tc<FWD_NT[4]>(q, k, v, mask, o, N, S, st);
  return attend_fwd_fma<__nv_bfloat16>(q, k, v, mask, o, N, S, D, st);  // past the buckets
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (D = 64; tensor cores up
// to S = 352, CUDA cores past it). mask may be null (no mask).
extern "C" int mvlpt_attend_fwd(int dtype, const void* q, const void* k, const void* v,
                                const void* mask, void* o, int N, int S, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return attend_fwd_fma<float>(q, k, v, (const float*)mask, o, N, S, D, st);
  if (dtype == 1) return attend_fwd_bf16(q, k, v, (const float*)mask, o, N, S, D, st);
  return (int)cudaErrorInvalidValue;
}
