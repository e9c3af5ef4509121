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
// order, so each route is two launches with no atomics (results do not
// change from run to run). Two routes, by dtype and S:
//
// bfloat16 up to S = 280 (the buckets): tensor cores, mma.sync m16n8k16
//   (csrc/mma.cuh), D = 64; no (N, S, S) tensor in device memory.
//   1. attend_bwd_dq_tc, one block of 4 warps per (row, share of its
//      query groups), K and V staged once as bf16 in shared memory. A
//      warp takes 16 queries: the exact p as in attend_fwd.cu, held in
//      registers (above S = 128 in the warp's own shared memory, as
//      registers would spill); dp = do v^T one key tile at a time,
//      twice (once for t = rowsum(dp p), once for ds), so no second score
//      row is held; ds packed from the accumulators into the A fragments
//      of dq = ds k.
//      It writes dq and, per query row, max, sum and t: a (3, N, S) fp32
//      scratch.
//   2. attend_bwd_dkv_tc, one block per (row, share of its key groups),
//      Q, dO and the row statistics (and 1 / sum) staged. A warp takes
//      16 keys, holds their k and v as A fragments and walks the queries
//      16 at a time:
//      s^T = k q^T, so p^T = expf(s^T * scale + mask^T - max) / sum
//      comes out in the accumulator layout that is the A operand of
//      dv += T(p^T) do; dp^T = v do^T; ds^T = T(p^T (dp^T - t) scale);
//      dk += ds^T q.
// CUDA cores, fp32 FMAs (TF32 would not hold fp32's tolerance), templated
//   on T with the rounding points above: every fp32 call, and a bf16 call
//   past the largest bucket, chosen openly by shape
//   (ops/attention.route_of).
//   1. one block per (row, query tile) streams the row's K and V through
//      shared memory in key chunks, recomputes p, takes dp, ds and dq,
//      and writes T(p) and ds to (N, S, S) scratch in T; each query keeps
//      its S-long p and dp rows, and a block takes fewer queries as S
//      grows: any S whose one pair of rows fits a block (about 24,800 at
//      D = 64);
//   2. one block per (row, key tile) streams q, do, p and ds through
//      shared memory in query chunks for dv and dk.
//
// Bound: the function reads q, k, v, do and writes dq, dk, dv. At the
// image train shape (N = B*H = 384, S = 201, D = 64, bf16) that is
// 69.2 MB, 20.7 us at 3.35 TB/s, against 9.9 GFLOP (the recomputed
// scores and four products), 10.0 us at 989 TFLOP/s: bound by bytes. The
// tensor-core route moves q, k, v and do twice (one staging a launch)
// and 0.9 MB of statistics besides.
#include "common.cuh"
#include "fma_attn.cuh"
#include "mma.cuh"

using namespace mvlpt;

namespace {

// ------------------------------------------------ bf16, tensor cores

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int BWD_NT[] = {10, 16, 26, 35};  // buckets: S <= 80, 128, 208, 280
// Up to this bucket launch 1 holds a warp's probability row in registers;
// above it, in the warp's shared memory (ScoreRow), where ptxas would
// otherwise spill (the S <= 208 bucket did, in registers).
constexpr int DQ_REG_NT = 16;
// A row in shared memory is walked this many key tiles at a time: unrolled
// whole, the scheduler hoists every tile's loads at once; one tile at a
// time, ptxas spilled.
constexpr int DQ_UNROLL = 4;

template <int NT>
constexpr bool dq_row_shared = NT > DQ_REG_NT;

// Launch 1: dq and the row statistics (max, sum, t) of each query row.
template <int NT>
__global__ void __launch_bounds__(TC_THREADS)
attend_bwd_dq_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                 const __nv_bfloat16* __restrict__ dout, float* __restrict__ stats,
                 __nv_bfloat16* __restrict__ dq, int N, int S, float scale) {
  using namespace mvlpt::mma;
  constexpr int KC = (NT + 1) / 2;
  constexpr int ROWS = 16 * KC;
  constexpr int UNROLL = dq_row_shared<NT> ? DQ_UNROLL : NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + ROWS * ROW;
  float* rows_buf = reinterpret_cast<float*>(Vs + ROWS * ROW);  // dq_row_shared only
  const size_t base = (size_t)blockIdx.x * S * D;
  stage_rows(Ks, k + base, S, ROWS, threadIdx.x, TC_THREADS);
  stage_rows(Vs, v + base, S, ROWS, threadIdx.x, TC_THREADS);
  cp_async_wait();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const size_t ns = (size_t)N * S;
  float* st = stats + (size_t)blockIdx.x * S;  // max, then sum and t at +ns, +2ns
  const int groups = (S + 15) / 16;
  for (int grp = blockIdx.y * TC_WARPS + warp; grp < groups; grp += gridDim.y * TC_WARPS) {
    const int q0 = grp * 16;
    uint32_t a[D / 16][4];
    load_a_rows(a, q + base, q0, S, lane);
    ScoreRow<NT, dq_row_shared<NT>> p(rows_buf + warp * row_floats<NT>, lane);
    float mx[2], sum[2];
    softmax_rows<NT>(p, mx, sum, a, Ks, mask, q0, S, scale, lane);
    const float rs[2] = {rcp(sum[0]), rcp(sum[1])};

    // p = e / sum, and t = rowsum(dp p) with dp = do v^T a key tile at a
    // time (a row in shared memory DQ_UNROLL tiles at a time).
    load_a_rows(a, dout + base, q0, S, lane);  // a: do from here on
    float t[2] = {0.f, 0.f};
#pragma unroll UNROLL
    for (int j = 0; j < NT; ++j) {
      float dp[4];
      row_tile(dp, a, Vs, j, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = div_rn(p(j, e), sum[e >> 1], rs[e >> 1]);
        p(j, e) = pe;
        t[e >> 1] += dp[e] * pe;
      }
    }
    t[0] = quad_sum(t[0]);
    t[1] = quad_sum(t[1]);

    float acc[D / 8][4] = {};
#pragma unroll UNROLL
    for (int kc = 0; kc < KC; ++kc) {
      float ds[2][4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kc + h < NT ? 2 * kc + h : NT - 1;
        if (2 * kc + h >= NT) continue;  // an odd NT: the last chunk's right half is empty
        float dp[4];
        row_tile(dp, a, Vs, j, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[h][e] = __fmul_rn(__fmul_rn(p(j, e), dp[e] - t[e >> 1]), scale);
      }
      uint32_t dsa[4];
      pack_a(dsa, ds[0], ds[1]);
      acc_rows16(acc, dsa, Ks, 16 * kc, lane);
    }
    store_rows(dq + base, acc, q0, S, lane);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + g + 8 * h;
        if (r >= S) continue;
        st[r] = mx[h];
        st[ns + r] = sum[h];
        st[2 * ns + r] = t[h];
      }
    }
  }
}

// Launch 2: dk and dv, each key row summing over every query.
template <int NT>
__global__ void __launch_bounds__(TC_THREADS)
attend_bwd_dkv_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                  const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N, int S,
                  float scale) {
  using namespace mvlpt::mma;
  constexpr int KC = (NT + 1) / 2;  // query chunks of 16
  constexpr int ROWS = 16 * KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + ROWS * ROW;
  float* mxs = reinterpret_cast<float*>(dOs + ROWS * ROW);
  float* sums = mxs + ROWS;
  float* rcps = sums + ROWS;
  float* ts = rcps + ROWS;
  const size_t base = (size_t)blockIdx.x * S * D;
  const size_t ns = (size_t)N * S;
  stage_rows(Qs, q + base, S, ROWS, threadIdx.x, TC_THREADS);
  stage_rows(dOs, dout + base, S, ROWS, threadIdx.x, TC_THREADS);
  const float* st = stats + (size_t)blockIdx.x * S;
  for (int i = threadIdx.x; i < ROWS; i += TC_THREADS) {
    const bool in = i < S;
    mxs[i] = in ? st[i] : 0.f;
    sums[i] = in ? st[ns + i] : 1.f;
    rcps[i] = rcp(sums[i]);
    ts[i] = in ? st[2 * ns + i] : 0.f;
  }
  cp_async_wait();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = (lane & 3) * 2;
  const int groups = (S + 15) / 16;
  for (int grp = blockIdx.y * TC_WARPS + warp; grp < groups; grp += gridDim.y * TC_WARPS) {
    const int k0 = grp * 16;
    const int keys[2] = {k0 + g, k0 + g + 8};
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_a_rows(ka, k + base, k0, S, lane);
    load_a_rows(va, v + base, k0, S, lane);
    float dka[D / 8][4] = {}, dva[D / 8][4] = {};
#pragma unroll 1
    for (int qc = 0; qc < KC; ++qc) {
      // p^T of these keys (rows) against queries 16 qc + 8 h + c + e % 2.
      float pt[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row_tile(pt[h], ka, Qs, 2 * qc + h, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 16 * qc + 8 * h + c + (e & 1), key = keys[e >> 1];
          float s = __fmul_rn(pt[h][e], scale);
          if (mask != nullptr && key < S && qi < S) s += mask[(size_t)qi * S + key];
          pt[h][e] = qi < S ? div_rn(expf(s - mxs[qi]), sums[qi], rcps[qi]) : 0.f;
        }
      }
      uint32_t fa[4];
      pack_a(fa, pt[0], pt[1]);
      acc_rows16(dva, fa, dOs, 16 * qc, lane);
      float ds[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row_tile(ds[h], va, dOs, 2 * qc + h, lane);  // dp^T
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 16 * qc + 8 * h + c + (e & 1);
          ds[h][e] = __fmul_rn(__fmul_rn(pt[h][e], ds[h][e] - ts[qi]), scale);
        }
      }
      pack_a(fa, ds[0], ds[1]);
      acc_rows16(dka, fa, Qs, 16 * qc, lane);
    }
    store_rows(dk + base, dka, k0, S, lane);
    store_rows(dv + base, dva, k0, S, lane);
  }
}

template <int NT>
int launch_bwd_tc(const void* q, const void* k, const void* v, const float* mask,
                  const void* dout, float* stats, void* dq, void* dk, void* dv, int N, int S,
                  cudaStream_t st) {
  using bf = __nv_bfloat16;
  constexpr int ROWS = 16 * ((NT + 1) / 2);
  const int smem_kv = 2 * ROWS * mma::ROW * (int)sizeof(bf) +
                      4 * ROWS * (int)sizeof(float);  // Q, dO; max, sum, 1 / sum, t
  const int smem_q = 2 * ROWS * mma::ROW * (int)sizeof(bf) +
                     (dq_row_shared<NT> ? TC_WARPS * mma::row_floats<NT> * (int)sizeof(float) : 0);
  MVLPT_TRY(cudaFuncSetAttribute(attend_bwd_dq_tc<NT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q));
  MVLPT_TRY(cudaFuncSetAttribute(attend_bwd_dkv_tc<NT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv));
  const dim3 grid(N, mma::row_shares(N, S, TC_WARPS));
  const float scale = 0.125f;  // 64^-1/2
  attend_bwd_dq_tc<NT><<<grid, TC_THREADS, smem_q, st>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, mask, (const bf*)dout, stats, (bf*)dq, N, S,
      scale);
  MVLPT_TRY(cudaGetLastError());
  attend_bwd_dkv_tc<NT><<<grid, TC_THREADS, smem_kv, st>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, mask, (const bf*)dout, stats, (bf*)dk, (bf*)dv,
      N, S, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------------- CUDA cores, in T

using fma_core::FMA_KC;
using fma_core::FMA_THREADS;
using fma_core::fma_rows;

constexpr int KT = 32;  // key rows per dk/dv block

inline size_t dq_fixed(int D) { return 2 * (size_t)FMA_KC * (D + 1); }
inline size_t dq_row(int S, int D) { return 3 * (size_t)D + 2 * (size_t)S; }
inline size_t dkv_words(int D) {
  return 2 * (size_t)FMA_KC * D + 2 * (size_t)KT * (FMA_KC + 1) + 2 * (size_t)KT * D;
}

// Per query row: p, dp, ds, dq; T(p) and ds go to the (N, S, S) scratch.
template <typename T>
__global__ void __launch_bounds__(FMA_THREADS)
attend_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ mask, const T* __restrict__ dout, T* __restrict__ p_g,
              T* __restrict__ ds_g, T* __restrict__ dq, int S, int D, float scale, int qt) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.y * qt;
  const size_t base = (size_t)blockIdx.x * S * D;
  float* Kc = smem;                    // FMA_KC x (D+1)
  float* Vc = Kc + FMA_KC * (D + 1);   // FMA_KC x (D+1)
  float* Qs = Vc + FMA_KC * (D + 1);   // qt x D
  float* dOs = Qs + qt * D;            // qt x D
  float* dQ = dOs + qt * D;            // qt x D, the dq accumulators
  float* Ps = dQ + qt * D;             // qt x S: scores, then probabilities
  float* DPs = Ps + qt * S;            // qt x S: dp, then ds

  for (int idx = threadIdx.x; idx < qt * D; idx += FMA_THREADS) {
    const bool in = q0 + idx / D < S;
    const size_t g = base + (size_t)q0 * D + idx;
    Qs[idx] = in ? to_f(q[g]) : 0.f;
    dOs[idx] = in ? to_f(dout[g]) : 0.f;
    dQ[idx] = 0.f;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The scores and dp = do v^T, a key chunk at a time.
  for (int k0 = 0; k0 < S; k0 += FMA_KC) {
    const int nk = min(FMA_KC, S - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += FMA_THREADS) {
      const int j = idx / D, d = idx - j * D;
      const size_t g = base + (size_t)k0 * D + idx;
      Kc[j * (D + 1) + d] = to_f(k[g]);
      Vc[j * (D + 1) + d] = to_f(v[g]);
    }
    __syncthreads();
    for (int r = warp; r < qt; r += FMA_THREADS / 32) {
      const int qi = q0 + r;
      if (qi >= S) break;
      const float* qrow = Qs + r * D;
      const float* dorow = dOs + r * D;
      for (int j = lane; j < nk; j += 32) {
        const float* krow = Kc + j * (D + 1);
        const float* vrow = Vc + j * (D + 1);
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
        for (int d = 0; d < D; ++d) dp = fmaf(dorow[d], vrow[d], dp);
        s = __fmul_rn(s, scale);
        if (mask != nullptr) s += mask[(size_t)qi * S + k0 + j];
        Ps[r * S + k0 + j] = s;
        DPs[r * S + k0 + j] = dp;
      }
    }
  }

  // The exact softmax of each whole row, t = rowsum(dp p) and
  // ds = T(p (dp - t) scale) from the unrounded p.
  for (int r = warp; r < qt; r += FMA_THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= S) break;
    float* prow = Ps + r * S;
    float* drow = DPs + r * S;
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
    float t = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = prow[j] / sum;
      prow[j] = p;
      t += drow[j] * p;
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
  }

  // dq = ds k, a key chunk at a time.
  for (int k0 = 0; k0 < S; k0 += FMA_KC) {
    const int nk = min(FMA_KC, S - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += FMA_THREADS) {
      const int j = idx / D, d = idx - j * D;
      Kc[j * (D + 1) + d] = to_f(k[base + (size_t)k0 * D + idx]);
    }
    __syncthreads();
    for (int r = warp; r < qt; r += FMA_THREADS / 32) {
      if (q0 + r >= S) break;
      const float* drow = DPs + r * S + k0;
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
    for (int d = lane; d < D; d += 32) dq[base + (size_t)qi * D + d] = from_f<T>(dQ[r * D + d]);
  }
}

// Per key row k: dv = T(sum_q T(p)[q,k] do[q]), dk = T(sum_q ds[q,k] q[q]),
// the queries a chunk of FMA_KC at a time.
template <typename T>
__global__ void __launch_bounds__(FMA_THREADS)
attend_bwd_dkv(const T* __restrict__ q, const T* __restrict__ dout, const T* __restrict__ p_g,
               const T* __restrict__ ds_g, T* __restrict__ dk, T* __restrict__ dv, int S, int D) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QC = FMA_KC, PT = QC + 1;  // query chunk; padded row of Pt and DSt
  const int k0 = blockIdx.y * KT;
  const size_t base = (size_t)blockIdx.x * S * D;
  const size_t row_off = (size_t)blockIdx.x * S * S;
  float* Qc = smem;             // QC x D
  float* dOc = Qc + QC * D;     // QC x D
  float* Pt = dOc + QC * D;     // KT x PT, p transposed
  float* DSt = Pt + KT * PT;    // KT x PT, ds transposed
  float* dK = DSt + KT * PT;    // KT x D, the dk accumulators
  float* dV = dK + KT * D;      // KT x D, the dv accumulators
  for (int idx = threadIdx.x; idx < KT * D; idx += FMA_THREADS) dK[idx] = dV[idx] = 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int c0 = 0; c0 < S; c0 += QC) {
    const int nq = min(QC, S - c0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nq * D; idx += FMA_THREADS) {
      const size_t g = base + (size_t)c0 * D + idx;
      Qc[idx] = to_f(q[g]);
      dOc[idx] = to_f(dout[g]);
    }
    for (int idx = threadIdx.x; idx < KT * nq; idx += FMA_THREADS) {
      const int qi = idx / KT, kk = idx - qi * KT;
      const int kj = k0 + kk;
      const bool in = kj < S;
      const size_t g = row_off + (size_t)(c0 + qi) * S + kj;
      Pt[kk * PT + qi] = in ? to_f(p_g[g]) : 0.f;
      DSt[kk * PT + qi] = in ? to_f(ds_g[g]) : 0.f;
    }
    __syncthreads();
    for (int kk = warp; kk < KT; kk += FMA_THREADS / 32) {
      if (k0 + kk >= S) break;
      const float* pcol = Pt + kk * PT;
      const float* dscol = DSt + kk * PT;
      for (int d = lane; d < D; d += 32) {
        float accv = dV[kk * D + d], acck = dK[kk * D + d];
        for (int qi = 0; qi < nq; ++qi) {
          accv = fmaf(pcol[qi], dOc[qi * D + d], accv);
          acck = fmaf(dscol[qi], Qc[qi * D + d], acck);
        }
        dV[kk * D + d] = accv;
        dK[kk * D + d] = acck;
      }
    }
  }
  for (int kk = warp; kk < KT; kk += FMA_THREADS / 32) {
    const int kj = k0 + kk;
    if (kj >= S) break;
    for (int d = lane; d < D; d += 32) {
      dk[base + (size_t)kj * D + d] = from_f<T>(dK[kk * D + d]);
      dv[base + (size_t)kj * D + d] = from_f<T>(dV[kk * D + d]);
    }
  }
}

template <typename T>
int attend_bwd_fma(const void* q, const void* k, const void* v, const float* mask,
                   const void* dout, void* p, void* ds, void* dq, void* dk, void* dv, int N, int S,
                   int D, cudaStream_t st) {
  if (p == nullptr || ds == nullptr || S < 1) return (int)cudaErrorInvalidValue;
  const int qt = fma_rows(dq_fixed(D), dq_row(S, D));
  const size_t smem_kv = sizeof(float) * dkv_words(D);
  if (qt < 1 || smem_kv > kMaxDynSmem) return (int)cudaErrorInvalidConfiguration;
  const size_t smem_q = sizeof(float) * (dq_fixed(D) + (size_t)qt * dq_row(S, D));
  MVLPT_TRY(cudaFuncSetAttribute(attend_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_q));
  MVLPT_TRY(cudaFuncSetAttribute(attend_bwd_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_kv));
  attend_bwd_dq<T><<<dim3(N, (S + qt - 1) / qt), FMA_THREADS, smem_q, st>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (const T*)dout, (T*)p, (T*)ds, (T*)dq, S, D,
      (float)pow((double)D, -0.5), qt);
  MVLPT_TRY(cudaGetLastError());
  attend_bwd_dkv<T><<<dim3(N, (S + KT - 1) / KT), FMA_THREADS, smem_kv, st>>>(
      (const T*)q, (const T*)dout, (const T*)p, (const T*)ds, (T*)dk, (T*)dv, S, D);
  return (int)cudaGetLastError();
}

int attend_bwd_bf16(const void* q, const void* k, const void* v, const float* mask,
                    const void* dout, void* p, void* ds, float* stats, void* dq, void* dk,
                    void* dv, int N, int S, int D, cudaStream_t st) {
  if (D != mma::D || S < 1) return (int)cudaErrorInvalidValue;
  if (S > 8 * BWD_NT[3])  // past the buckets
    return attend_bwd_fma<__nv_bfloat16>(q, k, v, mask, dout, p, ds, dq, dk, dv, N, S, D, st);
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (S <= 8 * BWD_NT[0])
    return launch_bwd_tc<BWD_NT[0]>(q, k, v, mask, dout, stats, dq, dk, dv, N, S, st);
  if (S <= 8 * BWD_NT[1])
    return launch_bwd_tc<BWD_NT[1]>(q, k, v, mask, dout, stats, dq, dk, dv, N, S, st);
  if (S <= 8 * BWD_NT[2])
    return launch_bwd_tc<BWD_NT[2]>(q, k, v, mask, dout, stats, dq, dk, dv, N, S, st);
  return launch_bwd_tc<BWD_NT[3]>(q, k, v, mask, dout, stats, dq, dk, dv, N, S, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (D = 64). The tensor-core route (bf16,
// S <= 280) takes stats, caller-allocated (3, N, S) fp32 scratch, and
// leaves p and ds unused; the CUDA-core route (fp32, and bf16 past
// S = 280) takes p and ds, caller-allocated (N, S, S) scratch in the
// dtype, and leaves stats unused. mask may be null (no mask).
extern "C" int mvlpt_attend_bwd(int dtype, const void* q, const void* k, const void* v,
                                const void* mask, const void* dout, void* p, void* ds,
                                void* stats, void* dq, void* dk, void* dv, int N, int S, int D,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return attend_bwd_fma<float>(q, k, v, (const float*)mask, dout, p, ds, dq, dk, dv, N, S, D,
                                 st);
  if (dtype == 1)
    return attend_bwd_bf16(q, k, v, (const float*)mask, dout, p, ds, (float*)stats, dq, dk, dv,
                           N, S, D, st);
  return (int)cudaErrorInvalidValue;
}
