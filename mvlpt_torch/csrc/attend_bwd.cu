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
// change from run to run). Two routes, by dtype:
//
// bfloat16: tensor cores, mma.sync m16n8k16 (csrc/mma.cuh), D = 64,
//   S <= 280; no (N, S, S) tensor in device memory.
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
// float32: CUDA cores, fp32 FMAs (TF32 would not hold fp32's tolerance).
//   1. one block per (row, query tile) holds the row's K and V, recomputes
//      p, takes dp, ds and dq, and writes p and ds to (N, S, S) scratch;
//   2. one block per (row, key tile) holds the row's q and do and reads
//      p and ds by column for dv and dk.
//   Past the shared memory of one block (S above 278 at D = 64) it
//   refuses to launch.
//
// Bound: the function reads q, k, v, do and writes dq, dk, dv. At the
// image train shape (N = B*H = 384, S = 201, D = 64, bf16) that is
// 69.2 MB, 20.7 us at 3.35 TB/s, against 9.9 GFLOP (the recomputed
// scores and four products), 10.0 us at 989 TFLOP/s: bound by bytes. The
// tensor-core route moves q, k, v and do twice (one staging a launch)
// and 0.9 MB of statistics besides.
#include "common.cuh"
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

int attend_bwd_bf16(const void* q, const void* k, const void* v, const float* mask,
                    const void* dout, float* stats, void* dq, void* dk, void* dv, int N, int S,
                    int D, cudaStream_t st) {
  if (D != mma::D || S < 1 || stats == nullptr) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (S <= 8 * BWD_NT[0])
    return launch_bwd_tc<BWD_NT[0]>(q, k, v, mask, dout, stats, dq, dk, dv, N, S, st);
  if (S <= 8 * BWD_NT[1])
    return launch_bwd_tc<BWD_NT[1]>(q, k, v, mask, dout, stats, dq, dk, dv, N, S, st);
  if (S <= 8 * BWD_NT[2])
    return launch_bwd_tc<BWD_NT[2]>(q, k, v, mask, dout, stats, dq, dk, dv, N, S, st);
  if (S <= 8 * BWD_NT[3])
    return launch_bwd_tc<BWD_NT[3]>(q, k, v, mask, dout, stats, dq, dk, dv, N, S, st);
  return (int)cudaErrorInvalidValue;
}

// --------------------------------------------------- fp32, CUDA cores

constexpr int QT = 32;        // query rows per dq block
constexpr int KT = 32;        // key rows per dk/dv block
constexpr int THREADS = 256;  // 8 warps

size_t dq_smem(int S, int D) {
  return sizeof(float) * (2 * (size_t)S * (D + 1) + 2 * (size_t)QT * D + 2 * (size_t)QT * S);
}

size_t dkv_smem(int S, int D) {
  return sizeof(float) * (2 * (size_t)S * D + 2 * (size_t)KT * S);
}

// Per query row: p, dp, ds, dq; p and ds go to scratch.
__global__ void __launch_bounds__(THREADS)
attend_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              const float* __restrict__ dout, float* __restrict__ p_g, float* __restrict__ ds_g,
              float* __restrict__ dq, int S, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.y * QT;
  const size_t base = (size_t)blockIdx.x * S * D;
  float* Ks = smem;                // S x (D+1)
  float* Vs = Ks + S * (D + 1);    // S x (D+1)
  float* Qs = Vs + S * (D + 1);    // QT x D
  float* dOs = Qs + QT * D;        // QT x D
  float* Ps = dOs + QT * D;        // QT x S: scores, then probabilities
  float* DPs = Ps + QT * S;        // QT x S: dp, then ds

  for (int idx = threadIdx.x; idx < S * D; idx += THREADS) {
    const int j = idx / D, d = idx - j * D;
    Ks[j * (D + 1) + d] = k[base + idx];
    Vs[j * (D + 1) + d] = v[base + idx];
  }
  for (int idx = threadIdx.x; idx < QT * D; idx += THREADS) {
    const bool in = q0 + idx / D < S;
    const size_t g = base + (size_t)q0 * D + idx;
    Qs[idx] = in ? q[g] : 0.f;
    dOs[idx] = in ? dout[g] : 0.f;
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
      const float ds = __fmul_rn(p * (drow[j] - t), scale);
      drow[j] = ds;
      ds_g[prow_off + j] = ds;
      p_g[prow_off + j] = p;
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(drow[j], Ks[j * (D + 1) + d], acc);
      dq[base + (size_t)qi * D + d] = acc;
    }
  }
}

// Per key row k: dv = sum_q p[q,k] do[q], dk = sum_q ds[q,k] q[q].
__global__ void __launch_bounds__(THREADS)
attend_bwd_dkv(const float* __restrict__ q, const float* __restrict__ dout,
               const float* __restrict__ p_g, const float* __restrict__ ds_g,
               float* __restrict__ dk, float* __restrict__ dv, int S, int D) {
  extern __shared__ __align__(16) float smem[];
  const int k0 = blockIdx.y * KT;
  const size_t base = (size_t)blockIdx.x * S * D;
  float* Qs = smem;            // S x D
  float* dOs = Qs + S * D;     // S x D
  float* Pt = dOs + S * D;     // KT x S, p transposed
  float* DSt = Pt + KT * S;    // KT x S, ds transposed

  for (int idx = threadIdx.x; idx < S * D; idx += THREADS) {
    Qs[idx] = q[base + idx];
    dOs[idx] = dout[base + idx];
  }
  const size_t row_off = (size_t)blockIdx.x * S * S;
  for (int idx = threadIdx.x; idx < KT * S; idx += THREADS) {
    const int qi = idx / KT, kk = idx - qi * KT;
    const int kj = k0 + kk;
    const bool in = kj < S;
    Pt[kk * S + qi] = in ? p_g[row_off + (size_t)qi * S + kj] : 0.f;
    DSt[kk * S + qi] = in ? ds_g[row_off + (size_t)qi * S + kj] : 0.f;
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
      dk[base + (size_t)kj * D + d] = acck;
      dv[base + (size_t)kj * D + d] = accv;
    }
  }
}

int attend_bwd_f32(const void* q, const void* k, const void* v, const float* mask,
                   const void* dout, void* p, void* ds, void* dq, void* dk, void* dv, int N, int S,
                   int D, cudaStream_t st) {
  const size_t smem_q = dq_smem(S, D), smem_kv = dkv_smem(S, D);
  if (smem_q > kMaxDynSmem || smem_kv > kMaxDynSmem) return (int)cudaErrorInvalidConfiguration;
  if (p == nullptr || ds == nullptr) return (int)cudaErrorInvalidValue;
  MVLPT_TRY(cudaFuncSetAttribute(attend_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_q));
  MVLPT_TRY(cudaFuncSetAttribute(attend_bwd_dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_kv));
  attend_bwd_dq<<<dim3(N, (S + QT - 1) / QT), THREADS, smem_q, st>>>(
      (const float*)q, (const float*)k, (const float*)v, mask, (const float*)dout, (float*)p,
      (float*)ds, (float*)dq, S, D, (float)pow((double)D, -0.5));
  MVLPT_TRY(cudaGetLastError());
  attend_bwd_dkv<<<dim3(N, (S + KT - 1) / KT), THREADS, smem_kv, st>>>(
      (const float*)q, (const float*)dout, (const float*)p, (const float*)ds, (float*)dk,
      (float*)dv, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores; p and ds are caller-allocated (N, S, S)
// fp32 scratch, stats is unused), 1 = bfloat16 (tensor cores, D = 64,
// S <= 280; stats is caller-allocated (3, N, S) fp32 scratch, p and ds
// are unused). mask may be null (no mask).
extern "C" int mvlpt_attend_bwd(int dtype, const void* q, const void* k, const void* v,
                                const void* mask, const void* dout, void* p, void* ds,
                                void* stats, void* dq, void* dk, void* dv, int N, int S, int D,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return attend_bwd_f32(q, k, v, (const float*)mask, dout, p, ds, dq, dk, dv, N, S, D, st);
  if (dtype == 1)
    return attend_bwd_bf16(q, k, v, (const float*)mask, dout, (float*)stats, dq, dk, dv, N, S,
                           D, st);
  return (int)cudaErrorInvalidValue;
}
