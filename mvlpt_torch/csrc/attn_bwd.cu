// Attention half-block backward, dx only (the backbone is frozen).
//
// Replaces the Pallas kernel mvlpt_tpu/ops/block.py:_attn_bwd_kernel
// (called by _attn_bwd), with its rounding points:
//   do = T(gy Wout^T); dv = T(p^T do); dp = do v^T in fp32;
//   ds = T(p * (dp - sum_k dp * p) * scale); dq = T(ds k); dk = T(ds^T q);
//   dxh = [dq | dk | dv] Wqkv^T in fp32;
//   dx = T(gy + T(LayerNorm input cotangent of dxh)).
// p is the forward's rounded probabilities (its residual probs), so the
// mask needs no second reading: p is 0 wherever the mask took a key away.
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
// 3.35 TB/s): bound by operations, two thirds of them in the two
// products. At the text tower's packed rows (S=126, W=512, H=8; see
// attn_fwd.cu) about 3.8 GFLOP (3.9 us) against 17.5 MB (5.2 us): bound
// by bytes, most of them the probabilities.
//
// Five launches: the do product; a dq launch and a dk/dv launch for the
// attention core; the dxh product; the LayerNorm backward rows. They
// take two routes by dtype (ops/block.ATTN_BWD_ROUTES):
//   bf16, tensor cores: both products on wgmma.cuh's GEMM with the
//     weights read K-major where they lie (Wout (Wl, W) as the (N, K) B
//     of do through the EPI_ROUND epilogue, Wqkv (W, 3 Wl) as that of dxh
//     through EPI_F32); the core on mma.sync (namespace tc below), whose
//     only scratch is t = rowsum(dp p), a (B, H, S) fp32 tensor. D = 64.
//   fp32, CUDA cores: common.cuh's GEMM, and a core that writes ds to a
//     (B, H, S, S) scratch in the dq launch and reads it by column in the
//     dk/dv launch (namespace cuda_cores below), every product summed in
//     order with fp32 FMAs (TF32 would not hold fp32's tolerance).
// bf16 at the shapes the tensor cores' route does not take (D other than
// 64, W or Wl off the multiples of 64) takes the CUDA cores' route on bf16
// operands (ops/block.BF16_CUDA_CORES): the same GEMM and core, ds
// rounded to bf16 before it is kept, dq, dk and dv rounded as they are
// stored.
// Neither core uses atomics: results do not change from run to run.
#include <type_traits>

#include "common.cuh"
#include "fma_attn.cuh"
#include "mma.cuh"
#include "stamp.cuh"
#include "wgmma.cuh"

using namespace mvlpt;

namespace {

// ------------------------------------------ bf16 attention core, mma.sync
//
// Over (batch*head) rows read in place: q, k, v from qkv (B, S, 3 Wl) at
// columns h D, Wl + h D, 2 Wl + h D (row stride 3 Wl), do from (B, S, Wl)
// at h D, p from probs (B, H, S, S); dq, dk, dv written into dqkv, laid
// out as qkv. Two launches, each one block of WARPS warps per (batch*head)
// row and share of its 16-row groups (mma::row_shares), as attn_fwd.cu's
// core; each stages its B operands in shared-memory windows of up to KW
// rows, so there is no S ceiling. The m16n8k16 fragment layouts are
// mma.cuh's.
//   dq launch: a warp takes 16 queries, do in A fragments; K and V staged.
//     Pass 1 (V only): dp = do v^T a key tile at a time, and t = rowsum(dp
//       p).
//     Pass 2 (K and V): dp again, ds = T(p (dp - t) scale), packed from
//       the accumulators into the A fragments of dq += ds k.
//     It writes dq, and t to its (B, H, S) scratch.
//   dk/dv launch: a warp takes 16 keys, v in A fragments; Q, dO and t
//     staged. It walks the queries 16 at a time: dp^T = v do^T; p^T (bf16
//     already, so it is the A fragment of dv += p^T do exactly); ds^T =
//     T(p^T (dp^T - t) scale); dk += ds^T q, with q the B operand through
//     ldmatrix.trans.
// p goes through a warp's own staging tile in shared memory. A probs row
// of odd S is only 2-byte aligned, so it is read a bf16 value a lane, but
// each load of the warp covers neighbouring keys of one row (32 in the dq
// launch, 16 in each of two rows in the dk/dv launch) rather than pairs of
// keys in 8 rows; ldmatrix then reads the tile back as p's A fragment
// (transposed, p^T's), whose registers unpack into the C tiles that meet
// dp. The dq launch loads the next chunk's p while it works on this one's.
// dp is computed in both launches, so ds may round one ulp apart between
// dq and dk, as in attend_bwd.cu. Rows and keys at or past S are zero in
// every operand (staged zero, p read as 0) and are never stored.
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int KC = 32;           // keys a chunk of the dq launch: four dp tiles
constexpr int QROW = KC + 8;     // a warp's p staging row in the dq launch, bf16 (80 bytes)
constexpr int KROW = 16 + 8;     // in the dk/dv launch (48 bytes)
constexpr float SCALE = 0.125f;  // 64^-1/2
// Rows a window: with the staging tiles, 224 leaves shared memory for
// three blocks an SM (69,632 bytes a dq block), where 256 would leave it
// for two (78,848).
constexpr int KW = 224;

// The dq launch: K and V windows, the warps' p staging. The dk/dv launch:
// Q and dO windows, the warps' p staging, the window's t.
inline size_t smem_dq(int kw) {
  return sizeof(bf16) * (2 * (size_t)kw * mma::ROW + (size_t)WARPS * 16 * QROW);
}
inline size_t smem_dkv(int kw) {
  return sizeof(bf16) * (2 * (size_t)kw * mma::ROW + (size_t)WARPS * 16 * KROW) +
         sizeof(float) * (size_t)kw;
}

// The two bf16 values of a fragment register as floats: the first
// (lower address) in lo.
__device__ __forceinline__ void unpack(float& lo, float& hi, uint32_t u) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

// The C tiles lo (columns 0-7) and hi (8-15) held by an A fragment.
__device__ __forceinline__ void unpack_a(float (&lo)[4], float (&hi)[4], const uint32_t (&a)[4]) {
  unpack(lo[0], lo[1], a[0]);
  unpack(lo[2], lo[3], a[1]);
  unpack(hi[0], hi[1], a[2]);
  unpack(hi[2], hi[3], a[3]);
}

// The dq launch's p, rows r0..r0+15 of a (S, S) probs block at keys
// key0 + lane: one value a row, each load of the warp 32 neighbouring
// keys of a row; 0 at or past S.
__device__ __forceinline__ void load_p_rows(unsigned short (&v)[16], const bf16* pb, int r0,
                                            int key0, int S, int lane) {
  const int k = key0 + lane;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(pb) + (size_t)r0 * S + k;
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = k < S && r0 + r < S ? __ldg(src + (size_t)r * S) : 0;
}

// The dk/dv launch's p, rows r0..r0+15 at keys k0..k0+15: lane l takes
// key k0 + l % 16 of rows r0 + l / 16 + 2 i.
__device__ __forceinline__ void load_p_cols(unsigned short (&v)[8], const bf16* pb, int r0, int k0,
                                            int S, int lane) {
  const int k = k0 + (lane & 15), r1 = r0 + (lane >> 4);
  const unsigned short* src = reinterpret_cast<const unsigned short*>(pb) + (size_t)r1 * S + k;
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = k < S && r1 + 2 * i < S ? __ldg(src + (size_t)2 * i * S) : 0;
}

__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ probs,
               const bf16* __restrict__ dout, float* __restrict__ t_g, bf16* __restrict__ dqkv,
               int S, int H, int Wl, int kw) {
  using namespace mvlpt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kw * ROW;
  bf16* ps = Vs + kw * ROW + warp * 16 * QROW;  // this warp's p staging
  unsigned short* ps16 = reinterpret_cast<unsigned short*>(ps);
  const int ld = 3 * Wl;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const bf16* k = qkv + (size_t)b * S * ld + Wl + h * D;
  const bf16* v = k + Wl;
  const bf16* dob = dout + (size_t)b * S * Wl + h * D;
  bf16* dq = dqkv + (size_t)b * S * ld + h * D;
  const bf16* pb = probs + (size_t)bh * S * S;
  float* tb = t_g + (size_t)bh * S;
  const int nwin = (S + kw - 1) / kw, groups = (S + 15) / 16;

  // Keys [k0, k0 + kw) of V (and K) into shared memory, zero past S up to
  // a whole chunk; every thread of the block takes part.
  auto stage = [&](int k0, bool with_k) {
    const int n = min(kw, S - k0), rows = (n + KC - 1) / KC * KC;
    stage_rows(Vs, v + (size_t)k0 * ld, n, rows, threadIdx.x, THREADS, ld);
    if (with_k) stage_rows(Ks, k + (size_t)k0 * ld, n, rows, threadIdx.x, THREADS, ld);
    cp_async_wait();
    __syncthreads();
  };
  if (nwin == 1) stage(0, true);

  // One pass over the window's keys [k0, k0 + n), a chunk of KC at a time:
  // the chunk's p goes through the warp's staging tile, the next chunk's
  // loads in flight meanwhile, and f(c0, pa) gets its two 16-key halves
  // as A fragments (pa[hf]: keys c0 + 16 hf..).
  auto walk = [&](int q0, int k0, int n, auto&& f) {
    unsigned short pv[16];
    load_p_rows(pv, pb, q0, k0, S, lane);
    for (int c0 = 0; c0 < n; c0 += KC) {
      __syncwarp();  // the last chunk's fragments are read
#pragma unroll
      for (int r = 0; r < 16; ++r) ps16[r * QROW + lane] = pv[r];
      if (c0 + KC < n) load_p_rows(pv, pb, q0, k0 + c0 + KC, S, lane);
      __syncwarp();
      uint32_t pa[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) ldsm_x4(pa[hf], frag_rows16(ps, 0, 16 * hf, lane, QROW));
      f(c0, pa);
    }
  };

  // The loop runs alike in every warp of the block, so the windows'
  // barriers meet; a warp past the last group idles through them.
  for (int base = blockIdx.y * WARPS; base < groups; base += gridDim.y * WARPS) {
    const int q0 = (base + warp) * 16;
    const bool active = q0 < S;
    uint32_t da[D / 16][4];
    load_a_rows(da, dob, q0, S, lane, Wl);

    // Pass 1: t = rowsum(dp p), per lane over its columns, rows g (index
    // 0) and g + 8 (1).
    float t[2] = {0.f, 0.f};
    for (int w = 0; w < nwin; ++w) {
      const int k0 = w * kw, n = min(kw, S - k0);
      if (nwin > 1) {
        __syncthreads();  // every warp is done with the last window
        stage(k0, false);
      }
      if (!active) continue;
      walk(q0, k0, n, [&](int c0, const uint32_t (&pa)[2][4]) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float p[2][4], dp[2][4];
          unpack_a(p[0], p[1], pa[hf]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            row_tile(dp[j], da, Vs, c0 / 8 + 2 * hf + j, lane);
#pragma unroll
            for (int e = 0; e < 4; ++e) t[e >> 1] += dp[j][e] * p[j][e];
          }
        }
      });
    }
    t[0] = quad_sum(t[0]);
    t[1] = quad_sum(t[1]);

    // Pass 2: ds, 16 keys (one k step of ds k) at a time.
    float acc[D / 8][4] = {};
    for (int w = 0; w < nwin; ++w) {
      const int k0 = w * kw, n = min(kw, S - k0);
      if (nwin > 1) {
        __syncthreads();
        stage(k0, true);
      }
      if (!active) continue;
      walk(q0, k0, n, [&](int c0, const uint32_t (&pa)[2][4]) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float ds[2][4];
          unpack_a(ds[0], ds[1], pa[hf]);  // p, then ds in place
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float dp[4];
            row_tile(dp, da, Vs, c0 / 8 + 2 * hf + j, lane);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ds[j][e] = __fmul_rn(__fmul_rn(ds[j][e], dp[e] - t[e >> 1]), SCALE);
          }
          uint32_t dsa[4];
          pack_a(dsa, ds[0], ds[1]);
          acc_rows16(acc, dsa, Ks, c0 + 16 * hf, lane);
        }
      });
    }
    if (!active) continue;
    store_rows(dq, acc, q0, S, lane, ld);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (q0 + g + 8 * i < S) tb[q0 + g + 8 * i] = t[i];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
attn_bwd_dkv_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ probs,
                const bf16* __restrict__ dout, const float* __restrict__ t_g,
                bf16* __restrict__ dqkv, int S, int H, int Wl, int qw) {
  using namespace mvlpt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (lane & 3) * 2;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + qw * ROW;
  bf16* ps = dOs + qw * ROW + warp * 16 * KROW;  // this warp's p staging
  unsigned short* ps16 = reinterpret_cast<unsigned short*>(ps);
  float* ts = reinterpret_cast<float*>(dOs + qw * ROW + WARPS * 16 * KROW);
  const int ld = 3 * Wl;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const bf16* q = qkv + (size_t)b * S * ld + h * D;
  const bf16* v = q + 2 * Wl;
  const bf16* dob = dout + (size_t)b * S * Wl + h * D;
  bf16* dk = dqkv + (size_t)b * S * ld + Wl + h * D;
  bf16* dv = dk + Wl;
  const bf16* pb = probs + (size_t)bh * S * S;
  const float* tb = t_g + (size_t)bh * S;
  const int nwin = (S + qw - 1) / qw, groups = (S + 15) / 16;
  // ldmatrix.trans of the staged 16 x 16 p (rows queries, columns keys):
  // matrix l / 8 of lane l is queries 8 (l / 16).., keys 8 (l / 8 % 2)..,
  // so the four registers are the A fragment of p^T (rows keys).
  const int trow = ((lane >> 4) * 8 + (lane & 7)) * KROW + ((lane >> 3) & 1) * 8;

  // Queries [q0, q0 + qw) of Q, dO and t into shared memory, zero past S
  // up to a whole chunk.
  auto stage = [&](int q0) {
    const int n = min(qw, S - q0), rows = (n + KC - 1) / KC * KC;
    stage_rows(Qs, q + (size_t)q0 * ld, n, rows, threadIdx.x, THREADS, ld);
    stage_rows(dOs, dob + (size_t)q0 * Wl, n, rows, threadIdx.x, THREADS, Wl);
    for (int i = threadIdx.x; i < rows; i += THREADS) ts[i] = i < n ? tb[q0 + i] : 0.f;
    cp_async_wait();
    __syncthreads();
  };
  if (nwin == 1) stage(0);

  for (int base = blockIdx.y * WARPS; base < groups; base += gridDim.y * WARPS) {
    const int k0 = (base + warp) * 16;
    const bool active = k0 < S;
    uint32_t va[D / 16][4];
    load_a_rows(va, v, k0, S, lane, ld);
    float dka[D / 8][4] = {}, dva[D / 8][4] = {};
    for (int w = 0; w < nwin; ++w) {
      const int q0 = w * qw, n = min(qw, S - q0);
      if (nwin > 1) {
        __syncthreads();
        stage(q0);
      }
      if (!active) continue;
#pragma unroll 1
      for (int qc = 0; qc < n; qc += 16) {
        // p of queries q0 + qc.. through the staging tile.
        unsigned short pv[8];
        load_p_cols(pv, pb, q0 + qc, k0, S, lane);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 8; ++i) ps16[(2 * i + (lane >> 4)) * KROW + (lane & 15)] = pv[i];
        __syncwarp();
        uint32_t pa[4];  // p^T of these keys (rows) against the 16 queries
        ldsm_x4_t(pa, ps + trow);
        acc_rows16(dva, pa, dOs, qc, lane);
        // ds^T against queries qc + 8 hf + c + e % 2, from p^T as C tiles.
        float ds[2][4];
        unpack_a(ds[0], ds[1], pa);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float dpt[4];
          row_tile(dpt, va, dOs, qc / 8 + hf, lane);  // dp^T = v do^T
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float tq = ts[qc + 8 * hf + c + (e & 1)];
            ds[hf][e] = __fmul_rn(__fmul_rn(ds[hf][e], dpt[e] - tq), SCALE);
          }
        }
        pack_a(pa, ds[0], ds[1]);
        acc_rows16(dka, pa, Qs, qc, lane);
      }
    }
    if (!active) continue;
    store_rows(dk, dka, k0, S, lane, ld);
    store_rows(dv, dva, k0, S, lane, ld);
  }
}

// The shared-memory attributes are set once, for the largest window, and
// the SM count read once: both hold for the process (one card a process),
// and the launches then make no runtime call but their own.
int launch(const void* qkv, const void* probs, const void* dout, float* t, void* dqkv, int B,
           int S, int H, int Wl, cudaStream_t st) {
  static bool smem_set = false;
  static int sms = 0;
  if (!smem_set) {
    MVLPT_TRY(cudaFuncSetAttribute(attn_bwd_dq_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_dq(KW)));
    MVLPT_TRY(cudaFuncSetAttribute(attn_bwd_dkv_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_dkv(KW)));
    smem_set = true;
  }
  if (sms == 0) MVLPT_TRY(mma::sm_count(&sms));
  const int kw = mma::window(S, KW);
  const dim3 grid(B * H, mma::row_shares(B * H, S, WARPS, sms));
  attn_bwd_dq_tc<<<grid, THREADS, smem_dq(kw), st>>>((const bf16*)qkv, (const bf16*)probs,
                                                      (const bf16*)dout, t, (bf16*)dqkv, S, H,
                                                      Wl, kw);
  MVLPT_TRY(cudaGetLastError());
  attn_bwd_dkv_tc<<<grid, THREADS, smem_dkv(kw), st>>>((const bf16*)qkv, (const bf16*)probs,
                                                        (const bf16*)dout, t, (bf16*)dqkv, S, H,
                                                        Wl, kw);
  return (int)cudaGetLastError();
}

}  // namespace tc

// --------------------------------------- CUDA-core attention core, FMAs
//
// In T (fp32, or bf16 off the tensor cores' shapes): operands read and
// widened to fp32, every sum in fp32, ds rounded to T in the (B, H, S, S)
// fp32 scratch, dq, dk and dv rounded to T as they are stored.
//
// The dq launch, one block per (query tile, head, image), writes ds to a
// (B, H, S, S) scratch; the dk/dv launch, one block per (key tile, head,
// image), reads p and ds by column. Both pass their operand rows through
// shared memory in fixed-size chunks (k and v by key chunks for dq; q and
// do by query chunks for dk/dv), so shared memory does not grow as S x D;
// the dq kernel keeps each query row's S-long dp/ds row and takes fewer
// query rows a block as S grows (fma_attn.cuh's fma_rows), so it takes
// any S whose one row fits a block (about 24,900 at D = 64).
namespace cuda_cores {

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
            float* __restrict__ ds_g, T* __restrict__ dqkv, int S, int H, int D, float scale,
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

  // ds = p (dp - rowsum(dp p)) scale over each whole row.
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
      const float ds = rnd<T>(to_f(pg[j]) * (drow[j] - t) * scale);
      drow[j] = ds;
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

// Per key row k: dv = sum_q p[q,k] do[q], dk = sum_q ds[q,k] q[q], the
// queries a chunk of FMA_KC at a time.
template <typename T>
__global__ void __launch_bounds__(FMA_THREADS)
attn_bwd_dkv(const T* __restrict__ qkv, const T* __restrict__ probs,
             const float* __restrict__ ds_g, const T* __restrict__ dout, T* __restrict__ dqkv,
             int S, int H, int D) {
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
      DSt[kk * PT + q] = in ? ds_g[g] : 0.f;
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

// The shared-memory attributes are set once for each T, to a block's
// most, so a launch makes no runtime call but its own.
template <typename T>
int launch(const void* qkv, const void* probs, const void* dout, float* ds, void* dqkv, int B,
           int S, int H, int D, cudaStream_t st) {
  static bool smem_set = false;
  const int qt = fma_rows(dq_fixed(D), dq_row(S, D));
  if (qt < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t smem_q = sizeof(float) * (dq_fixed(D) + (size_t)qt * dq_row(S, D));
  const size_t smem_kv = sizeof(float) * dkv_words(D);
  if (smem_kv > kMaxDynSmem) return (int)cudaErrorInvalidConfiguration;
  if (!smem_set) {
    MVLPT_TRY(cudaFuncSetAttribute(attn_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kMaxDynSmem));
    MVLPT_TRY(cudaFuncSetAttribute(attn_bwd_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kMaxDynSmem));
    smem_set = true;
  }
  attn_bwd_dq<T><<<dim3((S + qt - 1) / qt, H, B), FMA_THREADS, smem_q, st>>>(
      (const T*)qkv, (const T*)probs, (const T*)dout, ds, (T*)dqkv, S, H, D,
      (float)pow((double)D, -0.5), qt);
  MVLPT_TRY(cudaGetLastError());
  attn_bwd_dkv<T><<<dim3((S + KT - 1) / KT, H, B), FMA_THREADS, smem_kv, st>>>(
      (const T*)qkv, (const T*)probs, ds, (const T*)dout, (T*)dqkv, S, H, D);
  return (int)cudaGetLastError();
}

}  // namespace cuda_cores

// ------------------------------------------------------- the half-block

// H heads of D each (Wl = H D); gy and dxh are over the model width W.
// scratch: the tensor cores' route's (B, H, S) fp32 t, or the CUDA
// cores' (B, H, S, S) fp32 ds. part: stop at the fp32 dxh (no LayerNorm
// backward, x/mu/rstd unused). tensor_cores: that route (bf16 only).
// marks: stamped right before and after the core, its dq and dkv kernels
// (a null table: none).
template <typename T, bool tensor_cores = std::is_same_v<T, __nv_bfloat16>>
int attn_bwd_impl(const void* x, const float* mu, const float* rstd, const void* qkv,
                  const void* probs, const void* ln_scale, const void* qkv_w, const void* out_w,
                  const void* gy, void* dout, void* scratch, void* dqkv, float* dxh, void* dx,
                  int B, int S, int W, int H, int D, bool part, const Marks& marks,
                  cudaStream_t st) {
  if (tensor_cores && D != mma::D) return (int)cudaErrorInvalidValue;  // the wrappers route first
  const int M = B * S, Wl = H * D;
  // do[m, i] = sum_n gy[m, n] Wout[i, n]: Wout is (Wl, W), read K-major.
  MVLPT_TRY((wg::gemm<T, EPI_ROUND, true, tensor_cores>(
      gy, out_w, M, Wl, W, EpiArgs{nullptr, nullptr, nullptr, dout, nullptr}, st)));
  MVLPT_TRY(mark(marks, 0, st));
  const int rc =
      tensor_cores ? tc::launch(qkv, probs, dout, (float*)scratch, dqkv, B, S, H, Wl, st)
                   : cuda_cores::launch<T>(qkv, probs, dout, (float*)scratch, dqkv, B, S, H, D,
                                           st);
  if (rc != 0) return rc;
  MVLPT_TRY(mark(marks, 1, st));
  // dxh[m, n] = sum_k dqkv[m, k] Wqkv[n, k]: Wqkv is (W, 3Wl), read K-major.
  MVLPT_TRY((wg::gemm<T, EPI_F32, true, tensor_cores>(
      dqkv, qkv_w, M, W, 3 * Wl, EpiArgs{nullptr, nullptr, nullptr, dxh, nullptr}, st)));
  if (!part) MVLPT_TRY(launch_ln_bwd<T>(x, mu, rstd, ln_scale, dxh, gy, dx, M, W, st));
  return 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores, D = 64),
// 2 = bfloat16 (CUDA cores, any D). dout (M, W) and dqkv (M, 3W) in the
// dtype, and dxh (M, W, fp32), are caller-allocated scratch, and so is
// scratch: (B, H, S) fp32 on the tensor cores, (B, H, S, S) fp32 on the
// CUDA cores. mark_*: the core's marks (stamp.cuh's Marks; a null
// mark_table: none).
extern "C" int mvlpt_attn_bwd(int dtype, const void* x, const void* mu, const void* rstd,
                              const void* qkv, const void* probs, const void* ln_scale,
                              const void* qkv_w, const void* out_w, const void* gy, void* dout,
                              void* scratch, void* dqkv, void* dxh, void* dx, int B, int S,
                              int W, int H, void* mark_table, const void* mark_row,
                              int mark_width, int mark_col, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int D = W / H;
  const Marks marks{(long long*)mark_table, (const long long*)mark_row, mark_width, mark_col};
  if (dtype == 0)
    return attn_bwd_impl<float>(x, (const float*)mu, (const float*)rstd, qkv, probs, ln_scale,
                                qkv_w, out_w, gy, dout, scratch, dqkv, (float*)dxh, dx, B, S, W,
                                H, D, false, marks, st);
  if (dtype == 1)
    return attn_bwd_impl<__nv_bfloat16>(x, (const float*)mu, (const float*)rstd, qkv, probs,
                                        ln_scale, qkv_w, out_w, gy, dout, scratch, dqkv,
                                        (float*)dxh, dx, B, S, W, H, D, false, marks, st);
  if (dtype == 2)
    return attn_bwd_impl<__nv_bfloat16, false>(x, (const float*)mu, (const float*)rstd, qkv,
                                               probs, ln_scale, qkv_w, out_w, gy, dout, scratch,
                                               dqkv, (float*)dxh, dx, B, S, W, H, D, false, marks,
                                               st);
  return (int)cudaErrorInvalidValue;
}

// Tensor-parallel part: H local heads of D each; qkv (B, S, 3HD), probs
// (B, H, S, S), qkv_w (W, 3HD), out_w (HD, W), gy (B, S, W) -> the fp32
// partial dxh (B, S, W). dout (B, S, HD), dqkv (B, S, 3HD) and scratch
// (as mvlpt_attn_bwd's) are caller-allocated scratch.
extern "C" int mvlpt_attn_bwd_part(int dtype, const void* qkv, const void* probs,
                                   const void* qkv_w, const void* out_w, const void* gy,
                                   void* dout, void* scratch, void* dqkv, void* dxh, int B, int S,
                                   int W, int H, int D, void* mark_table,
                                   const void* mark_row, int mark_width, int mark_col,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Marks marks{(long long*)mark_table, (const long long*)mark_row, mark_width, mark_col};
  if (dtype == 0)
    return attn_bwd_impl<float>(nullptr, nullptr, nullptr, qkv, probs, nullptr, qkv_w, out_w, gy,
                                dout, scratch, dqkv, (float*)dxh, nullptr, B, S, W, H, D, true,
                                marks, st);
  if (dtype == 1)
    return attn_bwd_impl<__nv_bfloat16>(nullptr, nullptr, nullptr, qkv, probs, nullptr, qkv_w,
                                        out_w, gy, dout, scratch, dqkv, (float*)dxh, nullptr, B,
                                        S, W, H, D, true, marks, st);
  if (dtype == 2)
    return attn_bwd_impl<__nv_bfloat16, false>(nullptr, nullptr, nullptr, qkv, probs, nullptr,
                                               qkv_w, out_w, gy, dout, scratch, dqkv,
                                               (float*)dxh, nullptr, B, S, W, H, D, true, marks,
                                               st);
  return (int)cudaErrorInvalidValue;
}
