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
//     through the EPI_BIAS epilogue), the core on mma.sync: rows of up
//     to 256 keys in one pass over a row held whole on the chip
//     (res::attn_core_res), longer ones in two passes over windows of
//     keys (core::attn_core_tc). D = 64 only.
//   fp32, CUDA cores: common.cuh's GEMM and fma_attn.cuh's core, every
//     product summed in order with fp32 FMAs (TF32 would not hold fp32's
//     tolerance).
// bf16 at the shapes the tensor cores' route does not take (D other than
// 64, W or Wl off the multiples of 64: the soak's 32-wide text tower, the
// 4-head towers of tests/test_bf16_drift.py) takes the CUDA cores' route
// on bf16 operands (ops/block.BF16_CUDA_CORES), at the same rounding
// points.
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
// never stored. Shared memory does not grow with S: no S ceiling. It takes
// the rows of more than res::MAX_KEYS keys (launch_core); res's one-pass
// core, below, the shorter ones.
namespace core {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int KC = 32;          // keys a chunk: four score tiles, two k steps of p v
using mma::KW_MAX;              // keys a window of K and V in shared memory (mma::window)
constexpr int PROW = KC + 8;    // a warp's probs staging row, in bf16 (80 bytes: no bank conflict)
constexpr float SCALE = 0.125f;  // 64^-1/2

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
  const int kw = mma::window(S);
  attn_core_tc<PROBS><<<dim3(B * H, mma::row_shares(B * H, S, WARPS, sms)), THREADS,
                        smem_bytes(kw, PROBS), st>>>((const bf16*)qkv, mask, (bf16*)o,
                                                     (bf16*)probs, S, H, Wl, kw);
  return (int)cudaGetLastError();
}

}  // namespace core

// ------------------------------ bf16 attention core, one pass, S <= 256
//
// The same function as core::attn_core_tc, for rows of at most MAX_KEYS
// keys, which fit whole on the chip: each score is formed and
// exponentiated once. A block of warps_of<NT> warps takes one
// (batch*head) row (or a share of its 16-query groups, where the rows
// are too few to fill the card) and brings its K and V into shared
// memory once, by two TMA boxes of keys<NT> rows (a tensor map over qkv
// as (B, S, 3 Wl), so the keys past S, up to the box, are zeros, never
// the next image's rows; 128-byte rows in the 128-byte swizzle, no
// skew), each on its own mbarrier: the scores start when K has landed
// while V is still on its way. Each warp then walks its groups:
//   s = fl(q k^T * 0.125) + mask, in fp32 on the tensor cores (mma.sync
//     m16n8k16), the 16 x 8 NT strip held in registers; keys at or past
//     S -inf, the mask read once a score;
//   the row's exact max (the lane's, then the four lanes' of a row);
//   e = expf(s - max) in place; sum = the fp32 sum of e (lanes, then the
//     four lanes');
//   p = T(div_rn(e, sum)) (mma::div_rn, the IEEE-rounded divide), packed
//     straight into the A fragments of p v, whose fp32 sum gives o = T(p v);
//   with PROBS, p through the warp's staging area in shared memory, 8 query
//     rows at a time: the span of 8 S values those rows take in probs
//     (B, H, S, S) is contiguous, so it goes out in 16-byte stores, with
//     2-byte stores only at its two unaligned ends. The layout stays (S a
//     row), as attn_bwd.cu reads it.
// The next group's q is read while this one's softmax and p v run. Query
// rows past S are computed on zero q and never stored. The rounding points
// are core::attn_core_tc's: only the order of the sum differs.
//
// Bound at (B, S) = (32, 201) with probs: 29.6 MB of qkv read, 31 MB of
// probs and 9.9 MB of o written, 21 us at 3.35 TB/s, against 4 GFLOP of
// products (4 us); at (100, 201) without probs 123.5 MB, 37 us. Past the
// bytes, each score's exponential, divide and rounding (about 16
// instructions) and the latency of a strip's products bound it; three
// blocks an SM (the strip's registers) hide what they can.
//
// Why a second kernel: a row whose keys do not fit in registers cannot
// have its exact max before its exponentials, so rows past MAX_KEYS keep
// the two-pass windowed core (no S ceiling). launch_core picks by S alone.
namespace res {

using bf16 = __nv_bfloat16;
// Keys a row may have on this route: ops/block.py's RESIDENT_KEYS holds
// the same number for the launch counters.
constexpr int MAX_KEYS = 256;
// Key tiles of 8 a kernel holds (its S bucket: S <= 8 NT). The text rows
// (s = 70, 77 and the packed 126), the image rows (197, 201, 213) and the
// switch at 256 each fall in a bucket with little padding.
constexpr int BUCKETS[] = {9, 10, 16, 26, 27, 32};
constexpr float SCALE = 0.125f;  // 64^-1/2
constexpr int ROW_BYTES = mma::D * 2;  // a key's 64 bf16: one 128-byte swizzle row
// In the buckets past 128 keys ptxas would move every K tile's loads (and
// every p v step's) ahead of the products, each load holding four
// registers, and spill. There each K tile's loads from the DEPTH_K-th on
// wait for the product DEPTH_K tiles back, and each p v step's from the
// DEPTH_V-th on for one of the step before (zero_after). The shorter
// strips leave ptxas registers enough without.
template <int NT>
__host__ __device__ constexpr bool chained() { return NT > 16; }
constexpr int DEPTH_K = 6, DEPTH_V = 3;

// Keys staged: whole 16-key steps of p v, the ones past S zero.
template <int NT>
__host__ __device__ constexpr int keys() { return 16 * ((NT + 1) / 2); }
// Warps a block: a query group each where a row has 5 or fewer (S <= 80),
// else four walking the groups.
template <int NT>
__host__ __device__ constexpr int warps_of() { return NT <= 10 ? 5 : 4; }
// Blocks an SM is to hold: three, so that 12 or 15 warps an SM hide each
// other's latencies. That caps a thread's registers at 128 (4 warps on a
// quarter of the SM) for five warps a block and at 168 for four; the
// 256-key strip takes 255 at two blocks.
template <int NT>
__host__ __device__ constexpr int min_blocks() { return NT > 28 ? 2 : 3; }
// A warp's probs staging: 8 query rows of at most keys() values, offset
// by the span's misalignment (at most 7 values).
template <int NT>
__host__ __device__ constexpr int stage_elems() { return 8 * keys<NT>() + 8; }
template <int NT, bool PROBS>
__host__ __device__ constexpr int warp_bytes() { return PROBS ? stage_elems<NT>() * 2 : 0; }

template <int NT, bool PROBS>
constexpr size_t smem_bytes() {
  return 1024 /* swizzle-atom alignment */ + 2 * (size_t)keys<NT>() * ROW_BYTES +
         (size_t)warps_of<NT>() * warp_bytes<NT, PROBS>() + 16;
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The box at (c0 innermost, c1, c2) of a 3-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 0, from a value ptxas cannot see is 0: |x| clamped to [0, 1] (NaN to 1),
// times 0. Added to a shared-memory address, it makes a load wait for x,
// which bounds how far ptxas moves the strip's loads ahead of its
// products (each load moved ahead holds its four registers; with all of
// them ahead, the strip's registers run out).
__device__ __forceinline__ uint32_t zero_after(float x) {
  return __float_as_uint(fminf(fabsf(x), 1.f) * 0.f);
}

// The 16-byte chunk ch of row r of a swizzled tile at t: TMA's 128-byte
// swizzle puts it at chunk ch ^ (r % 8) of the row.
__device__ __forceinline__ uint32_t sw_chunk(uint32_t t, int r, int ch) {
  return t + r * ROW_BYTES + ((ch ^ (r & 7)) << 4);
}

// The C tile of the 16 queries (A fragments a) against keys 8j..8j+7 of
// the swizzled K tile at ks: fp32, summed over D (mma.cuh's row_tile).
__device__ __forceinline__ void key_tile(float (&acc)[4], const uint32_t (&a)[mma::D / 16][4],
                                         uint32_t ks, int j, int lane) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  const int r = 8 * j + (lane & 7);
#pragma unroll
  for (int h = 0; h < mma::D / 32; ++h) {
    uint32_t b[4];
    ldsm4(b, sw_chunk(ks, r, 4 * h + (lane >> 3)));
    mma::mma_bf16(acc, a[2 * h], b[0], b[1]);
    mma::mma_bf16(acc, a[2 * h + 1], b[2], b[3]);
  }
}

// acc[n] += a v over keys r0..r0+15 of the swizzled V tile at vs
// (mma.cuh's acc_rows16).
__device__ __forceinline__ void pv_step(float (&acc)[mma::D / 8][4], const uint32_t (&a)[4],
                                        uint32_t vs, int r0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nd = 0; nd < mma::D / 16; ++nd) {
    uint32_t b[4];
    ldsm4_t(b, sw_chunk(vs, r, 2 * nd + (lane >> 4)));
    mma::mma_bf16(acc[2 * nd], a, b[0], b[1]);
    mma::mma_bf16(acc[2 * nd + 1], a, b[2], b[3]);
  }
}

// mma.cuh's load_a_rows and store_rows over one head's rows of qkv and o,
// each lane's offset from the block's base taken in 32 bits: the offsets
// stay below S x 3 Wl, and no lane then holds a 64-bit address across the
// loop over its groups (beside a 26-tile strip ptxas has no register for it).
__device__ __forceinline__ void q_frags(uint32_t (&a)[mma::D / 16][4], const bf16* src, int r0,
                                        int n, int lane, int ld) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  const bool in0 = r0 + g < n, in1 = r0 + g + 8 < n;
  const uint32_t* row0 = reinterpret_cast<const uint32_t*>(src + (uint32_t)((r0 + g) * ld + c));
  const uint32_t* row1 =
      reinterpret_cast<const uint32_t*>(src + (uint32_t)((r0 + g + 8) * ld + c));
#pragma unroll
  for (int kc = 0; kc < mma::D / 16; ++kc) {
    a[kc][0] = in0 ? row0[kc * 8] : 0u;
    a[kc][1] = in1 ? row1[kc * 8] : 0u;
    a[kc][2] = in0 ? row0[kc * 8 + 4] : 0u;
    a[kc][3] = in1 ? row1[kc * 8 + 4] : 0u;
  }
}

__device__ __forceinline__ void o_rows(bf16* dst, const float (&acc)[mma::D / 8][4], int r0,
                                       int n, int lane, int ld) {
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= n) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + (uint32_t)(r * ld + c));
#pragma unroll
    for (int t = 0; t < mma::D / 8; ++t)
      out[4 * t] = mma::pack_bf16(acc[t][2 * h], acc[t][2 * h + 1]);
  }
}

// Query rows q0 + 8 hf .. (at most 8, none at or past S) of p into probs
// (pb: this (batch*head) row's S x S block) through the warp's staging
// area ps: p's half hf of each A fragment (a[0], a[2] hold row g, a[1],
// a[3] row g + 8) goes to ps at lead + row * S + key, lead being the
// span's offset (in values) past a 16-byte boundary, so that the span's
// aligned 8-value chunks lie on 16-byte boundaries in ps too.
template <int NT>
__device__ __forceinline__ void store_probs(bf16* pb, bf16* ps,
                                            const uint32_t (&pa)[(NT + 1) / 2][4], int q0,
                                            int hf, int S, int lane) {
  const int r0 = q0 + 8 * hf, rows = min(8, S - r0);
  if (rows <= 0) return;
  bf16* dst = pb + (uint32_t)(r0 * S);
  const int lead = (int)((reinterpret_cast<uintptr_t>(dst) >> 1) & 7);
  const int g = lane >> 2, c = (lane & 3) * 2;
  if (g < rows) {
    unsigned short* row = reinterpret_cast<unsigned short*>(ps + lead + g * S);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t w = pa[j / 2][hf + 2 * (j & 1)];
      const int col = 8 * j + c;
      if (col < S) row[col] = (unsigned short)(w & 0xffffu);
      if (col + 1 < S) row[col + 1] = (unsigned short)(w >> 16);
    }
  }
  __syncwarp();
  const int n = rows * S, head = min(n, (8 - lead) & 7), body = (n - head) >> 3;
  const bf16* src = ps + lead;
  for (int k = lane; k < body; k += 32)
    *reinterpret_cast<uint4*>(dst + head + 8 * k) =
        *reinterpret_cast<const uint4*>(src + head + 8 * k);
  const int tail = head + 8 * body;
  if (lane < head) dst[lane] = src[lane];
  if (lane < n - tail) dst[tail + lane] = src[tail + lane];
  __syncwarp();  // the area is the next half's
}

template <int NT, bool PROBS>
__global__ void __launch_bounds__(32 * warps_of<NT>(), min_blocks<NT>())
attn_core_res(const __grid_constant__ CUtensorMap kv, const bf16* __restrict__ qkv,
              const float* __restrict__ mask, bf16* __restrict__ o, bf16* __restrict__ probs,
              int S, int H, int Wl) {
  using namespace mvlpt::mma;
  constexpr int KC = (NT + 1) / 2, TILE = keys<NT>() * ROW_BYTES;
  constexpr bool CHAINED = chained<NT>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // swizzle-atom aligned
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const uint32_t ks = smem_addr(smem), vs = ks + TILE;
  bf16* ps = reinterpret_cast<bf16*>(smem + 2 * TILE + warp * warp_bytes<NT, PROBS>());
  const uint32_t bar_k = vs + TILE + warps_of<NT>() * warp_bytes<NT, PROBS>(), bar_v = bar_k + 8;
  const int ld = 3 * Wl, bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const bf16* q = qkv + (size_t)b * S * ld + h * D;
  bf16* ob = o + (size_t)b * S * Wl + h * D;
  bf16* pb = PROBS ? probs + (size_t)bh * S * S : nullptr;

  if (threadIdx.x == 0) {
    wg::mbar_init(bar_k, 1);
    wg::mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::mbar_expect_tx(bar_k, TILE);
    tma_load_3d(ks, &kv, bar_k, Wl + h * D, 0, b);
    wg::mbar_expect_tx(bar_v, TILE);
    tma_load_3d(vs, &kv, bar_v, 2 * Wl + h * D, 0, b);
  }

  const int groups = (S + 15) >> 4, stride = gridDim.y * warps;
  const int g = lane >> 2, c = (lane & 3) * 2;
  int grp = blockIdx.y * warps + warp;
  uint32_t qa[D / 16][4];
  if (grp < groups) {
    q_frags(qa, q, grp * 16, S, lane, ld);
    wg::mbar_wait(bar_k, 0);
  }
  for (; grp < groups; grp += stride) {
    const int q0 = grp * 16;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      key_tile(s[j], qa,
               ks + (CHAINED && j >= DEPTH_K ? zero_after(s[j >= DEPTH_K ? j - DEPTH_K : 0][3])
                                             : 0u),
               j, lane);
    // The next group's q, read while this one's softmax and p v run.
    if (grp + stride < groups) q_frags(qa, q, (grp + stride) * 16, S, lane, ld);

    // Scale, then add the mask (no fused multiply-add); the row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bool edge = 8 * j + 8 > S;  // the tile holds keys at or past S
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + g + 8 * (e >> 1), col = 8 * j + c + (e & 1);
        float v = __fmul_rn(s[j][e], SCALE);
        if (edge && col >= S) v = -INFINITY;
        else if (mask != nullptr && r < S) v += mask[(size_t)r * S + col];
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    const float rs[2] = {rcp(sum[0]), rcp(sum[1])};
    uint32_t pa[KC][4];  // p, rounded: the A fragments of p v's k steps
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const bool full = 2 * kc + 1 < NT;  // an odd NT leaves the last step's right half empty
      const int jh = full ? 2 * kc + 1 : 2 * kc;
      float lo[4], hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo[e] = div_rn(s[2 * kc][e], sum[e >> 1], rs[e >> 1]);
        hi[e] = full ? div_rn(s[jh][e], sum[e >> 1], rs[e >> 1]) : 0.f;
      }
      pack_a(pa[kc], lo, hi);
    }

    wg::mbar_wait(bar_v, 0);
    float acc[D / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      pv_step(acc, pa[kc],
              vs + (CHAINED && kc >= DEPTH_V ? zero_after(acc[(kc + 8 - DEPTH_V) % 8][3]) : 0u),
              16 * kc, lane);
    o_rows(ob, acc, q0, S, lane, Wl);
    if constexpr (PROBS) {
      store_probs<NT>(pb, ps, pa, q0, 0, S, lane);
      store_probs<NT>(pb, ps, pa, q0, 1, S, lane);
    }
  }
  // No TMA may outlive its block: thread 0's warp always has a group
  // (launch gives no block a share past the row's groups), but waits here
  // regardless.
  if (threadIdx.x == 0) {
    wg::mbar_wait(bar_k, 0);
    wg::mbar_wait(bar_v, 0);
  }
}

// A 3-D tensor map over qkv as (B, S, 3 Wl) bf16, boxes of 64 columns by
// `rows` tokens of one image, zeros past S, in the 128-byte swizzle.
inline cudaError_t make_kv_map(CUtensorMap* map, const void* qkv, int B, int S, int Wl, int rows) {
  const wg::EncodeTiledFn enc = wg::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)3 * Wl, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t pitch[2] = {(cuuint64_t)3 * Wl * 2, (cuuint64_t)S * 3 * Wl * 2};
  const cuuint32_t box[3] = {(cuuint32_t)mma::D, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims,
                         pitch, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The shared-memory attribute and the blocks an SM holds are read once a
// kernel (they hold for the process: one card a process). A row is cut
// into shares only where the rows are too few to fill the SMs' resident
// blocks once. The tensor map is encoded on this thread, whose context
// the qkv product's launch (wg::gemm) has just made current.
template <int NT, bool PROBS>
int launch(const void* qkv, const float* mask, void* o, void* probs, int B, int S, int H, int Wl,
           cudaStream_t st) {
  constexpr int W = warps_of<NT>();
  constexpr size_t smem = smem_bytes<NT, PROBS>();
  static int resident = 0;  // blocks of W warps an SM holds, the whole card's
  if (resident == 0) {
    MVLPT_TRY(cudaFuncSetAttribute(attn_core_res<NT, PROBS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    int per_sm = 0, sms = 0;
    MVLPT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_core_res<NT, PROBS>,
                                                            32 * W, smem));
    MVLPT_TRY(mma::sm_count(&sms));
    resident = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  CUtensorMap map;
  MVLPT_TRY(make_kv_map(&map, qkv, B, S, Wl, keys<NT>()));
  const int N = B * H, groups = (S + 15) / 16, warps = groups < W ? groups : W;
  const int most = (groups + warps - 1) / warps, want = resident / N;
  const int shares = want < 1 ? 1 : (want > most ? most : want);
  attn_core_res<NT, PROBS><<<dim3(N, shares), 32 * warps, smem, st>>>(
      map, (const bf16*)qkv, mask, (bf16*)o, (bf16*)probs, S, H, Wl);
  return (int)cudaGetLastError();
}

template <bool PROBS, int I = 0>
int launch_bucket(const void* qkv, const float* mask, void* o, void* probs, int B, int S, int H,
                  int Wl, cudaStream_t st) {
  constexpr int NT = BUCKETS[I];
  if constexpr (I + 1 < (int)(sizeof(BUCKETS) / sizeof(BUCKETS[0]))) {
    if (S > 8 * NT) return launch_bucket<PROBS, I + 1>(qkv, mask, o, probs, B, S, H, Wl, st);
  }
  return launch<NT, PROBS>(qkv, mask, o, probs, B, S, H, Wl, st);
}

static_assert(8 * BUCKETS[sizeof(BUCKETS) / sizeof(BUCKETS[0]) - 1] == MAX_KEYS,
              "the last bucket ends at the route's switch");

}  // namespace res

// The bf16 core by S: the one-pass core up to res::MAX_KEYS keys, the
// windowed two-pass core past it.
template <bool PROBS>
int launch_core(const void* qkv, const float* mask, void* o, void* probs, int B, int S, int H,
                int Wl, cudaStream_t st) {
  return S <= res::MAX_KEYS ? res::launch_bucket<PROBS>(qkv, mask, o, probs, B, S, H, Wl, st)
                            : core::launch<PROBS>(qkv, mask, o, probs, B, S, H, Wl, st);
}

// ------------------------------------------------------- the half-block

// H heads of D each (Wl = H D, the qkv width 3 Wl); the LN and the output
// are over the model width W. part: fp32 partial out-projection into y,
// without out_b or the residual. probs, mu and rstd may be null.
// tc: the tensor cores' route (bf16 only); else the CUDA cores'. marks:
// stamped right before and after the attention core (a null table: none).
template <typename T, bool tc = std::is_same_v<T, __nv_bfloat16>>
int attn_fwd_impl(const void* x, const void* ln_scale, const void* ln_bias, const void* qkv_w,
                  const void* qkv_b, const void* out_w, const void* out_b, const float* mask,
                  void* xh, void* qkv, void* o, void* probs, float* mu, float* rstd, void* y,
                  int B, int S, int W, int H, int D, float eps, bool part, const Marks& marks,
                  cudaStream_t st) {
  if (tc && D != mma::D) return (int)cudaErrorInvalidValue;  // the wrappers route first
  const int M = B * S, Wl = H * D;
  MVLPT_TRY(launch_ln_fwd<T>(x, ln_scale, ln_bias, xh, mu, rstd, M, W, eps, st));
  MVLPT_TRY((wg::gemm<T, EPI_BIAS, false, tc>(xh, qkv_w, M, 3 * Wl, W,
                                              EpiArgs{qkv_b, nullptr, nullptr, qkv, nullptr},
                                              st)));
  MVLPT_TRY(mark(marks, 0, st));
  int rc;
  if constexpr (tc) {
    rc = probs != nullptr ? launch_core<true>(qkv, mask, o, probs, B, S, H, Wl, st)
                          : launch_core<false>(qkv, mask, o, nullptr, B, S, H, Wl, st);
  } else {
    const fma_core::AttnRows rows{qkv, (const T*)qkv + Wl, (const T*)qkv + 2 * Wl, o, H,
                                  (long long)S * 3 * Wl, (long long)S * Wl, D, 3 * Wl, D, Wl};
    rc = fma_core::launch_fma_attn_fwd<T>(rows, B * H, mask, probs, S, D,
                                          (float)pow((double)D, -0.5), true, st);
  }
  if (rc != 0) return rc;
  MVLPT_TRY(mark(marks, 1, st));
  if (part)
    MVLPT_TRY((wg::gemm<T, EPI_F32, false, tc>(o, out_w, M, W, Wl,
                                               EpiArgs{nullptr, nullptr, nullptr, y, nullptr},
                                               st)));
  else
    MVLPT_TRY((wg::gemm<T, EPI_BIAS_RESID, false, tc>(o, out_w, M, W, Wl,
                                                      EpiArgs{out_b, x, nullptr, y, nullptr},
                                                      st)));
  return 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores, D = 64),
// 2 = bfloat16 (CUDA cores, any D). probs, mu and rstd may be null (no-residual mode); xh, qkv and o are
// caller-allocated scratch. mark_*: the core's marks (stamp.cuh's Marks;
// a null mark_table: none).
extern "C" int mvlpt_attn_fwd(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                              const void* qkv_w, const void* qkv_b, const void* out_w,
                              const void* out_b, const void* mask, void* xh, void* qkv, void* o,
                              void* probs, void* mu, void* rstd, void* y, int B, int S, int W,
                              int H, float eps, void* mark_table, const void* mark_row,
                              int mark_width, int mark_col, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int D = W / H;
  const Marks marks{(long long*)mark_table, (const long long*)mark_row, mark_width, mark_col};
  if (dtype == 0)
    return attn_fwd_impl<float>(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                                (const float*)mask, xh, qkv, o, probs, (float*)mu, (float*)rstd,
                                y, B, S, W, H, D, eps, false, marks, st);
  if (dtype == 1)
    return attn_fwd_impl<__nv_bfloat16>(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                               (const float*)mask, xh, qkv, o, probs, (float*)mu, (float*)rstd, y,
                               B, S, W, H, D, eps, false, marks, st);
  if (dtype == 2)
    return attn_fwd_impl<__nv_bfloat16, false>(
        x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, (const float*)mask, xh, qkv, o, probs,
        (float*)mu, (float*)rstd, y, B, S, W, H, D, eps, false, marks, st);
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
                                   int S, int W, int H, int D, float eps, void* mark_table,
                                   const void* mark_row, int mark_width, int mark_col,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Marks marks{(long long*)mark_table, (const long long*)mark_row, mark_width, mark_col};
  if (dtype == 0)
    return attn_fwd_impl<float>(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, nullptr,
                                (const float*)mask, xh, qkv, o, probs, (float*)mu, (float*)rstd,
                                ypart, B, S, W, H, D, eps, true, marks, st);
  if (dtype == 1)
    return attn_fwd_impl<__nv_bfloat16>(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, nullptr,
                               (const float*)mask, xh, qkv, o, probs, (float*)mu, (float*)rstd,
                               ypart, B, S, W, H, D, eps, true, marks, st);
  if (dtype == 2)
    return attn_fwd_impl<__nv_bfloat16, false>(
        x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, nullptr, (const float*)mask, xh, qkv, o, probs,
        (float*)mu, (float*)rstd, ypart, B, S, W, H, D, eps, true, marks, st);
  return (int)cudaErrorInvalidValue;
}
