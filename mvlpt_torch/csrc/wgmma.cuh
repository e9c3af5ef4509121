// bf16 GEMM for Hopper's tensor cores: wgmma fed by TMA through an
// mbarrier ring, with the fused epilogues of common.cuh.
//
//   C[M, N] = A[M, K] @ op(B), A row-major bf16, fp32 accumulators, then
//   one of the Epilogue modes on each element. B is a row-major bf16
//   weight in the JAX (in, out) schema, read as it lies, with no copy:
//   - MN-major (B_KMAJOR false): B is (K, N), op(B) = B, the forward's
//     products; wgmma reads it transposed from shared memory;
//   - K-major (B_KMAJOR true): B is (N, K), op(B) = B^T, the backward's
//     products (gy W_proj^T, dh W_fc^T); its slabs lie in shared memory
//     as A's do.
//
// A block computes a BM x BN tile of C (128 x 128, or 128 x 256 where
// that still makes three waves of blocks: launch_gemm_bf16) with three
// warpgroups, one block an SM. Warpgroup 0 is the producer: one of its
// threads keeps a ring of STAGES = 4 K-slabs in flight with
// cp.async.bulk.tensor (TMA), 64 values (128 bytes) of K a slab, in the
// 128-byte swizzle (B MN-major in boxes of 64 columns, K-major in one
// box of BN rows); each stage completes on its `full` mbarrier
// (transaction bytes) and is handed back on its `empty` mbarrier.
// Warpgroups 1 and 2 are the consumers, 64 rows each: per slab four
// wgmma.mma_async.m64nBNk16 (A and B from shared memory by descriptor),
// one group kept in flight. setmaxnreg moves the producer's registers to
// the consumers. The epilogue stages each consumer's fp32 tile through
// the drained ring, so every thread then applies the epilogue to four
// neighbouring columns and each warp stores whole rows.
//
// Its callers: the MLP half-blocks' products (mlp_fwd.cu, mlp_bwd.cu)
// and the attention half-block forward's qkv product (EPI_BIAS) and
// out-projection (attn_fwd.cu), all in bf16.
//
// Bound by operations at the MLP's shapes; what keeps it from the
// tensor cores' rate is that a block's ring fill and epilogue do not
// overlap another tile's products (one tile a block, one block an SM).
//
// Ragged edges: TMA fills rows (and columns) past the tensor with zeros
// on load, and the epilogue masks rows >= M and columns >= N on store.
// The operands' bases must be 16-byte aligned and K, N multiples of 8
// (TMA's row pitch); the wrappers ask for W, 4W multiples of 64. In the
// EPI_GELU_BWD epilogue, aux (M, N) is read four values at a time under
// the same mask as the store.
//
// The tensor maps are encoded on the host (cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point, so the library needs
// no -lcuda) and passed as __grid_constant__ kernel parameters.
//
// Raw PTX in inline asm (no CuTe), so the build stays in seconds.
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace mvlpt {
namespace wg {
// Internal linkage: each kernel library keeps its own kernels and host
// state (the static of an inline function would be one object for every
// library the process loads).
namespace {

constexpr int BM = 128, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                       // warpgroups of 64 rows
constexpr int THREADS = 128 * (1 + CONSUMERS);
// setmaxnreg's split of the block's 65536 registers (168 a thread at
// entry): the producer gives up all but 40, the consumers take them.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= THREADS * 168,
              "setmaxnreg asks for more registers than the block holds");
constexpr int BOX_N = 64;                          // MN-major B's TMA box: 128 bytes of N
constexpr int A_BYTES = BM * BK * 2;               // 16 KB
constexpr int B_BOX_BYTES = BK * BOX_N * 2;        // 8 KB

// The shared-memory plan of a BM x BN tile: the ring of STAGES (A, B)
// slabs, the epilogue's fp32 staging (one consumer's 64 rows, padded to
// OUT_ROW floats: no bank conflicts) in the drained ring, then the
// barriers.
template <int BN>
struct Tile {
  static constexpr int B_BYTES = BK * BN * 2;      // BN / BOX_N boxes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int OUT_ROW = BN + 8;
  static constexpr int OUT_BYTES = 64 * OUT_ROW * 4;
  // 1024 bytes of slack to align the ring to the swizzle atom.
  static constexpr int SMEM_BYTES = 1024 + RING_BYTES + 2 * STAGES * 8;
  static_assert(CONSUMERS * OUT_BYTES <= RING_BYTES, "the staging does not fit in the ring");
  static_assert(SMEM_BYTES <= (int)kMaxDynSmem, "the GEMM's shared memory exceeds a block's");
};

// ------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// About 8 s at the H100's boost clock: far past any wait of the ring.
constexpr long long kWaitCycles = 1ll << 34;

// Returns once the phase of parity `parity` of the barrier has completed.
// A wait that never ends (a fault of the protocol) traps, so it surfaces
// as a launch error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// The box at (c0 innermost, c1) of a 2-D tensor map into shared memory,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
//   A, K-major (rows of 64 K values, 128 bytes): LBO unused, SBO = 1024
//   (from one 8-row group to the next); a K step of 16 adds 32 bytes to
//   the start, inside the swizzle atom, as the hardware swizzles the
//   address it computes.
//   B, MN-major (rows of 64 N values, one row a k): LBO = the step from
//   one 64-column box to the next, SBO = 1024 (from one 8-k group to the
//   next); a K step of 16 adds 16 rows, 2048 bytes.
//   B, K-major (rows of 64 K values, one row an n): as A.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above a wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B over one k16 step: A 64 x 16 (K-major), B 16 x N (MN-major
// with imm-trans-b TB = 1, K-major with TB = 0), fp32 accumulators; N is
// the width of d (64 or 128 floats: N = 128 or 256). Accumulator i of
// thread t holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2.
template <int TB>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[64], uint64_t a, uint64_t b) {
  const int scale_d = 1;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[128], uint64_t a, uint64_t b) {
  const int scale_d = 1;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// --------------------------------------------------------- epilogue

__device__ __forceinline__ void load_bf16x4(float (&v)[4], const void* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ void store_bf16x4(void* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(mma::pack_bf16(v[0], v[1]), mma::pack_bf16(v[2], v[3]));
}

// sigmoid(z) = 1 / (1 + exp(-z)), the divide by mma.cuh's fast path of
// the IEEE divide (no slow-path call holding the live registers); past
// 2^126, where the hardware reciprocal flushes to zero, the quotient is 0.
__device__ __forceinline__ float sigmoid_rn(float z) {
  const float y = 1.f + expf(-z);
  return y < 0x1p126f ? mma::div_rn(1.f, y, mma::rcp(y)) : 0.f;
}

// The epilogue on columns n..n+3 of row m (bf16 operands; EPI_F32 writes
// the fp32 accumulators), with common.cuh's rounding points.
template <int EPI>
__device__ __forceinline__ void epi_quad(const EpiArgs& ep, int m, int n, int N, float4 acc) {
  const size_t o = (size_t)m * N + n;
  if constexpr (EPI == EPI_F32) {
    *reinterpret_cast<float4*>((float*)ep.out + o) = acc;
  } else {
    static_assert(EPI == EPI_BIAS || EPI == EPI_BIAS_RESID || EPI == EPI_BIAS_GELU,
                  "wgmma GEMM: epilogue not instantiated for the bf16 route");
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
    float b[4], out[4];
    load_bf16x4(b, (const __nv_bfloat16*)ep.bias + n);
    if constexpr (EPI == EPI_BIAS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = a[i] + b[i];
    } else if constexpr (EPI == EPI_BIAS_RESID) {
      float r[4];
      load_bf16x4(r, (const __nv_bfloat16*)ep.resid + o);
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = r[i] + rnd<__nv_bfloat16>(a[i] + b[i]);
    } else {  // EPI_BIAS_GELU
      float h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = rnd<__nv_bfloat16>(a[i] + b[i]);
        out[i] = h[i] * sigmoid_rn(1.702f * h[i]);
      }
      if (ep.out2 != nullptr) store_bf16x4((__nv_bfloat16*)ep.out2 + o, h);
    }
    store_bf16x4((__nv_bfloat16*)ep.out + o, out);
  }
}

// EPI_GELU_BWD on columns n..n+3 of a row at offset o, given the four
// bf16 hpre values there (aux, loaded ahead by the caller): dh =
// T(da QuickGELU'(h)) at the saved, rounded h, common.cuh's rounding
// points.
__device__ __forceinline__ void gelu_bwd_quad(const EpiArgs& ep, size_t o, float4 acc,
                                              uint2 hq) {
  const float a[4] = {acc.x, acc.y, acc.z, acc.w};
  float h[4], out[4];
  load_bf16x4(h, &hq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sg = sigmoid_rn(1.702f * h[i]);
    out[i] = a[i] * (sg + 1.702f * h[i] * sg * (1.f - sg));
  }
  store_bf16x4((__nv_bfloat16*)ep.out + o, out);
}

// ----------------------------------------------------------- kernel

template <int EPI, int BN, bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, int M, int N, int K, EpiArgs ep) {
  using L = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // swizzle-atom aligned
  uint8_t* s_a = smem;                                           // STAGES x A_BYTES
  uint8_t* s_b = smem + STAGES * A_BYTES;                        // STAGES x B_BYTES
  const uint32_t full0 = smem_u32(smem + L::RING_BYTES);
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt_n = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (t == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty0 + 8 * s, ((kt / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, L::STAGE_BYTES);
        tma_load_2d(smem_u32(s_a + s * A_BYTES), &map_a, full, kt * BK, m0);
        if constexpr (B_KMAJOR) {
          tma_load_2d(smem_u32(s_b + s * L::B_BYTES), &map_b, full, kt * BK, n0);
        } else {
#pragma unroll
          for (int h = 0; h < BN / BOX_N; ++h)
            tma_load_2d(smem_u32(s_b + s * L::B_BYTES + h * B_BOX_BYTES), &map_b, full,
                        n0 + h * BOX_N, kt * BK);
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wgi - 1;
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    for (int kt = 0; kt < kt_n; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full0 + 8 * s, (kt / STAGES) & 1);
      const uint32_t a0 = smem_u32(s_a + s * A_BYTES + c * 64 * BK * 2);
      const uint32_t b0 = smem_u32(s_b + s * L::B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t bd = B_KMAJOR ? sw128_desc(b0 + 32 * kk, 16, 1024)
                                     : sw128_desc(b0 + 2048 * kk, B_BOX_BYTES, 1024);
        wgmma_m64k16<B_KMAJOR ? 0 : 1>(d, sw128_desc(a0 + 32 * kk, 16, 1024), bd);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slab's products are done: hand its stage back
      if (kt > 0 && t == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % STAGES));
    }
    // The epilogue's quads: iteration it takes quad idx = 128 it + t of
    // this consumer's 64 x BN tile, row idx / (BN / 4), columns 4 (idx %
    // (BN / 4)) on.
    constexpr int ITERS = 64 * (BN / 4) / 128;
    const int row0 = t / (BN / 4), q0 = t % (BN / 4), rows_per_it = 128 / (BN / 4);
    // EPI_GELU_BWD reads aux (hpre) as a stream as large as its output:
    // every load of the tile starts here, before the last products
    // drain, so the loads' latencies overlap them and the staging (a
    // load cannot move past a store the compiler cannot tell apart from
    // it).
    uint2 hq[EPI == EPI_GELU_BWD ? ITERS : 1];
    if constexpr (EPI == EPI_GELU_BWD) {
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int m = m0 + 64 * c + row0 + rows_per_it * it, n = n0 + 4 * q0;
        hq[it] = m < M && n < N
                     ? __ldg(reinterpret_cast<const uint2*>((const __nv_bfloat16*)ep.aux +
                                                           (size_t)m * N + n))
                     : make_uint2(0u, 0u);
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    // The staging reuses the ring: both consumers' products must be done.
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");

    // Stage the 64 x BN fp32 tile (rows padded to OUT_ROW: no bank
    // conflicts on the float2 writes), then the epilogue by row quads.
    float* so = reinterpret_cast<float*>(smem) + c * 64 * L::OUT_ROW;
    const int warp = t / 32, lane = t % 32;
    const int r = 16 * warp + lane / 4, cc = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(so + r * L::OUT_ROW + 8 * j + cc) =
          make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(so + (r + 8) * L::OUT_ROW + 8 * j + cc) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");  // this warpgroup only
    if constexpr (EPI == EPI_GELU_BWD) {
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int row = row0 + rows_per_it * it;
        const int m = m0 + 64 * c + row, n = n0 + 4 * q0;
        if (m < M && n < N)
          gelu_bwd_quad(ep, (size_t)m * N + n,
                        *reinterpret_cast<const float4*>(so + row * L::OUT_ROW + 4 * q0), hq[it]);
      }
    } else {
#pragma unroll 4
      for (int it = 0; it < ITERS; ++it) {
        const int idx = it * 128 + t, row = idx / (BN / 4), q = idx % (BN / 4);
        const int m = m0 + 64 * c + row, n = n0 + 4 * q;
        if (m < M && n < N)
          epi_quad<EPI>(ep, m, n, N,
                        *reinterpret_cast<const float4*>(so + row * L::OUT_ROW + 4 * q));
      }
    }
  }
}

// ------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A tensor map over a (rows, cols) row-major bf16 matrix, boxes of
// (box_rows, box_cols) in the 128-byte swizzle, zeros past the edges.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                            int box_cols) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                         pitch, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// C = A (M, K) @ op(B) through the epilogue EPI, both operands bf16, in
// tiles of BM x BN; B is (K, N), or (N, K) with B_KMAJOR.
template <int EPI, int BN, bool B_KMAJOR = false>
inline cudaError_t launch_gemm_bf16_tiles(const void* A, const void* B, int M, int N, int K,
                                          EpiArgs ep, cudaStream_t st) {
  static bool smem_set = false;  // the attribute holds for the process
  constexpr int smem = Tile<BN>::SMEM_BYTES;
  // cuTensorMapEncodeTiled needs the device's context current on this
  // thread, and a thread's first call here (autograd's backward thread,
  // say) may come before any runtime call that makes it so:
  // cudaSetDevice on the current device does (CUDA 12).
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  CUtensorMap map_a, map_b;
  if (e == cudaSuccess) e = make_map(&map_a, A, M, K, BM, BK);
  if (e == cudaSuccess)
    e = B_KMAJOR ? make_map(&map_b, B, N, K, BN, BK) : make_map(&map_b, B, K, N, BK, BOX_N);
  if (e == cudaSuccess && !smem_set) {
    e = cudaFuncSetAttribute(wgmma_gemm_kernel<EPI, BN, B_KMAJOR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = e == cudaSuccess;
  }
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  wgmma_gemm_kernel<EPI, BN, B_KMAJOR><<<grid, THREADS, smem, st>>>(map_a, map_b, M, N, K, ep);
  return cudaGetLastError();
}

// The same, in 128 x 256 tiles where they make three waves of blocks or
// more (the FC product; the projection at the eval batch), else in
// 128 x 128 tiles. Measured on an H100: the wide tile reads less of B a
// product and wins where the card stays full; where it leaves the last
// wave mostly empty (the projection at M = 6432, N = 768), it loses.
template <int EPI, bool B_KMAJOR = false>
inline cudaError_t launch_gemm_bf16(const void* A, const void* B, int M, int N, int K, EpiArgs ep,
                                    cudaStream_t st) {
  int sms = 0;
  const cudaError_t e = mma::sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long wide_tiles = (long)((M + BM - 1) / BM) * ((N + 255) / 256);
  return wide_tiles >= 3l * sms
             ? launch_gemm_bf16_tiles<EPI, 256, B_KMAJOR>(A, B, M, N, K, ep, st)
             : launch_gemm_bf16_tiles<EPI, 128, B_KMAJOR>(A, B, M, N, K, ep, st);
}

// C = A (M, K) @ op(B) on T's route, the half-blocks' products: bf16 on
// this GEMM, fp32 on common.cuh's CUDA-core GEMM (TF32 would not hold
// fp32's tolerance). B is (K, N), or (N, K) with B_KMAJOR.
template <typename T, int EPI, bool B_KMAJOR = false>
inline cudaError_t gemm(const void* A, const void* B, int M, int N, int K, EpiArgs ep,
                        cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return launch_gemm_bf16<EPI, B_KMAJOR>(A, B, M, N, K, ep, st);
  else
    return launch_gemm<T, B_KMAJOR, EPI>(A, B, M, N, K, ep, st);
}

}  // namespace
}  // namespace wg
}  // namespace mvlpt
