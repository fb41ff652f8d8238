// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cu; flash_bwd.cu): wgmma on 16-bit operands with fp32
// accumulation and its shared-memory descriptors, mbarriers, TMA tensor
// loads and stores over 4-D maps of (B, T, H, D) tensors, the swizzle of a
// tile by head dim, the K-tile range a Q tile sees under the causal and
// window masks, and the persistent walk over pairs of tiles.
//
// Shared-memory tiles: a [rows][D] tile is stored as D / kAtomCols swizzle
// atoms side by side, each `rows` rows of kRowBytes (128-byte rows at
// D=64, two 128-byte atoms at D=128, 64-byte at D=32, 32-byte at D=16);
// the TMA maps (encode) and the wgmma descriptors (make_desc) use the same
// mode.  As a wgmma operand such a tile is K-major (D contiguous: the A
// operand, or a B operand whose reduction runs over D) through
// make_desc(tile, 16, kGroupBytes), a k-slice of 16 columns adding its byte
// offset inside its atom; or MN-major (a B operand whose reduction runs
// over the tile's rows) through make_desc(tile, rows * kRowBytes,
// kGroupBytes), a k-slice of 16 rows adding 16 * kRowBytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The swizzle geometry of a tile of head dim D (see the note above).
template <int D>
struct Swizzle {
  static constexpr int kAtomCols = D < 64 ? D : 64;
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kRowBytes = kAtomCols * 2;
  static constexpr int kSwizzleBits = kRowBytes == 128 ? 3 : kRowBytes == 64 ? 2 : 1;
  static constexpr uint64_t kDescLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kGroupBytes = 8 * kRowBytes;  // 8 rows: wgmma's SBO
};

// ---- wgmma ----------------------------------------------------------------

#define FLASH_WGMMA_SS_N128(TY, d, da, db, scale_d) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
      "%62, %63}, " \
      "%64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define FLASH_WGMMA_SS_N64(TY, d, da, db, scale_d) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
      "%27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define FLASH_WGMMA_RS_N16(TY, d, a, db) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, " \
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define FLASH_WGMMA_RS_N32(TY, d, a, db) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
      "%14, %15}, " \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define FLASH_WGMMA_RS_N64(TY, d, a, db) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
      "%26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define FLASH_WGMMA_RS_N128(TY, d, a, db) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
      "%62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T> struct Ops;

template <> struct Ops<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // two floats -> one register, `lo` in the low half (smaller column)
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void qk(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    FLASH_WGMMA_SS_N128("bf16", d, da, db, scale_d);
  }
  static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
    FLASH_WGMMA_SS_N64("bf16", d, da, db, scale_d);
  }
  template <int N>
  static __device__ __forceinline__ void pv(float (&d)[N / 2],
                                            const uint32_t (&a)[4], uint64_t db) {
    if constexpr (N == 16) FLASH_WGMMA_RS_N16("bf16", d, a, db);
    if constexpr (N == 32) FLASH_WGMMA_RS_N32("bf16", d, a, db);
    if constexpr (N == 64) FLASH_WGMMA_RS_N64("bf16", d, a, db);
    if constexpr (N == 128) FLASH_WGMMA_RS_N128("bf16", d, a, db);
  }
};

template <> struct Ops<__half> {
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void qk(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    FLASH_WGMMA_SS_N128("f16", d, da, db, scale_d);
  }
  static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
    FLASH_WGMMA_SS_N64("f16", d, da, db, scale_d);
  }
  template <int N>
  static __device__ __forceinline__ void pv(float (&d)[N / 2],
                                            const uint32_t (&a)[4], uint64_t db) {
    if constexpr (N == 16) FLASH_WGMMA_RS_N16("f16", d, a, db);
    if constexpr (N == 32) FLASH_WGMMA_RS_N32("f16", d, a, db);
    if constexpr (N == 64) FLASH_WGMMA_RS_N64("f16", d, a, db);
    if constexpr (N == 128) FLASH_WGMMA_RS_N128("f16", d, a, db);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {  // at most N groups in flight
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers an asynchronous wgmma reads or writes must not be touched by
// the compiler until the wait: tie them to a volatile asm after it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
// A k-slice further into the tile adds its byte offset / 16 to the start
// address field.  The result passes through an opaque move, so that the
// compiler builds each slice's descriptor where it is used instead of
// hoisting all of them out of the loop into registers the products need.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
               (static_cast<uint64_t>(lbo >> 4) << 16) |
               (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
  asm volatile("" : "+l"(d));
  return d;
}

// ---- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of `parity` to complete.  A barrier that never
// completes is a bug: after 2^24 polls (seconds) trap, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The K tiles [lo, hi) that the CTA's query rows see: every other tile is
// wholly masked for all of its rows (the TPU kernel's `needed`).
template <int kBlockM, int kBlockN, typename A>
__device__ __forceinline__ void tile_range(const A& a, int qb, int& lo,
                                           int& hi) {
  const int nk = (a.Tk + kBlockN - 1) / kBlockN;
  const long long q_first = static_cast<long long>(a.q_off) + qb * kBlockM;
  const long long q_last =
      static_cast<long long>(a.q_off) + min(qb * kBlockM + kBlockM, a.Tq) - 1;
  hi = nk;
  if (a.causal) {  // the tile of the newest key any row sees
    const long long newest = q_last - a.k_off;
    hi = newest < 0 ? 0 : newest / kBlockN + 1 < nk ? static_cast<int>(newest / kBlockN + 1) : nk;
  }
  lo = 0;
  if (a.window > 0) {  // first tile whose last key is inside the window
    const long long first = -floor_div(a.window - 1 + a.k_off + (kBlockN - 1) - q_first, kBlockN);
    lo = first < 0 ? 0 : first < nk ? static_cast<int>(first) : nk;
  }
}

// The CTA's walk over Q tiles.  Work item w is the pair of Q tiles
// (n_qblocks - 1 - p, p) of one (b, h), heaviest first, so that every
// item covers the same number of causal K tiles; CTA c takes items c,
// c + G, ... in (b, h)-major order, so the CTAs at work at any time share
// the K/V of few heads, which stay in L2.  Step u is half u & 1 of the
// CTA's item u >> 1: false past the last item, and qb = -1 for the
// missing partner of the middle tile when n_qblocks is odd.
template <typename A>
__device__ __forceinline__ bool walk(const A& a, int u, int& bh, int& qb) {
  const int item = blockIdx.x + (u >> 1) * gridDim.x;
  if (item >= a.n_items) return false;
  bh = item / a.n_pairs;
  const int pair = item % a.n_pairs;
  qb = (u & 1) == 0 ? a.n_qblocks - 1 - pair
       : pair == a.n_qblocks - 1 - pair ? -1 : pair;
  return true;
}

// Byte offset of a swizzled tile, as TMA writes it and wgmma reads it:
// the 16-byte chunk index XORed with address bits 7 and up.
template <int B>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & ((1u << B) - 1)) << 4);
}

// ---- tensor maps (host) -----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (D, T, H, B) of a (B, T, H, D) tensor with element
// strides sb, st, sh; boxes of one swizzle atom's columns by `rows` rows.
template <typename T, int D>
bool encode(CUtensorMap* map, const void* ptr, int B, int rows, int H,
            long long sb, long long st, long long sh, int box_rows) {
  using L = Swizzle<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  // a dimension of extent 1 is never stepped: any legal stride will do
  const auto bytes = [](long long s, int n) -> cuuint64_t {
    return n > 1 ? static_cast<cuuint64_t>(s) * 2 : 16;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st, rows), bytes(sh, H), bytes(sb, B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::kAtomCols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = L::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, Ops<T>::kTma, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
