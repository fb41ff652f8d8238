// Flash-attention forward for Hopper (sm_90a), bf16 or fp16 operands.
//
// Replaces the TPU kernel `_fwd_kernel` (called through `_fwd`) in
// chainermn_tpu/ops/pallas_attention.py.  It computes the same function:
// flash-v2 online softmax over K tiles, causal and sliding-window masking
// in GLOBAL positions (q_offset/k_offset), whole K tiles skipped when the
// causal/window predicate masks them entirely, fp32 running max `m`,
// normaliser `l` and accumulator, and the outputs `o` and `lse`.
//
// Numerics kept from the TPU kernel:
//   s   = (q . k^T with fp32 accumulation) * scale, scale = D^-0.5;
//   s   = allow ? s : -1e30;
//   p   = allow ? exp(s - m_new) : 0      (the zeroing is load-bearing: a
//         fully masked row would otherwise average V into the output);
//   acc = acc * alpha + (p cast to V's dtype) . v   (fp32 accumulation);
//   l   = l * alpha + rowsum(p)           (p in fp32, before the cast);
//   o   = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)),
// so a fully masked row gives o = 0 and lse ~ -1e30.  lse is stored as
// fp32 (B*H, Tq) without the TPU's 128-lane padding.  Keys beyond Tk (the
// ragged last tile) are masked like causally masked keys.  The exponent
// is taken base 2: s, m and the arguments of exp carry a factor log2(e)
// folded into the scale (exp(x) = 2^(x log2 e), one ex2 per element), and
// lse is converted back to the natural log when it is written.
//
// Bound at the flagship scoring shape (B=8, H=16, T=2048, D=64, causal,
// bf16): the lower triangle needs 4*B*H*D*T*(T+1)/2 = 68.7 GFLOP, 69 us at
// 989 TFLOP/s; q/k/v/o move 134 MB, 40 us at 3.35 TB/s.  The call is
// bound by tensor-core operations, and at D=64 the 2^x of the softmax
// (one per score, 16 a clock on an SM) takes as long as both products:
// the two units have to run at once.
//
// Design, against the six limits of the first (mma.sync) version:
//  1. Synchronous loads: one producer thread issues TMA
//     (cp.async.bulk.tensor) loads of Q and of K and V tiles into a
//     two-stage ring with full and empty mbarriers (K and V apart, so K
//     is refilled as soon as S is done with it).
//  2. mma.sync: both products are wgmma.mma_async, S = Q K^T (m64n128k16,
//     both operands from shared memory) and O += P V (m64nDk16, P from
//     registers), by two consumer warpgroups of 64 query rows each.  A
//     warpgroup issues tile n's S and tile n-1's P V together and runs
//     tile n's softmax while P V is on the tensor cores; the other
//     warpgroup's products fill its softmax.  setmaxnreg gives the
//     producer warpgroup 40 registers and the consumers 232.  (Tried
//     and not kept, none faster: strict turns between the warpgroups; a
//     third consumer warpgroup, which spills at 160 registers with this
//     overlap.)
//  3. Scalar operand loads: the tensor cores read Q, K (K-major) and V
//     (MN-major, a transposed B) through shared-memory descriptors, and
//     S's accumulator layout is wgmma's register-A layout, so P never
//     leaves registers.
//  4. Mask arithmetic on every element: each K tile is classed from
//     global positions as skipped (wholly masked: never loaded), interior
//     (wholly allowed: no test) or edge (diagonal, window edge, ragged
//     tail: the exact per-element rule, as two compares of a column
//     against the row's allowed range, with the explicit zero of masked
//     p).  At T=2048, causal, 1 tile in 8.5 of a Q tile is an edge tile.
//  5. Small tiles, naive schedule: 128-row Q tiles and 128-key K tiles
//     halve the K/V refetches; the kernel is persistent, one CTA an SM,
//     walking pairs of Q tiles of one (b, h), the heaviest with the
//     lightest (equal work per pair), heads in order (a head's K/V stays
//     in L2); the producer loads the next Q tile while the consumers
//     finish the last, and O leaves through its own buffer, so no CTA
//     start-up or epilogue stands between two tiles' products.
//  6. Strided 4-byte Q loads: Q arrives by TMA, and O leaves by a TMA
//     store that clips the ragged tail.
// The swizzle of each tile follows D: 128-byte rows at D=64 (two 128-byte
// atoms at D=128), 64-byte at D=32, 32-byte at D=16; the TMA maps and the
// wgmma descriptors use the same mode.
//
// Layout: q, k, v, o are (B, T, H, D) with unit stride along D and any
// element strides for b, t and h (multiples of 8, 16-byte aligned bases),
// described in place by 4-D tensor maps over (D, T, H, B); rows beyond T
// arrive as zeros.  cuTensorMapEncodeTiled is looked up at run time with
// cudaGetDriverEntryPoint, so the library needs no link to libcuda.  The C
// entry point returns the launch's cudaError_t (cudaErrorInvalidValue if
// a tensor map cannot describe an operand).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 128;   // keys per K/V tile
constexpr int kStages = 2;     // depth of the K/V ring
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The CTA: a producer warpgroup and kWGs consumer warpgroups of 64 query
// rows each; setmaxnreg splits the register file between them.  Shared
// memory for head dim D: a [rows][D] tile is stored as D / kAtomCols
// swizzle atoms side by side, each `rows` rows of kRowBytes.
template <int D>
struct Smem {
  static constexpr int kWGs = 2;
  static constexpr int kBlockM = 64 * kWGs;
  static constexpr int kThreads = 128 * (kWGs + 1);
  static constexpr int kConsumerWarps = 4 * kWGs;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static_assert(128 * kProducerRegs + 128 * kWGs * kConsumerRegs <= 65536, "registers");
  static constexpr int kAtomCols = D < 64 ? D : 64;
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kRowBytes = kAtomCols * 2;
  static constexpr int kSwizzleBits = kRowBytes == 128 ? 3 : kRowBytes == 64 ? 2 : 1;
  static constexpr uint64_t kDescLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kGroupBytes = 8 * kRowBytes;  // 8 rows: wgmma's SBO
  static constexpr int kQAtom = kBlockM * kRowBytes;
  static constexpr int kKAtom = kBlockN * kRowBytes;
  static constexpr int kQBytes = kAtoms * kQAtom;
  static constexpr int kKBytes = kAtoms * kKAtom;
  static constexpr int kQ = 0;
  static constexpr int kO = kQ + kQBytes;  // the O tile on its way out
  static constexpr int kK = kO + kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kKBytes;
  // barriers: Q full and empty; K full, V full, K empty, V empty per
  // stage; +1024 to align the base to the 128-byte swizzle's pattern
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages) + 1024;
};

struct Args {
  float* lse;
  int H, Tq, Tk, n_qblocks;
  int n_pairs, n_items;  // Q-tile pairs of one (b, h); pairs of all
  int causal, window, q_off, k_off;
  float scale_log2;  // D^-0.5 * log2(e)
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
template <int kBlockM>
__device__ __forceinline__ void tile_range(const Args& a, int qb, int& lo,
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
__device__ __forceinline__ bool walk(const Args& a, int u, int& bh, int& qb) {
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

// Max or sum of the thread's 32 elements of row r (sc elements 4k + 2r
// and 4k + 2r + 1) as a tree: five dependent steps instead of a chain of
// 31, since two consumer warps per scheduler cannot hide a long chain.
template <typename Op>
__device__ __forceinline__ float row_reduce(const float (&x)[64], int r, Op op) {
  float t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = op(x[4 * k + 2 * r], x[4 * k + 2 * r + 1]);
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = op(t[k], t[k + 8]);
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = op(t[k], t[k + 4]);
  return op(op(t[0], t[2]), op(t[1], t[3]));
}

// The online softmax of one S tile, in place: scale, mask (edge tiles
// only), running max, p = 2^(s - m) with masked p = 0, and the fp32 row
// sums.  sc element i is row r = (i >> 1) & 1 of the thread's two, key
// column 8 * (i >> 2) + 2 * t4 + (i & 1) of tile j.  Returns each row's
// alpha, the factor that moves earlier sums to the new max.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool interior, int j, int t4,
                                             const int (&qpos)[2], const Args& a) {
  const auto max_op = [](float x, float y) { return fmaxf(x, y); };
  const auto add_op = [](float x, float y) { return x + y; };
  float mx[2];
  if (interior) {
#pragma unroll
    for (int r = 0; r < 2; ++r)  // scale > 0: the max commutes with it
      mx[r] = row_reduce(sc, r, max_op) * a.scale_log2;
  } else {
    // the allowed keys of row r are the tile columns [lo, hi]: below the
    // end of K, not after the query (causal), inside the window; taken
    // relative to this thread's column 2 * t4, so each element compares
    // its own compile-time offset 8 * (i >> 2) + (i & 1)
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long first = static_cast<long long>(j) * kBlockN + 2 * t4;
      const long long rel = static_cast<long long>(qpos[r]) - a.k_off - first;
      long long top = a.Tk - 1 - first, bottom = 0;
      if (a.causal && rel < top) top = rel;
      if (a.window > 0) bottom = rel - a.window + 1;
      hi[r] = static_cast<int>(top < -1 ? -1 : top > kBlockN ? kBlockN : top);
      lo[r] = static_cast<int>(bottom < 0 ? 0 : bottom > kBlockN ? kBlockN : bottom);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1, c = 8 * (i >> 2) + (i & 1);
      sc[i] = c >= lo[r] && c <= hi[r] ? sc[i] * a.scale_log2 : kNeg;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = row_reduce(sc, r, max_op);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
  if (interior) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = ex2(fmaf(sc[i], a.scale_log2, -m[(i >> 1) & 1]));
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      sc[i] = sc[i] == kNeg ? 0.f : ex2(sc[i] - m[(i >> 1) & 1]);
  }
  float ps[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) ps[r] = row_reduce(sc, r, add_op);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
}

template <typename T, int D>
__global__ void __launch_bounds__(Smem<D>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to, const Args a) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_addr(smem_raw));
  // barriers: Q full, Q empty; per stage K full, V full, K empty, V empty
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const auto bar = [&](int kind, int s) { return base + L::kBar + 8 * (2 + kind * kStages + s); };
  enum { kKFull, kVFull, kKEmpty, kVEmpty };
  const auto k_tile = [&](int s) { return base + L::kK + s * L::kKBytes; };
  const auto v_tile = [&](int s) { return base + L::kV + s * L::kKBytes; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, L::kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(kKFull, s), 1);
      mbar_init(bar(kVFull, s), 1);
      mbar_init(bar(kKEmpty, s), L::kConsumerWarps);
      mbar_init(bar(kVEmpty, s), L::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load, in the order
    // the consumers use them: Q, K0, then K(n) ahead of V(n-1); the next
    // Q tile's loads start as soon as the consumers release their slots
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kProducerRegs));
    if (threadIdx.x == 0) {
      const auto prefetch = [](const CUtensorMap* map) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
                     : "memory");
      };
      prefetch(&tq);
      prefetch(&tk);
      prefetch(&tv);
      prefetch(&to);
      int kc = 0, vc = 0;  // K and V loads issued so far
      const auto load = [&](const CUtensorMap* map, uint32_t tile, int kind, int c,
                            int j, int h, int b) {
        const int s = c % kStages;
        mbar_wait(bar(kind + 2, s), ((c / kStages) & 1) ^ 1);  // slot released
        mbar_expect_tx(bar(kind, s), L::kKBytes);
        for (int t = 0; t < L::kAtoms; ++t)
          tma_load(tile + s * L::kKBytes + t * L::kKAtom, map, bar(kind, s),
                   t * L::kAtomCols, j * kBlockN, h, b);
      };
      int bh, qb;
      for (int u = 0, qc = 0; walk(a, u, bh, qb); ++u) {
        if (qb < 0) continue;
        const int b = bh / a.H, h = bh % a.H;
        int j_lo, j_hi;
        tile_range<L::kBlockM>(a, qb, j_lo, j_hi);
        const int n_tiles = j_hi - j_lo;
        mbar_wait(q_empty, (qc++ & 1) ^ 1);
        mbar_expect_tx(q_full, L::kQBytes);
        for (int t = 0; t < L::kAtoms; ++t)
          tma_load(base + L::kQ + t * L::kQAtom, &tq, q_full, t * L::kAtomCols,
                   qb * L::kBlockM, h, b);
        for (int n = 0; n <= n_tiles; ++n) {
          if (n < n_tiles) load(&tk, base + L::kK, kKFull, kc++, j_lo + n, h, b);
          if (n > 0) load(&tv, base + L::kV, kVFull, vc++, j_lo + n - 1, h, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each -----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const uint32_t q_rows = base + L::kQ + wg * 64 * L::kRowBytes;
    const uint32_t o_rows = base + L::kO + wg * 64 * L::kRowBytes;
    // S = Q K^T: 64 rows x 128 keys, K-major operands, fp32 accumulation
    const auto issue_qk = [&](float (&sc)[64], int s) {
      const uint64_t dq = make_desc(q_rows, 16, L::kGroupBytes, L::kDescLayout);
      const uint64_t dk = make_desc(k_tile(s), 16, L::kGroupBytes, L::kDescLayout);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int t = kk * 16 / L::kAtomCols;
        const int off = (kk * 16 % L::kAtomCols) * 2;
        Ops<T>::qk(sc, dq + ((t * L::kQAtom + off) >> 4),
                   dk + ((t * L::kKAtom + off) >> 4), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V: V's tile read MN-major (D contiguous), 16 keys a slice
    const auto issue_pv = [&](float (&acc)[D / 2], const uint32_t (&pa)[8][4], int s) {
      const uint64_t dv = make_desc(v_tile(s), L::kKAtom, L::kGroupBytes, L::kDescLayout);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        Ops<T>::template pv<D>(acc, pa[kk], dv + ((kk * 16 * L::kRowBytes) >> 4));
      wgmma_commit();
    };
    const auto wg_sync = [&]() {  // this warpgroup's 128 threads
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    };
    const auto release = [&](uint32_t barrier) {  // this warp is done with it
      __syncwarp();
      if (lane == 0) mbar_arrive(barrier);
    };
    // P rounded to V's dtype in wgmma's register-A layout: S's accumulator
    // layout for keys 16kk..16kk+15 is the A fragment of k-slice kk
    const auto pack = [&](uint32_t (&pa)[8][4], const float (&sc)[64]) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = Ops<T>::pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    };

    int kc = 0, vc = 0;  // K and V tiles consumed so far
    int bh, qb;
    for (int u = 0, qc = 0; walk(a, u, bh, qb); ++u) {
      if (qb < 0) continue;
      const int b = bh / a.H, h = bh % a.H;
      int j_lo, j_hi;
      tile_range<L::kBlockM>(a, qb, j_lo, j_hi);
      const int n_tiles = j_hi - j_lo;
      const int row0 = qb * L::kBlockM + wg * 64 + warp * 16 + g;  // and row0 + 8
      const int qpos[2] = {a.q_off + row0, a.q_off + row0 + 8};
      // this warpgroup's valid query positions, for the tile classes
      const int w_first = a.q_off + qb * L::kBlockM + wg * 64;
      const int w_last = a.q_off + min(qb * L::kBlockM + wg * 64 + 64, a.Tq) - 1;
      const auto interior = [&](int j) {  // wholly allowed for these rows
        const long long k_first = static_cast<long long>(a.k_off) + j * kBlockN;
        return (j + 1) * kBlockN <= a.Tk &&
               (!a.causal || static_cast<long long>(w_first) >= k_first + kBlockN - 1) &&
               (a.window <= 0 || static_cast<long long>(w_last) - k_first < a.window);
      };

      float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, alpha[2];
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float sc[64];
      uint32_t pa[8][4];

      mbar_wait(q_full, qc++ & 1);
      if (n_tiles == 0) release(q_empty);
      if (n_tiles > 0) {
        // Tile n's S product and softmax overlap tile n-1's P V product:
        // both are issued together, the softmax runs once S is done, and
        // O is rescaled after P V lands.  Q is released after the last S.
        int s = kc % kStages;
        mbar_wait(bar(kKFull, s), (kc / kStages) & 1);
        wgmma_fence();
        issue_qk(sc, s);
        wgmma_wait<0>();
        hold(sc);
        release(bar(kKEmpty, s));
        ++kc;
        if (n_tiles == 1) release(q_empty);
        softmax_tile(sc, m, l, alpha, interior(j_lo), j_lo, t4, qpos, a);
        pack(pa, sc);
        for (int n = 1; n < n_tiles; ++n) {
          const int sv = vc % kStages;
          s = kc % kStages;
          mbar_wait(bar(kKFull, s), (kc / kStages) & 1);
          wgmma_fence();
          issue_qk(sc, s);
          mbar_wait(bar(kVFull, sv), (vc / kStages) & 1);
          issue_pv(acc, pa, sv);
          wgmma_wait<1>();  // S of tile n is done, P V of tile n-1 runs on
          hold(sc);
          release(bar(kKEmpty, s));
          ++kc;
          if (n == n_tiles - 1) release(q_empty);
          softmax_tile(sc, m, l, alpha, interior(j_lo + n), j_lo + n, t4, qpos, a);
          wgmma_wait<0>();
          hold(acc);
          hold(pa);
          release(bar(kVEmpty, sv));
          ++vc;
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
          pack(pa, sc);
        }
        const int sv = vc % kStages;
        mbar_wait(bar(kVFull, sv), (vc / kStages) & 1);
        wgmma_fence();
        issue_pv(acc, pa, sv);
        wgmma_wait<0>();
        hold(acc);
        hold(pa);
        release(bar(kVEmpty, sv));
        ++vc;
      }

      // epilogue: o = acc / l through this warpgroup's rows of the O
      // buffer, once the previous tile's store has read them; lse direct
      float safe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        safe[r] = fmaxf(l[r], 1e-30f);
      }
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      wg_sync();
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int t = c * 8 / L::kAtomCols;
        const int col = (c * 8) % L::kAtomCols + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = (warp * 16 + g + 8 * r) * L::kRowBytes + col * 2;
          *reinterpret_cast<uint32_t*>(smem + L::kO + t * L::kQAtom +
                                       wg * 64 * L::kRowBytes +
                                       swizzle<L::kSwizzleBits>(off)) =
              Ops<T>::pack(acc[4 * c + 2 * r] / safe[r], acc[4 * c + 2 * r + 1] / safe[r]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync();
      if (tid == 0) {
        for (int t = 0; t < L::kAtoms; ++t)
          tma_store(&to, o_rows + t * L::kQAtom, t * L::kAtomCols,
                    qb * L::kBlockM + wg * 64, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < a.Tq)
            a.lse[static_cast<long long>(bh) * a.Tq + row] =
                (m[r] == kNeg ? kNeg : m[r] * kLn2) + logf(safe[r]);
        }
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---- host ---------------------------------------------------------------------

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
  using L = Smem<D>;
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

struct Operands {
  const void* q; const void* k; const void* v; void* o;
  int B, H, Tq, Tk;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
      o_sb, o_st, o_sh;
};

template <typename T, int D>
cudaError_t launch(const Operands& x, Args a, cudaStream_t stream) {
  using L = Smem<D>;
  CUtensorMap tq, tk, tv, to;
  if (!encode<T, D>(&tq, x.q, x.B, x.Tq, x.H, x.q_sb, x.q_st, x.q_sh, L::kBlockM) ||
      !encode<T, D>(&tk, x.k, x.B, x.Tk, x.H, x.k_sb, x.k_st, x.k_sh, kBlockN) ||
      !encode<T, D>(&tv, x.v, x.B, x.Tk, x.H, x.v_sb, x.v_st, x.v_sh, kBlockN) ||
      !encode<T, D>(&to, x.o, x.B, x.Tq, x.H, x.o_sb, x.o_st, x.o_sh, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  a.n_qblocks = (a.Tq + L::kBlockM - 1) / L::kBlockM;
  a.n_pairs = (a.n_qblocks + 1) / 2;
  a.n_items = x.B * x.H * a.n_pairs;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  const dim3 grid(a.n_items < sms ? a.n_items : sms);  // persistent: one CTA an SM
  flash_fwd_kernel<T, D><<<grid, L::kThreads, L::kBytes, stream>>>(tq, tk, tv, to, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Operands& x, const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(x, a, stream);
    case 32: return launch<T, 32>(x, a, stream);
    case 64: return launch<T, 64>(x, a, stream);
    case 128: return launch<T, 128>(x, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one CTA at head dim D (bytes), -1 if D is not
// taken: the Q and O tiles, the K/V ring and the barriers.
extern "C" int flash_fwd_smem_bytes(int D) {
  switch (D) {
    case 16: return Smem<16>::kBytes;
    case 32: return Smem<32>::kBytes;
    case 64: return Smem<64>::kBytes;
    case 128: return Smem<128>::kBytes;
    default: return -1;
  }
}

// dtype: 0 = bf16, 1 = fp16.  window <= 0 means no window.  Strides are in
// elements, for the (b, t, h) axes of (B, T, H, D) tensors.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int Tq, int Tk, int D,
                         int dtype, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st,
                         long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, long long o_sb, long long o_st,
                         long long o_sh, int causal, int window, int q_off,
                         int k_off, float scale, void* stream) {
  const Operands x{q, k, v, o, B, H, Tq, Tk,
                   q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                   o_sb, o_st, o_sh};
  const Args a{lse, H, Tq, Tk, 0, 0, 0, causal, window, q_off, k_off, scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<__nv_bfloat16>(x, a, D, st)
                  : dtype == 1 ? dispatch<__half>(x, a, D, st)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
