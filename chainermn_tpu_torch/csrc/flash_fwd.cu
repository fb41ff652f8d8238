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
// a tensor map cannot describe an operand).  The TMA, mbarrier, wgmma,
// swizzle, tile-range and walk helpers are in hopper.cuh, shared with the
// backward kernels (flash_bwd.cu).

#include "hopper.cuh"

namespace {

constexpr int kBlockN = 128;   // keys per K/V tile
constexpr int kStages = 2;     // depth of the K/V ring

// The CTA: a producer warpgroup and kWGs consumer warpgroups of 64 query
// rows each; setmaxnreg splits the register file between them.  Shared
// memory for head dim D: a [rows][D] tile is stored as D / kAtomCols
// swizzle atoms side by side, each `rows` rows of kRowBytes.
template <int D>
struct Smem : Swizzle<D> {
  using G = Swizzle<D>;
  static constexpr int kWGs = 2;
  static constexpr int kBlockM = 64 * kWGs;
  static constexpr int kThreads = 128 * (kWGs + 1);
  static constexpr int kConsumerWarps = 4 * kWGs;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static_assert(128 * kProducerRegs + 128 * kWGs * kConsumerRegs <= 65536, "registers");
  static constexpr int kQAtom = kBlockM * G::kRowBytes;
  static constexpr int kKAtom = kBlockN * G::kRowBytes;
  static constexpr int kQBytes = G::kAtoms * kQAtom;
  static constexpr int kKBytes = G::kAtoms * kKAtom;
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
        tile_range<L::kBlockM, kBlockN>(a, qb, j_lo, j_hi);
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
      tile_range<L::kBlockM, kBlockN>(a, qb, j_lo, j_hi);
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