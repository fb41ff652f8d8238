// Flash-attention backward for Hopper (sm_90a), bf16 or fp16 operands:
// two kernels, one for dq and one for dk/dv.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` (called through
// `_flash_bwd`, with `_recompute_p`) in chainermn_tpu/ops/pallas_attention.py.
// They compute the same functions from the forward's saved `lse` and the
// row term `delta = rowsum(do * o) - dlse`, which the wrapper computes with
// torch ops (the TPU path computes it outside any kernel too):
//
//   s  = (q . k^T with fp32 accumulation) * scale,   scale = D^-0.5;
//   p  = allow ? exp(s - lse) : 0     (the zeroing is load-bearing: a fully
//        masked row has lse ~ -1e30 and would otherwise give p = inf);
//   dp = do . v^T                     (fp32 accumulation);
//   ds = p * (dp - delta) * scale     (the only other place the scale goes);
//   dq = sum over K tiles of (ds cast to k's dtype) . k;
//   dv = sum over Q tiles of (p cast to do's dtype)^T . do;
//   dk = sum over Q tiles of (ds cast to q's dtype)^T . q.
//
// Masking is in GLOBAL positions (q_offset/k_offset), whole tiles are
// skipped by the forward's causal/window predicate, and keys or queries
// past the ragged ends of Tk/Tq are masked.  `lse` and `delta` are fp32
// (B*H, Tq), without the TPU's 128-lane padding.  The exponent is taken
// base 2: log2(e) is folded into the scale and into each row's lse once,
// p = 2^(s * scale * log2 e - lse * log2 e), one ex2 per element.
//
// Bound at the flagship training shape (B=8, H=16, T=2048, D=64, causal,
// bf16): one product over the 268.6 M allowed (q, k) pairs of a head is
// 2*D*pairs*B*H = 34.38 GFLOP.  The dq kernel runs three (QK^T recompute,
// dO.V^T, dS.K): 103.1 GFLOP, 104.3 us at 989 TFLOP/s, against ~170 MB
// moved (50.7 us at 3.35 TB/s), so it is bound by operations.  The dk/dv
// kernel runs four (QK^T, dO.V^T, P^T.dO, dS^T.Q): 137.5 GFLOP, 139.0 us,
// against ~203 MB (60.7 us): bound by operations too.  The least work of
// the whole backward is five products (173.8 us); the two-kernel design
// (the JAX one: no atomics, deterministic, every output element written
// once) recomputes QK^T and dO.V^T once more.
//
// Design, the forward's (flash_fwd.cu) Hopper machinery from hopper.cuh,
// against the six limits of the first (mma.sync) version:
//  1. Synchronous loads: one producer thread issues TMA loads into an
//     mbarrier ring of two stages; the consumers' products never wait
//     for a copy that could have been issued earlier.  The dq kernel
//     loads a Q tile and its dO tile once and streams K and V tiles; the
//     dk/dv kernel loads a K tile and its V tile once and streams Q and dO
//     tiles.  lse and delta: the dq kernel's consumers read their two
//     rows' values once a Q tile; in dk/dv they are indexed by column, so
//     the producer warp's lanes copy each Q tile's slice (scaled lse and
//     delta) into the stage beside Q and dO, with plain loads that need no
//     alignment of a ragged Tq, and arrive on the stage's barrier.
//  2. mma.sync: every product is wgmma.mma_async by two consumer
//     warpgroups of 64 rows (dq: query rows; dk/dv: keys).  dq: S = Q K^T
//     and dP = dO V^T are SS (m64n64k16, both operands K-major); dS stays
//     in registers (the accumulator layout is wgmma's register-A layout)
//     and dQ += dS K is RS, the same K tile read MN-major (the forward's
//     P V on V).  dk/dv: S^T = K Q^T and dP^T = V dO^T are SS with keys as
//     M, so P^T and dS^T land in registers as A operands, and
//     dV += P^T dO, dK += dS^T Q are RS with dO and Q read MN-major from
//     the shared tiles that served as K-major B operands.  setmaxnreg
//     gives the producer warpgroup 40 registers and the consumers 232, but
//     ptxas allocates the consumers' code within the 168 registers of the
//     384-thread launch (their SASS uses none above R165, with setmaxnreg
//     at 240 too, or at 288 threads, where three warps share a scheduler's
//     16K registers), so each kernel keeps its live set under that: dq
//     works a K/V tile in 64-key halves, S and dP of one half in registers
//     at a time (S, dP and dQ of 128 keys spill 296 bytes at D=64), and
//     issues the first half's dQ with the second half's S and dP, so that
//     it runs while the second half's dS is computed.  Every product is
//     issued on every path: ptxas serialises wgmma issued on a
//     data-dependent path (its warning C7520), which cost the dq kernel a
//     third of its time while it skipped halves masked for its rows.
//     (Tried and not kept, all slower: a pipeline across tiles in both
//     kernels, tile n's S and dP issued with tile n-1's last products,
//     which needs such paths and spills in dk/dv at 64-query tiles;
//     32-query tiles in dk/dv; the dk/dv tile in two 32-query halves, the
//     first half's dV and dK products run during the second half's P and
//     dS, as dq does with keys.)
//  3. Scalar operand loads: operands reach the tensor cores through
//     shared-memory descriptors (swizzle by D, hopper.cuh); no fragment is
//     assembled from 16-bit loads, and no K/V fragment is re-read.
//  4. Mask arithmetic on every element: each tile is classed from global
//     positions as skipped (wholly masked for the CTA's rows or keys:
//     never loaded), or, per consumer warpgroup, interior (wholly allowed:
//     no test) or edge (diagonal, window edge, ragged tail, or wholly
//     masked for this warpgroup alone: the exact rule as two compares of
//     a column against the row's allowed range, masked p = 0 without its
//     ex2).  A row that sees no key (lse ~ -1e30) only ever lies in edge
//     tiles.
//  5. Small tiles, naive schedule: dq works on 128-row Q tiles against
//     128-key tiles (64 at D=128, where the Q, dO and dQ tiles take the
//     shared memory), dk/dv on 128-key tiles against 64-query tiles.
//     Both kernels are persistent, one CTA an SM, walking pairs of tiles
//     of one (b, h): the heaviest with the lightest (dq: late Q tiles with
//     early ones; dk/dv: early key tiles with late ones), heads in order so
//     a head's operands stay in L2.  The next work item's tiles load while
//     the consumers finish the last one, and each output tile leaves
//     through its own shared buffer.
//  6. Strided 4-byte Q and dO loads: every tile arrives by TMA over 4-D
//     tensor maps of the strided (B, T, H, D) views, rows past the end as
//     zeros, and dq, dk and dv leave by TMA stores that clip the ragged
//     tail.
//
// Layout: q, k, v, do, dq, dk, dv are (B, T, H, D) with unit stride along
// D and element strides for b, t and h that are multiples of 8 (16-byte
// aligned bases).  The C entry points return the launch's cudaError_t
// (cudaErrorInvalidValue if a tensor map cannot describe an operand).

#include "hopper.cuh"

namespace {

// The CTA: a producer warpgroup (threads 0-127) and kWGs consumer
// warpgroups of 64 rows; setmaxnreg moves registers from the producers
// to the consumers.
constexpr int kStages = 2;          // depth of the streamed-tile ring
constexpr int kWGs = 2;
constexpr int kThreads = 128 * (kWGs + 1);
constexpr int kConsumerWarps = 4 * kWGs;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 128 * kWGs * kConsumerRegs <= 65536, "registers");

// dq kernel's shared memory: the Q and dO tiles of 128 rows, the dQ tile
// on its way out, the K and V ring, the barriers (Q full and empty; per
// stage K/V full and empty); +1024 to align the base to the swizzle.
template <int D>
struct DqSmem : Swizzle<D> {
  using G = Swizzle<D>;
  static constexpr int kBlockM = 64 * kWGs;            // query rows a tile
  static constexpr int kBlockN = D <= 64 ? 128 : 64;   // keys a K/V tile
  static constexpr int kQAtom = kBlockM * G::kRowBytes;
  static constexpr int kKAtom = kBlockN * G::kRowBytes;
  static constexpr int kQBytes = G::kAtoms * kQAtom;
  static constexpr int kKBytes = G::kAtoms * kKAtom;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kDQ = kDO + kQBytes;
  static constexpr int kK = kDQ + kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kKBytes;
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages) + 1024;
};

// dk/dv kernel's shared memory: the K and V tiles of 128 keys, the dK and
// dV tiles on their way out, the Q and dO ring, each stage's scaled lse
// and delta, the barriers (K/V full and empty; per stage full and empty).
template <int D>
struct DkvSmem : Swizzle<D> {
  using G = Swizzle<D>;
  static constexpr int kBlockK = 64 * kWGs;            // keys a tile
  static constexpr int kBlockQ = 64;                   // queries a Q/dO tile: S^T is m64n64
  static constexpr int kKAtom = kBlockK * G::kRowBytes;
  static constexpr int kQAtom = kBlockQ * G::kRowBytes;
  static constexpr int kKBytes = G::kAtoms * kKAtom;
  static constexpr int kQBytes = G::kAtoms * kQAtom;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kDK = kV + kKBytes;
  static constexpr int kDV = kDK + kKBytes;
  static constexpr int kQ = kDV + kKBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kRows = kDO + kStages * kQBytes;  // [stage][lse, delta][kBlockQ]
  static constexpr int kBar = kRows + kStages * 2 * kBlockQ * 4;
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages) + 1024;
};

// A compile-time flag for a generic lambda: the tile class.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

struct Args {
  const float* lse;
  const float* delta;
  int H, Tq, Tk;
  int n_qblocks;         // tiles along the CTA's own axis (dq: Q; dk/dv: K)
  int n_pairs, n_items;  // tile pairs of one (b, h); pairs of all
  int causal, window, q_off, k_off;
  float scale, scale_log2;  // D^-0.5 and D^-0.5 * log2(e)
};

// The allowed columns [lo, hi] (tile-local, clamped to [0, N] and
// [-1, N]) of one row of an edge tile, relative to column `first`:
// rel is the column of the row's own position (causal boundary), Tn the
// columns' extent, and `rows_are_keys` says which side of the causal and
// window rules the columns are on.
template <int N>
__device__ __forceinline__ void col_bounds(const Args& a, long long rel,
                                           long long top, bool rows_are_keys,
                                           int& lo, int& hi) {
  long long bottom = 0;
  if (rows_are_keys) {  // columns are queries: q >= k, q - k < window
    if (a.causal && rel > bottom) bottom = rel;
    if (a.window > 0 && rel + a.window - 1 < top) top = rel + a.window - 1;
  } else {              // columns are keys: k <= q, q - k < window
    if (a.causal && rel < top) top = rel;
    if (a.window > 0) bottom = rel - a.window + 1;
  }
  hi = static_cast<int>(top < -1 ? -1 : top > N ? N : top);
  lo = static_cast<int>(bottom < 0 ? 0 : bottom > N ? N : bottom);
}

// A warpgroup's 64 x D fp32 accumulator (wgmma's layout), rounded to T,
// into its 64 rows of a swizzled [rows][D] shared tile with `atom` bytes
// an atom: `rows` points at the warpgroup's first row.
template <typename T, int D>
__device__ __forceinline__ void stage_out(uint8_t* rows, int atom,
                                          const float (&acc)[D / 2], int warp,
                                          int g, int t4) {
  using G = Swizzle<D>;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int t = c * 8 / G::kAtomCols;
    const int col = (c * 8) % G::kAtomCols + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off = (warp * 16 + g + 8 * r) * G::kRowBytes + col * 2;
      *reinterpret_cast<uint32_t*>(rows + t * atom + swizzle<G::kSwizzleBits>(off)) =
          Ops<T>::pack(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    }
  }
}

// The Q tiles [lo, hi) that see any key of key tile kb (the dk/dv kernel's
// `needed`): every other Q tile is wholly masked for all of its keys.
template <int kBlockK, int kBlockQ>
__device__ __forceinline__ void q_tile_range(const Args& a, int kb, int& lo,
                                             int& hi) {
  const int nq = (a.Tq + kBlockQ - 1) / kBlockQ;
  const long long k_first = static_cast<long long>(a.k_off) + kb * kBlockK;
  const long long k_last =
      static_cast<long long>(a.k_off) + min(kb * kBlockK + kBlockK, a.Tk) - 1;
  lo = 0;
  hi = nq;
  if (a.causal) {  // the first query that sees the tile's oldest key
    const long long first = k_first - a.q_off;
    lo = first <= 0 ? 0 : first / kBlockQ < nq ? static_cast<int>(first / kBlockQ) : nq;
  }
  if (a.window > 0) {  // the last query whose window holds the newest key
    const long long last = k_last + a.window - 1 - a.q_off;
    hi = last < 0 ? 0 : last / kBlockQ + 1 < nq ? static_cast<int>(last / kBlockQ + 1) : nq;
  }
  if (hi < lo) hi = lo;
}

__device__ __forceinline__ void init_barriers(uint32_t bar, int n_stages,
                                              int full_count) {
  // bar: item full, item empty, then per stage full and empty
  mbar_init(bar, 1);
  mbar_init(bar + 8, kConsumerWarps);
  for (int s = 0; s < n_stages; ++s) {
    mbar_init(bar + 16 + 8 * s, full_count);
    mbar_init(bar + 16 + 8 * (n_stages + s), kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- dq ------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdq, const Args a) {
  using L = DqSmem<D>;
  constexpr int BM = L::kBlockM, BN = L::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const auto full = [&](int s) { return base + L::kBar + 16 + 8 * s; };
  const auto empty = [&](int s) { return base + L::kBar + 16 + 8 * (kStages + s); };
  const auto k_tile = [&](int s) { return base + L::kK + s * L::kKBytes; };
  const auto v_tile = [&](int s) { return base + L::kV + s * L::kKBytes; };

  if (threadIdx.x == 0) init_barriers(q_full, kStages, 1);
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread loads each Q tile with its dO tile, then
    // the K and V tiles it sees, in the order the consumers use them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&tdo);
      prefetch_map(&tdq);
      int bh, qb;
      for (int u = 0, qc = 0, kc = 0; walk(a, u, bh, qb); ++u) {
        if (qb < 0) continue;
        const int b = bh / a.H, h = bh % a.H;
        int j_lo, j_hi;
        tile_range<BM, BN>(a, qb, j_lo, j_hi);
        mbar_wait(q_empty, (qc++ & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * L::kQBytes);
        for (int t = 0; t < L::kAtoms; ++t) {
          tma_load(base + L::kQ + t * L::kQAtom, &tq, q_full, t * L::kAtomCols, qb * BM, h, b);
          tma_load(base + L::kDO + t * L::kQAtom, &tdo, q_full, t * L::kAtomCols, qb * BM, h, b);
        }
        for (int j = j_lo; j < j_hi; ++j, ++kc) {
          const int s = kc % kStages;
          mbar_wait(empty(s), ((kc / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * L::kKBytes);
          for (int t = 0; t < L::kAtoms; ++t) {
            tma_load(k_tile(s) + t * L::kKAtom, &tk, full(s), t * L::kAtomCols, j * BN, h, b);
            tma_load(v_tile(s) + t * L::kKAtom, &tv, full(s), t * L::kAtomCols, j * BN, h, b);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each -----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const uint32_t q_rows = base + L::kQ + wg * 64 * L::kRowBytes;
    const uint32_t do_rows = base + L::kDO + wg * 64 * L::kRowBytes;
    // A K/V tile is worked in 64-key halves, so that S and dP of one half
    // are in registers at a time and the first half's dQ product runs on
    // the tensor cores while the second half's dS is computed.
    constexpr int NS = BN / 64;
    // S = Q K^T and dP = dO V^T over keys [64 hf, 64 hf + 64) of stage s:
    // 64 rows x 64 keys, K-major operands
    const auto issue_s_dp = [&](float (&sc)[32], float (&dp)[32], int s, int hf) {
      const uint32_t k_rows = k_tile(s) + hf * 64 * L::kRowBytes;
      const uint32_t v_rows = v_tile(s) + hf * 64 * L::kRowBytes;
      const uint64_t dq_ = make_desc(q_rows, 16, L::kGroupBytes, L::kDescLayout);
      const uint64_t dk = make_desc(k_rows, 16, L::kGroupBytes, L::kDescLayout);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int t = kk * 16 / L::kAtomCols;
        const int off = (kk * 16 % L::kAtomCols) * 2;
        Ops<T>::ss64(sc, dq_ + ((t * L::kQAtom + off) >> 4),
                                dk + ((t * L::kKAtom + off) >> 4), kk > 0);
      }
      const uint64_t ddo = make_desc(do_rows, 16, L::kGroupBytes, L::kDescLayout);
      const uint64_t dv = make_desc(v_rows, 16, L::kGroupBytes, L::kDescLayout);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int t = kk * 16 / L::kAtomCols;
        const int off = (kk * 16 % L::kAtomCols) * 2;
        Ops<T>::ss64(dp, ddo + ((t * L::kQAtom + off) >> 4),
                                dv + ((t * L::kKAtom + off) >> 4), kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K over the half's keys: K read MN-major (D contiguous), 16
    // keys a slice
    const auto issue_dq = [&](float (&acc)[D / 2], const uint32_t (&pa)[4][4], int s,
                              int hf) {
      const uint64_t dk = make_desc(k_tile(s) + hf * 64 * L::kRowBytes, L::kKAtom,
                                    L::kGroupBytes, L::kDescLayout);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Ops<T>::template pv<D>(acc, pa[kk], dk + ((kk * 16 * L::kRowBytes) >> 4));
      wgmma_commit();
    };
    const auto wg_sync = [&]() {  // this warpgroup's 128 threads
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    };
    const auto release = [&](uint32_t barrier) {  // this warp is done with it
      __syncwarp();
      if (lane == 0) mbar_arrive(barrier);
    };

    int bh, qb;
    for (int u = 0, qc = 0, kc = 0; walk(a, u, bh, qb); ++u) {
      if (qb < 0) continue;
      const int b = bh / a.H, h = bh % a.H;
      int j_lo, j_hi;
      tile_range<BM, BN>(a, qb, j_lo, j_hi);
      const int n_tiles = j_hi - j_lo;
      const int row0 = qb * BM + wg * 64 + warp * 16 + g;  // and row0 + 8
      const int qpos[2] = {a.q_off + row0, a.q_off + row0 + 8};
      float lse2[2], dl[2];  // lse * log2(e) and delta of the two rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const long long i = static_cast<long long>(bh) * a.Tq + row;
        lse2[r] = row < a.Tq ? a.lse[i] * kLog2e : 0.f;
        dl[r] = row < a.Tq ? a.delta[i] : 0.f;
      }
      // this warpgroup's valid query positions, for the classes of the
      // 64-key halves (key index c0 of the tile's first key)
      const int w_row = qb * BM + wg * 64;
      const long long w_first = static_cast<long long>(a.q_off) + w_row;
      const long long w_last = static_cast<long long>(a.q_off) + min(w_row + 64, a.Tq) - 1;
      const auto interior = [&](int c0) {  // wholly allowed for these rows
        const long long k_first = static_cast<long long>(a.k_off) + c0;
        return c0 + 64 <= a.Tk && (!a.causal || w_first >= k_first + 63) &&
               (a.window <= 0 || w_last - k_first < a.window);
      };
      // p and ds of one half in place of dp, rounded to K's dtype into
      // wgmma's register-A layout: sc element i is row r = (i >> 1) & 1,
      // key column c0 + 8 * (i >> 2) + 2 * t4 + (i & 1)
      const auto p_ds = [&](const float (&sc)[32], float (&dp)[32], uint32_t (&pa)[4][4],
                            int c0) {
        if (interior(c0)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            const float p = ex2(fmaf(sc[i], a.scale_log2, -lse2[r]));
            dp[i] = p * (dp[i] - dl[r]) * a.scale;
          }
        } else {
          int lo[2], hi[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const long long first = static_cast<long long>(c0) + 2 * t4;
            col_bounds<64>(a, static_cast<long long>(qpos[r]) - a.k_off - first,
                           a.Tk - 1 - first, false, lo[r], hi[r]);
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1, c = 8 * (i >> 2) + (i & 1);
            const float p = c >= lo[r] && c <= hi[r]
                                ? ex2(fmaf(sc[i], a.scale_log2, -lse2[r])) : 0.f;
            dp[i] = p * (dp[i] - dl[r]) * a.scale;
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] = Ops<T>::pack(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      };

      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float sc[32], dp[32];
      uint32_t pa[NS][4][4];

      mbar_wait(q_full, qc++ & 1);
      if (n_tiles == 0) release(q_empty);
      for (int n = 0; n < n_tiles; ++n, ++kc) {
        const int j = j_lo + n, s = kc % kStages;
        mbar_wait(full(s), (kc / kStages) & 1);
        // every product is issued on every path (a half wholly masked for
        // these rows has p = 0): ptxas serialises wgmma issued on a
        // data-dependent path
#pragma unroll
        for (int hf = 0; hf < NS; ++hf) {
          wgmma_fence();
          issue_s_dp(sc, dp, s, hf);
          if (hf > 0) {  // the previous half's dQ
            issue_dq(acc, pa[hf > 0 ? hf - 1 : 0], s, hf - 1);
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          hold(sc);
          hold(dp);
          p_ds(sc, dp, pa[hf], j * BN + 64 * hf);
        }
        if (n == n_tiles - 1) release(q_empty);  // every S and dP is done
        wgmma_fence();
        issue_dq(acc, pa[NS - 1], s, NS - 1);
        wgmma_wait<0>();
        hold(acc);
#pragma unroll
        for (int hf = 0; hf < NS; ++hf) hold(pa[hf]);
        release(empty(s));
      }

      // epilogue: dQ through this warpgroup's rows of the dQ buffer, once
      // the previous tile's store has read them
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      wg_sync();
      stage_out<T, D>(smem + L::kDQ + wg * 64 * L::kRowBytes, L::kQAtom, acc, warp, g, t4);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync();
      if (tid == 0) {
        for (int t = 0; t < L::kAtoms; ++t)
          tma_store(&tdq, base + L::kDQ + wg * 64 * L::kRowBytes + t * L::kQAtom,
                    t * L::kAtomCols, w_row, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---- dk / dv -------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdk,
                     const __grid_constant__ CUtensorMap tdv, const Args a) {
  using L = DkvSmem<D>;
  constexpr int BK = L::kBlockK, BQ = L::kBlockQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t kv_full = base + L::kBar, kv_empty = kv_full + 8;
  const auto full = [&](int s) { return base + L::kBar + 16 + 8 * s; };
  const auto empty = [&](int s) { return base + L::kBar + 16 + 8 * (kStages + s); };
  const auto q_tile = [&](int s) { return base + L::kQ + s * L::kQBytes; };
  const auto do_tile = [&](int s) { return base + L::kDO + s * L::kQBytes; };
  // [lse * log2(e), delta] of stage s's queries
  const auto rows = [&](int s) {
    return reinterpret_cast<float*>(smem + L::kRows) + s * 2 * BQ;
  };

  // a stage fills with the TMA bytes and the arrivals of the producer
  // warp's 32 threads, once each has written its lse and delta
  if (threadIdx.x == 0) init_barriers(kv_full, kStages, 32);
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32) return;
    // ---- producer warp: lane 0 loads each K tile with its V tile, then
    // the Q and dO tiles that see them; every lane copies its share of
    // each Q tile's lse (times log2 e) and delta, zeros past Tq, into the
    // tile's stage before it arrives on the stage's barrier
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&tdo);
      prefetch_map(&tdk);
      prefetch_map(&tdv);
    }
    int bh, kb;
    for (int u = 0, kvc = 0, qc = 0; walk(a, u, bh, kb); ++u) {
      if (kb < 0) continue;
      const int b = bh / a.H, h = bh % a.H;
      int i_lo, i_hi;
      q_tile_range<BK, BQ>(a, kb, i_lo, i_hi);
      if (lane == 0) {
        mbar_wait(kv_empty, (kvc & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * L::kKBytes);
        for (int t = 0; t < L::kAtoms; ++t) {
          tma_load(base + L::kK + t * L::kKAtom, &tk, kv_full, t * L::kAtomCols, kb * BK, h, b);
          tma_load(base + L::kV + t * L::kKAtom, &tv, kv_full, t * L::kAtomCols, kb * BK, h, b);
        }
      }
      ++kvc;
      for (int i = i_lo; i < i_hi; ++i, ++qc) {
        const int s = qc % kStages;
        mbar_wait(empty(s), ((qc / kStages) & 1) ^ 1);
        float* r = rows(s);
        for (int c = lane; c < BQ; c += 32) {
          const int q = i * BQ + c;
          const long long at = static_cast<long long>(bh) * a.Tq + q;
          r[c] = q < a.Tq ? a.lse[at] * kLog2e : 0.f;
          r[BQ + c] = q < a.Tq ? a.delta[at] : 0.f;
        }
        if (lane == 0) {  // its arrival carries the TMA bytes
          mbar_expect_tx(full(s), 2 * L::kQBytes);
          for (int t = 0; t < L::kAtoms; ++t) {
            tma_load(q_tile(s) + t * L::kQAtom, &tq, full(s), t * L::kAtomCols, i * BQ, h, b);
            tma_load(do_tile(s) + t * L::kQAtom, &tdo, full(s), t * L::kAtomCols, i * BQ, h, b);
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const uint32_t k_rows = base + L::kK + wg * 64 * L::kRowBytes;
    const uint32_t v_rows = base + L::kV + wg * 64 * L::kRowBytes;
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries, K-major operands
    const auto issue_s_dp = [&](float (&st)[BQ / 2], float (&dpt)[BQ / 2], int s) {
      const uint64_t dk = make_desc(k_rows, 16, L::kGroupBytes, L::kDescLayout);
      const uint64_t dq_ = make_desc(q_tile(s), 16, L::kGroupBytes, L::kDescLayout);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int t = kk * 16 / L::kAtomCols;
        const int off = (kk * 16 % L::kAtomCols) * 2;
        Ops<T>::ss64(st, dk + ((t * L::kKAtom + off) >> 4),
                                dq_ + ((t * L::kQAtom + off) >> 4), kk > 0);
      }
      const uint64_t dv = make_desc(v_rows, 16, L::kGroupBytes, L::kDescLayout);
      const uint64_t ddo = make_desc(do_tile(s), 16, L::kGroupBytes, L::kDescLayout);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int t = kk * 16 / L::kAtomCols;
        const int off = (kk * 16 % L::kAtomCols) * 2;
        Ops<T>::ss64(dpt, dv + ((t * L::kKAtom + off) >> 4),
                                ddo + ((t * L::kQAtom + off) >> 4), kk > 0);
      }
      wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q: dO and Q read MN-major, 16 queries a
    // slice
    const auto issue_dkv = [&](float (&dk)[D / 2], float (&dv)[D / 2],
                               const uint32_t (&pa)[BQ / 16][4],
                               const uint32_t (&dsa)[BQ / 16][4], int s) {
      const uint64_t ddo = make_desc(do_tile(s), L::kQAtom, L::kGroupBytes, L::kDescLayout);
      const uint64_t dq_ = make_desc(q_tile(s), L::kQAtom, L::kGroupBytes, L::kDescLayout);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Ops<T>::template pv<D>(dv, pa[kk], ddo + ((kk * 16 * L::kRowBytes) >> 4));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Ops<T>::template pv<D>(dk, dsa[kk], dq_ + ((kk * 16 * L::kRowBytes) >> 4));
      wgmma_commit();
    };
    const auto wg_sync = [&]() {
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    };
    const auto release = [&](uint32_t barrier) {
      __syncwarp();
      if (lane == 0) mbar_arrive(barrier);
    };

    int bh, kb;
    for (int u = 0, kvc = 0, qc = 0; walk(a, u, bh, kb); ++u) {
      if (kb < 0) continue;
      int i_lo, i_hi;
      q_tile_range<BK, BQ>(a, kb, i_lo, i_hi);
      const int n_tiles = i_hi - i_lo;
      const int key0 = kb * BK + wg * 64 + warp * 16 + g;  // and key0 + 8
      // this warpgroup's valid key positions, for the tile classes
      const int w_key = kb * BK + wg * 64;
      const long long w_first = static_cast<long long>(a.k_off) + w_key;
      const long long w_last = static_cast<long long>(a.k_off) + min(w_key + 64, a.Tk) - 1;
      const auto q_first = [&](int i) { return static_cast<long long>(a.q_off) + i * BQ; };
      const auto interior = [&](int i) {  // wholly allowed for these keys
        return (i + 1) * BQ <= a.Tq && w_key + 64 <= a.Tk &&
               (!a.causal || q_first(i) >= w_last) &&
               (a.window <= 0 || q_first(i) + BQ - 1 - w_first < a.window);
      };
      // the interior tiles are one run [n_lo, n_hi): two registers in the
      // loop instead of the positions above
      int n_lo = i_hi, n_hi = i_hi;
      for (int i = i_lo; i < i_hi; ++i) {
        if (interior(i)) {
          n_lo = min(n_lo, i);
          n_hi = i + 1;
        }
      }

      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
      float st[BQ / 2], dpt[BQ / 2];
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];

      mbar_wait(kv_full, kvc++ & 1);
      if (n_tiles == 0) release(kv_empty);
      for (int n = 0; n < n_tiles; ++n, ++qc) {
        const int i = i_lo + n, s = qc % kStages;
        mbar_wait(full(s), (qc / kStages) & 1);
        // every product is issued on every path (a tile wholly masked for
        // these keys has p = 0): ptxas serialises wgmma issued on a
        // data-dependent path
        wgmma_fence();
        issue_s_dp(st, dpt, s);
        wgmma_wait<0>();
        hold(st);
        hold(dpt);
        if (n == n_tiles - 1) release(kv_empty);
        // P^T and dS^T: st element e is key row r = (e >> 1) & 1 of the
        // thread's two, query column 8 * (e >> 2) + 2 * t4 + (e & 1); the
        // columns' lse and delta come from the stage, two at a time
        const float* lse2 = rows(s);
        const float* dl = lse2 + BQ;
        const auto p_ds = [&](auto edge) {
          int lo[2], hi[2];
          if constexpr (decltype(edge)::value) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const long long first = static_cast<long long>(i) * BQ + 2 * t4;
              col_bounds<BQ>(a, static_cast<long long>(a.k_off) + key0 + 8 * r - a.q_off - first,
                             a.Tq - 1 - first, true, lo[r], hi[r]);
              if (key0 + 8 * r >= a.Tk) hi[r] = -1;
            }
          }
#pragma unroll
          for (int c8 = 0; c8 < BQ / 8; ++c8) {
            const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * c8 + 2 * t4);
            const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * c8 + 2 * t4);
            float p[4], ds[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int e = 4 * c8 + x, r = x >> 1, c = 8 * c8 + (x & 1);
              const float l = (x & 1) ? l2.y : l2.x, d = (x & 1) ? d2.y : d2.x;
              if constexpr (decltype(edge)::value)
                p[x] = c >= lo[r] && c <= hi[r] ? ex2(fmaf(st[e], a.scale_log2, -l)) : 0.f;
              else
                p[x] = ex2(fmaf(st[e], a.scale_log2, -l));
              ds[x] = p[x] * (dpt[e] - d) * a.scale;
            }
            // accumulator pairs (4 c8 + 2 r, +1) are A registers 2 c8 + r
            // of the flat [BQ / 16][4] fragment array
            pa[c8 >> 1][2 * (c8 & 1)] = Ops<T>::pack(p[0], p[1]);
            pa[c8 >> 1][2 * (c8 & 1) + 1] = Ops<T>::pack(p[2], p[3]);
            dsa[c8 >> 1][2 * (c8 & 1)] = Ops<T>::pack(ds[0], ds[1]);
            dsa[c8 >> 1][2 * (c8 & 1) + 1] = Ops<T>::pack(ds[2], ds[3]);
          }
        };
        if (i >= n_lo && i < n_hi)
          p_ds(Flag<false>{});
        else
          p_ds(Flag<true>{});
        wgmma_fence();
        issue_dkv(dk, dv, pa, dsa, s);
        wgmma_wait<0>();
        hold(dk);
        hold(dv);
        hold(pa);
        hold(dsa);
        release(empty(s));
      }

      // epilogue: dK and dV through this warpgroup's rows of their
      // buffers, once the previous tile's stores have read them
      const int b = bh / a.H, h = bh % a.H;
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      wg_sync();
      stage_out<T, D>(smem + L::kDK + wg * 64 * L::kRowBytes, L::kKAtom, dk, warp, g, t4);
      stage_out<T, D>(smem + L::kDV + wg * 64 * L::kRowBytes, L::kKAtom, dv, warp, g, t4);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync();
      if (tid == 0) {
        for (int t = 0; t < L::kAtoms; ++t) {
          tma_store(&tdk, base + L::kDK + wg * 64 * L::kRowBytes + t * L::kKAtom,
                    t * L::kAtomCols, w_key, h, b);
          tma_store(&tdv, base + L::kDV + wg * 64 * L::kRowBytes + t * L::kKAtom,
                    t * L::kAtomCols, w_key, h, b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---- host ---------------------------------------------------------------------

struct Operands {
  const void* q; const void* k; const void* v; const void* dout;
  void* dq; void* dk; void* dv;
  int B;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
      do_sb, do_st, do_sh, dq_sb, dq_st, dq_sh, dk_sb, dk_st, dk_sh,
      dv_sb, dv_st, dv_sh;
};

// Persistent grid: one CTA an SM, at most one a work item.
cudaError_t grid_size(const Args& a, int& grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  grid = a.n_items < sms ? a.n_items : sms;
  return err;
}

template <typename T, int D>
cudaError_t launch_dq(const Operands& x, Args a, cudaStream_t stream) {
  using L = DqSmem<D>;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!encode<T, D>(&tq, x.q, x.B, a.Tq, a.H, x.q_sb, x.q_st, x.q_sh, L::kBlockM) ||
      !encode<T, D>(&tk, x.k, x.B, a.Tk, a.H, x.k_sb, x.k_st, x.k_sh, L::kBlockN) ||
      !encode<T, D>(&tv, x.v, x.B, a.Tk, a.H, x.v_sb, x.v_st, x.v_sh, L::kBlockN) ||
      !encode<T, D>(&tdo, x.dout, x.B, a.Tq, a.H, x.do_sb, x.do_st, x.do_sh, L::kBlockM) ||
      !encode<T, D>(&tdq, x.dq, x.B, a.Tq, a.H, x.dq_sb, x.dq_st, x.dq_sh, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  a.n_qblocks = (a.Tq + L::kBlockM - 1) / L::kBlockM;
  a.n_pairs = (a.n_qblocks + 1) / 2;
  a.n_items = x.B * a.H * a.n_pairs;
  int grid = 0;
  if ((err = grid_size(a, grid)) != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, L::kBytes, stream>>>(tq, tk, tv, tdo, tdq, a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Operands& x, Args a, cudaStream_t stream) {
  using L = DkvSmem<D>;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  if (!encode<T, D>(&tq, x.q, x.B, a.Tq, a.H, x.q_sb, x.q_st, x.q_sh, L::kBlockQ) ||
      !encode<T, D>(&tk, x.k, x.B, a.Tk, a.H, x.k_sb, x.k_st, x.k_sh, L::kBlockK) ||
      !encode<T, D>(&tv, x.v, x.B, a.Tk, a.H, x.v_sb, x.v_st, x.v_sh, L::kBlockK) ||
      !encode<T, D>(&tdo, x.dout, x.B, a.Tq, a.H, x.do_sb, x.do_st, x.do_sh, L::kBlockQ) ||
      !encode<T, D>(&tdk, x.dk, x.B, a.Tk, a.H, x.dk_sb, x.dk_st, x.dk_sh, 64) ||
      !encode<T, D>(&tdv, x.dv, x.B, a.Tk, a.H, x.dv_sb, x.dv_st, x.dv_sh, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  a.n_qblocks = (a.Tk + L::kBlockK - 1) / L::kBlockK;  // key tiles
  a.n_pairs = (a.n_qblocks + 1) / 2;
  a.n_items = x.B * a.H * a.n_pairs;
  int grid = 0;
  if ((err = grid_size(a, grid)) != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, L::kBytes, stream>>>(tq, tk, tv, tdo, tdk,
                                                                    tdv, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Operands& x, const Args& a, int D, bool dkv,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return dkv ? launch_dkv<T, 16>(x, a, stream) : launch_dq<T, 16>(x, a, stream);
    case 32: return dkv ? launch_dkv<T, 32>(x, a, stream) : launch_dq<T, 32>(x, a, stream);
    case 64: return dkv ? launch_dkv<T, 64>(x, a, stream) : launch_dq<T, 64>(x, a, stream);
    case 128: return dkv ? launch_dkv<T, 128>(x, a, stream) : launch_dq<T, 128>(x, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Operands& x, const Args& a, int D, int dtype, bool dkv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<__nv_bfloat16>(x, a, D, dkv, st)
                  : dtype == 1 ? dispatch<__half>(x, a, D, dkv, st)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Dynamic shared memory of one CTA at head dim D (bytes), -1 if D is not
// taken: dkv = 0 for the dq kernel, 1 for the dk/dv kernel.
extern "C" int flash_bwd_smem_bytes(int D, int dkv) {
  switch (D) {
    case 16: return dkv ? DkvSmem<16>::kBytes : DqSmem<16>::kBytes;
    case 32: return dkv ? DkvSmem<32>::kBytes : DqSmem<32>::kBytes;
    case 64: return dkv ? DkvSmem<64>::kBytes : DqSmem<64>::kBytes;
    case 128: return dkv ? DkvSmem<128>::kBytes : DqSmem<128>::kBytes;
    default: return -1;
  }
}

// dtype: 0 = bf16, 1 = fp16.  window <= 0 means no window.  Strides are in
// elements, for the (b, t, h) axes of (B, T, H, D) tensors; lse and delta
// are fp32 (B*H, Tq) contiguous.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int H,
                            int Tq, int Tk, int D, int dtype, long long q_sb,
                            long long q_st, long long q_sh, long long k_sb,
                            long long k_st, long long k_sh, long long v_sb,
                            long long v_st, long long v_sh, long long do_sb,
                            long long do_st, long long do_sh, long long dq_sb,
                            long long dq_st, long long dq_sh, int causal,
                            int window, int q_off, int k_off, float scale,
                            void* stream) {
  const Operands x{q, k, v, dout, dq, nullptr, nullptr, B,
                   q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                   do_sb, do_st, do_sh, dq_sb, dq_st, dq_sh, 0, 0, 0, 0, 0, 0};
  const Args a{lse, delta, H, Tq, Tk, 0, 0, 0, causal, window, q_off, k_off,
               scale, scale * kLog2e};
  return run(x, a, D, dtype, false, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int B,
                             int H, int Tq, int Tk, int D, int dtype,
                             long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh,
                             long long v_sb, long long v_st, long long v_sh,
                             long long do_sb, long long do_st, long long do_sh,
                             long long dk_sb, long long dk_st, long long dk_sh,
                             long long dv_sb, long long dv_st, long long dv_sh,
                             int causal, int window, int q_off, int k_off,
                             float scale, void* stream) {
  const Operands x{q, k, v, dout, nullptr, dk, dv, B,
                   q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                   do_sb, do_st, do_sh, 0, 0, 0, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh};
  const Args a{lse, delta, H, Tq, Tk, 0, 0, 0, causal, window, q_off, k_off,
               scale, scale * kLog2e};
  return run(x, a, D, dtype, true, stream);
}
