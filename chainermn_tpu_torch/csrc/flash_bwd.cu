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
//        masked row has lse ~ -1e30 and would otherwise give p = 1);
//   dp = do . v^T                     (fp32 accumulation);
//   ds = p * (dp - delta) * scale     (the only other place the scale goes);
//   dq = sum over K tiles of (ds cast to k's dtype) . k;
//   dv = sum over Q tiles of (p cast to do's dtype)^T . do;
//   dk = sum over Q tiles of (ds cast to q's dtype)^T . q.
//
// Masking is in GLOBAL positions (q_offset/k_offset), whole tiles are
// skipped by the forward's causal/window predicate, and keys or queries
// past the ragged ends of Tk/Tq are masked.  `lse` and `delta` are fp32
// (B*H, Tq), without the TPU's 128-lane padding.
//
// Design (the JAX one: two kernels, no atomics, deterministic):
// - dq kernel: one block of 4 warps owns 64 query rows of one (b, h) and
//   loops over K tiles of 64 keys; each warp owns 16 rows.  Q and dO
//   fragments stay in registers; K and V tiles are staged in shared
//   memory.  S and dP are formed 16 keys at a time, and dS (the
//   accumulator layout of two 8-key n-tiles is the A-fragment layout of
//   one 16-key k-slice) feeds dQ += dS . K without leaving registers.
//   K is the B operand along the key axis there, read with 16-bit shared
//   loads (the transposed read of the forward's V).
// - dk/dv kernel: one block owns 64 keys and loops over Q tiles of 64
//   rows; each warp owns 16 keys and computes S^T = K . Q^T and
//   dP^T = V . dO^T directly, keys as the M dimension, so P^T and dS^T
//   land in the accumulator layout and feed dV += P^T . dO and
//   dK += dS^T . Q as A operands.  lse and delta are indexed by query
//   (the column), so they are staged per Q tile in shared memory.  K and
//   V fragments stay in registers for D <= 64; at D = 128 they are
//   re-read from shared memory, which keeps the two fp32 (16 x D)
//   accumulators of a warp in registers.
// Both accumulate in fp32 registers and write each output element once.
//
// Bound at the flagship training shape (B=8, H=16, T=2048, D=64, causal,
// bf16): one product over the 268.6 M allowed (q, k) pairs of a head is
// 2*D*pairs*B*H = 34.38 GFLOP.  The dq kernel runs three (QK^T recompute,
// dO.V^T, dS.K): 103.1 GFLOP, 104.3 us at 989 TFLOP/s, against ~170 MB
// moved (50.7 us at 3.35 TB/s), so it is bound by operations.  The dk/dv
// kernel runs four (QK^T, dO.V^T, P^T.dO, dS^T.Q): 137.5 GFLOP, 139.0 us,
// against ~203 MB (60.7 us): bound by operations too.  The least work of
// the whole backward is five products (173.8 us); the two-kernel design
// recomputes QK^T and dO.V^T once more to need no atomics.  This first
// version uses warp-level mma.sync (m16n8k16) on 64 x 64 tiles without
// pipelining, wgmma or TMA, so it stays well short of those bounds.
//
// Layout: q, k, v, do, dq, dk, dv are (B, T, H, D) with unit stride along
// D and element strides for b, t and h that are multiples of 8 (16-byte
// aligned bases).  The C entry points return the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;    // query rows (dq) or keys (dk/dv) per block
constexpr int kWarps = 4;     // 16 rows or keys per warp
constexpr int kThreads = kWarps * 32;

template <typename T> struct Ops;

template <> struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two floats -> one register, `lo` in the low half (smaller column)
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Ops<__half> {
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta;
  void* dq; void* dk; void* dv;
  int H, Tq, Tk;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
      do_sb, do_st, do_sh, dq_sb, dq_st, dq_sh, dk_sb, dk_st, dk_sh,
      dv_sb, dv_st, dv_sh;
  int causal, window, q_off, k_off;
  float scale;
};

// two consecutive 16-bit elements as one register (4-byte aligned: even col)
template <typename T>
__device__ __forceinline__ uint32_t ld2(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two 16-bit elements from separate addresses, `lo` in the low half
template <typename T>
__device__ __forceinline__ uint32_t join2(const T& lo, const T& hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

// A fragment (16 x 16, k-slice s) of rows r0 and r0 + 8 of a row-major
// shared tile `m` with leading dimension LD
template <typename T, int LD>
__device__ __forceinline__ void afrag(const T* m, int r0, int s, int t4,
                                      uint32_t (&f)[4]) {
  const T* p = m + r0 * LD + s * 16 + t4 * 2;
  f[0] = ld2(p);
  f[1] = ld2(p + 8 * LD);
  f[2] = ld2(p + 8);
  f[3] = ld2(p + 8 * LD + 8);
}

// Copy rows [row0, row0 + kBlock) of a (T, D) slice with row stride `st`
// into a shared tile, zero-filling rows at or past `n`.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(T (*dst)[LD], const T* src, long long st,
                                      int row0, int n) {
  for (int c = threadIdx.x; c < kBlock * D / 8; c += kThreads) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const int gr = row0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (gr < n) x = *reinterpret_cast<const uint4*>(src + gr * st + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = x;
  }
}

// the forward's mask, in global positions
__device__ __forceinline__ bool allowed(const Args& a, int qi, int ki) {
  bool ok = qi < a.Tq && ki < a.Tk;
  const int qp = a.q_off + qi, kp = a.k_off + ki;
  if (a.causal) ok = ok && qp >= kp;
  if (a.window > 0) ok = ok && (qp - kp) < a.window;
  return ok;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = D + 8;          // padded smem row
  constexpr int KS = D / 16;         // k-slices along D
  constexpr int ND = D / 8;          // n-tiles of dQ (8 features each)
  __shared__ __align__(16) T ks[kBlock][LD];
  __shared__ __align__(16) T vs[kBlock][LD];

  const int bh = blockIdx.x, qb = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;

  // this thread's two rows: r0 (fragment halves c0,c1) and r0 + 8 (c2,c3)
  const int r0 = qb * kBlock + warp * 16 + g;
  const int rows[2] = {r0, r0 + 8};

  // Q and dO fragments stay in registers for the whole K sweep
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s * 16 + t4 * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < a.Tq;
      const T* qr = q + static_cast<long long>(rows[r]) * a.q_st;
      const T* dr = dout + static_cast<long long>(rows[r]) * a.do_st;
      qa[s][r] = in ? ld2(qr + c) : 0u;
      qa[s][r + 2] = in ? ld2(qr + c + 8) : 0u;
      da[s][r] = in ? ld2(dr + c) : 0u;
      da[s][r + 2] = in ? ld2(dr + c + 8) : 0u;
    }
  }
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < a.Tq;
    const long long i = static_cast<long long>(bh) * a.Tq + rows[r];
    lse[r] = in ? a.lse[i] : 0.f;
    dl[r] = in ? a.delta[i] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // block-uniform tile predicate (the TPU kernel's `needed`)
  const int q_first = a.q_off + qb * kBlock;
  const int q_last = q_first + kBlock - 1;
  const int nk = (a.Tk + kBlock - 1) / kBlock;

  for (int j = 0; j < nk; ++j) {
    const int k_first = a.k_off + j * kBlock;
    if (a.causal && q_last < k_first) break;  // every later tile is future
    if (a.window > 0 && k_first + kBlock - 1 < q_first - (a.window - 1))
      continue;                               // tile wholly before window

    __syncthreads();  // every warp is done with the previous tile
    stage<T, D, LD>(ks, k, a.k_st, j * kBlock, a.Tk);
    stage<T, D, LD>(vs, v, a.v_st, j * kBlock, a.Tk);
    __syncthreads();

#pragma unroll
    for (int t = 0; t < kBlock / 16; ++t) {   // 16 keys: n-tiles 2t, 2t+1
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int n = 2 * t + nn;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nn][e] = dp[nn][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const T* kr = &ks[n * 8 + g][kk * 16 + t4 * 2];
          Ops<T>::mma(s[nn], qa[kk], ld2(kr), ld2(kr + 8));
          const T* vr = &vs[n * 8 + g][kk * 16 + t4 * 2];
          Ops<T>::mma(dp[nn], da[kk], ld2(vr), ld2(vr + 8));
        }
      }
      // p and ds in place of s
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = j * kBlock + (2 * t + nn) * 8 + t4 * 2 + (e & 1);
          const float p = allowed(a, rows[r], col)
                              ? __expf(s[nn][e] * a.scale - lse[r]) : 0.f;
          s[nn][e] = p * (dp[nn][e] - dl[r]) * a.scale;
        }
      }
      // dQ += dS . K over these 16 keys
      uint32_t pa[4];
      pa[0] = Ops<T>::pack(s[0][0], s[0][1]);
      pa[1] = Ops<T>::pack(s[0][2], s[0][3]);
      pa[2] = Ops<T>::pack(s[1][0], s[1][1]);
      pa[3] = Ops<T>::pack(s[1][2], s[1][3]);
      const int kr = t * 16 + t4 * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = n * 8 + g;
        Ops<T>::mma(acc[n], pa, join2(ks[kr][col], ks[kr + 1][col]),
                    join2(ks[kr + 8][col], ks[kr + 9][col]));
      }
    }
  }

  T* dq = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= a.Tq) continue;
    T* row = dq + static_cast<long long>(rows[r]) * a.dq_st;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + t4 * 2) =
          Ops<T>::pack(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int D, typename T>
constexpr int dkv_smem_bytes() {
  return 4 * kBlock * (D + 8) * static_cast<int>(sizeof(T)) +
         2 * kBlock * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Args a) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  constexpr bool kHold = D <= 64;    // K/V fragments in registers
  extern __shared__ __align__(16) unsigned char smem[];
  T (*ks)[LD] = reinterpret_cast<T (*)[LD]>(smem);
  T (*vs)[LD] = ks + kBlock;
  T (*qs)[LD] = vs + kBlock;
  T (*dos)[LD] = qs + kBlock;
  float* lse_s = reinterpret_cast<float*>(dos + kBlock);
  float* dl_s = lse_s + kBlock;

  const int bh = blockIdx.x, kb = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;

  // this block's K and V tile, staged once
  stage<T, D, LD>(ks, k, a.k_st, kb * kBlock, a.Tk);
  stage<T, D, LD>(vs, v, a.v_st, kb * kBlock, a.Tk);
  __syncthreads();

  // this thread's two keys: local rows kl and kl + 8 of the tile
  const int kl = warp * 16 + g;
  const int keys[2] = {kb * kBlock + kl, kb * kBlock + kl + 8};
  uint32_t ka[kHold ? KS : 1][4], va[kHold ? KS : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      afrag<T, LD>(&ks[0][0], kl, s, t4, ka[s]);
      afrag<T, LD>(&vs[0][0], kl, s, t4, va[s]);
    }
  }

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int k_first = a.k_off + kb * kBlock;
  const int k_last = k_first + kBlock - 1;
  const int nq = (a.Tq + kBlock - 1) / kBlock;

  for (int i = 0; i < nq; ++i) {
    const int q_first = a.q_off + i * kBlock;
    if (a.causal && q_first + kBlock - 1 < k_first) continue;  // all past
    if (a.window > 0 && k_last < q_first - (a.window - 1))
      break;                    // this and every later Q tile past window

    __syncthreads();  // every warp is done with the previous Q tile
    stage<T, D, LD>(qs, q, a.q_st, i * kBlock, a.Tq);
    stage<T, D, LD>(dos, dout, a.do_st, i * kBlock, a.Tq);
    if (threadIdx.x < kBlock) {
      const int qi = i * kBlock + threadIdx.x;
      const long long idx = static_cast<long long>(bh) * a.Tq + qi;
      lse_s[threadIdx.x] = qi < a.Tq ? a.lse[idx] : 0.f;
      dl_s[threadIdx.x] = qi < a.Tq ? a.delta[idx] : 0.f;
    }
    __syncthreads();

    // at D = 128 a rolled slice loop keeps the accumulators in registers
#pragma unroll (kHold ? kBlock / 16 : 1)
    for (int t = 0; t < kBlock / 16; ++t) {   // 16 queries: n-tiles 2t, 2t+1
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int n = 2 * t + nn;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nn][e] = dp[nn][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t kf[4], vf[4];
          if constexpr (kHold) {
#pragma unroll
            for (int x = 0; x < 4; ++x) { kf[x] = ka[kk][x]; vf[x] = va[kk][x]; }
          } else {
            afrag<T, LD>(&ks[0][0], kl, kk, t4, kf);
            afrag<T, LD>(&vs[0][0], kl, kk, t4, vf);
          }
          const T* qr = &qs[n * 8 + g][kk * 16 + t4 * 2];
          Ops<T>::mma(s[nn], kf, ld2(qr), ld2(qr + 8));        // S^T
          const T* dr = &dos[n * 8 + g][kk * 16 + t4 * 2];
          Ops<T>::mma(dp[nn], vf, ld2(dr), ld2(dr + 8));       // dP^T
        }
      }
      // P^T and dS^T, packed straight into the A fragments of this
      // 16-query k-slice: register 2*nn + r holds key keys[r], queries
      // (2t + nn)*8 + 2*t4 + {0, 1}
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p[2], ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int ql = (2 * t + nn) * 8 + t4 * 2 + c;
            p[c] = allowed(a, i * kBlock + ql, keys[r])
                       ? __expf(s[nn][2 * r + c] * a.scale - lse_s[ql]) : 0.f;
            ds[c] = p[c] * (dp[nn][2 * r + c] - dl_s[ql]) * a.scale;
          }
          pa[2 * nn + r] = Ops<T>::pack(p[0], p[1]);
          dsa[2 * nn + r] = Ops<T>::pack(ds[0], ds[1]);
        }
      }
      // dV += P^T . dO and dK += dS^T . Q over these 16 queries
      const int qr = t * 16 + t4 * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = n * 8 + g;
        Ops<T>::mma(dv[n], pa, join2(dos[qr][col], dos[qr + 1][col]),
                    join2(dos[qr + 8][col], dos[qr + 9][col]));
        Ops<T>::mma(dk[n], dsa, join2(qs[qr][col], qs[qr + 1][col]),
                    join2(qs[qr + 8][col], qs[qr + 9][col]));
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk) + b * a.dk_sb + h * a.dk_sh;
  T* dvp = static_cast<T*>(a.dv) + b * a.dv_sb + h * a.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= a.Tk) continue;
    T* krow = dkp + static_cast<long long>(keys[r]) * a.dk_st;
    T* vrow = dvp + static_cast<long long>(keys[r]) * a.dv_st;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8 + t4 * 2) =
          Ops<T>::pack(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vrow + n * 8 + t4 * 2) =
          Ops<T>::pack(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes<D, T>();
  // above 48 KB (D = 128) dynamic shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int BH, int D, bool dkv, cudaStream_t stream) {
  if (dkv) {
    const dim3 grid(BH, (a.Tk + kBlock - 1) / kBlock);
    switch (D) {
      case 16: return launch_dkv<T, 16>(a, grid, stream);
      case 32: return launch_dkv<T, 32>(a, grid, stream);
      case 64: return launch_dkv<T, 64>(a, grid, stream);
      case 128: return launch_dkv<T, 128>(a, grid, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  const dim3 grid(BH, (a.Tq + kBlock - 1) / kBlock);
  switch (D) {
    case 16: flash_bwd_dq_kernel<T, 16><<<grid, kThreads, 0, stream>>>(a); break;
    case 32: flash_bwd_dq_kernel<T, 32><<<grid, kThreads, 0, stream>>>(a); break;
    case 64: flash_bwd_dq_kernel<T, 64><<<grid, kThreads, 0, stream>>>(a); break;
    case 128: flash_bwd_dq_kernel<T, 128><<<grid, kThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int run(const Args& a, int B, int D, int dtype, bool dkv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch<__nv_bfloat16>(a, B * a.H, D, dkv, st)
                  : dtype == 1 ? launch<__half>(a, B * a.H, D, dkv, st)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

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
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, H, Tq, Tk,
         q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
         do_sb, do_st, do_sh, dq_sb, dq_st, dq_sh, 0, 0, 0, 0, 0, 0,
         causal, window, q_off, k_off, scale};
  return run(a, B, D, dtype, false, stream);
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
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, H, Tq, Tk,
         q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
         do_sb, do_st, do_sh, 0, 0, 0, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh,
         causal, window, q_off, k_off, scale};
  return run(a, B, D, dtype, true, stream);
}
