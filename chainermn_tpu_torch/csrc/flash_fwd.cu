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
// ragged last tile) are masked like causally masked keys.
//
// Bound at the flagship scoring shape (B=8, H=16, T=2048, D=64, causal,
// bf16): the lower triangle needs 4*B*H*D*T*(T+1)/2 = 68.7 GFLOP, 69 us at
// 989 TFLOP/s; q/k/v/o move 134 MB, 40 us at 3.35 TB/s.  The call is
// therefore bound by tensor-core operations.  This first version uses
// warp-level mma.sync (m16n8k16) tensor-core products, keeps S and P in
// registers (no T x T matrix in memory), reads each K/V tile from device
// memory once per 64-row query tile, and skips masked tiles.  It does not
// use wgmma, TMA or warp specialisation, so it stays well short of that
// bound; those are the tools of a later, faster version.
//
// Layout: q, k, v, o are (B, T, H, D) with unit stride along D and any
// element strides for b, t and h (multiples of 8, 16-byte aligned bases).
// One block of 4 warps handles one (b, h) pair and 64 query rows; each
// warp owns 16 rows.  The C entry point returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block (16 per warp)
constexpr int kBlockK = 64;   // keys per K/V tile
constexpr int kWarps = 4;
constexpr float kNeg = -1e30f;

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
  const void* q; const void* k; const void* v; void* o; float* lse;
  int H, Tq, Tk;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
      o_sb, o_st, o_sh;
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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const Args a) {
  constexpr int LD = D + 8;          // padded smem row: conflict-free reads
  constexpr int KS = D / 16;         // k-slices of the QK^T product
  constexpr int NS = kBlockK / 8;    // n-tiles of S (8 keys each)
  constexpr int ND = D / 8;          // n-tiles of O (8 features each)
  __shared__ __align__(16) T ks[kBlockK][LD];
  __shared__ __align__(16) T vs[kBlockK][LD];

  const int bh = blockIdx.x, qb = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  // this thread's two rows: r0 (fragment halves c0,c1) and r0 + 8 (c2,c3)
  const int r0 = qb * kBlockQ + warp * 16 + g;
  const int rows[2] = {r0, r0 + 8};
  const int qpos[2] = {a.q_off + r0, a.q_off + r0 + 8};

  // Q fragments stay in registers for the whole K sweep
  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s * 16 + t4 * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < a.Tq;
      const T* qr = q + static_cast<long long>(rows[r]) * a.q_st;
      qa[s][r] = in ? ld2(qr + c) : 0u;
      qa[s][r + 2] = in ? ld2(qr + c + 8) : 0u;
    }
  }

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // block-uniform tile predicate in global positions (the TPU kernel's
  // `needed`): the block's first/last query row against the tile's keys
  const int q_first = a.q_off + qb * kBlockQ;
  const int q_last = q_first + kBlockQ - 1;
  const int nk = (a.Tk + kBlockK - 1) / kBlockK;

  for (int j = 0; j < nk; ++j) {
    const int k_first = a.k_off + j * kBlockK;
    if (a.causal && q_last < k_first) break;  // every later tile is future
    if (a.window > 0 && k_first + kBlockK - 1 < q_first - (a.window - 1))
      continue;                               // tile wholly before window

    __syncthreads();  // every warp is done with the previous tile
    for (int c = threadIdx.x; c < kBlockK * D / 8; c += kWarps * 32) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const int kr = j * kBlockK + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (kr < a.Tk) {  // zero-fill the ragged tail: 0 * p stays finite
        kx = *reinterpret_cast<const uint4*>(k + kr * a.k_st + col);
        vx = *reinterpret_cast<const uint4*>(v + kr * a.v_st + col);
      }
      *reinterpret_cast<uint4*>(&ks[r][col]) = kx;
      *reinterpret_cast<uint4*>(&vs[r][col]) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys, fp32 accumulation
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        const T* kr = &ks[n * 8 + g][t * 16 + t4 * 2];
        Ops<T>::mma(s[n], qa[t], ld2(kr), ld2(kr + 8));
      }
    }

    // scale, mask, running max
    uint32_t allow = 0;  // bit n*4+e: element (n, e) is attendable
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = j * kBlockK + n * 8 + t4 * 2 + (e & 1);
        const int kpos = a.k_off + col;
        bool ok = col < a.Tk;
        if (a.causal) ok = ok && qpos[r] >= kpos;
        if (a.window > 0) ok = ok && (qpos[r] - kpos) < a.window;
        const float x = ok ? s[n][e] * a.scale : kNeg;
        s[n][e] = x;
        allow |= static_cast<uint32_t>(ok) << (n * 4 + e);
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }

    // p, this thread's share of rowsum(p), and the rescaled accumulator
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = ((allow >> (n * 4 + e)) & 1u) ? __expf(s[n][e] - m[r]) : 0.f;
        s[n][e] = p;
        ps[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // acc += P V: S's accumulator layout for key tiles (2t, 2t+1) is the
    // A-fragment layout of k-slice t, so P never leaves registers
#pragma unroll
    for (int t = 0; t < kBlockK / 16; ++t) {
      uint32_t pa[4];
      pa[0] = Ops<T>::pack(s[2 * t][0], s[2 * t][1]);
      pa[1] = Ops<T>::pack(s[2 * t][2], s[2 * t][3]);
      pa[2] = Ops<T>::pack(s[2 * t + 1][0], s[2 * t + 1][1]);
      pa[3] = Ops<T>::pack(s[2 * t + 1][2], s[2 * t + 1][3]);
      const int kr = t * 16 + t4 * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = n * 8 + g;
        Ops<T>::mma(acc[n], pa, join2(vs[kr][col], vs[kr + 1][col]),
                    join2(vs[kr + 8][col], vs[kr + 9][col]));
      }
    }
  }

  // finalize: the quad's partial normalisers sum to the row's l
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= a.Tq) continue;
    const float safe = fmaxf(l[r], 1e-30f);
    T* orow = o + static_cast<long long>(rows[r]) * a.o_st;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
          Ops<T>::pack(acc[n][2 * r] / safe, acc[n][2 * r + 1] / safe);
    }
    if (t4 == 0)
      a.lse[static_cast<long long>(bh) * a.Tq + rows[r]] = m[r] + logf(safe);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int BH, int D, cudaStream_t stream) {
  const dim3 grid(BH, (a.Tq + kBlockQ - 1) / kBlockQ), block(kWarps * 32);
  switch (D) {
    case 16: flash_fwd_kernel<T, 16><<<grid, block, 0, stream>>>(a); break;
    case 32: flash_fwd_kernel<T, 32><<<grid, block, 0, stream>>>(a); break;
    case 64: flash_fwd_kernel<T, 64><<<grid, block, 0, stream>>>(a); break;
    case 128: flash_fwd_kernel<T, 128><<<grid, block, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

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
  Args a{q, k, v, o, lse, H, Tq, Tk,
         q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
         o_sb, o_st, o_sh, causal, window, q_off, k_off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch<__nv_bfloat16>(a, B * H, D, st)
                  : dtype == 1 ? launch<__half>(a, B * H, D, st)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
