// K7's backward — dq, dk and dv of flash attention, for the train step.
//
// Replaces: no TPU kernel. The JAX package trains through its plain
// repro/models/attention.py:attention and lets XLA derive the backward;
// the port sends training through K7's forward
// (src/repro/kernels/flash_attention.py:flash_attention_pallas), and this
// is its gradient on the card, in place of autograd through the plain
// version.
//
// Computes, for q (B, H, Lq, D), k and v (B, Hkv, Lk, D), the forward's
// output o and row log-sum-exp lse (B, H, Lq), and the output's gradient
// dO, head h reading kv head h / (H / Hkv), FlashAttention-2's recurrence
// with these rounding points (T is the input type):
//   qs  = q * scale, rounded to T (as the forward scales it);
//   D_i = sum_d dO_id O_id, float32 (the pre-pass, one warp a row);
//   s   = qs . k and dp = dO . v, float32 sums of T products;
//   p   = exp(s - lse) on the visible columns, else 0;
//   dV  = sum_i (p rounded to T) dO_i, float32, rounded to T once;
//   ds  = p (dp - D), rounded to T;
//   dK  = sum_i ds qs_i, float32, rounded to T once;
//   dQ  = scale * sum_j ds k_j, float32, rounded to T once.
// A row with no visible column has lse = +inf (the forward writes it), so
// its p is 0: it gets dq = 0 and adds nothing to dk and dv, the gradient of
// the forward's 0 there. Rows >= Lq read lse = +inf and dO = 0, columns
// >= Lk zero K and V; tiles that hold either are masked as partial.
//
// What bounds it on the H100: operations, 10 D per visible (row, col)
// pair in five products (s, dp, dV, dK, dQ), 14 D as this kernel runs them
// (s and dp twice, once in each pass). Two passes, no atomics, so every
// run gives the same bits:
//   dK/dV pass: one block per (kv tile of BN rows, query head, batch). It
//     loads its K and V tile once, then walks the q blocks that see the
//     tile (the host's plan, q_tile_plan). With H / Hkv > 1 each query
//     head writes float32 partials (B, H, Lk, D) and a reduce kernel sums
//     a group's heads in order; with one head a group the pass writes dk
//     and dv directly. Looping over the group inside one block instead
//     would leave 2 kv heads x 64 tiles = 128 blocks at qwen2.5-3b's
//     training shape, the first of them walking 8 x 64 q blocks.
//   dQ pass: one block per (q block of BM rows, head, batch); it loads its
//     Q, dO, lse and D once and walks the kv tiles it sees (kv_tile_plan,
//     the forward's plan at these blocks).
// Both passes run in two phases a step, 8 warps each:
//   A. the score tile (16-row pieces a warp): s and dp from shared memory,
//      then p and ds in registers (the mask only on the tiles the plan
//      marks partial), written to shared memory in T (p and ds in the
//      dK/dV pass, ds in the dQ pass);
//   B. the outputs' products from shared memory into float32 accumulators
//      held in registers for the whole block (16-row pieces of the output;
//      in the dK/dV pass warps 0-3 take dV and 4-7 dK).
// bfloat16 multiplies on the tensor cores with mma.sync m16n8k16 (float32
// sums): A fragments and the K-major B fragments are 32-bit shared loads,
// the row-major B operand of phase B (dO, qs, K) comes by ldmatrix .trans.
// Rows are padded by 16 bytes, so (row stride / 4 B) % 8 == 4: the 32-bit
// fragment loads of 8 rows x 4 lanes and ldmatrix's 8 rows of 16 bytes
// fall in distinct banks. float32 runs on the FMA units (TF32 would break
// the float32 contract, as in the forward): the same fragment layout, each
// lane's 16 x 8 share by fmaf, rows padded by one word.
// Head dims are instantiated for the buckets 64, 128, 256 and 320 (D a
// multiple of 16 up to the bucket; output columns past D are skipped a
// whole 8-column tile at a time):
//   type      bucket   BM   BN   shared memory (dK/dV pass, dQ pass)
//   bfloat16  64       64   64   54 KB, 46 KB
//   bfloat16  128      64   64   86 KB, 78 KB
//   bfloat16  256      64   32   108 KB, 104 KB
//   bfloat16  320      64   32   132 KB, 128 KB
//   float32   64       64   64   98 KB, 82 KB
//   float32   128      64   64   162 KB, 146 KB
//   float32   256      64   32   210 KB, 202 KB
//   float32   320      32   32   169 KB, 165 KB
// The accumulators take at most 80 float32 registers a thread (bucket 320).
// Global loads are 16 bytes a thread where the host says a tensor is
// 16-byte aligned (base and strides), else element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, h, l;  // in elements; the last axis is contiguous
};

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kPad = 1;  // words a shared row is padded by
  static __device__ __forceinline__ float get(float x) { return x; }
  static __device__ __forceinline__ float put(float x) { return x; }
};
template <>
struct Elem<bf16> {
  static constexpr int kPad = 8;  // 16 bytes
  static __device__ __forceinline__ float get(bf16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ bf16 put(float x) { return __float2bfloat16_rn(x); }
};

// 16 bytes of a row (4 float32 or 8 bf16 values) to float32, and back.
__device__ __forceinline__ void load_chunk(const float* src, bool vec, float* x) {
  if (vec) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = src[e];
  }
}
__device__ __forceinline__ void load_chunk(const bf16* src, bool vec, float* x) {
  if (vec) {
    uint4 u = *reinterpret_cast<const uint4*>(src);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(src[i]);
  }
}
__device__ __forceinline__ void store_chunk(float* dst, const float* x) {  // rows padded by a word
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = x[e];
}
__device__ __forceinline__ void store_chunk(bf16* dst, const float* x) {  // 16-byte aligned
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(x[i]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// Rows r0 .. r0 + ROWS - 1 of an (L, D) slice with row stride sl into a
// ROWS x ld shared tile; rows >= L are zeros. With `scaled`, each value is
// multiplied by `scale` in float32 and rounded to T (the forward's qs).
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long sl, int r0,
                                          int L, int D, bool vec, bool scaled, float scale) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = D / E;
  for (int i = threadIdx.x; i < ROWS * cpr; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * E;
    float x[E];
    if (r0 + r < L) {
      load_chunk(src + static_cast<long long>(r0 + r) * sl + c, vec, x);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = 0.f;
    }
    if (scaled) {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] *= scale;
    }
    store_chunk(dst + r * ld + c, x);
  }
}

__device__ __forceinline__ void put2(float* p, float x0, float x1) {
  p[0] = x0;
  p[1] = x1;
}
__device__ __forceinline__ void put2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// ---- products on a warp's 16-row piece ----------------------------------
// Accumulator layout (mma.sync m16n8, float32), the same for both types:
// lane (g = lane / 4, t = lane % 4) holds c[j][0..1] at row g, columns
// 8 j + 2 t (+ 1) and c[j][2..3] at row g + 8.

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment (16 x 8) of a row-major K x N operand at p (lanes 0-15
// point at its rows 0-15, column 0 of the fragment).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr)
               : "memory");
}

// c[j] += A (16 rows, stride ld) . B^T over K columns; B's rows 8 j .. 8 j + 7
// (stride ld) give c[j]'s columns.
template <int NT>
__device__ __forceinline__ void prod_nt(float (&c)[NT][4], const bf16* A, const bf16* B, int ld,
                                        int K, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* a_lo = A + g * ld + 2 * t;
  const bf16* a_hi = a_lo + 8 * ld;
  const bf16* b_p = B + g * ld + 2 * t;
  for (int kk = 0; kk < K; kk += 16) {
    const uint32_t a[4] = {ld32(a_lo + kk), ld32(a_hi + kk), ld32(a_lo + kk + 8),
                           ld32(a_hi + kk + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* bp = b_p + 8 * j * ld + kk;
      mma16816(c[j], a, ld32(bp), ld32(bp + 8));
    }
  }
}
template <int NT>
__device__ __forceinline__ void prod_nt(float (&c)[NT][4], const float* A, const float* B,
                                        int ld, int K, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a_lo = A + g * ld;
  const float* a_hi = a_lo + 8 * ld;
  const float* b_p = B + 2 * t * ld;
  for (int k = 0; k < K; ++k) {
    const float a0 = a_lo[k], a1 = a_hi[k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = b_p[8 * j * ld + k], b1 = b_p[(8 * j + 1) * ld + k];
      c[j][0] = fmaf(a0, b0, c[j][0]);
      c[j][1] = fmaf(a0, b1, c[j][1]);
      c[j][2] = fmaf(a1, b0, c[j][2]);
      c[j][3] = fmaf(a1, b1, c[j][3]);
    }
  }
}

// c[j] += A (16 rows x K, stride lda) . B (K rows, stride ldb), c[j] over
// B's columns 8 j .. 8 j + 7, for j < n_valid (a warp-uniform count).
template <int NT, int K>
__device__ __forceinline__ void prod_nn(float (&c)[NT][4], const bf16* A, int lda, const bf16* B,
                                        int ldb, int n_valid, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* a_lo = A + g * lda + 2 * t;
  const bf16* a_hi = a_lo + 8 * lda;
  const bf16* b_row = B + (lane & 15) * ldb;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    const uint32_t a[4] = {ld32(a_lo + kk), ld32(a_hi + kk), ld32(a_lo + kk + 8),
                           ld32(a_hi + kk + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < n_valid) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, b_row + kk * ldb + 8 * j);
        mma16816(c[j], a, b0, b1);
      }
    }
  }
}
template <int NT, int K>
__device__ __forceinline__ void prod_nn(float (&c)[NT][4], const float* A, int lda,
                                        const float* B, int ldb, int n_valid, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a_lo = A + g * lda;
  const float* a_hi = a_lo + 8 * lda;
  const float* b_p = B + 2 * t;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a_lo[k], a1 = a_hi[k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < n_valid) {
        const float b0 = b_p[k * ldb + 8 * j], b1 = b_p[k * ldb + 8 * j + 1];
        c[j][0] = fmaf(a0, b0, c[j][0]);
        c[j][1] = fmaf(a0, b1, c[j][1]);
        c[j][2] = fmaf(a1, b0, c[j][2]);
        c[j][3] = fmaf(a1, b1, c[j][3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

__device__ __forceinline__ bool visible(int row, int col, int Lq, int Lk, int causal, int window) {
  return row < Lq && col < Lk && (!causal || col <= row) && (window <= 0 || col > row - window);
}

// ---- shapes ---------------------------------------------------------------

template <typename T, int DM, int BM_, int BN_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int LD = DM + Elem<T>::kPad;      // Q, dO, K, V tiles
  static constexpr int LDP_KV = BM + Elem<T>::kPad;  // p and ds of the dK/dV pass (BN x BM)
  static constexpr int LDP_Q = BN + Elem<T>::kPad;   // ds of the dQ pass (BM x BN)
  static constexpr int SMEM_KV = static_cast<int>(
      ((2 * BN + 2 * BM) * LD + 2 * BN * LDP_KV) * sizeof(T) + 2 * BM * sizeof(float));
  static constexpr int SMEM_Q = static_cast<int>(
      ((2 * BM + 2 * BN) * LD + BM * LDP_Q) * sizeof(T) + 2 * BM * sizeof(float));
  static_assert(BM % 16 == 0 && BN % 16 == 0 && DM % 16 == 0, "16-row pieces");
};

// ---- the pre-pass: D_i = sum_d dO_id O_id ----------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                    Strides os, Strides dos, int H, int Lq, int D, long long n_rows) {
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(r % Lq);
  const long long bh = r / Lq;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const T* op = o + b * os.b + h * os.h + i * os.l;
  const T* dp = dout + b * dos.b + h * dos.h + i * dos.l;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += Elem<T>::get(op[d]) * Elem<T>::get(dp[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[r] = s;
}

// ---- the dK/dV pass ---------------------------------------------------------

template <typename T, int DM, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                  float* __restrict__ dk_part, float* __restrict__ dv_part, Strides qs,
                  Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                  const int* __restrict__ plan, int group, int Lq, int Lk, int D, int causal,
                  int window, float scale, int vec) {
  using S = Shape<T, DM, BM, BN>;
  constexpr int LD = S::LD, LDP = S::LDP_KV;
  // phase A: 16 x WA pieces of the BN x BM tile of p and ds
  constexpr int RGA = BN / 16, CPA = kWarps / RGA, WA = BM / CPA, NTA = WA / 8;
  // phase B: warps 0-3 dV, 4-7 dK, each a 16 x WB piece of the BN x D output
  constexpr int RGB = BN / 16, CPB = (kWarps / 2) / RGB, WB = DM / CPB, NTB = WB / 8;
  static_assert(RGA * CPA == kWarps && WA % 8 == 0 && RGB * CPB == kWarps / 2 && WB % 8 == 0,
                "warp pieces");

  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BN * LD;
  T* sQ = sV + BN * LD;
  T* sdO = sQ + BM * LD;
  T* sP = sdO + BM * LD;
  T* sdS = sP + BN * LDP;
  float* sL = reinterpret_cast<float*>(sdS + BN * LDP);
  float* sD = sL + BM;

  // plan row: kv tile, first and end q block, first and end block without a mask
  const int* pr = plan + 5 * blockIdx.z;
  const int kb = pr[0], qb0 = pr[1], qb1 = pr[2], fb0 = pr[3], fb1 = pr[4];
  const int H = gridDim.x, h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int c0 = kb * BN;
  const long long row_bh = (static_cast<long long>(b) * H + h) * Lq;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* dop = dout + b * dos.b + h * dos.h;
  load_tile<T, BN>(sK, LD, k + b * ks.b + hk * ks.h, ks.l, c0, Lk, D, vec & 2, false, 1.f);
  load_tile<T, BN>(sV, LD, v + b * vs.b + hk * vs.h, vs.l, c0, Lk, D, vec & 4, false, 1.f);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = (warp % RGA) * 16, ca = (warp / RGA) * WA;
  const int which = warp / (kWarps / 2), wb = warp % (kWarps / 2);  // which: 0 dV, 1 dK
  const int rb = (wb % RGB) * 16, cb = (wb / RGB) * WB;
  const int n_valid = max(0, min(NTB, (D - cb) / 8));
  float acc[NTB][4];
  zero(acc);

  for (int qb = qb0; qb < qb1; ++qb) {
    const int q0 = qb * BM;
    __syncthreads();  // the last step's readers of sQ, sdO, sP, sdS are done
    load_tile<T, BM>(sQ, LD, qp, qs.l, q0, Lq, D, vec & 1, true, scale);
    load_tile<T, BM>(sdO, LD, dop, dos.l, q0, Lq, D, vec & 8, false, 1.f);
    for (int i = threadIdx.x; i < BM; i += kThreads) {
      const bool in = q0 + i < Lq;
      sL[i] = in ? lse[row_bh + q0 + i] : INFINITY;
      sD[i] = in ? delta[row_bh + q0 + i] : 0.f;
    }
    __syncthreads();

    // A: s^T = K qs^T and dp^T = V dO^T on rows ra.. (kv) x columns ca.. (q)
    float s[NTA][4], dp[NTA][4];
    zero(s);
    zero(dp);
    prod_nt<NTA>(s, sK + ra * LD, sQ + ca * LD, LD, D, lane);
    prod_nt<NTA>(dp, sV + ra * LD, sdO + ca * LD, LD, D, lane);
    const bool full = qb >= fb0 && qb < fb1;
#pragma unroll
    for (int j = 0; j < NTA; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = ra + g + 8 * hi, cc = ca + 8 * j + 2 * t;
        float pv[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = expf(s[j][2 * hi + e] - sL[cc + e]);
          if (!full && !visible(q0 + cc + e, c0 + r, Lq, Lk, causal, window)) p = 0.f;
          pv[e] = p;
          dsv[e] = p * (dp[j][2 * hi + e] - sD[cc + e]);
        }
        put2(sP + r * LDP + cc, pv[0], pv[1]);
        put2(sdS + r * LDP + cc, dsv[0], dsv[1]);
      }
    __syncthreads();

    // B: dV += p^T dO, dK += ds^T qs on rows rb.. x columns cb..
    if (which == 0)
      prod_nn<NTB, BM>(acc, sP + rb * LDP, LDP, sdO + cb, LD, n_valid, lane);
    else
      prod_nn<NTB, BM>(acc, sdS + rb * LDP, LDP, sQ + cb, LD, n_valid, lane);
  }

#pragma unroll
  for (int j = 0; j < NTB; ++j) {
    if (j >= n_valid) continue;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = c0 + rb + g + 8 * hi, col = cb + 8 * j + 2 * t;
      if (row >= Lk) continue;
      if (dk_part != nullptr) {  // a query head's share; the reduce kernel sums the group
        float* o = (which ? dk_part : dv_part) +
                   ((static_cast<long long>(b) * H + h) * Lk + row) * D + col;
        o[0] = acc[j][2 * hi];
        o[1] = acc[j][2 * hi + 1];
      } else {
        T* o = which ? dk + b * dks.b + hk * dks.h + row * dks.l + col
                     : dv + b * dvs.b + hk * dvs.h + row * dvs.l + col;
        o[0] = Elem<T>::put(acc[j][2 * hi]);
        o[1] = Elem<T>::put(acc[j][2 * hi + 1]);
      }
    }
  }
}

// dk and dv of a kv head: its group's float32 partials summed in head order
// (blockIdx.y: 0 dv, 1 dk).
template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_reduce(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                     T* __restrict__ dk, T* __restrict__ dv, Strides dks, Strides dvs, int Hkv,
                     int group, int Lk, int D, long long n) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int which = blockIdx.y;
  const int d = static_cast<int>(idx % D);
  long long rest = idx / D;
  const int j = static_cast<int>(rest % Lk);
  rest /= Lk;
  const int hk = static_cast<int>(rest % Hkv), b = static_cast<int>(rest / Hkv);
  const long long head = static_cast<long long>(Lk) * D;
  const float* p = (which ? dk_part : dv_part) +
                   (static_cast<long long>(b) * Hkv * group + hk * group) * head +
                   static_cast<long long>(j) * D + d;
  float s = 0.f;
  for (int i = 0; i < group; ++i) s += p[i * head];
  T* o = which ? dk + b * dks.b + hk * dks.h + j * dks.l + d
               : dv + b * dvs.b + hk * dvs.h + j * dvs.l + d;
  *o = Elem<T>::put(s);
}

// ---- the dQ pass ---------------------------------------------------------------

template <typename T, int DM, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks,
                 Strides vs, Strides dos, Strides dqs, const int* __restrict__ plan, int group,
                 int Lq, int Lk, int D, int causal, int window, float scale, int vec) {
  using S = Shape<T, DM, BM, BN>;
  constexpr int LD = S::LD, LDP = S::LDP_Q;
  // phase A: 16 x WA pieces of the BM x BN tile of ds
  constexpr int RGA = BM / 16, CPA = kWarps / RGA, WA = BN / CPA, NTA = WA / 8;
  // phase B: 16 x WB pieces of the BM x D output
  constexpr int RGB = BM / 16, CPB = kWarps / RGB, WB = DM / CPB, NTB = WB / 8;
  static_assert(RGA * CPA == kWarps && WA % 8 == 0 && RGB * CPB == kWarps && WB % 8 == 0,
                "warp pieces");

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + BM * LD;
  T* sK = sdO + BM * LD;
  T* sV = sK + BN * LD;
  T* sdS = sV + BN * LD;
  float* sL = reinterpret_cast<float*>(sdS + BM * LDP);
  float* sD = sL + BM;

  // plan row: q block, first and end kv tile, first and end tile without a mask
  const int* pr = plan + 5 * blockIdx.z;
  const int qb = pr[0], kb0 = pr[1], kb1 = pr[2], fb0 = pr[3], fb1 = pr[4];
  const int H = gridDim.x, h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int q0 = qb * BM;
  const long long row_bh = (static_cast<long long>(b) * H + h) * Lq;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  load_tile<T, BM>(sQ, LD, q + b * qs.b + h * qs.h, qs.l, q0, Lq, D, vec & 1, true, scale);
  load_tile<T, BM>(sdO, LD, dout + b * dos.b + h * dos.h, dos.l, q0, Lq, D, vec & 8, false,
                   1.f);
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    const bool in = q0 + i < Lq;
    sL[i] = in ? lse[row_bh + q0 + i] : INFINITY;
    sD[i] = in ? delta[row_bh + q0 + i] : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = (warp % RGA) * 16, ca = (warp / RGA) * WA;
  const int rb = (warp % RGB) * 16, cb = (warp / RGB) * WB;
  const int n_valid = max(0, min(NTB, (D - cb) / 8));
  float acc[NTB][4];
  zero(acc);

  for (int kb = kb0; kb < kb1; ++kb) {
    const int c0 = kb * BN;
    __syncthreads();  // the last step's readers of sK, sV, sdS are done
    load_tile<T, BN>(sK, LD, kp, ks.l, c0, Lk, D, vec & 2, false, 1.f);
    load_tile<T, BN>(sV, LD, vp, vs.l, c0, Lk, D, vec & 4, false, 1.f);
    __syncthreads();

    // A: s = qs K^T and dp = dO V^T on rows ra.. (q) x columns ca.. (kv)
    float s[NTA][4], dp[NTA][4];
    zero(s);
    zero(dp);
    prod_nt<NTA>(s, sQ + ra * LD, sK + ca * LD, LD, D, lane);
    prod_nt<NTA>(dp, sdO + ra * LD, sV + ca * LD, LD, D, lane);
    const bool full = kb >= fb0 && kb < fb1;
#pragma unroll
    for (int j = 0; j < NTA; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = ra + g + 8 * hi, cc = ca + 8 * j + 2 * t;
        float dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = expf(s[j][2 * hi + e] - sL[r]);
          if (!full && !visible(q0 + r, c0 + cc + e, Lq, Lk, causal, window)) p = 0.f;
          dsv[e] = p * (dp[j][2 * hi + e] - sD[r]);
        }
        put2(sdS + r * LDP + cc, dsv[0], dsv[1]);
      }
    __syncthreads();

    // B: dQ += ds K on rows rb.. x columns cb..
    prod_nn<NTB, BN>(acc, sdS + rb * LDP, LDP, sK + cb, LD, n_valid, lane);
  }

#pragma unroll
  for (int j = 0; j < NTB; ++j) {
    if (j >= n_valid) continue;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = q0 + rb + g + 8 * hi, col = cb + 8 * j + 2 * t;
      if (row >= Lq) continue;
      T* o = dq + b * dqs.b + h * dqs.h + row * dqs.l + col;
      o[0] = Elem<T>::put(scale * acc[j][2 * hi]);
      o[1] = Elem<T>::put(scale * acc[j][2 * hi + 1]);
    }
  }
}

// ---- host side ---------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *delta, *dk_part, *dv_part;
  int B, H, Hkv, Lq, Lk, D;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale;
  const int *dq_plan, *dkv_plan;
  int n_dq_plan, n_dkv_plan, block_q, block_k, vec;
};

// Lets `kernel` take `bytes` of dynamic shared memory, once a device.
template <typename K>
int allow_smem(K kernel, int bytes, uint64_t* done) {
  if (bytes <= 48 * 1024) return 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < 64 && (*done >> device & 1)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < 64) *done |= 1ull << device;
  return 0;
}

template <typename T, int DM, int BM, int BN>
int run(const Args& a, cudaStream_t st) {
  using S = Shape<T, DM, BM, BN>;
  const int group = a.H / a.Hkv;
  if (a.block_q != BM || a.block_k != BN ||
      (a.dq != nullptr && a.n_dq_plan != (a.Lq + BM - 1) / BM) ||
      (a.dk != nullptr && a.n_dkv_plan != (a.Lk + BN - 1) / BN) || a.n_dq_plan > 65535 ||
      a.n_dkv_plan > 65535 ||
      (a.dk != nullptr && group > 1 && (a.dk_part == nullptr || a.dv_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);

  const long long n_rows = static_cast<long long>(a.B) * a.H * a.Lq;
  attention_bwd_delta<T><<<static_cast<unsigned>((n_rows + kWarps - 1) / kWarps), kThreads, 0,
                           st>>>(static_cast<const T*>(a.o), dout, delta, a.os, a.dos, a.H, a.Lq,
                                 a.D, n_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  if (a.dk != nullptr) {
    static uint64_t done = 0;
    int err = allow_smem(attention_bwd_dkv<T, DM, BM, BN>, S::SMEM_KV, &done);
    if (err != 0) return err;
    float* dk_part = group > 1 ? static_cast<float*>(a.dk_part) : nullptr;
    float* dv_part = group > 1 ? static_cast<float*>(a.dv_part) : nullptr;
    attention_bwd_dkv<T, DM, BM, BN><<<dim3(a.H, a.B, a.n_dkv_plan), kThreads, S::SMEM_KV, st>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), dk_part,
        dv_part, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.dkv_plan, group, a.Lq, a.Lk, a.D,
        a.causal, a.window, a.scale, a.vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (group > 1) {
      const long long n = static_cast<long long>(a.B) * a.Hkv * a.Lk * a.D;
      attention_bwd_reduce<T><<<dim3(static_cast<unsigned>((n + 255) / 256), 2), 256, 0, st>>>(
          dk_part, dv_part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dks, a.dvs, a.Hkv,
          group, a.Lk, a.D, n);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  if (a.dq != nullptr) {
    static uint64_t done = 0;
    int err = allow_smem(attention_bwd_dq<T, DM, BM, BN>, S::SMEM_Q, &done);
    if (err != 0) return err;
    attention_bwd_dq<T, DM, BM, BN><<<dim3(a.H, a.B, a.n_dq_plan), kThreads, S::SMEM_Q, st>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs,
        a.dq_plan, group, a.Lq, a.Lk, a.D, a.causal, a.window, a.scale, a.vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, dout, dq, dk and dv alike; lse,
// delta and the partials are float32). Strides in elements, (batch, head,
// row) for each of q, k, v, o, dout, dq, dk, dv; the head-dim axis is
// contiguous; lse and delta are (B, H, Lq) and the partials (B, H, Lk, D),
// contiguous. dq == null skips the dQ pass, dk == null the dK/dV pass (dk
// and dv come together); with H > Hkv the dK/dV pass needs both partials.
// D is a multiple of 16 in [16, 320], H a multiple of Hkv. The plans
// (device int32, five columns a row) and the blocks come from
// kernels/flash_attention.py (bwd_blocks, kv_tile_plan, q_tile_plan); vec
// has bit 0 for q, 1 for k, 2 for v and 3 for dout where the tensor may be
// read 16 bytes at a time.
extern "C" int nebula_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* delta, void* dk_part, void* dv_part,
    int dtype, int B, int H, int Hkv, int Lq, int Lk, int D, long long qsb, long long qsh,
    long long qsl, long long ksb, long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, long long osb, long long osh, long long osl, long long dosb, long long dosh,
    long long dosl, long long dqsb, long long dqsh, long long dqsl, long long dksb,
    long long dksh, long long dksl, long long dvsb, long long dvsh, long long dvsl, int causal,
    int window, float scale, const void* dq_plan, int n_dq_plan, const void* dkv_plan,
    int n_dkv_plan, int block_q, int block_k, int vec, void* stream) {
  if (D < 16 || D > 320 || D % 16 != 0 || B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      Lq < 1 || Lk < 1 || H > 65535 || B > 65535 || lse == nullptr || delta == nullptr ||
      (dk == nullptr) != (dv == nullptr) || (dq != nullptr && dq_plan == nullptr) ||
      (dk != nullptr && dkv_plan == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, delta, dk_part, dv_part, B, H, Hkv, Lq, Lk, D,
               Strides{qsb, qsh, qsl}, Strides{ksb, ksh, ksl}, Strides{vsb, vsh, vsl},
               Strides{osb, osh, osl}, Strides{dosb, dosh, dosl}, Strides{dqsb, dqsh, dqsl},
               Strides{dksb, dksh, dksl}, Strides{dvsb, dvsh, dvsl}, causal, window, scale,
               static_cast<const int*>(dq_plan), static_cast<const int*>(dkv_plan), n_dq_plan,
               n_dkv_plan, block_q, block_k, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 64) return run<bf16, 64, 64, 64>(a, st);
    if (D <= 128) return run<bf16, 128, 64, 64>(a, st);
    if (D <= 256) return run<bf16, 256, 64, 32>(a, st);
    return run<bf16, 320, 64, 32>(a, st);
  }
  if (dtype == 0) {
    if (D <= 64) return run<float, 64, 64, 64>(a, st);
    if (D <= 128) return run<float, 128, 64, 64>(a, st);
    if (D <= 256) return run<float, 256, 64, 32>(a, st);
    return run<float, 320, 32, 32>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
