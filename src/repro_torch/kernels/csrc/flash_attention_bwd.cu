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
// pair in five products (s, dp, dV, dK, dQ), 14 D as these kernels run them
// (s and dp twice, once in each pass). Two passes, no atomics, so every
// run gives the same bits (FlashAttention-2 and -3 sum dQ with float32
// atomics inside the dK/dV pass; a dQ partial for each kv tile would be
// about 1 GB at the training shape):
//   dK/dV pass: one block per (kv tile of BN rows, query head, batch). It
//     loads its K and V tile once, then walks the q blocks that see the
//     tile (the host's plan, q_tile_plan). With H / Hkv > 1 each query
//     head writes float32 partials (B, H, Lk, D) and a reduce kernel sums
//     a group's heads in order; with one head a group the pass writes dk
//     and dv directly. Looping over the group inside one block instead
//     would leave 2 kv heads x 32 kv tiles of 128 rows = 64 blocks at
//     qwen2.5-3b's training shape, the first of them walking 8 x 64 q
//     blocks.
//   dQ pass: one block per (q block of BM rows, head, batch); it loads its
//     qs, dO, lse and D once and walks the kv tiles it sees (kv_tile_plan,
//     the forward's plan at these blocks).
// Three routes, chosen by the host (kernels/flash_attention.py:bwd_route):
//
// wgmma — bfloat16 at head dims up to 128 (buckets 64 and 128), the
// training path's. The forward's machinery (sm90.cuh) applied to both
// passes. The pre-pass also writes qs = round_bf16(q * scale) once into a
// contiguous (B, H, Lq, D) scratch, and lse and D into (B, H, Lq_pad)
// buffers whose rows Lq .. Lq_pad - 1 (Lq_pad = Lq rounded up to 128) hold
// lse = +inf and D = 0: TMA's zero fill would give lse 0 there. Each pass
// is a block of two consumer warpgroups (256 threads), each 64 rows of the
// block's tile, fed by TMA into 128-byte-swizzled shared memory (4-D
// tensor maps, boxes of 64 columns; head-dim columns past D arrive as
// zeros, add 0 to every score and are never stored). The block's first
// thread issues every load: the block's fixed operands once, then a ring
// of 4 stages, each with its own full and empty mbarriers as the forward's,
// filled 2 steps ahead (a refill waits on the step two back, so neither
// warpgroup waits on the other's current step). No producer warp: with 9
// or 12 warps a block ptxas holds every thread to 168 registers (one
// sub-partition's 16,384 over 3 warps), whatever setmaxnreg asks at run
// time, and the dK/dV pass takes 226 (ptxas); with a producer warp or
// warpgroup it spilled 4.3 KB.
//   dK/dV pass (attention_bwd_dkv_wgmma): BN 128 kv rows; K and V once,
//     then stages of (qs block of 64 rows, dO block, their 64 lse and D
//     values by bulk copy). A step: s^T = K qs^T and dp^T = V dO^T by wgmma
//     (A and B from shared memory, K-major), p^T and ds^T in registers (the
//     mask only on the blocks the plan marks partial), then dV += p^T dO
//     and dK += ds^T qs by wgmma with A from registers: the m64nNk16
//     accumulator layout of s^T is the register-A layout, as the forward
//     feeds P, so p and ds never touch shared memory; the B operand is the
//     same dO or qs tile read MN-major. The dV and dK accumulators (64 + 64
//     floats a thread at D_pad 128) and s^T and dp^T (32 + 32).
//   dQ pass (attention_bwd_dq_wgmma): BM 128 q rows; qs and dO once, then
//     stages of (K tile, V tile) of BN 64 rows. A step: s = qs K^T and
//     dp = dO V^T (shared, K-major), ds in registers, then dQ += ds K (A
//     from registers, K read MN-major) is issued behind the next step's s
//     and dp and runs while that step's ds is computed (ds double-buffered
//     in registers, 204 in all); dq is scaled once at the end. Run after
//     its step instead, the pass took 0.29 ms at the training shape
//     against 0.21.
//   The s and dp products of a step are committed together and waited for
//   before p and ds are computed, into registers of their own: a write to
//   an accumulator while another product is in flight makes ptxas
//   serialize every wgmma of the kernel. They issue NK = D / 16 k-steps,
//   a constant of the instantiation: the bucket's, or 5 at D 80 (zamba2's),
//   whose last three would hold only zero fill; the output products are
//   16 NK columns wide (m64n80k16 at D 80, the second box read for its
//   first 16 columns), so D 80 does 5/8 of D 128's work.
//   pass     D_pad   q block   kv tile   shared memory (4 stages)
//   dK/dV    64      64        128       99 KB
//   dK/dV    128     64        128       195 KB
//   dQ       64      128       64        97 KB
//   dQ       128     128       64        193 KB
//   TMA needs 16-byte aligned bases and strides of q, k, v and dout; the
//   host checks them and raises, and the entry point refuses anything
//   else: nothing is copied, nothing falls back to the other route.
//
// mma_sync — bfloat16 at buckets 256 and 320 (the first kernels, kept: at
// gemma3's local layer, D 320, the bf16 kernel takes 1.14 ms against sdpa's
// 2.73, and two wgmma accumulators of D_pad / 2 floats a thread do not fit
// there). Both passes run in two phases a step, 8 warps each:
//   A. the score tile (16-row pieces a warp): s and dp from shared memory,
//      then p and ds in registers (the mask only on the tiles the plan
//      marks partial), written to shared memory in T (p and ds in the
//      dK/dV pass, ds in the dQ pass);
//   B. the outputs' products from shared memory into float32 accumulators
//      held in registers for the whole block (16-row pieces of the output;
//      in the dK/dV pass warps 0-3 take dV and 4-7 dK).
// mma.sync m16n8k16 (float32 sums): A fragments and the K-major B fragments
// are 32-bit shared loads, the row-major B operand of phase B (dO, qs, K)
// comes by ldmatrix .trans. Rows are padded by 16 bytes, so (row stride /
// 4 B) % 8 == 4: the 32-bit fragment loads of 8 rows x 4 lanes and
// ldmatrix's 8 rows of 16 bytes fall in distinct banks. Output columns past
// D are skipped a whole 8-column tile at a time:
//   bucket   BM   BN   shared memory (dK/dV pass, dQ pass)
//   256      64   32   108 KB, 104 KB
//   320      64   32   132 KB, 128 KB
// The accumulators take at most 80 float32 registers a thread (bucket 320).
// Global loads are 16 bytes a thread where the host says a tensor is
// 16-byte aligned (base and strides), else element by element.
//
// tf32x3 — float32 at every head dim, on the tensor cores as three TF32
// products (tf32x3.cuh: x = hi + lo, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi
// on mma.sync m16n8k8, about 2^-22 of |a b| from the float32 product): the
// bound is 30 D TF32 operations a visible pair at 495 TFLOP/s (42 D as the
// two passes run it), 2.5x the 10 D at the 67 TFLOP/s of the FMA units
// that float32 ran on before. Both passes keep p and ds in registers: each
// warp computes a 16-row piece of s and dp across the step's whole tile and
// feeds it, split in registers, as the A operand of its output products
// (the accumulator's columns 2t and 2t + 1 as k t and t + 4, so the B
// operand's rows 2t and 2t + 1 of each k-step are read). A warp's own rows
// of the fixed operand (K and V in the dK/dV pass, qs and dO in the dQ
// pass) stay raw in shared memory and are split on read, once a k-step for
// all of the step's n-tiles; the walked operand, which every warp reads,
// arrives by cp.async (16 bytes a copy where the host says the tensor
// allows, else 4) into landing tiles and is split once into hi and lo
// working tiles, so that the next step's copy lands while this one is used
// (a ring of two stages: the raw one and the split one). Rows of (bucket +
// 4) words put every fragment load in 32 banks. A block has 8 warps (the
// dQ pass 4 at buckets 256 and 320, where shared memory holds no more
// rows), and each warp issues its products' chains interleaved, as the
// forward's do (flash_attention.cu says why).
//   dK/dV pass (attention_bwd_dkv_tf32x3): 16 kv rows a warp (at buckets
//     256 and 320 two warps share them, one summing dV and the other dK: a
//     warp holding both accumulators would need D floats a thread; the dV
//     warp computes s^T and hands p^T to the dK warp through shared memory
//     while that one computes dp^T); a step is a q block's qs (q scale) and
//     dO, hi and lo, with its lse and D.
//     A step: s^T = K qs^T and dp^T = V dO^T, p^T and ds^T, dV += p^T dO and
//     dK += ds^T qs.
//   dQ pass (attention_bwd_dq_tf32x3): 16 q rows a warp; the ring holds a
//     kv tile's V and then its K (hi and lo), one at a time: dp = dO V^T
//     with V, then s = qs K^T, ds and dQ += ds K with K.
//   What bounds them: the tensor pipe's issue (three mma.sync a product)
//   and the shared-memory reads of the B fragments (4 words a lane for 3
//   products), with one step's copy in flight behind them.
//   bucket   dK/dV: warps, kv tile, q block   dQ: warps, q block, kv tile   shared memory (dK/dV, dQ)
//   64       8, 128, 32                       8, 128, 64                    122,112 B, 122,880 B
//   128      8, 128, 16                       8, 128, 32                    185,984 B, 186,880 B
//   256      8 (pairs), 64, 8                 4, 64, 16                     185,152 B, 183,552 B
//   320      8 (pairs), 64, 8                 4, 64, 16                     230,208 B, 228,608 B
//   (kernels/flash_attention.py:tf32x3_smem mirrors the table.)
// The Δ pre-pass and the GQA reduce are the mma_sync route's kernels, in
// float32.

#include <math.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

typedef __nv_bfloat16 bf16;

template <typename T>
struct Elem;
template <>
struct Elem<float> {  // the float32 GQA reduce's store
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
__device__ __forceinline__ void store_chunk(float* dst, const float* x) {  // float32 pre-pass
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
// A row of the (B, H, pitch) row space to each group of lpr lanes (a power
// of two <= 32, each lane 16 bytes of the row at a time; 32 / lpr rows a
// warp). delta (and lse_pad) have that pitch. With qs != null (the wgmma
// route) it also writes the row's qs = round_T(q * scale) into the
// contiguous (B, H, Lq, D) scratch and copies its lse into lse_pad; rows
// Lq .. pitch - 1 get D = 0 and lse = +inf, so that a q block past Lq
// reads them as the other routes' loads set them.

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, const T* __restrict__ q,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ lse_pad, T* __restrict__ qs, Strides os, Strides dos,
                    Strides qst, int H, int Lq, int pitch, int D, float scale,
                    long long n_rows, int lpr, int vec) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, sub = lane & (lpr - 1);
  const long long r =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * (32 / lpr) +
      lane / lpr;
  const bool valid = r < n_rows;
  const int i = valid ? static_cast<int>(r % pitch) : 0;
  const long long bh = valid ? r / pitch : 0;
  const bool in = valid && i < Lq;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  float s = 0.f;
  if (in) {
    const T* op = o + b * os.b + h * os.h + i * os.l;
    const T* dp = dout + b * dos.b + h * dos.h + i * dos.l;
    for (int c = sub * E; c < D; c += lpr * E) {
      float x[E], y[E];
      load_chunk(op + c, vec & 16, x);
      load_chunk(dp + c, vec & 8, y);
#pragma unroll
      for (int e = 0; e < E; ++e) s += x[e] * y[e];
    }
  }
  for (int off = lpr / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (valid && sub == 0) {
    delta[r] = in ? s : 0.f;
    if (qs != nullptr) lse_pad[r] = in ? lse[bh * Lq + i] : INFINITY;
  }
  if (in && qs != nullptr) {
    const T* qp = q + b * qst.b + h * qst.h + i * qst.l;
    T* out = qs + (bh * Lq + i) * D;
    for (int c = sub * E; c < D; c += lpr * E) {
      float x[E];
      load_chunk(qp + c, vec & 1, x);
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] *= scale;
      store_chunk(out + c, x);
    }
  }
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
// (blockIdx.y: 0 dv, 1 dk), 4 columns a thread (D is a multiple of 16).
template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_reduce(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                     T* __restrict__ dk, T* __restrict__ dv, Strides dks, Strides dvs, int Hkv,
                     int group, int Lk, int D, int n4) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n4) return;
  const int which = blockIdx.y;
  const int d = (idx % (D / 4)) * 4, row = idx / (D / 4);  // row of (B, Hkv, Lk)
  const int j = row % Lk, bh = row / Lk;
  const int hk = bh % Hkv, b = bh / Hkv;
  const long long head = static_cast<long long>(Lk) * D;
  const float* p = (which ? dk_part : dv_part) +
                   (static_cast<long long>(b) * Hkv * group + hk * group) * head +
                   static_cast<long long>(j) * D + d;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < group; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(p + i * head);
    s.x += x.x, s.y += x.y, s.z += x.z, s.w += x.w;
  }
  T* o = which ? dk + b * dks.b + hk * dks.h + j * dks.l + d
               : dv + b * dvs.b + hk * dvs.h + j * dvs.l + d;
  o[0] = Elem<T>::put(s.x);
  o[1] = Elem<T>::put(s.y);
  o[2] = Elem<T>::put(s.z);
  o[3] = Elem<T>::put(s.w);
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

// ---- the tf32x3 route (float32 at every bucket) -------------------------------

namespace x3 {

// dK/dV pass: NW warps of 16 kv rows each (with SPLIT, pairs of warps on 16
// rows: the even warp sums dV, the odd one dK), q blocks of BM rows.
template <int DM, int NW, bool SPLIT, int BM_>
struct DkvShape {
  static constexpr int BM = BM_, BN = 16 * (SPLIT ? NW / 2 : NW), LD = Row<DM>::LD;
  static constexpr int THREADS = 32 * NW, QT = BM * LD;  // floats of a q-side tile
  // K and V raw; q and dO landing; qs hi, qs lo, dO hi, dO lo; the step's lse
  // and D; with SPLIT, each pair's p^T (its 16 x BM piece, lane by lane)
  static constexpr int PAIR_P = SPLIT ? (NW / 2) * 16 * BM : 0;
  static constexpr int SMEM = ((2 * BN + 6 * BM) * LD + 2 * BM + PAIR_P) * 4;
  static_assert(BM % 8 == 0 && (!SPLIT || NW % 2 == 0), "warp pieces");
};

template <int DM, int NW, bool SPLIT, int BM>
__global__ void __launch_bounds__(32 * NW, 1)
attention_bwd_dkv_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dk_part, float* __restrict__ dv_part, Strides qs,
                         Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                         const int* __restrict__ plan, int group, int Lq, int Lk, int D,
                         int causal, int window, float scale, int vec) {
  using Sh = DkvShape<DM, NW, SPLIT, BM>;
  constexpr int BN = Sh::BN, LD = Sh::LD, THREADS = Sh::THREADS, QT = Sh::QT, NT = BM / 8;
  constexpr int NA = SPLIT ? 1 : 2;  // output accumulators a warp holds
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BN * LD;
  float* rawQ = sV + BN * LD;
  float* rawD = rawQ + QT;
  float* work = rawD + QT;  // qs hi, qs lo, dO hi, dO lo
  float* sL = work + 4 * QT;
  float* sD = sL + BM;
  float* pair_p = sD + BM;

  // plan row: kv tile, first and end q block, first and end block without a mask
  const int* pr = plan + 5 * blockIdx.z;
  const int kb = pr[0], qb0 = pr[1], qb1 = pr[2], fb0 = pr[3], fb1 = pr[4];
  const int H = gridDim.x, h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int c0 = kb * BN, n = qb1 - qb0;
  const long long row_bh = (static_cast<long long>(b) * H + h) * Lq;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* dop = dout + b * dos.b + h * dos.h;

  copy_tile<BN, THREADS>(sK, LD, k + b * ks.b + hk * ks.h, ks.l, c0, Lk, D, vec & 2);
  copy_tile<BN, THREADS>(sV, LD, v + b * vs.b + hk * vs.h, vs.l, c0, Lk, D, vec & 4);
  // step i: q block qb0 + i (q and dO raw)
  auto issue = [&](int i) {
    if (i < n) {
      copy_tile<BM, THREADS>(rawQ, LD, qp, qs.l, (qb0 + i) * BM, Lq, D, vec & 1);
      copy_tile<BM, THREADS>(rawD, LD, dop, dos.l, (qb0 + i) * BM, Lq, D, vec & 8);
    }
    cp_commit();
  };
  issue(0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int unit = SPLIT ? warp >> 1 : warp;
  const bool do_dv = !SPLIT || (warp & 1) == 0, do_dk = !SPLIT || (warp & 1) == 1;
  const int j0 = c0 + unit * 16 + g;  // this lane's kv rows: j0 and j0 + 8
  const float* ka = sK + (unit * 16 + g) * LD + t;
  const float* va = sV + (unit * 16 + g) * LD + t;
  float acc[NA][DM / 8][4];
#pragma unroll
  for (int a = 0; a < NA; ++a) zero(acc[a]);
  float s[NT][4], dp[NT][4];

  const uint32_t* qh = reinterpret_cast<const uint32_t*>(work);
  const uint32_t* ql = qh + QT;
  const uint32_t* dh = qh + 2 * QT;
  const uint32_t* dl = qh + 3 * QT;
  for (int i = 0; i < n; ++i) {
    cp_wait_all();
    __syncthreads();  // step i (and K, V) landed; every warp is done with step i - 1
    const int qb = qb0 + i, q0 = qb * BM;
    split_tile<BM, THREADS>(rawQ, work, work + QT, LD, D, scale);  // qs = q scale
    split_tile<BM, THREADS>(rawD, work + 2 * QT, work + 3 * QT, LD, D, 1.f);
    for (int r = threadIdx.x; r < BM; r += THREADS) {
      const bool in = q0 + r < Lq;
      sL[r] = in ? lse[row_bh + q0 + r] : INFINITY;
      sD[r] = in ? delta[row_bh + q0 + r] : 0.f;
    }
    __syncthreads();  // the landing tiles are free: step i + 1 lands while step i runs
    issue(i + 1);

    // s^T = K qs^T and dp^T = V dO^T (16 kv rows x BM q columns), then p^T
    // and ds^T in place: element e of n-tile j is kv row j0 + 8 (e / 2), q
    // column 8 j + 2 t + e % 2. Without SPLIT a warp issues both products'
    // chains interleaved (at D 128 and 80 the pass took 5-12% longer with
    // one product after the other); with SPLIT, the pair's dV warp computes
    // s^T and hands p^T over in shared memory (a fragment a lane) while its
    // dK warp computes dp^T.
    const bool partial = qb < fb0 || qb >= fb1;
    zero(s);
    zero(dp);
    if (!SPLIT)
      mma3_kdim2<NT>(s, ka, qh, ql, dp, va, dh, dl, LD, g * LD + t, LD, D);
    else if (do_dv)
      mma3_kdim<NT>(s, ka, LD, qh, ql, g * LD + t, LD, D);
    else
      mma3_kdim<NT>(dp, va, LD, dh, dl, g * LD + t, LD, D);
    if (do_dv) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          float p = expf(s[j][e] - sL[col]);
          if (partial && !visible(q0 + col, j0 + 8 * (e >> 1), Lq, Lk, causal, window)) p = 0.f;
          s[j][e] = p;
        }
    }
    if constexpr (SPLIT) {
      float* pp = pair_p + (unit * 32 + lane) * (BM / 2);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (do_dv) pp[4 * j + e] = s[j][e];
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + unit) : "memory");  // the pair's p^T
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (do_dk) s[j][e] = pp[4 * j + e];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (do_dk) dp[j][e] = s[j][e] * (dp[j][e] - sD[8 * j + 2 * t + (e & 1)]);
    // dV += p^T dO and dK += ds^T qs read dO's and qs's rows 2t and 2t + 1
    // of each 8-row k-step
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      const int base = (8 * jj + 2 * t) * LD + g;
      uint32_t ph[4], pl[4];
      if (!SPLIT) {
        uint32_t dsh[4], dsl[4];
        a_from_acc(ph, pl, s[jj]);
        a_from_acc(dsh, dsl, dp[jj]);
        mma3_rows2<DM>(acc[0], ph, pl, dh, dl, acc[NA - 1], dsh, dsl, qh, ql, base, LD, D);
      } else if (do_dv) {
        a_from_acc(ph, pl, s[jj]);
        mma3_rows<DM>(acc[0], ph, pl, dh, dl, base, LD, D);
      } else {
        a_from_acc(ph, pl, dp[jj]);
        mma3_rows<DM>(acc[0], ph, pl, qh, ql, base, LD, D);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const bool is_dk = SPLIT ? (warp & 1) == 1 : a == 1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = j0 + 8 * r;
      if (row >= Lk) continue;
#pragma unroll
      for (int c = 0; c < DM / 8; ++c) {
        const int col = 8 * c + 2 * t;
        if (col >= D) continue;
        float* o;
        if (dk_part != nullptr)  // a query head's share; the reduce kernel sums the group
          o = (is_dk ? dk_part : dv_part) +
              ((static_cast<long long>(b) * H + h) * Lk + row) * D + col;
        else
          o = is_dk ? dk + b * dks.b + hk * dks.h + row * dks.l + col
                    : dv + b * dvs.b + hk * dvs.h + row * dvs.l + col;
        o[0] = acc[a][c][2 * r];
        o[1] = acc[a][c][2 * r + 1];
      }
    }
  }
}

// dQ pass: NW warps of 16 q rows each, kv tiles of BN rows.
template <int DM, int NW, int BN_>
struct DqShape {
  static constexpr int BM = 16 * NW, BN = BN_, LD = Row<DM>::LD, THREADS = 32 * NW;
  static constexpr int TILE = BN * LD;  // floats of a kv tile
  // qs and dO raw, the landing tile and the hi and lo tiles, the block's lse and D
  static constexpr int SMEM = (2 * BM * LD + 3 * TILE + 2 * BM) * 4;
  static_assert(BN % 8 == 0, "8-column n-tiles");
};

template <int DM, int NW, int BN>
__global__ void __launch_bounds__(32 * NW, 1)
attention_bwd_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dqs, const int* __restrict__ plan, int group, int Lq, int Lk,
                        int D, int causal, int window, float scale, int vec) {
  using Sh = DqShape<DM, NW, BN>;
  constexpr int BM = Sh::BM, LD = Sh::LD, THREADS = Sh::THREADS, NT = BN / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + BM * LD;
  float* raw = sdO + BM * LD;
  float* hi = raw + Sh::TILE;
  float* lo = hi + Sh::TILE;
  float* sL = lo + Sh::TILE;
  float* sD = sL + BM;

  // plan row: q block, first and end kv tile, first and end tile without a mask
  const int* pr = plan + 5 * blockIdx.z;
  const int qb = pr[0], kb0 = pr[1], kb1 = pr[2], fb0 = pr[3], fb1 = pr[4];
  const int H = gridDim.x, h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int q0 = qb * BM;
  const long long row_bh = (static_cast<long long>(b) * H + h) * Lq;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;

  // item i: V (i even) or K (i odd) of kv tile kb0 + i / 2
  const int n_items = 2 * (kb1 - kb0);
  auto issue = [&](int i) {
    if (i < n_items) {
      const bool is_k = i & 1;
      copy_tile<BN, THREADS>(raw, LD, is_k ? kp : vp, is_k ? ks.l : vs.l, (kb0 + i / 2) * BN,
                             Lk, D, vec & (is_k ? 2 : 4));
    }
    cp_commit();
  };
  issue(0);
  load_scaled<BM, THREADS>(sQ, LD, q + b * qs.b + h * qs.h, qs.l, q0, Lq, D, vec & 1, scale);
  load_scaled<BM, THREADS>(sdO, LD, dout + b * dos.b + h * dos.h, dos.l, q0, Lq, D, vec & 8,
                           1.f);
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const bool in = q0 + r < Lq;
    sL[r] = in ? lse[row_bh + q0 + r] : INFINITY;
    sD[r] = in ? delta[row_bh + q0 + r] : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this lane's rows of the block: r0 and r0 + 8
  const float* qa = sQ + r0 * LD + t;
  const float* da = sdO + r0 * LD + t;
  float acc[DM / 8][4], s[NT][4], dp[NT][4];
  zero(acc);
  zero(dp);

  const uint32_t* bh = reinterpret_cast<const uint32_t*>(hi);
  const uint32_t* bl = reinterpret_cast<const uint32_t*>(lo);
  for (int i = 0; i < n_items; ++i) {
    cp_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1's hi and lo
    split_tile<BN, THREADS>(raw, hi, lo, LD, D, 1.f);
    __syncthreads();  // the landing tile is free: item i + 1 lands while item i is used
    issue(i + 1);
    const int kb = kb0 + i / 2;

    if ((i & 1) == 0) {  // V: dp = dO V^T
      zero(dp);
      mma3_kdim<NT>(dp, da, LD, bh, bl, g * LD + t, LD, D);
      continue;
    }
    // K: s = qs K^T, ds in place of s, dQ += ds K
    zero(s);
    mma3_kdim<NT>(s, qa, LD, bh, bl, g * LD + t, LD, D);
    const bool partial = kb < fb0 || kb >= fb1;
    const int c0 = kb * BN;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
        float p = expf(s[j][e] - sL[r]);
        if (partial && !visible(q0 + r, c0 + col, Lq, Lk, causal, window)) p = 0.f;
        s[j][e] = p * (dp[j][e] - sD[r]);
      }
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      uint32_t ah[4], al[4];
      a_from_acc(ah, al, s[jj]);
      mma3_rows<DM>(acc, ah, al, bh, bl, (8 * jj + 2 * t) * LD + g, LD, D);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= Lq) continue;
    float* out = dq + b * dqs.b + h * dqs.h + row * dqs.l;
#pragma unroll
    for (int c = 0; c < DM / 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (col >= D) continue;
      out[col] = scale * acc[c][2 * r];
      out[col + 1] = scale * acc[c][2 * r + 1];
    }
  }
}

}  // namespace x3

// ---- the wgmma route (bfloat16, D_pad 64 and 128) ----------------------------

namespace tc {

constexpr int kBarBytes = 128;  // room for the mbarriers

// Both passes: 256 threads, two consumer warpgroups, and the first thread
// fills a ring of kStages stages kAhead steps ahead. ptxas gives every
// thread at most 168 registers when a block has 9 or 12 warps (one
// sub-partition's 16,384 registers over 3 warps), whatever setmaxnreg asks
// at run time; the dK/dV pass at D_pad 128 takes 226 and spilled 4.3 KB
// with a producer warp or warpgroup.
constexpr int kStages = 4;
constexpr int kAhead = 2;  // <= kStages - 2: a refill waits on a step two back

// dK/dV pass: BN kv rows (two consumer warpgroups of 64), q blocks of BM.
template <int DP>
struct DkvLayout {
  static constexpr int BN = 128, BM = 64, NWG = 2, NBOX = DP / kBox;
  static constexpr int KV_BYTES = BN * DP * 2;  // K or V: NBOX boxes of BN rows x 128 bytes
  static constexpr int Q_BYTES = BM * DP * 2;   // qs or dO of a stage
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int QS_OFF = V_OFF + KV_BYTES;
  static constexpr int DO_OFF = QS_OFF + kStages * Q_BYTES;
  static constexpr int L_OFF = DO_OFF + kStages * Q_BYTES;  // lse of a stage's BM rows
  static constexpr int D_OFF = L_OFF + kStages * BM * 4;    // and their D
  static constexpr int BAR_OFF = D_OFF + kStages * BM * 4;
  static constexpr int SMEM = BAR_OFF + kBarBytes + 1024;  // slack to align to 1024
  static constexpr int THREADS = NWG * kWarpgroup;
};

// acc (64 x N) = A (64 rows of a K-major tile at a) . B (N rows of a K-major
// tile at b)^T over the first NK k-steps of the head dim (the rest hold
// TMA's zero fill); each tile is NBOX boxes of a_rows / b_rows rows x 128
// bytes. NK is a constant: a branch between the wgmmas makes ptxas
// serialize them.
template <int N, int NK>
__device__ __forceinline__ void product_kmajor(float* acc, uint32_t a, int a_rows, uint32_t b,
                                               int b_rows) {
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    const uint32_t within = (kc % 4) * 32;  // 16 columns = 32 bytes into the box
    WgmmaSS<N>::run(acc,
                    sw128_desc(a + (kc / 4) * a_rows * kRowBytes + within, 16, 8 * kRowBytes),
                    sw128_desc(b + (kc / 4) * b_rows * kRowBytes + within, 16, 8 * kRowBytes),
                    kc > 0);
  }
}

// acc (64 x N) += P (64 x K, registers: K / 16 groups of 4 packed bf16
// pairs, the accumulator layout of a 64 x K product) . B (K rows x N columns
// of an MN-major tile at b, boxes of b_rows rows x 128 bytes: N = 80 reads
// the first 16 columns of the second box)
template <int K, int N>
__device__ __forceinline__ void product_rs(float* acc, const uint32_t* pk, uint32_t b,
                                           int b_rows) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    WgmmaRS<N>::run(acc, &pk[4 * kk],
                     sw128_desc(b + kk * 16 * kRowBytes, b_rows * kRowBytes, 8 * kRowBytes));
}

template <int DP, int NK>
__global__ void __launch_bounds__(DkvLayout<DP>::THREADS, 1)
attention_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tqs,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse_pad, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        float* __restrict__ dk_part, float* __restrict__ dv_part, Strides dks,
                        Strides dvs, const int* __restrict__ plan, int group, int Lq, int Lk,
                        int lq_pad, int D, int causal, int window) {
  using Lt = DkvLayout<DP>;
  constexpr int BN = Lt::BN, BM = Lt::BM, NWG = Lt::NWG, NBOX = Lt::NBOX;
  constexpr int S = kStages;
  constexpr int NO = 16 * NK;  // output columns: D_pad, or 80 at D 80
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;  // swizzle atoms are 1024 bytes
  const uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t s_k = base + Lt::K_OFF, s_v = base + Lt::V_OFF;
  const uint32_t bar = base + Lt::BAR_OFF;
  const uint32_t kv_full = bar;
  auto full = [&](int st) { return bar + 8 + 8 * st; };
  auto empty = [&](int st) { return bar + 8 + 8 * S + 8 * st; };

  // plan row: kv tile, first and end q block, first and end block without a mask
  const int* pr = plan + 5 * blockIdx.z;
  const int kb = pr[0], qb0 = pr[1], qb1 = pr[2], fb0 = pr[3], fb1 = pr[4];
  const int H = gridDim.x, h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int c0 = kb * BN, n = qb1 - qb0;
  const int wg = threadIdx.x / kWarpgroup;
  const long long row_bh = (static_cast<long long>(b) * H + h) * lq_pad;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the i-th q block of the walk into stage i % S, once its last user is done
  const bool loader = threadIdx.x == 0;
  auto load = [&](int i) {
    const int st = i % S, qb = qb0 + i;
    if (i >= S) mbar_wait(empty(st), (i / S - 1) & 1);
    mbar_expect_tx(full(st), 2 * Lt::Q_BYTES + 2 * BM * 4);
    const uint32_t sq = base + Lt::QS_OFF + st * Lt::Q_BYTES;
    const uint32_t sdo = base + Lt::DO_OFF + st * Lt::Q_BYTES;
    for (int c = 0; c < NBOX; ++c) {
      tma_load(sq + c * BM * kRowBytes, &tqs, full(st), c * kBox, qb * BM, h, b);
      tma_load(sdo + c * BM * kRowBytes, &tdo, full(st), c * kBox, qb * BM, h, b);
    }
    bulk_load(base + Lt::L_OFF + st * BM * 4, lse_pad + row_bh + qb * BM, BM * 4, full(st));
    bulk_load(base + Lt::D_OFF + st * BM * 4, delta + row_bh + qb * BM, BM * 4, full(st));
  };
  if (loader) {
    mbar_expect_tx(kv_full, 2 * Lt::KV_BYTES);
    for (int c = 0; c < NBOX; ++c) {
      tma_load(s_k + c * BN * kRowBytes, &tk, kv_full, c * kBox, c0, hk, b);
      tma_load(s_v + c * BN * kRowBytes, &tv, kv_full, c * kBox, c0, hk, b);
    }
    for (int i = 0; i < kAhead && i < n; ++i) load(i);
  }

  // ---- consumers: 64 kv rows per warpgroup ----
  const int t = threadIdx.x - wg * kWarpgroup;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, c4 = lane & 3;
  const int j0 = c0 + wg * 64 + warp * 16 + g;  // this lane's kv rows: j0 and j0 + 8
  const uint32_t a_k = s_k + wg * 64 * kRowBytes, a_v = s_v + wg * 64 * kRowBytes;

  float dv_acc[NO / 2], dk_acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
  float s[BM / 2], dp[BM / 2];
  uint32_t pk[BM / 4], dsk[BM / 4];

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n; ++i) {
    if (loader && i + kAhead < n) load(i + kAhead);
    const int st = i % S, ph = (i / S) & 1, qb = qb0 + i;
    const uint32_t sq = base + Lt::QS_OFF + st * Lt::Q_BYTES;
    const uint32_t sdo = base + Lt::DO_OFF + st * Lt::Q_BYTES;
    const float* sL = reinterpret_cast<const float*>(smem + Lt::L_OFF) + st * BM;
    const float* sD = reinterpret_cast<const float*>(smem + Lt::D_OFF) + st * BM;
    const int q0 = qb * BM;

    mbar_wait(full(st), ph);
    wg_fence();
    product_kmajor<BM, NK>(s, a_k, BN, sq, BM);  // s^T = K qs^T
    product_kmajor<BM, NK>(dp, a_v, BN, sdo, BM);  // dp^T = V dO^T
    wg_commit();
    wg_wait<0>();
    reg_fence<BM / 2>(s);
    reg_fence<BM / 2>(dp);

    // element 4 jj + e is kv row j0 + 8 (e / 2), q column 8 jj + 2 c4 + e % 2;
    // p and ds rounded to bf16 as wgmma's register A operand, a k-step (16 q
    // columns) in 4 registers, as the forward feeds P
    const bool partial = qb < fb0 || qb >= fb1;
#pragma unroll
    for (int jj = 0; jj < BM / 8; ++jj) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * jj + 2 * c4 + (e & 1);
        p[e] = expf(s[4 * jj + e] - sL[col]);
        if (partial && !visible(q0 + col, j0 + 8 * (e >> 1), Lq, Lk, causal, window)) p[e] = 0.f;
        ds[e] = p[e] * (dp[4 * jj + e] - sD[col]);
      }
      pk[2 * jj] = pack_bf16(p[0], p[1]);
      pk[2 * jj + 1] = pack_bf16(p[2], p[3]);
      dsk[2 * jj] = pack_bf16(ds[0], ds[1]);
      dsk[2 * jj + 1] = pack_bf16(ds[2], ds[3]);
    }

    reg_fence<NO / 2>(dv_acc);
    reg_fence<NO / 2>(dk_acc);
    wg_fence();
    product_rs<BM, NO>(dv_acc, pk, sdo, BM);   // dV += p^T dO
    product_rs<BM, NO>(dk_acc, dsk, sq, BM);   // dK += ds^T qs
    wg_commit();
    wg_wait<0>();
    reg_fence<NO / 2>(dv_acc);
    reg_fence<NO / 2>(dk_acc);
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = j0 + 8 * r;
    if (row >= Lk) continue;
#pragma unroll
    for (int jj = 0; jj < NO / 8; ++jj) {
      const int col = 8 * jj + 2 * c4;
      if (col >= D) continue;
      const float v0 = dv_acc[4 * jj + 2 * r], v1 = dv_acc[4 * jj + 2 * r + 1];
      const float k0 = dk_acc[4 * jj + 2 * r], k1 = dk_acc[4 * jj + 2 * r + 1];
      if (dk_part != nullptr) {  // a query head's share; the reduce kernel sums the group
        const long long o = ((static_cast<long long>(b) * H + h) * Lk + row) * D + col;
        *reinterpret_cast<float2*>(dv_part + o) = make_float2(v0, v1);
        *reinterpret_cast<float2*>(dk_part + o) = make_float2(k0, k1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dv + b * dvs.b + hk * dvs.h + row * dvs.l + col) =
            __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(dk + b * dks.b + hk * dks.h + row * dks.l + col) =
            __floats2bfloat162_rn(k0, k1);
      }
    }
  }
}

// dQ pass: BM q rows (two consumer warpgroups of 64), kv tiles of BN rows
// in a ring of kStages stages filled kAhead tiles ahead by the first
// consumer thread, as the dK/dV pass's.
template <int DP>
struct DqLayout {
  static constexpr int BM = 128, BN = 64, NWG = 2, NBOX = DP / kBox;
  static constexpr int Q_BYTES = BM * DP * 2;   // qs or dO
  static constexpr int KV_BYTES = BN * DP * 2;  // K or V of a stage
  static constexpr int QS_OFF = 0;
  static constexpr int DO_OFF = QS_OFF + Q_BYTES;
  static constexpr int K_OFF = DO_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + kBarBytes + 1024;
  static constexpr int THREADS = NWG * kWarpgroup;
};

template <int DP, int NK>
__global__ void __launch_bounds__(DqLayout<DP>::THREADS, 1)
attention_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tqs,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse_pad, const float* __restrict__ delta,
                       bf16* __restrict__ dq, Strides dqs, const int* __restrict__ plan,
                       int group, int Lq, int Lk, int lq_pad, int D, int causal, int window,
                       float scale) {
  using Lt = DqLayout<DP>;
  constexpr int BN = Lt::BN, BM = Lt::BM, NWG = Lt::NWG, NBOX = Lt::NBOX;
  constexpr int NO = 16 * NK;  // output columns: D_pad, or 80 at D 80
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t base = raw + pad;
  const uint32_t s_qs = base + Lt::QS_OFF, s_do = base + Lt::DO_OFF;
  const uint32_t bar = base + Lt::BAR_OFF;
  const uint32_t q_full = bar;
  auto full = [&](int st) { return bar + 8 + 8 * st; };
  auto empty = [&](int st) { return bar + 8 + 8 * S + 8 * st; };

  const int* pr = plan + 5 * blockIdx.z;
  const int qb = pr[0], kb0 = pr[1], kb1 = pr[2], fb0 = pr[3], fb1 = pr[4];
  const int H = gridDim.x, h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int q0 = qb * BM, n = kb1 - kb0;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool loader = threadIdx.x == 0;
  auto load = [&](int i) {
    const int st = i % S, kb = kb0 + i;
    if (i >= S) mbar_wait(empty(st), (i / S - 1) & 1);
    mbar_expect_tx(full(st), 2 * Lt::KV_BYTES);
    const uint32_t sk = base + Lt::K_OFF + st * Lt::KV_BYTES;
    const uint32_t sv = base + Lt::V_OFF + st * Lt::KV_BYTES;
    for (int c = 0; c < NBOX; ++c) {
      tma_load(sk + c * BN * kRowBytes, &tk, full(st), c * kBox, kb * BN, hk, b);
      tma_load(sv + c * BN * kRowBytes, &tv, full(st), c * kBox, kb * BN, hk, b);
    }
  };
  if (loader) {
    mbar_expect_tx(q_full, 2 * Lt::Q_BYTES);
    for (int c = 0; c < NBOX; ++c) {
      tma_load(s_qs + c * BM * kRowBytes, &tqs, q_full, c * kBox, q0, h, b);
      tma_load(s_do + c * BM * kRowBytes, &tdo, q_full, c * kBox, q0, h, b);
    }
    for (int i = 0; i < kAhead && i < n; ++i) load(i);
  }

  const int t = threadIdx.x - wg * kWarpgroup;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, c4 = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  const uint32_t a_qs = s_qs + wg * 64 * kRowBytes, a_do = s_do + wg * 64 * kRowBytes;
  const long long row_bh = (static_cast<long long>(b) * H + h) * lq_pad;
  const float l_r[2] = {lse_pad[row_bh + row0], lse_pad[row_bh + row0 + 8]};
  const float d_r[2] = {delta[row_bh + row0], delta[row_bh + row0 + 8]};

  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
  float s[BN / 2], dp[BN / 2];
  uint32_t dsk[BN / 4], prev[BN / 4];  // this tile's ds, and the one dQ takes now

  mbar_wait(q_full, 0);
  for (int i = 0; i < n; ++i) {
    if (loader && i + kAhead < n) load(i + kAhead);
    const int st = i % S, ph = (i / S) & 1, kb = kb0 + i;
    const uint32_t sk = base + Lt::K_OFF + st * Lt::KV_BYTES;
    const uint32_t sv = base + Lt::V_OFF + st * Lt::KV_BYTES;
    const int c0 = kb * BN;

    mbar_wait(full(st), ph);
    wg_fence();
    product_kmajor<BN, NK>(s, a_qs, BM, sk, BN);   // s = qs K^T
    product_kmajor<BN, NK>(dp, a_do, BM, sv, BN);  // dp = dO V^T
    wg_commit();
    if (i > 0) {  // the last tile's dQ += ds K, behind this tile's s and dp
      reg_fence<NO / 2>(acc);
      product_rs<BN, NO>(acc, prev, base + Lt::K_OFF + ((i - 1) % S) * Lt::KV_BYTES, BN);
      wg_commit();
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    reg_fence<BN / 2>(s);
    reg_fence<BN / 2>(dp);

    const bool partial = kb < fb0 || kb >= fb1;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[4 * jj + e] - l_r[e >> 1]);
        if (partial &&
            !visible(row0 + 8 * (e >> 1), c0 + 8 * jj + 2 * c4 + (e & 1), Lq, Lk, causal, window))
          p = 0.f;
        ds[e] = p * (dp[4 * jj + e] - d_r[e >> 1]);
      }
      dsk[2 * jj] = pack_bf16(ds[0], ds[1]);
      dsk[2 * jj + 1] = pack_bf16(ds[2], ds[3]);
    }
    if (i > 0) {
      wg_wait<0>();
      reg_fence<NO / 2>(acc);
      if (lane == 0) mbar_arrive(empty((i - 1) % S));
    }
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) prev[j] = dsk[j];
  }
  if (n > 0) {
    reg_fence<NO / 2>(acc);
    wg_fence();
    product_rs<BN, NO>(acc, prev, base + Lt::K_OFF + ((n - 1) % S) * Lt::KV_BYTES, BN);
    wg_commit();
    wg_wait<0>();
    reg_fence<NO / 2>(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    bf16* out = dq + b * dqs.b + h * dqs.h + row * dqs.l;
#pragma unroll
    for (int jj = 0; jj < NO / 8; ++jj) {
      const int col = 8 * jj + 2 * c4;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
            scale * acc[4 * jj + 2 * r], scale * acc[4 * jj + 2 * r + 1]);
    }
  }
}

}  // namespace tc

// ---- host side ---------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *delta, *dk_part, *dv_part, *q_scaled, *lse_pad;
  int B, H, Hkv, Lq, Lk, D;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale;
  const int *dq_plan, *dkv_plan;
  int n_dq_plan, n_dkv_plan, d_pad, dq_bq, dq_bk, dkv_bq, dkv_bk, lq_pad, vec;
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

// The pre-pass over B * H rows of `pitch` (>= Lq); q_scaled and lse_pad null
// on the mma_sync and tf32x3 routes.
template <typename T>
int launch_delta(const Args& a, int pitch, cudaStream_t st) {
  const long long n_rows = static_cast<long long>(a.B) * a.H * pitch;
  const int chunks = a.D / (16 / static_cast<int>(sizeof(T)));
  int lpr = 1;  // lanes a row: the row's 16-byte chunks, to a power of two <= 32
  while (lpr < chunks && lpr < 32) lpr *= 2;
  const long long rows_per_block = static_cast<long long>(kWarps) * (32 / lpr);
  attention_bwd_delta<T><<<static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block),
                           kThreads, 0, st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), static_cast<const T*>(a.q),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<float*>(a.lse_pad), static_cast<T*>(a.q_scaled), a.os, a.dos, a.qs, a.H, a.Lq,
      pitch, a.D, a.scale, n_rows, lpr, a.vec);
  return static_cast<int>(cudaGetLastError());
}

// dk and dv from the float32 partials of a GQA group's heads.
template <typename T>
int launch_reduce(const Args& a, cudaStream_t st) {
  const long long n4 = static_cast<long long>(a.B) * a.Hkv * a.Lk * (a.D / 4);
  if (n4 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attention_bwd_reduce<T><<<dim3(static_cast<unsigned>((n4 + 255) / 256), 2), 256, 0, st>>>(
      static_cast<const float*>(a.dk_part), static_cast<const float*>(a.dv_part),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dks, a.dvs, a.Hkv, a.H / a.Hkv, a.Lk,
      a.D, static_cast<int>(n4));
  return static_cast<int>(cudaGetLastError());
}

bool plans_ok(const Args& a, int dq_bq, int dq_bk, int dkv_bq, int dkv_bk) {
  return a.dq_bq == dq_bq && a.dq_bk == dq_bk && a.dkv_bq == dkv_bq && a.dkv_bk == dkv_bk &&
         (a.dq == nullptr || a.n_dq_plan == (a.Lq + dq_bq - 1) / dq_bq) &&
         (a.dk == nullptr || a.n_dkv_plan == (a.Lk + dkv_bk - 1) / dkv_bk) &&
         a.n_dq_plan <= 65535 && a.n_dkv_plan <= 65535 &&
         (a.dk == nullptr || a.H == a.Hkv || (a.dk_part != nullptr && a.dv_part != nullptr));
}

template <typename T, int DM, int BM, int BN>
int run(const Args& a, cudaStream_t st) {
  using S = Shape<T, DM, BM, BN>;
  const int group = a.H / a.Hkv;
  if (a.d_pad != DM || !plans_ok(a, BM, BN, BM, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);

  int err = launch_delta<T>(a, a.Lq, st);
  if (err != 0) return err;
  if (a.dk != nullptr) {
    static uint64_t done = 0;
    err = allow_smem(attention_bwd_dkv<T, DM, BM, BN>, S::SMEM_KV, &done);
    if (err != 0) return err;
    float* dk_part = group > 1 ? static_cast<float*>(a.dk_part) : nullptr;
    float* dv_part = group > 1 ? static_cast<float*>(a.dv_part) : nullptr;
    attention_bwd_dkv<T, DM, BM, BN><<<dim3(a.H, a.B, a.n_dkv_plan), kThreads, S::SMEM_KV, st>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), dk_part,
        dv_part, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.dkv_plan, group, a.Lq, a.Lk, a.D,
        a.causal, a.window, a.scale, a.vec);
    err = static_cast<int>(cudaGetLastError());
    if (err == 0 && group > 1) err = launch_reduce<T>(a, st);
    if (err != 0) return err;
  }
  if (a.dq != nullptr) {
    static uint64_t done = 0;
    err = allow_smem(attention_bwd_dq<T, DM, BM, BN>, S::SMEM_Q, &done);
    if (err != 0) return err;
    attention_bwd_dq<T, DM, BM, BN><<<dim3(a.H, a.B, a.n_dq_plan), kThreads, S::SMEM_Q, st>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs,
        a.dq_plan, group, a.Lq, a.Lk, a.D, a.causal, a.window, a.scale, a.vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tf32x3 route's two passes at bucket DM: the dK/dV pass's warps, warp
// pairs and q block; the dQ pass's warps and kv tile.
template <int DM, int KV_NW, bool SPLIT, int KV_BM, int Q_NW, int Q_BN>
int run_tf32x3(const Args& a, cudaStream_t st) {
  using Kv = x3::DkvShape<DM, KV_NW, SPLIT, KV_BM>;
  using Qd = x3::DqShape<DM, Q_NW, Q_BN>;
  const int group = a.H / a.Hkv;
  if (a.d_pad != DM || !plans_ok(a, Qd::BM, Qd::BN, Kv::BM, Kv::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  int err = launch_delta<float>(a, a.Lq, st);
  if (err != 0) return err;
  if (a.dk != nullptr) {
    static uint64_t done = 0;
    err = allow_smem(x3::attention_bwd_dkv_tf32x3<DM, KV_NW, SPLIT, KV_BM>, Kv::SMEM, &done);
    if (err != 0) return err;
    x3::attention_bwd_dkv_tf32x3<DM, KV_NW, SPLIT, KV_BM>
        <<<dim3(a.H, a.B, a.n_dkv_plan), Kv::THREADS, Kv::SMEM, st>>>(
            q, k, v, dout, lse, delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
            group > 1 ? static_cast<float*>(a.dk_part) : nullptr,
            group > 1 ? static_cast<float*>(a.dv_part) : nullptr, a.qs, a.ks, a.vs, a.dos,
            a.dks, a.dvs, a.dkv_plan, group, a.Lq, a.Lk, a.D, a.causal, a.window, a.scale,
            a.vec);
    err = static_cast<int>(cudaGetLastError());
    if (err == 0 && group > 1) err = launch_reduce<float>(a, st);
    if (err != 0) return err;
  }
  if (a.dq != nullptr) {
    static uint64_t done = 0;
    err = allow_smem(x3::attention_bwd_dq_tf32x3<DM, Q_NW, Q_BN>, Qd::SMEM, &done);
    if (err != 0) return err;
    x3::attention_bwd_dq_tf32x3<DM, Q_NW, Q_BN>
        <<<dim3(a.H, a.B, a.n_dq_plan), Qd::THREADS, Qd::SMEM, st>>>(
            q, k, v, dout, lse, delta, static_cast<float*>(a.dq), a.qs, a.ks, a.vs, a.dos,
            a.dqs, a.dq_plan, group, a.Lq, a.Lk, a.D, a.causal, a.window, a.scale, a.vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 pairs can be stored at every even column of every row
bool pairs_ok(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && s.l % 2 == 0 && s.h % 2 == 0 &&
         s.b % 2 == 0;
}

template <int DP, int NK>
int run_wgmma(const Args& a, cudaStream_t st) {
  using Kv = tc::DkvLayout<DP>;
  using Qd = tc::DqLayout<DP>;
  const int group = a.H / a.Hkv;
  if (!plans_ok(a, Qd::BM, Qd::BN, Kv::BM, Kv::BN) || a.q_scaled == nullptr ||
      a.lse_pad == nullptr || a.lq_pad % Qd::BM != 0 || a.lq_pad < a.Lq ||
      a.lq_pad - a.Lq >= Qd::BM || !tc::tma_ready(a.q, a.qs) || !tc::tma_ready(a.k, a.ks) ||
      !tc::tma_ready(a.v, a.vs) || !tc::tma_ready(a.dout, a.dos) ||
      (a.dq != nullptr && !pairs_ok(a.dq, a.dqs)) ||
      (a.dk != nullptr && (!pairs_ok(a.dk, a.dks) || !pairs_ok(a.dv, a.dvs))))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_delta<bf16>(a, a.lq_pad, st);
  if (err != 0) return err;
  const float* lse_pad = static_cast<const float*>(a.lse_pad);
  const float* delta = static_cast<const float*>(a.delta);
  const Strides qss{static_cast<long long>(a.H) * a.Lq * a.D,
                    static_cast<long long>(a.Lq) * a.D, a.D};  // the contiguous qs scratch
  // a pass's tensor maps (qs, k, v, dout), its q and kv boxes of these rows
  CUtensorMap m[4];
  auto maps = [&](int q_rows, int kv_rows) {
    return tc::encode(&m[0], a.q_scaled, a.D, a.Lq, a.H, a.B, qss, q_rows) &&
           tc::encode(&m[1], a.k, a.D, a.Lk, a.Hkv, a.B, a.ks, kv_rows) &&
           tc::encode(&m[2], a.v, a.D, a.Lk, a.Hkv, a.B, a.vs, kv_rows) &&
           tc::encode(&m[3], a.dout, a.D, a.Lq, a.H, a.B, a.dos, q_rows);
  };
  if (a.dk != nullptr) {
    if (!maps(Kv::BM, Kv::BN)) return static_cast<int>(cudaErrorInvalidValue);
    static uint64_t done = 0;
    err = allow_smem(tc::attention_bwd_dkv_wgmma<DP, NK>, Kv::SMEM, &done);
    if (err != 0) return err;
    const dim3 grid(a.H, a.B, a.n_dkv_plan);
    tc::attention_bwd_dkv_wgmma<DP, NK><<<grid, Kv::THREADS, Kv::SMEM, st>>>(
        m[0], m[1], m[2], m[3], lse_pad, delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), group > 1 ? static_cast<float*>(a.dk_part) : nullptr,
        group > 1 ? static_cast<float*>(a.dv_part) : nullptr, a.dks, a.dvs, a.dkv_plan, group,
        a.Lq, a.Lk, a.lq_pad, a.D, a.causal, a.window);
    err = static_cast<int>(cudaGetLastError());
    if (err == 0 && group > 1) err = launch_reduce<bf16>(a, st);
    if (err != 0) return err;
  }
  if (a.dq != nullptr) {
    if (!maps(Qd::BM, Qd::BN)) return static_cast<int>(cudaErrorInvalidValue);
    static uint64_t done = 0;
    err = allow_smem(tc::attention_bwd_dq_wgmma<DP, NK>, Qd::SMEM, &done);
    if (err != 0) return err;
    const dim3 grid(a.H, a.B, a.n_dq_plan);
    tc::attention_bwd_dq_wgmma<DP, NK><<<grid, Qd::THREADS, Qd::SMEM, st>>>(
        m[0], m[1], m[2], m[3], lse_pad, delta, static_cast<bf16*>(a.dq), a.dqs, a.dq_plan,
        group, a.Lq, a.Lk, a.lq_pad, a.D, a.causal, a.window, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, dout, dq, dk and dv alike; lse,
// delta, lse_pad and the partials are float32). Strides in elements, (batch,
// head, row) for each of q, k, v, o, dout, dq, dk, dv; the head-dim axis is
// contiguous; lse is (B, H, Lq) and the partials (B, H, Lk, D), contiguous.
// dq == null skips the dQ pass, dk == null the dK/dV pass (dk and dv come
// together); with H > Hkv the dK/dV pass needs both partials. D is a
// multiple of 16 in [16, 320], H a multiple of Hkv. route (from
// kernels/flash_attention.py:bwd_route, with d_pad and each pass's q block
// and kv tile rows): 0 mma_sync (bfloat16, d_pad 256 or 320) and 2 tf32x3
// (float32) (delta (B, H, Lq); q_scaled, lse_pad and lq_pad unused), 1 wgmma
// (bfloat16, d_pad 64 or 128; delta and lse_pad
// (B, H, lq_pad) with lq_pad the multiple of 128 at or above Lq, q_scaled
// (B, H, Lq, D) contiguous bf16 scratch; q, k, v and dout 16-byte aligned in
// base and strides). vec has bit 0 for q, 1 for k, 2 for v, 3 for dout and
// 4 for o where the tensor may be read 16 bytes at a time. The plans (device int32, five
// columns a row) come from kv_tile_plan (dQ pass) and q_tile_plan (dK/dV
// pass) at those blocks.
extern "C" int nebula_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* delta, void* dk_part, void* dv_part,
    void* q_scaled, void* lse_pad, int dtype, int B, int H, int Hkv, int Lq, int Lk, int D,
    long long qsb, long long qsh, long long qsl, long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl, long long osb, long long osh, long long osl,
    long long dosb, long long dosh, long long dosl, long long dqsb, long long dqsh,
    long long dqsl, long long dksb, long long dksh, long long dksl, long long dvsb,
    long long dvsh, long long dvsl, int causal, int window, float scale, const void* dq_plan,
    int n_dq_plan, const void* dkv_plan, int n_dkv_plan, int route, int d_pad, int dq_block_q,
    int dq_block_k, int dkv_block_q, int dkv_block_k, int lq_pad, int vec, void* stream) {
  if (D < 16 || D > 320 || D % 16 != 0 || B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      Lq < 1 || Lk < 1 || H > 65535 || B > 65535 || lse == nullptr || delta == nullptr ||
      (dk == nullptr) != (dv == nullptr) || (dq != nullptr && dq_plan == nullptr) ||
      (dk != nullptr && dkv_plan == nullptr) || d_pad < D || d_pad - D >= 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, delta, dk_part, dv_part, q_scaled, lse_pad,
               B, H, Hkv, Lq, Lk, D,
               Strides{qsb, qsh, qsl}, Strides{ksb, ksh, ksl}, Strides{vsb, vsh, vsl},
               Strides{osb, osh, osl}, Strides{dosb, dosh, dosl}, Strides{dqsb, dqsh, dqsl},
               Strides{dksb, dksh, dksl}, Strides{dvsb, dvsh, dvsl}, causal, window, scale,
               static_cast<const int*>(dq_plan), static_cast<const int*>(dkv_plan), n_dq_plan,
               n_dkv_plan, d_pad, dq_block_q, dq_block_k, dkv_block_q, dkv_block_k, lq_pad, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && route == 1) {
    // the head dim's k-steps: all of the bucket's but at D 80 (zamba2's),
    // whose last three hold only TMA's zero fill
    if (d_pad == 64) return run_wgmma<64, 4>(a, st);
    if (d_pad == 128 && D == 80) return run_wgmma<128, 5>(a, st);
    if (d_pad == 128) return run_wgmma<128, 8>(a, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0 && route == 2) {
    if (D <= 64) return run_tf32x3<64, 8, false, 32, 8, 64>(a, st);
    if (D <= 128) return run_tf32x3<128, 8, false, 16, 8, 32>(a, st);
    if (D <= 256) return run_tf32x3<256, 8, true, 8, 4, 16>(a, st);
    return run_tf32x3<320, 8, true, 8, 4, 16>(a, st);
  }
  if (dtype != 1 || route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 256 && D > 128) return run<bf16, 256, 64, 32>(a, st);
  if (D > 256) return run<bf16, 320, 64, 32>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);  // the wgmma route's head dims
}
