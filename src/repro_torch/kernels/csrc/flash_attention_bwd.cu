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
// Two routes, chosen by the host (kernels/flash_attention.py:bwd_route):
//
// wgmma — bfloat16 at every head dim (buckets 64, 128, 256 and 320), the
// training path's. The forward's machinery (sm90.cuh) applied to both
// passes. The pre-pass also writes qs = round_bf16(q * scale) once into a
// contiguous (B, H, Lq, D) scratch, and lse and D into (B, H, Lq_pad)
// buffers whose rows Lq .. Lq_pad - 1 (Lq_pad = Lq rounded up to 128) hold
// lse = +inf and D = 0: TMA's zero fill would give lse 0 there. Each pass
// is a block of two consumer warpgroups (256 threads), fed by TMA into
// 128-byte-swizzled shared memory (4-D tensor maps, boxes of 64 columns;
// head-dim columns past D arrive as zeros, a box wholly past D included,
// add 0 to every score and are never stored). The block's first thread
// issues every load: the block's fixed operands once, then a ring of S
// stages, each with its own full and empty mbarriers as the forward's,
// filled S - 2 steps ahead (a refill waits on the step two back, so neither
// warpgroup waits on the other's current step). No producer warp: with 9
// or 12 warps a block ptxas holds every thread to 168 registers (one
// sub-partition's 16,384 over 3 warps), whatever setmaxnreg asks at run
// time, and the dK/dV pass takes 226 (ptxas); with a producer warp or
// warpgroup it spilled 4.3 KB.
//   dK/dV pass (attention_bwd_dkv_wgmma): K and V of the kv tile once, then
//     stages of (qs block, dO block, their lse and D values by bulk copy).
//     A step: s^T = K qs^T and dp^T = V dO^T by wgmma (A and B from shared
//     memory, K-major), p^T and ds^T (the mask only on the blocks the plan
//     marks partial), then dV += p^T dO and dK += ds^T qs by wgmma with A
//     from registers: the m64nNk16 accumulator layout of s^T is the
//     register-A layout, as the forward feeds P; the B operand is the same
//     dO or qs tile read MN-major. At buckets 64 and 128 each warpgroup
//     takes 64 of the tile's 128 kv rows and does all four products (the dV
//     and dK accumulators 64 + 64 floats a thread at D_pad 128, s^T and dp^T
//     32 + 32), p and ds never touching shared memory. At 256 and 320 one
//     accumulator of 64 x D_pad is D_pad / 2 floats a thread (160 at 320),
//     so the two warpgroups share one tile of 64 kv rows: warpgroup 0 computes
//     s^T, p^T and dV, warpgroup 1 dp^T, ds^T and dK, two D-long products
//     each a step. Warpgroup 0 hands p^T over in float32 through two shared
//     buffers (a thread's values where the thread of the same rank in the
//     other warpgroup holds the same elements of dp^T), behind a pair of
//     named barriers a buffer (full, empty), so it may run a step ahead.
//     Output products wider than 256 columns (wgmma's widest) run as 256 +
//     64.
//   dQ pass (attention_bwd_dq_wgmma): BM 128 q rows, 64 a warpgroup; qs and
//     dO once, then stages of (K tile, V tile). A step: s = qs K^T and
//     dp = dO V^T (shared, K-major), ds in registers, then dQ += ds K (A
//     from registers, K read MN-major) is issued behind the next step's s
//     and dp and runs while that step's ds is computed (ds double-buffered
//     in registers, 204 in all at D_pad 128); dq is scaled once at the end.
//     Run after its step instead, the pass took 0.29 ms at the training
//     shape against 0.21. At 256 and 320 qs and dO of 128 rows take 128 or
//     160 KB, so the kv tiles shrink to 32 and 16 rows, 3 stages.
//   The s and dp products of a step are committed together and waited for
//   before p and ds are computed, into registers of their own: a write to
//   an accumulator while another product is in flight makes ptxas
//   serialize every wgmma of the kernel. They issue NK = D / 16 k-steps,
//   a constant of the instantiation: the bucket's, or 5 at D 80 (zamba2's),
//   whose last three would hold only zero fill; the output products are
//   16 NK columns wide (m64n80k16 at D 80, the second box read for its
//   first 16 columns), so D 80 does 5/8 of D 128's work.
//   pass     D_pad   kv tile   q block   stages   shared memory
//   dK/dV    64      128       64        4        101,504 B
//   dK/dV    128     128       64        4        199,808 B
//   dK/dV    256     64        32        4        215,168 B (pair)
//   dK/dV    320     64        32        3        223,104 B (pair)
//   dQ       64      64        128       4        99,456 B
//   dQ       128     64        128       4        197,760 B
//   dQ       256     32        128       3        230,528 B
//   dQ       320     16        128       3        226,432 B
//   (static_asserts after DqLayout hold the layouts to the table's bytes.)
//   TMA needs 16-byte aligned bases and strides of q, k, v and dout; the
//   host checks them and raises, and the entry point refuses anything
//   else: nothing is copied, nothing falls back to another route.
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
// The Δ pre-pass and the GQA reduce serve both routes (the tf32x3 route's
// pre-pass writes D alone).

#include <math.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

typedef __nv_bfloat16 bf16;

// the GQA reduce's store
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float put(float x) { return x; }
};
template <>
struct Elem<bf16> {
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

__device__ __forceinline__ bool visible(int row, int col, int Lq, int Lk, int causal, int window) {
  return row < Lq && col < Lk && (!causal || col <= row) && (window <= 0 || col > row - window);
}

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

// ---- the wgmma route (bfloat16 at every bucket) -------------------------------

namespace tc {

constexpr int kBarBytes = 128;     // room for the mbarriers
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100

// Both passes: 256 threads, two consumer warpgroups, and the first thread
// fills a ring of S stages S - 2 steps ahead (a refill waits on the step two
// back). ptxas gives every thread at most 168 registers when a block has 9
// or 12 warps (one sub-partition's 16,384 registers over 3 warps), whatever
// setmaxnreg asks at run time; the dK/dV pass at D_pad 128 takes 226 and
// spilled 4.3 KB with a producer warp or warpgroup.
//
// The blocks at a head-dim bucket DP: the dK/dV pass's kv tile (KV_BN) and q
// block (KV_BM) rows and stages (KV_S), and whether its two warpgroups share
// the kv tile, one summing dV and the other dK (PAIR: at 256 and 320 a
// warpgroup holding both would need D_pad floats a thread); the dQ pass's q
// block (Q_BM) and kv tile (Q_BN) rows and stages (Q_S). Shared memory sets
// the rows above 128 (kernels/flash_attention.py:_BWD_WGMMA mirrors the
// blocks).
template <int DP>
struct Blocks;
template <>
struct Blocks<64> {
  static constexpr bool PAIR = false;
  static constexpr int KV_BN = 128, KV_BM = 64, KV_S = 4, Q_BM = 128, Q_BN = 64, Q_S = 4;
};
template <>
struct Blocks<128> {
  static constexpr bool PAIR = false;
  static constexpr int KV_BN = 128, KV_BM = 64, KV_S = 4, Q_BM = 128, Q_BN = 64, Q_S = 4;
};
template <>
struct Blocks<256> {
  static constexpr bool PAIR = true;
  static constexpr int KV_BN = 64, KV_BM = 32, KV_S = 4, Q_BM = 128, Q_BN = 32, Q_S = 3;
};
template <>
struct Blocks<320> {
  static constexpr bool PAIR = true;
  static constexpr int KV_BN = 64, KV_BM = 32, KV_S = 3, Q_BM = 128, Q_BN = 16, Q_S = 3;
};

// dK/dV pass: BN kv rows (two consumer warpgroups of 64, or with PAIR both
// on the same 64), q blocks of BM rows in a ring of S stages.
template <int DP>
struct DkvLayout {
  static constexpr bool PAIR = Blocks<DP>::PAIR;
  static constexpr int BN = Blocks<DP>::KV_BN, BM = Blocks<DP>::KV_BM, S = Blocks<DP>::KV_S;
  static constexpr int AHEAD = S - 2, NWG = 2, NBOX = DP / kBox;
  static constexpr int KV_BYTES = BN * DP * 2;  // K or V: NBOX boxes of BN rows x 128 bytes
  static constexpr int Q_BYTES = BM * DP * 2;   // qs or dO of a stage
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int QS_OFF = V_OFF + KV_BYTES;
  static constexpr int DO_OFF = QS_OFF + S * Q_BYTES;
  static constexpr int L_OFF = DO_OFF + S * Q_BYTES;  // lse of a stage's BM rows
  static constexpr int D_OFF = L_OFF + S * BM * 4;    // and their D
  static constexpr int P_OFF = D_OFF + S * BM * 4;    // PAIR: p^T, two BN x BM float32 buffers
  static constexpr int BAR_OFF = P_OFF + (PAIR ? 2 * BN * BM * 4 : 0);
  static constexpr int SMEM = BAR_OFF + kBarBytes + 1024;  // slack to align to 1024
  static constexpr int THREADS = NWG * kWarpgroup;
  static_assert(!PAIR || BN == 64, "a pair's warpgroups share one 64-row kv tile");
  static_assert(SMEM <= kSmemLimit, "the dK/dV pass's shared memory");
};

// the PAIR hand-over of p^T: named barriers of the two warpgroups (256
// threads), one full and one empty for each of the two buffers
constexpr int kPFull = 1, kPEmpty = 3;

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
// the first 16 columns of the second box). Above 256 columns (wgmma's
// widest) the product runs as 256 + the rest, the rest from box 4 on into
// acc + 128, as the forward's O += P V.
template <int K, int N>
__device__ __forceinline__ void product_rs(float* acc, const uint32_t* pk, uint32_t b,
                                           int b_rows) {
  constexpr int N0 = N > 256 ? 256 : N;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    WgmmaRS<N0>::run(acc, &pk[4 * kk],
                     sw128_desc(b + kk * 16 * kRowBytes, b_rows * kRowBytes, 8 * kRowBytes));
    if constexpr (N > 256)
      WgmmaRS<N - 256>::run(acc + N0 / 2, &pk[4 * kk],
                            sw128_desc(b + 4 * b_rows * kRowBytes + kk * 16 * kRowBytes,
                                       b_rows * kRowBytes, 8 * kRowBytes));
  }
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
  constexpr int S = Lt::S;
  constexpr int NO = 16 * NK;  // output columns: D_pad, or 80 at D 80
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;  // swizzle atoms are 1024 bytes
  uint8_t* smem = smem_raw + pad;
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
    for (int i = 0; i < Lt::AHEAD && i < n; ++i) load(i);
  }

  const int t = threadIdx.x - wg * kWarpgroup;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, c4 = lane & 3;
  if constexpr (!Lt::PAIR) {
    // ---- consumers: 64 kv rows per warpgroup, each summing dV and dK ----
    const int j0 = c0 + wg * 64 + warp * 16 + g;  // this lane's kv rows: j0 and j0 + 8
    const uint32_t a_k = s_k + wg * 64 * kRowBytes, a_v = s_v + wg * 64 * kRowBytes;

    float dv_acc[NO / 2], dk_acc[NO / 2];
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
    float s[BM / 2], dp[BM / 2];
    uint32_t pk[BM / 4], dsk[BM / 4];

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      if (loader && i + Lt::AHEAD < n) load(i + Lt::AHEAD);
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
  } else {
    // ---- consumers: the tile's 64 kv rows in both warpgroups; warpgroup 0
    // computes s^T = K qs^T, p^T and dV += p^T dO, warpgroup 1 dp^T = V dO^T,
    // ds^T = p^T (dp^T - D) and dK += ds^T qs, with p^T handed over in
    // float32 through two shared buffers (each thread's 4 BM / 8 values where
    // its namesake in the other warpgroup holds the same elements of dp^T):
    // two D-long products a warpgroup a step
    const int j0 = c0 + warp * 16 + g;  // this lane's kv rows: j0 and j0 + 8
    const uint32_t a_op = wg ? s_v : s_k;

    float acc[NO / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
    float s[BM / 2];    // s^T, then p^T (0); dp^T (1)
    uint32_t pk[BM / 4];  // p^T (0) or ds^T (1) in bf16: the output product's A

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      if (loader && i + Lt::AHEAD < n) load(i + Lt::AHEAD);
      const int st = i % S, ph = (i / S) & 1, qb = qb0 + i;
      const uint32_t sq = base + Lt::QS_OFF + st * Lt::Q_BYTES;
      const uint32_t sdo = base + Lt::DO_OFF + st * Lt::Q_BYTES;
      const float* sL = reinterpret_cast<const float*>(smem + Lt::L_OFF) + st * BM;
      const float* sD = reinterpret_cast<const float*>(smem + Lt::D_OFF) + st * BM;
      float4* pbuf = reinterpret_cast<float4*>(smem + Lt::P_OFF) + (i & 1) * (BN * BM / 4) + t;
      const int q0 = qb * BM;

      mbar_wait(full(st), ph);
      wg_fence();
      product_kmajor<BM, NK>(s, a_op, BN, wg ? sdo : sq, BM);
      wg_commit();
      wg_wait<0>();
      reg_fence<BM / 2>(s);

      // element 4 jj + e is kv row j0 + 8 (e / 2), q column 8 jj + 2 c4 + e % 2
      if (wg == 0) {
        const bool partial = qb < fb0 || qb >= fb1;
#pragma unroll
        for (int jj = 0; jj < BM / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * jj + 2 * c4 + (e & 1);
            float p = expf(s[4 * jj + e] - sL[col]);
            if (partial && !visible(q0 + col, j0 + 8 * (e >> 1), Lq, Lk, causal, window)) p = 0.f;
            s[4 * jj + e] = p;
          }
          pk[2 * jj] = pack_bf16(s[4 * jj], s[4 * jj + 1]);
          pk[2 * jj + 1] = pack_bf16(s[4 * jj + 2], s[4 * jj + 3]);
        }
        if (i >= 2) named_sync(kPEmpty + (i & 1), 2 * kWarpgroup);  // step i - 2 read it
#pragma unroll
        for (int jj = 0; jj < BM / 8; ++jj)
          pbuf[jj * kWarpgroup] =
              make_float4(s[4 * jj], s[4 * jj + 1], s[4 * jj + 2], s[4 * jj + 3]);
        __threadfence_block();
        named_arrive(kPFull + (i & 1), 2 * kWarpgroup);
      } else {
        named_sync(kPFull + (i & 1), 2 * kWarpgroup);
#pragma unroll
        for (int jj = 0; jj < BM / 8; ++jj) {
          const float4 p = pbuf[jj * kWarpgroup];
          const int col = 8 * jj + 2 * c4;
          pk[2 * jj] = pack_bf16(p.x * (s[4 * jj] - sD[col]), p.y * (s[4 * jj + 1] - sD[col + 1]));
          pk[2 * jj + 1] =
              pack_bf16(p.z * (s[4 * jj + 2] - sD[col]), p.w * (s[4 * jj + 3] - sD[col + 1]));
        }
        if (i + 2 < n) named_arrive(kPEmpty + (i & 1), 2 * kWarpgroup);
      }

      reg_fence<NO / 2>(acc);
      wg_fence();
      product_rs<BM, NO>(acc, pk, wg ? sq : sdo, BM);  // dV += p^T dO, or dK += ds^T qs
      wg_commit();
      wg_wait<0>();
      reg_fence<NO / 2>(acc);
      if (lane == 0) mbar_arrive(empty(st));
    }

    float* part = wg ? dk_part : dv_part;
    bf16* o = wg ? dk : dv;
    const Strides os = wg ? dks : dvs;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = j0 + 8 * r;
      if (row >= Lk) continue;
#pragma unroll
      for (int jj = 0; jj < NO / 8; ++jj) {
        const int col = 8 * jj + 2 * c4;
        if (col >= D) continue;
        const float x0 = acc[4 * jj + 2 * r], x1 = acc[4 * jj + 2 * r + 1];
        if (part != nullptr)  // a query head's share; the reduce kernel sums the group
          *reinterpret_cast<float2*>(part +
                                     ((static_cast<long long>(b) * H + h) * Lk + row) * D + col) =
              make_float2(x0, x1);
        else
          *reinterpret_cast<__nv_bfloat162*>(o + b * os.b + hk * os.h + row * os.l + col) =
              __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// dQ pass: BM q rows (two consumer warpgroups of 64), kv tiles of BN rows
// in a ring of S stages filled S - 2 tiles ahead by the first consumer
// thread, as the dK/dV pass's.
template <int DP>
struct DqLayout {
  static constexpr int BM = Blocks<DP>::Q_BM, BN = Blocks<DP>::Q_BN, S = Blocks<DP>::Q_S;
  static constexpr int AHEAD = S - 2, NWG = 2, NBOX = DP / kBox;
  static constexpr int Q_BYTES = BM * DP * 2;   // qs or dO
  static constexpr int KV_BYTES = BN * DP * 2;  // K or V of a stage
  static constexpr int QS_OFF = 0;
  static constexpr int DO_OFF = QS_OFF + Q_BYTES;
  static constexpr int K_OFF = DO_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + S * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + S * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + kBarBytes + 1024;
  static constexpr int THREADS = NWG * kWarpgroup;
  static_assert(SMEM <= kSmemLimit, "the dQ pass's shared memory");
};

// the header's table
static_assert(DkvLayout<64>::SMEM == 101504, "dK/dV 64");
static_assert(DkvLayout<128>::SMEM == 199808, "dK/dV 128");
static_assert(DkvLayout<256>::SMEM == 215168, "dK/dV 256");
static_assert(DkvLayout<320>::SMEM == 223104, "dK/dV 320");
static_assert(DqLayout<64>::SMEM == 99456, "dQ 64");
static_assert(DqLayout<128>::SMEM == 197760, "dQ 128");
static_assert(DqLayout<256>::SMEM == 230528, "dQ 256");
static_assert(DqLayout<320>::SMEM == 226432, "dQ 320");

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
  constexpr int S = Lt::S;
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
    for (int i = 0; i < Lt::AHEAD && i < n; ++i) load(i);
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
    if (loader && i + Lt::AHEAD < n) load(i + Lt::AHEAD);
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
// on the tf32x3 route.
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
// multiple of 16 in [16, 320], H a multiple of Hkv; d_pad is D's bucket (64,
// 128, 256 or 320). route (from kernels/flash_attention.py:bwd_route, with
// d_pad and each pass's q block and kv tile rows): 1 wgmma (bfloat16; delta
// and lse_pad (B, H, lq_pad) with lq_pad the multiple of 128 at or above Lq,
// q_scaled (B, H, Lq, D) contiguous bf16 scratch; q, k, v and dout 16-byte
// aligned in base and strides), 2 tf32x3 (float32; delta (B, H, Lq);
// q_scaled, lse_pad and lq_pad unused); anything else is refused. vec has bit
// 0 for q, 1 for k, 2 for v, 3 for dout and 4 for o where the tensor may be
// read 16 bytes at a time. The plans (device int32, five columns a row) come
// from kv_tile_plan (dQ pass) and q_tile_plan (dK/dV pass) at those blocks.
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
      (dk != nullptr && dkv_plan == nullptr) ||
      d_pad != (D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 320))
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
    if (d_pad == 256) return run_wgmma<256, 16>(a, st);
    return run_wgmma<320, 20>(a, st);
  }
  if (dtype == 0 && route == 2) {
    if (D <= 64) return run_tf32x3<64, 8, false, 32, 8, 64>(a, st);
    if (D <= 128) return run_tf32x3<128, 8, false, 16, 8, 32>(a, st);
    if (D <= 256) return run_tf32x3<256, 8, true, 8, 4, 16>(a, st);
    return run_tf32x3<320, 8, true, 8, 4, 16>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
