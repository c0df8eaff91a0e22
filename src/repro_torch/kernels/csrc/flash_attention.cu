// K7 — flash attention (online softmax) for the LM serving path's prefill.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas
// (body _flash_kernel), the TPU kernel on a (batch, head, q-block) grid
// that streams (block_k, D) K/V chunks through VMEM with a running
// (max, denom, acc) carry.
//
// Computes, for q (B, H, Lq, D) and k, v (B, Hkv, Lk, D), head h reading kv
// head h / (H / Hkv):
//   qs  = q * scale, rounded to the input type (scale = 1/sqrt(D), itself
//         rounded to the input type by the caller);
//   s   = qs . k in float32, set to -1e30 where col >= Lk, or (causal)
//         col > row, or (window > 0) col <= row - window;
//   m, l, acc carried over kv blocks: m' = max(m, rowmax s), p = exp(s - m'),
//         alpha = exp(m - m'), l = alpha l + sum p, acc = alpha acc +
//         (p rounded to v's type) . v, all float32;
//   out = acc / max(l, 1e-30), rounded to q's type.
// The mask value is the finite -1e30 of the Pallas body, not -inf: a kv
// block whose columns are all masked for a row gives p = exp(0) = 1 there,
// and the row's first visible block wipes that with alpha = exp(-1e30 - m')
// = 0. Blocks masked for every row of a q block are skipped, which gives the
// same result. A row with no visible column at all (never the case in
// self-attention, where the diagonal is visible; its m stays -1e30) gets 0,
// where the Pallas body would average the values it read.
// With a non-null lse (B, H, Lq, float32, contiguous) both kernels also
// write each row's log-sum-exp, lse = m + log l, for the backward
// (flash_attention_bwd.cu); a row with no visible column gets lse = +inf,
// which makes its p = exp(s - lse) = 0 there. Serving passes null.
//
// What bounds it on the H100: operations, 4 D per visible (row, col) pair.
// Two kernels, chosen by type:
//
// bfloat16 — flash_attention_wgmma, on the tensor cores. bf16 operands with
// a float32 sum are exactly what wgmma computes, so the rounding points
// above hold. One block per (q block, head, batch): NWG consumer warpgroups
// of 64 q rows each and one producer warpgroup. The producer's first thread
// loads the Q block once and then a ring of two K/V stages by TMA (4-D
// tensor maps over (D, L, head, batch) built on the host from the strides
// it is given, 128-byte swizzle, boxes of 64 columns); each stage has its
// own K-full, V-full and empty mbarriers, so Q K^T of a tile starts before
// its V has arrived and the next tile's loads overlap this tile's math.
// Rows past L and head-dim columns past D arrive as TMA's zero fill: the
// padded Q/K columns add 0 to every score and the padded V columns are
// never stored. Each consumer warpgroup scales its 64 Q rows in shared
// memory once (rounded to bf16), fences the async proxy, then per kv tile:
// S = Q K^T by wgmma (A and B from shared memory, both K-major), the mask
// only on the tiles the host's plan marks as partial, the online softmax
// in registers (row max and sum over the 4 lanes that share a row; expf of
// s - m as the plain version takes it), P rounded to bf16 in registers and
// fed back as wgmma's register A operand, O += P V with V as the MN-major B
// operand (split over N in pieces of at most 256 columns). With two
// consumer warpgroups setmaxnreg gives them 232 registers and the producer
// 40; built that way D_pad 256 spilled (ptxas -v), so 256 and 320 run one
// consumer warpgroup (up to 255 registers). The head dim is padded to D_pad
// in {64, 128, 192, 256, 320}:
//   D_pad   q block   kv tile   shared memory
//   64      128       128       80 KB
//   128     128       128       160 KB
//   192     128       64        144 KB
//   256     64        64        160 KB (one consumer warpgroup)
//   320     64        64        200 KB (one consumer warpgroup)
// The host (kernels/flash_attention.py) chooses D_pad and the blocks, and
// hands over the plan: for each q block, in launch order (longest first),
// its first and last kv tile and the tiles that need no mask. TMA needs
// 16-byte aligned bases and strides; the host checks them and the entry
// point refuses anything else.
//
// float32 — flash_attention_tf32x3, on the tensor cores as three TF32
// products (tf32x3.cuh: x = hi + lo, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi
// on mma.sync m16n8k8, about 2^-22 of |a b| from the float32 product). Its
// bound is 12 D TF32 operations a visible pair at 495 TFLOP/s, 2.5x the 4 D
// at the 67 TFLOP/s of the FMA units that a float32 kernel had before.
// One block per (q block, head, batch) of the host's plan, in its launch
// order (longest q blocks first); NW warps of 16 q rows each. The block
// holds q * scale (float32) in shared memory, read by each warp for its own
// rows and split on read once a k-step for all of the tile's columns. K and
// V tiles, in turn, arrive by cp.async (16 bytes a copy where the tensor's
// base and strides allow, else 4) into a landing tile; once landed, a tile
// is split into a hi and a lo working tile, which every warp reads, and the
// next tile's copy lands while this one is used (a ring of two stages: the
// raw one and the split one). A warp that issues one n-tile's products
// after another waits on each of them, so each warp issues the three
// products of 4 n-tiles interleaved (`mma3_group`: the training-shape
// forward 3.12 -> 1.96 ms, tools/k7_passes.py); a block has 8
// warps (two blocks of 4 at bucket 128 took 2.44-2.57 ms at qwen2.5's
// float32 prefill and training shapes against 1.99-2.05 for one of 8,
// tools/k7_passes.py). Per kv tile: S = Q K^T (the mask only on the tiles the plan
// marks partial), the online softmax in registers as the bf16 kernel's
// (expf of s - m as the plain version takes it), then O += P V with P fed
// from the S accumulator as the A operand, split in registers, and V's rows
// 2t and 2t + 1 of each k-step read from the hi and lo tiles. Rows of
// (bucket + 4) words put every fragment load in 32 banks. What bounds it:
// the tensor pipe's issue (three mma.sync a product), and the shared-memory
// reads of the B fragments (4 words a lane for 3 products) beside it. The
// head dim runs in buckets (D a multiple of 16 up to the bucket):
//   bucket   warps   q block   kv tile   shared memory
//   64       8       128       64        87,040 B
//   128      8       128       64        168,960 B
//   256      8       128       24        208,000 B
//   320      8       128       16        228,096 B
// (q block + 3 kv tiles) x (bucket + 4) words; kernels/flash_attention.py
// (`f32_blocks`, `tf32x3_smem`) mirrors the table.

#include <math.h>

#include "sm90.cuh"    // the Hopper helpers, shared with flash_attention_bwd.cu
#include "tf32x3.cuh"  // float32 as three TF32 products, shared likewise

namespace {

constexpr int kMaxD = 320;
constexpr float kNegInf = -1e30f;

// ---- float32: three TF32 products on mma.sync ---------------------------------

namespace x3 {

// bucket -> kv tile rows (8 warps of 16 q rows each)
template <int DM>
struct FwdShape;
template <>
struct FwdShape<64> { static constexpr int BN = 64; };
template <>
struct FwdShape<128> { static constexpr int BN = 64; };
template <>
struct FwdShape<256> { static constexpr int BN = 24; };
template <>
struct FwdShape<320> { static constexpr int BN = 16; };

template <int DM>
struct FwdLayout {
  static constexpr int NW = 8, BN = FwdShape<DM>::BN, BM = 16 * NW;
  static constexpr int LD = Row<DM>::LD, THREADS = 32 * NW;
  static constexpr int TILE = BN * LD;  // floats of a kv tile
  // the scaled Q block, then the landing tile and the hi and lo tiles
  static constexpr int SMEM = (BM * LD + 3 * TILE) * 4;
  static_assert(BN % 8 == 0, "8-column n-tiles");
};

template <int DM>
__global__ void __launch_bounds__(FwdLayout<DM>::THREADS, 1)
flash_attention_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, Strides qs, Strides ks, Strides vs, Strides os,
                       const int* __restrict__ plan, int group, int Lq, int Lk, int D,
                       int causal, int window, float scale, int vec) {
  using Lt = FwdLayout<DM>;
  constexpr int BN = Lt::BN, BM = Lt::BM, LD = Lt::LD, THREADS = Lt::THREADS, NT = BN / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* raw = sQ + BM * LD;
  float* hi = raw + Lt::TILE;
  float* lo = hi + Lt::TILE;

  // plan row: q block, first and end kv tile, first and end tile without a mask
  const int* pr = plan + 5 * blockIdx.z;
  const int qb = pr[0], kb0 = pr[1], kb1 = pr[2], fb0 = pr[3], fb1 = pr[4];
  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int q0 = qb * BM;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;

  // item i: K (i even) or V (i odd) of kv tile kb0 + i / 2
  const int n_items = 2 * (kb1 - kb0);
  auto issue = [&](int i) {
    if (i < n_items) {
      const bool is_v = i & 1;
      copy_tile<BN, THREADS>(raw, LD, is_v ? vp : kp, is_v ? vs.l : ks.l, (kb0 + i / 2) * BN,
                             Lk, D, vec & (is_v ? 4 : 2));
    }
    cp_commit();
  };
  issue(0);
  load_scaled<BM, THREADS>(sQ, LD, q + b * qs.b + h * qs.h, qs.l, q0, Lq, D, vec & 1, scale);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0 and row0 + 8
  float acc[DM / 8][4], s[NT][4];
  zero(acc);
  zero(s);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's partial sums
  const float* qa = sQ + (warp * 16 + g) * LD + t;

  const uint32_t* bh = reinterpret_cast<const uint32_t*>(hi);
  const uint32_t* bl = reinterpret_cast<const uint32_t*>(lo);
  for (int i = 0; i < n_items; ++i) {
    cp_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1's hi and lo
    split_tile<BN, THREADS>(raw, hi, lo, LD, D, 1.f);
    __syncthreads();  // the landing tile is free: item i + 1 lands while item i is used
    issue(i + 1);
    const int kb = kb0 + i / 2;

    if ((i & 1) == 0) {
      // S = (q scale) K^T, Q split on read once a k-step for all NT n-tiles
      zero(s);
      mma3_kdim<NT>(s, qa, LD, bh, bl, g * LD + t, LD, D);
      if (kb < fb0 || kb >= fb1) {  // a partial tile: mask it
        const int c0 = kb * BN;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + (e >> 1) * 8;
            const int col = c0 + 8 * j + 2 * t + (e & 1);
            bool ok = col < Lk;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && col > row - window;
            if (!ok) s[j][e] = kNegInf;
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = expf(m[r] - mx);
        m[r] = mx;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
      for (int n = 0; n < DM / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    } else {
      // O += P V: P from the S accumulator (split in registers), V's rows 2t
      // and 2t + 1 of each 8-row k-step
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        uint32_t ah[4], al[4];
        a_from_acc(ah, al, s[jj]);
        mma3_rows<DM>(acc, ah, al, bh, bl, (8 * jj + 2 * t) * LD + g, LD, D);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* op = o + b * os.b + h * os.h;
  const long long lse_row = (static_cast<long long>(b) * gridDim.x + h) * Lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const bool none = m[r] == kNegInf;  // no visible column
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = op + row * os.l;
#pragma unroll
    for (int n = 0; n < DM / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D) {
        orow[col] = none ? 0.f : acc[n][2 * r] / den;
        orow[col + 1] = none ? 0.f : acc[n][2 * r + 1] / den;
      }
    }
    if (lse != nullptr && t == 0) lse[lse_row + row] = none ? INFINITY : m[r] + logf(l[r]);
  }
}

template <int DM>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int Hkv, int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs, Strides os,
           const int* plan, int n_plan, int block_q, int block_k, int causal, int window,
           float scale, cudaStream_t stream) {
  using Lt = FwdLayout<DM>;
  if (block_q != Lt::BM || block_k != Lt::BN || n_plan != (Lq + Lt::BM - 1) / Lt::BM ||
      n_plan > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static uint64_t smem_set = 0;  // devices this instantiation was set up on
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 64 || !(smem_set >> device & 1)) {
    e = cudaFuncSetAttribute(flash_attention_tf32x3<DM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Lt::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 64) smem_set |= 1ull << device;
  }
  const int vec = aligned16(q, qs) | aligned16(k, ks) << 1 | aligned16(v, vs) << 2;
  const dim3 grid(H, B, n_plan);  // every head's longest q blocks first
  flash_attention_tf32x3<DM><<<grid, Lt::THREADS, Lt::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, qs, ks, vs, os, plan, H / Hkv, Lq, Lk, D, causal, window,
      scale, vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int Hkv, int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs, Strides os,
             const int* plan, int n_plan, int d_pad, int block_q, int block_k, int causal,
             int window, float scale, cudaStream_t stream) {
  const int bucket = D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 320;
  if (plan == nullptr || d_pad != bucket || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define NEBULA_FA_X3(DM)                                                                      \
  if (d_pad == DM)                                                                            \
    return launch<DM>(q, k, v, o, lse, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os, plan, n_plan,     \
                      block_q, block_k, causal, window, scale, stream);
  NEBULA_FA_X3(64)
  NEBULA_FA_X3(128)
  NEBULA_FA_X3(256)
  NEBULA_FA_X3(320)
#undef NEBULA_FA_X3
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace x3


// ---- bfloat16: wgmma + TMA kernel ------------------------------------------

namespace tc {

constexpr int kStages = 2;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// D_pad -> kv tile rows and consumer warpgroups (64 q rows each)
template <int DP>
struct Shape;
template <>
struct Shape<64> { static constexpr int BN = 128, NWG = 2; };
template <>
struct Shape<128> { static constexpr int BN = 128, NWG = 2; };
template <>
struct Shape<192> { static constexpr int BN = 64, NWG = 2; };
template <>
struct Shape<256> { static constexpr int BN = 64, NWG = 1; };
template <>
struct Shape<320> { static constexpr int BN = 64, NWG = 1; };

template <int DP>
struct Layout {
  static constexpr int BN = Shape<DP>::BN, NWG = Shape<DP>::NWG, BM = 64 * NWG;
  static constexpr int NBOX = DP / kBox;
  static constexpr int Q_BYTES = BM * DP * 2;   // NBOX boxes of BM rows x 128 bytes
  static constexpr int KV_BYTES = BN * DP * 2;  // NBOX boxes of BN rows x 128 bytes
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;  // barriers; slack to align to 1024
  static constexpr int THREADS = kWarpgroup * (NWG + 1);
};

template <int DP>
__global__ void __launch_bounds__(Layout<DP>::THREADS, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, Strides os, const int* __restrict__ plan,
                      int group, int Lq, int Lk,
                      int D, int causal, int window, float scale) {
  using Lt = Layout<DP>;
  constexpr int BN = Lt::BN, BM = Lt::BM, NWG = Lt::NWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;  // swizzle atoms are 1024 bytes
  uint8_t* smem = smem_raw + pad;
  const uint32_t s_q = raw + pad + Lt::Q_OFF;
  const uint32_t s_k = raw + pad + Lt::K_OFF;
  const uint32_t s_v = raw + pad + Lt::V_OFF;
  const uint32_t bar = raw + pad + Lt::BAR_OFF;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 + 8 * s; };
  auto v_full = [&](int s) { return bar + 8 + 8 * kStages + 8 * s; };
  auto empty = [&](int s) { return bar + 8 + 16 * kStages + 8 * s; };

  // plan row: q block, first and end kv tile, first and end tile without a mask
  const int* pr = plan + 5 * blockIdx.z;
  const int qb = pr[0], kb0 = pr[1], kb1 = pr[2], fb0 = pr[3], fb1 = pr[4];
  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int q0 = qb * BM;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread issues every load ----
    if constexpr (NWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == NWG * kWarpgroup) {
      mbar_expect_tx(q_full, Lt::Q_BYTES);
      for (int c = 0; c < Lt::NBOX; ++c)
        tma_load(s_q + c * BM * kRowBytes, &tq, q_full, c * kBox, q0, h, b);
      for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), (i / kStages - 1) & 1);
        mbar_expect_tx(k_full(s), Lt::KV_BYTES);
        for (int c = 0; c < Lt::NBOX; ++c)
          tma_load(s_k + s * Lt::KV_BYTES + c * BN * kRowBytes, &tk, k_full(s), c * kBox,
                   kb * BN, hk, b);
        mbar_expect_tx(v_full(s), Lt::KV_BYTES);
        for (int c = 0; c < Lt::NBOX; ++c)
          tma_load(s_v + s * Lt::KV_BYTES + c * BN * kRowBytes, &tv, v_full(s), c * kBox,
                   kb * BN, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ----
    if constexpr (NWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x - wg * kWarpgroup;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, c4 = lane & 3;
    const int row0 = q0 + wg * 64 + warp * 16 + g;  // and row0 + 8

    // q * scale, rounded to bf16, in place: this warpgroup's 64 rows of every box
    mbar_wait(q_full, 0);
#pragma unroll
    for (int c = 0; c < Lt::NBOX; ++c) {
      uint4* p = reinterpret_cast<uint4*>(smem + Lt::Q_OFF + (c * BM + wg * 64) * kRowBytes);
#pragma unroll
      for (int i = t; i < 64 * kRowBytes / 16; i += kWarpgroup) {
        uint4 u = p[i];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
        p[i] = u;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(kWarpgroup) : "memory");

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's partial sums
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    uint32_t pk[BN / 4];

    for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i) {
      const int st = i % kStages, ph = (i / kStages) & 1;
      const uint32_t ks = s_k + st * Lt::KV_BYTES, vs = s_v + st * Lt::KV_BYTES;

      mbar_wait(k_full(st), ph);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        const uint32_t within = (kc % 4) * 32;  // 16 columns = 32 bytes into the box
        const uint64_t da =
            sw128_desc(s_q + ((kc / 4) * BM + wg * 64) * kRowBytes + within, 16,
                       8 * kRowBytes);
        const uint64_t db = sw128_desc(ks + (kc / 4) * BN * kRowBytes + within, 16,
                                       8 * kRowBytes);
        WgmmaSS<BN>::run(s, da, db, kc > 0);
      }
      wg_commit();
      wg_wait_all();
      reg_fence<BN / 2>(s);

      if (kb < fb0 || kb >= fb1) {  // a partial tile: mask it
        const int c0 = kb * BN;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + (e >> 1) * 8;
            const int col = c0 + 8 * j + 2 * c4 + (e & 1);
            bool ok = col < Lk;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && col > row - window;
            if (!ok) s[4 * j + e] = kNegInf;
          }
      }

      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = expf(m[r] - mx);
        m[r] = mx;
      }
      // exp(s - m), as the plain version computes it (not exp2 of a
      // rescaled difference: p is rounded to bf16 next, and every extra
      // rounding here moves some p across a bf16 rounding boundary)
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = expf(s[4 * j + 0] - m[0]);
        const float p1 = expf(s[4 * j + 1] - m[0]);
        const float p2 = expf(s[4 * j + 2] - m[1]);
        const float p3 = expf(s[4 * j + 3] - m[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pk[2 * j] = pack_bf16(p0, p1);
        pk[2 * j + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }

      mbar_wait(v_full(st), ph);
      reg_fence<DP / 2>(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        // rows 16 kk .. 16 kk + 15 of V: two 8-row groups of 1024 bytes;
        // the next 64 columns are the next box (leading byte offset)
        const uint32_t rows = kk * 16 * kRowBytes;
        constexpr int N0 = DP > 256 ? 256 : DP;
        WgmmaRS<N0>::run(acc, &pk[4 * kk],
                         sw128_desc(vs + rows, BN * kRowBytes, 8 * kRowBytes));
        if constexpr (DP > 256)
          WgmmaRS<DP - 256>::run(acc + 128, &pk[4 * kk],
                                 sw128_desc(vs + 4 * BN * kRowBytes + rows, BN * kRowBytes,
                                            8 * kRowBytes));
      }
      wg_commit();
      wg_wait_all();
      reg_fence<DP / 2>(acc);
      if (lane == 0) mbar_arrive(empty(st));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __nv_bfloat16* op = o + b * os.b + h * os.h;
    const long long lse_row = (static_cast<long long>(b) * gridDim.x + h) * Lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Lq) continue;
      const bool none = m[r] == kNegInf;  // no visible column
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = op + row * os.l;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * c4;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              none ? __floats2bfloat162_rn(0.f, 0.f)
                   : __floats2bfloat162_rn(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
      }
      if (lse != nullptr && c4 == 0) lse[lse_row + row] = none ? INFINITY : m[r] + logf(l[r]);
    }
  }
}


template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int Hkv,
           int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs, Strides os,
           const int* plan, int n_plan, int block_q, int block_k, int causal, int window,
           float scale, cudaStream_t stream) {
  using Lt = Layout<DP>;
  if (block_q != Lt::BM || block_k != Lt::BN || n_plan != (Lq + Lt::BM - 1) / Lt::BM ||
      n_plan > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, D, Lq, H, B, qs, Lt::BM) || !encode(&mk, k, D, Lk, Hkv, B, ks, Lt::BN) ||
      !encode(&mv, v, D, Lk, Hkv, B, vs, Lt::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  static uint64_t smem_set = 0;  // devices this instantiation was set up on
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 64 || !(smem_set >> device & 1)) {
    e = cudaFuncSetAttribute(flash_attention_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Lt::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 64) smem_set |= 1ull << device;
  }
  const dim3 grid(H, B, n_plan);  // every head's longest q blocks first
  flash_attention_wgmma<DP><<<grid, Lt::THREADS, Lt::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, os, plan, H / Hkv, Lq, Lk, D, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int Hkv, int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs, Strides os,
             const int* plan, int n_plan, int d_pad, int block_q, int block_k, int causal,
             int window, float scale, cudaStream_t stream) {
  if (!tma_ready(q, qs) || !tma_ready(k, ks) || !tma_ready(v, vs) ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0 || os.l % 2 != 0 || os.h % 2 != 0 ||
      os.b % 2 != 0 || plan == nullptr || d_pad < D || d_pad - D >= 64 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define NEBULA_FA_TC(DP)                                                                      \
  if (d_pad == DP)                                                                            \
    return launch<DP>(q, k, v, o, lse, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os, plan, n_plan,     \
                      block_q, block_k, causal, window, scale, stream);
  NEBULA_FA_TC(64)
  NEBULA_FA_TC(128)
  NEBULA_FA_TC(192)
  NEBULA_FA_TC(256)
  NEBULA_FA_TC(320)
#undef NEBULA_FA_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike). lse: null, or (B, H,
// Lq) float32, contiguous, for each row's log-sum-exp. Strides in elements,
// (batch, head, row) for each tensor; the head-dim axis is contiguous.
// D must be a multiple of 16 in [16, 320], and H a multiple of Hkv.
// plan (device int32, n_plan rows of five: q block, first and end kv tile,
// first and end tile without a mask, in launch order), the padded head dim
// (bf16) or head-dim bucket (float32) and the q and kv block rows, all from
// kernels/flash_attention.py.
extern "C" int nebula_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, int dtype, int B, int H,
    int Hkv, int Lq, int Lk, int D, long long qsb, long long qsh, long long qsl,
    long long ksb, long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, long long osb, long long osh, long long osl, int causal,
    int window, float scale, const void* plan, int n_plan, int d_pad, int block_q,
    int block_k, void* stream) {
  if (D < 16 || D > kMaxD || D % 16 != 0 || B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      Lq < 1 || Lk < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl}, os{osb, osh, osl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return x3::dispatch(q, k, v, o, static_cast<float*>(lse), B, H, Hkv, Lq, Lk, D, qs, ks, vs,
                        os, static_cast<const int*>(plan), n_plan, d_pad, block_q, block_k,
                        causal, window, scale, s);
  if (dtype == 1)
    return tc::dispatch(q, k, v, o, static_cast<float*>(lse), B, H, Hkv, Lq, Lk, D, qs, ks,
                        vs, os, static_cast<const int*>(plan), n_plan, d_pad, block_q,
                        block_k, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
