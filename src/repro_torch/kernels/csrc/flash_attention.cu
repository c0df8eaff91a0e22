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
// float32 — flash_attention_kernel, on the FMA units: on the tensor cores
// float32 would run as TF32 and break the 2e-5 contract. One block of 256
// threads per (q block of 64 rows, head, batch). The scaled Q block and one
// K or V tile of 64 rows live in shared memory as float32, rows padded to
// D + 1 words so that the 16 rows a warp reads at once fall in 16 banks;
// the probabilities of the tile go through shared memory too. Thread (ty,
// tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3 of the block: it
// computes their scores against columns tx + 16 j (j < 4) and accumulates
// their outputs in columns tx + 16 j (j < D / 16) in registers. Row max and
// row sum are shuffles over the 16 lanes that share a row. Shared memory:
// (128 (D + 1) + 64 * 65) floats, 83 KB at D = 128 and 181 KB at D = 320.
// Q blocks go from the last to the first, so that the causal blocks with
// the most kv blocks start first.

#include <math.h>

#include "sm90.cuh"  // the Hopper helpers, shared with flash_attention_bwd.cu

namespace {

// ---- float32: scalar FMA kernel --------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // rows of the block a thread owns
constexpr int kCols = 4;       // score columns of a tile a thread owns
constexpr int kLdP = kBlockK + 1;
constexpr int kMaxD = 320;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load_tile(float* dst, const float* src, long long sl,
                                          int r0, int n_valid, int D, int ld) {
  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = r0 + r < n_valid ? src[(r0 + r) * sl + d] : 0.f;
  }
}

// NJ >= D / 16: the output columns a thread owns, fixed at compile time so
// that the accumulator stays in registers.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int group,
                       int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs,
                       Strides os, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* s_q = smem;                 // kBlockQ x ld
  float* s_kv = s_q + kBlockQ * ld;  // kBlockK x ld: K, then V
  float* s_p = s_kv + kBlockK * ld;  // kBlockQ x kLdP
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qb * kBlockQ;
  const int nj = D / 16;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  float* op = o + b * os.b + h * os.h;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    s_q[r * ld + d] = row < Lq ? qp[row * qs.l + d] * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // the kv blocks that hold a visible column for some row of this q block
  const int last_row = min(q0 + kBlockQ, Lq) - 1;
  int kb_end = (Lk + kBlockK - 1) / kBlockK;
  if (causal) kb_end = min(kb_end, last_row / kBlockK + 1);
  int kb_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kb_begin = (q0 - window + 1) / kBlockK;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int c0 = kb * kBlockK;
    __syncthreads();  // the previous tile's readers are done (and s_q is written)
    load_tile(s_kv, kp, ks.l, c0, Lk, D, ld);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[kRows], c[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = s_q[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = s_kv[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = c0 + tx + 16 * j;
        bool ok = col < Lk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        s_p[(ty * kRows + i) * kLdP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every score of the tile is read: K can go
    load_tile(s_kv, vp, vs.l, c0, Lk, D, ld);
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = s_p[(ty * kRows + i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float x = s_kv[c * ld + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
        }
      }
    }
  }

  const long long lse_row = (static_cast<long long>(b) * gridDim.y + h) * Lq;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Lq) continue;
    const bool none = m[i] == kNegInf;  // no visible column
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nj) op[row * os.l + tx + 16 * j] = none ? 0.f : acc[i][j] / den;
    if (lse != nullptr && tx == 0) lse[lse_row + row] = none ? INFINITY : m[i] + logf(l[i]);
  }
}

int smem_bytes(int D) {
  return ((kBlockQ + kBlockK) * (D + 1) + kBlockQ * kLdP) * static_cast<int>(sizeof(float));
}

template <int NJ>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int Hkv, int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H / Hkv, Lq, Lk, D, qs,
      ks, vs, os, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
             int H, int Hkv, int Lq, int Lk, int D, Strides qs, Strides ks, Strides vs,
             Strides os, int causal, int window, float scale, cudaStream_t stream) {
  const int nj = D / 16;
  if (nj <= 2)
    return launch<2>(q, k, v, o, lse, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os, causal, window,
                     scale, stream);
  if (nj <= 4)
    return launch<4>(q, k, v, o, lse, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os, causal, window,
                     scale, stream);
  if (nj <= 8)
    return launch<8>(q, k, v, o, lse, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os, causal, window,
                     scale, stream);
  return launch<kMaxD / 16>(q, k, v, o, lse, B, H, Hkv, Lq, Lk, D, qs, ks, vs, os, causal,
                            window, scale, stream);
}


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
// bfloat16 only: plan (device int32, n_plan rows of five: q block, first
// and end kv tile, first and end tile without a mask, in launch order),
// the padded head dim and the q and kv block rows, all from
// kernels/flash_attention.py; the float32 kernel ignores them.
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
    return dispatch(q, k, v, o, static_cast<float*>(lse), B, H, Hkv, Lq, Lk, D, qs, ks, vs,
                    os, causal, window, scale, s);
  if (dtype == 1)
    return tc::dispatch(q, k, v, o, static_cast<float*>(lse), B, H, Hkv, Lq, Lk, D, qs, ks,
                        vs, os, static_cast<const int*>(plan), n_plan, d_pad, block_q,
                        block_k, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
