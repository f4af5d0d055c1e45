// Flash-attention forward for Hopper (sm_90a): causal / local-window GQA
// attention with an online softmax.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py
//   _flash_kernel / flash_attention_bhsd (pl.pallas_call), wrapper
//   src/repro/kernels/flash_attention/ops.py flash_attention.
// It computes what _flash_kernel computes, not block for block: one thread
// block per (b*h, q-tile) with a loop over kv tiles inside the block (the
// loop replaces the TPU's sequential "arbitrary" grid axis); m, l and the
// accumulator are f32; kv tiles fully masked by causality or the window
// are never visited; the output is acc / max(l, 1e-20). Unlike the Pallas
// kernel, the ragged edge is masked here, so Sq and Sk need not be
// multiples of the tile.
//
// What bounds it on this card: at prefill lengths the work is
// 4*Hq*D*(unmasked q-k pairs) operations over (|q|+|k|+|v|+|o|) bytes,
// which at S >= ~200, D = 128 is far above the H100's ~295 bf16
// operations per byte, so the bound is the tensor-core rate.
//
// Two paths, split by dtype; neither falls back to the other.
//
// bf16 (the serve dtype): flash_fwd_tc, FlashAttention-2 on the tensor
// cores. 4 warps, one block per (b*h, 64 q rows), each warp owns 16 q
// rows. Q is staged in shared memory once (and, at D <= 128, held as
// ldmatrix A fragments in registers); K and V tiles come through a
// two-stage cp.async ring, so the next tile's copy overlaps this tile's
// products. S = Q K^T is mma.sync m16n8k16 with K as the .col B operand
// (ldmatrix), f32 accumulators; the scale is folded with log2(e) into
// exp2f on S; the online softmax runs on the accumulator fragments in
// registers (a row lives on the 4 lanes of a quad: shuffles with xor 1 and
// 2, no shared score tile, no barrier between softmax and P V). P is
// rounded to bf16 and repacked from the C layout of S straight into the A
// layout of the P V product (the C tiles 2j and 2j+1 are the A fragment of
// k-step j); V is the B operand through ldmatrix.trans. Rows of shared
// tiles are padded by 16 bytes, so the 8 row addresses of an ldmatrix hit
// 8 distinct 16-byte bank groups. Masking is applied only in tiles that
// need it (per warp); a row fully masked so far keeps m = -inf and uses 0
// as its exponent base, so exp(-inf - -inf) never occurs. Blocks start
// in order of decreasing work: the last q tile of every head first, then
// the one before (the longest causal rows start first; in head-major
// order qwen2-7b's 28 heads left the last long rows to a second wave).
// D = 256 (recurrentgemma-9b): the 16 x 256 f32 O accumulator is 128
// registers a thread, so Q is re-read from shared memory by ldmatrix at
// each kv tile instead of held (165 KB of shared memory: one block an SM).
// The kernel addresses rows through strides (struct Layout), so it reads
// the model's (B, S, H, D) tensors and writes its output in place
// (repro_flash_attention_fwd_bshd): no transposed copies around the call.
//
// f32: flash_fwd, the FMA kernel of the first port, kept for the f32
// oracle phases (their 2e-5 tolerance needs full-f32 products; tensor
// cores would mean TF32). Tiles are staged in shared memory with padded
// rows, each thread keeps a score tile and an output tile in registers,
// K and V share one buffer, whole masked tiles are skipped. Its tiles
// (struct Tiles): D <= 128 64 x 64, 128 threads, two blocks per SM; D =
// 256 32 x 32, each thread a 2 x 4 score tile and an 8 x 8 output tile,
// three blocks per SM.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/flash_attention/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

// ---- f32: FMA kernel (only float instantiates it) ----

// BQ q rows per block, BK kv rows per tile, NT threads; a thread owns
// BQ / (NT / SC_T) score rows x BK / SC_T columns (SC_T threads across a
// score row) and BQ / (NT / OC_T) output rows x D / OC_T columns; MINB
// blocks per SM fit the shared memory.
template <int D>
struct Tiles {
  static constexpr int BQ = 64, BK = 64, NT = 128, SC_T = 8, OC_T = 16,
                       MINB = 2;
};
template <>
struct Tiles<256> {
  static constexpr int BQ = 32, BK = 32, NT = 128, SC_T = 8, OC_T = 32,
                       MINB = 3;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Copy rows [row0, row0 + BK) of a (rows, D) matrix into a padded f32 tile;
// rows past n_rows read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int n_rows, float mul) {
  constexpr int BK = Tiles<D>::BK, NT = Tiles<D>::NT;
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < BK * D; i += NT) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (row0 + r < n_rows) x = to_f32(src[(size_t)(row0 + r) * D + c]) * mul;
    dst[r * DP + c] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::NT, Tiles<D>::MINB)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int group, int Sq,
          int Sk, int causal, int window, float scale) {
  using Tl = Tiles<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, NT = Tl::NT;
  static_assert(BQ == BK, "Q and KV tiles share the loader");
  static_assert(D % 16 == 0 && (D <= 128 || D == 256), "head_dim");
  constexpr int DP = D + 1;   // padded row stride of the Q and KV tiles
  constexpr int SP = BK + 1;  // padded row stride of the score tile
  constexpr int SR = BQ / (NT / Tl::SC_T);  // score rows per thread
  constexpr int SC = BK / Tl::SC_T;         // score columns per thread
  constexpr int OR = BQ / (NT / Tl::OC_T);  // output rows per thread
  constexpr int CPT = D / Tl::OC_T;         // output columns per thread
  constexpr int TPR = NT / BQ;              // softmax threads per row
  static_assert(SR * SC * NT == BQ * BK && OR * CPT * NT == BQ * D &&
                TPR * BQ == NT && (TPR & (TPR - 1)) == 0, "tiling");

  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x DP, pre-scaled
  float* KVs = Qs + BQ * DP;     // BK x DP: K, then V of the same tile
  float* Ss = KVs + BK * DP;     // BQ x SP: scores, then probabilities
  float* m_s = Ss + BQ * SP;     // running row max
  float* l_s = m_s + BQ;         // running row sum
  float* c_s = l_s + BQ;         // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t kv_row = (size_t)(bh / group);
  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + kv_row * Sk * D;
  const T* vp = v + kv_row * Sk * D;
  T* op = o + (size_t)bh * Sq * D;

  load_tile<T, D>(Qs, qp, q0, Sq, scale);
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // score ownership: rows r1 .. r1 + SR - 1, columns c1 + SC_T j
  const int r1 = (tid / Tl::SC_T) * SR, c1 = tid % Tl::SC_T;
  // output ownership: rows r3 .. r3 + OR - 1, columns c3 + OC_T j
  const int r3 = (tid / Tl::OC_T) * OR, c3 = tid % Tl::OC_T;
  float acc[OR][CPT];
#pragma unroll
  for (int i = 0; i < OR; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // kv range any row of this q-tile can see
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_first / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's P @ V is done with KVs and Ss
    load_tile<T, D>(KVs, kp, k0, Sk, 1.f);
    __syncthreads();

    // S = (q * scale) K^T on this tile, masked
    float s[SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[SR], kb[SC];
#pragma unroll
      for (int i = 0; i < SR; ++i) qa[i] = Qs[(r1 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < SC; ++j) kb[j] = KVs[(c1 + Tl::SC_T * j) * DP + d];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int qpos = q0 + r1 + i;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kpos = k0 + c1 + Tl::SC_T * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        Ss[(r1 + i) * SP + c1 + Tl::SC_T * j] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();  // K is no longer read: V may replace it

    load_tile<T, D>(KVs, vp, k0, Sk, 1.f);

    // online softmax, TPR threads per row
    {
      const int r = tid / TPR, h = tid % TPR;
      float* srow = Ss + r * SP;
      float mx = -INFINITY;
      for (int j = h; j < BK; j += TPR) mx = fmaxf(mx, srow[j]);
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = h; j < BK; j += TPR) {
        const float sv = srow[j];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
        srow[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (h == 0) {
        const float corr = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < OR; ++i) {
      const float corr = c_s[r3 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[OR], vv[CPT];
#pragma unroll
      for (int i = 0; i < OR; ++i) pv[i] = Ss[(r3 + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = KVs[kk * DP + c3 + Tl::OC_T * j];
#pragma unroll
      for (int i = 0; i < OR; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // l_s is final (also when no tile was visited)

#pragma unroll
  for (int i = 0; i < OR; ++i) {
    const int row = q0 + r3 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_s[r3 + i], 1e-20f);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      store(op + (size_t)row * D + c3 + Tl::OC_T * j, acc[i][j] / denom);
  }
}

template <int D>
constexpr size_t fma_smem_bytes() {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  return sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bhq, int group, int sq, int sk, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::BQ, NT = Tiles<D>::NT;
  const size_t smem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bhq);
  flash_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, sq, sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int bhq, int group, int sq, int sk,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, bhq, group, sq, sk, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, bhq, group, sq, sk, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bhq, group, sq, sk, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bhq, group, sq, sk, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, bhq, group, sq, sk, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16: tensor-core kernel ----

// 4 warps a block, each owning 16 q rows (64 a block); 64 kv rows a tile;
// two blocks an SM. Registers a thread: O D/2, S 32, Q D/4 where it is held
// as A fragments for the whole kv loop (D <= 128); at D = 256 (O alone is
// 128 registers) Q is re-read from shared memory by ldmatrix at each tile.
// scripts/torch_tile_sweep.py times the alternatives.
constexpr int TC_NT = 128, TC_BQ = 64, TC_BK = 64, TC_MINB = 2;
template <int D>
__host__ __device__ constexpr bool tc_q_regs() {
  return D <= 128;
}

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q, then two stages of K and two of V; rows padded by 8 bf16
  return sizeof(__nv_bfloat16) * (D + 8) * (TC_BQ + 4 * TC_BK);
}

// Where the rows of one (batch, head) lie, in elements: the offset of a
// batch, of a head, and between rows (a row's D values are contiguous). q
// and o share theirs, k and v theirs. (B*H, S, D) and the model's (B, S,
// H, D) are both read in place.
struct Layout {
  long long q_b, q_h, q_s, kv_b, kv_h, kv_s;
};

// cp.async rows [row0, row0 + ROWS) of a matrix of n_rows rows, ``stride``
// elements apart, into a tile with row stride D + 8; rows past n_rows are
// zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void tc_load_rows(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             long long stride, int row0,
                                             int n_rows) {
  constexpr int CH = D / 8;  // 16-byte chunks in a row
  for (int i = threadIdx.x; i < ROWS * CH; i += TC_NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < n_rows;
    tc::cp_async16(dst + r * (D + 8) + c,
                   src + (ok ? row0 + r : 0) * stride + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT, TC_MINB)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o, Layout lay, int hq, int group,
             int Sq, int Sk, int causal, int window, float scale_log2) {
  constexpr int BQ = TC_BQ, BK = TC_BK, RS = D + 8;
  constexpr bool Q_REGS = tc_q_regs<D>();
  constexpr int KS = D / 16;   // k-steps of S = Q K^T
  constexpr int NS = BK / 8;   // n8 tiles of S
  constexpr int NO = D / 8;    // n8 tiles of O
  static_assert(D % 16 == 0 && BQ == 16 * (TC_NT / 32), "tiling");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * RS;      // 2 stages of BK x RS
  __nv_bfloat16* Vs = Ks + 2 * BK * RS;  // 2 stages of BK x RS

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // grid (b * hq, q tiles), q tiles from the last: blocks start in order
  // of decreasing causal work, whatever the number of heads
  const int b = blockIdx.x / hq, h = blockIdx.x % hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long q_off = b * lay.q_b + h * lay.q_h;
  const long long kv_off = b * lay.kv_b + (h / group) * lay.kv_h;
  const __nv_bfloat16* qp = q + q_off;
  const __nv_bfloat16* kp = k + kv_off;
  const __nv_bfloat16* vp = v + kv_off;
  __nv_bfloat16* op = o + q_off;

  // kv range any row of this q-tile can see, in tiles
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_first / BK, t_end = (k_end + BK - 1) / BK;

  tc_load_rows<BQ, D>(Qs, qp, lay.q_s, q0, Sq);
  if (t_first < t_end) {
    tc_load_rows<BK, D>(Ks, kp, lay.kv_s, t_first * BK, Sk);
    tc_load_rows<BK, D>(Vs, vp, lay.kv_s, t_first * BK, Sk);
  }
  tc::cp_async_commit();

  // this warp's rows: row[0] = r_lo + g (c0, c1), row[1] = r_lo + g + 8
  // (c2, c3)
  const int r_lo = q0 + 16 * warp;
  const int row[2] = {r_lo + g, r_lo + g + 8};
  // ldmatrix row addresses of this lane (see tc_bf16.cuh)
  const __nv_bfloat16* q_lane = Qs + (16 * warp + (lane & 15)) * RS +
                                (lane >> 4) * 8;
  const int k_lane =
      ((lane >> 4) * 8 + (lane & 7)) * RS + ((lane >> 3) & 1) * 8;
  const int v_lane =
      (((lane >> 3) & 1) * 8 + (lane & 7)) * RS + (lane >> 4) * 8;

  uint32_t qf[Q_REGS ? KS : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  // per row: running max (unscaled) and this lane's share of the sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int tile = t_first; tile < t_end; ++tile) {
    const int st = (tile - t_first) & 1;
    if (tile + 1 < t_end) {  // next tile's K and V into the other stage
      tc_load_rows<BK, D>(Ks + (st ^ 1) * BK * RS, kp, lay.kv_s,
                          (tile + 1) * BK, Sk);
      tc_load_rows<BK, D>(Vs + (st ^ 1) * BK * RS, vp, lay.kv_s,
                          (tile + 1) * BK, Sk);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Q_REGS) {
      if (tile == t_first) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) tc::ldsm_x4(qf[kk], q_lane + kk * 16);
      }
    }
    const __nv_bfloat16* Kt = Ks + st * BK * RS;
    const __nv_bfloat16* Vt = Vs + st * BK * RS;
    const int k0 = tile * BK;

    // S = Q K^T
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (Q_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i];
      } else {
        tc::ldsm_x4(qa, q_lane + kk * 16);
      }
      uint32_t kb[NS / 2][4];  // this k-step's fragments first
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp)
        tc::ldsm_x4(kb[jp], Kt + jp * 16 * RS + k_lane + kk * 16);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        tc::mma(s[2 * jp], qa, kb[jp][0], kb[jp][1]);
        tc::mma(s[2 * jp + 1], qa, kb[jp][2], kb[jp][3]);
      }
    }

    // mask, where some pair of this warp's rows and this tile needs it
    const bool need_mask = k0 + BK > Sk || (causal && k0 + BK - 1 > r_lo) ||
                           (window > 0 && k0 <= r_lo + 15 - window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + 8 * j + 2 * t + (i & 1);
          const int r = row[i >> 1];
          const bool ok = col < Sk && (!causal || col <= r) &&
                          (window <= 0 || col > r - window);
          if (!ok) s[j][i] = -INFINITY;
        }
    }

    // online softmax on the fragments: row hf holds c[2 hf], c[2 hf + 1]
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m[hf];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // exponent base; 0 while the row has seen no unmasked column
      const float base = mx == -INFINITY ? 0.f : mx * scale_log2;
      const float corr = exp2f(m[hf] * scale_log2 - base);
      m[hf] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 2 * hf; c < 2 * hf + 2; ++c) {
          s[j][c] = exp2f(fmaf(s[j][c], scale_log2, -base));
          sum += s[j][c];
        }
      l[hf] = l[hf] * corr + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * hf] *= corr;
        acc[j][2 * hf + 1] *= corr;
      }
    }

    // O += P V: the C tiles 2kk, 2kk + 1 of S are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // V fragments in groups of up to four, each loaded before its products
      constexpr int VG = NO / 2 < 4 ? NO / 2 : 4;
#pragma unroll
      for (int d0 = 0; d0 < NO / 2; d0 += VG) {
        uint32_t vb[VG][4];
#pragma unroll
        for (int dp = 0; dp < VG; ++dp)
          tc::ldsm_x4_t(vb[dp], Vt + kk * 16 * RS + v_lane + (d0 + dp) * 16);
#pragma unroll
        for (int dp = 0; dp < VG; ++dp) {
          tc::mma(acc[2 * (d0 + dp)], pa, vb[dp][0], vb[dp][1]);
          tc::mma(acc[2 * (d0 + dp) + 1], pa, vb[dp][2], vb[dp][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  tc::cp_async_wait<0>();  // no copy is in flight when no tile was visited
  __syncthreads();

  // stage this warp's 16 output rows in its own rows of Qs, then store
  // them with 16-byte writes
  __nv_bfloat16* Ow = Qs + 16 * warp * RS;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-20f);
    __nv_bfloat16* orow = Ow + (g + 8 * hf) * RS + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          tc::pack_bf16(acc[j][2 * hf] * inv, acc[j][2 * hf + 1] * inv);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    if (r_lo + r < Sq)
      *reinterpret_cast<uint4*>(op + (r_lo + r) * lay.q_s + c) =
          *reinterpret_cast<const uint4*>(Ow + r * RS + c);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const Layout& lay, int bhq, int hq, int group, int sq,
                      int sk, int causal, int window, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhq, (sq + TC_BQ - 1) / TC_BQ);
  flash_fwd_tc<D><<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lay, hq, group, sq, sk, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// One grid row per (batch, q head): bhq = batches x hq; the kv head of q
// head h is h / group.
cudaError_t dispatch_tc(int d, const void* q, const void* k, const void* v,
                        void* o, const Layout& lay, int bhq, int hq,
                        int group, int sq, int sk, int causal, int window,
                        float scale, cudaStream_t stream) {
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15) != 0)
    return cudaErrorMisalignedAddress;  // cp.async moves 16-byte chunks
  switch (d) {
    case 16: return launch_tc<16>(q, k, v, o, lay, bhq, hq, group, sq, sk, causal, window, scale, stream);
    case 32: return launch_tc<32>(q, k, v, o, lay, bhq, hq, group, sq, sk, causal, window, scale, stream);
    case 64: return launch_tc<64>(q, k, v, o, lay, bhq, hq, group, sq, sk, causal, window, scale, stream);
    case 128: return launch_tc<128>(q, k, v, o, lay, bhq, hq, group, sq, sk, causal, window, scale, stream);
    case 256: return launch_tc<256>(q, k, v, o, lay, bhq, hq, group, sq, sk, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bhq, sq, d); k, v: (bhq / group, sk, d); o: (bhq, sq, d); all
// contiguous, of one dtype (0 = float32, 1 = bfloat16). The kv row of q row
// bh is bh / group. Launches on ``stream``, allocates nothing, and returns
// the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int dtype,
                                         int bhq, int group, int sq, int sk,
                                         int d, int causal, int window,
                                         float scale, void* stream) {
  if (bhq <= 0 || group <= 0 || sq <= 0 || sk <= 0 || bhq % group != 0 ||
      bhq > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, o, bhq, group, sq, sk, causal, window, scale, st);
  else if (dtype == 1)
    err = dispatch_tc(d, q, k, v, o,
                      Layout{0, (long long)sq * d, d, 0, (long long)sk * d, d},
                      bhq, bhq, group, sq, sk, causal, window, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The model's layout, read and written in place, bf16 only (the tensor-core
// kernel): q: (b, sq, hq, d); k, v: (b, sk, hkv, d); o: (b, sq, hq, d); all
// contiguous. The kv head of q head h is h / (hq / hkv). Launches on
// ``stream``, allocates nothing, and returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_flash_attention_fwd_bshd(const void* q, const void* k,
                                              const void* v, void* o, int b,
                                              int hq, int hkv, int sq, int sk,
                                              int d, int causal, int window,
                                              float scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || sk <= 0 || hq % hkv != 0 ||
      (long long)b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout lay{(long long)sq * hq * d, d, (long long)hq * d,
                   (long long)sk * hkv * d, d, (long long)hkv * d};
  return (int)dispatch_tc(d, q, k, v, o, lay, b * hq, hq, hq / hkv, sq, sk,
                          causal, window, scale,
                          static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory, in bytes, that a block of the instantiation
// (dtype, d) launches takes; -1 for what the entry point refuses.
extern "C" int repro_flash_attention_smem(int dtype, int d) {
  if (dtype != 0 && dtype != 1) return -1;
  const bool tc = dtype == 1;
  switch (d) {
    case 16: return (int)(tc ? tc_smem_bytes<16>() : fma_smem_bytes<16>());
    case 32: return (int)(tc ? tc_smem_bytes<32>() : fma_smem_bytes<32>());
    case 64: return (int)(tc ? tc_smem_bytes<64>() : fma_smem_bytes<64>());
    case 128: return (int)(tc ? tc_smem_bytes<128>() : fma_smem_bytes<128>());
    case 256: return (int)(tc ? tc_smem_bytes<256>() : fma_smem_bytes<256>());
    default: return -1;
  }
}
