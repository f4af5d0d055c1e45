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
// are never visited; the output is acc / max(l, 1e-20). A q_offset (>= 0)
// places q row i at key position q_offset + i, for context parallelism:
// a rank's query rows against the keys gathered from every rank. Unlike the Pallas
// kernel, the ragged edge is masked here, so Sq and Sk need not be
// multiples of the tile. A logit softcap c > 0 (Gemma 2's, JAX's
// layers.attention softcap) replaces each scaled score s by c*tanh(s/c)
// before the mask and the softmax, as JAX's masked_attention and
// flash_attention_jnp do; c = 0 leaves the scores as they are. The cap is
// a template switch (CAP) of every kernel, so the uncapped instantiations
// compile to the code they had without it.
//
// What bounds it on this card: at prefill lengths the work is
// 4*Hq*D*(unmasked q-k pairs) operations over (|q|+|k|+|v|+|o|) bytes,
// which at S >= ~200, D = 128 is far above the H100's ~295 bf16
// operations per byte, so the bound is the tensor-core rate (in f32 the
// split-TF32 rate: three TF32 products at 495 TFLOP/s).
//
// Four paths, picked by the caller (kernels/flash_attention/ops.py
// flash_path) from the dtype and the head dim; none falls back to another.
//
// bf16, D in {64, 128, 256} (every shipped config): flash_fwd_wgmma,
// FlashAttention-3's shape on Hopper's wgmma and TMA (csrc/sm90.cuh).
// A block takes 64 q rows of one (batch, head) at D <= 128 (one consumer
// warpgroup, two blocks an SM) and 128 at D = 256 (two consumer
// warpgroups of 64 rows, one block an SM), beside a producer warpgroup of
// which one thread issues every TMA load (setmaxnreg: consumers 232 / 240
// registers, producer 24). Q is loaded once; K and V tiles (128 kv rows at
// D = 64, 64 at D = 128 and 256) come through two rings of FW_STAGES
// stages with full / empty mbarriers, so the producer streams tile i + 1
// while the consumers work on tile i. TMA boxes are 64 D values (128
// bytes, 128-byte swizzle) x 1 head x the tile's rows x 1 batch of a
// rank-4 map over (D, H, S, B): rows past Sq or Sk read as zeros (a rank-3
// map over (D, H, B*S) would read the next batch's rows) and stores past
// Sq are dropped. S = Q K^T is wgmma with both operands in shared memory,
// K-major (a key's D values contiguous), f32 accumulators in registers;
// the online softmax runs on those fragments (each warp's 16 rows have
// mma.sync's m16n8 layout: a row lives on the 4 lanes of a quad), the
// scale folded into the exponent (ex2.approx); P is rounded to bf16 and
// repacked in registers into the A fragments of O += P V (wgmma with A in
// registers), V the MN-major B operand (the transpose bit).
// Intra-warpgroup overlap: tile i's Q K^T is issued before tile i - 1's
// P V, so the softmax of one tile runs while the tensor cores work on the
// other. Masking runs only on tiles where some pair of the warpgroup's
// rows needs it (the causal diagonal, the window's edge, the ragged last
// tile: a zero-filled K row scores 0, not -inf, so it is masked too);
// every branch around a wgmma is uniform over the warpgroup (ptxas
// serialises wgmma behind a branch it cannot prove warp-uniform, C7518).
// The output is staged through the warpgroup's own rows of Q's buffer and
// written by a TMA store. Both entry points reach it: the model's (B, S,
// H, D) layout and (B*H, S, D), through the same map with B = 1.
//
// bf16, D in {16, 32} (test shapes and reduced configs only):
// flash_fwd_tc, FlashAttention-2 on sm_80's mma.sync. 4 warps, one block
// per (b*h, 64 q rows), each warp owns 16 q rows. Q is staged in shared
// memory once and held as ldmatrix A fragments in registers; K and V tiles
// come through a two-stage cp.async ring, so the next tile's copy
// overlaps this tile's products. S = Q K^T is mma.sync m16n8k16 with K as
// the .col B operand (ldmatrix), f32 accumulators; the online softmax,
// the P repack and the masking are the wgmma path's; V is the B operand
// through ldmatrix.trans. Rows of shared tiles are padded by 16 bytes, so
// the 8 row addresses of an ldmatrix hit 8 distinct 16-byte bank groups.
//
// Both bf16 paths: a row fully masked so far keeps m = -inf and uses 0 as
// its exponent base, so exp(-inf - -inf) never occurs. Under a softcap
// the scale no longer folds into exp2f, since the cap acts on s*scale and
// is not linear: each accumulator fragment becomes c*tanh(s*(scale/c))
// right after the products (tanh.approx.f32, one special-function-unit
// instruction, relative error ~2^-11, below the 2^-9 rounding of P to
// bf16), m is tracked in capped units, and log2(e) alone is the exp2
// factor. Blocks start in order of decreasing work: the last q tile of
// every head first, then the one before (the longest causal rows start
// first; in head-major order qwen2-7b's 28 heads left the last long rows
// to a second wave). Rows are addressed through strides, so the model's
// (B, S, H, D) tensors are read and written in place
// (repro_flash_attention_fwd_bshd): no transposed copies around the call.
//
// f32, D in {64, 128, 256} (every shipped config's f32 calls):
// flash_fwd_tf32x3, both products on wgmma in split TF32, fed by TMA.
// wgmma's tf32 form drops an f32's low 13 mantissa bits (about three
// digits), so each operand is split a = hi + lo, hi = tf32(a), lo =
// tf32(a - hi) (cvt.rna), and a b is taken as hi hi + hi lo + lo hi in the
// f32 accumulators: within about 2^-21 of |a b|, far inside f32's 2e-5
// tolerance (ssd_scan.cu's products do the same). A block is 64 q rows of
// one (batch, head): one consumer warpgroup (S = Q K^T from Q's and K's
// hi and lo planes in shared memory, the online softmax on the fragments
// as the wgmma path's with the scale folded into ex2.approx, P split in
// registers into the A fragments of O += P V) beside one splitter
// warpgroup, which turns each raw tile TMA lands into its hi and lo
// planes: Q and K in place (hi over the raw tile, lo beside it), V
// transposed (tf32 wgmma takes K-major operands only, and P V's depth is
// the keys), read whole into registers before its stage is overwritten.
// K and V tiles of 4096 values (64 kv rows at D 64, 32 at 128, 16 at
// 256) stream through rings of 32 KB stages (hi + lo); the consumer
// refills a stage itself, one predicated TMA issue as soon as it is done
// with it, so no thread waits on another to issue a load. Q's planes and
// the stages fill 224 KB: one block an SM. The m16n8 accumulator holds
// keys 2t and 2t + 1 of each k8 slice where the tf32 A fragment reads
// keys t and t + 4, so V^T's columns are written in that order and P
// needs no shuffle. The softcap is the accurate tanhf (tanh.approx's
// 2^-11 is far over 2e-5). The output is staged in Q's hi plane and
// written by a TMA store; both layouts are read and written in place.
//
// f32, D in {16, 32} (test shapes only): flash_fwd, the FMA kernel of the
// first port, on the (B*H, S, D) layout. Tiles of 64 x 64 are staged in
// shared memory with padded rows, each thread keeps a score tile and an
// output tile in registers, K and V share one buffer, whole masked tiles
// are skipped; 128 threads, two blocks per SM. Its softcap is
// c*tanhf(s/c) on each score of the tile (the accurate tanhf).
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/flash_attention/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tc_bf16.cuh"

namespace {

// ---- f32, D in {16, 32}: FMA kernel (only float instantiates it) ----

// BQ q rows per block, BK kv rows per tile, NT threads; a thread owns
// BQ / (NT / SC_T) score rows x BK / SC_T columns (SC_T threads across a
// score row) and BQ / (NT / OC_T) output rows x D / OC_T columns; MINB
// blocks per SM fit the shared memory.
template <int D>
struct Tiles {
  static constexpr int BQ = 64, BK = 64, NT = 128, SC_T = 8, OC_T = 16,
                       MINB = 2;
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

template <typename T, int D, bool CAP>
__global__ void __launch_bounds__(Tiles<D>::NT, Tiles<D>::MINB)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int group, int Sq,
          int Sk, int causal, int window, int q_offset, float scale,
          float softcap) {
  using Tl = Tiles<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, NT = Tl::NT;
  static_assert(BQ == BK, "Q and KV tiles share the loader");
  static_assert(D == 16 || D == 32, "head_dim");
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

  // kv range any row of this q-tile can see; q row i sits at key
  // position q_offset + i
  const int p0 = q_offset + q0;
  const int k_end = causal ? min(Sk, p0 + BQ) : Sk;
  const int k_first = window > 0 ? max(0, p0 - window + 1) : 0;

  for (int k0 = (k_first / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's P @ V is done with KVs and Ss
    load_tile<T, D>(KVs, kp, k0, Sk, 1.f);
    __syncthreads();

    // S = (q * scale) K^T on this tile, capped (CAP), masked
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
      const int qpos = p0 + r1 + i;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kpos = k0 + c1 + Tl::SC_T * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        float sv = s[i][j];
        if constexpr (CAP) sv = softcap * tanhf(sv / softcap);
        Ss[(r1 + i) * SP + c1 + Tl::SC_T * j] = ok ? sv : -INFINITY;
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
    // q0 + r3 + i, with q0 = p0 - q_offset: one row base stays live
    const int row = p0 - q_offset + r3 + i;
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
                   int q_offset, float scale, float softcap,
                   cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::BQ, NT = Tiles<D>::NT;
  const size_t smem = fma_smem_bytes<D>();
  const bool cap = softcap > 0.f;
  auto kernel = cap ? flash_fwd<T, D, true> : flash_fwd<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bhq);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, sq, sk, causal,
      window, q_offset, scale, cap ? softcap : 0.f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int bhq, int group, int sq, int sk,
                       int causal, int window, int q_offset, float scale,
                       float softcap, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, bhq, group, sq, sk, causal, window, q_offset, scale, softcap, stream);
    case 32: return launch<T, 32>(q, k, v, o, bhq, group, sq, sk, causal, window, q_offset, scale, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16: tensor-core kernel ----

// 4 warps a block, each owning 16 q rows (64 a block); 64 kv rows a tile;
// two blocks an SM. Registers a thread: O D/2, S 32, Q D/4 (held as A
// fragments for the whole kv loop). D in {16, 32} only.
constexpr int TC_NT = 128, TC_BQ = 64, TC_BK = 64, TC_MINB = 2;

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

// c * tanh(x / c) with x = s * scale, as c_out * tanh(s * c_in): c_in =
// scale / c, c_out = c; tanh on the special-function unit
__device__ __forceinline__ float tc_softcap(float s, float c_in,
                                            float c_out) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(s * c_in));
  return c_out * t;
}

// scale_log2 multiplies a score into exp2's units: scale * log2(e)
// without a cap, log2(e) alone with one (CAP: the scores are then already
// scaled and capped, c_out * tanh(s * c_in))
template <int D, bool CAP>
__global__ void __launch_bounds__(TC_NT, TC_MINB)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o, Layout lay, int hq, int group,
             int Sq, int Sk, int causal, int window, int q_offset,
             float scale_log2, float c_in, float c_out) {
  constexpr int BQ = TC_BQ, BK = TC_BK, RS = D + 8;
  constexpr int KS = D / 16;   // k-steps of S = Q K^T
  constexpr int NS = BK / 8;   // n8 tiles of S
  constexpr int NO = D / 8;    // n8 tiles of O
  static_assert(D % 16 == 0 && D <= 32 && BQ == 16 * (TC_NT / 32),
                "tiling");

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

  // kv range any row of this q-tile can see, in tiles; q row i sits at key
  // position q_offset + i
  const int k_end = causal ? min(Sk, q_offset + q0 + BQ) : Sk;
  const int k_first = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int t_first = k_first / BK, t_end = (k_end + BK - 1) / BK;

  tc_load_rows<BQ, D>(Qs, qp, lay.q_s, q0, Sq);
  if (t_first < t_end) {
    tc_load_rows<BK, D>(Ks, kp, lay.kv_s, t_first * BK, Sk);
    tc_load_rows<BK, D>(Vs, vp, lay.kv_s, t_first * BK, Sk);
  }
  tc::cp_async_commit();

  // this warp's rows sit at key positions p_lo .. p_lo + 15; the positions
  // of this lane's: row[0] = p_lo + g (c0, c1), row[1] = p_lo + g + 8 (c2,
  // c3)
  const int p_lo = q_offset + q0 + 16 * warp;
  const int row[2] = {p_lo + g, p_lo + g + 8};
  // ldmatrix row addresses of this lane (see tc_bf16.cuh)
  const __nv_bfloat16* q_lane = Qs + (16 * warp + (lane & 15)) * RS +
                                (lane >> 4) * 8;
  const int k_lane =
      ((lane >> 4) * 8 + (lane & 7)) * RS + ((lane >> 3) & 1) * 8;
  const int v_lane =
      (((lane >> 3) & 1) * 8 + (lane & 7)) * RS + (lane >> 4) * 8;

  uint32_t qf[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  // per row: running max (unscaled; capped under CAP) and this lane's
  // share of the sum
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
    if (tile == t_first) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) tc::ldsm_x4(qf[kk], q_lane + kk * 16);
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
      const uint32_t(&qa)[4] = qf[kk];
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

    if constexpr (CAP) {  // before the mask: a masked score stays -inf
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[j][i] = tc_softcap(s[j][i], c_in, c_out);
    }

    // mask, where some pair of this warp's rows and this tile needs it
    const bool need_mask = k0 + BK > Sk || (causal && k0 + BK - 1 > p_lo) ||
                           (window > 0 && k0 <= p_lo + 15 - window);
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
  // the warp's first row; q_offset is a parameter, so no register holds
  // the row across the kv loop beside p_lo
  const int r_lo = p_lo - q_offset;
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
                      int sk, int causal, int window, int q_offset,
                      float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  constexpr float LOG2E = 1.4426950408889634f;
  const bool cap = softcap > 0.f;
  auto kernel = cap ? flash_fwd_tc<D, true> : flash_fwd_tc<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhq, (sq + TC_BQ - 1) / TC_BQ);
  kernel<<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lay, hq, group, sq, sk, causal, window, q_offset,
      cap ? LOG2E : scale * LOG2E, cap ? scale / softcap : 0.f,
      cap ? softcap : 0.f);
  return cudaGetLastError();
}

// One grid row per (batch, q head): bhq = batches x hq; the kv head of q
// head h is h / group.
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t dispatch_tc(int d, const void* q, const void* k, const void* v,
                        void* o, const Layout& lay, int bhq, int hq,
                        int group, int sq, int sk, int causal, int window,
                        int q_offset, float scale, float softcap,
                        cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorMisalignedAddress;  // cp.async moves 16-byte chunks
  switch (d) {
    case 16: return launch_tc<16>(q, k, v, o, lay, bhq, hq, group, sq, sk, causal, window, q_offset, scale, softcap, stream);
    case 32: return launch_tc<32>(q, k, v, o, lay, bhq, hq, group, sq, sk, causal, window, q_offset, scale, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16, D >= 64: wgmma fed by TMA ----

// q rows a block at D <= 128: 64 (one consumer warpgroup, two blocks an
// SM) or 128 (two, one block an SM). 64 was faster at every D <= 128
// shape scripts/torch_tile_sweep.py times, grids of 40 to 768 64-row
// blocks: two blocks an SM hide each other's prologue (Q's load, the
// first Q K^T) and epilogue, and causal blocks of unequal length balance
// better. D = 256 takes 128 rows: its 64 KB K + V stage leaves room for
// one block an SM, whose two warpgroups then share each tile.
constexpr int FW_ROWS = 64;
constexpr int FW_BK_D64 = 128;   // kv rows a tile at D = 64
constexpr int FW_BK_D128 = 64;   // at D = 128 (a 128-row tile does not
                                 // leave two 64-row blocks an SM)
constexpr int FW_BK_D256 = 64;   // at D = 256
constexpr int FW_STAGES = 2;     // stages of the K and V rings, D <= 128
constexpr int FW_BOX = 64;       // D values a box: one 128-byte row

// NWG consumer warpgroups of 64 q rows each and a producer warpgroup;
// byte offsets in the 1024-byte aligned dynamic shared memory
template <int D>
struct FwLayout {
  static constexpr int BQ = D == 256 ? 128 : FW_ROWS;
  static constexpr int NWG = BQ / 64;
  static constexpr int BK =
      D == 64 ? FW_BK_D64 : D == 128 ? FW_BK_D128 : FW_BK_D256;
  static constexpr int NB = D / FW_BOX;         // boxes across D
  static constexpr int Q_BOX = BQ * 128;        // a Q box: BQ rows
  static constexpr int KV_BOX = BK * 128;       // a K or V box: BK rows
  static constexpr int KV_STAGE = NB * KV_BOX;  // one tile of K (or V)
  static constexpr int ST = D == 256 ? 2 : FW_STAGES;  // ring stages
  static constexpr int Q0 = 0;
  static constexpr int K0 = Q0 + NB * Q_BOX;
  static constexpr int V0 = K0 + ST * KV_STAGE;
  static constexpr int BAR0 = V0 + ST * KV_STAGE;
  static constexpr int BYTES = BAR0 + (1 + 4 * ST) * 8;
  static constexpr int SMEM = BYTES + 1024;     // + the alignment
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int MINB = NWG == 1 ? 2 : 1;  // blocks an SM
  // registers a thread after setmaxnreg: the launch's share (65536 /
  // THREADS / MINB, a multiple of 8) moved from the producer to the
  // consumers
  static constexpr int REG_P = 24, REG_C = NWG == 1 ? 232 : 240;
  static_assert((D == 64 || D == 128 || D == 256) &&
                    (BQ == 64 || BQ == 128), "head_dim, rows");
  static_assert(BK % 16 == 0 && (BK == 64 || BK == 128), "kv tile");
  static_assert(MINB * (SMEM + 1024) <= 233472, "shared memory");
};

// 2^x on the special-function unit (ex2.approx.ftz, relative error
// 2^-22; a result below 2^-126 flushes to 0, far under P's bf16 rounding)
__device__ __forceinline__ float fw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x BK) = Q K^T over one k16 slice; both K-major in shared memory
template <int BK>
__device__ __forceinline__ void fw_qk(float (&s)[BK / 2], uint64_t da,
                                      uint64_t db, bool accumulate) {
  if constexpr (BK == 64)
    sm90::wgmma_m64n64k16<0, 0>(s, da, db, accumulate);
  else
    sm90::wgmma_m64n128k16<0, 0>(s, da, db, accumulate);
}

// O (64 x D) += P (registers) V (k16 x D, MN-major in shared memory)
template <int D>
__device__ __forceinline__ void fw_pv(float (&o)[D / 2],
                                      const uint32_t (&p)[4], uint64_t db) {
  if constexpr (D == 64)
    sm90::wgmma_m64n64k16_rs<1>(o, p, db);
  else if constexpr (D == 128)
    sm90::wgmma_m64n128k16_rs<1>(o, p, db);
  else
    sm90::wgmma_m64n256k16_rs<1>(o, p, db);
}

// One block: q rows [q0, q0 + BQ) of one (batch, q head); the kv tiles
// [t_first, t_first + n) any of its rows can see. scale_log2, c_in, c_out
// as flash_fwd_tc's; sms: the card's SMs.
template <int D, bool CAP>
__global__ void __launch_bounds__(FwLayout<D>::THREADS, FwLayout<D>::MINB)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_o, int hq, int group,
                int Sq, int Sk, int causal, int window, int q_offset,
                float scale_log2, float c_in, float c_out, int sms) {
  using L = FwLayout<D>;
  constexpr int BQ = L::BQ, NWG = L::NWG, BK = L::BK, NB = L::NB, ST = L::ST;
  constexpr int NS = BK / 8;  // n8 column groups of S
  extern __shared__ __align__(1024) unsigned char smem_fw[];
  unsigned char* smem =
      smem_fw + ((1024 - (sm90::smem_u32(smem_fw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR0);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;

  // grid (b * hq, q tiles). Blocks start in order of decreasing work (q
  // tiles from the last: the longest causal rows first), except that the
  // blocks which take an SM's second slot in the first wave (MINB = 2)
  // come in reverse: the SM that got the longest first block gets the
  // shortest second one. Everything up to the role split is uniform over
  // the block.
  long long w = blockIdx.x + (long long)blockIdx.y * gridDim.x;  // launch
  if constexpr (L::MINB == 2) {
    const long long wave =
        min((long long)gridDim.x * gridDim.y, 2LL * sms);
    if (w >= sms && w < wave) w = sms + wave - 1 - w;
  }
  const int bh = (int)(w % gridDim.x);
  const int b = bh / hq, h = bh % hq;
  const int q0 = (int)(gridDim.y - 1 - w / gridDim.x) * BQ;
  const int k_end = causal ? min(Sk, q_offset + q0 + BQ) : Sk;
  const int k_first = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int t_first = k_first / BK;
  const int n = max(0, (k_end + BK - 1) / BK - t_first);  // tiles to visit
  // warp-uniform to the compiler (broadcast from lane 0), so that the
  // branches around the wgmma are too
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      sm90::mbar_init(&k_full[i], 1);          // the producer's expect_tx
      sm90::mbar_init(&v_full[i], 1);
      sm90::mbar_init(&k_empty[i], 4 * NWG);   // each consumer warp
      sm90::mbar_init(&v_empty[i], 4 * NWG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {  // ---- producer: one thread issues every load ----
    sm90::setmaxnreg_dec<L::REG_P>();
    if (threadIdx.x == NWG * 128) {
      sm90::prefetch_tensor_map(&map_q);
      sm90::prefetch_tensor_map(&map_k);
      sm90::prefetch_tensor_map(&map_v);
      const int hk = h / group;
      sm90::mbar_arrive_expect_tx(q_full, NB * L::Q_BOX);
      for (int x = 0; x < NB; ++x)
        sm90::tma_load_4d(smem + L::Q0 + x * L::Q_BOX, &map_q, q_full,
                          x * FW_BOX, h, q0, b);
      // the i-th tile of K or V into stage i % ST, once the consumers
      // have released the tile that stage held before
      auto load = [&](const CUtensorMap* map, int base, uint64_t* full,
                      uint64_t* empty, int i) {
        const int st = i % ST;
        sm90::mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[st], L::KV_STAGE);
        for (int x = 0; x < NB; ++x)
          sm90::tma_load_4d(smem + base + st * L::KV_STAGE + x * L::KV_BOX,
                            map, &full[st], x * FW_BOX, hk,
                            (t_first + i) * BK, b);
      };
      // in the order the consumers take them: K 0, then K i, V i - 1
      if (n > 0) load(&map_k, L::K0, k_full, k_empty, 0);
      for (int i = 1; i < n; ++i) {
        load(&map_k, L::K0, k_full, k_empty, i);
        load(&map_v, L::V0, v_full, v_empty, i - 1);
      }
      if (n > 0) load(&map_v, L::V0, v_full, v_empty, n - 1);
    }
  } else {  // ---- consumers: warpgroup wg owns q rows 64 wg .. +63 ----
    sm90::setmaxnreg_inc<L::REG_C>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    // key position of the warpgroup's first row (uniform), and of this
    // lane's two rows: g (fragments 0, 1) and g + 8 (fragments 2, 3) of
    // its warp's 16
    const int p_wg = q_offset + q0 + 64 * wg;
    const int row[2] = {p_wg + 16 * warp + g, p_wg + 16 * warp + g + 8};
    const uint32_t q_s = sm90::smem_u32(smem + L::Q0) + wg * 64 * 128;
    const uint32_t k_s = sm90::smem_u32(smem + L::K0);
    const uint32_t v_s = sm90::smem_u32(smem + L::V0);

    // fragment 4j + 2hf + i: row hf, column 8j + 2t + i
    float o[D / 2], s[BK / 2];
    uint32_t p[BK / 16][4];  // P as the A fragments of BK / 16 k16 slices
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    // per row: running max (unscaled; capped under CAP), this lane's share
    // of the sum, the last tile's rescale factor
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float corr[2] = {1.f, 1.f};

    // a stage is free once each consumer warp of the block has left it
    auto release = [&](uint64_t* empty, int i) {
      sm90::mbar_arrive(&empty[i % ST], lane == 0);
    };
    // S = Q K_i^T, issued and committed (the caller waits)
    auto qk = [&](int i) {
      const int st = i % ST;
      sm90::mbar_wait(&k_full[st], (i / ST) & 1);
      sm90::fence_operands(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // +32 B a k16, a box a 64
        fw_qk<BK>(s,
                  sm90::desc_sw128(q_s + kk / 4 * L::Q_BOX + kk % 4 * 32,
                                   16, 1024),
                  sm90::desc_sw128(k_s + st * L::KV_STAGE +
                                       kk / 4 * L::KV_BOX + kk % 4 * 32,
                                   16, 1024),
                  kk > 0);
      sm90::wgmma_commit();
    };
    // O += P V_i, issued and committed; 16 V rows (2048 B) a k16 slice,
    // boxes of 64 D values KV_BOX bytes apart
    auto pv = [&](int i) {
      const int st = i % ST;
      sm90::mbar_wait(&v_full[st], (i / ST) & 1);
      sm90::fence_operands(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        fw_pv<D>(o, p[kk],
                 sm90::desc_sw128(v_s + st * L::KV_STAGE + kk * 2048,
                                  L::KV_BOX, 1024));
      sm90::wgmma_commit();
    };
    // cap, mask and online softmax of tile i on S's fragments: S becomes
    // exp(S - m) (f32), m and l move, corr takes the factor for O
    auto softmax = [&](int i) {
      const int k0 = (t_first + i) * BK;
      if constexpr (CAP) {  // before the mask: a masked score stays -inf
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) s[x] = tc_softcap(s[x], c_in, c_out);
      }
      // uniform over the warpgroup: some pair of its rows and this tile
      const bool need_mask = k0 + BK > Sk ||
                             (causal && k0 + BK - 1 > p_wg) ||
                             (window > 0 && k0 <= p_wg + 63 - window);
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = k0 + 8 * j + 2 * t + (c & 1);
            const int r = row[c >> 1];
            const bool ok = col < Sk && (!causal || col <= r) &&
                            (window <= 0 || col > r - window);
            s[4 * j + c] = ok ? s[4 * j + c] : -INFINITY;
          }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = m[hf];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // exponent base; 0 while the row has seen no unmasked column
        const float base = mx == -INFINITY ? 0.f : mx * scale_log2;
        corr[hf] = fw_exp2(m[hf] * scale_log2 - base);
        m[hf] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int c = 2 * hf; c < 2 * hf + 2; ++c) {
            s[4 * j + c] = fw_exp2(fmaf(s[4 * j + c], scale_log2, -base));
            sum += s[4 * j + c];
          }
        l[hf] = l[hf] * corr[hf] + sum;
      }
    };
    auto rescale = [&] {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
    };
    // S's column groups 2kk, 2kk + 1 are the A fragment of k16 slice kk
    auto pack = [&] {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = tc::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    sm90::mbar_wait(q_full, 0);
    if (n > 0) {
      qk(0);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);
      release(k_empty, 0);
      softmax(0);
      pack();
      for (int i = 1; i < n; ++i) {
        qk(i);      // tile i's products start ...
        rescale();  // (O is not in flight: the last P V has finished)
        pv(i - 1);  // ... and tile i - 1's P V behind them
        sm90::wgmma_wait<1>();  // S of tile i is done
        sm90::fence_operands(s);
        release(k_empty, i);
        softmax(i);
        sm90::wgmma_wait<0>();  // P V of tile i - 1 is done
        sm90::fence_operands(o);
        release(v_empty, i - 1);
        pack();
      }
      rescale();
      pv(n - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
      release(v_empty, n - 1);
    }

    // O / max(l, 1e-20) into this warpgroup's rows of Q's buffer (no wgmma
    // of it reads Q any more), 128-byte rows, chunk j % 8 ^ row % 8 of box
    // j / 8; then one TMA store a box (rows past Sq are dropped)
    unsigned char* o_s = smem + L::Q0 + wg * 64 * 128;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float sum = l[hf];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / fmaxf(sum, 1e-20f);
      const int r = 16 * warp + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(
            o_s + j / 8 * L::Q_BOX + r * 128 + (((j % 8) ^ (r % 8)) << 4) +
            4 * t) = tc::pack_bf16(o[4 * j + 2 * hf] * inv,
                                   o[4 * j + 2 * hf + 1] * inv);
    }
    sm90::fence_async_shared();
    sm90::named_barrier_sync(1 + wg, 128);
    const bool leader = tid == 0;
#pragma unroll
    for (int x = 0; x < NB; ++x)
      sm90::tma_store_4d(&map_o, o_s + x * L::Q_BOX, x * FW_BOX, h,
                         q0 + 64 * wg, b, leader);
    sm90::tma_store_commit(leader);
    sm90::tma_store_wait<0>(leader);
  }
}

template <int D>
cudaError_t launch_wgmma_map(const CUtensorMap& mq, const CUtensorMap& mk,
                             const CUtensorMap& mv, const CUtensorMap& mo,
                             int bhq, int hq, int group, int sq, int sk,
                             int causal, int window, int q_offset,
                             float scale, float softcap,
                             cudaStream_t stream) {
  using L = FwLayout<D>;
  constexpr float LOG2E = 1.4426950408889634f;
  const bool cap = softcap > 0.f;
  auto kernel = cap ? flash_fwd_wgmma<D, true> : flash_fwd_wgmma<D, false>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhq, (sq + L::BQ - 1) / L::BQ);
  kernel<<<grid, L::THREADS, L::SMEM, stream>>>(
      mq, mk, mv, mo, hq, group, sq, sk, causal, window, q_offset,
      cap ? LOG2E : scale * LOG2E, cap ? scale / softcap : 0.f,
      cap ? softcap : 0.f, sms);
  return cudaGetLastError();
}

// The four tensor maps (q and o: boxes of 64 D values x 1 head x the
// block's rows (q) or a warpgroup's 64 (o) x 1 batch; k and v: x the kv
// tile's rows), then the launch. lay's strides are in elements; a map
// takes them in bytes.
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, const Layout& lay, int batches, int hq,
                         int hkv, int sq, int sk, int causal, int window,
                         int q_offset, float scale, float softcap,
                         cudaStream_t stream) {
  using L = FwLayout<D>;
  const cuuint64_t qdims[4] = {(cuuint64_t)D, (cuuint64_t)hq, (cuuint64_t)sq,
                               (cuuint64_t)batches};
  const cuuint64_t kdims[4] = {(cuuint64_t)D, (cuuint64_t)hkv,
                               (cuuint64_t)sk, (cuuint64_t)batches};
  const cuuint64_t qstr[3] = {(cuuint64_t)lay.q_h * 2, (cuuint64_t)lay.q_s * 2,
                              (cuuint64_t)lay.q_b * 2};
  const cuuint64_t kstr[3] = {(cuuint64_t)lay.kv_h * 2,
                              (cuuint64_t)lay.kv_s * 2,
                              (cuuint64_t)lay.kv_b * 2};
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err = sm90::tensor_map_bf16<4>(&mq, q, qdims, qstr,
                                             {FW_BOX, 1, L::BQ, 1});
  if (err == cudaSuccess)
    err = sm90::tensor_map_bf16<4>(&mk, k, kdims, kstr, {FW_BOX, 1, L::BK, 1});
  if (err == cudaSuccess)
    err = sm90::tensor_map_bf16<4>(&mv, v, kdims, kstr, {FW_BOX, 1, L::BK, 1});
  if (err == cudaSuccess)
    err = sm90::tensor_map_bf16<4>(&mo, o, qdims, qstr, {FW_BOX, 1, 64, 1});
  if (err != cudaSuccess) return err;
  return launch_wgmma_map<D>(mq, mk, mv, mo, batches * hq, hq, hq / hkv, sq,
                             sk, causal, window, q_offset, scale, softcap,
                             stream);
}

cudaError_t dispatch_wgmma(int d, const void* q, const void* k,
                           const void* v, void* o, const Layout& lay,
                           int batches, int hq, int hkv, int sq, int sk,
                           int causal, int window, int q_offset, float scale,
                           float softcap, cudaStream_t stream) {
  // TMA: 16-byte aligned bases, row strides of 128 bytes or more
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorMisalignedAddress;
  switch (d) {
    case 64: return launch_wgmma<64>(q, k, v, o, lay, batches, hq, hkv, sq, sk, causal, window, q_offset, scale, softcap, stream);
    case 128: return launch_wgmma<128>(q, k, v, o, lay, batches, hq, hkv, sq, sk, causal, window, q_offset, scale, softcap, stream);
    case 256: return launch_wgmma<256>(q, k, v, o, lay, batches, hq, hkv, sq, sk, causal, window, q_offset, scale, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- f32, D >= 64: split TF32 on wgmma, fed by TMA ----

// Every K or V tile is 4096 f32 values (16 KB), so its kv rows are 4096 /
// D: 64 at D = 64, 32 at D = 128, 16 at D = 256. Ring stages of K and of V
// a head dim: Q's two planes and the KST + VST stages of 32 KB fill 224 KB
// (one block an SM). From scripts/torch_tile_sweep.py --kernels tf32x3:
// at D 64 and 128 every split measured within 3% of the others; at D 256
// one V stage costs 16-18% (V's refill is asked for only after P V).
constexpr int FT_KST_D64 = 4, FT_VST_D64 = 2;
constexpr int FT_KST_D128 = 1, FT_VST_D128 = 4;
constexpr int FT_KST_D256 = 1, FT_VST_D256 = 2;

// One consumer warpgroup of 64 q rows and one splitter warpgroup; byte
// offsets in the 1024-byte aligned dynamic shared memory. Tiles are
// K-major f32 in panels of 32 values (128-byte rows, 128-byte swizzle).
template <int D>
struct FtLayout {
  static constexpr int BQ = 64;
  static constexpr int BK = 4096 / D;              // kv rows a tile
  static constexpr int NB = D / 32;                // TMA boxes across D
  static constexpr int KST = D == 64 ? FT_KST_D64
                             : D == 128 ? FT_KST_D128 : FT_KST_D256;
  static constexpr int VST = D == 64 ? FT_VST_D64
                             : D == 128 ? FT_VST_D128 : FT_VST_D256;
  static constexpr int Q_BOX = BQ * 128;           // a Q box: 64 rows
  static constexpr int KV_BOX = BK * 128;          // a K or V box: BK rows
  static constexpr int PLANE = 16384;              // a K or V tile
  static constexpr int STAGE = 2 * PLANE;          // its hi and lo
  static constexpr int VT_PANEL = D * 128;         // a panel of V^T: D rows
  static constexpr int Q0 = 0;                     // Q hi (raw Q lands here)
  static constexpr int QL = Q0 + NB * Q_BOX;       // Q lo
  static constexpr int K0 = QL + NB * Q_BOX;
  static constexpr int V0 = K0 + KST * STAGE;
  static constexpr int BAR0 = V0 + VST * STAGE;
  static constexpr int BYTES = BAR0 + (2 + 2 * KST + 2 * VST) * 8;
  static constexpr int SMEM = BYTES + 1024;        // + the alignment
  static constexpr int THREADS = 256;
  static_assert((D == 64 || D == 128 || D == 256) && NB * KV_BOX == PLANE,
                "head_dim");
  static_assert(SMEM <= 232448, "shared memory");
};

// 64 x BK scores over one k8 slice of D; both K-major in shared memory
template <int BK>
__device__ __forceinline__ void ft_qk(float (&s)[BK / 2], uint64_t da,
                                      uint64_t db, bool accumulate) {
  if constexpr (BK == 64)
    sm90::wgmma_m64n64k8_tf32(s, da, db, accumulate);
  else if constexpr (BK == 32)
    sm90::wgmma_m64n32k8_tf32(s, da, db, accumulate);
  else
    sm90::wgmma_m64n16k8_tf32(s, da, db, accumulate);
}

// O (64 x D) += P (one k8 slice, registers) V^T's slice (K-major)
template <int D>
__device__ __forceinline__ void ft_pv(float (&o)[D / 2], const float (&p)[4],
                                      uint64_t db) {
  if constexpr (D == 64)
    sm90::wgmma_m64n64k8_tf32_rs(o, p, db);
  else if constexpr (D == 128)
    sm90::wgmma_m64n128k8_tf32_rs(o, p, db);
  else
    sm90::wgmma_m64n256k8_tf32_rs(o, p, db);
}

// the descriptor of a tile at shared address ``saddr``, opaque to the
// compiler: a slice's descriptor is this one plus its byte offset / 16
// (the start address field, 14 bits of addr / 16, cannot carry below 256
// KB), added where it is used. Left visible, every slice's descriptor of
// Q and K is hoisted out of the kv loop into two registers each (at D 256,
// 192 registers: spills).
__device__ __forceinline__ uint64_t ft_desc(uint32_t saddr) {
  uint64_t d = sm90::desc_sw128(saddr, 16, 1024);
  asm volatile("" : "+l"(d));
  return d;
}

// hi = tf32(a) (cvt.rna), lo = tf32(a - hi), four at a time
__device__ __forceinline__ void ft_split(float4 a, float4& hi, float4& lo) {
  hi = make_float4(sm90::to_tf32(a.x), sm90::to_tf32(a.y),
                   sm90::to_tf32(a.z), sm90::to_tf32(a.w));
  lo = make_float4(sm90::to_tf32(a.x - hi.x), sm90::to_tf32(a.y - hi.y),
                   sm90::to_tf32(a.z - hi.z), sm90::to_tf32(a.w - hi.w));
}

// ``n16`` 16-byte chunks of a raw tile at ``raw`` split in place into hi,
// lo at the same offsets from ``lo``: chunk tid, tid + 128, ...
__device__ __forceinline__ void ft_split_plane(unsigned char* raw,
                                               unsigned char* lo, int n16,
                                               int tid) {
  for (int c = tid; c < n16; c += 128) {
    float4 h, l;
    ft_split(*reinterpret_cast<const float4*>(raw + 16 * c), h, l);
    *reinterpret_cast<float4*>(raw + 16 * c) = h;
    *reinterpret_cast<float4*>(lo + 16 * c) = l;
  }
}

// One block: q rows [q0, q0 + 64) of one (batch, q head) against the kv
// tiles [t_first, t_first + n) any of them can see. scale_log2, c_in,
// c_out as flash_fwd_tc's; the cap is the accurate tanhf.
template <int D, bool CAP>
__global__ void __launch_bounds__(FtLayout<D>::THREADS, 1)
flash_fwd_tf32x3(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_o, int hq,
                 int group, int Sq, int Sk, int causal, int window,
                 int q_offset, float scale_log2, float c_in, float c_out) {
  using L = FtLayout<D>;
  constexpr int BK = L::BK, NB = L::NB, KST = L::KST, VST = L::VST;
  constexpr int NS = BK / 8;  // k8 slices of a kv tile (n8 groups of S)
  extern __shared__ __align__(1024) unsigned char smem_ft[];
  unsigned char* smem =
      smem_ft + ((1024 - (sm90::smem_u32(smem_ft) & 1023)) & 1023);
  uint64_t* q_raw = reinterpret_cast<uint64_t*>(smem + L::BAR0);
  uint64_t* q_full = q_raw + 1;
  uint64_t* k_raw = q_full + 1;   // TMA has landed a raw tile
  uint64_t* k_full = k_raw + KST; // the splitters have split it
  uint64_t* v_raw = k_full + KST;
  uint64_t* v_full = v_raw + VST;

  // grid (b * hq, q tiles), q tiles from the last: the longest causal
  // rows start first. Everything up to the role split is uniform.
  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BQ;
  const int k_end = causal ? min(Sk, q_offset + q0 + L::BQ) : Sk;
  const int k_first = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int t_first = k_first / BK;
  const int n = max(0, (k_end + BK - 1) / BK - t_first);  // tiles to visit
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;

  // the i-th raw K (V) tile into stage i % KST (i % VST), if ``pred``
  auto load_k = [&](int i, bool pred) {
    const int st = i % KST;
    sm90::mbar_arrive_expect_tx(&k_raw[st], L::PLANE, pred);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      sm90::tma_load_4d(smem + L::K0 + st * L::STAGE + x * L::KV_BOX, &map_k,
                        &k_raw[st], 32 * x, hk, (t_first + i) * BK, b, pred);
  };
  auto load_v = [&](int i, bool pred) {
    const int st = i % VST;
    sm90::mbar_arrive_expect_tx(&v_raw[st], L::PLANE, pred);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      sm90::tma_load_4d(smem + L::V0 + st * L::STAGE + x * L::KV_BOX, &map_v,
                        &v_raw[st], 32 * x, hk, (t_first + i) * BK, b, pred);
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_raw, 1);
    sm90::mbar_init(q_full, 128);          // every splitter thread
    for (int i = 0; i < KST; ++i) {
      sm90::mbar_init(&k_raw[i], 1);       // one expect_tx
      sm90::mbar_init(&k_full[i], 128);
    }
    for (int i = 0; i < VST; ++i) {
      sm90::mbar_init(&v_raw[i], 1);
      sm90::mbar_init(&v_full[i], 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 1) {  // ---- splitters: each raw tile into hi and lo ----
    if (tid == 0) {  // Q and the first tile of each stage
      sm90::prefetch_tensor_map(&map_q);
      sm90::prefetch_tensor_map(&map_k);
      sm90::prefetch_tensor_map(&map_v);
      sm90::mbar_arrive_expect_tx(q_raw, NB * L::Q_BOX);
      for (int x = 0; x < NB; ++x)
        sm90::tma_load_4d(smem + L::Q0 + x * L::Q_BOX, &map_q, q_raw, 32 * x,
                          h, q0, b);
      for (int i = 0; i < KST && i < n; ++i) load_k(i, true);
      for (int i = 0; i < VST && i < n; ++i) load_v(i, true);
    }
    sm90::mbar_wait(q_raw, 0);
    ft_split_plane(smem + L::Q0, smem + L::QL, NB * L::Q_BOX / 16, tid);
    sm90::fence_async_shared();
    sm90::mbar_arrive(q_full);

    // V^T's transpose: this thread's two 4 x 4 blocks of the tile, block
    // (kq, dq) the keys of quad kq (below) x D values 4 dq .. 4 dq + 3. A
    // quarter warp's 8 blocks lie so that its 16-byte reads of the raw tile
    // and its writes of V^T each touch 8 distinct bank groups.
    constexpr int KQ = BK / 4;    // key quads a tile
    constexpr int KQ4 = KQ / 4;
    int kq[2], dq[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int blk = tid + 128 * j;
      const int l = blk & 7, w = (blk >> 3) & 3, v = blk >> 5;
      kq[j] = (l & 3) + 4 * (v % KQ4);
      dq[j] = 8 * (v / KQ4) + (((l & 6) + (l >> 2)) ^ (2 * w));
    }
    for (int i = 0; i < n; ++i) {
      const int ks = i % KST;
      unsigned char* kt = smem + L::K0 + ks * L::STAGE;
      sm90::mbar_wait(&k_raw[ks], (i / KST) & 1);
      ft_split_plane(kt, kt + L::PLANE, L::PLANE / 16, tid);
      sm90::fence_async_shared();
      sm90::mbar_arrive(&k_full[ks]);

      // V: read the raw blocks, wait for every splitter, then write V^T's
      // hi and lo over the stage. V^T is the B operand of P V: D rows of
      // 2 BK logical columns (hi, then lo) in panels of 32. P's A fragment
      // holds keys 2t and 2t + 1 of each k8 slice where wgmma reads columns
      // t and t + 4, so logical column c of a slice holds key 2c (c < 4) or
      // 2 (c - 4) + 1: key quad kq = 2 s + par holds keys 8 s + par + 2 m
      // (m = 0..3) at logical columns 4 kq + m.
      const int vs = i % VST;
      unsigned char* vt = smem + L::V0 + vs * L::STAGE;
      sm90::mbar_wait(&v_raw[vs], (i / VST) & 1);
      float x[2][4][4];  // block j, key m, D value e
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int r = 8 * (kq[j] >> 1) + (kq[j] & 1) + 2 * m;
          const float4 a = *reinterpret_cast<const float4*>(
              vt + (dq[j] >> 3) * L::KV_BOX + r * 128 +
              (((dq[j] & 7) ^ (r & 7)) << 4));
          x[j][m][0] = a.x;
          x[j][m][1] = a.y;
          x[j][m][2] = a.z;
          x[j][m][3] = a.w;
        }
      sm90::named_barrier_sync(2, 128);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * dq[j] + e;
          float4 hi, lo;
          ft_split(make_float4(x[j][0][e], x[j][1][e], x[j][2][e],
                               x[j][3][e]),
                   hi, lo);
          const int ch = kq[j], cl = KQ + kq[j];   // 16-byte column chunks
          *reinterpret_cast<float4*>(vt + (ch >> 3) * L::VT_PANEL + d * 128 +
                                     (((ch & 7) ^ (d & 7)) << 4)) = hi;
          *reinterpret_cast<float4*>(vt + (cl >> 3) * L::VT_PANEL + d * 128 +
                                     (((cl & 7) ^ (d & 7)) << 4)) = lo;
        }
      sm90::fence_async_shared();
      sm90::mbar_arrive(&v_full[vs]);
    }
  } else {  // ---- consumer: 64 q rows, 16 a warp ----
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    // key position of the warpgroup's first row (uniform), and of this
    // lane's two rows: g (fragments 0, 1) and g + 8 (2, 3) of its warp's 16
    const int p_wg = q_offset + q0;
    const int row[2] = {p_wg + 16 * warp + g, p_wg + 16 * warp + g + 8};
    const uint32_t q_s = sm90::smem_u32(smem + L::Q0);
    const uint32_t k_s = sm90::smem_u32(smem + L::K0);
    const uint32_t v_s = sm90::smem_u32(smem + L::V0);
    const bool leader = tid == 0;

    // fragment 4j + 2hf + i: row hf, column 8j + 2t + i
    float o[D / 2], s[BK / 2];
    float ph[NS][4], pl[NS][4];  // P's hi and lo as A fragments a slice
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    // per row: running max (unscaled; capped under CAP), this lane's share
    // of the sum, the last tile's rescale factor
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float corr[2] = {1.f, 1.f};

    // S = Q K_i^T as Qh Kh + Qh Kl + Ql Kh, issued and committed
    auto qk = [&](int i) {
      const int st = i % KST;
      sm90::mbar_wait(&k_full[st], (i / KST) & 1);
      sm90::fence_operands(s);
      sm90::wgmma_fence();
      const uint64_t dq = ft_desc(q_s), dk = ft_desc(k_s + st * L::STAGE);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {  // +32 B a k8, a box a 32
        const uint64_t qa = dq + (kk / 4 * L::Q_BOX + kk % 4 * 32) / 16;
        const uint64_t ka = dk + (kk / 4 * L::KV_BOX + kk % 4 * 32) / 16;
        ft_qk<BK>(s, qa, ka, kk > 0);
        ft_qk<BK>(s, qa, ka + L::PLANE / 16, true);
        ft_qk<BK>(s, qa + NB * L::Q_BOX / 16, ka, true);
      }
      sm90::wgmma_commit();
    };
    // O += P V_i as Ph Vh + Ph Vl + Pl Vh, issued and committed
    auto pv = [&](int i) {
      const int st = i % VST;
      sm90::mbar_wait(&v_full[st], (i / VST) & 1);
      sm90::fence_operands(o);
      sm90::wgmma_fence();
      const uint64_t dv = ft_desc(v_s + st * L::STAGE);
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const int ch = kk, cl = NS + kk;  // hi's and lo's k8 slices
        const uint64_t vh = dv + (ch / 4 * L::VT_PANEL + ch % 4 * 32) / 16;
        const uint64_t vl = dv + (cl / 4 * L::VT_PANEL + cl % 4 * 32) / 16;
        ft_pv<D>(o, ph[kk], vh);
        ft_pv<D>(o, ph[kk], vl);
        ft_pv<D>(o, pl[kk], vh);
      }
      sm90::wgmma_commit();
    };
    // cap, mask and online softmax of tile i on S's fragments: S becomes
    // exp(S - m), m and l move, corr takes the factor for O
    auto softmax = [&](int i) {
      const int k0 = (t_first + i) * BK;
      if constexpr (CAP) {  // before the mask: a masked score stays -inf
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) s[x] = c_out * tanhf(s[x] * c_in);
      }
      // uniform over the warpgroup: some pair of its rows and this tile
      const bool need_mask = k0 + BK > Sk ||
                             (causal && k0 + BK - 1 > p_wg) ||
                             (window > 0 && k0 <= p_wg + 63 - window);
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = k0 + 8 * j + 2 * t + (c & 1);
            const int r = row[c >> 1];
            const bool ok = col < Sk && (!causal || col <= r) &&
                            (window <= 0 || col > r - window);
            s[4 * j + c] = ok ? s[4 * j + c] : -INFINITY;
          }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = m[hf];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // exponent base; 0 while the row has seen no unmasked column
        const float base = mx == -INFINITY ? 0.f : mx * scale_log2;
        corr[hf] = fw_exp2(m[hf] * scale_log2 - base);
        m[hf] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int c = 2 * hf; c < 2 * hf + 2; ++c) {
            s[4 * j + c] = fw_exp2(fmaf(s[4 * j + c], scale_log2, -base));
            sum += s[4 * j + c];
          }
        l[hf] = l[hf] * corr[hf] + sum;
      }
    };
    auto rescale = [&] {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
    };
    // slice kk's A fragment (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    // at keys 2t, 2t, 2t + 1, 2t + 1 (V^T's columns are permuted to match)
    auto pack = [&] {
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const float a[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1],
                            s[4 * kk + 3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ph[kk][r] = sm90::to_tf32(a[r]);
          pl[kk][r] = sm90::to_tf32(a[r] - ph[kk][r]);
        }
      }
    };
    auto fence_p = [&] {
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        sm90::fence_operands(ph[kk]);
        sm90::fence_operands(pl[kk]);
      }
    };

    sm90::mbar_wait(q_full, 0);
    if (n > 0) {
      qk(0);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);
      load_k(KST, leader && KST < n);  // stage 0 is free again
      softmax(0);
      pack();
      for (int i = 1; i < n; ++i) {
        qk(i);      // tile i's products start ...
        rescale();  // (O is not in flight: the last P V has finished)
        pv(i - 1);  // ... and tile i - 1's P V behind them
        sm90::wgmma_wait<1>();  // S of tile i is done
        sm90::fence_operands(s);
        load_k(i + KST, leader && i + KST < n);
        softmax(i);
        sm90::wgmma_wait<0>();  // P V of tile i - 1 is done
        sm90::fence_operands(o);
        fence_p();
        load_v(i - 1 + VST, leader && i - 1 + VST < n);
        pack();
      }
      rescale();
      pv(n - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
      fence_p();
    }

    // O / max(l, 1e-20) into Q's hi plane (no wgmma reads Q any more) as
    // TMA's f32 boxes lie: box j / 4, 128-byte rows, chunk (2 (j % 4) +
    // t / 2) ^ row % 8; then one TMA store a box (rows past Sq dropped)
    unsigned char* o_s = smem + L::Q0;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float sum = l[hf];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / fmaxf(sum, 1e-20f);
      const int r = 16 * warp + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(
            o_s + j / 4 * L::Q_BOX + r * 128 +
            (((2 * (j % 4) + (t >> 1)) ^ (r % 8)) << 4) + (t & 1) * 8) =
            make_float2(o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
    }
    sm90::fence_async_shared();
    sm90::named_barrier_sync(1, 128);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      sm90::tma_store_4d(&map_o, o_s + x * L::Q_BOX, 32 * x, h, q0, b,
                         leader);
    sm90::tma_store_commit(leader);
    sm90::tma_store_wait<0>(leader);
  }
}

// The four f32 tensor maps (q and o: boxes of 32 D values x 1 head x 64
// rows x 1 batch; k and v: x the kv tile's rows), then the launch. lay's
// strides are in elements; a map takes them in bytes.
template <int D>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v,
                          void* o, const Layout& lay, int batches, int hq,
                          int hkv, int sq, int sk, int causal, int window,
                          int q_offset, float scale, float softcap,
                          cudaStream_t stream) {
  using L = FtLayout<D>;
  constexpr float LOG2E = 1.4426950408889634f;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t qdims[4] = {(cuuint64_t)D, (cuuint64_t)hq, (cuuint64_t)sq,
                               (cuuint64_t)batches};
  const cuuint64_t kdims[4] = {(cuuint64_t)D, (cuuint64_t)hkv,
                               (cuuint64_t)sk, (cuuint64_t)batches};
  const cuuint64_t qstr[3] = {(cuuint64_t)lay.q_h * 4, (cuuint64_t)lay.q_s * 4,
                              (cuuint64_t)lay.q_b * 4};
  const cuuint64_t kstr[3] = {(cuuint64_t)lay.kv_h * 4,
                              (cuuint64_t)lay.kv_s * 4,
                              (cuuint64_t)lay.kv_b * 4};
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err = sm90::tensor_map<4>(&mq, F32, q, qdims, qstr,
                                        {32, 1, L::BQ, 1});
  if (err == cudaSuccess)
    err = sm90::tensor_map<4>(&mk, F32, k, kdims, kstr, {32, 1, L::BK, 1});
  if (err == cudaSuccess)
    err = sm90::tensor_map<4>(&mv, F32, v, kdims, kstr, {32, 1, L::BK, 1});
  if (err == cudaSuccess)
    err = sm90::tensor_map<4>(&mo, F32, o, qdims, qstr, {32, 1, L::BQ, 1});
  const bool cap = softcap > 0.f;
  auto kernel = cap ? flash_fwd_tf32x3<D, true> : flash_fwd_tf32x3<D, false>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(batches * hq, (sq + L::BQ - 1) / L::BQ);
  kernel<<<grid, L::THREADS, L::SMEM, stream>>>(
      mq, mk, mv, mo, hq, hq / hkv, sq, sk, causal, window, q_offset,
      cap ? LOG2E : scale * LOG2E, cap ? scale / softcap : 0.f,
      cap ? softcap : 0.f);
  return cudaGetLastError();
}

cudaError_t dispatch_tf32x3(int d, const void* q, const void* k,
                            const void* v, void* o, const Layout& lay,
                            int batches, int hq, int hkv, int sq, int sk,
                            int causal, int window, int q_offset, float scale,
                            float softcap, cudaStream_t stream) {
  // TMA: 16-byte aligned bases, row strides of 256 bytes or more
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorMisalignedAddress;
  switch (d) {
    case 64: return launch_tf32x3<64>(q, k, v, o, lay, batches, hq, hkv, sq, sk, causal, window, q_offset, scale, softcap, stream);
    case 128: return launch_tf32x3<128>(q, k, v, o, lay, batches, hq, hkv, sq, sk, causal, window, q_offset, scale, softcap, stream);
    case 256: return launch_tf32x3<256>(q, k, v, o, lay, batches, hq, hkv, sq, sk, causal, window, q_offset, scale, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the paths, as kernels/flash_attention/ops.py numbers them
enum Path { FMA = 0, TC = 1, WGMMA = 2, TF32X3 = 3 };

}  // namespace

// q: (bhq, sq, d); k, v: (bhq / group, sk, d); o: (bhq, sq, d); all
// contiguous; float32 for paths FMA (d 16, 32) and TF32X3 (d 64, 128,
// 256), bfloat16
// for TC (d 16, 32) and WGMMA (d 64, 128, 256): the caller's choice (kernels/flash_attention/ops.py
// flash_path). The kv row of q row bh is bh / group; q row i sits at key
// position q_offset + i (>= 0). softcap > 0 caps each scaled score s at
// softcap * tanh(s / softcap); 0 leaves it. Launches on ``stream``,
// allocates nothing, and returns the cudaError_t of the launch (0 on
// success); a path that does not take the call refuses it
// (cudaErrorInvalidValue) and launches nothing.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int path,
                                         int bhq, int group, int sq, int sk,
                                         int d, int causal, int window,
                                         int q_offset, float scale,
                                         float softcap, void* stream) {
  if (bhq <= 0 || group <= 0 || sq <= 0 || sk <= 0 || bhq % group != 0 ||
      bhq > 65535 || q_offset < 0 ||
      !(softcap >= 0.f && softcap < INFINITY))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one batch of bhq heads; its stride only has to be a valid one
  const Layout lay{(long long)bhq * sq * d, (long long)sq * d, d,
                   (long long)(bhq / group) * sk * d, (long long)sk * d, d};
  switch (path) {
    case FMA:
      return (int)dispatch_d<float>(d, q, k, v, o, bhq, group, sq, sk, causal, window, q_offset, scale, softcap, st);
    case TC:
      return (int)dispatch_tc(d, q, k, v, o, lay, bhq, bhq, group, sq, sk,
                              causal, window, q_offset, scale, softcap, st);
    case WGMMA:
      return (int)dispatch_wgmma(d, q, k, v, o, lay, 1, bhq, bhq / group, sq,
                                 sk, causal, window, q_offset, scale,
                                 softcap, st);
    case TF32X3:
      return (int)dispatch_tf32x3(d, q, k, v, o, lay, 1, bhq, bhq / group,
                                  sq, sk, causal, window, q_offset, scale,
                                  softcap, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The model's layout, read and written in place (path TC or WGMMA in
// bf16, TF32X3 in f32): q: (b, sq, hq, d); k, v: (b, sk, hkv, d); o: (b, sq, hq, d); all
// contiguous. The kv head of q head h is h / (hq / hkv); q row i sits at
// key position q_offset + i (>= 0); softcap as above. Launches on
// ``stream``, allocates nothing, and returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_flash_attention_fwd_bshd(const void* q, const void* k,
                                              const void* v, void* o,
                                              int path, int b, int hq,
                                              int hkv, int sq, int sk, int d,
                                              int causal, int window,
                                              int q_offset, float scale,
                                              float softcap, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || sk <= 0 || hq % hkv != 0 ||
      (long long)b * hq > 65535 || q_offset < 0 ||
      !(softcap >= 0.f && softcap < INFINITY))
    return (int)cudaErrorInvalidValue;
  const Layout lay{(long long)sq * hq * d, d, (long long)hq * d,
                   (long long)sk * hkv * d, d, (long long)hkv * d};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (path) {
    case TC:
      return (int)dispatch_tc(d, q, k, v, o, lay, b * hq, hq, hq / hkv, sq,
                              sk, causal, window, q_offset, scale, softcap,
                              st);
    case WGMMA:
      return (int)dispatch_wgmma(d, q, k, v, o, lay, b, hq, hkv, sq, sk,
                                 causal, window, q_offset, scale, softcap,
                                 st);
    case TF32X3:
      return (int)dispatch_tf32x3(d, q, k, v, o, lay, b, hq, hkv, sq, sk,
                                  causal, window, q_offset, scale, softcap,
                                  st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory, in bytes, that a block of ``path`` takes at head
// dim d; -1 for what the entry points refuse.
extern "C" int repro_flash_attention_smem(int path, int d) {
  switch (path) {
    case FMA:
      return d == 16 ? (int)fma_smem_bytes<16>()
                     : d == 32 ? (int)fma_smem_bytes<32>() : -1;
    case TC:
      return d == 16 ? (int)tc_smem_bytes<16>()
                     : d == 32 ? (int)tc_smem_bytes<32>() : -1;
    case WGMMA:
      return d == 64 ? FwLayout<64>::SMEM
                     : d == 128 ? FwLayout<128>::SMEM
                                : d == 256 ? FwLayout<256>::SMEM : -1;
    case TF32X3:
      return d == 64 ? FtLayout<64>::SMEM
                     : d == 128 ? FtLayout<128>::SMEM
                                : d == 256 ? FtLayout<256>::SMEM : -1;
  }
  return -1;
}
