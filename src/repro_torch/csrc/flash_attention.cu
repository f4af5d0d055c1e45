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
// operations per byte, so the bound is the tensor-core rate. This first
// version does not reach it: it runs the products as f32 FMA loops out of
// shared memory (f32 and bf16 inputs alike; bf16 is widened on load), so
// its ceiling is the FMA rate and shared-memory bandwidth. What the design
// does about that: tiles are staged in shared memory with padded rows so
// the inner loops are free of bank conflicts, each thread keeps a score
// tile and an output tile in registers (4 x 8 and 8 x D/16 at D <= 128),
// K and V share one buffer so more blocks fit on an SM, and whole masked
// tiles are skipped.
// Tensor cores (mma.sync / wgmma) and TMA pipelining are later work.
//
// The tiles depend on the head dim (struct Tiles). D <= 128: 64 x 64 tiles,
// 128 threads, two blocks per SM (74 KB of shared memory at D = 128).
// D = 256 (recurrentgemma-9b): 64-row tiles would need 149 KB, one block
// per SM, and 128 accumulators a thread; so 32 x 32 tiles, 128 threads,
// each thread a 2 x 4 score tile and an 8 x 8 output tile (a warp owns 8
// rows and reads 32 neighbouring columns of V), four threads a softmax
// row, 69 KB of shared memory: three blocks per SM.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/flash_attention/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bhq, int group, int sq, int sk, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK, NT = Tiles<D>::NT;
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + BQ * (BK + 1) + 3 * BQ);
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
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, o, bhq, group, sq, sk, causal, window, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
