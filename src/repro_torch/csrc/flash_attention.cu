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
// the inner loops are free of bank conflicts, each thread keeps a 4x8
// score tile and an 8 x D/16 output tile in registers, K and V share one
// buffer so two blocks fit on an SM, and whole masked tiles are skipped.
// Tensor cores (mma.sync / wgmma) and TMA pipelining are later work.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/flash_attention/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // kv rows per tile
constexpr int NT = 128;  // threads per block

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
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < BK * D; i += NT) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (row0 + r < n_rows) x = to_f32(src[(size_t)(row0 + r) * D + c]) * mul;
    dst[r * DP + c] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int group, int Sq,
          int Sk, int causal, int window, float scale) {
  static_assert(BQ == BK, "Q and KV tiles share the loader");
  static_assert(D % 16 == 0 && D <= 128, "head_dim");
  constexpr int DP = D + 1;   // padded row stride of the Q and KV tiles
  constexpr int SP = BK + 1;  // padded row stride of the score tile
  constexpr int CPT = D / 16; // output columns per thread

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

  // score ownership: rows r1..r1+3, columns c1 + 8j
  const int r1 = (tid / 8) * 4, c1 = tid % 8;
  // output ownership: rows r3..r3+7, columns c3 + 16j
  const int r3 = (tid / 16) * 8, c3 = tid % 16;
  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
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
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(r1 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = KVs[(c1 + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r1 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + c1 + 8 * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        Ss[(r1 + i) * SP + c1 + 8 * j] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();  // K is no longer read: V may replace it

    load_tile<T, D>(KVs, vp, k0, Sk, 1.f);

    // online softmax, two threads per row
    {
      const int r = tid >> 1, h = tid & 1;
      float* srow = Ss + r * SP;
      float mx = -INFINITY;
      for (int j = h; j < BK; j += 2) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = h; j < BK; j += 2) {
        const float sv = srow[j];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
        srow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
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
    for (int i = 0; i < 8; ++i) {
      const float corr = c_s[r3 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[8], vv[CPT];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ss[(r3 + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = KVs[kk * DP + c3 + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // l_s is final (also when no tile was visited)

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + r3 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_s[r3 + i], 1e-20f);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      store(op + (size_t)row * D + c3 + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bhq, int group, int sq, int sk, int causal, int window,
                   float scale, cudaStream_t stream) {
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
