// RG-LRU linear recurrence for Hopper (sm_90a): per (batch, channel),
//   h_t = exp(log_a_t) h_{t-1} + b_t,   h_{-1} = h0 (0 when absent),
// every h_t written out, and the last one, the carry, also in f32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan/rglru_scan.py:55 rglru_scan_bc
//   (_rglru_kernel :28, pl.pallas_call :62), wrapper
//   src/repro/kernels/rglru_scan/ops.py rglru_scan; the JAX model computes
//   the same function with an associative scan in
//   src/repro/models/rglru.py:68 _rglru_scan.
// It computes what _rglru_kernel computes, not block for block: the TPU
// walks chunks of the sequence on a sequential grid axis, the (1, C) carry
// in VMEM scratch, and runs an exact sequential loop inside each chunk.
//
// What bounds it on this card: it reads log_a and b once and writes h once
// (recurrentgemma-9b's prefill of 1024 tokens at batch 1, C 4096, f32:
// 50.3 MB, 0.015 ms at 3.35 TB/s); its operations (an exp, a multiply and
// an FMA per element) are far below that. To reach the memory rate, each
// SM needs tens of KB in flight; one thread walking all S steps of a
// channel (the first version) left 32 of the 132 SMs busy at batch 1,
// latency-bound on the dependent chain.
// What the design does about it: the sequence is cut into chunks of L = 8
// steps, and one thread owns one (channel, chunk). A block owns 32
// neighbouring channels (a warp spans them, so every load and store is a
// coalesced row) over up to WARPS chunks a round (WARPS L = 256 steps;
// fewer warps when S is shorter), and walks the rounds of its sequence
// with the carry kept between them, so any S and any C work (C = 4096 at
// batch 1: 128 blocks of 32 warps; S = 32: 4 warps).
// Each thread
//   1. holds its L steps in registers, and the next round's L steps are
//      loaded before this round's arithmetic, so 64 KB a block are in
//      flight while the chain runs;
//   2. runs the local recurrence from 0, h_local_t, with the running
//      product P_t = prod_{u <= t} exp(log_a_u) of its chunk;
//   3. publishes (P_end, h_local_end) in shared memory; one warp then
//      walks the round's chunks, h_start(k) = P_end(k-1) h_start(k-1) +
//      h_local_end(k-1), from the carry (h0 or 0 in the first round);
//   4. writes h_t = h_local_t + P_t h_start.
// The running product, never exp(cum_i - cum_j): under strong decay
// (log_a about -10.5 a step at the model's scale) the difference form
// overflows, while the product only underflows, to 0, which is right.
// Steps past S count as log_a = 0, b = 0 (they leave h and P as they are)
// and are never stored. All arithmetic and the carry are f32 (expf, not
// __expf); bf16 inputs are widened on load and h is rounded once, on
// store. One launch a call.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/rglru_scan/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 32;        // most chunks of a round, one warp each
constexpr int NT = 32 * WARPS;   // most threads of a block
constexpr int L = 8;             // steps of a chunk, one thread's

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Steps t0 .. t0 + L - 1 of one channel; steps at or past S (or of a
// channel past C) read as log_a = 0, b = 0.
template <typename T>
__device__ __forceinline__ void load_chunk(float (&la)[L], float (&bx)[L],
                                           const T* __restrict__ pa,
                                           const T* __restrict__ pb, int t0,
                                           int S, int C, bool ok) {
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const int t = t0 + u;
    const bool in = ok && t < S;
    la[u] = in ? to_f32(pa[(size_t)t * C]) : 0.f;
    bx[u] = in ? to_f32(pb[(size_t)t * C]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_fwd(const T* __restrict__ log_a, const T* __restrict__ b,
          const float* __restrict__ h0, T* __restrict__ y,
          float* __restrict__ h_last, int S, int C) {
  __shared__ float p_end[WARPS][32], h_end[WARPS][32], h_start[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;             // chunks of a round
  const int round = nw * L;                   // steps of a round
  const int c = blockIdx.x * 32 + lane;
  const int bi = blockIdx.y;
  const bool ok = c < C;
  const size_t base = ok ? (size_t)bi * S * C + c : 0;
  const T* pa = log_a + base;
  const T* pb = b + base;
  T* py = y + base;

  // the carry between rounds, held by warp 0
  float carry = warp == 0 && ok && h0 != nullptr ? h0[(size_t)bi * C + c]
                                                 : 0.f;
  float la[L], bx[L];
  load_chunk<T>(la, bx, pa, pb, warp * L, S, C, ok);
  for (int r0 = 0; r0 < S; r0 += round) {
    const int t0 = r0 + warp * L;
    float na[L], nb[L];
    load_chunk<T>(na, nb, pa, pb, t0 + round, S, C, ok);
    // local recurrence from 0 and the running product; la becomes P_t and
    // bx h_local_t
    float prod = 1.f, hl = 0.f;
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const float a = expf(la[u]);
      hl = fmaf(a, hl, bx[u]);
      prod *= a;
      la[u] = prod;
      bx[u] = hl;
    }
    p_end[warp][lane] = prod;
    h_end[warp][lane] = hl;
    __syncthreads();
    if (warp == 0) {
      float hs = carry;
#pragma unroll 4
      for (int k = 0; k < nw; ++k) {
        h_start[k][lane] = hs;
        hs = fmaf(p_end[k][lane], hs, h_end[k][lane]);
      }
      carry = hs;
    }
    __syncthreads();
    const float hs = h_start[warp][lane];
#pragma unroll
    for (int u = 0; u < L; ++u)
      if (ok && t0 + u < S)
        store(py + (size_t)(t0 + u) * C, fmaf(la[u], hs, bx[u]));
#pragma unroll
    for (int u = 0; u < L; ++u) {
      la[u] = na[u];
      bx[u] = nb[u];
    }
  }
  if (warp == 0 && ok) h_last[(size_t)bi * C + c] = carry;
}

template <typename T>
cudaError_t launch(const void* log_a, const void* b, const float* h0,
                   void* y, float* h_last, int B, int S, int C,
                   cudaStream_t stream) {
  // a short sequence takes fewer chunks a round, so no warp is idle
  const int warps = min(WARPS, (S + L - 1) / L);
  const dim3 grid((C + 31) / 32, B);
  rglru_fwd<T><<<grid, 32 * warps, 0, stream>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(b), h0,
      static_cast<T*>(y), h_last, S, C);
  return cudaGetLastError();
}

}  // namespace

// log_a, b, y: (B, S, C), contiguous, of one dtype (0 = float32,
// 1 = bfloat16); h0 (may be null) and h_last: (B, C) float32. Launches on
// ``stream``, allocates nothing, and returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_rglru_scan(const void* log_a, const void* b,
                                const void* h0, void* y, void* h_last,
                                int dtype, int B, int S, int C,
                                void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (dtype == 0)
    return (int)launch<float>(log_a, b, h0f, y, hl, B, S, C, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(log_a, b, h0f, y, hl, B, S, C, st);
  return (int)cudaErrorInvalidValue;
}
