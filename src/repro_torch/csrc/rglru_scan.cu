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
// It computes what _rglru_kernel computes, not block for block. The TPU
// walks chunks of the sequence on a sequential grid axis, the (1, C) carry
// in VMEM scratch, and runs an exact sequential loop inside each chunk.
// Here the channels are independent, so one thread owns one (b, channel)
// and walks the whole sequence itself, the carry in a register: no chunk
// boundary, no carry pass, and any S (the Pallas kernel asserts
// S % chunk == 0). The masked exp(cum_i - cum_j) matrix form that the
// Pallas module's docstring describes is not used: under strong decay
// (log_a about -10.5 a step at the model's scale) it overflows.
//
// What bounds it on this card: it reads log_a and b once and writes h once
// (recurrentgemma-9b's prefill of 1024 tokens at batch 1, C 4096, f32:
// 50.3 MB, 0.015 ms at 3.35 TB/s); its operations (an exp and an FMA per
// element) are far below that. What the design does about it: a warp
// owns 32 neighbouring channels, so each step reads and writes whole
// coalesced rows; the loads of the next U steps are issued before the
// dependent FMAs of the current U (double-buffered registers), so memory
// latency overlaps the chain; exp(log_a) is off the dependent chain, which
// is one FMA a step. What it does not do yet: at batch 1 only C threads
// (32 blocks of 128 for C = 4096, on 132 SMs) walk a chain of S steps, so
// too few bytes are in flight to reach the memory rate; a chunk-parallel
// version with a carry pass is later work.
// All arithmetic and the carry are f32 (expf, not __expf); bf16 inputs are
// widened on load and h is rounded once, on store.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/rglru_scan/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;  // threads (channels) per block
constexpr int U = 8;     // steps loaded ahead of the dependent chain

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Steps t0 .. t0 + U - 1 of one channel; steps at or past S read as
// log_a = 0, b = 0 (they leave h as it is and are never stored).
template <typename T>
__device__ __forceinline__ void load_steps(float (&la)[U], float (&bx)[U],
                                           const T* __restrict__ pa,
                                           const T* __restrict__ pb, int t0,
                                           int S, int C) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    la[u] = t < S ? to_f32(pa[(size_t)t * C]) : 0.f;
    bx[u] = t < S ? to_f32(pb[(size_t)t * C]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_fwd(const T* __restrict__ log_a, const T* __restrict__ b,
          const float* __restrict__ h0, T* __restrict__ y,
          float* __restrict__ h_last, int S, int C) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= C) return;
  const size_t base = (size_t)bi * S * C + c;
  const T* pa = log_a + base;
  const T* pb = b + base;
  T* py = y + base;

  float h = h0 != nullptr ? h0[(size_t)bi * C + c] : 0.f;
  float la[U], bx[U];
  load_steps<T>(la, bx, pa, pb, 0, S, C);
  for (int t0 = 0; t0 < S; t0 += U) {
    float na[U], nb[U];
    load_steps<T>(na, nb, pa, pb, t0 + U, S, C);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = fmaf(expf(la[u]), h, bx[u]);
      if (t0 + u < S) store(py + (size_t)(t0 + u) * C, h);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      la[u] = na[u];
      bx[u] = nb[u];
    }
  }
  h_last[(size_t)bi * C + c] = h;
}

template <typename T>
cudaError_t launch(const void* log_a, const void* b, const float* h0,
                   void* y, float* h_last, int B, int S, int C,
                   cudaStream_t stream) {
  const dim3 grid((C + NT - 1) / NT, B);
  rglru_fwd<T><<<grid, NT, 0, stream>>>(
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
