// Grouped (per-expert) matmul for Hopper (sm_90a): out[e] = x[e] @ w[e]
// over MoE capacity buffers, with rows >= counts[e] written as zeros.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/moe_gmm/moe_gmm.py:51 moe_gmm (_gmm_kernel,
//   pl.pallas_call at :68), wrapper src/repro/kernels/moe_gmm/ops.py
//   grouped_matmul.
// It computes what _gmm_kernel computes, not block for block: one thread
// block per (F tile, C tile, expert) with a loop over D tiles inside the
// block (the loop replaces the TPU's sequential "arbitrary" di grid axis
// and its VMEM accumulator: the sum lives in registers, in f32); the
// block reads counts[e] from device memory itself (the TPU kernel's scalar
// prefetch); output rows >= counts[e] are written as zeros. A block whose
// first row is at or past counts[e] writes its zero tile and returns
// without reading x or w (the Pallas kernel's pl.when(row_start < count)).
// Unlike the Pallas kernel, the ragged edges are masked here, so C, D and
// F need not be multiples of the tile.
//
// What bounds it on this card (olmoe-1b-7b: E 64, d_model 2048, expert
// d_ff 1024, bf16). Each launch's weights are 64 x 2048 x 1024 x 2 B =
// 268 MB. Decode (4 slots, top-8: C = 8, at most 32 experts with a row):
// the work is 2 x 32 x 2048 x 1024 = 0.13 GFLOP against the active
// experts' 134 MB, 0.040 ms at 3.35 TB/s: bound by bytes. Prefill of 1024
// tokens (C = 160): 2 x 8192 x 2048 x 1024 = 34 GFLOP, 0.035 ms at
// 989 TFLOP/s, against 268 MB, 0.080 ms: bound by bytes too. What the
// design does about the bound: experts (and C tiles) with no rows are
// skipped without reading their weights; each w tile is read once per C
// tile, and the C tile is as tall as the buffer needs (8, 16, 32 or 64
// rows), so decode reads each active expert's weights once; loads are 16
// bytes a thread where the strides allow it, and the next D tile is
// fetched into registers while the current one is computed (32 deep, 64
// for C tiles of 8 and 16 rows). Only threads that own a row below
// counts[e] do arithmetic. This first version does the products as f32
// FMA out of shared memory (bf16 is widened on load), so at prefill it is
// bound by the FMA rate, far from the bytes bound; tensor cores (mma.sync
// / wgmma), TMA and a fused gate/up launch are later work.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/moe_gmm/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int BF = 128;  // output columns per block

// elements of T in one 16-byte load
template <typename T> struct Pack;
template <> struct Pack<float> { static constexpr int N = 4; };
template <> struct Pack<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// dst[i] = src[i] for i < n, else 0 (n may be <= 0: nothing is read). One
// 16-byte load when the pack is whole and ``vec`` says the row stride and
// base keep it aligned.
template <typename T>
__device__ __forceinline__ void load_pack(float (&dst)[Pack<T>::N],
                                          const T* src, int n, bool vec) {
  constexpr int V = Pack<T>::N;
  if (vec && n >= V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = to_f32(el[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = i < n ? to_f32(src[i]) : 0.f;
  }
}

// BC rows x BF columns of one expert's output per block, BD deep per
// stage; each thread owns TM rows (tr + TR*i) and TN columns (tc + TC*j),
// strided so that the shared-memory reads of a warp are broadcasts or hit
// distinct banks and its stores to the output are coalesced.
template <typename T, int BC, int TM, int BD>
__global__ void __launch_bounds__(NT, 2)
gmm_fwd(const T* __restrict__ x, const T* __restrict__ w,
        const int* __restrict__ counts, T* __restrict__ out, int C, int D,
        int F, int vec_x, int vec_w) {
  constexpr int V = Pack<T>::N;
  constexpr int TR = BC / TM;  // threads along rows
  constexpr int TC = NT / TR;  // threads along columns
  constexpr int TN = BF / TC;  // columns per thread
  static_assert(TR * TM == BC && TR * TC == NT && TC * TN == BF, "tiling");
  static_assert(BD % V == 0 && BF % V == 0, "packs tile the stage");
  constexpr int XP = BC * BD / V;  // packs in an x tile
  constexpr int WP = BD * BF / V;  // packs in a w tile
  constexpr int XPT = (XP + NT - 1) / NT;
  constexpr int WPT = WP / NT;
  static_assert(WP % NT == 0, "w packs per thread");

  __shared__ float Xs[BC][BD + 1];                // padded: no bank conflicts
  __shared__ __align__(16) float Ws[BD][BF];

  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BC;
  const int col0 = blockIdx.x * BF;
  const int count = max(0, min(counts[e], C));
  T* op = out + (size_t)e * C * F;

  if (row0 >= count) {  // no row of this tile is in use: zeros, no reads
    for (int i = tid; i < BC * BF; i += NT) {
      const int r = row0 + i / BF, c = col0 + i % BF;
      if (r < C && c < F) store(op + (size_t)r * F + c, 0.f);
    }
    return;
  }

  const T* xp = x + (size_t)e * C * D;
  const T* wp = w + (size_t)e * D * F;
  const int nrows = min(BC, count - row0);  // rows in use, >= 1
  const int tr = tid / TC, tc = tid % TC;
  const bool active = tr < nrows;  // owns a row in use (its first is tr)

  float xr[XPT][V], wr[WPT][V];  // the next stage, staged in registers
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int q = tid + j * NT;
      if (q < XP) {
        const int r = q / (BD / V), kc = (q % (BD / V)) * V;
        const int n = r < nrows ? D - (k0 + kc) : 0;  // rows not in use: 0
        load_pack<T>(xr[j], xp + (size_t)(row0 + r) * D + k0 + kc, n,
                     vec_x);
      }
    }
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int q = tid + j * NT;
      const int k = q / (BF / V), fc = (q % (BF / V)) * V;
      const int n = k0 + k < D ? F - (col0 + fc) : 0;
      load_pack<T>(wr[j], wp + (size_t)(k0 + k) * F + col0 + fc, n, vec_w);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int q = tid + j * NT;
      if (q < XP) {
        const int r = q / (BD / V), kc = (q % (BD / V)) * V;
#pragma unroll
        for (int i = 0; i < V; ++i) Xs[r][kc + i] = xr[j][i];
      }
    }
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int q = tid + j * NT;
      const int k = q / (BF / V), fc = (q % (BF / V)) * V;
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(&Ws[k][fc + i]) =
            make_float4(wr[j][i], wr[j][i + 1], wr[j][i + 2], wr[j][i + 3]);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < D; k0 += BD) {
    stash();
    __syncthreads();
    if (k0 + BD < D) fetch(k0 + BD);  // in flight during this stage's math
    if (active) {
#pragma unroll 8
      for (int kk = 0; kk < BD; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Xs[tr + TR * i][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Ws[kk][tc + TC * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // Xs and Ws are free for the next stage
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + tr + TR * i;
    if (r >= C) continue;
    const bool in_use = r < count;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tc + TC * j;
      if (c < F) store(op + (size_t)r * F + c, in_use ? acc[i][j] : 0.f);
    }
  }
}

template <typename T, int BC, int TM, int BD>
cudaError_t launch(const void* x, const void* w, const int* counts, void* out,
                   int E, int C, int D, int F, int vec_x, int vec_w,
                   cudaStream_t stream) {
  const dim3 grid((F + BF - 1) / BF, (C + BC - 1) / BC, E);
  gmm_fwd<T, BC, TM, BD><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), counts,
      static_cast<T*>(out), C, D, F, vec_x, vec_w);
  return cudaGetLastError();
}

// The C tile is as tall as the buffer needs, up to 64 rows: decode's
// C = 8 reads each active expert's weights once, with one row per warp.
// Short tiles do little arithmetic per weight byte, so they take deeper
// stages: more bytes in flight per block.
template <typename T>
cudaError_t dispatch_c(const void* x, const void* w, const int* counts,
                       void* out, int E, int C, int D, int F,
                       cudaStream_t stream) {
  constexpr int V = Pack<T>::N;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w)) % 16) == 0;
  const int vec_x = aligned && D % V == 0;
  const int vec_w = aligned && F % V == 0;
  if (C <= 8) return launch<T, 8, 1, 64>(x, w, counts, out, E, C, D, F, vec_x, vec_w, stream);
  if (C <= 16) return launch<T, 16, 1, 64>(x, w, counts, out, E, C, D, F, vec_x, vec_w, stream);
  if (C <= 32) return launch<T, 32, 2, 32>(x, w, counts, out, E, C, D, F, vec_x, vec_w, stream);
  return launch<T, 64, 4, 32>(x, w, counts, out, E, C, D, F, vec_x, vec_w, stream);
}

}  // namespace

// x: (E, C, D); w: (E, D, F); counts: (E,) int32; out: (E, C, F); x, w and
// out contiguous, of one dtype (0 = float32, 1 = bfloat16). Launches on
// ``stream``, allocates nothing, and returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_moe_gmm(const void* x, const void* w, const void* counts,
                             void* out, int dtype, int E, int C, int D, int F,
                             void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      (C + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  if (dtype == 0)
    return (int)dispatch_c<float>(x, w, cnt, out, E, C, D, F, st);
  if (dtype == 1)
    return (int)dispatch_c<__nv_bfloat16>(x, w, cnt, out, E, C, D, F, st);
  return (int)cudaErrorInvalidValue;
}
