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
// 989 TFLOP/s, against 268 MB, 0.080 ms: bound by bytes too, but only
// once the products run on the tensor cores. Experts (and C tiles) with
// no rows are skipped without reading their weights, and rows past
// counts[e] are never read.
//
// Two paths, split by dtype; neither falls back to the other.
//
// bf16 (the serve dtype), on the tensor cores (mma.sync m16n8k16, f32
// accumulators, operands by ldmatrix from shared tiles whose rows are
// padded by 16 bytes, so an ldmatrix's 8 row addresses hit 8 distinct
// 16-byte bank groups; x and w tiles come through a 4-stage cp.async ring
// over D, so three stages of copies are in flight while one is computed):
//  * C > 16 (prefill): 64 x 128 output tiles, 4 warps of 32 x 64, 64
//    deep a stage; x is the A operand (ldmatrix), w, stored (D, F)
//    row-major, the B operand through ldmatrix.trans; a warp loads all
//    its fragments of a stage before its products; a warp whose rows are
//    all past counts[e] skips its products. (Tiles of 128 rows, or 32
//    deep, measured slower: scripts/torch_tile_sweep.py.)
//  * C <= 16 (decode): the operands swap, out^T = w^T x^T, so the weight
//    columns fill the 16-row M side of m16n8k16 (w through ldmatrix.trans)
//    and the 8 or 16 token rows are its n side (x through ldmatrix): no
//    lane of the tensor core computes a padding row. 128 columns a block,
//    4 warps of 32, 64 deep a stage: 48 KB of weights in flight a block
//    (64 KB of ring), across the 256 blocks of decode's 32 experts in use;
//    decode is all bytes, each active expert's weights read once.
//  The C tile is staged through shared memory for 16-byte stores. Where
//  the strides or the base addresses do not keep 16-byte chunks aligned
//  (D or F not a multiple of 8), the same tiles are filled element by
//  element, and the products still run on mma.sync.
//
// f32: gmm_fwd, the FMA kernel of the first port, kept for the f32 oracle
// phases (their 1e-4 tolerance needs full-f32 products; tensor cores would
// mean TF32). Each thread owns a strided TM x TN output tile, the next D
// tile is fetched into registers while the current one is computed, the C
// tile is as tall as the buffer needs (8 to 64 rows).
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/moe_gmm/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

// ---- f32: FMA kernel (only float instantiates it) ----

constexpr int NT = 256;  // threads per block
constexpr int BF = 128;  // output columns per block

// elements of T in one 16-byte load
template <typename T> struct Pack;
template <> struct Pack<float> { static constexpr int N = 4; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---- bf16: tensor-core kernels ----

constexpr int TC_BN = 128;     // weight (output) columns per block
constexpr int TC_STAGES = 4;   // cp.async ring depth over D

// shared bytes of one ring stage: an x tile (BC x BK) and a w tile
// (BK x 128), rows padded by 8 bf16
template <int BC, int BK>
__host__ __device__ constexpr int tc_stage_elems() {
  return BC * (BK + 8) + BK * (TC_BN + 8);
}
// threads a block: 2 warps per 32 rows of the C tile (prefill), 4 over
// 128 weight columns (decode)
template <int BC, bool SWAP>
__host__ __device__ constexpr int tc_threads() {
  return SWAP ? 128 : 2 * BC;
}
template <int BC, int BK>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * TC_STAGES * tc_stage_elems<BC, BK>();
}

// One ring stage: x rows [0, nrows) of the block (later rows zero) and
// depth [k0, k0 + BK) into Xs; w rows [k0, k0 + BK), columns [col0, col0 +
// 128) into Ws; past D and F zero. 16-byte cp.async where ``vec_*`` says
// the chunks stay aligned, else element by element.
template <int BC, int BK, int NTH>
__device__ __forceinline__ void tc_load_stage(
    __nv_bfloat16* Xs, __nv_bfloat16* Ws, const __nv_bfloat16* xp,
    const __nv_bfloat16* wp, int k0, int nrows, int D, int F, int col0,
    bool vec_x, bool vec_w) {
  constexpr int XS = BK + 8, WS = TC_BN + 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec_x) {
    for (int i = threadIdx.x; i < BC * BK / 8; i += NTH) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = r < nrows && k0 + c < D;
      tc::cp_async16(Xs + r * XS + c, ok ? xp + (size_t)r * D + k0 + c : xp,
                     ok);
    }
  } else {
    for (int i = threadIdx.x; i < BC * BK; i += NTH) {
      const int r = i / BK, c = i % BK;
      Xs[r * XS + c] =
          r < nrows && k0 + c < D ? xp[(size_t)r * D + k0 + c] : zero;
    }
  }
  if (vec_w) {
    for (int i = threadIdx.x; i < BK * TC_BN / 8; i += NTH) {
      const int r = i / (TC_BN / 8), c = (i % (TC_BN / 8)) * 8;
      const bool ok = k0 + r < D && col0 + c < F;
      tc::cp_async16(Ws + r * WS + c,
                     ok ? wp + (size_t)(k0 + r) * F + col0 + c : wp, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BK * TC_BN; i += NTH) {
      const int r = i / TC_BN, c = i % TC_BN;
      Ws[r * WS + c] = k0 + r < D && col0 + c < F
                           ? wp[(size_t)(k0 + r) * F + col0 + c]
                           : zero;
    }
  }
}

// BC token rows x 128 weight columns of one expert's output per block, BK
// deep a stage. SWAP false: warps (BC / 32) x 2 over the tile, each 32
// rows (two m16 tiles of x) x 64 columns (eight n8 tiles of w); a warp
// whose rows are all past counts[e] skips the products. SWAP true: each
// warp 32 weight columns (two m16 tiles of w^T) x BC token rows (BC / 8
// n8 tiles of x^T).
template <int BC, int BK, bool SWAP>
__global__ void __launch_bounds__(tc_threads<BC, SWAP>(), SWAP ? 2 : 1)
gmm_tc(const __nv_bfloat16* __restrict__ x,
       const __nv_bfloat16* __restrict__ w, const int* __restrict__ counts,
       __nv_bfloat16* __restrict__ out, int C, int D, int F, int vec_x,
       int vec_w, int vec_o) {
  constexpr int XS = BK + 8, WS = TC_BN + 8, OS = TC_BN + 8;
  constexpr int MI = 2;                     // m16 tiles a warp
  constexpr int NI = SWAP ? BC / 8 : 8;     // n8 tiles a warp
  constexpr int NTH = tc_threads<BC, SWAP>();
  static_assert(SWAP ? (BC % 8 == 0 && BC <= 16) : BC % 32 == 0, "tiling");
  static_assert(BK % 16 == 0 && BC * OS <= TC_STAGES *
                tc_stage_elems<BC, BK>(), "the C tile fits in the ring");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BC;
  const int col0 = blockIdx.x * TC_BN;
  const int count = max(0, min(counts[e], C));
  __nv_bfloat16* op = out + (size_t)e * C * F;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  if (row0 >= count) {  // no row of this tile is in use: zeros, no reads
    for (int i = threadIdx.x; i < BC * TC_BN; i += NTH) {
      const int r = row0 + i / TC_BN, c = col0 + i % TC_BN;
      if (r < C && c < F) op[(size_t)r * F + c] = zero;
    }
    return;
  }

  const __nv_bfloat16* xp = x + ((size_t)e * C + row0) * D;
  const __nv_bfloat16* wp = w + (size_t)e * D * F;
  const int nrows = min(BC, count - row0);  // rows in use, >= 1
  auto Xs = [&](int st) { return ring + st * tc_stage_elems<BC, BK>(); };
  auto Ws = [&](int st) { return Xs(st) + BC * XS; };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int nk = (D + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nk)
      tc_load_stage<BC, BK, NTH>(Xs(s), Ws(s), xp, wp, s * BK, nrows, D, F,
                                 col0, vec_x, vec_w);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<TC_STAGES - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread; stage kt - 1 is free
    const int nx = kt + TC_STAGES - 1;
    if (nx < nk)
      tc_load_stage<BC, BK, NTH>(Xs(nx % TC_STAGES), Ws(nx % TC_STAGES), xp,
                                 wp, nx * BK, nrows, D, F, col0, vec_x,
                                 vec_w);
    tc::cp_async_commit();

    const __nv_bfloat16* xs = Xs(kt % TC_STAGES);
    const __nv_bfloat16* ws = Ws(kt % TC_STAGES);
    if constexpr (!SWAP) {
      const int wm = warp >> 1, wn = warp & 1;
      if (wm * 32 < nrows) {  // warp-uniform: skip a warp with no row in use
        // the stage's fragments first, then its products
        uint32_t a[BK / 16][MI][4], b[BK / 16][NI / 2][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            tc::ldsm_x4(a[kk][mi], xs + (wm * 32 + mi * 16 + (lane & 15)) *
                                            XS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < NI / 2; ++np)
            tc::ldsm_x4_t(b[kk][np], ws + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                           (lane & 7)) * WS +
                                         wn * 64 + np * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int np = 0; np < NI / 2; ++np)
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              tc::mma(acc[mi][2 * np], a[kk][mi], b[kk][np][0], b[kk][np][1]);
              tc::mma(acc[mi][2 * np + 1], a[kk][mi], b[kk][np][2],
                      b[kk][np][3]);
            }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MI][4], b[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          tc::ldsm_x4_t(a[mi], ws + (kk * 16 + (lane >> 4) * 8 +
                                     (lane & 7)) * WS +
                                   warp * 32 + mi * 16 +
                                   ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          tc::ldsm_x2(b[ni], xs + (ni * 8 + (lane & 7)) * XS + kk * 16 +
                                 ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            tc::mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the C tile there

  // Os[r][c], bf16, rows past the ones in use zero
  __nv_bfloat16* Os = ring;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int r, col;
        if constexpr (!SWAP) {
          r = (warp >> 1) * 32 + mi * 16 + g + (c >> 1) * 8;
          col = (warp & 1) * 64 + ni * 8 + 2 * t + (c & 1);
        } else {
          r = ni * 8 + 2 * t + (c & 1);
          col = warp * 32 + mi * 16 + g + (c >> 1) * 8;
        }
        Os[r * OS + col] =
            r < nrows ? __float2bfloat16(acc[mi][ni][c]) : zero;
      }
  __syncthreads();
  const int rows = min(BC, C - row0);
  if (vec_o) {
    for (int i = threadIdx.x; i < BC * TC_BN / 8; i += NTH) {
      const int r = i / (TC_BN / 8), c = (i % (TC_BN / 8)) * 8;
      if (r < rows && col0 + c < F)
        *reinterpret_cast<uint4*>(op + (size_t)(row0 + r) * F + col0 + c) =
            *reinterpret_cast<const uint4*>(Os + r * OS + c);
    }
  } else {
    for (int i = threadIdx.x; i < BC * TC_BN; i += NTH) {
      const int r = i / TC_BN, c = i % TC_BN;
      if (r < rows && col0 + c < F)
        op[(size_t)(row0 + r) * F + col0 + c] = Os[r * OS + c];
    }
  }
}

template <int BC, int BK, bool SWAP>
cudaError_t launch_tc(const void* x, const void* w, const int* counts,
                      void* out, int E, int C, int D, int F, int vec_x,
                      int vec_w, int vec_o, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<BC, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      gmm_tc<BC, BK, SWAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + TC_BN - 1) / TC_BN, (C + BC - 1) / BC, E);
  gmm_tc<BC, BK, SWAP><<<grid, tc_threads<BC, SWAP>(), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), counts,
      static_cast<__nv_bfloat16*>(out), C, D, F, vec_x, vec_w, vec_o);
  return cudaGetLastError();
}

// C <= 16 (decode): the operand swap, the C tile 8 or 16 rows; otherwise
// 64-row C tiles with x as the A operand.
cudaError_t dispatch_tc(const void* x, const void* w, const int* counts,
                        void* out, int E, int C, int D, int F,
                        cudaStream_t stream) {
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec_x = al(x) && D % 8 == 0;
  const int vec_w = al(w) && F % 8 == 0;
  const int vec_o = al(out) && F % 8 == 0;
  if (C <= 8)
    return launch_tc<8, 64, true>(x, w, counts, out, E, C, D, F, vec_x, vec_w, vec_o, stream);
  if (C <= 16)
    return launch_tc<16, 64, true>(x, w, counts, out, E, C, D, F, vec_x, vec_w, vec_o, stream);
  return launch_tc<64, 64, false>(x, w, counts, out, E, C, D, F, vec_x, vec_w, vec_o, stream);
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
    return (int)dispatch_tc(x, w, cnt, out, E, C, D, F, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory, in bytes, that a block of the instantiation
// (dtype, C) launches takes (the f32 kernel's is static: 0); -1 for what
// the entry point refuses.
extern "C" int repro_moe_gmm_smem(int dtype, int C) {
  if (C <= 0 || (dtype != 0 && dtype != 1)) return -1;
  if (dtype == 0) return 0;
  if (C <= 8) return (int)tc_smem_bytes<8, 64>();
  if (C <= 16) return (int)tc_smem_bytes<16, 64>();
  return (int)tc_smem_bytes<64, 64>();
}
