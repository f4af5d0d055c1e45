// Grouped (per-expert) matmul for Hopper (sm_90a): out[e] = x[e] @ w[e]
// over MoE capacity buffers, with rows >= counts[e] written as zeros.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/moe_gmm/moe_gmm.py:51 moe_gmm (_gmm_kernel,
//   pl.pallas_call at :68), wrapper src/repro/kernels/moe_gmm/ops.py
//   grouped_matmul.
// It computes what _gmm_kernel computes, not block for block: the loop
// over D runs inside a block (it replaces the TPU's sequential
// "arbitrary" di grid axis and its VMEM accumulator: the sum lives in
// registers, in f32); a block reads counts[e] from device memory itself
// (the TPU kernel's scalar prefetch); output rows >= counts[e] are
// written as zeros, and a tile whose first row is at or past counts[e]
// writes its zeros without reading x or w (the Pallas kernel's
// pl.when(row_start < count); on the wgmma path, per cluster: a block
// with no rows in use still loads its share of the w tile its partner
// needs, and no x). Unlike the Pallas kernel, the ragged edges
// are handled here, so C, D and F need not be multiples of a tile.
//
// What bounds it on this card (olmoe-1b-7b: E 64, d_model 2048, expert
// d_ff 1024, bf16). Each launch's weights are 64 x 2048 x 1024 x 2 B =
// 268 MB. Decode (4 slots, top-8: C = 8, at most 32 experts with a row):
// 0.13 GFLOP against the active experts' 134 MB, 0.040 ms at 3.35 TB/s:
// bound by bytes. Prefill of 1024 tokens (C = 160): 34 GFLOP, 0.035 ms at
// 989 TFLOP/s, against 268 MB, 0.080 ms: bound by bytes, once the
// products run at the tensor cores' rate. Under expert parallelism (4
// experts a device, C = 2560 rows received) the same products are bound
// by operations: 43 GFLOP against 17 MB of weights.
//
// The wrapper (kernels/moe_gmm/ops.py gmm_path) picks one path a call
// from (dtype, C, D, F, alignment) and passes it in; a path that cannot
// take the call refuses it, none falls back to another.
//
// wgmma (bf16, C > 16, D and F multiples of 8, 16-byte aligned bases):
// gmm_wgmma, built from sm90.cuh. Output tiles of 128 rows x WG_BN (256)
// columns of one expert. A producer warp (setmaxnreg down to 40
// registers) keeps TMA loads in flight into a ring of WG_STAGES (4)
// stages of 48 KB (full / empty mbarriers): x through a 3D map (D, C,
// E), so a box never reads into the next expert's rows (TMA fills rows
// past C with zeros), as wgmma's K-major A operand; w in place through a
// 3D map (F, D, E), 64 columns a box, as its MN-major B operand (the
// descriptor's transpose bit: no transposed copy of w). Two consumer
// warpgroups (setmaxnreg up to 232) own 64 rows each and run
// wgmma.m64n256k16 with f32 accumulators in registers, one group of
// products in flight while the next stage is awaited; a warpgroup whose
// rows are all past counts[e] skips its products. Where an expert's rows
// take more than one M tile (C > 128: prefill's C = 160, expert
// parallelism's 2560), 2 blocks form a cluster over consecutive M tiles
// of one (expert, F tile): each loads its own x rows and half of the w
// boxes, multicast to both, so a weight tile crosses L2 once for the pair
// and the launch's weights cross HBM about once. The epilogue rounds to
// bf16 (rows past counts[e] zero) into a 128-byte-swizzled staging tile
// and TMA-stores it (rows past C and columns past F are not written).
// Grid walk: one persistent block an SM (clusters an SM pair) walking the
// tiles expert-major, F tile next, M tiles innermost, so the producer
// loads a block's next tile while its consumers store the last. Measured
// (scripts/torch_tile_sweep.py, WG_PERSISTENT): with clusters the
// persistent walk beats one block a tile (T=1024 0.1176 against 0.1220
// ms on an H100); without clusters a static walk lost, because an even
// grid gave every even block M tile 0, the one that streams w from HBM.
// ptxas serialises wgmma in code it cannot prove warp-uniform (C7518), so
// the consumers' role, rank and count are broadcast with __shfl_sync and
// one-lane arrivals and stores are predicated inside their asm.
//
// swap (bf16, C <= 16: decode; D and F multiples of 8, 16-byte aligned
// bases): gmm_swap_wgmma, built from sm90.cuh. Decode reads each active
// expert's weights once for 1 to 16 rows (olmoe on one card: 0.13 GFLOP
// against 134 MB, 0.040 ms at 3.35 TB/s): all bytes, so the design is for
// weight bytes in flight on every SM, not for the tensor cores. The
// product runs with the operands swapped, out^T = w^T x^T, so the 8 or 16
// token rows are wgmma's N (m64n8k16 or m64n16k16) and no lane computes a
// padding row: w through the 3D map (F, D, E) in 64 x 64 boxes, read in
// place as wgmma's MN-major A (the descriptor's transpose bit), x through
// the 3D map (D, C, E) as its K-major B (TMA fills rows past C with
// zeros). A tile is 128 columns of one expert: two consumer warpgroups of
// 64 columns, one producer warp keeping a ring of SW_STAGES (4) stages of
// 18 KB in flight (full / empty mbarriers), two blocks an SM. Where E x
// tiles leaves SMs idle (expert parallelism: 4 experts a device, 32 or 64
// tiles), ops.py gmm_splits makes the ``splits`` blocks of a tile a
// cluster along D, each streaming 1 / splits of the tile's weights. Rank
// r sums 128 / splits columns: each block sends each peer its f32 partial
// of the peer's columns with st.async into the peer's shared memory,
// completing on the peer's receive mbarrier, and the owner adds the
// partials in rank order (deterministic: no atomics, no workspace, one
// launch) and stores them rounded to bf16 with 16-byte stores. A block
// whose expert has no row in use writes its zeros without loading.
// Measured on an H100 80GB HBM3 at 700 W (scripts/torch_gmm_times.py and
// torch_tile_sweep.py --kernels swap, CUDA-graph device time; PERF.md
// §6): one card's decode gate/up / down 0.0476-0.0483 ms, 84-85% of the
// bound (the mma.sync tile before it: 0.0518-0.0540); EP 16's C = 16
// gate/up 0.0066 (splits 4; the mma.sync tile: 0.0233-0.0241),
// torch.bmm 0.0051-0.0052: the partials' exchange (1.2 us: without it
// 0.0054) and the prologue before the first load (counts[e], the
// barriers) stay above bmm's whole call. Pulling the partials through
// ld.shared::cluster between two cluster barriers took 0.0077; a ring
// of more than 5 stages (one block an SM) leaves clusters of 4 unable
// to co-schedule all of EP gate/up's 32 tiles (0.0118).
//
// fill (bf16, shapes TMA cannot address: D or F not a multiple of 8, or a
// base off 16 bytes, which no model has): gmm_tc, mma.sync m16n8k16 with
// the operands swapped (w through ldmatrix.trans, x through ldmatrix), 8
// or 16 token rows a tile, 128 columns a block, 4 warps, a 4-stage
// cp.async ring 64 deep, the tiles filled element by element where the
// strides or bases do not keep 16-byte chunks aligned; C > 16 runs as
// 16-row tiles of the same kernel. Shared tiles are padded by 16 bytes a
// row, so an ldmatrix's 8 row addresses hit 8 distinct bank groups; the
// C tile is staged through shared memory for 16-byte stores.
//
// tf32x3 (f32, D and F multiples of 4, 16-byte aligned bases: every f32
// call of a model): gmm_tf32x3, built from sm90.cuh. The f32 oracle phases
// hold the port to 1e-4, and wgmma's tf32 form drops an f32's low 13
// mantissa bits (about three digits), so each operand is split a = hi +
// lo, hi = tf32(a), lo = tf32(a - hi) (cvt.rna), and a b is taken as hi hi
// + hi lo + lo hi in f32 accumulators: within about 2^-21 of |a b|, as
// ssd_scan.cu and flash's f32 path do. tf32 wgmma takes K-major operands
// only, and w is (E, D, F) with F contiguous, so the product runs with the
// operands swapped at every C, out^T = w^T x^T: w^T is the A operand from
// registers, each consumer thread reading its m64k8 fragment straight from
// the raw 128-byte-swizzled TMA box of w (32 columns x 32 D rows; a
// warp's 16 rows are spread over the box's chunks so that a fragment load
// hits 32 distinct banks) and splitting it in registers; x (D contiguous)
// is the K-major B operand, split once a stage by three splitter warps
// into a hi plane over the raw tile and a lo plane beside it. That keeps
// the 64-row operand off shared memory, which bounds flash's f32 kernel. A
// tile is 128 columns of one expert (two consumer warpgroups of 64) x 8,
// 16, 64 or 128 token rows (wgmma's N; a tile of 64 or 128 rows with
// fewer rows in use takes N = 32 or 64), D in stages of 32 through a TMA
// ring fed by one producer thread (setmaxnreg: consumers 232 / 96,
// producer and splitters 40). Decode (C <= 16) is all bytes: two blocks an
// SM, TF_ST_DECODE stages each, and where E x tiles leaves SMs idle (EP:
// 4 experts) the D sum splits over a cluster as on the swap path
// (ops.py gmm_splits, partials through st.async, added in rank order).
// Prefill (C > 16) is bound by the split-TF32 products: one block an SM,
// the accumulators stored straight to out (rows past counts[e] zero). A
// tile with no row in use writes its zeros without loading. Measured on
// an H100 80GB HBM3 at 700 W (scripts/torch_gmm_times.py, CUDA-graph
// device time; PERF.md §6): one card's decode 0.093-0.095 ms against the
// FMA kernel's 0.090-0.092 (86% of the bytes bound), the T=1024 prefill
// 0.44-0.46 ms (torch.bmm in f32: 1.06), EP 16's all-to-all buffer 0.41
// (bmm 1.01-1.02), its replicated decode at C = 16 0.018 (bmm 0.039).
//
// fma (f32 shapes TMA cannot address, which no model has): gmm_fwd, the
// FMA kernel of the first port. Each thread owns a strided TM x TN output
// tile, the next D tile is fetched into registers while the current one is
// computed, the C tile is as tall as the buffer needs (8 to 64 rows).
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/moe_gmm/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
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

// ---- bf16, the fill: mma.sync with the operands swapped ----

constexpr int TC_BN = 128;     // weight (output) columns per block
constexpr int TC_STAGES = 4;   // cp.async ring depth over D
constexpr int TC_THREADS = 128;

// shared bytes of one ring stage: an x tile (BC x BK) and a w tile
// (BK x 128), rows padded by 8 bf16
template <int BC, int BK>
__host__ __device__ constexpr int tc_stage_elems() {
  return BC * (BK + 8) + BK * (TC_BN + 8);
}
template <int BC, int BK>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * TC_STAGES * tc_stage_elems<BC, BK>();
}

// One ring stage: x rows [0, nrows) of the block (later rows zero) and
// depth [k0, k0 + BK) into Xs; w rows [k0, k0 + BK), columns [col0, col0 +
// 128) into Ws; past D and F zero. 16-byte cp.async where ``vec_*`` says
// the chunks stay aligned, else element by element.
template <int BC, int BK>
__device__ __forceinline__ void tc_load_stage(
    __nv_bfloat16* Xs, __nv_bfloat16* Ws, const __nv_bfloat16* xp,
    const __nv_bfloat16* wp, int k0, int nrows, int D, int F, int col0,
    bool vec_x, bool vec_w) {
  constexpr int XS = BK + 8, WS = TC_BN + 8, NTH = TC_THREADS;
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
// deep a stage: each warp 32 weight columns (two m16 tiles of w^T) x BC
// token rows (BC / 8 n8 tiles of x^T).
template <int BC, int BK>
__global__ void __launch_bounds__(TC_THREADS, 2)
gmm_tc(const __nv_bfloat16* __restrict__ x,
       const __nv_bfloat16* __restrict__ w, const int* __restrict__ counts,
       __nv_bfloat16* __restrict__ out, int C, int D, int F, int vec_x,
       int vec_w, int vec_o) {
  constexpr int XS = BK + 8, WS = TC_BN + 8, OS = TC_BN + 8;
  constexpr int MI = 2;        // m16 tiles a warp
  constexpr int NI = BC / 8;   // n8 tiles a warp
  constexpr int NTH = TC_THREADS;
  static_assert(BC % 8 == 0 && BC <= 16, "tiling");
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
      tc_load_stage<BC, BK>(Xs(s), Ws(s), xp, wp, s * BK, nrows, D, F, col0,
                            vec_x, vec_w);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<TC_STAGES - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread; stage kt - 1 is free
    const int nx = kt + TC_STAGES - 1;
    if (nx < nk)
      tc_load_stage<BC, BK>(Xs(nx % TC_STAGES), Ws(nx % TC_STAGES), xp, wp,
                            nx * BK, nrows, D, F, col0, vec_x, vec_w);
    tc::cp_async_commit();

    const __nv_bfloat16* xs = Xs(kt % TC_STAGES);
    const __nv_bfloat16* ws = Ws(kt % TC_STAGES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        tc::ldsm_x4_t(a[mi], ws + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                      WS +
                                  warp * 32 + mi * 16 + ((lane >> 3) & 1) * 8);
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
        const int r = ni * 8 + 2 * t + (c & 1);
        const int col = warp * 32 + mi * 16 + g + (c >> 1) * 8;
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

template <int BC, int BK>
cudaError_t launch_tc(const void* x, const void* w, const int* counts,
                      void* out, int E, int C, int D, int F,
                      cudaStream_t stream) {
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec_x = al(x) && D % 8 == 0;
  const int vec_w = al(w) && F % 8 == 0;
  const int vec_o = al(out) && F % 8 == 0;
  constexpr size_t smem = tc_smem_bytes<BC, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      gmm_tc<BC, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + TC_BN - 1) / TC_BN, (C + BC - 1) / BC, E);
  gmm_tc<BC, BK><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), counts,
      static_cast<__nv_bfloat16*>(out), C, D, F, vec_x, vec_w, vec_o);
  return cudaGetLastError();
}

// ---- bf16, C > 16: wgmma fed by TMA ----

constexpr int WG_BM = 128;      // output rows a tile: two warpgroups of 64
constexpr int WG_BN = 256;      // output columns a tile (128 or 256)
constexpr int WG_BK = 64;       // depth a stage: one 128-byte swizzle row
constexpr int WG_STAGES = 4;    // TMA ring depth
constexpr int WG_OBOXES = 2;    // 64-column boxes a warpgroup stages a store
constexpr bool WG_PERSISTENT = true;  // a block an SM; else one a tile
constexpr int WG_THREADS = 384; // consumer warpgroups 0 and 1, producer 2
constexpr int WG_BOX = 64;      // columns of a w / out box (128 bytes)

template <int BN>
struct WgLayout {  // byte offsets in the 1024-byte aligned dynamic smem
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;     // x stage: 16 KB
  static constexpr int BOX_BYTES = WG_BOX * 64 * 2;     // a 64 x 64 box
  static constexpr int B_BYTES = BN / WG_BOX * BOX_BYTES;
  static constexpr int OBOXES = WG_OBOXES < BN / WG_BOX ? WG_OBOXES
                                                        : BN / WG_BOX;
  static constexpr int O_BYTES = OBOXES * BOX_BYTES;    // a warpgroup's
  static constexpr int A0 = 0;
  static constexpr int B0 = A0 + WG_STAGES * A_BYTES;
  static constexpr int O0 = B0 + WG_STAGES * B_BYTES;
  static constexpr int BAR0 = O0 + 2 * O_BYTES;
  static constexpr int BYTES = BAR0 + 2 * WG_STAGES * 8;
  static constexpr int SMEM = BYTES + 1024;             // + the alignment
  static_assert(BN % WG_BOX == 0 && (BN == 128 || BN == 256), "WG_BN");
  static_assert(BN / WG_BOX % OBOXES == 0, "WG_OBOXES");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128)
    sm90::wgmma_m64n128k16<0, 1>(acc, da, db);
  else
    sm90::wgmma_m64n256k16<0, 1>(acc, da, db);
}

// out[e] rows [m0, m0 + 128) x columns [n0, n0 + BN) a block. CL blocks
// (a cluster) take the CL consecutive M tiles of one (expert, F tile):
// each loads its own x rows and 1 / CL of the w boxes, multicast to all
// CL, so the weight tile crosses L2 once for the cluster. Clusters in the
// order (e, F tile, M tiles), M fastest; cluster c takes tiles c, c +
// clusters, .. (one each on a plain grid).
template <int BN, int CL>
__global__ void __launch_bounds__(WG_THREADS, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap map_x,
          const __grid_constant__ CUtensorMap map_w,
          const __grid_constant__ CUtensorMap map_o,
          const int* __restrict__ counts, int E, int C, int D, int F) {
  using L = WgLayout<BN>;
  static_assert(CL == 1 || CL == 2, "cluster");
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem =
      smem_wg + ((1024 - (sm90::smem_u32(smem_wg) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR0);
  uint64_t* empty = full + WG_STAGES;

  // warp-uniform to the compiler (broadcast from lane 0), so that the
  // branches around the wgmma are too
  const int rank =
      CL == 1 ? 0 : __shfl_sync(0xffffffffu, (int)sm90::cluster_rank(), 0);
  const int n_mc = ((C + WG_BM - 1) / WG_BM + CL - 1) / CL;  // M tiles / CL
  const int n_n = (F + BN - 1) / BN;
  const int tiles = E * n_n * n_mc;
  const int nk = (D + WG_BK - 1) / WG_BK;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);        // the producer's expect_tx
      sm90::mbar_init(&empty[s], 8 * CL);  // each consumer warp, each block
    }
    sm90::fence_barrier_init();
  }
  if constexpr (CL == 1)
    __syncthreads();
  else
    sm90::cluster_sync();  // the peers' barriers exist before any multicast

  if (wg == 2) {  // ---- producer: one thread issues every load ----
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      sm90::prefetch_tensor_map(&map_x);
      sm90::prefetch_tensor_map(&map_w);
      int stage = 0;
      uint32_t phase = 1;  // the ring starts empty: the first waits pass
      for (int t = blockIdx.x / CL; t < tiles; t += gridDim.x / CL) {
        const int e = t / (n_n * n_mc), n0 = (t / n_mc) % n_n * BN;
        const int mc = t % n_mc * CL * WG_BM;  // the cluster's first row
        const int m0 = mc + rank * WG_BM;
        const int count = max(0, min(counts[e], C));
        if (mc >= count) continue;  // zeros in every block: no loads
        const bool rows = m0 < count;  // this block's x rows are in use
        // boxes of w past F are not loaded (their columns are not stored)
        const int boxes = min(BN / WG_BOX, (F - n0 + WG_BOX - 1) / WG_BOX);
        for (int kt = 0; kt < nk; ++kt) {
          sm90::mbar_wait(&empty[stage], phase);
          sm90::mbar_arrive_expect_tx(
              &full[stage], (rows ? L::A_BYTES : 0) + boxes * L::BOX_BYTES);
          if (rows)
            sm90::tma_load_3d(smem + L::A0 + stage * L::A_BYTES, &map_x,
                              &full[stage], kt * WG_BK, m0, e);
          for (int b = rank; b < boxes; b += CL) {
            unsigned char* dst =
                smem + L::B0 + stage * L::B_BYTES + b * L::BOX_BYTES;
            if constexpr (CL == 1)
              sm90::tma_load_3d(dst, &map_w, &full[stage], n0 + b * WG_BOX,
                                kt * WG_BK, e);
            else
              sm90::tma_load_3d_multicast(dst, &map_w, &full[stage],
                                          (1 << CL) - 1, n0 + b * WG_BOX,
                                          kt * WG_BK, e);
          }
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // stay until every stage loaded has been released by the consumers
      // of all CL blocks: their arrivals land in this block's barriers
      for (int s = 0; s < WG_STAGES; ++s) {
        sm90::mbar_wait(&empty[stage], phase);
        if (++stage == WG_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // ---- consumers: warpgroups 0 and 1, 64 rows each ----
    sm90::setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const bool leader = tid == 0, warp_leader = lane == 0;
    unsigned char* stage_o = smem + L::O0 + wg * L::O_BYTES;
    // a stage is free once each consumer warp of each block has left it
    auto release = [&](int s, bool pred) {
      if constexpr (CL == 1)
        sm90::mbar_arrive(&empty[s], warp_leader && pred);
      else
        for (int c = 0; c < CL; ++c)
          sm90::mbar_arrive_cluster(&empty[s], c, warp_leader && pred);
    };
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (int t = blockIdx.x / CL; t < tiles; t += gridDim.x / CL) {
      const int e = t / (n_n * n_mc), n0 = (t / n_mc) % n_n * BN;
      const int mc = t % n_mc * CL * WG_BM;
      const int count =
          __shfl_sync(0xffffffffu, max(0, min(counts[e], C)), 0);
      const int r0 = mc + rank * WG_BM + wg * 64;  // this warpgroup's rows
      const bool active = r0 < count;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      if (mc < count && active) {  // the producers load this tile
        sm90::fence_operands(acc);
        for (int kt = 0, prev = 0; kt < nk; ++kt) {
          sm90::mbar_wait(&full[stage], phase);
          const uint32_t a = sm90::smem_u32(smem + L::A0 +
                                            stage * L::A_BYTES) + wg * 8192;
          const uint32_t b = sm90::smem_u32(smem + L::B0 +
                                            stage * L::B_BYTES);
          const uint64_t da = sm90::desc_sw128(a, 16, 1024);
          const uint64_t db = sm90::desc_sw128(b, L::BOX_BYTES, 1024);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < WG_BK / 16; ++kk)  // +32 B / +2048 B a k16
            wgmma_tile<BN>(acc, da + 2 * kk, db + 128 * kk);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the previous stage's products are done
          release(prev, kt > 0);
          prev = stage;
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_operands(acc);
        release((stage + WG_STAGES - 1) % WG_STAGES, true);
      } else if (mc < count) {  // loaded, but no row of ours is in use
        for (int kt = 0; kt < nk; ++kt) {
          sm90::mbar_wait(&full[stage], phase);
          release(stage, true);
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      if (r0 >= C) continue;  // no row of this warpgroup exists
      // acc[4j + 2h + i]: row 16 warp + lane / 4 + 8 h, column 8 j + 2
      // (lane % 4) + i, in box j / 8 of the tile; staged OBOXES boxes at a
      // time, 128-byte rows, chunk j % 8 ^ row % 8
#pragma unroll
      for (int b0 = 0; b0 < BN / WG_BOX; b0 += L::OBOXES) {
        if (n0 + b0 * WG_BOX >= F) continue;  // these boxes hold no column
        // the staging tile is free once the last store has read it
        sm90::tma_store_wait_read<0>(leader);
        sm90::named_barrier_sync(1 + wg, 128);
#pragma unroll
        for (int j = b0 * 8; j < (b0 + L::OBOXES) * 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + lane / 4 + 8 * h;
            const bool keep = active && r0 + r < count;
            const uint32_t v = tc::pack_bf16(
                keep ? acc[4 * j + 2 * h] : 0.f,
                keep ? acc[4 * j + 2 * h + 1] : 0.f);
            *reinterpret_cast<uint32_t*>(
                stage_o + (j / 8 - b0) * L::BOX_BYTES + r * 128 +
                (((j % 8) ^ (r % 8)) << 4) + (lane % 4) * 4) = v;
          }
        sm90::fence_async_shared();
        sm90::named_barrier_sync(1 + wg, 128);
#pragma unroll
        for (int b = b0; b < b0 + L::OBOXES; ++b)
          sm90::tma_store_3d(&map_o, stage_o + (b - b0) * L::BOX_BYTES,
                             n0 + b * WG_BOX, r0, e,
                             leader && n0 + b * WG_BOX < F);
        sm90::tma_store_commit(leader);
      }
    }
    sm90::tma_store_wait<0>(leader);
  }
}

template <int CL>
cudaError_t launch_wgmma_cl(const CUtensorMap& mx, const CUtensorMap& mw,
                            const CUtensorMap& mo, const int* counts, int E,
                            int C, int D, int F, cudaStream_t stream) {
  using L = WgLayout<WG_BN>;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_wgmma<WG_BN, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long clusters = (long long)E *
                             (((C + WG_BM - 1) / WG_BM + CL - 1) / CL) *
                             ((F + WG_BN - 1) / WG_BN);
  if (clusters * CL > 0x7fffffff) return cudaErrorInvalidValue;
  const long long most = sms / CL;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(
      (unsigned)(CL * (WG_PERSISTENT && clusters > most ? most : clusters)));
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<CUtensorMap*>(&mx),
                  const_cast<CUtensorMap*>(&mw),
                  const_cast<CUtensorMap*>(&mo), &counts, &E, &C, &D, &F};
  err = cudaLaunchKernelExC(
      &cfg, (const void*)gmm_wgmma<WG_BN, CL>, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A cluster of 2 blocks shares each weight tile between consecutive M
// tiles where an expert's rows take more than one (C > 128).
cudaError_t launch_wgmma(const void* x, const void* w, const int* counts,
                         void* out, int E, int C, int D, int F,
                         cudaStream_t stream) {
  const uint64_t e = E, c = C, d = D, f = F;
  CUtensorMap mx, mw, mo;
  cudaError_t err = sm90::tensor_map_bf16<3>(
      &mx, x, {d, c, e}, {d * 2, c * d * 2}, {WG_BK, WG_BM, 1});
  if (err == cudaSuccess)
    err = sm90::tensor_map_bf16<3>(&mw, w, {f, d, e}, {f * 2, d * f * 2},
                                   {WG_BOX, WG_BK, 1});
  if (err == cudaSuccess)
    err = sm90::tensor_map_bf16<3>(&mo, out, {f, c, e}, {f * 2, c * f * 2},
                                   {WG_BOX, 64, 1});
  if (err != cudaSuccess) return err;
  if (C > WG_BM)
    return launch_wgmma_cl<2>(mx, mw, mo, counts, E, C, D, F, stream);
  return launch_wgmma_cl<1>(mx, mw, mo, counts, E, C, D, F, stream);
}

// ---- bf16, C <= 16: wgmma with the operands swapped, split over D ----

constexpr int SW_BN = 128;      // weight (output) columns a tile: 2 x 64
constexpr int SW_BK = 64;       // depth a stage: one 128-byte swizzle row
constexpr int SW_STAGES = 4;    // TMA ring depth: two blocks an SM
constexpr int SW_THREADS = 288; // consumer warpgroups 0 and 1, producer warp
constexpr int SW_BOX = 64;      // columns of a w box (128 bytes)
constexpr int SW_MAX_SPLITS = 8;  // blocks along D: a portable cluster

template <int BC>
struct SwLayout {  // byte offsets in the 1024-byte aligned dynamic smem
  static constexpr int BOX_BYTES = SW_BOX * SW_BK * 2;  // a 64 x 64 box
  static constexpr int W_BYTES = SW_BN / SW_BOX * BOX_BYTES;
  static constexpr int X_BYTES = BC * SW_BK * 2;        // 1 or 2 KB
  static constexpr int RS = BC + 2;  // floats a received partial column
  static constexpr int W0 = 0;
  static constexpr int X0 = W0 + SW_STAGES * W_BYTES;
  static constexpr int R0 = X0 + SW_STAGES * X_BYTES;
  static constexpr int BAR0 = R0 + SW_BN * RS * 4;
  static constexpr int BYTES = BAR0 + (2 * SW_STAGES + 1) * 8;
  static constexpr int SMEM = BYTES + 1024;             // + the alignment
  static_assert(BC == 8 || BC == 16, "a wgmma N of 8 or 16 token rows");
  static_assert(X_BYTES % 1024 == 0, "x tiles start on 1024-byte atoms");
  static_assert(SMEM <= 232448, "shared memory");
};

// D tiles [lo, hi) of rank ``rank`` of ``splits`` over ``nk`` tiles
// (kernels/moe_gmm/tiling.py split_bounds cuts D the same way)
__device__ __forceinline__ int split_lo(int rank, int splits, int nk) {
  return rank * nk / splits;
}

// out[e] rows [0, BC) (those below C) x columns [n0, n0 + 128) a cluster
// of ``splits`` blocks, block ``rank`` summing D tiles split_lo(rank) ..
// split_lo(rank + 1) of the product out^T = w^T x^T: warpgroup wg owns
// w^T rows (out columns) n0 + 64 wg .. + 64 as wgmma's A operand, read
// MN-major from the w box in place, and x^T (BC token rows, zeros past C)
// as its K-major B operand. Rank r sums columns [r sw, (r + 1) sw) of the
// tile, sw = 128 / splits: each block sends each peer its f32 partial of
// the peer's columns (st.async into the peer's shared memory, completing
// on the peer's receive barrier) and keeps its own; once its barrier has
// every peer's bytes, a rank adds the partials in rank order and stores
// them rounded to bf16.
template <int BC>
__global__ void __launch_bounds__(SW_THREADS, 1)
gmm_swap_wgmma(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               const int* __restrict__ counts,
               __nv_bfloat16* __restrict__ out, int C, int D, int F,
               int splits) {
  using L = SwLayout<BC>;
  extern __shared__ __align__(1024) unsigned char smem_sw[];
  unsigned char* smem =
      smem_sw + ((1024 - (sm90::smem_u32(smem_sw) & 1023)) & 1023);
  // recv[(p sw + c) RS + r]: rank p's partial of this rank's column c,
  // token row r
  float* recv = reinterpret_cast<float*>(smem + L::R0);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR0);
  uint64_t* empty = full + SW_STAGES;
  uint64_t* received = empty + SW_STAGES;

  // warp-uniform to the compiler (blockIdx, arguments, or broadcast from
  // lane 0), so that the branches around the wgmma are too
  const int rank = blockIdx.x % splits;  // = %cluster_ctarank
  const int n0 = blockIdx.x / splits * SW_BN;
  const int e = blockIdx.y;
  const int nk = (D + SW_BK - 1) / SW_BK;
  const int k_lo = split_lo(rank, splits, nk);
  const int k_hi = split_lo(rank + 1, splits, nk);
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int count =
      __shfl_sync(0xffffffffu, max(0, min(counts[e], C)), 0);
  const int sw = SW_BN / splits;      // columns this rank sums and stores
  const int c0 = n0 + rank * sw;      // the first of them
  const int per_row = sw / 8;         // 8-column chunks of a row
  const int rows = min(BC, C);
  __nv_bfloat16* op = out + (size_t)e * C * F;

  if (count == 0) {  // the same in every block of the cluster: zeros, no
                     // loads, nothing sent
    for (int i = threadIdx.x; i < rows * per_row; i += SW_THREADS) {
      const int r = i / per_row, col = c0 + i % per_row * 8;
      if (col < F)
        *reinterpret_cast<uint4*>(op + (size_t)r * F + col) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < SW_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);   // the producer's expect_tx
      sm90::mbar_init(&empty[s], 8);  // each consumer warp
    }
    sm90::mbar_init(received, 1);     // this thread's expect_tx
    sm90::mbar_arrive_expect_tx(received, (splits - 1) * sw * BC * 4);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  // the peers may send once every block's receive barrier is set up: the
  // wait comes after the products
  if (splits > 1) sm90::cluster_arrive_relaxed();

  if (wg == 2) {  // ---- producer: one thread issues every load ----
    if (threadIdx.x == 256) {
      sm90::prefetch_tensor_map(&map_x);
      sm90::prefetch_tensor_map(&map_w);
      // boxes of w past F are not loaded (their columns are not stored)
      const int boxes = min(SW_BN / SW_BOX, (F - n0 + SW_BOX - 1) / SW_BOX);
      int stage = 0;
      uint32_t phase = 1;  // the ring starts empty: the first waits pass
      for (int kt = k_lo; kt < k_hi; ++kt) {
        sm90::mbar_wait(&empty[stage], phase);
        sm90::mbar_arrive_expect_tx(&full[stage],
                                    L::X_BYTES + boxes * L::BOX_BYTES);
        sm90::tma_load_3d(smem + L::X0 + stage * L::X_BYTES, &map_x,
                          &full[stage], kt * SW_BK, 0, e);
        for (int b = 0; b < boxes; ++b)
          sm90::tma_load_3d(
              smem + L::W0 + stage * L::W_BYTES + b * L::BOX_BYTES, &map_w,
              &full[stage], n0 + b * SW_BOX, kt * SW_BK, e);
        if (++stage == SW_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if (splits > 1) sm90::cluster_wait();
  } else {  // ---- consumers: warpgroups 0 and 1, 64 columns each ----
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const bool warp_leader = lane == 0;
    float acc[BC / 2];
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    sm90::fence_operands(acc);
    for (int kt = k_lo, prev = 0; kt < k_hi; ++kt) {
      sm90::mbar_wait(&full[stage], phase);
      // A: the w box, MN-major (8 k rows of 64 columns an atom, k groups
      // 1024 B apart; +2048 B a k16); B: x, K-major (+32 B a k16)
      const uint64_t da = sm90::desc_sw128(
          sm90::smem_u32(smem + L::W0 + stage * L::W_BYTES +
                         wg * L::BOX_BYTES),
          L::BOX_BYTES, 1024);
      const uint64_t db = sm90::desc_sw128(
          sm90::smem_u32(smem + L::X0 + stage * L::X_BYTES), 16, 1024);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SW_BK / 16; ++kk) {
        if constexpr (BC == 8)
          sm90::wgmma_m64n8k16<1, 0>(acc, da + 128 * kk, db + 2 * kk);
        else
          sm90::wgmma_m64n16k16<1, 0>(acc, da + 128 * kk, db + 2 * kk);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous stage's products are done
      sm90::mbar_arrive(&empty[prev], warp_leader && kt > k_lo);
      prev = stage;
      if (++stage == SW_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    if (splits > 1) sm90::cluster_wait();
    // acc[4j + 2h + i]: out^T row (tile column) 64 wg + 16 warp + lane / 4
    // + 8 h, column (token row) 8 j + 2 (lane % 4) + i: token rows in
    // pairs, 8 bytes, to slot ``rank`` of the column's owner
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = wg * 64 + 16 * warp + lane / 4 + 8 * h;
      const int owner = col / sw;
      float* dst = recv + (rank * sw + col % sw) * L::RS + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
        const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
        if (owner == rank)
          *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(a, b);
        else
          sm90::st_async_f32x2(sm90::cluster_map(dst + 8 * j, owner), a, b,
                               sm90::cluster_map(received, owner));
      }
    }
  }

  __syncthreads();  // this block's own partial is in recv
  if (splits > 1) sm90::mbar_wait_cluster(received, 0);  // and the peers'
  for (int i = threadIdx.x; i < rows * per_row; i += SW_THREADS) {
    const int r = i / per_row, ch = i % per_row * 8, col = c0 + ch;
    if (col >= F) continue;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < count) {  // the ranks' partials, added in rank order
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int p = 0; p < splits; ++p) {
        const float* src = recv + (p * sw + ch) * L::RS + r;
#pragma unroll
        for (int k = 0; k < 8; ++k) s[k] += src[k * L::RS];
      }
      v = make_uint4(tc::pack_bf16(s[0], s[1]), tc::pack_bf16(s[2], s[3]),
                     tc::pack_bf16(s[4], s[5]), tc::pack_bf16(s[6], s[7]));
    }
    *reinterpret_cast<uint4*>(op + (size_t)r * F + col) = v;
  }
}

template <int BC>
cudaError_t launch_swap(const void* x, const void* w, const int* counts,
                        void* out, int E, int C, int D, int F, int splits,
                        cudaStream_t stream) {
  using L = SwLayout<BC>;
  const uint64_t e = E, c = C, d = D, f = F;
  CUtensorMap mx, mw;
  cudaError_t err = sm90::tensor_map_bf16<3>(
      &mx, x, {d, c, e}, {d * 2, c * d * 2}, {SW_BK, BC, 1});
  if (err == cudaSuccess)
    err = sm90::tensor_map_bf16<3>(&mw, w, {f, d, e}, {f * 2, d * f * 2},
                                   {SW_BOX, SW_BK, 1});
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gmm_swap_wgmma<BC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((F + SW_BN - 1) / SW_BN) * splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)E);
  cfg.blockDim = dim3(SW_THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  void* args[] = {&mx, &mw, &counts, &o, &C, &D, &F, &splits};
  err = cudaLaunchKernelExC(&cfg, (const void*)gmm_swap_wgmma<BC>, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- f32: split TF32 on wgmma with the operands swapped, fed by TMA ----

constexpr int TF_BN = 128;      // weight (output) columns a tile: 2 x 64
constexpr int TF_BK = 32;       // D a stage: one 128-byte swizzle row of f32
constexpr int TF_BOX = 32;      // columns of a w box (128 bytes)
constexpr int TF_THREADS = 384; // consumer warpgroups 0 and 1; warpgroup 2:
                                // the producer warp, three splitter warps
constexpr int TF_SPLITTERS = 96;
// token rows a tile where C > 64 (64 or 128), and the TMA ring's stages at
// C <= 16 (two blocks an SM), at 64 rows and at 128 (one block an SM); from
// scripts/torch_tile_sweep.py --kernels gmm_tf32x3
constexpr int TF_WIDE_BC = 128;
constexpr int TF_ST_DECODE = 3, TF_ST_64 = 6, TF_ST_128 = 4;

template <int BC>
struct TfLayout {  // byte offsets in the 1024-byte aligned dynamic smem
  static constexpr bool DECODE = BC <= 16;  // split over D, two blocks an SM
  static constexpr int STAGES =
      DECODE ? TF_ST_DECODE : BC == 64 ? TF_ST_64 : TF_ST_128;
  static constexpr int BOX_BYTES = TF_BOX * TF_BK * 4;  // a 32 x 32 w box
  static constexpr int W_BYTES = TF_BN / TF_BOX * BOX_BYTES;
  static constexpr int X_PLANE = BC * 128;  // BC token rows of 32 D values
  static constexpr int X_BYTES = 2 * X_PLANE;  // hi (raw x lands there), lo
  static constexpr int RS = BC + 2;  // floats a received partial column
  static constexpr int W0 = 0;
  static constexpr int X0 = W0 + STAGES * W_BYTES;
  static constexpr int R0 = X0 + STAGES * X_BYTES;
  static constexpr int BAR0 = R0 + (DECODE ? TF_BN * RS * 4 : 0);
  static constexpr int BYTES = BAR0 + (3 * STAGES + 1) * 8;
  static constexpr int SMEM = BYTES + 1024;             // + the alignment
  static constexpr int MINB = DECODE ? 2 : 1;           // blocks an SM
  // registers a thread after setmaxnreg: 128 x PRODUCER + 256 x CONSUMER
  // within what the launch bounds give the block (80 or 168 a thread)
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = DECODE ? 96 : 232;
  static_assert(BC == 8 || BC == 16 || BC == 64 || BC == 128, "token rows");
  static_assert(X_PLANE % 1024 == 0, "x planes start on 1024-byte atoms");
  static_assert(MINB * (SMEM + 1024) <= 233472, "shared memory");
};

// d (64 x N) += A (64 x 8, tf32 in registers) B (8 x N, K-major)
template <int N>
__device__ __forceinline__ void tf_mma(float (&d)[N / 2], const float (&a)[4],
                                       uint64_t db) {
  if constexpr (N == 8)
    sm90::wgmma_m64n8k8_tf32_rs(d, a, db);
  else if constexpr (N == 16)
    sm90::wgmma_m64n16k8_tf32_rs(d, a, db);
  else if constexpr (N == 32)
    sm90::wgmma_m64n32k8_tf32_rs(d, a, db);
  else if constexpr (N == 64)
    sm90::wgmma_m64n64k8_tf32_rs(d, a, db);
  else
    sm90::wgmma_m64n128k8_tf32_rs(d, a, db);
}

// a stage's products on the first N token rows of a BC-row tile (the
// first N / 2 accumulators: columns past N stay zero): each k8 slice hi hi
// + hi lo + lo hi, x's hi plane at ``dx``, its lo plane ``lo16`` further
template <int N, int BC>
__device__ __forceinline__ void tf_stage(float (&acc)[BC / 2],
                                         float (&ah)[4][4], float (&al)[4][4],
                                         uint64_t dx, int lo16) {
  static_assert(N <= BC, "token rows");
  float(&d)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // +32 B a k8 slice
    const uint64_t bh = dx + 2 * kk, bl = bh + lo16;
    tf_mma<N>(d, ah[kk], bh);
    tf_mma<N>(d, ah[kk], bl);
    tf_mma<N>(d, al[kk], bh);
  }
}

// the descriptor of an x plane at ``saddr``, opaque to the compiler, so
// that the k8 slices' descriptors (this one plus offset / 16) are formed
// where they are used and not hoisted out of the D loop
__device__ __forceinline__ uint64_t tf_desc(uint32_t saddr) {
  uint64_t d = sm90::desc_sw128(saddr, 16, 1024);
  asm volatile("" : "+l"(d));
  return d;
}

// a[i] -> hi[i] = tf32(a[i]), lo[i] = tf32(a[i] - hi[i]) (cvt.rna)
__device__ __forceinline__ void tf_split(const float (&a)[4], float (&hi)[4],
                                         float (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = sm90::to_tf32(a[i]);
    lo[i] = sm90::to_tf32(a[i] - hi[i]);
  }
}

// keeps the fragments in their registers until the products reading them
// are done (after a wgmma wait)
__device__ __forceinline__ void tf_fence(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) sm90::fence_operands(a[i]);
}

// out[e] rows [c0, c0 + BC) (those below C) x columns [n0, n0 + 128) a
// cluster of ``splits`` blocks (1 where BC > 16), block ``rank`` summing D
// tiles split_lo(rank) .. split_lo(rank + 1) of the product out^T = w^T
// x^T in split TF32. Warpgroup wg owns w^T rows (tile columns) 64 wg ..
// + 64 as wgmma's A operand from registers: each thread reads its m64k8
// fragment from the raw TMA box of w and splits it into hi and lo; x^T
// (BC token rows, zeros past C) is the K-major B operand, split once a
// stage by the splitter warps into its hi plane (over the raw tile) and
// lo plane. Each k8 slice is hi hi + hi lo + lo hi. Where BC <= 16 each
// block sends each peer its f32 partial of the peer's columns (st.async,
// as gmm_swap_wgmma does) and the owner adds them in rank order; where BC
// > 16 the accumulators are stored as they are.
template <int BC>
__global__ void __launch_bounds__(TF_THREADS, TfLayout<BC>::MINB)
gmm_tf32x3(const __grid_constant__ CUtensorMap map_x,
           const __grid_constant__ CUtensorMap map_w,
           const int* __restrict__ counts, float* __restrict__ out, int C,
           int D, int F, int splits) {
  using L = TfLayout<BC>;
  constexpr int ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_tf[];
  unsigned char* smem =
      smem_tf + ((1024 - (sm90::smem_u32(smem_tf) & 1023)) & 1023);
  // recv[(p sw + c) RS + r]: rank p's partial of this rank's column c,
  // token row r (BC <= 16)
  float* recv = reinterpret_cast<float*>(smem + L::R0);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR0);
  uint64_t* split = full + ST;   // the splitters have split x's tile
  uint64_t* empty = split + ST;
  uint64_t* received = empty + ST;

  // warp-uniform to the compiler (blockIdx, arguments, or broadcast from
  // lane 0), so that the branches around the wgmma are too
  const int rank = blockIdx.x % splits;  // = %cluster_ctarank
  const int n0 = blockIdx.x / splits * TF_BN;
  const int c0 = blockIdx.y * BC;
  const int e = blockIdx.z;
  const int nk = (D + TF_BK - 1) / TF_BK;
  const int k_lo = split_lo(rank, splits, nk);
  const int k_hi = split_lo(rank + 1, splits, nk);
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int count =
      __shfl_sync(0xffffffffu, max(0, min(counts[e], C)), 0);
  const int sw = TF_BN / splits;      // columns this rank stores
  const int cs = n0 + rank * sw;      // the first of them
  const int per_row = sw / 4;         // 4-column chunks of a row
  const int rows = min(BC, C - c0);   // rows of this tile that exist
  // token rows the products take: all BC where BC <= 16, else the rows in
  // use rounded up to 32, 64 or BC (a tile with few rows in use, as the
  // last tile of an expert often is, does less work)
  const int used = min(count, c0 + BC) - c0;
  const int nb = BC <= 16 ? BC : used <= 32 ? 32 : used <= 64 ? 64 : BC;
  float* op = out + (size_t)e * C * F;

  if (c0 >= count) {  // the same in every block of the cluster: zeros, no
                      // loads, nothing sent
    for (int i = threadIdx.x; i < rows * per_row; i += TF_THREADS) {
      const int r = c0 + i / per_row, col = cs + i % per_row * 4;
      if (col < F)
        *reinterpret_cast<float4*>(op + (size_t)r * F + col) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full[s], 1);              // the producer's expect_tx
      sm90::mbar_init(&split[s], TF_SPLITTERS);  // each splitter thread
      sm90::mbar_init(&empty[s], 8);             // each consumer warp
    }
    if constexpr (L::DECODE) {
      sm90::mbar_init(received, 1);    // this thread's expect_tx
      sm90::mbar_arrive_expect_tx(received, (splits - 1) * sw * BC * 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  // the peers may send once every block's receive barrier is set up: the
  // wait comes after the products
  if constexpr (L::DECODE)
    if (splits > 1) sm90::cluster_arrive_relaxed();

  if (wg == 2) {  // ---- the producer warp and the splitter warps ----
    sm90::setmaxnreg_dec<L::PRODUCER_REGS>();
    const int t2 = threadIdx.x - 256;
    int stage = 0;
    uint32_t phase = 0;
    if (t2 == 0) {  // one thread issues every load
      sm90::prefetch_tensor_map(&map_x);
      sm90::prefetch_tensor_map(&map_w);
      // boxes of w past F are not loaded (their columns are not stored)
      const int boxes = min(TF_BN / TF_BOX, (F - n0 + TF_BOX - 1) / TF_BOX);
      phase = 1;  // the ring starts empty: the first waits pass
      for (int kt = k_lo; kt < k_hi; ++kt) {
        sm90::mbar_wait(&empty[stage], phase);
        sm90::mbar_arrive_expect_tx(&full[stage],
                                    L::X_PLANE + boxes * L::BOX_BYTES);
        sm90::tma_load_3d(smem + L::X0 + stage * L::X_BYTES, &map_x,
                          &full[stage], kt * TF_BK, c0, e);
        for (int b = 0; b < boxes; ++b)
          sm90::tma_load_3d(
              smem + L::W0 + stage * L::W_BYTES + b * L::BOX_BYTES, &map_w,
              &full[stage], n0 + b * TF_BOX, kt * TF_BK, e);
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (t2 >= 32) {  // x's raw tile -> hi over it, lo beside it
      for (int kt = k_lo; kt < k_hi; ++kt) {
        sm90::mbar_wait(&full[stage], phase);
        unsigned char* xs = smem + L::X0 + stage * L::X_BYTES;
        for (int c = t2 - 32; c < nb * 8; c += TF_SPLITTERS) {
          const float4 v = *reinterpret_cast<const float4*>(xs + 16 * c);
          const float a[4] = {v.x, v.y, v.z, v.w};
          float hi[4], lo[4];
          tf_split(a, hi, lo);
          *reinterpret_cast<float4*>(xs + 16 * c) =
              make_float4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<float4*>(xs + L::X_PLANE + 16 * c) =
              make_float4(lo[0], lo[1], lo[2], lo[3]);
        }
        sm90::fence_async_shared();
        sm90::mbar_arrive(&split[stage]);
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if constexpr (L::DECODE)
      if (splits > 1) sm90::cluster_wait();
  } else {  // ---- consumers: warpgroups 0 and 1, 64 columns each ----
    sm90::setmaxnreg_inc<L::CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const bool warp_leader = lane == 0;
    // Row g + 8 h of the warp's 16 (of the warpgroup's 64 w^T rows) is
    // column 4 ch[h] + g % 4 of w box 2 wg + warp / 2, chunk ch[h] = 2
    // (warp % 2) + h + 4 (g / 4): the 32 lanes of a fragment load then read
    // 32 distinct banks of the swizzled box (D row t + 4 q, chunk ch ^ (t +
    // 4 q)). off[h][q]: this thread's byte offset of row g + 8 h at D row t
    // + 4 q of the stage's first k8 slice (+1024 a slice).
    int ch[2], off[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ch[h] = 2 * (warp & 1) + h + 4 * (g >> 2);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int d = t + 4 * q;
        off[h][q] = (2 * wg + warp / 2) * L::BOX_BYTES + d * 128 +
                    ((ch[h] ^ d) << 4) + (g & 3) * 4;
      }
    }
    float acc[BC / 2];
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) acc[i] = 0.f;
    // A fragments of a stage's four k8 slices, hi and lo; two sets where
    // one stage's products run while the next stage's fragments load
    float ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ah0[i][j] = al0[i][j] = ah1[i][j] = al1[i][j] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    // the products of stage ``stage``, issued and committed: its fragments
    // read and split into (ah, al), x's planes through descriptors
    auto products = [&](float (&ah)[4][4], float (&al)[4][4]) {
      sm90::mbar_wait(&full[stage], phase);
      sm90::mbar_wait(&split[stage], phase);
      const float* ws =
          reinterpret_cast<const float*>(smem + L::W0 + stage * L::W_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float a[4] = {ws[(off[0][0] + 1024 * kk) / 4],
                            ws[(off[1][0] + 1024 * kk) / 4],
                            ws[(off[0][1] + 1024 * kk) / 4],
                            ws[(off[1][1] + 1024 * kk) / 4]};
        tf_split(a, ah[kk], al[kk]);
      }
      const uint64_t dx =
          tf_desc(sm90::smem_u32(smem + L::X0 + stage * L::X_BYTES));
      constexpr int lo16 = L::X_PLANE / 16;
      sm90::wgmma_fence();
      if constexpr (BC <= 16) {
        tf_stage<BC, BC>(acc, ah, al, dx, lo16);
      } else if (nb == 32) {
        tf_stage<32, BC>(acc, ah, al, dx, lo16);
      } else if (BC == 64 || nb == 64) {
        tf_stage<64, BC>(acc, ah, al, dx, lo16);
      } else {
        if constexpr (BC == 128) tf_stage<128, BC>(acc, ah, al, dx, lo16);
      }
      sm90::wgmma_commit();
    };
    auto advance = [&] {
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    };
    sm90::fence_operands(acc);
    if constexpr (L::DECODE) {  // bytes-bound: one set of fragments, each
                                // stage's products done before the next
      for (int kt = k_lo; kt < k_hi; ++kt) {
        products(ah0, al0);
        sm90::wgmma_wait<0>();
        tf_fence(ah0);
        tf_fence(al0);
        sm90::mbar_arrive(&empty[stage], warp_leader);
        advance();
      }
    } else {
      int prev = 0;
      for (int kt = k_lo; kt < k_hi; kt += 2) {
        products(ah0, al0);
        sm90::wgmma_wait<1>();  // the previous stage's products are done
        tf_fence(ah1);
        tf_fence(al1);
        sm90::mbar_arrive(&empty[prev], warp_leader && kt > k_lo);
        prev = stage;
        advance();
        if (kt + 1 < k_hi) {
          products(ah1, al1);
          sm90::wgmma_wait<1>();
          tf_fence(ah0);
          tf_fence(al0);
          sm90::mbar_arrive(&empty[prev], warp_leader);
          prev = stage;
          advance();
        }
      }
      sm90::wgmma_wait<0>();
      tf_fence(ah0);
      tf_fence(al0);
      tf_fence(ah1);
      tf_fence(al1);
    }
    sm90::fence_operands(acc);

    // acc[4j + 2h + i]: out^T row (tile column) col(h), column (token row)
    // 8 j + 2 (lane % 4) + i of the tile
    auto col = [&](int h) {
      return 64 * wg + 32 * (warp / 2) + 4 * ch[h] + (g & 3);
    };
    if constexpr (L::DECODE) {
      if (splits > 1) sm90::cluster_wait();
      // token rows in pairs, 8 bytes, to slot ``rank`` of the column's owner
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col(h), owner = c / sw;
        float* dst = recv + (rank * sw + c % sw) * L::RS + 2 * t;
#pragma unroll
        for (int j = 0; j < BC / 8; ++j) {
          const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
          if (owner == rank)
            *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(a, b);
          else
            sm90::st_async_f32x2(sm90::cluster_map(dst + 8 * j, owner), a, b,
                                 sm90::cluster_map(received, owner));
        }
      }
      sm90::named_barrier_sync(1, 256);  // this block's partial is in recv
      if (splits > 1) sm90::mbar_wait_cluster(received, 0);  // the peers'
      for (int i = tid + 128 * wg; i < rows * per_row; i += 256) {
        const int r = i / per_row, c4 = i % per_row * 4, c = cs + c4;
        if (c >= F) continue;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < count) {  // the ranks' partials, added in rank order
          for (int p = 0; p < splits; ++p) {
            const float* src = recv + (p * sw + c4) * L::RS + r;
#pragma unroll
            for (int k = 0; k < 4; ++k) s[k] += src[k * L::RS];
          }
        }
        *reinterpret_cast<float4*>(op + (size_t)r * F + c) =
            make_float4(s[0], s[1], s[2], s[3]);
      }
    } else {  // rows past counts[e] zero; rows past C and columns past F
              // not written
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = n0 + col(h);
        if (f >= F) continue;
#pragma unroll
        for (int j = 0; j < BC / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = c0 + 8 * j + 2 * t + i;
            if (r < C)
              op[(size_t)r * F + f] = r < count ? acc[4 * j + 2 * h + i] : 0.f;
          }
      }
    }
  }
}

template <int BC>
cudaError_t launch_tf32x3(const void* x, const void* w, const int* counts,
                          void* out, int E, int C, int D, int F, int splits,
                          cudaStream_t stream) {
  using L = TfLayout<BC>;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const uint64_t e = E, c = C, d = D, f = F;
  CUtensorMap mx, mw;
  cudaError_t err = sm90::tensor_map<3>(&mx, F32, x, {d, c, e},
                                        {d * 4, c * d * 4}, {TF_BK, BC, 1});
  if (err == cudaSuccess)
    err = sm90::tensor_map<3>(&mw, F32, w, {f, d, e}, {f * 4, d * f * 4},
                              {TF_BOX, TF_BK, 1});
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gmm_tf32x3<BC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((F + TF_BN - 1) / TF_BN) * splits;
  const int c_tiles = (C + BC - 1) / BC;
  if (blocks > 0x7fffffff || c_tiles > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)c_tiles, (unsigned)E);
  cfg.blockDim = dim3(TF_THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  float* o = static_cast<float*>(out);
  void* args[] = {&mx, &mw, &counts, &o, &C, &D, &F, &splits};
  err = cudaLaunchKernelExC(&cfg, (const void*)gmm_tf32x3<BC>, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// token rows a tile of the tf32x3 path: decode's 8 or 16 (split over D),
// 64, or the wide tile
int tf_rows(int C) {
  return C <= 8 ? 8 : C <= 16 ? 16 : C <= 64 ? 64 : TF_WIDE_BC;
}

cudaError_t launch_tf(const void* x, const void* w, const int* counts,
                      void* out, int E, int C, int D, int F, int splits,
                      cudaStream_t stream) {
  switch (tf_rows(C)) {
    case 8:
      return launch_tf32x3<8>(x, w, counts, out, E, C, D, F, splits, stream);
    case 16:
      return launch_tf32x3<16>(x, w, counts, out, E, C, D, F, splits, stream);
    case 64:
      return launch_tf32x3<64>(x, w, counts, out, E, C, D, F, splits, stream);
    case 128:
      return launch_tf32x3<128>(x, w, counts, out, E, C, D, F, splits,
                                stream);
  }
  return cudaErrorInvalidValue;
}

int tf_smem(int C) {
  switch (tf_rows(C)) {
    case 8: return TfLayout<8>::SMEM;
    case 16: return TfLayout<16>::SMEM;
    case 64: return TfLayout<64>::SMEM;
    case 128: return TfLayout<128>::SMEM;
  }
  return -1;
}

// the paths, as kernels/moe_gmm/ops.py numbers them
enum Path { FMA = 0, SWAP = 1, WGMMA = 2, FILL = 3, TF32X3 = 4 };

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x: (E, C, D); w: (E, D, F); counts: (E,) int32; out: (E, C, F); x, w and
// out contiguous, float32 for paths FMA and TF32X3 and bfloat16 for the
// others (the caller's choice: kernels/moe_gmm/ops.py gmm_path);
// ``splits``: the blocks along D of the SWAP path and of TF32X3 at C <= 16
// (1, 2, 4 or 8: ops.py gmm_splits), 1 on the others. Launches on
// ``stream``, allocates nothing, and returns the
// cudaError_t of the launch (0 on success); a path that cannot take the
// shape refuses it (cudaErrorInvalidValue) and launches nothing.
extern "C" int repro_moe_gmm(const void* x, const void* w, const void* counts,
                             void* out, int path, int splits, int E, int C,
                             int D, int F, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > SW_MAX_SPLITS || (splits & (splits - 1)) ||
      (splits != 1 && !((path == SWAP || path == TF32X3) && C <= 16)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  const bool aligned = aligned16(x) && aligned16(w) && aligned16(out);
  const bool tma = D % 8 == 0 && F % 8 == 0 && aligned;  // bf16 rows
  const bool tma_f32 = D % 4 == 0 && F % 4 == 0 && aligned;
  switch (path) {
    case FMA:
      if ((C + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
      return (int)dispatch_c<float>(x, w, cnt, out, E, C, D, F, st);
    case SWAP:
      if (C > 16 || !tma) return (int)cudaErrorInvalidValue;
      if (C <= 8)
        return (int)launch_swap<8>(x, w, cnt, out, E, C, D, F, splits, st);
      return (int)launch_swap<16>(x, w, cnt, out, E, C, D, F, splits, st);
    case FILL:
      if ((C + 15) / 16 > 65535) return (int)cudaErrorInvalidValue;
      if (C <= 8)
        return (int)launch_tc<8, 64>(x, w, cnt, out, E, C, D, F, st);
      return (int)launch_tc<16, 64>(x, w, cnt, out, E, C, D, F, st);
    case WGMMA:
      if (C <= 16 || !tma) return (int)cudaErrorInvalidValue;
      return (int)launch_wgmma(x, w, cnt, out, E, C, D, F, st);
    case TF32X3:
      if (!tma_f32) return (int)cudaErrorInvalidValue;
      return (int)launch_tf(x, w, cnt, out, E, C, D, F, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory, in bytes, a block of ``path`` takes at C rows
// (the FMA kernel's is static: 0); -1 for what the entry point refuses.
extern "C" int repro_moe_gmm_smem(int path, int C) {
  if (C <= 0) return -1;
  switch (path) {
    case FMA:
      return 0;
    case SWAP:
      return C > 16 ? -1 : C <= 8 ? SwLayout<8>::SMEM : SwLayout<16>::SMEM;
    case FILL:
      return C <= 8 ? (int)tc_smem_bytes<8, 64>()
                    : (int)tc_smem_bytes<16, 64>();
    case WGMMA:
      return C <= 16 ? -1 : WgLayout<WG_BN>::SMEM;
    case TF32X3:
      return tf_smem(C);
  }
  return -1;
}

// The tiling of the swap and tf32x3 paths, which kernels/moe_gmm/tiling.py
// repeats for the wrapper and the plain versions (ops.build checks the two
// agree): 0 -> the swap path's output columns a tile, 1 -> its D a stage,
// 2 -> the largest cluster, 3 -> the tf32x3 path's output columns a tile,
// 4 -> its D a stage; -1 otherwise.
extern "C" int repro_moe_gmm_tiling(int which) {
  switch (which) {
    case 0:
      return SW_BN;
    case 1:
      return SW_BK;
    case 2:
      return SW_MAX_SPLITS;
    case 3:
      return TF_BN;
    case 4:
      return TF_BK;
  }
  return -1;
}
