// Mamba2 SSD chunked scan for Hopper (sm_90a): per (batch, head),
//   h_t = exp(A dt_t) h_{t-1} + dt_t x_t (outer) B_t,   y_t = h_t C_t,
// computed chunk by chunk with an f32 (P, N) state passed between chunks.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:74 ssd_scan_bh (_ssd_kernel,
//   pl.pallas_call at :87), wrapper src/repro/kernels/ssd_scan/ops.py
//   ssd_scan; the model computes the same function in
//   src/repro/models/mamba2.py:66 _ssd_chunked.
// Within chunk c of Q tokens, with cumulative log-decay Lc (Lc_t = sum of
// A dt_u over u <= t in the chunk) and Ltot_c its last value, four
// products:
//   (i)   CB_c  = C_c B_c^T                              (Q x Q, j <= i)
//   (ii)  y_i   = sum_{j<=i} M[i][j] x_j,  M[i][j] = CB_c[i][j]
//                 exp(Lc_i - Lc_j) dt_j
//   (iii) s_c   = x^T (w B) over the chunk's rows j,  w_j = exp(Ltot_c -
//                 Lc_j) dt_j;  h_c = exp(Ltot_c) h_{c-1} + s_c
//   (iv)  y_i  += exp(Lc_i) C_i h_{c-1}^T;  h_{n_chunks - 1} is written.
// It computes what _ssd_kernel computes, not block for block: the TPU walks
// the chunks of one (b, h) in order on a sequential grid axis with the
// state in VMEM scratch; here every chunk is worked on at once.
//
// What bounds it (mamba2-1.3b prefill of 1024 tokens at batch 1, f32 as
// the model passes them: H 64, P 64, N 128, Q 256): 1.63 G multiply-adds
// (3.26 GFLOP) against 37 MB moved. On the FMA pipes (67 TFLOP/s) that is
// 0.049 ms, bound by operations; the first two versions of this kernel
// stayed there and reached 26% of it. On the tensor cores at f32's
// accuracy each product is taken three times in TF32 (below): 9.8 GFLOP at
// 495 TFLOP/s, 0.020 ms, against 0.011 ms for the bytes. So the products
// run on wgmma. What is left bounds this kernel: the element-wise passes
// (the split of each operand, the decays of M) and shared memory, whose
// 128 bytes a clock an N = 64 tf32 wgmma with both operands in shared
// memory takes whole (4 KB an instruction of 32 clocks), so the passes
// and the products slow each other; and the serial look-back.
//
// Numerics: split TF32 (3xTF32). wgmma's tf32 form reads f32 bits and
// drops the low 13 mantissa bits, which keeps about three digits: one
// TF32 product misses the 1e-3 tolerance. Each f32 operand is written a =
// hi + lo, hi = tf32(a), lo = tf32(a - hi) (cvt.rna), and a b is taken as
// hi hi + hi lo + lo hi, all three summed in wgmma's f32 accumulators;
// the dropped lo lo and the rounding of lo are below 2^-21 of |a b|. With
// bf16 inputs x, B and C are exact in TF32 (lo = 0) and those terms are
// skipped; M, w x and h are f32 products and keep their split. The
// log-decay and the state stay f32 (expf, not __expf).
//
// Layouts. The tf32 wgmma takes A (M x K) and B (N x K) K-major only
// (the transpose bits exist for 16-bit types), from 128-byte-swizzled
// tiles: rows of 32 f32, 8-row atoms 1024 bytes apart, a k8 slice 32
// bytes further into the row (csrc/sm90.cuh). The four products:
//   (i)   A = C[i][n], B = B[j][n]: both lie so in memory. TMA brings them
//         (128-byte swizzle: the operand's layout) and the split writes hi
//         and lo at the same offsets.
//   (ii)  A = M[i][j]: built in place from the CB tile that TMA brings
//         (CB is stored [i][j]); B = x as [p][j]: x lies [t][h P + p], so
//         the split pass transposes it.
//   (iii) s = (w x)^T B: A = (w x) as [p][j], transposed by the same pass
//         (w on x, not on B, keeps B's operand free of the head); B = B as
//         [n][j]: ssd_cb writes B^T's hi and lo once per (b, chunk), and
//         TMA brings them straight into the operand tiles.
//   (iv)  A = C[i][n]'s hi and lo, which ssd_cb also writes once; B =
//         h_{c-1} as [p][n]: the published state slots are [p][n]. The
//         product lands in registers of its own and joins y scaled by
//         exp(Lc_i) row by row, so C's operand is free of the head too.
// The transposes happen in the split pass itself: TMA lands the raw x
// tile (64 key rows) in a staging buffer, and each thread reads a 4 x 4
// block (four 16-byte row pieces) and writes it transposed (16-byte pieces
// of x^T and (w x)^T, hi and lo), with a diagonal thread order that keeps
// both sides free of bank conflicts in f32.
//
// Two launches a call:
//  * ssd_cb: C B^T once per (b, chunk), not per head (B and C are shared
//    across heads), one 64 x 64 tile of the lower triangle a block (two
//    warpgroups, each half of the depth), into a scratch tensor (B x
//    n_chunks x Qp^2 f32, Qp = Q rounded up to 64; 1 MB at S = 1024,
//    resident in L2), stored [i][j]; its diagonal blocks also write C's
//    and B^T's split planes. It zeroes the scan's ticket and flags, so the
//    wrapper needs no memset, and lets ssd_chunk launch at its start
//    (programmatic dependent launch): ssd_chunk's set-up runs beside it
//    and waits for it before reading what it writes.
//  * ssd_chunk: one block per (b, h, chunk, 64 columns of P), two
//    warpgroups, one block an SM (about 218 KB of shared memory). Blocks
//    take their work from an atomic ticket in chunk-major order, so the
//    block of chunk c-1 is always resident or done when chunk c waits on
//    it (decoupled look-back). A block walks its chunk's key tiles of 64
//    rows once: tile k+1's raw x arrives by TMA while tile k's products
//    run; each warpgroup takes half of the state's columns in (iii) and
//    whole query tiles of y in (ii) (tiles {3, 0} and {2, 1} at four: five
//    key tiles each), building M for its tile from the CB tile TMA brings
//    while its (iii) products run. Then it waits for h_{c-1} (only P N
//    element-wise FMAs are serial a chunk), publishes h_c (two slots a
//    line suffice: chunk c+1 overwrites slot c-1 only after chunk c, which
//    read it, has raised its flag), and adds (iv), each query tile's C
//    arriving by TMA. The warpgroups meet at every key tile, so a key
//    tile lasts as long as its warpgroup with the most M tiles in it (two
//    when a warpgroup has two query tiles). One chunk of three or four
//    query tiles (128 < S <= 256) on at most half the SMs: two blocks a
//    (b, h, P tile), each with half of the query tiles, a tile a
//    warpgroup (M tiles in turn 3 not 4 at three query tiles, 4 not 6 at
//    four); both take the whole state, the first writes it, and no ticket
//    is needed. At two query tiles each warpgroup has one already.
//  * Off the diagonal the decay factors as exp(Lc_i - Lc_i0) exp(Lc_i0 -
//    Lc_j) (both exponents <= 0), so only the diagonal tiles take an expf
//    per element.
//  * The log-decay cumsum is summed in token order, as a sequential
//    cumsum adds it: its rounding (Lc near -3,000 within a chunk) set the
//    first version's f32 error (4.2e-4 of the 1e-3 tolerance).
// Every branch between a wgmma and its wait is uniform over the warpgroup
// (the ticket and the warpgroup are broadcast with __shfl_sync; masks are
// selects; one-thread TMA issues are predicated in the asm): ptxas
// serialises wgmma behind a branch it cannot prove uniform (C7518). The
// look-back spin sits where no wgmma is in flight.
// Guards kept: exp only of non-positive differences (j <= i, Lc
// non-increasing); tokens past S count as dt = 0, x = 0, B = C = 0 and no
// y is written there (the Pallas kernel asserts S % chunk == 0); N <= 128,
// Q <= 256, any S, B and P; no h0 (the Pallas kernel has none). TMA needs
// 16-byte aligned x, B and C and rows of a multiple of 16 bytes (H P and
// N elements): the wrapper refuses others. bf16 inputs are widened in the
// split and y is rounded once, on store.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/ssd_scan/ops.py).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int KT = 64;       // rows of a query or key tile (wgmma's M)
constexpr int QMAX = 256;    // longest chunk
constexpr int NMAX = 128;    // largest state dim
constexpr int PT = 64;       // columns of P a block (y's wgmma N)
constexpr int NT = 256;      // threads of an ssd_chunk block: 2 warpgroups
constexpr int CB_NT = 256;   // threads of an ssd_cb block: 2 warpgroups
constexpr int PANEL = KT * 128;  // a 64-row tile of 128-byte rows

// ssd_chunk's shared memory, in bytes from a 1024-byte aligned base.
// Operand tiles are K-major f32, 128-byte swizzle, in panels of 32 K
// values (a panel: rows x 128 bytes).
constexpr int XH = 0;                // x^T hi: [64 p][64 j], 2 panels
constexpr int XL = XH + 2 * PANEL;   // x^T lo
constexpr int VH = XL + 2 * PANEL;   // (w x)^T hi: [64 p][64 j], 2 panels
constexpr int VL = VH + 2 * PANEL;   // (w x)^T lo
constexpr int WH = VL + 2 * PANEL;   // B^T hi: [128 n][64 j], 2 panels of
                                     // 128 rows; then h_{c-1} hi: [64 p]
                                     // [128 n], 4 panels
constexpr int WL = WH + 4 * PANEL;   // B^T lo; then h_{c-1} lo
constexpr int RX = WL + 4 * PANEL;   // raw x: 64 rows of 64 p (T)
constexpr int MB = RX + 2 * PANEL;   // a warpgroup's M
constexpr int MBYTES = 4 * PANEL;    // hi: 2 panels, lo: 2 panels
constexpr int SMALL = MB + 2 * MBYTES;
// (iv) brings a query tile's C hi and lo ([64 i][128 n], 4 panels each)
// into what the key loop leaves free: warpgroup 0's at XH (hi) and VH
// (lo), warpgroup 1's at MB (both warpgroups' M buffers)
constexpr int CH0 = XH, CL0 = VH, CH1 = MB, CL1 = MB + 4 * PANEL;
// f32 arrays after SMALL: lc, dt, w, exp(Lc) of the chunk; u[4][64],
// v[4][256] (the off-diagonal decay factors of each query tile)
constexpr int SMALL_FLOATS = 4 * QMAX + 4 * KT + 4 * QMAX;
constexpr int BARS = SMALL + SMALL_FLOATS * 4;  // x, bt, cb[2], c[2]
constexpr int CHUNK_SMEM = BARS + 7 * 8 + 1024;  // + the ticket, alignment
static_assert(CHUNK_SMEM <= 232448, "ssd_chunk's shared memory");
static_assert(VH - CH0 >= 4 * PANEL && WH - CL0 >= 4 * PANEL &&
                  SMALL - CL1 >= 4 * PANEL,
              "C hi and lo of a query tile fit each warpgroup's area");

// ssd_cb's: raw C and B, then the operands C (hi, lo) and B (hi, lo), each
// [64 rows][128 n] in 4 panels
constexpr int CB_RC = 0, CB_RB = 4 * PANEL, CB_CH = 8 * PANEL,
              CB_CL = 12 * PANEL, CB_BH = 16 * PANEL, CB_BL = 20 * PANEL;
constexpr int CB_SMEM = 24 * PANEL + 8 + 1024;

template <typename T>
struct In;
template <>
struct In<float> {
  static constexpr bool kExact = false;  // lo may be nonzero
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct In<__nv_bfloat16> {
  static constexpr bool kExact = true;   // exact in tf32: lo = 0
  static constexpr CUtensorMapDataType kMap =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// byte offset of (row, k) in a K-major f32 operand tile of ``rows`` rows
__device__ __forceinline__ int opnd_off(int row, int k, int rows) {
  return (k >> 5) * rows * 128 + row * 128 +
         ((((k & 31) >> 2) ^ (row & 7)) << 4) + ((k & 3) << 2);
}

// four values of row ``row``, columns col .. col + 3 (col % 4 == 0), of a
// raw tile of T as TMA lands it: 64-row panels of 128-byte rows, 128-byte
// swizzle
template <typename T>
__device__ __forceinline__ float4 raw4(const unsigned char* base, int row,
                                       int col) {
  constexpr int EPR = 128 / (int)sizeof(T);
  const int c = col % EPR;
  const unsigned char* p = base + (col / EPR) * PANEL + row * 128 +
                           ((((c * (int)sizeof(T)) >> 4) ^ (row & 7)) << 4) +
                           ((c * (int)sizeof(T)) & 15);
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

// hi and lo of four values, stored at byte ``off`` of the hi and lo tiles
template <bool LO>
__device__ __forceinline__ void put_split(unsigned char* hi, unsigned char* lo,
                                          int off, float a, float b, float c,
                                          float d) {
  const float4 h = make_float4(sm90::to_tf32(a), sm90::to_tf32(b),
                               sm90::to_tf32(c), sm90::to_tf32(d));
  *reinterpret_cast<float4*>(hi + off) = h;
  if constexpr (LO)
    *reinterpret_cast<float4*>(lo + off) =
        make_float4(sm90::to_tf32(a - h.x), sm90::to_tf32(b - h.y),
                    sm90::to_tf32(c - h.z), sm90::to_tf32(d - h.w));
}

__device__ __forceinline__ uint64_t desc(const unsigned char* p) {
  return sm90::desc_sw128(sm90::smem_u32(p), 16, 1024);
}

// acc += A B^T over ``nk8`` k8 slices in split TF32: A (64 rows) at ah /
// al, B (64 rows) at bh / bl, K-major tiles whose panels are ``pa`` / ``pb``
// bytes apart. AX / BX: A's / B's lo is zero (its terms are skipped).
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&acc)[32], const unsigned char* ah,
                                     const unsigned char* al,
                                     const unsigned char* bh,
                                     const unsigned char* bl, int pa, int pb,
                                     int nk8) {
  for (int ks = 0; ks < nk8; ++ks) {
    const int oa = (ks >> 2) * pa + (ks & 3) * 32;
    const int ob = (ks >> 2) * pb + (ks & 3) * 32;
    sm90::wgmma_m64n64k8_tf32(acc, desc(ah + oa), desc(bh + ob));
    if constexpr (!BX)
      sm90::wgmma_m64n64k8_tf32(acc, desc(ah + oa), desc(bl + ob));
    if constexpr (!AX)
      sm90::wgmma_m64n64k8_tf32(acc, desc(al + oa), desc(bh + ob));
  }
}

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// The scratch a call needs, carved from one allocation: the ticket, one
// flag per (b, h, P tile, chunk), C B^T per (b, chunk) in Qp x Qp
// (Qp = Q rounded up to a tile), C's hi and lo per (b, chunk) in two Qp x
// NMAX planes, B^T's in two NMAX x Qp planes, two state slots ([p][n]) per
// (b, h, P tile).
struct Layout {
  int n_chunks, n_pt, qp;
  size_t flags, cb, cs, bs, state, bytes;   // byte offsets and the total
};

Layout layout(int B, int S, int H, int P, int N, int Q) {
  Layout l;
  l.n_chunks = (S + Q - 1) / Q;
  l.n_pt = (P + PT - 1) / PT;
  l.qp = (Q + KT - 1) / KT * KT;
  const size_t lines = (size_t)B * H * l.n_pt;
  l.flags = 256;
  l.cb = l.flags + align256(sizeof(int) * lines * l.n_chunks);
  l.cs = l.cb + align256(sizeof(float) * B * l.n_chunks * l.qp * l.qp);
  l.bs = l.cs + align256(sizeof(float) * B * l.n_chunks * 2 * l.qp * NMAX);
  l.state = l.bs + align256(sizeof(float) * B * l.n_chunks * 2 * NMAX * l.qp);
  l.bytes = l.state + sizeof(float) * lines * 2 * PT * N;
  return l;
}

// (i): one 64 x 64 tile (query tile it, key tile jt <= it) of CB[i][j] =
// C_i . B_j for one (b, chunk), on wgmma; rows past S are zero. TMA brings
// the raw C and B rows; the split writes hi and lo at the layout's own
// offsets. Also zeroes the ticket and the flags (``n_zero`` ints from
// ``zero``).
template <typename T>
__global__ void __launch_bounds__(CB_NT, 1)
ssd_cb(const __grid_constant__ CUtensorMap map_b,
       const __grid_constant__ CUtensorMap map_c, float* __restrict__ cb,
       float* __restrict__ csplit, float* __restrict__ bsplit,
       int* __restrict__ zero, int n_zero, int S, int N, int Q, int n_chunks,
       int qp, int pairs) {
  constexpr int EPR = 128 / (int)sizeof(T);
  constexpr bool X = In<T>::kExact;
  extern __shared__ __align__(1024) unsigned char cb_raw[];
  unsigned char* sm =
      cb_raw + ((1024 - (sm90::smem_u32(cb_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 24 * PANEL);
  const int tid = threadIdx.x;
  sm90::griddep_launch_dependents();   // ssd_chunk's set-up may start
  for (int e = blockIdx.x * CB_NT + tid; e < n_zero; e += gridDim.x * CB_NT)
    zero[e] = 0;

  const int bc = blockIdx.x / pairs;       // b * n_chunks + chunk
  int pr = blockIdx.x - bc * pairs, it = 0;
  while (pr > it) pr -= ++it;              // pairs in order (0,0) (1,0) (1,1)
  const int jt = pr;
  const int b = bc / n_chunks, c = bc - b * n_chunks;
  const int c0 = c * Q, valid = min(Q, S - c0);
  const int row0 = b * S + c0;
  const int npn = (N + EPR - 1) / EPR;     // panels of a raw row
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::prefetch_tensor_map(&map_b);
    sm90::prefetch_tensor_map(&map_c);
    sm90::mbar_arrive_expect_tx(bar, 2 * npn * PANEL);
    for (int q = 0; q < npn; ++q) {
      sm90::tma_load_2d(sm + CB_RC + q * PANEL, &map_c, bar, q * EPR,
                        row0 + it * KT);
      sm90::tma_load_2d(sm + CB_RB + q * PANEL, &map_b, bar, q * EPR,
                        row0 + jt * KT);
    }
  }
  sm90::mbar_wait(bar, 0);
  // split: 4 values (a 16-byte piece of an operand row) a step, at the
  // operand's own offset; zero past S and past N. A diagonal block also
  // writes C's hi and lo (rows it) for ssd_chunk's (iv), row-major [i][n]
  // planes of NMAX columns that TMA brings back in this layout.
  const bool diag = it == jt;
  float* chi = csplit + ((size_t)bc * 2 * qp + it * KT) * NMAX;
  float* clo = chi + (size_t)qp * NMAX;
#pragma unroll 4
  for (int q = 0; q < 2048 / CB_NT; ++q) {
    const int ch = tid + CB_NT * q;
    const int row = (ch >> 3) & 63;
    const int col = (ch >> 9) * 32 + (((ch & 7) ^ (row & 7)) << 2);
    const bool cin = col < N;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 cv = cin && it * KT + row < valid
                          ? raw4<T>(sm + CB_RC, row, col) : z;
    const float4 bv = cin && jt * KT + row < valid
                          ? raw4<T>(sm + CB_RB, row, col) : z;
    put_split<!X>(sm + CB_CH, sm + CB_CL, ch * 16, cv.x, cv.y, cv.z, cv.w);
    put_split<!X>(sm + CB_BH, sm + CB_BL, ch * 16, bv.x, bv.y, bv.z, bv.w);
    if (diag) {
      *reinterpret_cast<float4*>(chi + row * NMAX + col) =
          *reinterpret_cast<const float4*>(sm + CB_CH + ch * 16);
      if constexpr (!X)
        *reinterpret_cast<float4*>(clo + row * NMAX + col) =
            *reinterpret_cast<const float4*>(sm + CB_CL + ch * 16);
    }
  }
  sm90::fence_async_shared();
  __syncthreads();
  if (diag) {
    // B^T's hi and lo (key tile jt) for ssd_chunk's (iii): row-major [n][j]
    // planes of NMAX rows; a 4 x 4 block (rows j .., columns n ..) a step,
    // read as four 16-byte row pieces of the split's tiles and written as
    // four 16-byte pieces of B^T's rows
    float* bhi = bsplit + (size_t)bc * 2 * NMAX * qp + jt * KT;
    float* blo = bhi + (size_t)NMAX * qp;
#pragma unroll
    for (int q = 0; q < 512 / CB_NT; ++q) {
      const int e = tid + CB_NT * q;
      const int j = 4 * (e & 15), n = 4 * (e >> 4);
#pragma unroll
      for (int pl = 0; pl < (X ? 1 : 2); ++pl) {
        const unsigned char* src = sm + (pl ? CB_BL : CB_BH);
        float4 r4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          r4[r] = *reinterpret_cast<const float4*>(src +
                                                   opnd_off(j + r, n, KT));
        float* dst = (pl ? blo : bhi) + (size_t)n * qp + j;
        *reinterpret_cast<float4*>(dst) =
            make_float4(r4[0].x, r4[1].x, r4[2].x, r4[3].x);
        *reinterpret_cast<float4*>(dst + qp) =
            make_float4(r4[0].y, r4[1].y, r4[2].y, r4[3].y);
        *reinterpret_cast<float4*>(dst + 2 * qp) =
            make_float4(r4[0].z, r4[1].z, r4[2].z, r4[3].z);
        *reinterpret_cast<float4*>(dst + 3 * qp) =
            make_float4(r4[0].w, r4[1].w, r4[2].w, r4[3].w);
      }
    }
  }
  // the product, its depth split over the two warpgroups (k8 slices 8 g
  // ..): warpgroup 1 hands its sum to warpgroup 0 through the raw C stage
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int nk8 = (N + 7) / 8, k0 = min(8 * wg, nk8);
  const int koff = (k0 >> 2) * PANEL;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  sm90::fence_operands(acc);
  sm90::wgmma_fence();
  mma3<X, X>(acc, sm + CB_CH + koff, sm + CB_CL + koff, sm + CB_BH + koff,
             sm + CB_BL + koff, PANEL, PANEL, min(nk8, 8 * wg + 8) - k0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);
  float* part = reinterpret_cast<float*>(sm + CB_RC) + (tid % 128);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i * 128] = acc[i];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[i * 128];
  // fragment 4 jj + 2 hf + e: row 16 warp + g + 8 hf, column 8 jj + 2 t + e
  const int warp = tid / 32, g = (tid & 31) >> 2, t = tid & 3;
  float* out = cb + (size_t)bc * qp * qp;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = it * KT + 16 * warp + g + 8 * hf;
      const int j = jt * KT + 8 * jj + 2 * t;
      *reinterpret_cast<float2*>(&out[(size_t)i * qp + j]) =
          make_float2(acc[4 * jj + 2 * hf], acc[4 * jj + 2 * hf + 1]);
    }
}

// (ii)-(iv) for one (b, h, chunk, 64 columns of P), in ticket order.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_chunk(const __grid_constant__ CUtensorMap map_x,
          const __grid_constant__ CUtensorMap map_bs,
          const __grid_constant__ CUtensorMap map_cs,
          const __grid_constant__ CUtensorMap map_cb,
          const T* __restrict__ dt, const float* __restrict__ A,
          float* __restrict__ state, int* __restrict__ flags,
          int* __restrict__ ticket, T* __restrict__ y,
          float* __restrict__ hout, int B, int S, int H, int P, int N, int Q,
          int n_chunks, int n_pt, int qp, int qsplit) {
  constexpr int EPR = 128 / (int)sizeof(T);
  constexpr bool X = In<T>::kExact;
  extern __shared__ __align__(1024) unsigned char ch_raw[];
  unsigned char* sm =
      ch_raw + ((1024 - (sm90::smem_u32(ch_raw) & 1023)) & 1023);
  float* lc = reinterpret_cast<float*>(sm + SMALL);  // log-decay (f32)
  float* dtv = lc + QMAX;       // dt of the chunk (0 past S)
  float* w = dtv + QMAX;        // exp(Ltot - Lc_j) dt_j (0 past S)
  float* el = w + QMAX;         // exp(Lc_i)
  float* u = el + QMAX;         // u[it][r] = exp(Lc_{i0 + r} - Lc_i0)
  float* v = u + 4 * KT;        // v[it][j] = exp(Lc_i0 - Lc_j) dt_j, j < i0
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + BARS);
  uint64_t* bar_raw = bars;     // raw x of a key tile
  uint64_t* bar_bt = bars + 1;  // B^T (hi, lo) of a key tile
  uint64_t* bar_cb = bars + 2;  // a warpgroup's CB tile
  uint64_t* bar_c = bars + 4;   // a warpgroup's C tile (hi, lo)
  int* tk = reinterpret_cast<int*>(bars + 6);
  const int tid = threadIdx.x;
  // launched while ssd_cb runs: what reads ssd_cb's results (the ticket
  // it zeroes, C B^T, the planes) waits for it. One chunk has no
  // look-back, so its blocks take their work from blockIdx and their
  // set-up overlaps ssd_cb.
  if (n_chunks > 1) sm90::griddep_wait();
  if (tid == 0) {
    *tk = n_chunks > 1 ? atomicAdd(ticket, 1) : (int)blockIdx.x;
    for (int i = 0; i < 6; ++i) sm90::mbar_init(&bars[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  // uniform to the compiler (broadcast from lane 0), as is all derived
  // from it: the branches around the wgmma are too
  const int tkt = __shfl_sync(0xffffffffu, *tk, 0);
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);   // warpgroup
  const int wt = tid % 128, warp = wt / 32, fg = (tid & 31) >> 2,
            ft = tid & 3;
  // chunk-major: every block of chunk c-1 took its ticket before chunk c's.
  // qsplit (one chunk of three or four query tiles, a grid of at most
  // half the SMs): two blocks a (b, h, P tile), each with half of the
  // query tiles, one a warpgroup (both take the whole state: the first
  // writes it)
  const int per_chunk = B * H * n_pt << qsplit;
  const int c = tkt / per_chunk;
  const int line = (tkt - c * per_chunk) >> qsplit;   // (b H + h) n_pt + tile
  const int half = (tkt - c * per_chunk) & qsplit;
  const int bh = line / n_pt;
  const int p0 = (line - bh * n_pt) * PT;
  const int b = bh / H, hd = bh - b * H;
  const int c0 = c * Q, valid = min(Q, S - c0);
  const int row0 = b * S + c0;            // the chunk's first row of x, B, C
  const int nk = (valid + KT - 1) / KT;   // key (and query) tiles
  const bool inter = c > 0;               // h_{c-1} != 0
  // this warpgroup's query tiles: {nk-1-g, g+nk-4}, those >= 0; under
  // qsplit the block's warpgroup g takes the first (g = 0) or the second
  // of warpgroup ``half``'s
  const int ta = qsplit ? (g == 0 ? nk - 1 - half : half + nk - 4)
                        : nk - 1 - g;
  const int tb = qsplit ? -1 : g + nk - 4;
  const bool owner = half == 0;           // publishes the state
  const int npx = (min(PT, P - p0) + EPR - 1) / EPR;  // raw x panels
  const bool leader = wt == 0;
  unsigned char* mh = sm + MB + g * MBYTES;
  unsigned char* ml = mh + 2 * PANEL;

  // raw x of key tile k (if pred): the split reads it, so the next tile's
  // is in flight while this one's products run
  auto load_raw = [&](int k, bool pred) {
    sm90::mbar_arrive_expect_tx(bar_raw, npx * PANEL, pred);
    for (int q = 0; q < npx; ++q)
      sm90::tma_load_2d(sm + RX + q * PANEL, &map_x, bar_raw,
                        hd * P + p0 + q * EPR, row0 + k * KT, pred);
  };
  // B^T's hi and lo (ssd_cb's planes) of key tile k (if pred), straight
  // into the operand tiles: loaded once the last tile's products are done
  const int bplane = (b * n_chunks + c) * 2 * NMAX;   // the hi plane's row 0
  auto load_bt = [&](int k, bool pred) {
    sm90::mbar_arrive_expect_tx(bar_bt, (X ? 4 : 8) * PANEL, pred);
    for (int q = 0; q < 2; ++q) {
      sm90::tma_load_2d(sm + WH + 2 * q * PANEL, &map_bs, bar_bt,
                        k * KT + 32 * q, bplane, pred);
      if constexpr (!X)
        sm90::tma_load_2d(sm + WL + 2 * q * PANEL, &map_bs, bar_bt,
                          k * KT + 32 * q, bplane + NMAX, pred);
    }
  };
  // CB tile (it, k) into this warpgroup's M hi (by its leader)
  auto load_cb = [&](int it, int k) {
    sm90::mbar_arrive_expect_tx(bar_cb + g, 2 * PANEL, leader);
    for (int q = 0; q < 2; ++q)
      sm90::tma_load_2d(mh + q * PANEL, &map_cb, bar_cb + g,
                        k * KT + 32 * q, (b * n_chunks + c) * qp + it * KT,
                        leader);
  };
  // C hi and lo of query tile it (ssd_cb's planes) into this warpgroup's
  // area
  unsigned char* chi = sm + (g == 0 ? CH0 : CH1);
  unsigned char* clo = sm + (g == 0 ? CL0 : CL1);
  const int cplane = (b * n_chunks + c) * 2 * qp;   // the hi plane's row 0
  auto load_c = [&](int it, bool pred) {
    sm90::mbar_arrive_expect_tx(bar_c + g, (X ? 4 : 8) * PANEL, pred);
    for (int q = 0; q < 4; ++q) {
      sm90::tma_load_2d(chi + q * PANEL, &map_cs, bar_c + g, 32 * q,
                        cplane + it * KT, pred);
      if constexpr (!X)
        sm90::tma_load_2d(clo + q * PANEL, &map_cs, bar_c + g, 32 * q,
                          cplane + qp + it * KT, pred);
    }
  };

  if (tid == 0) {
    sm90::prefetch_tensor_map(&map_x);
    sm90::prefetch_tensor_map(&map_bs);
    sm90::prefetch_tensor_map(&map_cs);
    sm90::prefetch_tensor_map(&map_cb);
  }
  load_raw(0, tid == 0);
  const float a = A[hd];
  dtv[tid] = tid < valid ? to_f32(dt[(size_t)(row0 + tid) * H + hd]) : 0.f;
  __syncthreads();
  // the inclusive sum of A dt over the chunk, in token order (as a
  // sequential cumsum adds it): the log-decay sets the error of the
  // result; rows past S add 0
  if (tid == 0) {
    float acc = 0.f;
    for (int t0 = 0; t0 < valid; t0 += 8) {
      float d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = dtv[t0 + e];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc = __fadd_rn(acc, __fmul_rn(d[e], a));
        lc[t0 + e] = acc;
      }
    }
  }
  __syncthreads();
  const float ltot = lc[valid - 1];
  if (tid >= valid) lc[tid] = ltot;     // rows past S add nothing
  w[tid] = tid < valid ? expf(ltot - lc[tid]) * dtv[tid] : 0.f;
  el[tid] = expf(lc[tid]);
  __syncthreads();
  {
    const int it = tid / KT, r = tid % KT;
    u[tid] = expf(lc[it * KT + r] - lc[it * KT]);
    for (int i = 1; i < 4; ++i)
      for (int j = tid; j < i * KT; j += NT)
        v[i * QMAX + j] = expf(lc[i * KT] - lc[j]) * dtv[j];
  }
  __syncthreads();

  // wgmma accumulators: s (this warpgroup's 64 state columns), y of the
  // warpgroup's query tiles ta and tb. Fragment 4 jj + 2 hf + e: row
  // 16 warp + fg + 8 hf, column 8 jj + 2 ft + e.
  float s[32], ya[32], yb[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = ya[i] = yb[i] = 0.f;

  // M (it, k) in place over the CB tile in M hi: this warpgroup's 128
  // threads, 8 16-byte pieces each, at the tile's own offsets
  auto build_m = [&](int it, int k) {
    // four pieces a batch, all loads of a batch before its stores (the
    // compiler cannot tell the tiles apart, and would order each piece's
    // loads behind the last piece's stores)
#pragma unroll
    for (int q0 = 0; q0 < 8; q0 += 4) {
      float4 cbv[4], a4[4], d4[4];
      float li[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ch = wt + 128 * (q0 + q);
        const int row = (ch >> 3) & 63;
        const int jl = (ch >> 9) * 32 + (((ch & 7) ^ (row & 7)) << 2);
        const int j = k * KT + jl;
        cbv[q] = *reinterpret_cast<const float4*>(mh + ch * 16);
        if (k < it) {   // u_i v_j, both factors exp of a difference <= 0
          li[q] = u[it * KT + row];
          a4[q] = *reinterpret_cast<const float4*>(&v[it * QMAX + j]);
        } else {        // exp(Lc_i - Lc_j) where j <= i only
          li[q] = lc[it * KT + row];
          a4[q] = *reinterpret_cast<const float4*>(&lc[j]);
          d4[q] = *reinterpret_cast<const float4*>(&dtv[j]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ch = wt + 128 * (q0 + q);
        const int row = (ch >> 3) & 63;
        const int jl = (ch >> 9) * 32 + (((ch & 7) ^ (row & 7)) << 2);
        const float cr[4] = {cbv[q].x, cbv[q].y, cbv[q].z, cbv[q].w};
        const float ar[4] = {a4[q].x, a4[q].y, a4[q].z, a4[q].w};
        float m[4];
        if (k < it) {
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e] = cr[e] * (li[q] * ar[e]);
        } else {
          const float dr[4] = {d4[q].x, d4[q].y, d4[q].z, d4[q].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = expf(fminf(li[q] - ar[e], 0.f)) * cr[e] * dr[e];
            m[e] = jl + e <= row ? x : 0.f;
          }
        }
        put_split<true>(mh, ml, ch * 16, m[0], m[1], m[2], m[3]);
      }
    }
  };
  // y (it) += M (it, k) x_k: issued and committed
  auto mma_y = [&](float (&acc)[32]) {
    sm90::fence_async_shared();
    sm90::named_barrier_sync(1 + g, 128);
    sm90::fence_operands(acc);
    sm90::wgmma_fence();
    mma3<false, X>(acc, mh, ml, sm + XH, sm + XL, PANEL, PANEL, KT / 8);
    sm90::wgmma_commit();
  };

  // ssd_cb's results from here on
  sm90::griddep_wait();
  load_bt(0, tid == 0);
  int ph_cb = 0;
  for (int k = 0; k < nk; ++k) {
    sm90::mbar_wait(bar_raw, k & 1);
    // the split pass: x^T and (w x)^T of key tile k, a 4 x 4 block a step
    // (rows 4 jb .., columns 4 cb ..), read as four 16-byte row pieces and
    // written transposed; diagonal order: the 8 threads of a quarter warp
    // take 8 column blocks and 8 row blocks
    {
      const int l = tid & 7, grp = tid >> 3;
      const int jb = 8 * ((grp >> 1) & 1) + ((l + (grp >> 2)) & 7);
      const int cb0 = 8 * (grp & 1) + l;
      float wj[4];
      bool jin[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = k * KT + 4 * jb + r;
        jin[r] = j < valid;
        wj[r] = w[j];
      }
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xv[r] = jin[r] ? raw4<T>(sm + RX, 4 * jb + r, 4 * cb0) : z;
      const float xr[4][4] = {{xv[0].x, xv[0].y, xv[0].z, xv[0].w},
                              {xv[1].x, xv[1].y, xv[1].z, xv[1].w},
                              {xv[2].x, xv[2].y, xv[2].z, xv[2].w},
                              {xv[3].x, xv[3].y, xv[3].z, xv[3].w}};
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // x: columns 4 cb0 .. of P
        const int p = 4 * cb0 + e;
        const bool pin = p0 + p < P;
        const int off = opnd_off(p, 4 * jb, KT);
        const float x0 = pin ? xr[0][e] : 0.f, x1 = pin ? xr[1][e] : 0.f,
                    x2 = pin ? xr[2][e] : 0.f, x3 = pin ? xr[3][e] : 0.f;
        put_split<!X>(sm + XH, sm + XL, off, x0, x1, x2, x3);
        put_split<true>(sm + VH, sm + VL, off, x0 * wj[0], x1 * wj[1],
                        x2 * wj[2], x3 * wj[3]);
      }
    }
    sm90::fence_async_shared();
    __syncthreads();   // the raw stage is free
    load_raw(k + 1, tid == 0 && k + 1 < nk);
    // the first CB tile of key tile k: ta's, else tb's (uniform in the
    // warpgroup)
    const bool do_a = ta >= k, do_b = tb >= k;
    if (do_a || do_b) load_cb(do_a ? ta : tb, k);
    // (iii) s += (w x)^T B over the key tile: this warpgroup's 64 columns
    auto mma_s = [&] {
      sm90::mbar_wait(bar_bt, k & 1);
      sm90::fence_operands(s);
      sm90::wgmma_fence();
      mma3<false, X>(s, sm + VH, sm + VL, sm + WH + g * PANEL,
                     sm + WL + g * PANEL, PANEL, 2 * PANEL, KT / 8);
      sm90::wgmma_commit();
    };
    mma_s();
    // (ii) M of the first query tile, then its product
    if (do_a) {
      sm90::mbar_wait(bar_cb + g, ph_cb);
      ph_cb ^= 1;
      build_m(ta, k);
      mma_y(ya);
    }
    if (do_b) {
      if (do_a) {   // M hi is the last product's operand: wait for it
        sm90::wgmma_wait<0>();
        sm90::fence_operands(s);
        sm90::fence_operands(ya);
        sm90::named_barrier_sync(1 + g, 128);
        load_cb(tb, k);
      }
      sm90::mbar_wait(bar_cb + g, ph_cb);
      ph_cb ^= 1;
      build_m(tb, k);
      mma_y(yb);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::fence_operands(ya);
    sm90::fence_operands(yb);
    sm90::named_barrier_sync(1 + g, 128);   // M hi is free
    __syncthreads();   // x^T, (w x)^T and B^T are free
    load_bt(k + 1, tid == 0 && k + 1 < nk);
  }

  // C of the first query tile, in flight through the look-back
  if (inter) load_c(ta, leader && ta >= 0);   // ta < 0: tb < 0 too

  // (iii) look back for h_{c-1}; publish h_c = exp(Ltot) h_{c-1} + s_c;
  // h_{c-1} (hi, lo) becomes (iv)'s B operand: [64 p][128 n]
  if (inter) {
    if (tid == 0) {
      volatile int* f = flags + (size_t)line * n_chunks + c - 1;
      while (*f == 0) __nanosleep(32);
      __threadfence();
    }
    __syncthreads();
  }
  float* slot = state + (size_t)line * 2 * PT * N;   // slots [p][n]
  const float* src = slot + (size_t)((c - 1) & 1) * PT * N;
  float* dst = slot + (size_t)(c & 1) * PT * N;
  const float et = expf(ltot);
  const bool last = c + 1 == n_chunks;
  // fragment 4 jj + 2 hf + e: state row p = 16 warp + fg + 8 hf, column
  // n = 64 g + 8 jj + 2 ft + e; all loads first
  float2 hp[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int p = 16 * warp + fg + 8 * (q & 1);
    const int n = 64 * g + 8 * (q >> 1) + 2 * ft;
    hp[q] = inter && n < N
                ? __ldcg(reinterpret_cast<const float2*>(&src[p * N + n]))
                : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int p = 16 * warp + fg + 8 * (q & 1);
    const int n = 64 * g + 8 * (q >> 1) + 2 * ft;
    const int f = 4 * (q >> 1) + 2 * (q & 1);
    s[f] = fmaf(et, hp[q].x, s[f]);
    s[f + 1] = fmaf(et, hp[q].y, s[f + 1]);
    const float h0 = sm90::to_tf32(hp[q].x), h1 = sm90::to_tf32(hp[q].y);
    const int off = opnd_off(p, n, KT);
    *reinterpret_cast<float2*>(sm + WH + off) = make_float2(h0, h1);
    *reinterpret_cast<float2*>(sm + WL + off) = make_float2(
        sm90::to_tf32(hp[q].x - h0), sm90::to_tf32(hp[q].y - h1));
    if (n < N && owner) {
      if (!last)
        __stcg(reinterpret_cast<float2*>(&dst[p * N + n]),
               make_float2(s[f], s[f + 1]));
      else if (p0 + p < P)
        *reinterpret_cast<float2*>(
            &hout[((size_t)bh * P + p0 + p) * N + n]) =
            make_float2(s[f], s[f + 1]);
    }
  }
  if (!last && owner) {   // the block's stores, one fence and the flag
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicExch(flags + (size_t)line * n_chunks + c, 1);
    }
  }
  sm90::fence_async_shared();
  __syncthreads();   // h_{c-1}'s operand tiles are written

  // (iv) y_i += exp(Lc_i) (C h_{c-1}^T)[i]: C's hi and lo come from
  // ssd_cb's planes (they do not depend on the head), the product goes
  // into s's registers (h_c is published) and each row joins y scaled by
  // exp(Lc_i)
  if (inter) {
    int ph_c = 0;
    auto tile_iv = [&](float (&acc)[32], int it, int next) {
      sm90::mbar_wait(bar_c + g, ph_c);
      ph_c ^= 1;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      sm90::fence_operands(s);
      sm90::wgmma_fence();
      mma3<X, false>(s, chi, clo, sm + WH, sm + WL, PANEL, PANEL,
                     (N + 7) / 8);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);
      sm90::named_barrier_sync(1 + g, 128);   // C's area is free
      load_c(next, leader && next >= 0);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float e = el[it * KT + 16 * warp + fg + 8 * hf];
          acc[4 * jj + 2 * hf] = fmaf(e, s[4 * jj + 2 * hf],
                                      acc[4 * jj + 2 * hf]);
          acc[4 * jj + 2 * hf + 1] = fmaf(e, s[4 * jj + 2 * hf + 1],
                                          acc[4 * jj + 2 * hf + 1]);
        }
    };
    if (ta >= 0) tile_iv(ya, ta, tb);
    if (tb >= 0) tile_iv(yb, tb, -1);
  }

  // y of the warpgroup's query tiles
  auto store_y = [&](const float (&acc)[32], int it) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = it * KT + 16 * warp + fg + 8 * hf;
        const int p = p0 + 8 * jj + 2 * ft;
        if (i >= valid || p >= P) continue;
        T* o = y + ((size_t)(row0 + i) * H + hd) * P + p;
        const float v0 = acc[4 * jj + 2 * hf], v1 = acc[4 * jj + 2 * hf + 1];
        if (p + 1 < P && (P & 1) == 0) {
          store2(o, v0, v1);
        } else {
          store1(o, v0);
          if (p + 1 < P) store1(o + 1, v1);
        }
      }
  };
  if (ta >= 0) store_y(ya, ta);
  if (tb >= 0) store_y(yb, tb);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* Bm,
                   const void* Cm, const float* A, void* y, float* h,
                   char* ws, int B, int S, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  constexpr int ES = (int)sizeof(T), EPR = 128 / ES;
  // TMA: 16-byte aligned bases and rows
  if (!aligned16(x) || !aligned16(Bm) || !aligned16(Cm) ||
      (size_t)H * P * ES % 16 != 0 || (size_t)N * ES % 16 != 0)
    return cudaErrorMisalignedAddress;
  const Layout l = layout(B, S, H, P, N, Q);
  const int nt = l.qp / KT;
  const int pairs = nt * (nt + 1) / 2;
  int* ticket = reinterpret_cast<int*>(ws);
  int* flags = reinterpret_cast<int*>(ws + l.flags);
  float* cbt = reinterpret_cast<float*>(ws + l.cb);
  float* cs = reinterpret_cast<float*>(ws + l.cs);
  float* bs = reinterpret_cast<float*>(ws + l.bs);
  float* state = reinterpret_cast<float*>(ws + l.state);
  const cuuint64_t rows = (cuuint64_t)B * S;
  CUtensorMap mx, mb, mc, mcb, mcs, mbs;
  cudaError_t err = sm90::tensor_map<2>(
      &mx, In<T>::kMap, x, {(cuuint64_t)H * P, rows},
      {(cuuint64_t)H * P * ES}, {(cuuint32_t)EPR, (cuuint32_t)KT});
  if (err == cudaSuccess)
    err = sm90::tensor_map<2>(&mb, In<T>::kMap, Bm, {(cuuint64_t)N, rows},
                              {(cuuint64_t)N * ES},
                              {(cuuint32_t)EPR, (cuuint32_t)KT});
  if (err == cudaSuccess)
    err = sm90::tensor_map<2>(&mc, In<T>::kMap, Cm, {(cuuint64_t)N, rows},
                              {(cuuint64_t)N * ES},
                              {(cuuint32_t)EPR, (cuuint32_t)KT});
  if (err == cudaSuccess)
    err = sm90::tensor_map<2>(
        &mcb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cbt,
        {(cuuint64_t)l.qp, (cuuint64_t)B * l.n_chunks * l.qp},
        {(cuuint64_t)l.qp * 4}, {32u, (cuuint32_t)KT});
  if (err == cudaSuccess)
    err = sm90::tensor_map<2>(
        &mcs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cs,
        {(cuuint64_t)NMAX, (cuuint64_t)B * l.n_chunks * 2 * l.qp},
        {(cuuint64_t)NMAX * 4}, {32u, (cuuint32_t)KT});
  if (err == cudaSuccess)
    err = sm90::tensor_map<2>(
        &mbs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, bs,
        {(cuuint64_t)l.qp, (cuuint64_t)B * l.n_chunks * 2 * NMAX},
        {(cuuint64_t)l.qp * 4}, {32u, (cuuint32_t)NMAX});
  if (err != cudaSuccess) return err;
  // the ticket and the flags are zeroed by ssd_cb: they are contiguous
  // from the ticket (offset 0) to the end of the flags
  const int n_zero = (int)(l.cb / sizeof(int));
  err = cudaFuncSetAttribute(ssd_cb<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CB_SMEM);
  if (err != cudaSuccess) return err;
  ssd_cb<T><<<B * l.n_chunks * pairs, CB_NT, CB_SMEM, stream>>>(
      mb, mc, cbt, cs, bs, ticket, n_zero, S, N, Q, l.n_chunks, l.qp,
      pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CHUNK_SMEM);
  if (err != cudaSuccess) return err;
  // one chunk of three or four query tiles, on a grid of at most half the
  // SMs: two blocks a (b, h, P tile), each with half of the query tiles
  // (with one chunk no state is passed, so no block waits on another)
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = B * H * l.n_pt * l.n_chunks;
  const int qsplit = l.n_chunks == 1 && Q > 2 * KT && 2LL * blocks <= sms;
  // a programmatic launch: its blocks may start while ssd_cb runs (they
  // wait for it before reading what it writes)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks << qsplit);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = CHUNK_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ssd_chunk<T>, mx, mbs, mcs, mcb,
                            static_cast<const T*>(dt), A, state, flags,
                            ticket, static_cast<T*>(y), h, B, S, H, P, N, Q,
                            l.n_chunks, l.n_pt, l.qp, qsplit);
}

bool supported(int B, int S, int H, int P, int N, int Q) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > NMAX ||
      Q <= 0 || Q > QMAX)
    return false;
  const Layout l = layout(B, S, H, P, N, Q);
  const int nt = l.qp / KT;
  return (long long)B * S * H <= INT_MAX &&
         (long long)B * l.n_chunks * 2 * l.qp <= INT_MAX &&
         (long long)B * l.n_chunks * 2 * NMAX <= INT_MAX &&
         (long long)B * H * l.n_pt * l.n_chunks <= INT_MAX &&
         (long long)B * l.n_chunks * (nt * (nt + 1) / 2) <= INT_MAX &&
         l.cb / sizeof(int) <= (size_t)INT_MAX;
}

}  // namespace

// Bytes of scratch a call takes (0 if the extents are not supported).
extern "C" long long repro_ssd_scan_workspace(int B, int S, int H, int P,
                                              int N, int Q) {
  if (!supported(B, S, H, P, N, Q)) return 0;
  return (long long)layout(B, S, H, P, N, Q).bytes;
}

// Dynamic shared memory of a block, in bytes: kernel 0 = ssd_chunk (the
// chunk-parallel scan), 1 = ssd_cb (C B^T).
extern "C" int repro_ssd_scan_smem(int kernel) {
  return kernel == 0 ? CHUNK_SMEM : CB_SMEM;
}

// x: (B, S, H, P); dt: (B, S, H); Bm, Cm: (B, S, N); A: (H,) float32;
// y: (B, S, H, P); h: (B, H, P, N) float32; ws: repro_ssd_scan_workspace
// bytes, 256-byte aligned, contents ignored. x, dt, Bm, Cm and y
// contiguous, of one dtype (0 = float32, 1 = bfloat16); x, Bm and Cm
// 16-byte aligned with H P and N elements a multiple of 16 bytes (TMA);
// Q = min(chunk, S) <= 256; N <= 128. Launches two kernels on ``stream``,
// allocates nothing, and returns the cudaError_t of the launches (0 on
// success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* Bm,
                              const void* Cm, const void* A, void* y, void* h,
                              void* ws, int dtype, int B, int S, int H, int P,
                              int N, int Q, void* stream) {
  if (!supported(B, S, H, P, N, Q)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  float* hf = static_cast<float*>(h);
  char* w = static_cast<char*>(ws);
  if (dtype == 0)
    return (int)launch<float>(x, dt, Bm, Cm, a, y, hf, w, B, S, H, P, N, Q,
                              st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, Bm, Cm, a, y, hf, w, B, S, H,
                                      P, N, Q, st);
  return (int)cudaErrorInvalidValue;
}
