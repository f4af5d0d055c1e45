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
// A dt_u over u <= t in the chunk) and Ltot_c its last value:
//   (i)   CB_c    = C_c B_c^T                         (Q x Q, j <= i only)
//   (ii)  y_i     = sum_{j<=i} CB_c[i, j] exp(Lc_i - Lc_j) dt_j x_j
//         s_c     = sum_j exp(Ltot_c - Lc_j) dt_j x_j (outer) B_j
//   (iii) h_c     = exp(Ltot_c) h_{c-1} + s_c          (h_{-1} = 0)
//   (iv)  y_i    += exp(Lc_i) h_{c-1} C_i;  h_{n_chunks - 1} is written.
// It computes what _ssd_kernel computes, not block for block: the TPU walks
// the chunks of one (b, h) in order on a sequential grid axis with the
// state in VMEM scratch; here every chunk is worked on at once.
//
// What bounds it on this card (mamba2-1.3b prefill of 1024 tokens at
// batch 1, f32 inputs as the model passes them: H 64, P 64, N 128, Q 256):
// about 1.63 G f32 FMA (3.26 GFLOP: the j <= i half of each chunk's
// product, the state contribution and the inter-chunk term per head, C B^T
// once per (b, chunk)), 0.049 ms at 67 TFLOP/s, against 37 MB moved, 0.011
// ms at 3.35 TB/s: bound by operations. The f32 products stay f32 FMA:
// TF32 keeps three digits. The first version (one block per (b, h, 32
// columns of P) walking the chunks in order) recomputed C B^T in every
// block (4.43 G FMA done for 1.63 G needed) on 128 blocks, and stalled on
// the loads of each staged tile.
// What the design does about it, in two launches a call:
//  * ssd_cb: C B^T once per (b, chunk), not per head and P slice (B and C
//    are shared across heads), one 64 x 64 tile of the lower triangle a
//    block, into a scratch tensor (B x n_chunks x Qp^2 f32, 1 MB at
//    S = 1024, resident in L2), stored transposed (CBt[j][i]) so the scan
//    stages it with coalesced, conflict-free rows. It also zeroes the
//    scan's ticket and flags, so the wrapper needs no memset.
//  * ssd_chunk: one 256-thread block per (b, h, chunk, 32 columns of P):
//    B H n_chunks ceil(P / 32) blocks, 512 at S = 1024, B = 1; about 71 KB
//    of shared memory and at most 128 registers a thread, two blocks (16
//    warps) an SM. A block computes its chunk's state contribution s_c
//    first, then waits for h_{c-1} (decoupled look-back: the block of
//    chunk c-1 publishes h_{c-1} in the scratch tensor and raises a flag),
//    publishes h_c, and computes y_intra and the inter-chunk term. Blocks
//    take their (b, h, chunk, slice) from an atomic ticket in chunk-major
//    order, so the block of chunk c-1 is always resident or done when
//    chunk c waits on it; the only serial work is P N element-wise FMAs a
//    chunk. Two state slots a (b, h, slice) suffice: chunk c+1 overwrites
//    slot c-1 only after chunk c, which read it, has raised its flag.
//  * A block loads its x slice of the chunk once, then walks a fixed
//    sequence of steps, each staging one tile in shared memory (w B rows,
//    C^T, or the decayed M^T = (CB exp(Lc_i - Lc_j) dt_j)^T); the next
//    step's tile is fetched
//    into registers before this step's products, so its loads are in
//    flight while the FMAs run. Each half of the block takes half the
//    depth of every y product (their sums meet once a query tile), 4 x 4
//    outputs a thread, two 16-byte shared loads per 16 FMA.
//  * Off the diagonal the decay factors as exp(Lc_i - Lc_i0) exp(Lc_i0 -
//    Lc_j) (both exponents <= 0), so only the diagonal tiles take an expf
//    per element.
//  * The log-decay cumsum is summed in token order, as a sequential
//    cumsum adds it: its rounding (Lc near -3,000 within a chunk) set the
//    first version's f32 error (4.2e-4 of the 1e-3 tolerance).
// Guards kept from the first version: exp only of non-positive
// differences (j <= i, Lc non-increasing); tokens past S count as dt = 0,
// x = 0, B = C = 0 and no y is written there (the Pallas kernel asserts
// S % chunk == 0); N <= 128, Q <= 256, any S and B; no h0 (the Pallas
// kernel has none). All arithmetic and the state are f32 (expf, not
// __expf); bf16 inputs are widened on load and y is rounded once, on
// store.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/ssd_scan/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;        // rows of a query or key tile
constexpr int LDT = TQ + 4;   // row stride of a staged (transposed) tile
constexpr int QMAX = 256;     // longest chunk (its x slice in shared memory)
constexpr int NMAX = 128;     // largest state dim
constexpr int CB_NT = 256;    // threads of an ssd_cb block (4 x 4 a thread)
constexpr int NT = 256;       // threads of an ssd_chunk block: two halves
constexpr int HALF = NT / 2;
constexpr int PT = 32;        // columns of P a block
constexpr int TB = 32;        // rows of a w B tile in the state pass
constexpr int PRE = TQ * TQ / NT;    // elements of a staged tile a thread
constexpr int XROWS = 16 * NT / PT;  // rows of x loaded in one batch

static_assert(NMAX == 4 * (NT / (PT / 4)), "state tile: 4 p x 4 n a thread");
static_assert(TQ == 4 * (HALF / (PT / 4)), "y tile: 4 rows x 4 p a thread");
static_assert(TB * NMAX == PRE * NT, "every staged tile is PRE a thread");
static_assert(TB * NMAX <= TQ * LDT && TQ * PT <= TQ * LDT,
              "the w B tile and a half's y tile fit the staging buffer");
static_assert(NT == QMAX, "dt and the weights: a row a thread");
static_assert(CB_NT == 2 * NMAX, "ssd_cb: n = tid % NMAX");

struct Smem {
  float x[QMAX * PT];    // the chunk of x: x[t][p]
  float h[NMAX * PT];    // h_{c-1}, transposed: h[n][p]
  float t[TQ * LDT];     // staged tile: w B[j][n], C^T[n][i] or M^T[j][i]
  float lc[QMAX];        // cumulative log-decay in the chunk
  float dt[QMAX];        // dt of the chunk (0 past S)
  float w[QMAX];         // exp(Ltot - Lc_j) dt_j (0 past S)
  float u[TQ];           // exp(Lc_i - Lc_i0) over the query tile at i0
  float v[QMAX];         // exp(Lc_i0 - Lc_j) dt_j, j < i0
  int ticket;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// The scratch a call needs, carved from one allocation: the ticket, one
// flag per (b, h, P slice, chunk), C B^T per (b, chunk) in Qp x Qp
// (Qp = Q rounded up to a tile), two state slots per (b, h, P slice).
struct Layout {
  int n_chunks, n_pt, qp;
  size_t flags, cb, state, bytes;   // byte offsets and the total
};

Layout layout(int B, int S, int H, int P, int N, int Q) {
  Layout l;
  l.n_chunks = (S + Q - 1) / Q;
  l.n_pt = (P + PT - 1) / PT;
  l.qp = (Q + TQ - 1) / TQ * TQ;
  const size_t lines = (size_t)B * H * l.n_pt;
  l.flags = 256;
  l.cb = l.flags + align256(sizeof(int) * lines * l.n_chunks);
  l.state = l.cb + align256(sizeof(float) * B * l.n_chunks * l.qp * l.qp);
  l.bytes = l.state + sizeof(float) * lines * 2 * PT * N;
  return l;
}

constexpr int CB_SMEM = 2 * NMAX * LDT * (int)sizeof(float);

// (i): one 64 x 64 tile (query tile it, key tile jt <= it) of
// CBt[j][i] = C_i . B_j for one (b, chunk); rows past S are zero. Both
// tiles are staged whole (all N) from one batch of loads. Also zeroes the
// ticket and the flags (``n_zero`` ints from ``zero``).
template <typename T>
__global__ void __launch_bounds__(CB_NT)
ssd_cb(const T* __restrict__ Bm, const T* __restrict__ Cm,
       float* __restrict__ cbt, int* __restrict__ zero, int n_zero, int S,
       int N, int Q, int n_chunks, int qp, int pairs) {
  extern __shared__ float4 cb_raw[];
  float* sc = reinterpret_cast<float*>(cb_raw);   // C^T[n][i]
  float* sb = sc + NMAX * LDT;                    // B^T[n][j]
  const int tid = threadIdx.x;
  for (int e = blockIdx.x * CB_NT + tid; e < n_zero; e += gridDim.x * CB_NT)
    zero[e] = 0;

  const int bc = blockIdx.x / pairs;       // b * n_chunks + chunk
  int pr = blockIdx.x - bc * pairs, it = 0;
  while (pr > it) pr -= ++it;              // pairs in order (0,0) (1,0) (1,1)
  const int jt = pr;
  const int b = bc / n_chunks, c = bc - b * n_chunks;
  const int c0 = c * Q, valid = min(Q, S - c0);
  const int i0 = it * TQ, j0 = jt * TQ;
  const T* Cb = Cm + ((size_t)b * S + c0) * N;
  const T* Bb = Bm + ((size_t)b * S + c0) * N;
  const int n = tid % NMAX, r0 = tid / NMAX;
  float cv[TQ / 2], bv[TQ / 2];
#pragma unroll
  for (int q = 0; q < TQ / 2; ++q) {
    const int r = 2 * q + r0;
    cv[q] = n < N && i0 + r < valid ? to_f32(Cb[(size_t)(i0 + r) * N + n])
                                    : 0.f;
    bv[q] = n < N && j0 + r < valid ? to_f32(Bb[(size_t)(j0 + r) * N + n])
                                    : 0.f;
  }
#pragma unroll
  for (int q = 0; q < TQ / 2; ++q) {
    sc[n * LDT + 2 * q + r0] = cv[q];
    sb[n * LDT + 2 * q + r0] = bv[q];
  }
  __syncthreads();
  const int ty = tid / 16, tx = tid % 16;  // 4 key rows x 4 query rows
  float acc[4][4] = {};
#pragma unroll 4
  for (int k = 0; k < N; ++k) {
    const float4 b4 = *reinterpret_cast<const float4*>(&sb[k * LDT + ty * 4]);
    const float4 c4 = *reinterpret_cast<const float4*>(&sc[k * LDT + tx * 4]);
    const float br[4] = {b4.x, b4.y, b4.z, b4.w};
    const float cr[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] += br[r] * cr[q];
  }
  float* out = cbt + (size_t)bc * qp * qp;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(
        &out[(size_t)(j0 + ty * 4 + r) * qp + i0 + tx * 4]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// The steps of an ssd_chunk block, in order: the state pass over w B tiles
// of TB rows (kB, k = row tile); then per query tile it, the inter-chunk
// term over C tiles of 64 n (kC, k = n tile; only from chunk 1 on) and the
// intra-chunk product over key tiles k <= it (kM). Each step stages one
// tile of PRE elements a thread; the next step's elements are fetched into
// registers before the current step's products, so the loads of the next
// tile are in flight while this one is used.
enum Kind { kB, kC, kM, kDone };
struct Step {
  int kind, it, k;
};

__device__ __forceinline__ Step tile_start(int it, bool inter) {
  return Step{inter ? kC : kM, it, 0};
}

__device__ __forceinline__ Step advance(Step s, int nb, int nq, int ncn,
                                        bool inter) {
  if (s.kind == kB)
    return s.k + 1 < nb ? Step{kB, 0, s.k + 1} : tile_start(0, inter);
  if (s.kind == kC)
    return s.k + 1 < ncn ? Step{kC, s.it, s.k + 1} : Step{kM, s.it, 0};
  if (s.k < s.it) return Step{kM, s.it, s.k + 1};
  return s.it + 1 < nq ? tile_start(s.it + 1, inter) : Step{kDone, 0, 0};
}

// Raw elements of a step's tile, element e = tid + q NT: kB B[j0 + e /
// 128][e % 128]; kC and kM of a 64 x 64 tile, row
// e / 64 (query row for kC, key row for kM), column e % 64 (n for kC,
// query row for kM).
template <typename T>
__device__ __forceinline__ void fetch(float (&pre)[PRE], Step s,
                                      const T* __restrict__ Bb,
                                      const T* __restrict__ Cb,
                                      const float* __restrict__ cb,
                                      int valid, int N, int qp) {
  const int tid = threadIdx.x;
  if (s.kind == kB) {
    const int j0 = s.k * TB;
    const int n = tid % NMAX;
#pragma unroll
    for (int q = 0; q < PRE; ++q) {
      const int j = j0 + q * (NT / NMAX) + tid / NMAX;
      pre[q] = j < valid && n < N ? to_f32(Bb[j * N + n]) : 0.f;
    }
  } else if (s.kind == kC) {
    const int i0 = s.it * TQ, n = s.k * TQ + tid % TQ;
#pragma unroll
    for (int q = 0; q < PRE; ++q) {
      const int r = q * (NT / TQ) + tid / TQ;
      pre[q] = i0 + r < valid && n < N ? to_f32(Cb[(i0 + r) * N + n])
                                       : 0.f;
    }
  } else if (s.kind == kM) {
    const int i = s.it * TQ + tid % TQ;
#pragma unroll
    for (int q = 0; q < PRE; ++q) {
      const int j = s.k * TQ + q * (NT / TQ) + tid / TQ;
      pre[q] = j <= i && i < valid ? cb[j * qp + i] : 0.f;
    }
  }
}

// Stage a fetched tile: w B[j][n] (row stride NMAX); C^T[n][i]; M^T[j][i] = exp(Lc_i - Lc_j) CB[i][j] dt_j where j <= i,
// else 0. Off the diagonal (j < i0 <= i) the decay is u_i v_j, both
// factors exp of a non-positive difference; on it, exp(Lc_i - Lc_j) is
// taken where j <= i only. Never exp of a positive difference.
__device__ __forceinline__ void commit(const float (&pre)[PRE], Step s,
                                       Smem& sm, int valid) {
  const int tid = threadIdx.x;
  if (s.kind == kB) {
    const int j0 = s.k * TB;
#pragma unroll
    for (int q = 0; q < PRE; ++q) {
      const int jr = q * (NT / NMAX) + tid / NMAX;
      sm.t[jr * NMAX + tid % NMAX] = pre[q] * sm.w[j0 + jr];
    }
  } else if (s.kind == kC) {
#pragma unroll
    for (int q = 0; q < PRE; ++q)
      sm.t[(tid % TQ) * LDT + q * (NT / TQ) + tid / TQ] = pre[q];
  } else if (s.k < s.it) {
    const int ir = tid % TQ;
    const float ui = s.it * TQ + ir < valid ? sm.u[ir] : 0.f;
#pragma unroll
    for (int q = 0; q < PRE; ++q) {
      const int jr = q * (NT / TQ) + tid / TQ;
      sm.t[jr * LDT + ir] = pre[q] * (ui * sm.v[s.k * TQ + jr]);
    }
  } else {
    const int ir = tid % TQ, i = s.it * TQ + ir;
    const float li = sm.lc[i];
#pragma unroll
    for (int q = 0; q < PRE; ++q) {
      const int jr = q * (NT / TQ) + tid / TQ, j = s.k * TQ + jr;
      sm.t[jr * LDT + ir] = j <= i && i < valid
          ? expf(li - sm.lc[j]) * pre[q] * sm.dt[j] : 0.f;
    }
  }
}

// (ii)-(iv) for one (b, h, chunk, 32 columns of P), in ticket order.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_chunk(const T* __restrict__ x, const T* __restrict__ dt,
          const T* __restrict__ Bm, const T* __restrict__ Cm,
          const float* __restrict__ A, const float* __restrict__ cbt,
          float* __restrict__ state, int* __restrict__ flags,
          int* __restrict__ ticket, T* __restrict__ y,
          float* __restrict__ hout, int B, int S, int H, int P, int N, int Q,
          int n_chunks, int n_pt, int qp) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  if (tid == 0) sm.ticket = atomicAdd(ticket, 1);
  __syncthreads();
  // chunk-major: every block of chunk c-1 took its ticket before chunk c's
  const int per_chunk = B * H * n_pt;
  const int c = sm.ticket / per_chunk;
  const int line = sm.ticket - c * per_chunk;   // (b * H + h) * n_pt + slice
  const int bh = line / n_pt;
  const int p0 = (line - bh * n_pt) * PT;
  const int b = bh / H, hd = bh - b * H;
  const int c0 = c * Q, valid = min(Q, S - c0);
  const int nq = (valid + TQ - 1) / TQ;         // query tiles
  const int nb = (valid + TB - 1) / TB;         // w B tiles
  const int ncn = (N + TQ - 1) / TQ;            // C tiles a query tile
  const bool inter = c > 0;                     // h_{c-1} != 0
  const float a = A[hd];
  const int srow = H * P;     // stride of a token in x, y (offsets in a
                              // chunk fit an int: supported())
  const T* xb = x + ((size_t)b * S + c0) * srow + (size_t)hd * P + p0;
  T* yb = y + ((size_t)b * S + c0) * srow + (size_t)hd * P + p0;
  const T* dtb = dt + ((size_t)b * S + c0) * H + hd;
  const T* Bb = Bm + ((size_t)b * S + c0) * N;
  const T* Cb = Cm + ((size_t)b * S + c0) * N;
  const float* cb = cbt + ((size_t)b * n_chunks + c) * qp * qp;

  Step cur{kB, 0, 0};
  float pre[PRE];
  fetch<T>(pre, cur, Bb, Cb, cb, valid, N, qp);
  sm.dt[tid] = tid < valid ? to_f32(dtb[(size_t)tid * H]) : 0.f;
  const bool pin = p0 + tid % PT < P;           // this thread's x column
  for (int t0 = 0; t0 < valid; t0 += XROWS) {   // x of the chunk
    float v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int t = t0 + q * (NT / PT) + tid / PT;
      v[q] = t < valid && pin ? to_f32(xb[t * srow + tid % PT]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 16; ++q)
      sm.x[(t0 + q * (NT / PT) + tid / PT) * PT + tid % PT] = v[q];
  }
  __syncthreads();
  // the inclusive sum of A dt over the chunk, in token order (as a
  // sequential cumsum adds it): the log-decay sets the error of the
  // result; rows past S add 0
  if (tid == 0) {
    float acc = 0.f;
    for (int t0 = 0; t0 < valid; t0 += 8) {
      float d[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) d[u] = sm.dt[t0 + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        acc = __fadd_rn(acc, __fmul_rn(d[u], a));
        sm.lc[t0 + u] = acc;
      }
    }
  }
  __syncthreads();
  const float ltot = sm.lc[valid - 1];
  if (tid >= valid) sm.lc[tid] = ltot;          // rows past S add nothing
  sm.w[tid] = tid < valid ? expf(ltot - sm.lc[tid]) * sm.dt[tid] : 0.f;

  // Each half of the block takes half of the depth (key rows, n) of every
  // y product and they are summed when a query tile is done; the state
  // pass splits the state's rows over the whole block.
  const int pg = tid % 8;             // columns 4 pg .. 4 pg + 3
  const int ng = tid / 8;             // state rows 4 ng .. + 3
  const int half = tid / HALF;
  const int rg = (tid % HALF) / 8;    // rows 4 rg .. + 3 of a query tile
  float s[4][4] = {};                 // (ii) s_c, then h_c: [p][n]
  float yacc[4][4] = {};              // this half's y of the query tile
  float* slot = state + (size_t)line * 2 * PT * N;   // slots [n][p]

  while (cur.kind != kDone) {
    if (cur.kind != kB && (cur.k == 0 && (cur.kind == kC || !inter))) {
      // a query tile starts: the factors of its off-diagonal decays (the
      // previous tile's commits are behind the last barrier)
      const int i0 = cur.it * TQ;
      if (tid < TQ) sm.u[tid] = expf(sm.lc[i0 + tid] - sm.lc[i0]);
      for (int j = tid; j < i0; j += NT)
        sm.v[j] = expf(sm.lc[i0] - sm.lc[j]) * sm.dt[j];
    }
    __syncthreads();  // the staging buffer is free; w, lc, h, u, v visible
    commit(pre, cur, sm, valid);
    const Step nxt = advance(cur, nb, nq, ncn, inter);
    __syncthreads();
    if (nxt.kind != kDone)
      fetch<T>(pre, nxt, Bb, Cb, cb, valid, N, qp);
    if (cur.kind == kB) {
      // (ii) s_c += x_j (outer) w_j B_j over this tile: 4 p x 4 n
      const int j0 = cur.k * TB, jn = min(TB, valid - j0);
      for (int j = 0; j < jn; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(
            &sm.x[(j0 + j) * PT + pg * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(
            &sm.t[j * NMAX + ng * 4]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) s[k][l] += xr[k] * br[l];
      }
      if (nxt.kind != kB) {
        // (iii) look back for h_{c-1}; publish h_c = exp(Ltot) h_{c-1} + s_c
        if (inter) {
          if (tid == 0) {
            volatile int* f = flags + (size_t)line * n_chunks + c - 1;
            while (*f == 0) __nanosleep(32);
            __threadfence();
          }
          __syncthreads();
          const float* src = slot + (size_t)((c - 1) & 1) * PT * N;
          const float et = expf(ltot);
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const int n = ng * 4 + l;
            const float4 hp = n < N ? __ldcg(reinterpret_cast<const float4*>(
                                          &src[n * PT + pg * 4]))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
            s[0][l] = fmaf(et, hp.x, s[0][l]);
            s[1][l] = fmaf(et, hp.y, s[1][l]);
            s[2][l] = fmaf(et, hp.z, s[2][l]);
            s[3][l] = fmaf(et, hp.w, s[3][l]);
            // h_{c-1} for the inter-chunk term, read after the next barrier
            *reinterpret_cast<float4*>(&sm.h[n * PT + pg * 4]) = hp;
          }
        }
        if (c + 1 < n_chunks) {
          float* dst = slot + (size_t)(c & 1) * PT * N;
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const int n = ng * 4 + l;
            if (n < N)
              __stcg(reinterpret_cast<float4*>(&dst[n * PT + pg * 4]),
                     make_float4(s[0][l], s[1][l], s[2][l], s[3][l]));
          }
          __threadfence();
          __syncthreads();
          if (tid == 0) atomicExch(flags + (size_t)line * n_chunks + c, 1);
        } else {
          float* hb = hout + ((size_t)bh * P + p0) * N;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (p0 + pg * 4 + k >= P) continue;
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              const int n = ng * 4 + l;
              if (n < N) hb[(size_t)(pg * 4 + k) * N + n] = s[k][l];
            }
          }
        }
      }
    } else if (cur.kind == kC) {
      // (iv) y += C_i h_{c-1} over this half of a tile of n: 4 rows x 4 p
      const int n0 = cur.k * TQ, nn = min(TQ, N - n0);
      for (int n = half * (TQ / 2); n < min(nn, (half + 1) * (TQ / 2));
           ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(
            &sm.t[n * LDT + rg * 4]);
        const float4 hv = *reinterpret_cast<const float4*>(
            &sm.h[(n0 + n) * PT + pg * 4]);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) yacc[r][q] += cr[r] * hr[q];
      }
      if (nxt.kind == kM) {   // the tile's inter term, times exp(Lc_i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = expf(sm.lc[cur.it * TQ + rg * 4 + r]);
#pragma unroll
          for (int q = 0; q < 4; ++q) yacc[r][q] *= e;
        }
      }
    } else {
      // (ii) y += M x over this half of a key tile: 4 rows x 4 p
      const int j0 = cur.k * TQ, jn = min(TQ, valid - j0);
      for (int j = half * (TQ / 2); j < min(jn, (half + 1) * (TQ / 2));
           ++j) {
        const float4 mv = *reinterpret_cast<const float4*>(
            &sm.t[j * LDT + rg * 4]);
        const float4 xv = *reinterpret_cast<const float4*>(
            &sm.x[(j0 + j) * PT + pg * 4]);
        const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) yacc[r][q] += mr[r] * xr[q];
      }
      if (cur.k == cur.it) {
        // the query tile is done: the second half's sums join the first's
        // through the staging buffer, and the first half stores y
        __syncthreads();
        float* red = sm.t + (rg * 4) * PT + pg * 4;
        if (half == 1) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<float4*>(&red[r * PT]) =
                make_float4(yacc[r][0], yacc[r][1], yacc[r][2], yacc[r][3]);
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = cur.it * TQ + rg * 4 + r;
          const float4 o = *reinterpret_cast<const float4*>(&red[r * PT]);
          const float other[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (half == 0 && i < valid && p0 + pg * 4 + q < P)
              store(yb + i * srow + pg * 4 + q,
                    yacc[r][q] + other[q]);
            yacc[r][q] = 0.f;
          }
        }
      }
    }
    cur = nxt;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* Bm,
                   const void* Cm, const float* A, void* y, float* h,
                   char* ws, int B, int S, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  const Layout l = layout(B, S, H, P, N, Q);
  const int nt = l.qp / TQ;
  const int pairs = nt * (nt + 1) / 2;
  int* ticket = reinterpret_cast<int*>(ws);
  int* flags = reinterpret_cast<int*>(ws + l.flags);
  float* cbt = reinterpret_cast<float*>(ws + l.cb);
  float* state = reinterpret_cast<float*>(ws + l.state);
  // the ticket and the flags are zeroed by ssd_cb: they are contiguous
  // from the ticket (offset 0) to the end of the flags
  const int n_zero = (int)(l.cb / sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, CB_SMEM);
  if (err != cudaSuccess) return err;
  ssd_cb<T><<<B * l.n_chunks * pairs, CB_NT, CB_SMEM, stream>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), cbt, ticket,
      n_zero, S, N, Q, l.n_chunks, l.qp, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(
      ssd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_chunk<T><<<B * H * l.n_pt * l.n_chunks, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), A, cbt, state,
      flags, ticket, static_cast<T*>(y), h, B, S, H, P, N, Q, l.n_chunks,
      l.n_pt, l.qp);
  return cudaGetLastError();
}

bool supported(int B, int S, int H, int P, int N, int Q) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > NMAX ||
      Q <= 0 || Q > QMAX)
    return false;
  const Layout l = layout(B, S, H, P, N, Q);
  const int nt = l.qp / TQ;
  return (long long)H * P * QMAX <= INT_MAX &&
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

// Dynamic shared memory of an ssd_chunk block, in bytes.
extern "C" int repro_ssd_scan_smem() { return (int)sizeof(Smem); }

// x: (B, S, H, P); dt: (B, S, H); Bm, Cm: (B, S, N); A: (H,) float32;
// y: (B, S, H, P); h: (B, H, P, N) float32; ws: repro_ssd_scan_workspace
// bytes, 256-byte aligned, contents ignored. x, dt, Bm, Cm and y
// contiguous, of one dtype (0 = float32, 1 = bfloat16); Q = min(chunk, S)
// <= 256; N <= 128. Launches two kernels on ``stream``, allocates nothing,
// and returns the cudaError_t of the launches (0 on success).
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
