// Mamba2 SSD chunked scan for Hopper (sm_90a): per (batch, head),
//   h_t = exp(A dt_t) h_{t-1} + dt_t x_t (outer) B_t,   y_t = h_t C_t,
// computed chunk by chunk with an f32 (P, N) state carried between chunks.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:74 ssd_scan_bh (_ssd_kernel,
//   pl.pallas_call at :87), wrapper src/repro/kernels/ssd_scan/ops.py
//   ssd_scan; the model computes the same function in
//   src/repro/models/mamba2.py:66 _ssd_chunked.
// Within a chunk of Q tokens with cumulative log-decay Lc (Lc_t = sum of
// A dt_u over u <= t in the chunk, Ltot = Lc_{Q-1}):
//   y_i   = sum_{j<=i} exp(Lc_i - Lc_j) (C_i . B_j) dt_j x_j      (intra)
//         + exp(Lc_i) h_prev C_i                                (inter)
//   h_new = exp(Ltot) h_prev + sum_j exp(Ltot - Lc_j) dt_j x_j (outer) B_j
// It computes what _ssd_kernel computes, not block for block:
//  * The TPU walks the chunks on a sequential grid axis with the state in
//    VMEM scratch. Here one thread block per (b, h, 32 columns of P) walks
//    the chunks of its sequence itself, its (32, N) slice of the state in
//    shared memory: the columns of y and the rows of h are independent
//    over P. mamba2-1.3b (H 64, P 64) gives 128 blocks at batch 1.
//  * B and C are shared across heads and read from the (B, S, N) tensors
//    directly; the JAX wrapper broadcasts them H times over first.
//  * The (Q, Q) decay-times-scores matrix does not fit a block's shared
//    memory at Q = 256 (256 KB in f32). It is computed one 64 x 64 tile at
//    a time (query rows x key rows); tiles above the diagonal are skipped,
//    and exp(Lc_i - Lc_j) is taken only where j <= i (never of a positive
//    difference, which could overflow).
//  * Any S: the Pallas kernel asserts S % chunk == 0; here the tokens past
//    S in the last chunk count as dt = 0 and x = 0 (as _ssd_chunked pads
//    them), tiles made only of them are skipped, and no y is written there.
// All arithmetic and the state are f32; bf16 inputs are widened on load
// and y is rounded once, on store. Exponentials use expf, not __expf: the
// state crosses up to 4 chunks at S = 1024.
//
// What bounds it on this card (mamba2-1.3b prefill of 1024 tokens at
// batch 1, f32 inputs as the model passes them: H 64, P 64, N 128, Q 256).
// Counting only the Q (Q + 1) / 2 pairs j <= i of each chunk's triangle,
// and C B^T once per (b, chunk), as B and C are shared over heads, the
// work is about 3.26 GFLOP of f32 FMA, 0.049 ms at 67 TFLOP/s; it moves
// about 37 MB (x and y 16.8 MB each, the state 2.1 MB), 0.011 ms at
// 3.35 TB/s: bound by operations. What the design
// does about it: every product is register-tiled out of shared memory
// (4 x 4 score tiles per thread, 2 x 4 output and 4 x 4 state tiles), the
// diagonal's upper tiles and the padded tail are skipped, and the state
// update of a chunk is folded into the last query tile's pass over the
// key tiles, so each B tile is staged once for both. This first version
// recomputes C B^T in every block (once per head and P slice: 2 x 64 x
// the shared count) and uses f32 FMA only; computing C B^T once per
// (b, chunk), tensor cores (mma.sync / wgmma) and TMA are later work.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/ssd_scan/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int PT = 32;      // columns of P per block
constexpr int TQ = 64;      // rows of a query or key tile
constexpr int QMAX = 256;   // longest chunk (one row per thread in the scan)
constexpr int NMAX = 128;   // largest state dim
constexpr int LD = TQ + 4;  // row stride of the transposed B, C tiles and s

static_assert(QMAX == NT, "the log-decay scan gives each row one thread");
static_assert(NMAX == 4 * (NT / (PT / 4)), "state tile: 4 n x 4 p a thread");

struct Smem {
  float h[NMAX * PT];    // state slice, transposed: h[n][p]
  float x[QMAX * PT];    // the chunk of x: x[t][p]
  float ct[NMAX * LD];   // C of the query tile, transposed: ct[n][i]
  float bt[NMAX * LD];   // B of the key tile, transposed: bt[n][j]
  float s[TQ * LD];      // masked, scaled scores of a tile pair: s[i][j]
  float lc[QMAX];        // cumulative log-decay in the chunk
  float dt[QMAX];        // dt of the chunk (0 past S)
  float w[QMAX];         // exp(Ltot - Lc_j) dt_j
  float warp_sum[NT / 32];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + rows) of a (S, N) matrix into dst[n][r], r < TQ;
// rows past ``rows`` are zero
template <typename T>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src,
                                            int row0, int rows, int N) {
  for (int e = threadIdx.x; e < TQ * N; e += NT) {
    const int r = e / N, n = e - r * N;
    dst[n * LD + r] =
        r < rows ? to_f32(src[(size_t)(row0 + r) * N + n]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_fwd(const T* __restrict__ x, const T* __restrict__ dt,
        const T* __restrict__ Bm, const T* __restrict__ Cm,
        const float* __restrict__ A, T* __restrict__ y,
        float* __restrict__ hout, int S, int H, int P, int N, int Q) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_pt = (P + PT - 1) / PT;
  const int bh = blockIdx.x / n_pt;
  const int p0 = (blockIdx.x - bh * n_pt) * PT;
  const int b = bh / H, hd = bh - b * H;
  const float a = A[hd];
  const size_t srow = (size_t)H * P;  // stride of one token in x and y
  const T* xb = x + (size_t)b * S * srow + (size_t)hd * P + p0;
  T* yb = y + (size_t)b * S * srow + (size_t)hd * P + p0;
  const T* dtb = dt + (size_t)b * S * H + hd;
  const T* Bb = Bm + (size_t)b * S * N;
  const T* Cb = Cm + (size_t)b * S * N;

  for (int e = tid; e < NMAX * PT; e += NT) sm.h[e] = 0.f;

  // thread roles: a 4 x 4 block of a 64 x 64 score tile; 2 rows x 4
  // columns of a 64 x 32 output tile; 4 n x 4 p of the 128 x 32 state
  const int sy = tid / 16, sx = tid % 16;
  const int oy = tid / 8, ox = tid % 8;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * Q;
    const int valid = min(Q, S - c0);          // rows inside the sequence
    const int nt = (valid + TQ - 1) / TQ;      // tiles holding such rows
    __syncthreads();  // the previous chunk is done with x, lc, dt, w, h

    // dt and the inclusive scan of A dt over the chunk, a row per thread
    const float d = tid < valid ? to_f32(dtb[(size_t)(c0 + tid) * H]) : 0.f;
    float v = d * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) sm.warp_sum[warp] = v;
    for (int e = tid; e < nt * TQ * PT; e += NT) {
      const int t = e / PT, p = e - t * PT;
      sm.x[e] = (t < valid && p0 + p < P)
                    ? to_f32(xb[(size_t)(c0 + t) * srow + p]) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < warp; ++k) v += sm.warp_sum[k];
    sm.lc[tid] = v;
    sm.dt[tid] = d;
    __syncthreads();
    const float ltot = sm.lc[Q - 1];           // rows past S add nothing
    sm.w[tid] = expf(ltot - v) * d;

    float hacc[4][4] = {};                     // this chunk's state update
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * TQ;
      const bool last = it == nt - 1;
      __syncthreads();  // ct and s are free; w is visible
      load_tile_t(sm.ct, Cb, c0 + i0, valid - i0, N);
      __syncthreads();

      // inter-chunk term: exp(Lc_i) sum_n C[i][n] h[n][p]
      float yacc[2][4] = {};
      for (int n = 0; n < N; ++n) {
        const float2 cv = *reinterpret_cast<const float2*>(
            &sm.ct[n * LD + oy * 2]);
        const float4 hv = *reinterpret_cast<const float4*>(
            &sm.h[n * PT + ox * 4]);
        yacc[0][0] += cv.x * hv.x; yacc[0][1] += cv.x * hv.y;
        yacc[0][2] += cv.x * hv.z; yacc[0][3] += cv.x * hv.w;
        yacc[1][0] += cv.y * hv.x; yacc[1][1] += cv.y * hv.y;
        yacc[1][2] += cv.y * hv.z; yacc[1][3] += cv.y * hv.w;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float e = expf(sm.lc[i0 + oy * 2 + r]);
#pragma unroll
        for (int l = 0; l < 4; ++l) yacc[r][l] *= e;
      }

      // key tiles up to the diagonal; the last query tile's walk stages
      // every B tile of the chunk, so its B tiles also give the state update
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TQ;
        __syncthreads();  // bt and s are free
        load_tile_t(sm.bt, Bb, c0 + j0, valid - j0, N);
        __syncthreads();
        float sc[4][4] = {};
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(
              &sm.ct[n * LD + sy * 4]);
          const float4 bv = *reinterpret_cast<const float4*>(
              &sm.bt[n * LD + sx * 4]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) sc[r][q] += cr[r] * br[q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + sy * 4 + r;
          float o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + sx * 4 + q;
            o[q] = j <= i ? sc[r][q] * expf(sm.lc[i] - sm.lc[j]) * sm.dt[j]
                          : 0.f;
          }
          *reinterpret_cast<float4*>(&sm.s[(sy * 4 + r) * LD + sx * 4]) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
        __syncthreads();
        // intra-chunk term: s @ x over this key tile
        for (int j = 0; j < TQ; ++j) {
          const float s0 = sm.s[(oy * 2) * LD + j];
          const float s1 = sm.s[(oy * 2 + 1) * LD + j];
          const float4 xv = *reinterpret_cast<const float4*>(
              &sm.x[(j0 + j) * PT + ox * 4]);
          yacc[0][0] += s0 * xv.x; yacc[0][1] += s0 * xv.y;
          yacc[0][2] += s0 * xv.z; yacc[0][3] += s0 * xv.w;
          yacc[1][0] += s1 * xv.x; yacc[1][1] += s1 * xv.y;
          yacc[1][2] += s1 * xv.z; yacc[1][3] += s1 * xv.w;
        }
        if (last && oy * 4 < N) {
          // state update: sum_j B[j][n] w_j x[j][p] over this key tile
          for (int j = 0; j < TQ; ++j) {
            const float wj = sm.w[j0 + j];
            const float4 xv = *reinterpret_cast<const float4*>(
                &sm.x[(j0 + j) * PT + ox * 4]);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float bw = sm.bt[(oy * 4 + k) * LD + j] * wj;
              hacc[k][0] += bw * xv.x; hacc[k][1] += bw * xv.y;
              hacc[k][2] += bw * xv.z; hacc[k][3] += bw * xv.w;
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + oy * 2 + r;
        if (i >= valid) continue;
#pragma unroll
        for (int l = 0; l < 4; ++l)
          if (p0 + ox * 4 + l < P)
            store(yb + (size_t)(c0 + i) * srow + ox * 4 + l, yacc[r][l]);
      }
    }

    // h = exp(Ltot) h + update: each thread owns its 4 x 4 entries, and
    // every reader of h in this chunk (the inter terms) has passed a
    // barrier since
    const float et = expf(ltot);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = oy * 4 + k;
      if (n >= N) continue;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float& hv = sm.h[n * PT + ox * 4 + l];
        hv = et * hv + hacc[k][l];
      }
    }
  }

  __syncthreads();
  float* hb = hout + ((size_t)bh * P + p0) * N;
  for (int e = tid; e < PT * N; e += NT) {
    const int p = e / N, n = e - p * N;
    if (p0 + p < P) hb[(size_t)p * N + n] = sm.h[n * PT + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* Bm,
                   const void* Cm, const float* A, void* y, float* h, int B,
                   int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = B * H * ((P + PT - 1) / PT);
  ssd_fwd<T><<<blocks, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), A,
      static_cast<T*>(y), h, S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// x: (B, S, H, P); dt: (B, S, H); Bm, Cm: (B, S, N); A: (H,) float32;
// y: (B, S, H, P); h: (B, H, P, N) float32. x, dt, Bm, Cm and y contiguous,
// of one dtype (0 = float32, 1 = bfloat16); Q = min(chunk, S) <= 256;
// N <= 128. Launches on ``stream``, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* Bm,
                              const void* Cm, const void* A, void* y, void* h,
                              int dtype, int B, int S, int H, int P, int N,
                              int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > NMAX ||
      Q <= 0 || Q > QMAX ||
      (long long)B * H * ((P + PT - 1) / PT) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  float* hf = static_cast<float*>(h);
  if (dtype == 0)
    return (int)launch<float>(x, dt, Bm, Cm, a, y, hf, B, S, H, P, N, Q, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, Bm, Cm, a, y, hf, B, S, H, P,
                                      N, Q, st);
  return (int)cudaErrorInvalidValue;
}
