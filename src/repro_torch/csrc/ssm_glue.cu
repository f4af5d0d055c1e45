// The elementwise glue of Mamba2's SSD block at prefill, on each side of
// ssd_scan, for Hopper (sm_90a), as two kernels:
//
//   ssm_conv_act   before the scan: the depthwise causal convs of x (d_inner
//                  channels), B and C (N each), width W = 4 (mamba2's) with
//                  W - 1 zero rows in front, each summed in f32 and put through SiLU, the
//                  result rounded to the model's dtype (where the plain
//                  version stores it) and written in f32, the dtype ssd_scan
//                  reads; dt' = softplus(dt + dt_bias) per head in f32; and
//                  the conv state the decode step continues from, the last
//                  W - 1 input rows of x, B and C.
//   ssm_gate_norm  after the scan, one block a token row: g = (y + D[h] x)
//                  silu(z) in f32, rounded to the model's dtype (the plain
//                  version's y.to(x.dtype)), then the gated RMSNorm,
//                  round(round(g rsqrt(mean(g^2) + eps)) gn), written in the
//                  model's dtype for the out projection.
//
// Replaces no TPU kernel: the JAX package leaves these ops to XLA, which
// fuses them (src/repro/models/mamba2.py ssm_block_apply); in the port they
// ran as some twenty PyTorch elementwise launches a layer, each reading
// and writing the whole (B, S, d_inner) tensor. The plain versions are
// repro_torch/models/mamba2.py _conv_act and _gate_norm.
//
// What bounds them on this card: bytes. Each reads its inputs once and
// writes its outputs once, and does a few operations an element: at
// mamba2-1.3b's widths (d_inner 4096, N 128, 64 heads) ssm_conv_act moves
// 26.5 KB a token (bf16 in, f32 out) and ssm_gate_norm 48 KB (y and x in
// f32, z in, the output out in bf16).
// What the design does about it: every load and store is 16 bytes a
// thread (8 channels: one bf16 vector, or two f32 ones), neighbouring
// threads on neighbouring channels, so each warp moves whole rows.
// ssm_conv_act gives a thread 8 channels of ROWS = 4 consecutive tokens: it
// loads the W - 1 rows before its first and keeps a window of the last W
// rows in registers, so no strided or padded copy is made; the rows a
// thread re-reads were read by its neighbour tile just before (L2). Few
// rows a thread and no guard on a whole tile keep many loads in flight:
// at 16 rows a thread, or with softplus of dt on 8 threads a tile of 16
// tokens, it reached 46-54% of its bytes bound, at 4 rows and dt spread
// over a thread a token and 8 heads 59-62% (B 8, S 1024-4096, H100). The
// thread holding a sequence's last row writes the conv state from that
// window (zero rows where S < W - 1, as the zero pad). ssm_gate_norm keeps a row's rounded gated values in
// registers between the sum of squares (warp shuffles, then one warp over
// the block's partial sums) and the normalisation.
//
// Built by nvcc into a shared library with a plain C entry point and
// loaded with ctypes (repro_torch/kernels/ssm_glue/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;          // channels a thread: 16 bytes of bf16
constexpr int W = 4;            // the conv's width (mamba2's d_conv)
constexpr int ROWS = 4;         // tokens a conv thread walks
constexpr int MAX_CHUNKS = 4;   // 8-channel chunks a gate_norm thread holds
constexpr int NORM_THREADS = 256;
constexpr int CONV_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T (to nearest, ties to even) and widened back
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// torch.nn.functional.silu and softplus (beta 1, threshold 20) in f32, as
// PyTorch computes them: x / (1 + exp(-x)); x above 20, else log1p(exp(x))
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

// One 8-channel column of x, B or C over the ROWS tokens from s0: the
// conv's window win[i] holds token s - (W - 1) + i while token s is
// computed (rows before the sequence are the zero pad). FULL: all ROWS
// tokens lie in the sequence, so no row is guarded and the loads of later
// rows may be issued before earlier rows are done. The tile holding the
// sequence's last token writes the conv state from the window.
template <typename T, bool FULL>
__device__ __forceinline__ void conv_column(const T* __restrict__ in,
                                            const T* __restrict__ w,
                                            float* __restrict__ out,
                                            T* __restrict__ state, int C,
                                            int c, int s0, int S, int b) {
  const size_t row0 = (size_t)b * S;          // the sequence's first token
  float wt[W][VEC];
#pragma unroll
  for (int i = 0; i < W; ++i) load8(w + (size_t)i * C + c, wt[i]);
  float win[W][VEC];
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    const int s = s0 - (W - 1) + i;
    if (s >= 0) {
      load8(in + (row0 + s) * C + c, win[i]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) win[i][k] = 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int s = s0 + r;
    if (FULL || s < S) {
      load8(in + (row0 + s) * C + c, win[W - 1]);
      float o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < W; ++i) acc = fmaf(win[i][k], wt[i][k], acc);
        o[k] = rnd<T>(silu(acc));
      }
      store8(out + (row0 + s) * C + c, o);
#pragma unroll
      for (int i = 0; i < W - 1; ++i)
#pragma unroll
        for (int k = 0; k < VEC; ++k) win[i][k] = win[i + 1][k];
    }
  }
  if (s0 + ROWS >= S) {
    // win[0 .. W-2] are tokens S - W + 1 .. S - 1, the conv state; exact
    // in T, since they were read from it
    T* st = state + (size_t)b * (W - 1) * C + c;
#pragma unroll
    for (int i = 0; i < W - 1; ++i) store8(st + (size_t)i * C, win[i]);
  }
}

// grid (B * ceil(S / ROWS), column blocks); a thread owns one 8-channel
// column of x, B or C (the conv) over ROWS tokens, or 8 heads of dt in one
// of those tokens.
template <typename T>
__global__ void __launch_bounds__(CONV_THREADS)
ssm_conv_act(const T* __restrict__ x, const T* __restrict__ bm,
             const T* __restrict__ cm, const T* __restrict__ dt,
             const T* __restrict__ wx, const T* __restrict__ wb,
             const T* __restrict__ wc, const T* __restrict__ dt_bias,
             float* __restrict__ xo, float* __restrict__ bo,
             float* __restrict__ co, float* __restrict__ dto,
             T* __restrict__ sx, T* __restrict__ sb, T* __restrict__ sc,
             int S, int DI, int N, int H, int tiles) {
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int s0 = (blockIdx.x % tiles) * ROWS;
  const int nx = DI / VEC, nn = N / VEC;
  if (v < nx + 2 * nn) {
    const T* in;
    const T* w;
    float* out;
    T* state;
    int C, c;
    if (v < nx) {
      in = x; w = wx; out = xo; state = sx; C = DI; c = v * VEC;
    } else if (v < nx + nn) {
      in = bm; w = wb; out = bo; state = sb; C = N; c = (v - nx) * VEC;
    } else {
      in = cm; w = wc; out = co; state = sc; C = N; c = (v - nx - nn) * VEC;
    }
    if (s0 + ROWS <= S)
      conv_column<T, true>(in, w, out, state, C, c, s0, S, b);
    else
      conv_column<T, false>(in, w, out, state, C, c, s0, S, b);
  } else {
    const int q = v - nx - 2 * nn, hc = H / VEC;
    const int s = s0 + q / hc, h0 = (q % hc) * VEC;
    if (q >= ROWS * hc || s >= S) return;
    const size_t o = ((size_t)b * S + s) * H + h0;
    float d[VEC], bias[VEC];
    load8(dt + o, d);
    load8(dt_bias + h0, bias);
#pragma unroll
    for (int k = 0; k < VEC; ++k) d[k] = softplus(__fadd_rn(d[k], bias[k]));
    store8(dto + o, d);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (B * S): one block a token row of DI channels, a thread holding up
// to MAX_CHUNKS chunks of 8 channels (chunk j * blockDim + tid).
template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
ssm_gate_norm(const float* __restrict__ y, const float* __restrict__ xh,
              const T* __restrict__ z, const T* __restrict__ dskip,
              const T* __restrict__ gn, T* __restrict__ out, int DI, int P,
              float eps) {
  __shared__ float part[NORM_THREADS / 32];
  const size_t row = (size_t)blockIdx.x * DI;
  const int chunks = DI / VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float g[MAX_CHUNKS][VEC];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    const int q = j * blockDim.x + threadIdx.x;
    if (q < chunks) {
      const int c = q * VEC;
      float yv[VEC], xv[VEC], zv[VEC];
      load8(y + row + c, yv);
      load8(xh + row + c, xv);
      load8(z + row + c, zv);
      const float d = to_f32(dskip[c / P]);    // P % 8 == 0: one head
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        // the plain version's ops, each rounded to f32 as it rounds them
        const float t = __fmul_rn(__fadd_rn(yv[k], __fmul_rn(d, xv[k])),
                                  silu(zv[k]));
        g[j][k] = rnd<T>(t);
        ss = fmaf(g[j][k], g[j][k], ss);
      }
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(part[0] / (float)DI, eps));
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    const int q = j * blockDim.x + threadIdx.x;
    if (q < chunks) {
      const int c = q * VEC;
      float wv[VEC], o[VEC];
      load8(gn + c, wv);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o[k] = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(g[j][k], r)), wv[k]));
      store8(out + row + c, o);
    }
  }
}

template <typename T>
cudaError_t launch_conv(const void* x, const void* bm, const void* cm,
                        const void* dt, const void* wx, const void* wb,
                        const void* wc, const void* dt_bias, float* xo,
                        float* bo, float* co, float* dto, void* sx, void* sb,
                        void* sc, int B, int S, int DI, int N, int H,
                        cudaStream_t stream) {
  const int cols = DI / VEC + 2 * (N / VEC) + ROWS * (H / VEC);
  // the fewest blocks of at most CONV_THREADS over the columns, each a
  // whole number of warps (576 columns at mamba2-1.3b's widths: 3 x 192)
  const int nblk = (cols + CONV_THREADS - 1) / CONV_THREADS;
  const int threads = ((cols + nblk - 1) / nblk + 31) / 32 * 32;
  const int tiles = (S + ROWS - 1) / ROWS;
  const dim3 grid((unsigned)B * tiles, nblk);
  ssm_conv_act<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(dt),
      static_cast<const T*>(wx), static_cast<const T*>(wb),
      static_cast<const T*>(wc), static_cast<const T*>(dt_bias), xo, bo, co,
      dto, static_cast<T*>(sx), static_cast<T*>(sb), static_cast<T*>(sc), S,
      DI, N, H, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_norm(const float* y, const float* xh, const void* z,
                        const void* dskip, const void* gn, void* out, int B,
                        int S, int DI, int P, float eps,
                        cudaStream_t stream) {
  const int chunks = DI / VEC;
  const int threads = min(NORM_THREADS, (chunks + 31) / 32 * 32);
  ssm_gate_norm<T><<<(unsigned)((size_t)B * S), threads, 0, stream>>>(
      y, xh, static_cast<const T*>(z), static_cast<const T*>(dskip),
      static_cast<const T*>(gn), static_cast<T*>(out), DI, P, eps);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, DI), bm and cm (B, S, N), dt (B, S, H), wx (4, DI), wb and wc
// (4, N), dt_bias (H,): contiguous, of one dtype (0 = float32, 1 =
// bfloat16), on 16-byte boundaries; DI, N and H multiples of 8. Writes xo (B, S, DI), bo and co (B, S, N),
// dto (B, S, H) in float32 and the states sx (B, W-1, DI), sb and sc
// (B, W-1, N) in the input dtype. Launches once on ``stream``, allocates
// nothing, and returns the cudaError_t of the launch (0 on success).
extern "C" int repro_ssm_conv_act(const void* x, const void* bm,
                                  const void* cm, const void* dt,
                                  const void* wx, const void* wb,
                                  const void* wc, const void* dt_bias,
                                  void* xo, void* bo, void* co, void* dto,
                                  void* sx, void* sb, void* sc, int dtype,
                                  int B, int S, int DI, int N, int H,
                                  void* stream) {
  if (B <= 0 || S <= 0 || DI <= 0 || N <= 0 || H <= 0 || DI % VEC ||
      N % VEC || H % VEC || (long long)B * ((S + ROWS - 1) / ROWS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* xof = static_cast<float*>(xo);
  float* bof = static_cast<float*>(bo);
  float* cof = static_cast<float*>(co);
  float* dtof = static_cast<float*>(dto);
  if (dtype == 0)
    return (int)launch_conv<float>(x, bm, cm, dt, wx, wb, wc, dt_bias, xof,
                                   bof, cof, dtof, sx, sb, sc, B, S, DI, N,
                                   H, st);
  if (dtype == 1)
    return (int)launch_conv<__nv_bfloat16>(x, bm, cm, dt, wx, wb, wc,
                                           dt_bias, xof, bof, cof, dtof, sx,
                                           sb, sc, B, S, DI, N, H, st);
  return (int)cudaErrorInvalidValue;
}

// y and xh (B, S, DI) float32 (DI = H P, the heads' channels in order),
// z (B, S, DI), dskip (H,), gn (DI,) and out (B, S, DI) of one dtype (0 =
// float32, 1 = bfloat16): contiguous, on 16-byte boundaries; P a multiple
// of 8, DI at most 8 x MAX_CHUNKS x NORM_THREADS. Launches once on
// ``stream``, allocates nothing, and returns the cudaError_t of the launch.
extern "C" int repro_ssm_gate_norm(const void* y, const void* xh,
                                   const void* z, const void* dskip,
                                   const void* gn, void* out, float eps,
                                   int dtype, int B, int S, int DI, int P,
                                   void* stream) {
  if (B <= 0 || S <= 0 || P <= 0 || P % VEC || DI % P ||
      DI > VEC * MAX_CHUNKS * NORM_THREADS ||
      (long long)B * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* xf = static_cast<const float*>(xh);
  if (dtype == 0)
    return (int)launch_norm<float>(yf, xf, z, dskip, gn, out, B, S, DI, P,
                                   eps, st);
  if (dtype == 1)
    return (int)launch_norm<__nv_bfloat16>(yf, xf, z, dskip, gn, out, B, S,
                                           DI, P, eps, st);
  return (int)cudaErrorInvalidValue;
}

// The largest d_inner ssm_gate_norm takes (its registers hold a row).
extern "C" int repro_ssm_glue_max_inner() {
  return VEC * MAX_CHUNKS * NORM_THREADS;
}
