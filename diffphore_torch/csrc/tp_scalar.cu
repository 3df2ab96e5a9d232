// K3: scalar-path tensor-product aggregate with its backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   diffphore_tpu/ops/pallas/tp_scalar.py::scalar_path_aggregate
// and computes the same function, one l_in = 0 path of a channelwise tensor
// product per launch:
//   out[b,n,u,k] = sum_m x[b,m,u] * sh[b,n,m,k] * w[b,n,m,u]
// x (B,M,U) sender scalars, sh (B,N,M,K) the path's harmonics, w (B,N,M,U) the
// path's pre-masked edge weights, out (B,N,U,K) f32.  The TPU kernel has no
// backward; this file adds one, so that the training step runs hand-written
// kernels in both directions.  With g = dL/dout (B,N,U,K):
//   dw[b,n,m,u]  = x[b,m,u] * sum_k sh[b,n,m,k] g[b,n,u,k]
//   dsh[b,n,m,k] = sum_u x[b,m,u] w[b,n,m,u] g[b,n,u,k]
//   dx[b,m,u]    = sum_n w[b,n,m,u] * sum_k sh[b,n,m,k] g[b,n,u,k]
//
// Every operand is a strided view with a unit last stride: sh and w are
// last-axis slices of a convolution's full harmonics (B,N,M,S) and weights
// (B,N,M,F), out and g are slices of its packed (B,N,F,4) result, and the
// gradients are written into slices of the full dsh, dw and dx.  Nothing is
// copied to make a slice contiguous.
//
// What bounds it on an H100.  Device memory: w is the large operand (17.7 MB
// per path of the widest phore convolution of a 24-complex batch) and the
// forward, dsh and dx kernels read it once, the dw kernel writes its gradient
// once; x, sh, g and out are small beside it.  The arithmetic is 2K + 1
// multiply-adds per edge and channel, far under the byte bound.
//
// Design (simple and correct first; no tensor cores, no TMA):
//  * forward and dw: one block per (batch row, tile of TN receivers), a thread
//    per (receiver, channel) that walks the senders in chunks of MC whose
//    sender scalars and harmonics are staged in shared memory; neighbouring
//    threads read neighbouring channels of one edge's weights;
//  * dsh sums over channels: one block per (batch row, receiver) with that
//    receiver's g in shared memory, a thread per sender that walks its edge's
//    channels;
//  * dx sums over receivers: the roles of N and M swap (block = batch row x
//    tile of TM senders, a thread per (sender, channel), receiver chunks of NC
//    with their harmonics and g staged in shared memory);
//  * K is a template bound (1, 3 or 9 accumulators in registers) with the
//    actual K checked lane by lane;
//  * no atomics: every output element is written by one thread in a fixed
//    order, so two runs on the same inputs agree to the bit.  Where two paths
//    of a convolution share a slice of dsh or dx, the later launch adds to
//    what the earlier one wrote (`accumulate`), in stream order.

#include <cuda_runtime.h>

namespace {

constexpr int TN = 4;            // receivers per block (forward, dw)
constexpr int MC = 16;           // senders per staged chunk (forward, dw)
constexpr int TM = 4;            // senders per block (dx)
constexpr int NC = 16;           // receivers per staged chunk (dx)
constexpr int K_MAX = 9;         // l <= 4
constexpr int U_MAX = 64;        // TN * U and TM * U threads fit one block
constexpr int MAX_THREADS = 256;

// Element strides of the views; the last axis of each has stride 1.
struct NodeStride { long long b, m; };      // (B, M, U)
struct EdgeStride { long long b, n, m; };   // (B, N, M, K) and (B, N, M, U)
struct OutStride { long long b, n, u; };    // (B, N, U, K)

// Stage x of senders [m0, m0 + mc) as s_x[ml * U + u].
__device__ __forceinline__ void stage_x(float* s_x, const float* __restrict__ x, NodeStride xs,
                                        int b, int m0, int mc, int U, int tid, int nt) {
  for (int i = tid; i < mc * U; i += nt) {
    const int ml = i / U, u = i - ml * U;
    s_x[i] = x[b * xs.b + (m0 + ml) * xs.m + u];
  }
}

// Stage the harmonics of receivers [n0, n0 + rows) x senders [m0, m0 + cols)
// as s_sh[(r * pitch + c) * KT + k], zero outside N, M and K.
template <int KT>
__device__ __forceinline__ void stage_sh(float* s_sh, const float* __restrict__ sh, EdgeStride ss,
                                         int b, int n0, int rows, int N, int m0, int cols, int M,
                                         int pitch, int K, int tid, int nt) {
  for (int i = tid; i < rows * cols * KT; i += nt) {
    const int k = i % KT, e = i / KT;
    const int c = e % cols, r = e / cols;
    const int n = n0 + r, m = m0 + c;
    s_sh[(r * pitch + c) * KT + k] =
        (n < N && m < M && k < K) ? sh[b * ss.b + n * ss.n + m * ss.m + k] : 0.f;
  }
}

template <int KT>
__global__ void __launch_bounds__(MAX_THREADS) tp_scalar_fwd_kernel(
    const float* __restrict__ x, NodeStride xs, const float* __restrict__ sh, EdgeStride ss,
    const float* __restrict__ w, EdgeStride ws, float* __restrict__ out, OutStride os,
    int N, int M, int U, int K) {
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;              // MC * U
  float* s_sh = s_x + MC * U;     // TN * MC * KT

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int nl = tid / U, u = tid - nl * U;
  const int n = n0 + nl;
  const bool active = nl < TN && n < N;
  const float* w_row = w + b * ws.b + (active ? n : 0) * ws.n + u;
  float acc[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.f;

  for (int m0 = 0; m0 < M; m0 += MC) {
    const int mc = min(MC, M - m0);
    stage_x(s_x, x, xs, b, m0, mc, U, tid, nt);
    stage_sh<KT>(s_sh, sh, ss, b, n0, TN, N, m0, mc, M, MC, K, tid, nt);
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int ml = 0; ml < mc; ++ml) {
        const float xw = s_x[ml * U + u] * w_row[(m0 + ml) * ws.m];
        const float* sv = s_sh + (nl * MC + ml) * KT;
#pragma unroll
        for (int k = 0; k < KT; ++k) acc[k] = fmaf(xw, sv[k], acc[k]);
      }
    }
    __syncthreads();
  }

  if (active) {
    float* o = out + b * os.b + n * os.n + u * os.u;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < K) o[k] = acc[k];
  }
}

template <int KT>
__global__ void __launch_bounds__(MAX_THREADS) tp_scalar_bwd_w_kernel(
    const float* __restrict__ x, NodeStride xs, const float* __restrict__ sh, EdgeStride ss,
    const float* __restrict__ g, OutStride gs, float* __restrict__ dw, EdgeStride ds,
    int N, int M, int U, int K) {
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;              // MC * U
  float* s_sh = s_x + MC * U;     // TN * MC * KT

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int nl = tid / U, u = tid - nl * U;
  const int n = n0 + nl;
  const bool active = nl < TN && n < N;
  float gk[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k)
    gk[k] = (active && k < K) ? g[b * gs.b + n * gs.n + u * gs.u + k] : 0.f;
  float* dw_row = dw + b * ds.b + (active ? n : 0) * ds.n + u;

  for (int m0 = 0; m0 < M; m0 += MC) {
    const int mc = min(MC, M - m0);
    stage_x(s_x, x, xs, b, m0, mc, U, tid, nt);
    stage_sh<KT>(s_sh, sh, ss, b, n0, TN, N, m0, mc, M, MC, K, tid, nt);
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int ml = 0; ml < mc; ++ml) {
        const float* sv = s_sh + (nl * MC + ml) * KT;
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < KT; ++k) t = fmaf(sv[k], gk[k], t);
        dw_row[(m0 + ml) * ds.m] = s_x[ml * U + u] * t;
      }
    }
    __syncthreads();
  }
}

template <int KT>
__global__ void __launch_bounds__(MAX_THREADS) tp_scalar_bwd_sh_kernel(
    const float* __restrict__ x, NodeStride xs, const float* __restrict__ w, EdgeStride ws,
    const float* __restrict__ g, OutStride gs, float* __restrict__ dsh, EdgeStride ds,
    int N, int M, int U, int K, int accumulate) {
  extern __shared__ __align__(16) float smem[];
  float* s_g = smem;              // U * KT

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y, n = blockIdx.x;
  for (int i = tid; i < U * KT; i += nt) {
    const int u = i / KT, k = i - u * KT;
    s_g[i] = k < K ? g[b * gs.b + n * gs.n + u * gs.u + k] : 0.f;
  }
  __syncthreads();

  for (int m = tid; m < M; m += nt) {
    const float* xr = x + b * xs.b + m * xs.m;
    const float* wr = w + b * ws.b + n * ws.n + m * ws.m;
    float acc[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k] = 0.f;
    for (int u = 0; u < U; ++u) {
      const float xw = xr[u] * wr[u];
      const float* gv = s_g + u * KT;
#pragma unroll
      for (int k = 0; k < KT; ++k) acc[k] = fmaf(xw, gv[k], acc[k]);
    }
    float* o = dsh + b * ds.b + n * ds.n + m * ds.m;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < K) o[k] = accumulate ? o[k] + acc[k] : acc[k];
  }
}

template <int KT>
__global__ void __launch_bounds__(MAX_THREADS) tp_scalar_bwd_x_kernel(
    const float* __restrict__ sh, EdgeStride ss, const float* __restrict__ w, EdgeStride ws,
    const float* __restrict__ g, OutStride gs, float* __restrict__ dx, NodeStride ds,
    int N, int M, int U, int K, int accumulate) {
  extern __shared__ __align__(16) float smem[];
  float* s_sh = smem;                  // NC * TM * KT
  float* s_g = s_sh + NC * TM * KT;    // NC * U * KT

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * TM;
  const int ml = tid / U, u = tid - ml * U;
  const int m = m0 + ml;
  const bool active = ml < TM && m < M;
  const float* w_col = w + b * ws.b + (active ? m : 0) * ws.m + u;
  float acc = 0.f;

  for (int n0 = 0; n0 < N; n0 += NC) {
    const int nc = min(NC, N - n0);
    stage_sh<KT>(s_sh, sh, ss, b, n0, nc, N, m0, TM, M, TM, K, tid, nt);
    for (int i = tid; i < nc * U * KT; i += nt) {
      const int k = i % KT, e = i / KT;
      const int uu = e % U, r = e / U;
      s_g[i] = k < K ? g[b * gs.b + (n0 + r) * gs.n + uu * gs.u + k] : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int r = 0; r < nc; ++r) {
        const float wv = w_col[(n0 + r) * ws.n];
        const float* sv = s_sh + (r * TM + ml) * KT;
        const float* gv = s_g + (r * U + u) * KT;
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < KT; ++k) t = fmaf(sv[k], gv[k], t);
        acc = fmaf(wv, t, acc);
      }
    }
    __syncthreads();
  }

  if (active) {
    float* o = dx + b * ds.b + m * ds.m + u;
    *o = accumulate ? *o + acc : acc;
  }
}

bool bad_shape(int B, int N, int M, int U, int K) {
  return B < 1 || B > 65535 || N < 1 || M < 1 || U < 1 || U > U_MAX || K < 1 || K > K_MAX;
}

int round_up_32(int v) { return ((v + 31) / 32) * 32; }

// The template bound for K accumulators.
int k_bound(int K) { return K == 1 ? 1 : (K <= 3 ? 3 : K_MAX); }

}  // namespace

extern "C" {

// Each function returns a cudaError_t value: 0 when the launch was accepted.
// `strides` holds the element strides of the views in the order of the
// pointer arguments, without the unit last stride of each.

// strides: x (b, m), sh (b, n, m), w (b, n, m), out (b, n, u)
int dp_tp_scalar_fwd(const float* x, const float* sh, const float* w, float* out,
                     const long long* strides, int B, int N, int M, int U, int K, void* stream) {
  if (bad_shape(B, N, M, U, K)) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const NodeStride xs{s[0], s[1]};
  const EdgeStride ss{s[2], s[3], s[4]}, ws{s[5], s[6], s[7]};
  const OutStride os{s[8], s[9], s[10]};
  const dim3 grid((N + TN - 1) / TN, B);
  const int threads = round_up_32(TN * U);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DP_LAUNCH(KT)                                                                   \
  tp_scalar_fwd_kernel<KT><<<grid, threads, sizeof(float) * (MC * U + TN * MC * KT), st>>>( \
      x, xs, sh, ss, w, ws, out, os, N, M, U, K)
  switch (k_bound(K)) {
    case 1: DP_LAUNCH(1); break;
    case 3: DP_LAUNCH(3); break;
    default: DP_LAUNCH(K_MAX); break;
  }
#undef DP_LAUNCH
  return (int)cudaGetLastError();
}

// strides: x (b, m), sh (b, n, m), g (b, n, u), dw (b, n, m)
int dp_tp_scalar_bwd_w(const float* x, const float* sh, const float* g, float* dw,
                       const long long* strides, int B, int N, int M, int U, int K,
                       void* stream) {
  if (bad_shape(B, N, M, U, K)) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const NodeStride xs{s[0], s[1]};
  const EdgeStride ss{s[2], s[3], s[4]};
  const OutStride gs{s[5], s[6], s[7]};
  const EdgeStride ds{s[8], s[9], s[10]};
  const dim3 grid((N + TN - 1) / TN, B);
  const int threads = round_up_32(TN * U);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DP_LAUNCH(KT)                                                                     \
  tp_scalar_bwd_w_kernel<KT><<<grid, threads, sizeof(float) * (MC * U + TN * MC * KT), st>>>( \
      x, xs, sh, ss, g, gs, dw, ds, N, M, U, K)
  switch (k_bound(K)) {
    case 1: DP_LAUNCH(1); break;
    case 3: DP_LAUNCH(3); break;
    default: DP_LAUNCH(K_MAX); break;
  }
#undef DP_LAUNCH
  return (int)cudaGetLastError();
}

// strides: x (b, m), w (b, n, m), g (b, n, u), dsh (b, n, m)
int dp_tp_scalar_bwd_sh(const float* x, const float* w, const float* g, float* dsh,
                        const long long* strides, int B, int N, int M, int U, int K,
                        int accumulate, void* stream) {
  if (bad_shape(B, N, M, U, K)) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const NodeStride xs{s[0], s[1]};
  const EdgeStride ws{s[2], s[3], s[4]};
  const OutStride gs{s[5], s[6], s[7]};
  const EdgeStride ds{s[8], s[9], s[10]};
  const dim3 grid(N, B);
  const int threads = M >= 128 ? 128 : round_up_32(M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DP_LAUNCH(KT)                                                          \
  tp_scalar_bwd_sh_kernel<KT><<<grid, threads, sizeof(float) * (U * KT), st>>>( \
      x, xs, w, ws, g, gs, dsh, ds, N, M, U, K, accumulate)
  switch (k_bound(K)) {
    case 1: DP_LAUNCH(1); break;
    case 3: DP_LAUNCH(3); break;
    default: DP_LAUNCH(K_MAX); break;
  }
#undef DP_LAUNCH
  return (int)cudaGetLastError();
}

// strides: sh (b, n, m), w (b, n, m), g (b, n, u), dx (b, m)
int dp_tp_scalar_bwd_x(const float* sh, const float* w, const float* g, float* dx,
                       const long long* strides, int B, int N, int M, int U, int K,
                       int accumulate, void* stream) {
  if (bad_shape(B, N, M, U, K)) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const EdgeStride ss{s[0], s[1], s[2]}, ws{s[3], s[4], s[5]};
  const OutStride gs{s[6], s[7], s[8]};
  const NodeStride ds{s[9], s[10]};
  const dim3 grid((M + TM - 1) / TM, B);
  const int threads = round_up_32(TM * U);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DP_LAUNCH(KT)                                                                        \
  tp_scalar_bwd_x_kernel<KT>                                                                 \
      <<<grid, threads, sizeof(float) * (NC * TM * KT + NC * U * KT), st>>>(                 \
          sh, ss, w, ws, g, gs, dx, ds, N, M, U, K, accumulate)
  switch (k_bound(K)) {
    case 1: DP_LAUNCH(1); break;
    case 3: DP_LAUNCH(3); break;
    default: DP_LAUNCH(K_MAX); break;
  }
#undef DP_LAUNCH
  return (int)cudaGetLastError();
}

const char* dp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
