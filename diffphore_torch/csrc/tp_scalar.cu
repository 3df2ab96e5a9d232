// K3: scalar-path tensor-product aggregate with its backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   diffphore_tpu/ops/pallas/tp_scalar.py::scalar_path_aggregate
// and computes the same function for the l_in = 0 paths of a channelwise
// tensor product.  Per path p, with channels u of the path and c_p its scaled
// coupling (alpha * cg(0, l, l), a multiple of the identity: 1 in f32, the
// bf16-rounded value where the convolution computes in bf16):
//   out[b,n,u,k] = c_p * sum_m x[b,m,u] * sh[b,n,m,k] * w[b,n,m,u]
// x (B,M,U) sender scalars, sh (B,N,M,K) the path's harmonics, w (B,N,M,U) the
// path's pre-masked edge weights.  The TPU kernel has no backward; this file
// adds one, so that the training step runs hand-written kernels in both
// directions.  With g = dL/dout (B,N,U,K):
//   dw[b,n,m,u]  = c_p x[b,m,u] * sum_k sh[b,n,m,k] g[b,n,u,k]
//   dsh[b,n,m,k] = c_p sum_u x[b,m,u] w[b,n,m,u] g[b,n,u,k]
//   dx[b,m,u]    = c_p sum_n w[b,n,m,u] * sum_k sh[b,n,m,k] g[b,n,u,k]
// x, sh and w are f32 or bf16 (a template parameter), read as they are and
// multiplied and summed in f32; the output and g are f32; dw, dsh and dx are
// stored in the operands' type.
//
// What bounds it on an H100.  Device memory: w is the large operand (35 MB
// for the two paths of the widest phore convolution of a 24-complex batch in
// f32, half that in bf16) and the forward, dsh and dx kernels read it once,
// the dw kernel writes its gradient once; x, sh, g and out are small beside
// it.  The arithmetic is 2K + 1 multiply-adds per edge and channel, far
// under the byte bound.  Over the six layer-0 convolutions of a training step
// the forward's and dx's bound is about 25 us in f32, so one launch per path
// and narrow grids of small blocks would leave the launch floor and idle SMs
// in charge: hence one launch per convolution and split summed axes.
//
// Forward and dx (one launch per convolution, all its paths):
//  * thread = (kept entry, channel) over the full weight row of F channels:
//    a block keeps THREADS / F receivers (forward) or senders (dx) of one
//    batch row, so the F threads of one entry read a row of w coalesced, and
//    x (forward) or the receiver's g (dx, one float4 per channel) once;
//  * per channel a small table gives its x element, its harmonics' offset
//    and K (1 or 3), and c_p; the three sums are kept branch-free, the lanes
//    past K dropped at the end (and g's pad lanes never read);
//  * the summed axis (senders for the forward, receivers for dx) is cut into
//    contiguous chunks across blocks until the grid fills every block slot
//    the card holds at these widths (an occupancy query), none shorter than
//    eight entries: split blocks write f32 partial sums to a scratch buffer
//    that a second kernel adds in a fixed order.  No barrier in the forward,
//    one in dx, which adds the channels that read one input element in the
//    block, in the order of a host-built list.  No float atomics: two runs
//    agree to the bit.
// dw and dsh (one launch per path, on strided views):
//  * dw: one block per (batch row, tile of TN receivers), a thread per
//    (receiver, channel) that walks the senders in chunks of MC whose sender
//    scalars and harmonics are staged in shared memory;
//  * dsh sums over channels: one block per (batch row, receiver) with that
//    receiver's g in shared memory, a thread per sender that walks its
//    edge's channels;
//  * every operand is a strided view with a unit last stride (sh and w are
//    last-axis slices of the convolution's full tensors, g a slice of its
//    packed (B,N,F,4) gradient), and the gradients are written into slices
//    of the full dsh and dw; where two paths share a slice of dsh, the later
//    launch adds to what the earlier one wrote, in stream order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;     // threads of a forward or dx block (at most)
constexpr int TN = 4;            // receivers per block (dw)
constexpr int MC = 16;           // senders per staged chunk (dw)
constexpr int K_MAX = 9;         // l <= 4 (dw, dsh)
constexpr int U_MAX = 64;        // TN * U threads fit one block (dw)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float ld(const T* p) { return to_f(__ldg(p)); }

// ---- forward and dx: one launch per convolution (head note) ----

// dst: out (B, N, F, 4) when one split, else the partial sums (splits, B, N, F, 4).
template <typename T>
__global__ void __launch_bounds__(THREADS) tp_scalar_fwd_kernel(
    const T* __restrict__ x,           // (B, M, D) sender scalars
    const T* __restrict__ sh,          // (B, N, M, S) harmonics
    const T* __restrict__ w,           // (B, N, M, F) pre-masked edge weights
    const int4* __restrict__ chan,     // (F): x element, sh offset, K, 0
    const float* __restrict__ scale,   // (F): c_p of the channel's path
    float* __restrict__ dst, int B, int N, int M, int D, int S, int F, int keep, int chunk) {
  const int tid = threadIdx.x;
  const int kl = tid / F, f = tid - kl * F;
  const int b = blockIdx.z, n = blockIdx.y * keep + kl;
  if (kl >= keep || n >= N) return;
  const int m0 = blockIdx.x * chunk, m1 = min(M, m0 + chunk);
  const int4 c = chan[f];
  const int k1 = c.z > 1 ? 1 : 0, k2 = c.z > 2 ? 2 : 0;   // in range for any K
  const T* xp = x + (size_t)b * M * D + c.x;
  const T* wp = w + ((size_t)b * N + n) * M * F + f;
  const T* sp = sh + ((size_t)b * N + n) * M * S + c.y;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 8
  for (int m = m0; m < m1; ++m) {
    const float xw = ld(xp + (size_t)m * D) * ld(wp + (size_t)m * F);
    const T* s = sp + (size_t)m * S;
    a0 = fmaf(xw, ld(s), a0);
    a1 = fmaf(xw, ld(s + k1), a1);
    a2 = fmaf(xw, ld(s + k2), a2);
  }
  const float sc = scale[f];
  reinterpret_cast<float4*>(dst)[((size_t)blockIdx.x * B * N + (size_t)b * N + n) * F + f] =
      make_float4(sc * a0, k1 ? sc * a1 : 0.f, k2 ? sc * a2 : 0.f, 0.f);
}

// Writes dx (B, M, D) in T when one split, else f32 partial sums (splits, B, M, D).
template <typename T>
__global__ void __launch_bounds__(THREADS) tp_scalar_bwd_x_kernel(
    const T* __restrict__ sh,          // (B, N, M, S)
    const T* __restrict__ w,           // (B, N, M, F)
    const float* __restrict__ g,       // (B, N, F, 4) upstream gradient
    const int4* __restrict__ chan,     // (F): x element, sh offset, K, 0
    const float* __restrict__ scale,   // (F)
    const int* __restrict__ d_ptr,     // (D + 1): extents into d_item per input element
    const int* __restrict__ d_item,    // the channels reading each element, ascending
    T* __restrict__ dx, float* __restrict__ part, int B, int N, int M, int D, int S, int F,
    int n_items, int keep, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* s_part = smem;                                            // [kept][F]
  int* s_dptr = reinterpret_cast<int*>(smem + keep * F);           // D + 1
  int* s_ditem = s_dptr + D + 1;                                   // n_items
  const int tid = threadIdx.x, nt = blockDim.x;
  const int kl = tid / F, f = tid - kl * F;
  const int b = blockIdx.z, m0 = blockIdx.y * keep, m = m0 + kl;
  for (int i = tid; i <= D; i += nt) s_dptr[i] = d_ptr[i];
  for (int i = tid; i < n_items; i += nt) s_ditem[i] = d_item[i];
  if (kl < keep) {
    float acc = 0.f;
    if (m < M) {
      const int n0 = blockIdx.x * chunk, n1 = min(N, n0 + chunk);
      const int4 c = chan[f];
      const int k1 = c.z > 1 ? 1 : 0, k2 = c.z > 2 ? 2 : 0;
      const size_t edge_n = (size_t)M;                      // edges between receivers n, n + 1
      const T* wp = w + ((size_t)b * N * M + m) * F + f;
      const T* sp = sh + ((size_t)b * N * M + m) * S + c.y;
      const float4* gp = reinterpret_cast<const float4*>(g) + (size_t)b * N * F + f;
#pragma unroll 8
      for (int n = n0; n < n1; ++n) {
        const float wv = ld(wp + n * edge_n * F);
        const T* s = sp + n * edge_n * S;
        const float4 gv = __ldg(gp + (size_t)n * F);
        float t = ld(s) * gv.x;
        t = fmaf(ld(s + k1), k1 ? gv.y : 0.f, t);
        t = fmaf(ld(s + k2), k2 ? gv.z : 0.f, t);
        acc = fmaf(wv, t, acc);
      }
      acc *= scale[f];
    }
    s_part[kl * F + f] = acc;
  }
  __syncthreads();
  for (int r = tid; r < keep * D; r += nt) {
    const int k = r / D, d = r - k * D;
    const int mm = m0 + k;
    if (mm >= M) continue;
    float sum = 0.f;
    for (int e = s_dptr[d]; e < s_dptr[d + 1]; ++e) sum += s_part[k * F + s_ditem[e]];
    const size_t at = ((size_t)b * M + mm) * D + d;
    if (part != nullptr) part[(size_t)blockIdx.x * B * M * D + at] = sum;
    else dx[at] = from_f<T>(sum);
  }
}

// out[i] = sum over the splits of part[k][i], in order.
template <typename T>
__global__ void tp_scalar_sum_splits(const float* __restrict__ part, T* __restrict__ out,
                                     long long total, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[k * total + i];
  out[i] = from_f<T>(s);
}

// ---- dw and dsh: one launch per path, on strided views ----

// Element strides of the views; the last axis of each has stride 1.
struct NodeStride { long long b, m; };      // (B, M, U)
struct EdgeStride { long long b, n, m; };   // (B, N, M, K) and (B, N, M, U)
struct OutStride { long long b, n, u; };    // (B, N, U, K)

// Stage x of senders [m0, m0 + mc) as s_x[ml * U + u] in f32.
template <typename T>
__device__ __forceinline__ void stage_x(float* s_x, const T* __restrict__ x, NodeStride xs,
                                        int b, int m0, int mc, int U, int tid, int nt) {
  for (int i = tid; i < mc * U; i += nt) {
    const int ml = i / U, u = i - ml * U;
    s_x[i] = to_f(x[b * xs.b + (m0 + ml) * xs.m + u]);
  }
}

// Stage the harmonics of receivers [n0, n0 + rows) x senders [m0, m0 + cols)
// as s_sh[(r * pitch + c) * KT + k] in f32, zero outside N, M and K.
template <int KT, typename T>
__device__ __forceinline__ void stage_sh(float* s_sh, const T* __restrict__ sh, EdgeStride ss,
                                         int b, int n0, int rows, int N, int m0, int cols, int M,
                                         int pitch, int K, int tid, int nt) {
  for (int i = tid; i < rows * cols * KT; i += nt) {
    const int k = i % KT, e = i / KT;
    const int c = e % cols, r = e / cols;
    const int n = n0 + r, m = m0 + c;
    s_sh[(r * pitch + c) * KT + k] =
        (n < N && m < M && k < K) ? to_f(sh[b * ss.b + n * ss.n + m * ss.m + k]) : 0.f;
  }
}

template <int KT, typename T>
__global__ void __launch_bounds__(THREADS) tp_scalar_bwd_w_kernel(
    const T* __restrict__ x, NodeStride xs, const T* __restrict__ sh, EdgeStride ss,
    const float* __restrict__ g, OutStride gs, T* __restrict__ dw, EdgeStride ds,
    int N, int M, int U, int K, float scale) {
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
    gk[k] = (active && k < K) ? scale * g[b * gs.b + n * gs.n + u * gs.u + k] : 0.f;
  T* dw_row = dw + b * ds.b + (active ? n : 0) * ds.n + u;

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
        dw_row[(m0 + ml) * ds.m] = from_f<T>(s_x[ml * U + u] * t);
      }
    }
    __syncthreads();
  }
}

template <int KT, typename T>
__global__ void __launch_bounds__(THREADS) tp_scalar_bwd_sh_kernel(
    const T* __restrict__ x, NodeStride xs, const T* __restrict__ w, EdgeStride ws,
    const float* __restrict__ g, OutStride gs, T* __restrict__ dsh, EdgeStride ds,
    int N, int M, int U, int K, int accumulate, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_g = smem;              // U * KT

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y, n = blockIdx.x;
  for (int i = tid; i < U * KT; i += nt) {
    const int u = i / KT, k = i - u * KT;
    s_g[i] = k < K ? scale * g[b * gs.b + n * gs.n + u * gs.u + k] : 0.f;
  }
  __syncthreads();

  for (int m = tid; m < M; m += nt) {
    const T* xr = x + b * xs.b + m * xs.m;
    const T* wr = w + b * ws.b + n * ws.n + m * ws.m;
    float acc[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k] = 0.f;
    for (int u = 0; u < U; ++u) {
      const float xw = to_f(xr[u]) * to_f(wr[u]);
      const float* gv = s_g + u * KT;
#pragma unroll
      for (int k = 0; k < KT; ++k) acc[k] = fmaf(xw, gv[k], acc[k]);
    }
    T* o = dsh + b * ds.b + n * ds.n + m * ds.m;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < K) o[k] = from_f<T>(accumulate ? to_f(o[k]) + acc[k] : acc[k]);
  }
}

bool bad_path_shape(int B, int N, int M, int U, int K) {
  return B < 1 || B > 65535 || N < 1 || M < 1 || U < 1 || U > U_MAX || K < 1 || K > K_MAX;
}

bool bad_conv_shape(int B, int N, int M, int D, int S, int F, int keep, int chunk, int splits,
                    int summed, const float* part) {
  return B < 1 || B > 65535 || N < 1 || M < 1 || D < 1 || S < 1 || F < 1 || keep < 1 ||
         keep * F > THREADS || chunk < 1 || splits < 1 || (long long)chunk * (splits - 1) >= summed ||
         (long long)chunk * splits < summed || (splits > 1 && part == nullptr);
}

int round_up_32(int v) { return ((v + 31) / 32) * 32; }

// The template bound for K accumulators.
int k_bound(int K) { return K == 1 ? 1 : (K <= 3 ? 3 : K_MAX); }

size_t bwd_x_smem(int keep, int F, int D, int n_items) {
  return sizeof(float) * ((size_t)keep * F + D + 1 + n_items);
}

// After the main kernel: its launch error, else, when the summed axis is
// split, the launch of the sum of the splits into `out` (`total` elements).
template <typename T>
int sum_splits(const float* part, T* out, long long total, int splits, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  tp_scalar_sum_splits<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, out, total, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* sh, const void* w, const int* chan, const float* scale,
               float* out, float* part, int B, int N, int M, int D, int S, int F, int keep,
               int chunk, int splits, cudaStream_t st) {
  const dim3 grid(splits, (N + keep - 1) / keep, B);
  tp_scalar_fwd_kernel<T><<<grid, round_up_32(keep * F), 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(sh), static_cast<const T*>(w),
      reinterpret_cast<const int4*>(chan), scale, splits > 1 ? part : out, B, N, M, D, S, F, keep,
      chunk);
  return sum_splits<float>(part, out, (long long)B * N * F * 4, splits, st);
}

template <typename T>
int launch_bwd_x(const void* sh, const void* w, const float* g, const int* chan,
                 const float* scale, const int* d_ptr, const int* d_item, void* dx, float* part,
                 int B, int N, int M, int D, int S, int F, int n_items, int keep, int chunk,
                 int splits, cudaStream_t st) {
  const dim3 grid(splits, (M + keep - 1) / keep, B);
  T* out = static_cast<T*>(dx);
  tp_scalar_bwd_x_kernel<T><<<grid, round_up_32(keep * F), bwd_x_smem(keep, F, D, n_items), st>>>(
      static_cast<const T*>(sh), static_cast<const T*>(w), g, reinterpret_cast<const int4*>(chan),
      scale, d_ptr, d_item, out, splits > 1 ? part : nullptr, B, N, M, D, S, F, n_items, keep,
      chunk);
  return sum_splits<T>(part, out, (long long)B * M * D, splits, st);
}

template <typename T>
int launch_bwd_w(const void* x, const void* sh, const float* g, void* dw, const long long* s,
                 int B, int N, int M, int U, int K, float scale, cudaStream_t st) {
  const NodeStride xs{s[0], s[1]};
  const EdgeStride ss{s[2], s[3], s[4]};
  const OutStride gs{s[5], s[6], s[7]};
  const EdgeStride ds{s[8], s[9], s[10]};
  const dim3 grid((N + TN - 1) / TN, B);
  const int threads = round_up_32(TN * U);
  const T* xt = static_cast<const T*>(x);
  const T* sht = static_cast<const T*>(sh);
  T* dwt = static_cast<T*>(dw);
#define DP_LAUNCH(KT)                                                                         \
  tp_scalar_bwd_w_kernel<KT, T><<<grid, threads, sizeof(float) * (MC * U + TN * MC * KT), st>>>( \
      xt, xs, sht, ss, g, gs, dwt, ds, N, M, U, K, scale)
  switch (k_bound(K)) {
    case 1: DP_LAUNCH(1); break;
    case 3: DP_LAUNCH(3); break;
    default: DP_LAUNCH(K_MAX); break;
  }
#undef DP_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_sh(const void* x, const void* w, const float* g, void* dsh, const long long* s,
                  int B, int N, int M, int U, int K, int accumulate, float scale,
                  cudaStream_t st) {
  const NodeStride xs{s[0], s[1]};
  const EdgeStride ws{s[2], s[3], s[4]};
  const OutStride gs{s[5], s[6], s[7]};
  const EdgeStride ds{s[8], s[9], s[10]};
  const dim3 grid(N, B);
  const int threads = M >= 128 ? 128 : round_up_32(M);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* dst = static_cast<T*>(dsh);
#define DP_LAUNCH(KT)                                                              \
  tp_scalar_bwd_sh_kernel<KT, T><<<grid, threads, sizeof(float) * (U * KT), st>>>( \
      xt, xs, wt, ws, g, gs, dst, ds, N, M, U, K, accumulate, scale)
  switch (k_bound(K)) {
    case 1: DP_LAUNCH(1); break;
    case 3: DP_LAUNCH(3); break;
    default: DP_LAUNCH(K_MAX); break;
  }
#undef DP_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each function returns a cudaError_t value: 0 when the launches were
// accepted.  `bf16` selects the operands' type (x, sh, w and the gradients
// written in it): 0 f32, 1 bf16.

// Every path of a convolution: out (B, N, F, 4) f32; `part` holds (splits, B,
// N, F, 4) floats when the senders are split (splits > 1), else it is not
// read.  Senders [k * chunk, (k + 1) * chunk) go to split k.
int dp_tp_scalar_fwd(const void* x, const void* sh, const void* w, const int* chan,
                     const float* scale, float* out, float* part, int B, int N, int M, int D,
                     int S, int F, int keep, int chunk, int splits, int bf16, void* stream) {
  if (bad_conv_shape(B, N, M, D, S, F, keep, chunk, splits, M, part) ||
      (N + keep - 1) / keep > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, sh, w, chan, scale, out, part, B, N, M, D, S, F,
                                          keep, chunk, splits, st)
              : launch_fwd<float>(x, sh, w, chan, scale, out, part, B, N, M, D, S, F, keep, chunk,
                                  splits, st);
}

// dx (B, M, D) of every path of a convolution, in the operands' type; `part`
// holds (splits, B, M, D) floats when the receivers are split.
int dp_tp_scalar_bwd_x(const void* sh, const void* w, const float* g, const int* chan,
                       const float* scale, const int* d_ptr, const int* d_item, void* dx,
                       float* part, int B, int N, int M, int D, int S, int F, int n_items,
                       int keep, int chunk, int splits, int bf16, void* stream) {
  if (bad_conv_shape(B, N, M, D, S, F, keep, chunk, splits, N, part) || n_items < 1 ||
      (M + keep - 1) / keep > 65535 || bwd_x_smem(keep, F, D, n_items) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_x<__nv_bfloat16>(sh, w, g, chan, scale, d_ptr, d_item, dx, part, B, N,
                                            M, D, S, F, n_items, keep, chunk, splits, st)
              : launch_bwd_x<float>(sh, w, g, chan, scale, d_ptr, d_item, dx, part, B, N, M, D, S,
                                    F, n_items, keep, chunk, splits, st);
}

// One path.  strides: x (b, m), sh (b, n, m), g (b, n, u), dw (b, n, m)
int dp_tp_scalar_bwd_w(const void* x, const void* sh, const float* g, void* dw,
                       const long long* strides, int B, int N, int M, int U, int K, float scale,
                       int bf16, void* stream) {
  if (bad_path_shape(B, N, M, U, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_w<__nv_bfloat16>(x, sh, g, dw, strides, B, N, M, U, K, scale, st)
              : launch_bwd_w<float>(x, sh, g, dw, strides, B, N, M, U, K, scale, st);
}

// One path.  strides: x (b, m), w (b, n, m), g (b, n, u), dsh (b, n, m)
int dp_tp_scalar_bwd_sh(const void* x, const void* w, const float* g, void* dsh,
                        const long long* strides, int B, int N, int M, int U, int K,
                        int accumulate, float scale, int bf16, void* stream) {
  if (bad_path_shape(B, N, M, U, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_sh<__nv_bfloat16>(x, w, g, dsh, strides, B, N, M, U, K, accumulate,
                                             scale, st)
              : launch_bwd_sh<float>(x, w, g, dsh, strides, B, N, M, U, K, accumulate, scale, st);
}

// Blocks of the forward (dx = 0) or dx kernel that one SM holds at once for a
// convolution of F channels (keep = THREADS / F entries a block), D input
// elements and n_items (channel, element) pairs, or minus a cudaError_t value.
int dp_tp_scalar_blocks_per_sm(int dx, int F, int D, int n_items, int bf16) {
  if (F < 1 || F > THREADS) return -(int)cudaErrorInvalidValue;
  const int keep = THREADS / F;
  const int threads = round_up_32(keep * F);
  int blocks = 0;
  cudaError_t err;
  if (dx) {
    const size_t bytes = bwd_x_smem(keep, F, D, n_items);
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_scalar_bwd_x_kernel<__nv_bfloat16>, threads, bytes)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_scalar_bwd_x_kernel<float>, threads, bytes);
  } else {
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_scalar_fwd_kernel<__nv_bfloat16>, threads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_scalar_fwd_kernel<float>, threads, 0);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

const char* dp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
