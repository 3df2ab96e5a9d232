// K2: channelwise tensor-product aggregate with its backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   diffphore_tpu/ops/pallas/tp_aggregate.py::tp_aggregate_pallas
// and computes the same function, all paths of one convolution in one launch:
//   out[b,n,f,k] = sum_m w[b,n,m,f] * sum_{i,j} G_p(f)[i,j,k]
//                  * x[b,m,x_base(f)+i] * sh[b,n,m,sh_off(f)+j]
// where channel f belongs to tensor-product path p(f), G_p = alpha_p * cg_p
// (Wigner-3j block, l_in, l_out <= 1, l_sh <= 2) and w are the pre-masked edge
// weights.  Output (B, N, F, 4) f32, component k < 3 of each channel, lane 3
// zero.  The TPU kernel has no backward; this file adds one, so that the
// training step runs hand-written kernels in both directions.  With
// g = dL/dout (B, N, F, 4), lanes k >= 2*l_out+1 ignored:
//   dw[b,n,m,f]  = sum_{i,j,k} G[i,j,k] x[b,m,x_base+i] sh[b,n,m,sh_off+j] g[b,n,f,k]
//   dsh[b,n,m,s] = sum_{f: sh_off(f) <= s < sh_off(f)+d_sh(f)} w[b,n,m,f]
//                  * sum_{i,k} G[i,s-sh_off,k] x[b,m,x_base+i] g[b,n,f,k]
//   dx[b,m,d]    = sum_n sum_{(f,i): x_base(f)+i = d} w[b,n,m,f]
//                  * sum_{j,k} G[i,j,k] sh[b,n,m,sh_off+j] g[b,n,f,k]
//
// What bounds it on an H100.  Device memory: w (B,N,M,F) is the large operand
// (106 MB for the widest phore convolution of a 24-complex batch) and each
// kernel reads or writes it exactly once, coalesced along F; x, sh, g and the
// outputs are small beside it.  The arithmetic (about 50 f32 operations per
// edge and channel) stays under the byte bound except where few edges are live.
//
// Design (simple and correct first; no tensor cores, no TMA):
//  * thread = channel f, as in the fused kernel; its path's alpha*cg block is a
//    (3,5,3) table in shared memory;
//  * forward and the edge backward (dw, and dsh when asked for): one block per
//    (batch row, tile of TN receivers), a loop over sender chunks of MC whose
//    harmonics and sender features are staged in shared memory;
//  * dsh sums over channels, i.e. across the block's threads: per sender the
//    threads park w * t[j] in shared memory and TN*S threads add them path by
//    path in a fixed order;
//  * dx sums over receivers and over the channels that read one input element:
//    the roles of N and M swap (block = batch row x tile of TM senders, loop
//    over receiver chunks), each thread keeps its channel's 3 input components
//    for TM senders in registers, and a last pass adds the channels of each
//    input element in the fixed order of a host-built list;
//  * no atomics anywhere: every output element is written once by one thread,
//    so two runs on the same inputs agree to the bit.

#include <cuda_runtime.h>

namespace {

constexpr int TN = 8;           // receivers per block (forward, edge backward)
constexpr int MC = 8;           // senders per staged chunk (forward, edge backward)
constexpr int TM = 8;           // senders per block (dx)
constexpr int NC = 8;           // receivers per staged chunk (dx)
constexpr int SH_STRIDE = 12;   // padded harmonics row in shared memory
constexpr int J_MAX = 5;        // harmonic components of one path (l_sh <= 2)
constexpr int G_SIZE = 3 * J_MAX * 3;  // alpha*cg padded to (i < 3, j < 5, k < 3)
constexpr int MAX_THREADS = 256;

// z[j][k] = sum_i G[i][j][k] * y[i]: the node-level half of the product.
__device__ __forceinline__ void node_product(const float* G, const float* s_x_row, int x_base,
                                             int d_in, float z[J_MAX][3]) {
  float y[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = i < d_in ? s_x_row[x_base + i] : 0.f;
#pragma unroll
  for (int j = 0; j < J_MAX; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      z[j][k] = G[(0 * J_MAX + j) * 3 + k] * y[0] + G[(1 * J_MAX + j) * 3 + k] * y[1] +
                G[(2 * J_MAX + j) * 3 + k] * y[2];
}

// Stage the harmonics of an (n_count receivers x m_count senders) tile of edges,
// receiver-major, each row padded to SH_STRIDE with zeros.
__device__ __forceinline__ void stage_sh(float* s_sh, const float* __restrict__ sh, int b, int N,
                                         int M, int S, int n_base, int n_count, int m_base,
                                         int m_count, int tid, int nt) {
  for (int i = tid; i < n_count * m_count * SH_STRIDE; i += nt) {
    const int e = i / SH_STRIDE, j = i - e * SH_STRIDE;
    const int n = n_base + e / m_count, m = m_base + e % m_count;
    s_sh[i] = (n < N && m < M && j < S) ? sh[(((size_t)b * N + n) * M + m) * S + j] : 0.f;
  }
}

__global__ void __launch_bounds__(MAX_THREADS) tp_aggregate_fwd_kernel(
    const float* __restrict__ x,     // (B, M, D) sender features
    const float* __restrict__ sh,    // (B, N, M, S) edge harmonics
    const float* __restrict__ w,     // (B, N, M, F) pre-masked edge weights
    const int4* __restrict__ chan,   // (F): x_base, d_in, sh_off, path
    const float* __restrict__ gtab,  // (n_paths, 3, J_MAX, 3)
    float* __restrict__ out,         // (B, N, F, 4)
    int N, int M, int D, int S, int F, int n_paths) {
  extern __shared__ __align__(16) float smem[];
  float* s_g = smem;                          // n_paths * G_SIZE
  float* s_sh = s_g + n_paths * G_SIZE;       // TN * MC * SH_STRIDE
  float* s_x = s_sh + TN * MC * SH_STRIDE;    // MC * D

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  for (int i = tid; i < n_paths * G_SIZE; i += nt) s_g[i] = gtab[i];

  const int f = tid;
  const bool active = f < F;
  const int4 cm = active ? chan[f] : make_int4(0, 0, 0, 0);
  const float* G = s_g + cm.w * G_SIZE;
  float acc[TN][3];
#pragma unroll
  for (int nl = 0; nl < TN; ++nl) acc[nl][0] = acc[nl][1] = acc[nl][2] = 0.f;

  for (int m0 = 0; m0 < M; m0 += MC) {
    stage_sh(s_sh, sh, b, N, M, S, n0, TN, m0, MC, tid, nt);
    for (int i = tid; i < MC * D; i += nt) {
      const int m = m0 + i / D;
      s_x[i] = m < M ? x[((size_t)b * M + m) * D + (i % D)] : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int ml = 0; ml < MC && m0 + ml < M; ++ml) {
        float z[J_MAX][3];
        node_product(G, s_x + ml * D, cm.x, cm.y, z);
#pragma unroll
        for (int nl = 0; nl < TN; ++nl) {
          const int n = n0 + nl;
          if (n >= N) continue;
          const float wv = w[(((size_t)b * N + n) * M + (m0 + ml)) * F + f];
          if (wv == 0.f) continue;
          const float* sv = s_sh + (nl * MC + ml) * SH_STRIDE + cm.z;
          float g0 = 0.f, g1 = 0.f, g2 = 0.f;
#pragma unroll
          for (int j = 0; j < J_MAX; ++j) {
            const float s = sv[j];
            g0 = fmaf(z[j][0], s, g0);
            g1 = fmaf(z[j][1], s, g1);
            g2 = fmaf(z[j][2], s, g2);
          }
          acc[nl][0] = fmaf(wv, g0, acc[nl][0]);
          acc[nl][1] = fmaf(wv, g1, acc[nl][1]);
          acc[nl][2] = fmaf(wv, g2, acc[nl][2]);
        }
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int nl = 0; nl < TN; ++nl) {
      const int n = n0 + nl;
      if (n < N)
        reinterpret_cast<float4*>(out)[((size_t)b * N + n) * F + f] =
            make_float4(acc[nl][0], acc[nl][1], acc[nl][2], 0.f);
    }
  }
}

// dw for every edge and channel and, with DSH, dsh for every edge.
template <bool DSH>
__global__ void __launch_bounds__(MAX_THREADS) tp_aggregate_bwd_edge_kernel(
    const float* __restrict__ x,     // (B, M, D)
    const float* __restrict__ sh,    // (B, N, M, S)
    const float* __restrict__ w,     // (B, N, M, F), read when DSH
    const float* __restrict__ g,     // (B, N, F, 4) upstream gradient
    const int4* __restrict__ chan,   // (F): x_base, d_in, sh_off, path
    const int4* __restrict__ ptab,   // (n_paths): f_start, f_count, d_sh, d_out
    const float* __restrict__ gtab,  // (n_paths, 3, J_MAX, 3)
    float* __restrict__ dw,          // (B, N, M, F)
    float* __restrict__ dsh,         // (B, N, M, S), written when DSH
    int N, int M, int D, int S, int F, int n_paths) {
  extern __shared__ __align__(16) float smem[];
  const int Fp = F | 1;                       // odd row pitch of s_c
  float* s_g = smem;                          // n_paths * G_SIZE
  float* s_sh = s_g + n_paths * G_SIZE;       // TN * MC * SH_STRIDE
  float* s_x = s_sh + TN * MC * SH_STRIDE;    // MC * D
  float* s_c = s_x + MC * D;                  // DSH: TN * J_MAX * Fp

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  for (int i = tid; i < n_paths * G_SIZE; i += nt) s_g[i] = gtab[i];

  const int f = tid;
  const bool active = f < F;
  const int4 cm = active ? chan[f] : make_int4(0, 0, 0, 0);
  const int d_out = active ? ptab[cm.w].w : 0;
  const float* G = s_g + cm.w * G_SIZE;
  float gk[TN][3];
#pragma unroll
  for (int nl = 0; nl < TN; ++nl) {
    const int n = n0 + nl;
    float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active && n < N) gv = reinterpret_cast<const float4*>(g)[((size_t)b * N + n) * F + f];
    gk[nl][0] = d_out > 0 ? gv.x : 0.f;
    gk[nl][1] = d_out > 1 ? gv.y : 0.f;
    gk[nl][2] = d_out > 2 ? gv.z : 0.f;
  }

  for (int m0 = 0; m0 < M; m0 += MC) {
    stage_sh(s_sh, sh, b, N, M, S, n0, TN, m0, MC, tid, nt);
    for (int i = tid; i < MC * D; i += nt) {
      const int m = m0 + i / D;
      s_x[i] = m < M ? x[((size_t)b * M + m) * D + (i % D)] : 0.f;
    }
    __syncthreads();
    for (int ml = 0; ml < MC && m0 + ml < M; ++ml) {
      const int m = m0 + ml;
      if (active) {
        float z[J_MAX][3];
        node_product(G, s_x + ml * D, cm.x, cm.y, z);
#pragma unroll
        for (int nl = 0; nl < TN; ++nl) {
          const int n = n0 + nl;
          if (n >= N) continue;
          const size_t edge = ((size_t)b * N + n) * M + m;
          const float* sv = s_sh + (nl * MC + ml) * SH_STRIDE + cm.z;
          float t[J_MAX];
          float dwv = 0.f;
#pragma unroll
          for (int j = 0; j < J_MAX; ++j) {
            t[j] = z[j][0] * gk[nl][0] + z[j][1] * gk[nl][1] + z[j][2] * gk[nl][2];
            dwv = fmaf(t[j], sv[j], dwv);
          }
          dw[edge * F + f] = dwv;
          if (DSH) {
            const float wv = w[edge * F + f];
#pragma unroll
            for (int j = 0; j < J_MAX; ++j) s_c[(nl * J_MAX + j) * Fp + f] = wv * t[j];
          }
        }
      }
      if (DSH) {
        __syncthreads();
        for (int r = tid; r < TN * S; r += nt) {
          const int nl = r / S, s = r - nl * S;
          const int n = n0 + nl;
          if (n >= N) continue;
          float sum = 0.f;
          for (int q = 0; q < n_paths; ++q) {
            const int4 pt = ptab[q];
            const int j = s - chan[pt.x].z;
            if (j < 0 || j >= pt.z) continue;
            const float* row = s_c + (nl * J_MAX + j) * Fp + pt.x;
            for (int u = 0; u < pt.y; ++u) sum += row[u];
          }
          dsh[(((size_t)b * N + n) * M + m) * S + s] = sum;
        }
        __syncthreads();
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(MAX_THREADS) tp_aggregate_bwd_x_kernel(
    const float* __restrict__ sh,    // (B, N, M, S)
    const float* __restrict__ w,     // (B, N, M, F)
    const float* __restrict__ g,     // (B, N, F, 4)
    const int4* __restrict__ chan,   // (F): x_base, d_in, sh_off, path
    const int4* __restrict__ ptab,   // (n_paths): f_start, f_count, d_sh, d_out
    const float* __restrict__ gtab,  // (n_paths, 3, J_MAX, 3)
    const int* __restrict__ d_ptr,   // (D + 1): extents into d_item per input element
    const int* __restrict__ d_item,  // f * 4 + i of every (channel, component) reading it
    float* __restrict__ dx,          // (B, M, D)
    int N, int M, int D, int S, int F, int n_paths) {
  extern __shared__ __align__(16) float smem[];
  const int Fp = F | 1;
  float* s_g = smem;                          // n_paths * G_SIZE
  float* s_sh = s_g + n_paths * G_SIZE;       // NC * TM * SH_STRIDE
  float* s_d = s_sh + NC * TM * SH_STRIDE;    // TM * 3 * Fp

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * TM;
  for (int i = tid; i < n_paths * G_SIZE; i += nt) s_g[i] = gtab[i];

  const int f = tid;
  const bool active = f < F;
  const int4 cm = active ? chan[f] : make_int4(0, 0, 0, 0);
  const int d_out = active ? ptab[cm.w].w : 0;
  const float* G = s_g + cm.w * G_SIZE;
  float acc[TM][3];
#pragma unroll
  for (int ml = 0; ml < TM; ++ml) acc[ml][0] = acc[ml][1] = acc[ml][2] = 0.f;

  for (int n0 = 0; n0 < N; n0 += NC) {
    stage_sh(s_sh, sh, b, N, M, S, n0, NC, m0, TM, tid, nt);
    __syncthreads();
    if (active) {
      for (int nl = 0; nl < NC && n0 + nl < N; ++nl) {
        const int n = n0 + nl;
        const float4 gv = reinterpret_cast<const float4*>(g)[((size_t)b * N + n) * F + f];
        const float g0 = d_out > 0 ? gv.x : 0.f;
        const float g1 = d_out > 1 ? gv.y : 0.f;
        const float g2 = d_out > 2 ? gv.z : 0.f;
        // P[i][j] = sum_k G[i][j][k] g[k]
        float P[3][J_MAX];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < J_MAX; ++j) {
            const float* Gij = G + (i * J_MAX + j) * 3;
            P[i][j] = Gij[0] * g0 + Gij[1] * g1 + Gij[2] * g2;
          }
#pragma unroll
        for (int ml = 0; ml < TM; ++ml) {
          const int m = m0 + ml;
          if (m >= M) continue;
          const float wv = w[(((size_t)b * N + n) * M + m) * F + f];
          if (wv == 0.f) continue;
          const float* sv = s_sh + (nl * TM + ml) * SH_STRIDE + cm.z;
          float u0 = 0.f, u1 = 0.f, u2 = 0.f;
#pragma unroll
          for (int j = 0; j < J_MAX; ++j) {
            const float s = sv[j];
            u0 = fmaf(P[0][j], s, u0);
            u1 = fmaf(P[1][j], s, u1);
            u2 = fmaf(P[2][j], s, u2);
          }
          acc[ml][0] = fmaf(wv, u0, acc[ml][0]);
          acc[ml][1] = fmaf(wv, u1, acc[ml][1]);
          acc[ml][2] = fmaf(wv, u2, acc[ml][2]);
        }
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int ml = 0; ml < TM; ++ml)
#pragma unroll
      for (int i = 0; i < 3; ++i) s_d[(ml * 3 + i) * Fp + f] = acc[ml][i];
  }
  __syncthreads();
  for (int r = tid; r < TM * D; r += nt) {
    const int ml = r / D, d = r - ml * D;
    const int m = m0 + ml;
    if (m >= M) continue;
    float sum = 0.f;
    for (int e = d_ptr[d]; e < d_ptr[d + 1]; ++e) {
      const int it = d_item[e];
      sum += s_d[(ml * 3 + (it & 3)) * Fp + (it >> 2)];
    }
    dx[((size_t)b * M + m) * D + d] = sum;
  }
}

int threads_for(int F) {
  const int t = ((F + 31) / 32) * 32;
  return t < 128 ? 128 : t;
}

bool bad_shape(int B, int N, int M, int D, int S, int F, int n_paths) {
  return B < 1 || N < 1 || M < 1 || D < 1 || S < 1 || S > SH_STRIDE || F < 1 ||
         F > MAX_THREADS || n_paths < 1 || B > 65535;
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Each function returns a cudaError_t value: 0 when the launch was accepted.

int dp_tp_aggregate_fwd(const float* x, const float* sh, const float* w, const int* chan,
                        const float* gtab, float* out, int B, int N, int M, int D, int S, int F,
                        int n_paths, void* stream) {
  if (bad_shape(B, N, M, D, S, F, n_paths)) return (int)cudaErrorInvalidValue;
  const size_t bytes =
      sizeof(float) * ((size_t)n_paths * G_SIZE + (size_t)TN * MC * SH_STRIDE + (size_t)MC * D);
  cudaError_t err = allow_shared(tp_aggregate_fwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TN - 1) / TN, B);
  tp_aggregate_fwd_kernel<<<grid, threads_for(F), bytes, static_cast<cudaStream_t>(stream)>>>(
      x, sh, w, reinterpret_cast<const int4*>(chan), gtab, out, N, M, D, S, F, n_paths);
  return (int)cudaGetLastError();
}

// dsh may be null: then only dw is computed and w is not read.
int dp_tp_aggregate_bwd_edge(const float* x, const float* sh, const float* w, const float* g,
                             const int* chan, const int* ptab, const float* gtab, float* dw,
                             float* dsh, int B, int N, int M, int D, int S, int F, int n_paths,
                             void* stream) {
  if (bad_shape(B, N, M, D, S, F, n_paths)) return (int)cudaErrorInvalidValue;
  const bool with_dsh = dsh != nullptr;
  const size_t floats = (size_t)n_paths * G_SIZE + (size_t)TN * MC * SH_STRIDE + (size_t)MC * D +
                        (with_dsh ? (size_t)TN * J_MAX * (F | 1) : 0);
  const size_t bytes = sizeof(float) * floats;
  const dim3 grid((N + TN - 1) / TN, B);
  const int threads = threads_for(F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* chan4 = reinterpret_cast<const int4*>(chan);
  const int4* ptab4 = reinterpret_cast<const int4*>(ptab);
  if (with_dsh) {
    cudaError_t err = allow_shared(tp_aggregate_bwd_edge_kernel<true>, bytes);
    if (err != cudaSuccess) return (int)err;
    tp_aggregate_bwd_edge_kernel<true><<<grid, threads, bytes, st>>>(
        x, sh, w, g, chan4, ptab4, gtab, dw, dsh, N, M, D, S, F, n_paths);
  } else {
    cudaError_t err = allow_shared(tp_aggregate_bwd_edge_kernel<false>, bytes);
    if (err != cudaSuccess) return (int)err;
    tp_aggregate_bwd_edge_kernel<false><<<grid, threads, bytes, st>>>(
        x, sh, w, g, chan4, ptab4, gtab, dw, dsh, N, M, D, S, F, n_paths);
  }
  return (int)cudaGetLastError();
}

int dp_tp_aggregate_bwd_x(const float* sh, const float* w, const float* g, const int* chan,
                          const int* ptab, const float* gtab, const int* d_ptr, const int* d_item,
                          float* dx, int B, int N, int M, int D, int S, int F, int n_paths,
                          void* stream) {
  if (bad_shape(B, N, M, D, S, F, n_paths)) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * ((size_t)n_paths * G_SIZE + (size_t)NC * TM * SH_STRIDE +
                                        (size_t)TM * 3 * (F | 1));
  cudaError_t err = allow_shared(tp_aggregate_bwd_x_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + TM - 1) / TM, B);
  tp_aggregate_bwd_x_kernel<<<grid, threads_for(F), bytes, static_cast<cudaStream_t>(stream)>>>(
      sh, w, g, reinterpret_cast<const int4*>(chan), reinterpret_cast<const int4*>(ptab), gtab,
      d_ptr, d_item, dx, N, M, D, S, F, n_paths);
  return (int)cudaGetLastError();
}

const char* dp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
