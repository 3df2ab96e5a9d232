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
// Design (no tensor cores, no TMA):
//  * thread = channel f, as in the fused kernel; its path's alpha*cg block is a
//    (3,5,3) table in shared memory;
//  * forward: one block per (batch row, tile of TN receivers), a loop over
//    sender chunks of MC whose harmonics and sender features are staged in
//    shared memory;
//  * the edge backward (dw, and dsh when asked for) sums over no edges, so its
//    grid tiles receivers and senders both and fills the card on every shape;
//    dsh sums over channels; where it is asked for, another kernel computes
//    dw and dsh in one pass over w with the roles turned: one block per (batch
//    row, receiver, 32 senders), warp = path, lane = sender walking the path's
//    channels, w staged through shared memory, so that no sum over channels
//    crosses threads;
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
constexpr int MC = 8;           // senders per staged chunk (forward)
constexpr int TM = 8;           // senders per block (dx)
constexpr int NC = 8;           // receivers per staged chunk (dx)
constexpr int SH_STRIDE = 12;   // padded harmonics row in shared memory
constexpr int J_MAX = 5;        // harmonic components of one path (l_sh <= 2)
constexpr int G_SIZE = 3 * J_MAX * 3;  // alpha*cg padded to (i < 3, j < 5, k < 3)
constexpr int MAX_THREADS = 256;
constexpr size_t MAX_SMEM = 227 * 1024;

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

// dw for every edge and channel, where dsh is not asked for.  It sums over no
// edges, so the grid tiles both receivers and senders: one block per (batch row,
// TN receivers, mt senders), its harmonics and sender features staged once, no
// barrier after that.  It does not read w.
constexpr int MT_MAX = 16;      // senders per block

__global__ void __launch_bounds__(MAX_THREADS, 3) tp_aggregate_bwd_edge_kernel(
    const float* __restrict__ x,     // (B, M, D)
    const float* __restrict__ sh,    // (B, N, M, S)
    const float* __restrict__ g,     // (B, N, F, 4) upstream gradient
    const int4* __restrict__ chan,   // (F): x_base, d_in, sh_off, path
    const int4* __restrict__ ptab,   // (n_paths): f_start, f_count, d_sh, d_out
    const float* __restrict__ gtab,  // (n_paths, 3, J_MAX, 3)
    float* __restrict__ dw,          // (B, N, M, F)
    int N, int M, int D, int S, int F, int n_paths, int mt) {
  extern __shared__ __align__(16) float smem[];
  float* s_g = smem;                           // n_paths * G_SIZE
  float* s_sh = s_g + n_paths * G_SIZE;        // TN * mt * SH_STRIDE, receiver-major
  float* s_x = s_sh + TN * mt * SH_STRIDE;     // mt * D

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * TN;
  const int m0 = blockIdx.x * mt;
  const int m_end = min(M, m0 + mt);
  for (int i = tid; i < n_paths * G_SIZE; i += nt) s_g[i] = gtab[i];
  stage_sh(s_sh, sh, b, N, M, S, n0, TN, m0, mt, tid, nt);
  for (int i = tid; i < mt * D; i += nt) {
    const int m = m0 + i / D;
    s_x[i] = m < M ? x[((size_t)b * M + m) * D + (i % D)] : 0.f;
  }
  __syncthreads();

  const int f = tid;
  if (f >= F) return;
  const int4 cm = chan[f];
  const int d_out = ptab[cm.w].w;
  const float* G = s_g + cm.w * G_SIZE;
  float gk[TN][3];
#pragma unroll
  for (int nl = 0; nl < TN; ++nl) {
    const int n = n0 + nl;
    float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < N) gv = reinterpret_cast<const float4*>(g)[((size_t)b * N + n) * F + f];
    gk[nl][0] = d_out > 0 ? gv.x : 0.f;
    gk[nl][1] = d_out > 1 ? gv.y : 0.f;
    gk[nl][2] = d_out > 2 ? gv.z : 0.f;
  }

  for (int m = m0; m < m_end; ++m) {
    const int ml = m - m0;
    float z[J_MAX][3];
    node_product(G, s_x + ml * D, cm.x, cm.y, z);
#pragma unroll
    for (int nl = 0; nl < TN; ++nl) {
      const int n = n0 + nl;
      if (n >= N) continue;
      const float* sv = s_sh + (nl * mt + ml) * SH_STRIDE + cm.z;
      float dwv = 0.f;
#pragma unroll
      for (int j = 0; j < J_MAX; ++j) {
        const float t = z[j][0] * gk[nl][0] + z[j][1] * gk[nl][1] + z[j][2] * gk[nl][2];
        dwv = fmaf(t, sv[j], dwv);
      }
      dw[(((size_t)b * N + n) * M + m) * F + f] = dwv;
    }
  }
}

// dw and dsh for every edge, in one pass over w:
//   q[j]              = sum_i P[n,f,i,j] * x[b,m,x_base(f)+i],   P[n,f,i,j] = sum_k G[i,j,k] g[b,n,f,k]
//   dw[b,n,m,f]       = sum_j q[j] * sh[b,n,m,off+j]
//   dsh[b,n,m,off+j]  = sum_f w[b,n,m,f] * q[j].
// dsh sums over channels; with thread = channel that is a reduction across the
// block for every edge.  Here the roles are turned, so that no sum over channels
// crosses threads: one block per (batch row, receiver, chunk of SH_CHUNK
// senders) builds the receiver's P (thread = channel) and stages the chunk's
// rows of w (one contiguous piece of memory), of x and of sh in shared memory
// with coalesced loads, at odd pitches.  Then warp = tensor-product path, lane =
// sender: every lane of a warp walks the path's channels, reads P as a
// broadcast and w and x without bank conflicts, keeps the path's d_sh sums in
// registers and leaves dw in the place of the w it has just read.  The paths'
// partial sums meet in shared memory, where thread = (sender, harmonic
// component) adds those of the paths that reach the component (a host-built
// list); dw and dsh leave the block coalesced.  Three barriers per block, the
// order of every sum fixed.
constexpr int SH_CHUNK = 32;    // senders per block = lanes of a warp
constexpr int SHP = SH_STRIDE + 1;   // odd pitch of the staged harmonics

constexpr int P_PITCH = 16;     // P[f][i][j], 15 values, padded so that a row loads as four float4

// The first `quads` float4 of a channel's P row, as P[i * J_MAX + j].
template <int QUADS>
__device__ __forceinline__ void load_p(const float* __restrict__ pu, float (&pv)[4 * QUADS]) {
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    const float4 v = reinterpret_cast<const float4*>(pu)[q];
    pv[4 * q] = v.x, pv[4 * q + 1] = v.y, pv[4 * q + 2] = v.z, pv[4 * q + 3] = v.w;
  }
}

template <int DS>
__device__ __forceinline__ void path_dw_dsh(const float* __restrict__ p, float* __restrict__ wf,
                                            const float* __restrict__ xf,
                                            const float* __restrict__ sv, int count, int d_in,
                                            float* __restrict__ part) {
  float acc[DS], shj[DS];
#pragma unroll
  for (int j = 0; j < DS; ++j) {
    acc[j] = 0.f;
    shj[j] = sv[j];
  }
  if (d_in == 1) {
#pragma unroll 5
    for (int u = 0; u < count; ++u) {
      const float wv = wf[u], xv = xf[u];
      float pv[4 * ((DS + 3) / 4)];
      load_p<(DS + 3) / 4>(p + u * P_PITCH, pv);
      float dwv = 0.f;
#pragma unroll
      for (int j = 0; j < DS; ++j) {
        const float q = pv[j] * xv;
        dwv = fmaf(q, shj[j], dwv);
        acc[j] = fmaf(wv, q, acc[j]);
      }
      wf[u] = dwv;
    }
  } else {
#pragma unroll 5
    for (int u = 0; u < count; ++u) {
      const float wv = wf[u];
      const float x0 = xf[3 * u], x1 = xf[3 * u + 1], x2 = xf[3 * u + 2];
      float pv[16];
      load_p<4>(p + u * P_PITCH, pv);
      float dwv = 0.f;
#pragma unroll
      for (int j = 0; j < DS; ++j) {
        const float q = fmaf(pv[2 * J_MAX + j], x2, fmaf(pv[J_MAX + j], x1, pv[j] * x0));
        dwv = fmaf(q, shj[j], dwv);
        acc[j] = fmaf(wv, q, acc[j]);
      }
      wf[u] = dwv;
    }
  }
#pragma unroll
  for (int j = 0; j < DS; ++j) part[j] = acc[j];
}

__global__ void tp_aggregate_bwd_edge_kernel_dsh(
    const float* __restrict__ x,      // (B, M, D)
    const float* __restrict__ sh,     // (B, N, M, S)
    const float* __restrict__ w,      // (B, N, M, F)
    const float* __restrict__ g,      // (B, N, F, 4)
    const int4* __restrict__ chan,    // (F): x_base, d_in, sh_off, path
    const int4* __restrict__ ptab,    // (n_paths): f_start, f_count, d_sh, d_out
    const float* __restrict__ gtab,   // (n_paths, 3, J_MAX, 3)
    const int* __restrict__ seg_ptr,  // (S + 1): extents into seg per harmonic component
    const int2* __restrict__ seg,     // (path, j) of every path reaching the component
    float* __restrict__ dw,           // (B, N, M, F)
    float* __restrict__ dsh,          // (B, N, M, S)
    int N, int M, int D, int S, int F, int n_paths, int n_seg) {
  extern __shared__ __align__(16) float smem[];
  const int Fp = F | 1, Dp = D | 1;
  float* s_p = smem;                                     // F * P_PITCH: P[f][i][j]
  float* s_w = s_p + F * P_PITCH;                        // SH_CHUNK * Fp: w, then dw
  float* s_x = s_w + SH_CHUNK * Fp;                      // SH_CHUNK * Dp
  float* s_sh = s_x + SH_CHUNK * Dp;                     // SH_CHUNK * SHP, zero past S
  float* s_part = s_sh + SH_CHUNK * SHP;                 // n_paths * SH_CHUNK * J_MAX
  int* s_segptr = reinterpret_cast<int*>(s_part + n_paths * SH_CHUNK * J_MAX);   // S + 1
  int2* s_seg = reinterpret_cast<int2*>(s_segptr + ((S + 1 + 3) / 4) * 4);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int m0 = blockIdx.x * SH_CHUNK, n = blockIdx.y, b = blockIdx.z;
  const int count = min(SH_CHUNK, M - m0);
  const size_t row0 = ((size_t)b * N + n) * M + m0;
  for (int i = tid; i <= S; i += nt) s_segptr[i] = seg_ptr[i];
  for (int i = tid; i < n_seg; i += nt) s_seg[i] = seg[i];
  for (int f = tid; f < F; f += nt) {
    const int4 cm = chan[f];
    const int d_out = ptab[cm.w].w;
    const float4 gv = reinterpret_cast<const float4*>(g)[((size_t)b * N + n) * F + f];
    const float g0 = d_out > 0 ? gv.x : 0.f, g1 = d_out > 1 ? gv.y : 0.f,
                g2 = d_out > 2 ? gv.z : 0.f;
    const float* G = gtab + cm.w * G_SIZE;
#pragma unroll
    for (int ij = 0; ij < 3 * J_MAX; ++ij)
      s_p[f * P_PITCH + ij] = G[ij * 3] * g0 + G[ij * 3 + 1] * g1 + G[ij * 3 + 2] * g2;
    s_p[f * P_PITCH + 3 * J_MAX] = 0.f;
  }
  const float* wsrc = w + row0 * F;             // count * F contiguous floats
  if (F % 4 == 0) {
    for (int i = tid; i < count * (F / 4); i += nt) {
      const int ml = i / (F / 4), f4 = 4 * (i - ml * (F / 4));
      const float4 v = reinterpret_cast<const float4*>(wsrc)[i];
      float* d = s_w + ml * Fp + f4;
      d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
    }
  } else {
    for (int i = tid; i < count * F; i += nt) {
      const int ml = i / F;
      s_w[ml * Fp + (i - ml * F)] = wsrc[i];
    }
  }
  const float* xsrc = x + ((size_t)b * M + m0) * D;
  for (int i = tid; i < count * D; i += nt) {
    const int ml = i / D;
    s_x[ml * Dp + (i - ml * D)] = xsrc[i];
  }
  for (int i = tid; i < count * SHP; i += nt) {
    const int ml = i / SHP, j = i - ml * SHP;
    s_sh[i] = j < S ? sh[(row0 + ml) * S + j] : 0.f;
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int q = tid >> 5; q < n_paths; q += nt >> 5) {   // one warp per path
    if (lane >= count) continue;
    const int4 pt = ptab[q];
    const int4 cm = chan[pt.x];
    const float* p = s_p + pt.x * P_PITCH;
    float* wf = s_w + lane * Fp + pt.x;
    const float* xf = s_x + lane * Dp + cm.x;
    const float* sv = s_sh + lane * SHP + cm.z;
    float* part = s_part + (q * SH_CHUNK + lane) * J_MAX;
    if (pt.z == 1) path_dw_dsh<1>(p, wf, xf, sv, pt.y, cm.y, part);
    else if (pt.z == 3) path_dw_dsh<3>(p, wf, xf, sv, pt.y, cm.y, part);
    else path_dw_dsh<5>(p, wf, xf, sv, pt.y, cm.y, part);
  }
  __syncthreads();

  float* dwdst = dw + row0 * F;
  if (F % 4 == 0) {
    for (int i = tid; i < count * (F / 4); i += nt) {
      const int ml = i / (F / 4), f4 = 4 * (i - ml * (F / 4));
      const float* d = s_w + ml * Fp + f4;
      reinterpret_cast<float4*>(dwdst)[i] = make_float4(d[0], d[1], d[2], d[3]);
    }
  } else {
    for (int i = tid; i < count * F; i += nt) {
      const int ml = i / F;
      dwdst[i] = s_w[ml * Fp + (i - ml * F)];
    }
  }
  for (int r = tid; r < count * S; r += nt) {
    const int ml = r / S, s = r - ml * S;
    float sum = 0.f;
    for (int k = s_segptr[s]; k < s_segptr[s + 1]; ++k)
      sum += s_part[(s_seg[k].x * SH_CHUNK + ml) * J_MAX + s_seg[k].y];
    dsh[row0 * S + r] = sum;
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

// dsh may be null: then only dw is computed, by the kernel that tiles receivers
// and senders (mt senders a block, 1 <= mt <= 16), and w, seg_ptr and seg are
// not read.  Else one kernel computes dw and dsh in one pass over w.
int dp_tp_aggregate_bwd_edge(const float* x, const float* sh, const float* w, const float* g,
                             const int* chan, const int* ptab, const float* gtab,
                             const int* seg_ptr, const int* seg, float* dw, float* dsh, int B,
                             int N, int M, int D, int S, int F, int n_paths, int mt, int n_seg,
                             void* stream) {
  if (bad_shape(B, N, M, D, S, F, n_paths) || mt < 1 || mt > MT_MAX || n_seg < 0 ||
      (N + TN - 1) / TN > 65535 || N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* chan4 = reinterpret_cast<const int4*>(chan);
  const int4* ptab4 = reinterpret_cast<const int4*>(ptab);
  const size_t dw_bytes = sizeof(float) * ((size_t)n_paths * G_SIZE + (size_t)TN * mt * SH_STRIDE +
                                           (size_t)mt * D);
  const size_t sh_bytes =
      sizeof(float) * ((size_t)F * P_PITCH +
                       (size_t)SH_CHUNK * ((F | 1) + (D | 1) + SHP) +
                       (size_t)n_paths * SH_CHUNK * J_MAX + ((S + 1 + 3) / 4) * 4 + (size_t)n_seg * 2);
  if (dw_bytes > MAX_SMEM || sh_bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool allowed = false;   // the attributes are set once
  if (!allowed) {
    cudaError_t err = allow_shared(tp_aggregate_bwd_edge_kernel, MAX_SMEM);
    if (err == cudaSuccess) err = allow_shared(tp_aggregate_bwd_edge_kernel_dsh, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  if (dsh == nullptr) {
    const dim3 grid((M + mt - 1) / mt, (N + TN - 1) / TN, B);
    tp_aggregate_bwd_edge_kernel<<<grid, threads_for(F), dw_bytes, st>>>(
        x, sh, g, chan4, ptab4, gtab, dw, N, M, D, S, F, n_paths, mt);
  } else {
    // one warp per path, between 8 and 16 warps
    const int threads = 32 * (n_paths < 8 ? 8 : n_paths > 16 ? 16 : n_paths);
    const dim3 grid((M + SH_CHUNK - 1) / SH_CHUNK, N, B);
    tp_aggregate_bwd_edge_kernel_dsh<<<grid, threads, sh_bytes, st>>>(
        x, sh, w, g, chan4, ptab4, gtab, seg_ptr, reinterpret_cast<const int2*>(seg), dw, dsh, N, M,
        D, S, F, n_paths, n_seg);
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
