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
// f32, half that in bf16) and the forward and dx kernels read it once, the
// edge backward writes dw once (and reads w once where dsh is needed); x, sh,
// g and out are small beside it.  The arithmetic is 2K + 1 multiply-adds per
// edge and channel, far under the byte bound.  Over the six layer-0
// convolutions of a training step the forward's and dx's bound is about
// 25 us in f32, so one launch per path and narrow grids of small blocks would
// leave the launch floor and idle SMs in charge: hence one launch per
// convolution, and grids that fill every resident block slot.
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
// Edge backward, dw and dsh (one launch per convolution, all its paths):
//  * bound by bytes: the dw write and one read of the harmonic components
//    the paths read, plus one read of w and the dsh write where the
//    harmonics need a gradient.  Nothing is summed across edges (dw is a
//    per-edge product, dsh sums over one edge's channels), so it is a
//    streaming pass: no split, no second kernel, no block barrier;
//  * lane = four neighbouring channels of a row, one 16-byte (f32) or
//    8-byte (bf16) access of w, dw and, where the table allows, x; G =
//    ceil(F / 4) lanes take an edge, so a warp takes 32 / G neighbouring
//    edges at once (F = 40: 10 lanes, three edges, 480 or 240 coalesced
//    bytes of dw).  Rows whose width is not a multiple of four, or whose
//    base is not aligned to four elements, take scalar accesses;
//  * a warp walks a contiguous run of the flattened (b, n, m) edges, so it
//    streams one stretch of dw (and w); the grid is as many blocks as the
//    card holds at once (an occupancy query), the runs split evenly across
//    their warps.  Per receiver the run enters, each lane turns the table
//    and g into a coefficient per channel and harmonic component (c_p g[k]
//    at component offset + k, 0 elsewhere); the edge's first P = 4 harmonic
//    components (the layer-0 convs' paths read 0-3; a conv whose paths read
//    a later one is refused) are read once for all paths.  dw = x sum_s
//    sh[s] coef[s].  Two steps of edges are loaded before either is
//    finished, to keep loads in flight;
//  * dsh[s] = sum over the row's channels of x w coef[s]: each lane adds its
//    four channels, puts its P sums in shared memory, and one lane per
//    (edge, component) adds the edge's G lanes in order and writes the full
//    S-component row (0 where no path reads).  No atomics: two runs agree
//    to the bit.
// Lanes.  The forward and edge backward above take the dense 4-lane layout
// (K <= 3, g and out (B, N, F, 4), P = 4 components in the edge backward);
// dx is a template on L, the largest l of the convolution's irreps.  At L = 2
// (K <= 5: the 0e x 2e -> 2e path of the second-order layer-0 convolutions; g
// and out (B, N, F, 8), lanes 5-7 zero, never read) the dense mode has three
// kernels of its own, and the sender-index mode's forward and dw one kernel
// at both lane counts (below).
// Their lane is a unit (tp_scalar.units_l2): up to four neighbouring channels
// of one path, so it reads x and w as one 16-byte (f32) or 8-byte (bf16)
// access where every path is four channels wide at a multiple of four and
// the bases allow (else element by element: the same sums in the same
// order), and only its path's K harmonic components.
//  * tp_scalar_fwd_l2_kernel.  The L = 2 instantiation of the forward above
//    split the senders across blocks until the grid filled the card, and
//    wrote and re-read (B, N, F, 8) f32 partial sums a split (24-95 MB over
//    the six layer-0 convs, beside w's 110 / 55 MB) in a second kernel;
//    each thread (receiver, channel) loaded x, w and five harmonic
//    components an edge: 0.114-0.117 / 0.110-0.113 ms (f32 / bf16) over the
//    six convs, 0.101-0.102 / 0.098-0.104 on one split
//    (analysis/k3_l2_fwd_edge_variants.py, NVIDIA H100 80GB HBM3 at 700 W).
//    Here a block owns R whole receivers of one batch row and all their
//    senders: thread = (receiver, slice of SL, unit), the slices of a
//    receiver sum its senders s, s + SL, ... in order, F2_U = 4 senders'
//    w in flight a lane, with a chunk of MC senders' harmonics (the block's
//    receivers) and rows of x staged in shared memory as f32 (f32 operands
//    by cp.async, every copy in flight at once; bf16 through registers,
//    four loads a thread in flight); then the slices' sums meet in shared
//    memory, are added in order and written once.  (R, SL) come from a
//    cost model over waves of the card's block slots (tp_scalar.plan_fwd_l2,
//    an occupancy query).  0.0767 / 0.0760 ms (72 / 64 registers; the same
//    card, PERF.md); staged through registers at f32 too, 0.0892.
//    Tried and not kept: the same lanes with x, w and the harmonics loaded
//    from device memory two senders at a time, no staging (0.080 / 0.086:
//    f32 faster then, bf16 slower); two or eight senders in flight (0.093 / 0.080, 0.100 /
//    0.080); fixed plans of 1-8 receivers a block (0.093-0.135 /
//    0.083-0.117); registers capped for three or four blocks an SM (0.088
//    / 0.081, 0.088 / 0.075 with spills); the staging's loads issued eight
//    or sixteen a thread before any store (91-96 registers: 0.094 /
//    0.103-0.111).  Without its staging the forward takes 0.058 / 0.065,
//    without w's device-memory reads 0.074 / 0.072 (timing only): bf16's staging, whose copies cp.async cannot convert,
//    is what is left to hide.
//  * tp_scalar_bwd_edge_l2_kernel.  The L = 2 instantiation of the edge
//    backward above held coef[4][9] a lane and loaded all nine harmonic
//    components of each edge (114-128 registers, two blocks an SM), and
//    added dsh over an edge's 15 lanes in a serial chain: 0.108-0.110 /
//    0.116-0.127 ms.  Here a lane holds coef[4][5] for its path's K
//    components and loads only those, dsh component s adds only the units
//    whose path reads it (5 at F = 60), and its registers are capped for
//    three blocks an SM (E2_MIN_BLOCKS): 0.0905 / 0.0865 ms (78-80
//    registers).  Uncapped (90-112 registers, two blocks an SM) it took
//    0.096 / 0.107.  What bounds it is latency, not bytes: without its
//    harmonic loads it takes 0.082 / 0.075, without its dw stores 0.072 /
//    0.080 (timing only), and writing dw alone (fill_) 0.037 /
//    0.022.  Tried and not kept: one or four steps in flight (0.098 /
//    0.087, 0.094-0.116 / 0.103-0.105); four or five blocks an SM (spills:
//    0.099-0.116 / 0.087-0.100); each warp's harmonic rows staged 16 edges
//    at a time in shared memory, the next chunk's loads in flight (0.108-
//    0.127 / 0.115-0.135); dsh's sums read four at a time (no change).
//  * tp_scalar_bwd_x_l2_kernel (dx).  The dx above, a thread per (sender, channel),
// read its receiver's g row as two float4 for every (edge, channel), 32
// bytes of which it used 5 floats, from L1 at a 32-byte stride (8 loads of
// 128 bytes for a warp's 32 channels): 0.133 / 0.129 ms (f32 / bf16) over
// the six layer-0 convs of a second-order training step, 3.4x / 6.2x its
// byte bound.  Here thread = (channel, group of X2_Q = 4 senders): per
// receiver it loads the channel's g row once for its four senders (lanes
// 0-3 as a float4, lane 4 only where K = 5), then each sender's element of
// w (a warp's neighbouring channels: one coalesced row) and its K harmonic
// components (broadcast); a block takes a run of up to X2_Q (X2_THREADS /
// F) senders of one batch row and a chunk of receivers, no barrier before
// the end, and the host splits the receivers down to X2_MIN_CHUNK = 4 so
// that the grid holds four times the block slots the card has.  0.1231 /
// 0.1226 ms (chip_smoke.py phase 16 on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md): faster than the thread-per-(sender, channel) dx at both
// dtypes, still 3.1x / 5.9x the byte bound.  Tried and slower
// (analysis/k3_dx_l2_variants.py): g, harmonics (and w) staged a block on a
// cp.async ring, thread = (sender, four channels) (0.121-0.165 /
// 0.136-0.199 ms); more loads in flight (two or four receivers unrolled,
// eight senders a thread: 0.134-0.200 ms); registers capped for three
// blocks an SM (0.22-0.24 ms); w loaded evict-first (f32 5% faster, bf16 2%
// slower).
//  * Past 32 units (ns = 48 and 64 at l = 2: 36 and 48 units) the edge
//    backward's instantiation UG = 2 gives lane j units j and j + 32, a warp
//    one edge at a time, and dsh adds the same component lists in the same
//    order (registers uncapped).
// Sender-index mode (the KNN phore grid): an int32 index (B, N, K) names the
// sender row of x (B, Mx, U) that slot k of receiver n reads; sh, w and dw
// are (B, N, K, .).  The forward and dw: tp_scalar_idx_kernel<T, LANES, VEC,
// DW>, at 4 and 8 lanes.  What bounds them: the bytes of w (forward) or dw,
// 3.2 us at 4 lanes and 5.2 at 8 over a 24-row KNN step's layer-0 phore conv
// in f32, so a launch's own floor (~3 us) stands near the bound.  The
// general kernels' sender-index instantiations (the first design: a thread
// per (receiver, channel), the slots split across blocks and their partial
// sums added by a second kernel, a chain of index-then-x loads a slot, at L
// = 2 all five harmonic components a channel; the edge backward the general
// body with coef for all 9 components) took 0.0098 / 0.0100 and 0.0178 /
// 0.0158 ms (forward, f32 / bf16, 4 and 8 lanes) and 0.0067 / 0.0077 and
// 0.0117 / 0.0144 (dw), 2.1-5.6x their bounds.  Here the dense 8-lane
// forward's design takes the index: a block owns R whole receivers and all
// their K slots (one chunk on the KNN shapes: no partial sums, no second
// kernel) and stages the chunk's harmonics (f32 by cp.async, 16 bytes a
// copy where the rows allow), which every unit of a path reads; thread =
// (receiver, slice, unit), up to 16 slots a thread (dw 8), the unit's K
// harmonic components only, each slot's index and the unit's x elements
// read from device memory (no other thread reads those elements); the
// forward reads w four slots at a time and adds the slices in order, dw
// turns c_p g into coef once a receiver and writes each slot's units side
// by side, once.  What the launch's fixed chain costs sets these kernels
// (a few us of a launch, then index -> x, w and the harmonics' copy in
// flight): staging the block's index rows once and the slots' x rows by
// cp.async behind them, as a first version did, added a barrier and a
// round trip and took 10.9 / 11.7 and 14.1 / 13.4 us (forward) and 8.5 /
// 8.7 and 12.6 / 14.3 (dw); fewer slots a thread (more, smaller blocks)
// took longer, and the forward, which adds its slices' sums at the end,
// gains from fewer slices than dw (analysis/k3_idx_variants.py, PERF.md).
// Sender-index dx: tp_scalar_bwd_x_idx_slots, _chunks and _sum.  What bounds
// it: the bytes of the dense dx (each slot's w row and harmonics, each
// receiver's g row once, dx once), about 3 us at 4 lanes and K = 24 on a
// 24-complex step.  But a sender's slots are scattered over the receivers
// (the host's inverse lists `order` / `ptr` name them), and under KNN their
// counts are uneven (a phore point among the K nearest of most receivers has
// dozens, a padded one none).  The first version walked one sender's whole
// list a thread, a chain of dependent loads (the slot, then its w, sh and g)
// as long as the longest list on a grid of a few small blocks: 13x its
// bound, no faster than a gathered einsum with index_add_.  Cutting the
// lists into chunks (below) alone left a second cost in view: a slot reads
// its receiver's g row (16 or 32 bytes a channel), so walking by sender read
// g once per (slot, channel), 4 to 8 times the bytes of w, from L2.  So:
//  * _slots, receiver by receiver (a thread per (receiver, channel), its g
//    row read once): each slot's f32 term y = w * sum_k sh g, written in slot
//    order, coalesced;
//  * _chunks: every sender's list cut into chunks of at most Q slots
//    (`cuts`: the chunks tile `order` in its own order, chunk i is
//    order[cuts[i] .. cuts[i + 1])), Q chosen on the host so that the chunks
//    fill every block slot the card holds (an occupancy query); a thread per
//    (chunk, channel) loads eight slots' terms before adding any, in order,
//    into an f32 scratch row;
//  * _sum: each sender's chunks added in order (`row_ptr`: its extent in the
//    chunks), times c_p, then the channels that read one element, as the
//    dense dx adds them.
// No atomics: reruns agree to the bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int THREADS = 256;     // threads of a forward or dx block (at most)
constexpr int EDGE_THREADS = 256;                // threads of an edge-backward block
constexpr int EDGE_WARPS = EDGE_THREADS / 32;
constexpr int EDGE_F_MAX = 128;  // channels of a row: four a lane
constexpr int P = 4;             // harmonic components the edge backward reads
constexpr int EB = 2;            // steps of the edge backward loaded before any is finished

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
// The dense 4-lane forward (the 8-lane one and the sender-index mode have
// kernels of their own).
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
  const size_t at = ((size_t)blockIdx.x * B * N + (size_t)b * N + n) * F + f;
  reinterpret_cast<float4*>(dst)[at] =
      make_float4(sc * a0, k1 ? sc * a1 : 0.f, k2 ? sc * a2 : 0.f, 0.f);
}

// Writes dx (B, M, D) in T when one split, else f32 partial sums (splits, B, M, D).
// L = 1 only: the 8-lane dx is tp_scalar_bwd_x_l2_kernel.
template <typename T, int L>
__global__ void __launch_bounds__(THREADS) tp_scalar_bwd_x_kernel(
    const T* __restrict__ sh,          // (B, N, M, S)
    const T* __restrict__ w,           // (B, N, M, F)
    const float* __restrict__ g,       // (B, N, F, 4 L) upstream gradient
    const int4* __restrict__ chan,     // (F): x element, sh offset, K, 0
    const float* __restrict__ scale,   // (F)
    const int* __restrict__ d_ptr,     // (D + 1): extents into d_item per input element
    const int* __restrict__ d_item,    // the channels reading each element, ascending
    T* __restrict__ dx, float* __restrict__ part, int B, int N, int M, int D, int S,
    int F, int n_items, int keep, int chunk) {
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
      // L float4 of g a channel
      const float4* gp = reinterpret_cast<const float4*>(g) + ((size_t)b * N * F + f) * L;
#pragma unroll 8
      for (int n = n0; n < n1; ++n) {
        const float wv = ld(wp + n * edge_n * F);
        const T* s = sp + n * edge_n * S;
        const float4 gv = __ldg(gp + (size_t)n * F * L);
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

// ---- the 8-lane dx: four senders a thread (head note) ----

constexpr int X2_THREADS = 256;   // threads of a block at most: (channel, group of senders) each
constexpr int X2_Q = 4;           // senders of a thread: each g load serves them all

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// The shared memory of a block, in floats: the (sender, channel) sums of
// its run, then the d lists.
__host__ __device__ inline int x2_floats(int F, int D, int n_items, int run) {
  return pad4(run * F) + pad4(D + 1) + pad4(n_items);
}

// dx (B, M, D) of every path at L = 2, in T, or the f32 partial sums
// (splits, B, M, D) where the receivers are split.  Block: batch row
// blockIdx.z, senders blockIdx.y * run .. (a run of at most X2_Q (X2_THREADS /
// F) senders), receivers [blockIdx.x * chunk, + chunk).  Thread = (channel,
// group of X2_Q senders of the run): per receiver it loads the channel's g
// row once (lanes 0-3 as a float4, lane 4 where K = 5) for its senders,
// then each sender's w and harmonics (neighbouring threads, neighbouring
// channels: coalesced rows of w, broadcast harmonics):
// acc[q] += w sum_{k < K} sh[off + k] g[k].  Then the channels that read
// one element are added in the order of the d list, as the 4-lane dx adds
// them.
template <typename T>
__global__ void __launch_bounds__(X2_THREADS) tp_scalar_bwd_x_l2_kernel(
    const T* __restrict__ sh,          // (B, N, M, S)
    const T* __restrict__ w,           // (B, N, M, F)
    const float* __restrict__ g,       // (B, N, F, 8) upstream gradient
    const int4* __restrict__ chan,     // (F): x element, sh offset, K, 0
    const float* __restrict__ scale,   // (F)
    const int* __restrict__ d_ptr,     // (D + 1): extents into d_item per input element
    const int* __restrict__ d_item,    // the channels reading each element, ascending
    T* __restrict__ dx, float* __restrict__ part, int B, int N, int M, int D, int S, int F,
    int n_items, int run, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* s_part = smem;                                             // [sender of the run][F]
  int* s_dptr = reinterpret_cast<int*>(smem + pad4(run * F));       // D + 1
  int* s_ditem = s_dptr + pad4(D + 1);                              // n_items
  const int tid = threadIdx.x, nt = blockDim.x;
  const int grp = tid / F, f = tid - grp * F;
  const int b = blockIdx.z, m0 = blockIdx.y * run;
  const int cnt = min(run, M - m0);              // senders of the block
  const int mq = grp * X2_Q;                     // the thread's first sender in the run
  const int nq = min(X2_Q, cnt - mq);            // and its count (none past the run)
  for (int i = tid; i <= D; i += nt) s_dptr[i] = d_ptr[i];
  for (int i = tid; i < n_items; i += nt) s_ditem[i] = d_item[i];
  float acc[X2_Q] = {};
  if (nq > 0) {
    const int4 c = chan[f];
    const int K = c.z;
    const int n0 = blockIdx.x * chunk, n1 = min(N, n0 + chunk);
    const size_t wstep = (size_t)M * F, sstep = (size_t)M * S;     // between receivers
    const T* wp = w + ((size_t)b * N * M + m0 + mq) * F + f;
    const T* sp = sh + ((size_t)b * N * M + m0 + mq) * S + c.y;
    const float* gp = g + ((size_t)b * N * F + f) * 8;
#pragma unroll 1
    for (int n = n0; n < n1; ++n) {
      const float4 ga = __ldg(reinterpret_cast<const float4*>(gp + (size_t)n * F * 8));
      const float gk[5] = {ga.x, ga.y, ga.z, ga.w, K > 4 ? __ldg(gp + (size_t)n * F * 8 + 4) : 0.f};
      float wv[X2_Q];
#pragma unroll
      for (int q = 0; q < X2_Q; ++q) wv[q] = q < nq ? ld(wp + n * wstep + q * F) : 0.f;
#pragma unroll
      for (int q = 0; q < X2_Q; ++q) {
        if (q >= nq) break;
        const T* s = sp + n * sstep + q * S;
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < 5; ++k)
          if (k < K) t = fmaf(ld(s + k), gk[k], t);
        acc[q] = fmaf(wv[q], t, acc[q]);
      }
    }
    const float sc = scale[f];
#pragma unroll
    for (int q = 0; q < X2_Q; ++q)
      if (q < nq) s_part[(mq + q) * F + f] = acc[q] * sc;
  }
  __syncthreads();
  for (int r = tid; r < cnt * D; r += nt) {
    const int k = r / D, d = r - k * D;
    float sum = 0.f;
    for (int e = s_dptr[d]; e < s_dptr[d + 1]; ++e) sum += s_part[k * F + s_ditem[e]];
    const size_t at = ((size_t)b * M + m0 + k) * D + d;
    if (part != nullptr) part[(size_t)blockIdx.x * B * M * D + at] = sum;
    else dx[at] = from_f<T>(sum);
  }
}

// ---- sender-index dx: per-slot terms, slot chunks, a sum per sender (head note) ----

constexpr int IDX_UNROLL = 8;   // slots of a chunk whose loads are in flight at once

// y[e, f] = w[e, f] * sum_k sh[e, off_f + k] g[e / M, f, k] (f32) of every
// slot e: a thread per (receiver row, channel) reads its g row once and walks
// the row's M slots.
template <typename T, int L>
__global__ void __launch_bounds__(THREADS) tp_scalar_bwd_x_idx_slots(
    const T* __restrict__ sh,          // (B, N, M, S)
    const T* __restrict__ w,           // (B, N, M, F)
    const float* __restrict__ g,       // (B, N, F, 4 L) upstream gradient
    const int4* __restrict__ chan,     // (F): x element, sh offset, K, 0
    float* __restrict__ y, int receivers, int M, int S, int F, int keep) {
  const int tid = threadIdx.x;
  const int kl = tid / F, f = tid - kl * F;
  const int rr = blockIdx.x * keep + kl;
  if (kl >= keep || rr >= receivers) return;
  const int4 c = chan[f];
  const int k1 = c.z > 1 ? 1 : 0, k2 = c.z > 2 ? 2 : 0;
  const int k3 = c.z > 3 ? 3 : 0, k4 = c.z > 4 ? 4 : 0;   // (L = 2)
  const float4* gp = reinterpret_cast<const float4*>(g) + ((size_t)rr * F + f) * L;
  const float4 gv = __ldg(gp);
  float4 gw = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (L == 2) gw = __ldg(gp + 1);
  const float c1 = k1 ? gv.y : 0.f, c2 = k2 ? gv.z : 0.f;
  const float c3 = k3 ? gv.w : 0.f, c4 = k4 ? gw.x : 0.f;
  const size_t e0 = (size_t)rr * M;
#pragma unroll 4
  for (int k = 0; k < M; ++k) {
    const size_t e = e0 + k;
    const T* s = sh + e * S + c.y;
    float t = ld(s) * gv.x;
    t = fmaf(ld(s + k1), c1, t);
    t = fmaf(ld(s + k2), c2, t);
    if constexpr (L == 2) {
      t = fmaf(ld(s + k3), c3, t);
      t = fmaf(ld(s + k4), c4, t);
    }
    y[e * F + f] = ld(w + e * F + f) * t;
  }
}

// part[i][f] = the f32 sum over chunk i's slots order[cuts[i] .. cuts[i + 1])
// of y[e, f], in order, for the first row_ptr[rows] chunks (the rest of the
// grid-stride range is the host's bound).
__global__ void __launch_bounds__(THREADS) tp_scalar_bwd_x_idx_chunks(
    const float* __restrict__ y,       // (B * N * M, F) the slots' terms
    const int* __restrict__ order,     // the flat slots (b * N + n) * M + k by sender
    const int* __restrict__ cuts,      // (chunks + 1): each chunk's extent in order
    const int* __restrict__ row_ptr,   // (rows + 1): each sender's extent in the chunks
    float* __restrict__ part, int F, int keep, int rows) {
  const int tid = threadIdx.x;
  const int kl = tid / F, f = tid - kl * F;
  if (kl >= keep) return;
  const int chunks = __ldg(row_ptr + rows);
  for (int it = blockIdx.x * keep + kl; it < chunks; it += gridDim.x * keep) {
    const int q0 = __ldg(cuts + it), q1 = __ldg(cuts + it + 1);
    float acc = 0.f;
    for (int q = q0; q < q1; q += IDX_UNROLL) {
      // every load of IDX_UNROLL slots issued before any is used
      float v[IDX_UNROLL];
#pragma unroll
      for (int u = 0; u < IDX_UNROLL; ++u)
        v[u] = q + u < q1 ? __ldg(y + (size_t)__ldg(order + q + u) * F + f) : 0.f;
#pragma unroll
      for (int u = 0; u < IDX_UNROLL; ++u)
        if (q + u < q1) acc += v[u];
    }
    part[(size_t)it * F + f] = acc;
  }
}

// dx[r, d] = sum over the channels f reading element d (d_item order) of
// c_p(f) * (the sum of sender r's chunks' part[., f], in order).
template <typename T>
__global__ void tp_scalar_bwd_x_idx_sum(const float* __restrict__ part,
                                        const int* __restrict__ row_ptr,
                                        const float* __restrict__ scale,
                                        const int* __restrict__ d_ptr,
                                        const int* __restrict__ d_item, T* __restrict__ dx,
                                        int rows, int D, int F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * D) return;
  const int r = i / D, d = i - r * D;
  const int it0 = __ldg(row_ptr + r), it1 = __ldg(row_ptr + r + 1);
  float sum = 0.f;
  for (int e = __ldg(d_ptr + d); e < __ldg(d_ptr + d + 1); ++e) {
    const int f = __ldg(d_item + e);
    float s = 0.f;
    for (int it = it0; it < it1; ++it) s += part[(size_t)it * F + f];
    sum += __fmul_rn(s, scale[f]);
  }
  dx[i] = from_f<T>(sum);
}

// ---- dw and dsh: one launch per convolution (head note) ----

// Four neighbouring elements of a row as f32, and back (the address aligned
// to four elements).
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&a);
  t.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// dw (B, N, M, F) where dw != nullptr and, with DSH, dsh (B, N, M, S), in T.
// VEC: F a multiple of four and the rows of dw (and of w with DSH) aligned
// to four elements; xvec: each lane's four channels read four neighbouring,
// aligned elements of x.  No channel reads a harmonic component past P.
// The dense 4-lane edge backward (the 8-lane one and the sender-index mode
// have kernels of their own).
template <typename T, bool DSH, bool VEC>
__global__ void __launch_bounds__(EDGE_THREADS) tp_scalar_bwd_edge_kernel(
    const T* __restrict__ x,           // (B, M, D) sender scalars
    const T* __restrict__ sh,          // (B, N, M, S) harmonics
    const T* __restrict__ w,           // (B, N, M, F) pre-masked edge weights (DSH)
    const float* __restrict__ g,       // (B, N, F, 4) upstream gradient
    const int4* __restrict__ chan,     // (F): x element, sh offset, K, 0
    const float* __restrict__ scale,   // (F): c_p of the channel's path
    T* __restrict__ dw, T* __restrict__ dsh, int N, int M, int D, int S, int F, int edges,
    int xvec) {
  __shared__ float s_red[DSH ? EDGE_THREADS * P : 1];   // each lane's dsh partial sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = (F + 3) / 4;                     // lanes of one edge
  const int step = 32 / G;                       // edges a warp takes at once
  const int q = lane / G, j = lane - q * G;      // the lane's edge of a step, its channel quad
  const bool active = q < step;
  const bool with_dw = dw != nullptr;
  int cd[4], co[4], ck[4];
  float cs[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int f = 4 * j + c;
    const bool on = active && f < F;
    const int4 t = on ? chan[f] : make_int4(0, 0, 0, 0);
    cd[c] = t.x;
    co[c] = t.y;
    ck[c] = t.z;
    cs[c] = on ? scale[f] : 0.f;
  }
  const int warps = gridDim.x * EDGE_WARPS;
  const int per = ((edges + warps - 1) / warps + step - 1) / step * step;
  const int first = (blockIdx.x * EDGE_WARPS + warp) * per;
  const int e_end = min(edges, first + per);
  float* red = s_red + (warp * 32) * P;

  for (int e = first; e < e_end;) {
    const int r = e / M;                              // receiver row b * N + n
    const int seg_end = min(e_end, (r + 1) * M);
    const int x_of = (r / N) * M - r * M;             // + edge: the sender row of an edge
    // per channel, c_p g[k] at harmonic component offset + k, 0 elsewhere
    float coef[4][P];
    {
      const float* gr = g + (r * F + 4 * j) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (k < ck[c]) a[k] = cs[c] * gr[c * 4 + k];
#pragma unroll
        for (int s = 0; s < P; ++s) {
          const int k = s - co[c];
          coef[c][s] = k == 0 ? a[0] : (k == 1 ? a[1] : (k == 2 ? a[2] : 0.f));
        }
      }
    }
    for (; e < seg_end; e += EB * step) {
      // EB steps of `step` edges of one receiver: every load issued first
      float xv[EB][4], sv[EB][P], wv[EB][4];
#pragma unroll
      for (int i = 0; i < EB; ++i) {
        const int edge = e + i * step + q;
        const bool live = active && edge < seg_end;
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[i][c] = wv[i][c] = 0.f;
#pragma unroll
        for (int s = 0; s < P; ++s) sv[i][s] = 0.f;
        if (!live) continue;
        const T* xr = x + (x_of + edge) * D;
        if (xvec) {
          ld4(xr + cd[0], xv[i]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (4 * j + c < F) xv[i][c] = ld(xr + cd[c]);
        }
        if (with_dw) {
#pragma unroll
          for (int s = 0; s < P; ++s)
            if (s < S) sv[i][s] = ld(sh + edge * S + s);
        }
        if (DSH) {
          const T* wr = w + edge * F + 4 * j;
          if (VEC) {
            ld4(wr, wv[i]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (4 * j + c < F) wv[i][c] = ld(wr + c);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < EB; ++i) {
        const int edge = e + i * step + q;
        const bool live = active && edge < seg_end;
        if (with_dw && live) {
          float out[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float t = 0.f;
#pragma unroll
            for (int s = 0; s < P; ++s) t = fmaf(sv[i][s], coef[c][s], t);
            out[c] = xv[i][c] * t;
          }
          T* o = dw + edge * F + 4 * j;
          if (VEC) {
            st4(o, out);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (4 * j + c < F) o[c] = from_f<T>(out[c]);
          }
        }
        if (DSH) {
          // each lane's partial sums over its four channels, then one lane
          // per (edge, component) adds its edge's G lanes in order
          float acc[P];
#pragma unroll
          for (int s = 0; s < P; ++s) acc[s] = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float xw = xv[i][c] * wv[i][c];
#pragma unroll
            for (int s = 0; s < P; ++s) acc[s] = fmaf(xw, coef[c][s], acc[s]);
          }
#pragma unroll
          for (int s = 0; s < P; ++s) red[lane * P + s] = acc[s];
          __syncwarp();
          for (int o = lane; o < step * S; o += 32) {
            const int qq = o / S, s = o - qq * S;
            const int edge_q = e + i * step + qq;
            if (edge_q >= seg_end) continue;
            float sum = 0.f;
            if (s < P) {
              const float* pr = red + qq * G * P + s;
              for (int jj = 0; jj < G; ++jj) sum += pr[jj * P];
            }
            dsh[edge_q * S + s] = from_f<T>(sum);
          }
          __syncwarp();
        }
      }
    }
    e = seg_end;
  }
}

// ---- the dense 8-lane forward and edge backward: lane = a unit of one path (head note) ----

constexpr int KM = 5;              // harmonic components of a channel at L = 2, at most
constexpr int F2_THREADS = 256;    // threads of an 8-lane forward block at most
constexpr int F2_U = 4;            // senders whose w a forward lane loads before it adds any
constexpr int E2_THREADS = 256;    // threads of an 8-lane edge-backward block
constexpr int E2_WARPS = E2_THREADS / 32;
constexpr int E2_EB = 2;           // steps of edges loaded before any is finished
constexpr int E2_MIN_BLOCKS = 3;   // registers for three blocks an SM (at most 85 a thread)
constexpr int E2_UNITS = 64;       // units of an edge: two a lane past 32

// A unit: up to four neighbouring channels f0 .. f0 + cnt - 1 of one path,
// reading x elements d0 .. d0 + cnt - 1 and harmonic components off .. off +
// K - 1; packed as int4 (f0, d0, off, K + 8 cnt).
struct Unit {
  int f0, d0, off, K, cnt;
};
__device__ __forceinline__ Unit unit_of(int4 u) { return {u.x, u.y, u.z, u.w & 7, u.w >> 3}; }

// cnt neighbouring elements as f32 (VEC: four, one aligned access), 0 past cnt.
template <bool VEC, typename T>
__device__ __forceinline__ void ld_unit(const T* p, int cnt, float (&v)[4]) {
  if constexpr (VEC) {
    ld4(p, v);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < cnt ? ld(p + c) : 0.f;
  }
}

// A unit's elements of w as loaded, converted when used: one 16-byte (f32)
// or 8-byte (bf16) access where VEC, so that F2_U senders in flight cost a
// lane 4 F2_U (f32) or 2 F2_U (bf16) registers.
template <typename T, bool VEC>
struct Raw4 {
  float v[4];
  __device__ __forceinline__ void load(const T* p, int cnt) { ld_unit<false>(p, cnt, v); }
  __device__ __forceinline__ void get(float (&o)[4]) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = v[c];
  }
};
template <>
struct Raw4<float, true> {
  float4 v;
  __device__ __forceinline__ void load(const float* p, int) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void get(float (&o)[4]) const {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};
template <>
struct Raw4<__nv_bfloat16, true> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void get(float (&o)[4]) const {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
};

// A 4-byte (16-byte) copy from device to shared memory in flight until
// cp_async_wait_all.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Floats of an 8-lane forward block's shared memory: while it sums, a chunk
// of MC senders' harmonics for each of its R receivers (R MC S) and their
// rows of x (MC D, from a multiple of four); at the end each (receiver,
// slice, channel)'s KM sums, over the same space.
__host__ __device__ inline int f2_stage_floats(int R, int MC, int S, int D) {
  return pad4(R * MC * S) + MC * D;
}
__host__ __device__ inline int f2_floats(int R, int SL, int F, int MC, int S, int D) {
  const int sums = R * SL * F * KM, stage = f2_stage_floats(R, MC, S, D);
  return sums > stage ? sums : stage;
}

// out (B, N, F, 8) f32 of every path at L = 2, written once.  Block: batch
// row blockIdx.y, receivers blockIdx.x * R .. + R, all their senders, in
// chunks of MC (a multiple of SL): the block stages a chunk's harmonics of
// its receivers and the chunk's rows of x in shared memory (f32, coalesced),
// then thread = (receiver r, slice s of SL, unit j of G), j fastest, sums
// its slice's senders of the chunk, m = s, s + SL, ... in order: acc[c][k] +=
// x[m, d0 + c] w[n, m, f0 + c] sh[n, m, off + k], w read from device memory
// F2_U senders at a time (one access each where VEC), x and the path's K
// harmonic components from shared memory.  Then the slices' sums go to
// shared memory and each (receiver, channel) adds its SL slices in order,
// times c_p, and writes its 8 lanes (lanes past K zero).
template <typename T, bool VEC>
__global__ void __launch_bounds__(F2_THREADS) tp_scalar_fwd_l2_kernel(
    const T* __restrict__ x,           // (B, M, D) sender scalars
    const T* __restrict__ sh,          // (B, N, M, S) harmonics
    const T* __restrict__ w,           // (B, N, M, F) pre-masked edge weights
    const int4* __restrict__ units,    // (G) the lanes' units
    const int4* __restrict__ chan,     // (F): x element, sh offset, K, 0
    const float* __restrict__ scale,   // (F): c_p of the channel's path
    float* __restrict__ out, int N, int M, int D, int S, int F, int G, int R, int SL, int MC) {
  extern __shared__ __align__(16) float smem[];
  float* s_sh = smem;                                 // [R][MC][S]
  float* s_x = smem + pad4(R * MC * S);               // [MC][D]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rs = tid / G, j = tid - rs * G;
  const int r = rs / SL, s = rs - r * SL;
  const int b = blockIdx.y, n0 = blockIdx.x * R, n = n0 + r;
  const int rows = min(R, N - n0);                    // receivers of the block
  float acc[4][KM];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < KM; ++k) acc[c][k] = 0.f;
  Unit u = {0, 0, 0, 0, 0};
  if (r < R) u = unit_of(units[j]);
  const bool on = r < rows;
  const T* wr = w + ((size_t)b * N + n) * M * F + u.f0;
  for (int c0 = 0; c0 < M; c0 += MC) {
    const int cnt = min(MC, M - c0);
    __syncthreads();                                  // the last chunk's readers are done
    const int per = cnt * S;
    const T* shb = sh + (((size_t)b * N + n0) * M + c0) * S;
    const T* xb = x + ((size_t)b * M + c0) * D;
    if constexpr (sizeof(T) == 4) {   // f32: every copy in flight at once, no registers
      for (int i = tid; i < rows * per; i += nt) {
        const int rr = i / per;
        cp_async4(s_sh + rr * MC * S + i - rr * per, shb + (size_t)rr * M * S + i - rr * per);
      }
      for (int i = tid; i < cnt * D; i += nt) cp_async4(s_x + i, xb + i);
      cp_async_wait_all();
    } else {
#pragma unroll 4
      for (int i = tid; i < rows * per; i += nt) {
        const int rr = i / per;
        s_sh[rr * MC * S + i - rr * per] = ld(shb + (size_t)rr * M * S + i - rr * per);
      }
#pragma unroll 4
      for (int i = tid; i < cnt * D; i += nt) s_x[i] = ld(xb + i);
    }
    __syncthreads();
    if (!on) continue;
    const float* sr = s_sh + r * MC * S + u.off;
    const float* xr = s_x + u.d0;
    for (int m = s; m < cnt; m += F2_U * SL) {
      Raw4<T, VEC> wv[F2_U];                          // every load issued before any is used
#pragma unroll
      for (int i = 0; i < F2_U; ++i)
        if (m + i * SL < cnt) wv[i].load(wr + (size_t)(c0 + m + i * SL) * F, u.cnt);
#pragma unroll
      for (int i = 0; i < F2_U; ++i) {
        const int mm = m + i * SL;
        if (mm >= cnt) break;
        float wf[4], xv[4];
        wv[i].get(wf);
        if constexpr (VEC) {
          const float4 t = *reinterpret_cast<const float4*>(xr + mm * D);
          xv[0] = t.x;
          xv[1] = t.y;
          xv[2] = t.z;
          xv[3] = t.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = c < u.cnt ? xr[mm * D + c] : 0.f;
        }
        float sv[KM];
#pragma unroll
        for (int k = 0; k < KM; ++k) sv[k] = k < u.K ? sr[mm * S + k] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float xw = xv[c] * wf[c];
#pragma unroll
          for (int k = 0; k < KM; ++k) acc[c][k] = fmaf(xw, sv[k], acc[c][k]);
        }
      }
    }
  }
  __syncthreads();                                    // the sums take the staging space
  if (r < R) {
    float* dst = smem + ((size_t)(r * SL + s) * F + u.f0) * KM;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < u.cnt)
#pragma unroll
        for (int k = 0; k < KM; ++k) dst[c * KM + k] = acc[c][k];
  }
  __syncthreads();
  for (int i = tid; i < rows * F; i += nt) {
    const int rr = i / F, f = i - rr * F, nn = n0 + rr;
    const float* p = smem + (size_t)rr * SL * F * KM + f * KM;
    float a[KM];
#pragma unroll
    for (int k = 0; k < KM; ++k) a[k] = p[k];
    for (int sl = 1; sl < SL; ++sl)
#pragma unroll
      for (int k = 0; k < KM; ++k) a[k] += p[(size_t)sl * F * KM + k];
    const int K = chan[f].z;
    const float sc = scale[f];
    float4* o = reinterpret_cast<float4*>(out + (((size_t)b * N + nn) * F + f) * 8);
    o[0] = make_float4(sc * a[0], K > 1 ? sc * a[1] : 0.f, K > 2 ? sc * a[2] : 0.f,
                       K > 3 ? sc * a[3] : 0.f);
    o[1] = make_float4(K > 4 ? sc * a[4] : 0.f, 0.f, 0.f, 0.f);
  }
}

// dw (B, N, M, F) where dw != nullptr and, with DSH, dsh (B, N, M, S), in T,
// of every path at L = 2.  G <= 32 lanes take an edge (lane = unit), so a warp
// takes step = 32 / G neighbouring edges at once and walks a contiguous run
// of the flattened (b, n, m) edges; per receiver each lane turns c_p and g
// into coef[c][k] (0 past its unit's cnt and K).  dw = x sum_k sh[off + k]
// coef[k] from the unit's K components.  dsh[s] = the sum, over the units
// whose path reads component s (comp_item[comp_ptr[s] ..], in order), of
// sum_c x w coef[c][s - off]: each lane puts its KM sums in shared memory and
// lane (edge, s) of the warp adds that list and writes the edge's dsh row
// (0 where no path reads), coalesced.  No atomics: reruns agree to the bit.
// UG = 2 (G up to 64 units, ns up to 64): a warp takes one edge at a time,
// lane j its units j and j + 32, and dsh adds the same lists in the same
// order.
template <typename T, bool DSH, bool VEC, int UG>
__global__ void __launch_bounds__(E2_THREADS, UG == 1 ? E2_MIN_BLOCKS : 1) tp_scalar_bwd_edge_l2_kernel(
    const T* __restrict__ x,           // (B, M, D) sender scalars
    const T* __restrict__ sh,          // (B, N, M, S) harmonics
    const T* __restrict__ w,           // (B, N, M, F) pre-masked edge weights (DSH)
    const float* __restrict__ g,       // (B, N, F, 8) upstream gradient
    const int4* __restrict__ units,    // (G) the lanes' units
    const float* __restrict__ uscale,  // (G): c_p of the unit's path
    const int* __restrict__ comp_ptr,  // (S + 1): extents into comp_item per component (DSH)
    const int* __restrict__ comp_item, // unit j * KM + k of each component, ascending j
    T* __restrict__ dw, T* __restrict__ dsh, int N, int M, int D, int S, int F, int G,
    int n_items, int edges) {
  __shared__ float s_red[DSH ? E2_THREADS * KM * UG : 1];   // each unit's dsh sums
  extern __shared__ int s_comp[];                     // DSH: comp_ptr, then comp_item
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int step = UG == 1 ? 32 / G : 1;         // edges a warp takes at once
  const int q = UG == 1 ? lane / G : 0;          // the lane's edge of a step
  const int j = UG == 1 ? lane - q * G : lane;   // its unit (and j + 32 where UG = 2)
  const bool active = q < step;
  const bool with_dw = dw != nullptr;
  Unit u[UG];
  float sc[UG];
#pragma unroll
  for (int ug = 0; ug < UG; ++ug) {
    const int jj = j + 32 * ug;
    u[ug] = {0, 0, 0, 0, 0};
    sc[ug] = 0.f;
    if (active && jj < G) {
      u[ug] = unit_of(units[jj]);
      sc[ug] = uscale[jj];
    }
  }
  if constexpr (DSH) {
    for (int i = threadIdx.x; i <= S; i += E2_THREADS) s_comp[i] = comp_ptr[i];
    for (int i = threadIdx.x; i < n_items; i += E2_THREADS) s_comp[S + 1 + i] = comp_item[i];
    __syncthreads();
  }
  const int warps = gridDim.x * E2_WARPS;
  const int per = ((edges + warps - 1) / warps + step - 1) / step * step;
  const int first = (blockIdx.x * E2_WARPS + warp) * per;
  const int e_end = min(edges, first + per);
  float* red = s_red + (warp * 32) * KM * UG;

  for (int e = first; e < e_end;) {
    const int r = e / M;                              // receiver row b * N + n
    const int seg_end = min(e_end, (r + 1) * M);
    const int x_of = (r / N) * M - r * M;             // + edge: the sender row of an edge
    float coef[UG][4][KM];
#pragma unroll
    for (int ug = 0; ug < UG; ++ug) {
      const float* gr = g + ((size_t)r * F + u[ug].f0) * 8;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < KM; ++k)
          coef[ug][c][k] = c < u[ug].cnt && k < u[ug].K ? sc[ug] * gr[c * 8 + k] : 0.f;
    }
    for (; e < seg_end; e += E2_EB * step) {
      // E2_EB steps of `step` edges of one receiver: every load issued first
      float xv[E2_EB][UG][4], sv[E2_EB][UG][KM], wv[E2_EB][UG][4];
#pragma unroll
      for (int i = 0; i < E2_EB; ++i) {
        const int edge = e + i * step + q;
#pragma unroll
        for (int ug = 0; ug < UG; ++ug) {
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[i][ug][c] = wv[i][ug][c] = 0.f;
#pragma unroll
          for (int k = 0; k < KM; ++k) sv[i][ug][k] = 0.f;
          if (!active || edge >= seg_end || (UG > 1 && u[ug].cnt == 0)) continue;
          ld_unit<VEC>(x + (size_t)(x_of + edge) * D + u[ug].d0, u[ug].cnt, xv[i][ug]);
          if (with_dw) {
#pragma unroll
            for (int k = 0; k < KM; ++k)
              if (k < u[ug].K) sv[i][ug][k] = ld(sh + (size_t)edge * S + u[ug].off + k);
          }
          if (DSH) ld_unit<VEC>(w + (size_t)edge * F + u[ug].f0, u[ug].cnt, wv[i][ug]);
        }
      }
#pragma unroll
      for (int i = 0; i < E2_EB; ++i) {
        const int edge = e + i * step + q;
        const bool live = active && edge < seg_end;
#pragma unroll
        for (int ug = 0; ug < UG; ++ug) {
          if (!(with_dw && live) || (UG > 1 && u[ug].cnt == 0)) continue;
          float o[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float t = 0.f;
#pragma unroll
            for (int k = 0; k < KM; ++k) t = fmaf(sv[i][ug][k], coef[ug][c][k], t);
            o[c] = xv[i][ug][c] * t;
          }
          T* dst = dw + (size_t)edge * F + u[ug].f0;
          if constexpr (VEC) {
            st4(dst, o);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (c < u[ug].cnt) dst[c] = from_f<T>(o[c]);
          }
        }
        if constexpr (DSH) {
#pragma unroll
          for (int ug = 0; ug < UG; ++ug) {
            if (UG > 1 && j + 32 * ug >= G) break;
#pragma unroll
            for (int k = 0; k < KM; ++k) {
              float a = 0.f;
#pragma unroll
              for (int c = 0; c < 4; ++c) a = fmaf(xv[i][ug][c] * wv[i][ug][c], coef[ug][c][k], a);
              red[(UG == 1 ? lane : j + 32 * ug) * KM + k] = a;
            }
          }
          __syncwarp();
          const int base = e + i * step;
          for (int o = lane; o < step * S; o += 32) {
            const int qq = o / S, s_ = o - qq * S;
            if (base + qq >= seg_end) continue;
            float sum = 0.f;
            for (int it = s_comp[s_]; it < s_comp[s_ + 1]; ++it)
              sum += red[qq * G * KM + s_comp[S + 1 + it]];
            dsh[(size_t)base * S + o] = from_f<T>(sum);
          }
          __syncwarp();
        }
      }
    }
    e = seg_end;
  }
}

// ---- the sender-index forward and dw, both lane counts (head note) ----

// Floats of a sender-index block's shared memory: a chunk of MC slots' harmonics
// of its R receivers (R MC S, as f32); the forward at the end each
// (receiver, slice, channel)'s KM sums over the same space, and past it each
// channel's K and c_p (2 F).
__host__ __device__ inline int idx_work_floats(bool dw, int R, int SL, int F, int MC, int S) {
  const int sums = dw ? 0 : R * SL * F * KM, stage = R * MC * S;
  return pad4(sums > stage ? sums : stage);
}
__host__ __device__ inline int idx_floats(bool dw, int R, int SL, int F, int MC, int S) {
  return idx_work_floats(dw, R, SL, F, MC, S) + (dw ? 0 : 2 * F);
}

// The sender-index mode (x (B, Mx, D) read at idx (B, N, K), sh, w and dw
// (B, N, K, .)), LANES 4 or 8.  Block: batch row blockIdx.y, receivers
// blockIdx.x * R .. + R, all their K slots in chunks of MC (a multiple of
// SL; one chunk on the KNN shapes).  Per chunk the block stages its slots'
// harmonics (f32 by cp.async, bf16 converted through registers: every unit
// of a path reads them); thread = (receiver r, slice s of SL, unit j of G),
// j fastest, takes slots s, s + SL, ... in order, each slot's index and its
// sender's x elements read from device memory (a unit's own elements: no
// other thread reads them).
//  * forward (DW false): acc[c][k] += x[idx, d0 + c] w[n, m, f0 + c] sh[n, m,
//    off + k], w from device memory F2_U slots at a time (one access each
//    where VEC); then the slices' sums meet in shared memory, and each
//    (receiver, channel) adds its SL slices in order, times c_p, and writes
//    its LANES lanes once (lanes past K zero).
//  * dw (DW true): per receiver each thread turns c_p and g into coef[c][k]
//    once, then per slot dw = x sum_k sh[off + k] coef[k] from its unit's K
//    components, written once (a receiver's units of one slot side by side).
template <typename T, int LANES, bool VEC, bool DW>
__global__ void __launch_bounds__(F2_THREADS) tp_scalar_idx_kernel(
    const T* __restrict__ x,           // (B, Mx, D) sender scalars
    const T* __restrict__ sh,          // (B, N, K, S) slot harmonics
    const T* __restrict__ w,           // (B, N, K, F) pre-masked slot weights (forward)
    const int* __restrict__ idx,       // (B, N, K) the sender row of each slot
    const float* __restrict__ g,       // (B, N, F, LANES) upstream gradient (dw)
    const int4* __restrict__ units,    // (G) the lanes' units
    const float* __restrict__ uscale,  // (G): c_p of the unit's path
    const int4* __restrict__ chan,     // (F): x element, sh offset, K, 0 (forward)
    const float* __restrict__ scale,   // (F): c_p of the channel's path (forward)
    float* __restrict__ out,           // (B, N, F, LANES) (forward)
    T* __restrict__ dw,                // (B, N, K, F) (dw)
    int N, int K, int Mx, int D, int S, int F, int G, int R, int SL, int MC, int shq) {
  extern __shared__ __align__(16) float smem[];
  float* s_sh = smem;                                 // [R][MC][S]
  // forward: each channel's K and c_p, past the sums
  int* s_kf = reinterpret_cast<int*>(smem + idx_work_floats(DW, R, SL, F, MC, S));
  float* s_sc = reinterpret_cast<float*>(s_kf + F);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rs = tid / G, j = tid - rs * G;
  const int r = rs / SL, s = rs - r * SL;
  const int b = blockIdx.y, n0 = blockIdx.x * R, n = n0 + r;
  const int rows = min(R, N - n0);                    // receivers of the block
  Unit u = {0, 0, 0, 0, 0};
  float sc = 0.f;
  if (r < R) {
    u = unit_of(units[j]);
    sc = uscale[j];
  }
  const bool on = r < rows;
  const size_t row0 = ((size_t)b * N + n) * K;        // the receiver's first slot
  float acc[4][KM];                                   // forward: sums; dw: c_p g[k]
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < KM; ++k) acc[c][k] = 0.f;
  if (DW && on) {
    const float* gr = g + (((size_t)b * N + n) * F + u.f0) * LANES;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (c < u.cnt && k < u.K) acc[c][k] = sc * __ldg(gr + c * LANES + k);
  }
  if (!DW) {
    for (int f = tid; f < F; f += nt) {
      s_kf[f] = chan[f].z;
      s_sc[f] = scale[f];
    }
  }
  // the staging's copies: shq (f32): a receiver's run of harmonics in
  // 16-byte pieces (its length a multiple of four and its base aligned),
  // else one element at a time
  for (int c0 = 0; c0 < K; c0 += MC) {
    const int cnt = min(MC, K - c0);
    __syncthreads();                                  // the last chunk's readers are done
    const int per = cnt * S, perq = shq ? per / 4 : per;
    const T* shb = sh + (((size_t)b * N + n0) * K + c0) * S;
    for (int i = tid; i < rows * perq; i += nt) {
      const int rr = i / perq, e = i - rr * perq;
      float* d = s_sh + rr * MC * S;
      const T* src = shb + (size_t)rr * K * S;
      if constexpr (sizeof(T) == 4) {
        if (shq) cp_async16(d + 4 * e, src + 4 * e);
        else cp_async4(d + e, src + e);
      } else {
        d[e] = ld(src + e);
      }
    }
    if constexpr (sizeof(T) == 4) cp_async_wait_all();
    __syncthreads();
    if (!on) continue;
    const float* sr = s_sh + r * MC * S + u.off;
    // slot mm of the chunk: the unit's x elements (at the slot's index) and
    // K harmonic components
    auto x_of = [&](int mm, float (&xv)[4]) {
      const T* xg = x + ((size_t)b * Mx + __ldg(idx + row0 + c0 + mm)) * D + u.d0;
      if constexpr (VEC) {
        ld4(xg, xv);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = c < u.cnt ? ld(xg + c) : 0.f;
      }
    };
    auto sh_of = [&](int mm, float (&sv)[KM]) {
#pragma unroll
      for (int k = 0; k < KM; ++k) sv[k] = k < u.K ? sr[mm * S + k] : 0.f;
    };
    if constexpr (!DW) {
      const T* wr = w + row0 * F + u.f0;
      for (int m = s; m < cnt; m += F2_U * SL) {
        Raw4<T, VEC> wv[F2_U];                        // every load issued before any is used
#pragma unroll
        for (int i = 0; i < F2_U; ++i)
          if (m + i * SL < cnt) wv[i].load(wr + (size_t)(c0 + m + i * SL) * F, u.cnt);
#pragma unroll
        for (int i = 0; i < F2_U; ++i) {
          const int mm = m + i * SL;
          if (mm >= cnt) break;
          float wf[4], xv[4], sv[KM];
          wv[i].get(wf);
          x_of(mm, xv);
          sh_of(mm, sv);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float xw = xv[c] * wf[c];
#pragma unroll
            for (int k = 0; k < KM; ++k) acc[c][k] = fmaf(xw, sv[k], acc[c][k]);
          }
        }
      }
    } else {
      for (int m = s; m < cnt; m += SL) {
        float xv[4], sv[KM], o[4];
        x_of(m, xv);
        sh_of(m, sv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = 0.f;
#pragma unroll
          for (int k = 0; k < KM; ++k) t = fmaf(sv[k], acc[c][k], t);
          o[c] = xv[c] * t;
        }
        T* dst = dw + (row0 + c0 + m) * F + u.f0;
        if constexpr (VEC) {
          st4(dst, o);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < u.cnt) dst[c] = from_f<T>(o[c]);
        }
      }
    }
  }
  if constexpr (!DW) {
    __syncthreads();                                  // the sums take the staging space
    if (r < R) {
      float* dst = smem + ((size_t)(r * SL + s) * F + u.f0) * KM;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < u.cnt)
#pragma unroll
          for (int k = 0; k < KM; ++k) dst[c * KM + k] = acc[c][k];
    }
    __syncthreads();
    for (int i = tid; i < rows * F; i += nt) {
      const int rr = i / F, f = i - rr * F, nn = n0 + rr;
      const float* p = smem + (size_t)rr * SL * F * KM + f * KM;
      float a[KM];
#pragma unroll
      for (int k = 0; k < KM; ++k) a[k] = p[k];
      for (int sl = 1; sl < SL; ++sl)
#pragma unroll
        for (int k = 0; k < KM; ++k) a[k] += p[(size_t)sl * F * KM + k];
      const int Kf = s_kf[f];
      const float c = s_sc[f];
      float4* o = reinterpret_cast<float4*>(out + (((size_t)b * N + nn) * F + f) * LANES);
      o[0] = make_float4(c * a[0], Kf > 1 ? c * a[1] : 0.f, Kf > 2 ? c * a[2] : 0.f,
                         Kf > 3 ? c * a[3] : 0.f);
      if (LANES == 8) o[1] = make_float4(Kf > 4 ? c * a[4] : 0.f, 0.f, 0.f, 0.f);
    }
  }
}

bool bad_conv_shape(int B, int N, int M, int D, int S, int F, int keep, int chunk, int splits,
                    int summed, const float* part) {
  return B < 1 || B > 65535 || N < 1 || M < 1 || D < 1 || S < 1 || F < 1 || keep < 1 ||
         keep * F > THREADS || chunk < 1 || splits < 1 || (long long)chunk * (splits - 1) >= summed ||
         (long long)chunk * splits < summed || (splits > 1 && part == nullptr);
}

int round_up_32(int v) { return ((v + 31) / 32) * 32; }

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
  const int threads = round_up_32(keep * F);
  float* dst = splits > 1 ? part : out;
  tp_scalar_fwd_kernel<T><<<grid, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(sh), static_cast<const T*>(w),
      reinterpret_cast<const int4*>(chan), scale, dst, B, N, M, D, S, F, keep, chunk);
  return sum_splits<float>(part, out, (long long)B * N * F * 4, splits, st);
}

template <typename T, int L>
int launch_bwd_x(const void* sh, const void* w, const float* g, const int* chan,
                 const float* scale, const int* d_ptr, const int* d_item, void* dx, float* part,
                 int B, int N, int M, int D, int S, int F, int n_items, int keep, int chunk,
                 int splits, cudaStream_t st) {
  const dim3 grid(splits, (M + keep - 1) / keep, B);
  const int threads = round_up_32(keep * F);
  const size_t bytes = bwd_x_smem(keep, F, D, n_items);
  T* out = static_cast<T*>(dx);
  tp_scalar_bwd_x_kernel<T, L><<<grid, threads, bytes, st>>>(
      static_cast<const T*>(sh), static_cast<const T*>(w), g, reinterpret_cast<const int4*>(chan),
      scale, d_ptr, d_item, out, splits > 1 ? part : nullptr, B, N, M, D, S, F, n_items, keep,
      chunk);
  return sum_splits<T>(part, out, (long long)B * M * D, splits, st);
}

size_t x2_bytes(int F, int D, int n_items, int run) {
  return sizeof(float) * (size_t)x2_floats(F, D, n_items, run);
}

int x2_threads(int F, int run) { return round_up_32(((run + X2_Q - 1) / X2_Q) * F); }

bool bad_x2(int F, int run) {
  return F < 1 || run < 1 || ((run + X2_Q - 1) / X2_Q) * F > X2_THREADS;
}

template <typename T>
int launch_bwd_x_l2(const void* sh, const void* w, const float* g, const int* chan,
                    const float* scale, const int* d_ptr, const int* d_item, void* dx, float* part,
                    int B, int N, int M, int D, int S, int F, int n_items, int run, int chunk,
                    int splits, cudaStream_t st) {
  const size_t bytes = x2_bytes(F, D, n_items, run);
  if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  T* out = static_cast<T*>(dx);
  tp_scalar_bwd_x_l2_kernel<T><<<dim3(splits, (M + run - 1) / run, B), x2_threads(F, run), bytes,
                                 st>>>(
      static_cast<const T*>(sh), static_cast<const T*>(w), g, reinterpret_cast<const int4*>(chan),
      scale, d_ptr, d_item, out, splits > 1 ? part : nullptr, B, N, M, D, S, F, n_items, run,
      chunk);
  return sum_splits<T>(part, out, (long long)B * M * D, splits, st);
}

template <typename T>
int x2_blocks_per_sm(int F, int D, int n_items, int run) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tp_scalar_bwd_x_l2_kernel<T>, x2_threads(F, run), x2_bytes(F, D, n_items, run));
  return err == cudaSuccess ? blocks : -(int)err;
}

template <typename T, int L>
int launch_bwd_x_idx(const void* sh, const void* w, const float* g, const int* chan,
                     const float* scale, const int* d_ptr, const int* d_item, const int* order,
                     const int* cuts, const int* row_ptr, void* dx, float* y, float* part,
                     int receivers, int M, int D, int S, int F, int rows, int keep, int blocks,
                     cudaStream_t st) {
  const int threads = round_up_32(keep * F);
  tp_scalar_bwd_x_idx_slots<T, L><<<(receivers + keep - 1) / keep, threads, 0, st>>>(
      static_cast<const T*>(sh), static_cast<const T*>(w), g, reinterpret_cast<const int4*>(chan),
      y, receivers, M, S, F, keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tp_scalar_bwd_x_idx_chunks<<<blocks, threads, 0, st>>>(y, order, cuts, row_ptr, part, F, keep,
                                                         rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)rows * D;
  tp_scalar_bwd_x_idx_sum<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, row_ptr, scale, d_ptr, d_item, static_cast<T*>(dx), rows, D, F);
  return (int)cudaGetLastError();
}

bool quad_aligned(const void* p, int esize) {
  return reinterpret_cast<unsigned long long>(p) % (4 * esize) == 0;
}

template <typename T, bool DSH>
int launch_bwd_edge_t(const void* x, const void* sh, const void* w, const float* g,
                      const int* chan, const float* scale, void* dw, void* dsh, int N, int M,
                      int D, int S, int F, int edges, bool vec, int xvec, int blocks,
                      cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* sht = static_cast<const T*>(sh);
  const T* wt = static_cast<const T*>(w);
  const int4* ct = reinterpret_cast<const int4*>(chan);
  T* dwt = static_cast<T*>(dw);
  T* dsht = static_cast<T*>(dsh);
  if (vec)
    tp_scalar_bwd_edge_kernel<T, DSH, true><<<blocks, EDGE_THREADS, 0, st>>>(
        xt, sht, wt, g, ct, scale, dwt, dsht, N, M, D, S, F, edges, xvec);
  else
    tp_scalar_bwd_edge_kernel<T, DSH, false><<<blocks, EDGE_THREADS, 0, st>>>(
        xt, sht, wt, g, ct, scale, dwt, dsht, N, M, D, S, F, edges, xvec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_edge(const void* x, const void* sh, const void* w, const float* g,
                    const int* chan, const float* scale, void* dw, void* dsh, int B, int N,
                    int M, int D, int S, int F, int x_quads, int blocks, cudaStream_t st) {
  const int edges = B * N * M;
  const int esize = sizeof(T);
  const bool vec = F % 4 == 0 && (dw == nullptr || quad_aligned(dw, esize)) &&
                   (dsh == nullptr || quad_aligned(w, esize));
  const int xvec = x_quads && D % 4 == 0 && quad_aligned(x, esize);
  blocks = std::min(blocks, (edges + EDGE_WARPS - 1) / EDGE_WARPS);
  return dsh != nullptr
             ? launch_bwd_edge_t<T, true>(x, sh, w, g, chan, scale, dw, dsh, N, M, D, S, F, edges,
                                          vec, xvec, blocks, st)
             : launch_bwd_edge_t<T, false>(x, sh, w, g, chan, scale, dw, dsh, N, M, D, S, F,
                                           edges, vec, xvec, blocks, st);
}

template <typename T, bool DSH>
cudaError_t edge_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, tp_scalar_bwd_edge_kernel<T, DSH, true>, EDGE_THREADS, 0);
}

// ---- the dense 8-lane forward and edge backward: launches ----

size_t f2_bytes(int R, int SL, int F, int MC, int S, int D) {
  return sizeof(float) * (size_t)f2_floats(R, SL, F, MC, S, D);
}

int f2_threads(int R, int SL, int G) { return round_up_32(R * SL * G); }

bool bad_f2(int F, int G, int R, int SL, int MC, int S, int D) {
  return F < 1 || G < 1 || G > F || R < 1 || SL < 1 || (long long)R * SL * G > F2_THREADS ||
         MC < SL || MC % SL != 0 || S < 1 || D < 1 || f2_bytes(R, SL, F, MC, S, D) > 48 * 1024;
}

// VEC: every unit four channels at a multiple of four reading four x
// elements at a multiple of four (`vec_units`, the host's check), rows of
// F and D elements, and these bases aligned to four elements.
bool unit_vec(int vec_units, int F, int D, int esize, const void* a, const void* b,
              const void* c) {
  return vec_units && F % 4 == 0 && D % 4 == 0 && quad_aligned(a, esize) &&
         (b == nullptr || quad_aligned(b, esize)) && (c == nullptr || quad_aligned(c, esize));
}

template <typename T>
int launch_fwd_l2(const void* x, const void* sh, const void* w, const int* units,
                  const int* chan, const float* scale, float* out, int B, int N, int M, int D,
                  int S, int F, int G, int R, int SL, int MC, int vec_units, cudaStream_t st) {
  const dim3 grid((N + R - 1) / R, B);
  const int threads = f2_threads(R, SL, G);
  const size_t bytes = f2_bytes(R, SL, F, MC, S, D);
  const T* xt = static_cast<const T*>(x);
  const T* sht = static_cast<const T*>(sh);
  const T* wt = static_cast<const T*>(w);
  const int4* ut = reinterpret_cast<const int4*>(units);
  const int4* ct = reinterpret_cast<const int4*>(chan);
  if (unit_vec(vec_units, F, D, sizeof(T), x, w, nullptr))
    tp_scalar_fwd_l2_kernel<T, true><<<grid, threads, bytes, st>>>(
        xt, sht, wt, ut, ct, scale, out, N, M, D, S, F, G, R, SL, MC);
  else
    tp_scalar_fwd_l2_kernel<T, false><<<grid, threads, bytes, st>>>(
        xt, sht, wt, ut, ct, scale, out, N, M, D, S, F, G, R, SL, MC);
  return (int)cudaGetLastError();
}

template <typename T>
int f2_blocks_per_sm(int R, int SL, int G, int F, int MC, int S, int D, int vec) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, vec ? tp_scalar_fwd_l2_kernel<T, true> : tp_scalar_fwd_l2_kernel<T, false>,
      f2_threads(R, SL, G), f2_bytes(R, SL, F, MC, S, D));
  return err == cudaSuccess ? blocks : -(int)err;
}

size_t e2_bytes(bool dsh, int S, int n_items) {
  return dsh ? sizeof(int) * ((size_t)S + 1 + n_items) : 0;
}

template <typename T, bool DSH>
int launch_bwd_edge_l2_t(const void* x, const void* sh, const void* w, const float* g,
                         const int* units, const float* uscale, const int* comp_ptr,
                         const int* comp_item, void* dw, void* dsh, int N, int M, int D, int S,
                         int F, int G, int n_items, int edges, bool vec, int blocks,
                         cudaStream_t st) {
  const size_t bytes = e2_bytes(DSH, S, n_items);
  const T* xt = static_cast<const T*>(x);
  const T* sht = static_cast<const T*>(sh);
  const T* wt = static_cast<const T*>(w);
  const int4* ut = reinterpret_cast<const int4*>(units);
  T* dwt = static_cast<T*>(dw);
  T* dsht = static_cast<T*>(dsh);
#define E2_LAUNCH(V, UG)                                                                       \
  tp_scalar_bwd_edge_l2_kernel<T, DSH, V, UG><<<blocks, E2_THREADS, bytes, st>>>(              \
      xt, sht, wt, g, ut, uscale, comp_ptr, comp_item, dwt, dsht, N, M, D, S, F, G, n_items, edges)
  if (G <= 32) {
    if (vec) E2_LAUNCH(true, 1);
    else E2_LAUNCH(false, 1);
  } else {
    if (vec) E2_LAUNCH(true, 2);
    else E2_LAUNCH(false, 2);
  }
#undef E2_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_edge_l2(const void* x, const void* sh, const void* w, const float* g,
                       const int* units, const float* uscale, const int* comp_ptr,
                       const int* comp_item, void* dw, void* dsh, int B, int N, int M, int D,
                       int S, int F, int G, int n_items, int vec_units, int blocks,
                       cudaStream_t st) {
  const int edges = B * N * M;
  const bool vec = unit_vec(vec_units, F, D, sizeof(T), x, dw, dsh == nullptr ? nullptr : w);
  blocks = std::min(blocks, (edges + E2_WARPS - 1) / E2_WARPS);
  return dsh != nullptr
             ? launch_bwd_edge_l2_t<T, true>(x, sh, w, g, units, uscale, comp_ptr, comp_item, dw,
                                             dsh, N, M, D, S, F, G, n_items, edges, vec, blocks,
                                             st)
             : launch_bwd_edge_l2_t<T, false>(x, sh, w, g, units, uscale, comp_ptr, comp_item,
                                              dw, dsh, N, M, D, S, F, G, n_items, edges, vec,
                                              blocks, st);
}

template <typename T, bool DSH>
int e2_blocks_per_sm_t(int vec, int S, int n_items, int G) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks,
      G <= 32 ? (vec ? tp_scalar_bwd_edge_l2_kernel<T, DSH, true, 1>
                     : tp_scalar_bwd_edge_l2_kernel<T, DSH, false, 1>)
              : (vec ? tp_scalar_bwd_edge_l2_kernel<T, DSH, true, 2>
                     : tp_scalar_bwd_edge_l2_kernel<T, DSH, false, 2>),
      E2_THREADS, e2_bytes(DSH, S, n_items));
  return err == cudaSuccess ? blocks : -(int)err;
}

// ---- the sender-index forward and dw: launches ----

size_t idx_bytes(bool dw, int R, int SL, int F, int MC, int S) {
  return sizeof(float) * (size_t)idx_floats(dw, R, SL, F, MC, S);
}

bool bad_idx(int lanes, int F, int G, int R, int SL, int MC, int S, int D, bool dw) {
  return (lanes != 4 && lanes != 8) || F < 1 || G < 1 || G > F || R < 1 || SL < 1 ||
         (long long)R * SL * G > F2_THREADS || MC < SL || MC % SL != 0 || S < 1 || D < 1 ||
         idx_bytes(dw, R, SL, F, MC, S) > 48 * 1024;
}

template <typename T, int LANES, bool DW>
int launch_idx(const void* x, const void* sh, const void* w, const int* idx, const float* g,
               const int* units, const float* uscale, const int* chan, const float* scale,
               float* out, void* dw, int B, int N, int K, int Mx, int D, int S, int F, int G,
               int R, int SL, int MC, int vec_units, cudaStream_t st) {
  const dim3 grid((N + R - 1) / R, B);
  const int threads = f2_threads(R, SL, G);
  const size_t bytes = idx_bytes(DW, R, SL, F, MC, S);
  const T* xt = static_cast<const T*>(x);
  const T* sht = static_cast<const T*>(sh);
  const T* wt = static_cast<const T*>(w);
  const int4* ut = reinterpret_cast<const int4*>(units);
  const int4* ct = reinterpret_cast<const int4*>(chan);
  T* dwt = static_cast<T*>(dw);
  // f32 harmonics of a receiver (K S elements from a multiple of K S) in
  // 16-byte pieces where every chunk's run allows
  const int shq = sizeof(T) == 4 && (K * S) % 4 == 0 && (MC * S) % 4 == 0 &&
                  quad_aligned(sh, sizeof(T));
  if (unit_vec(vec_units, F, D, sizeof(T), DW ? dw : w, x, nullptr))
    tp_scalar_idx_kernel<T, LANES, true, DW><<<grid, threads, bytes, st>>>(
        xt, sht, wt, idx, g, ut, uscale, ct, scale, out, dwt, N, K, Mx, D, S, F, G, R, SL, MC,
        shq);
  else
    tp_scalar_idx_kernel<T, LANES, false, DW><<<grid, threads, bytes, st>>>(
        xt, sht, wt, idx, g, ut, uscale, ct, scale, out, dwt, N, K, Mx, D, S, F, G, R, SL, MC,
        shq);
  return (int)cudaGetLastError();
}

// The extern "C" entry points of lane count L (below), shared by both.

template <int L>
int bwd_x_entry(const void* sh, const void* w, const float* g, const int* chan,
                const float* scale, const int* d_ptr, const int* d_item, void* dx, float* part,
                int B, int N, int M, int D, int S, int F, int n_items, int keep, int chunk,
                int splits, int bf16, void* stream) {
  if (bad_conv_shape(B, N, M, D, S, F, keep, chunk, splits, N, part) || n_items < 1 ||
      (M + keep - 1) / keep > 65535 || bwd_x_smem(keep, F, D, n_items) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_x<__nv_bfloat16, L>(sh, w, g, chan, scale, d_ptr, d_item, dx, part, B,
                                               N, M, D, S, F, n_items, keep, chunk, splits, st)
              : launch_bwd_x<float, L>(sh, w, g, chan, scale, d_ptr, d_item, dx, part, B, N, M,
                                       D, S, F, n_items, keep, chunk, splits, st);
}

template <int L>
int bwd_x_idx_entry(const void* sh, const void* w, const float* g, const int* chan,
                    const float* scale, const int* d_ptr, const int* d_item, const int* order,
                    const int* cuts, const int* row_ptr, void* dx, float* y, float* part, int B,
                    int N, int M, int Mx, int D, int S, int F, int keep, int blocks, int bf16,
                    void* stream) {
  if (B < 1 || N < 1 || M < 1 || Mx < 1 || D < 1 || S < 1 || F < 1 || keep < 1 ||
      keep * F > THREADS || blocks < 1 || order == nullptr || cuts == nullptr ||
      row_ptr == nullptr || y == nullptr || part == nullptr ||
      (long long)B * N * M * std::max(F, S) >= INT_MAX || (long long)B * Mx * D >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_x_idx<__nv_bfloat16, L>(sh, w, g, chan, scale, d_ptr, d_item, order,
                                                   cuts, row_ptr, dx, y, part, B * N, M, D, S, F,
                                                   B * Mx, keep, blocks, st)
              : launch_bwd_x_idx<float, L>(sh, w, g, chan, scale, d_ptr, d_item, order, cuts,
                                           row_ptr, dx, y, part, B * N, M, D, S, F, B * Mx,
                                           keep, blocks, st);
}

// dx: 0 the dense 4-lane forward, 1 the dense dx, 2 the sender-index dx (chunks).
template <int L>
int blocks_entry(int dx, int F, int D, int n_items, int bf16) {
  if (F < 1 || F > THREADS) return -(int)cudaErrorInvalidValue;
  const int keep = THREADS / F;
  const int threads = round_up_32(keep * F);
  int blocks = 0;
  cudaError_t err;
  if (dx == 2) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tp_scalar_bwd_x_idx_chunks,
                                                        threads, 0);
  } else if constexpr (L != 1) {   // L = 2: forward and dx are kernels of their own
    return -(int)cudaErrorInvalidValue;
  } else if (dx) {
    const size_t bytes = bwd_x_smem(keep, F, D, n_items);
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_scalar_bwd_x_kernel<__nv_bfloat16, 1>, threads, bytes)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_scalar_bwd_x_kernel<float, 1>, threads, bytes);
  } else {
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_scalar_fwd_kernel<__nv_bfloat16>, threads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_scalar_fwd_kernel<float>, threads, 0);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

extern "C" {

// Each function returns a cudaError_t value: 0 when the launches were
// accepted.  `bf16` selects the operands' type (x, sh, w and the gradients
// written in it): 0 f32, 1 bf16.

// Every path of a dense 4-lane convolution: out (B, N, F, 4) f32; `part`
// holds (splits, B, N, F, 4) floats when the senders are split (splits > 1),
// else it is not read.  Senders [k * chunk, (k + 1) * chunk) go to split k.
int dp_tp_scalar_fwd(const void* x, const void* sh, const void* w, const int* chan,
                     const float* scale, float* out, float* part, int B, int N, int M, int D,
                     int S, int F, int keep, int chunk, int splits, int bf16, void* stream) {
  if (bad_conv_shape(B, N, M, D, S, F, keep, chunk, splits, M, part) ||
      (N + keep - 1) / keep > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, sh, w, chan, scale, out, part, B, N, M, D, S, F, keep,
                                          chunk, splits, st)
              : launch_fwd<float>(x, sh, w, chan, scale, out, part, B, N, M, D, S, F, keep, chunk,
                                  splits, st);
}

// dx (B, M, D) of every path of a convolution, in the operands' type; `part`
// holds (splits, B, M, D) floats when the receivers are split.
int dp_tp_scalar_bwd_x(const void* sh, const void* w, const float* g, const int* chan,
                       const float* scale, const int* d_ptr, const int* d_item, void* dx,
                       float* part, int B, int N, int M, int D, int S, int F, int n_items,
                       int keep, int chunk, int splits, int bf16, void* stream) {
  return bwd_x_entry<1>(sh, w, g, chan, scale, d_ptr, d_item, dx, part, B, N, M, D, S, F, n_items,
                        keep, chunk, splits, bf16, stream);
}

// The sender-index dx (B, Mx, D), in the operands' type: `order`
// (tp_fused.sender_lists), `cuts` and `row_ptr` (tp_scalar.slot_chunks); `y`
// (B * N * M, F) and `part` (chunks, F) floats of scratch, part for at least
// the row_ptr[B * Mx] chunks; `blocks` blocks of `keep` chunks.
int dp_tp_scalar_bwd_x_idx(const void* sh, const void* w, const float* g, const int* chan,
                           const float* scale, const int* d_ptr, const int* d_item,
                           const int* order, const int* cuts, const int* row_ptr, void* dx,
                           float* y, float* part, int B, int N, int M, int Mx, int D, int S, int F,
                           int keep, int blocks, int bf16, void* stream) {
  return bwd_x_idx_entry<1>(sh, w, g, chan, scale, d_ptr, d_item, order, cuts, row_ptr, dx, y,
                            part, B, N, M, Mx, D, S, F, keep, blocks, bf16, stream);
}

// dw (B, N, M, F) into `dw` (nullptr: none) and dsh (B, N, M, S) into `dsh`
// (nullptr: none) of every path of a dense 4-lane convolution, in the
// operands' type, in one launch of at most `blocks` blocks.  `reach`: one
// past the last harmonic component any channel reads, at most P; dsh's later
// components are written as 0.  `x_quads`: channels 4i..4i+3 read elements
// d..d+3 of x, d a multiple of four, for every i (then x is read four
// elements at a time where its base allows).
int dp_tp_scalar_bwd_edge(const void* x, const void* sh, const void* w, const float* g,
                          const int* chan, const float* scale, void* dw, void* dsh, int B, int N,
                          int M, int D, int S, int F, int reach, int x_quads, int blocks, int bf16,
                          void* stream) {
  if (B < 1 || N < 1 || M < 1 || D < 1 || S < 1 || F < 1 || F > EDGE_F_MAX || reach < 1 ||
      reach > P || reach > S || blocks < 1 || (dw == nullptr && dsh == nullptr) ||
      (long long)B * N * M * std::max(F, S) + (long long)B * M * D >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_edge<__nv_bfloat16>(x, sh, w, g, chan, scale, dw, dsh, B, N, M, D, S, F,
                                               x_quads, blocks, st)
              : launch_bwd_edge<float>(x, sh, w, g, chan, scale, dw, dsh, B, N, M, D, S, F,
                                       x_quads, blocks, st);
}

// Blocks of the edge backward that one SM holds at once (dsh: with dsh), or
// minus a cudaError_t value.
int dp_tp_scalar_bwd_edge_blocks_per_sm(int dsh, int bf16) {
  int blocks = 0;
  const cudaError_t err = bf16 ? (dsh ? edge_occupancy<__nv_bfloat16, true>(&blocks)
                                      : edge_occupancy<__nv_bfloat16, false>(&blocks))
                               : (dsh ? edge_occupancy<float, true>(&blocks)
                                      : edge_occupancy<float, false>(&blocks));
  return err == cudaSuccess ? blocks : -(int)err;
}

// Blocks of the forward (dx = 0), dense dx (1) or sender-index dx (2, its
// chunk kernel) that one SM holds at once for a convolution of F
// channels (keep = THREADS / F entries a block), D input elements and n_items
// (channel, element) pairs, or minus a cudaError_t value.
int dp_tp_scalar_blocks_per_sm(int dx, int F, int D, int n_items, int bf16) {
  return blocks_entry<1>(dx, F, D, n_items, bf16);
}

// The 8-lane dx: a block per (receiver split, run of `run` senders, batch
// row) of ceil(run / 4) F threads, at most X2_THREADS; receivers [k *
// chunk, (k + 1) * chunk) go to split k.
int dp_tp_scalar_bwd_x_l2(const void* sh, const void* w, const float* g, const int* chan,
                          const float* scale, const int* d_ptr, const int* d_item, void* dx,
                          float* part, int B, int N, int M, int D, int S, int F, int n_items,
                          int run, int chunk, int splits, int bf16, void* stream) {
  if (bad_conv_shape(B, N, M, D, S, F, 1, chunk, splits, N, part) || n_items < 1 ||
      bad_x2(F, run) || (M + run - 1) / run > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_x_l2<__nv_bfloat16>(sh, w, g, chan, scale, d_ptr, d_item, dx, part, B,
                                               N, M, D, S, F, n_items, run, chunk, splits, st)
              : launch_bwd_x_l2<float>(sh, w, g, chan, scale, d_ptr, d_item, dx, part, B, N, M,
                                       D, S, F, n_items, run, chunk, splits, st);
}

// Bytes of shared memory a block of the 8-lane dx takes, and the blocks of
// it that one SM holds at once, or minus a cudaError_t value.
int dp_tp_scalar_bwd_x_l2_smem(int F, int D, int n_items, int run) {
  return (int)x2_bytes(F, D, n_items, run);
}

int dp_tp_scalar_bwd_x_l2_blocks_per_sm(int F, int D, int n_items, int run, int bf16) {
  if (bad_x2(F, run)) return -(int)cudaErrorInvalidValue;
  return bf16 ? x2_blocks_per_sm<__nv_bfloat16>(F, D, n_items, run)
              : x2_blocks_per_sm<float>(F, D, n_items, run);
}

int dp_tp_scalar_bwd_x_idx_l2(const void* sh, const void* w, const float* g, const int* chan,
                           const float* scale, const int* d_ptr, const int* d_item,
                           const int* order, const int* cuts, const int* row_ptr, void* dx,
                           float* y, float* part, int B, int N, int M, int Mx, int D, int S, int F,
                           int keep, int blocks, int bf16, void* stream) {
  return bwd_x_idx_entry<2>(sh, w, g, chan, scale, d_ptr, d_item, order, cuts, row_ptr, dx, y,
                            part, B, N, M, Mx, D, S, F, keep, blocks, bf16, stream);
}

int dp_tp_scalar_blocks_per_sm_l2(int dx, int F, int D, int n_items, int bf16) {
  return blocks_entry<2>(dx, F, D, n_items, bf16);
}

// The dense 8-lane forward (tp_scalar_fwd_l2_kernel): out (B, N, F, 8) f32
// of every path, one launch, a block per (R receivers, batch row) of
// round_up_32(R * SL * G) threads, each receiver's senders split over SL
// slices of G lanes and staged MC at a time (a multiple of SL).  `units` (G)
// int4 of (f0, d0, off, K + 8 cnt), tp_scalar.units_l2; `vec_units`: its
// four-channel check held.
int dp_tp_scalar_fwd_l2_dense(const void* x, const void* sh, const void* w, const int* units,
                              const int* chan, const float* scale, float* out, int B, int N,
                              int M, int D, int S, int F, int G, int R, int SL, int MC,
                              int vec_units, int bf16, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1 || bad_f2(F, G, R, SL, MC, S, D) ||
      (long long)B * N * M * std::max(F, S) + (long long)B * M * D >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd_l2<__nv_bfloat16>(x, sh, w, units, chan, scale, out, B, N, M, D, S, F,
                                             G, R, SL, MC, vec_units, st)
              : launch_fwd_l2<float>(x, sh, w, units, chan, scale, out, B, N, M, D, S, F, G, R,
                                     SL, MC, vec_units, st);
}

// Bytes of shared memory a block of the dense 8-lane forward takes, and the
// blocks of it that one SM holds at once, or minus a cudaError_t value.
int dp_tp_scalar_fwd_l2_dense_smem(int R, int SL, int F, int MC, int S, int D) {
  return (int)f2_bytes(R, SL, F, MC, S, D);
}

int dp_tp_scalar_fwd_l2_dense_blocks_per_sm(int R, int SL, int G, int F, int MC, int S, int D,
                                            int vec, int bf16) {
  if (bad_f2(F, G, R, SL, MC, S, D)) return -(int)cudaErrorInvalidValue;
  return bf16 ? f2_blocks_per_sm<__nv_bfloat16>(R, SL, G, F, MC, S, D, vec)
              : f2_blocks_per_sm<float>(R, SL, G, F, MC, S, D, vec);
}

// The dense 8-lane edge backward (tp_scalar_bwd_edge_l2_kernel): dw into `dw`
// (nullptr: none) and dsh (B, N, M, S) into `dsh` (nullptr: none), in the
// operands' type, in one launch of at most `blocks` blocks of E2_THREADS;
// lane = unit (G <= 32; up to 64, two a lane), `uscale` (G) its c_p; dsh component s sums the
// units comp_item[comp_ptr[s] .. comp_ptr[s + 1]) (j * 5 + k each).
int dp_tp_scalar_bwd_edge_l2_dense(const void* x, const void* sh, const void* w, const float* g,
                                   const int* units, const float* uscale, const int* comp_ptr,
                                   const int* comp_item, void* dw, void* dsh, int B, int N, int M,
                                   int D, int S, int F, int G, int n_items, int vec_units,
                                   int blocks, int bf16, void* stream) {
  if (B < 1 || N < 1 || M < 1 || D < 1 || S < 1 || F < 1 || G < 1 || G > E2_UNITS || G > F ||
      n_items < 0 || blocks < 1 || (dw == nullptr && dsh == nullptr) ||
      (dsh != nullptr && (comp_ptr == nullptr || comp_item == nullptr)) ||
      (long long)B * N * M * std::max(F, S) + (long long)B * M * D >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_edge_l2<__nv_bfloat16>(x, sh, w, g, units, uscale, comp_ptr, comp_item,
                                                  dw, dsh, B, N, M, D, S, F, G, n_items,
                                                  vec_units, blocks, st)
              : launch_bwd_edge_l2<float>(x, sh, w, g, units, uscale, comp_ptr, comp_item, dw,
                                          dsh, B, N, M, D, S, F, G, n_items, vec_units, blocks,
                                          st);
}

// Bytes of shared memory a block of the dense 8-lane edge backward takes:
// each unit's KM dsh sums (two units a lane where G > 32) and, dynamic, the
// component lists (with dsh).
int dp_tp_scalar_bwd_edge_l2_dense_smem(int dsh, int S, int n_items, int G) {
  return (int)(sizeof(float) * (dsh ? E2_THREADS * KM * (G > 32 ? 2 : 1) : 1) +
               e2_bytes(dsh, S, n_items));
}

// Blocks of the dense 8-lane edge backward of G units that one SM holds at
// once (dsh: with dsh, S components and n_items list entries), or minus a
// cudaError_t.
int dp_tp_scalar_bwd_edge_l2_dense_blocks_per_sm(int dsh, int vec, int S, int n_items, int G,
                                                 int bf16) {
  return bf16 ? (dsh ? e2_blocks_per_sm_t<__nv_bfloat16, true>(vec, S, n_items, G)
                     : e2_blocks_per_sm_t<__nv_bfloat16, false>(vec, S, n_items, G))
              : (dsh ? e2_blocks_per_sm_t<float, true>(vec, S, n_items, G)
                     : e2_blocks_per_sm_t<float, false>(vec, S, n_items, G));
}

// The sender-index forward (dw = 0: out (B, N, F, lanes) f32) or dw (dw =
// 1: dw (B, N, K, F) in the operands' type) of every path of a convolution,
// lanes 4 or 8 (tp_scalar_idx_kernel): a block per (R receivers, batch row)
// of round_up_32(R * SL * G) threads, each receiver's K slots split over SL
// slices of G lanes and staged MC at a time (a multiple of SL).  `units` (G)
// and `uscale` from tp_scalar.units_l2; chan and scale (the forward's) from
// its conv tables; `vec_units`: the units' four-channel check held.
int dp_tp_scalar_idx(const void* x, const void* sh, const void* w, const int* idx, const float* g,
                     const int* units, const float* uscale, const int* chan, const float* scale,
                     float* out, void* dw, int B, int N, int K, int Mx, int D, int S, int F,
                     int G, int R, int SL, int MC, int vec_units, int lanes, int want_dw, int bf16,
                     void* stream) {
  const bool d = want_dw != 0;
  if (B < 1 || B > 65535 || N < 1 || K < 1 || Mx < 1 || idx == nullptr ||
      bad_idx(lanes, F, G, R, SL, MC, S, D, d) || (d ? (dw == nullptr || g == nullptr)
                                                      : (w == nullptr || out == nullptr)) ||
      (long long)B * N * K * std::max(F, S) + (long long)B * Mx * D >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define IDX_LAUNCH(TT, LN, DWF)                                                               \
  launch_idx<TT, LN, DWF>(x, sh, w, idx, g, units, uscale, chan, scale, out, dw, B, N, K, Mx, D, \
                          S, F, G, R, SL, MC, vec_units, st)
  if (lanes == 4) {
    if (d) return bf16 ? IDX_LAUNCH(__nv_bfloat16, 4, true) : IDX_LAUNCH(float, 4, true);
    return bf16 ? IDX_LAUNCH(__nv_bfloat16, 4, false) : IDX_LAUNCH(float, 4, false);
  }
  if (d) return bf16 ? IDX_LAUNCH(__nv_bfloat16, 8, true) : IDX_LAUNCH(float, 8, true);
  return bf16 ? IDX_LAUNCH(__nv_bfloat16, 8, false) : IDX_LAUNCH(float, 8, false);
#undef IDX_LAUNCH
}

// Bytes of shared memory a block of the sender-index forward (dw 0) or dw
// (1) takes.
int dp_tp_scalar_idx_smem(int dw, int R, int SL, int F, int MC, int S) {
  return (int)idx_bytes(dw != 0, R, SL, F, MC, S);
}

const char* dp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
