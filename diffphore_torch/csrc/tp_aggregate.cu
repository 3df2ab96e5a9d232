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
// (106 MB for the widest phore convolution of a 24-complex batch, 446 MB over
// the 17 training convolutions) and each kernel reads or writes it exactly
// once; x, sh, g and the outputs are small beside it.  Counted as
// chip_smoke.py's k2_work counts them (each operand read once, each result
// written once, products on live edges), the forward and dx are bound by those
// bytes on every training convolution (0.156 ms each over the 17 of a step at
// 3.35 TB/s), with the arithmetic (about 50 f32 operations per live edge and
// channel) 3 to 10 times under it; so is the edge backward.  Only 11-48% of
// the edges are live: a dead edge's row of w is zero.
//
// Forward and dx: one design, the summed axis split across blocks.
//  * A block keeps KEEP = 8 entries of one axis (receivers for the forward,
//    senders for dx) of one batch row, and takes every `splits`-th entry of
//    the summed axis (senders, receivers): split k takes k, k + splits, ...,
//    because padded graphs keep their live atoms and phore points first and
//    contiguous ranges would load the splits unevenly.  The host picks the
//    splits so that the grid fills every block slot the card has at these
//    widths (an occupancy query; two blocks per SM at least), N = 1, N = 8 and
//    B = 1 included, while each split keeps a tile of work.  Split blocks
//    write partial sums to a scratch buffer that a second kernel adds in a
//    fixed order; one split writes the result.  No atomics: two runs
//    agree to the bit.
//  * A tile is 4 entries of the summed axis x the 8 kept ones: 32 edges.  Its
//    rows of w (F contiguous floats each, 16-byte cp.async), harmonics and the
//    per-entry operand (sender features, or the receiver's upstream gradient)
//    go into a two-stage ring in shared memory: one tile is in flight while
//    one computes, and every (n, m) pair is read by one block only.
//  * Per (edge, path), once for all the path's channels: t[i,k] = sum_j
//    G_p[i,j,k] sh[j] (warp = edge, lane = (path, i)).  The warp first ORs the
//    edge's row of w: a dead edge is marked so and costs no further
//    instruction (a warp's vote over the marks gives each thread the
//    tile's live edges as the bits of one word).  Then thread = (channel,
//    half of the kept entries) walks the live bits: the forward adds w *
//    sum_i x[m, x_base+i] t[i,:] to the receiver's three sums, dx adds w *
//    sum_k t[i,k] g[n,f,k] to the sender's; the entry's x or g sits in
//    registers for its 4 edges.
//  * dx then adds the channels that read one input element, in the order of
//    a host-built list (d_ptr / d_item, copied into shared memory at the
//    start), inside the block: the partial sums of a split are (B, M, D),
//    smaller than per-channel ones.
//  * The edge backward (dw, and dsh when asked for) sums over no edges and has
//    kernels of its own, below.
//  Where they stand (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, the
//  17 convs of a training step at batch 24, graph replay): forward 0.64 ms
//  and dx 0.76 ms, 4.1x and 4.9x the byte bound (the first design, one
//  block per (batch row, 8 receivers) and a serial walk over the summed
//  axis: 3.0 and 2.4 ms).  What holds them back is a tile's chain of
//  dependent steps (wait, barrier, the edge pass, barrier, the channel pass),
//  not the bytes: the ring alone, without the arithmetic, moved 1.1-2.0 TB/s.
//  Resident blocks are what helped (two stages beat three; splits that fill
//  every slot); bulk copies (TMA) of each row of w ran slower than cp.async.
//
// Operand types.  x, sh and w are f32 or bf16 (a template parameter T; a
// convolution that computes in bf16 hands them over so), read as they are and
// multiplied and summed in f32 with alpha * bf16(cg) tables; the forward's
// output and the upstream gradient g are f32; dw, dsh and dx are stored in T.
// The ring keeps w in T, so bf16 halves its bytes; a bf16 row of w is 2F
// bytes, which is not a multiple of 16 at F = 100 (final_conv): the row copies
// take the largest of 16, 8 or 4 bytes that divides the row and its base
// address (plain loads otherwise), and the ring's rows keep a 16-byte pitch.
// Harmonics and sender features are converted to f32 on the way into shared
// memory.  Split partial sums are f32; the second kernel rounds once.
//
// The 8-lane kernels (`*_l2`: a product whose irreps reach l = 2, the
// second-order features).  Every path has l_in, l_sh, l_out <= 2, so G_p is
// (5, 5, 5), out and g are (B, N, F, 8) (lanes 5-7 zero, never read) and a
// layer-3 convolution has F = 360 channels over 30 paths, D = 200: the
// 4-lane kernels' two-threads-a-channel blocks, per-path t tables and rings
// of w do not fit in a block.
//  * The forward and dx (tp_aggregate_{fwd,bwd_x}_l2_tiled_kernel) take the
//    4-lane design above by channel tile: the host cuts the channels at path
//    boundaries into tiles of at most 128 (tp_fused.channel_tiles, as the
//    8-lane K1 does: 120 + 120 + 120 at F = 360), and a block is one (batch
//    row, T2_KEEP = 8 kept entries, channel tile, split of the summed axis).
//    It loads only its tile's coupling entries, path rows and t blocks, its
//    rows of w restricted to the tile's channels, and, forward, the tile's x
//    slice [x_lo, x_lo + xw) of each sender; dx each receiver's g row of the
//    tile's channels, lanes 0-4.  A tile is 4 summed entries x the 8 kept
//    ones = 32 edges, one bit a lane.
//  * Dead edges cost nothing.  Reading every row of w to find the live ones
//    made each tile a round trip to device memory whatever its content (the
//    first version of these kernels, which tested each row in the ring, spent
//    ~1 ms of its 1.7-1.9 ms there over a training step's 17 convs).  So a
//    live pass (tp_aggregate_l2_live_kernel, a streaming read of w at 2.2
//    TB/s) first sets one bit per edge whose row is not all zero; the
//    autograd forward runs it once and dx reads the same bits.  A block turns
//    its edges' bits into per-tile masks and a list of live tiles, and loads
//    and walks only those tiles, of them only the live rows.
//  * A two-stage cp.async ring carries the live rows (w in the operands'
//    type, 16- or 8-byte pieces; bf16 harmonics as the 4-byte words that
//    cover a row and bf16 x in 8-byte pieces, so no plain load waits in the
//    phase that starts the next tile's loads).  Per tile, warp = (path, i)
//    item, lane = row forms t of the live rows (a warp runs one shape); then
//    thread = (walk slot, part of the kept entries) walks the live bits with
//    its channel's shape (d_in, d_out) fixed at compile time, the summed
//    entry's x or g loaded once for its kept entries.  A warp runs each shape
//    it holds in turn, so the host packs a tile's channels into warps by
//    shape (tp_aggregate.walk_l2: at most two shapes a warp on the probe).
//    Two barriers a live tile; three blocks of eight warps an SM.
//  * The splits fill every block slot of an occupancy query
//    (dp_tp_aggregate_l2_blocks_per_sm); the forward's splits are added by
//    tp_aggregate_sum_splits; dx adds each tile's channels that read one x
//    element in the order of a per-tile host list (tp_aggregate.dx_lists_l2)
//    and writes per-(split, tile) partial sums of its tile's slice, which
//    tp_aggregate_l2_dx_sum adds tile by tile, split by split (one split and
//    one tile write dx directly).  Fixed orders, no float atomics: reruns
//    agree to the bit.
//    Where they stand (chip_smoke.py phase 16 on an NVIDIA H100 80GB HBM3 at
//    700 W, the 17 convs of a second-order training step at batch 24, graph
//    replay, f32 / bf16): forward 1.57 / 1.55 ms, of it the live pass ~0.44
//    / ~0.25; dx 1.33 / 1.29 ms; 4.5x / 8.4x and 3.8x / 7.0x their byte
//    bounds (the first design, a block per kept entry and a thread per
//    channel: 3.1-3.2 / 3.0 and 2.6-2.8 / 2.5-2.8 ms).  bf16 runs no
//    slower than f32: with every tile a round trip, it was slower, moving
//    half the bytes in as many trips.
//  * The edge backward: it sums over no edge, so what bounds it is writing
//    dw (every edge, live or dead) and the arithmetic per (edge, channel).
//    A first kernel (tp_aggregate_l2_p_kernel) forms every receiver's
//    P[f][i][j] = sum_k G[i,j,k] g[n,f,k] once into a scratch row (the
//    first design formed it per 8 senders, 125 loads and products a thread
//    each time; formed per block of 32 senders, in the block, it still took
//    a fifth of the time).  tp_aggregate_bwd_edge_l2_kernel then takes a
//    block per (32 senders, run of receivers, batch row): it stages its
//    senders' x rows once for the run (cp.async), each receiver's P row and
//    harmonics (and, for dsh, rows of w) while the previous receiver's dw
//    leaves, and turns the roles: warp = the paths of a host plan
//    (tp_aggregate.edge_plan_l2: by falling cost to the least loaded warp),
//    lane = sender.  A path's shape (d_in, d_sh) is fixed at compile time
//    and the same for the whole warp, so an l = 0 path costs 2 products and
//    not a padded 5 x 5; P is a broadcast read, x and w lie at odd pitches
//    (no bank read twice), the harmonics sit in registers.  dw is left in
//    the place of w and leaves row by row, coalesced (four elements a store
//    where F allows).  With dsh, each lane adds its sender's w q[j] over
//    the path's channels in registers (no sum crosses threads) and the
//    block then adds the paths that reach each component in the host list's
//    order.  dsh reads only the rows of w that the forward's live bits
//    mark: a dead row is zero.
//  * The sender-index mode: an int32 index (B, N, K) names the sender row of
//    x (B, Mx, D) that slot k of receiver n reads; sh, w and dw are (B, N,
//    K, .).  The forward (tp_aggregate_fwd_idx_tiled_kernel, LANES = 4 for
//    l <= 1 or 8) is the dense tiled forward above with the slots as the
//    summed axis: a block per (batch row, 8 receivers, channel tile, split
//    of at most 64 slots), the live pass's bits (made once by the autograd
//    forward for it and dx), only live tiles and rows loaded.  Every slot
//    has its own sender, so each live row brings its own x slice into the
//    ring (x read at the index, which the block reads once with the bits),
//    and the walk reads x per row, not per summed entry.  The first design
//    (a block per receiver, a thread per channel) read each row of w twice,
//    once to test it live and once to walk it, staged each whole padded
//    coupling table and left 22-79% of its threads idle: 1.6-1.9x slower
//    without the live pass than this design with it (PERF.md).
//    The edge backward (dw only: the phore
//    harmonics carry no gradient, so dsh is refused) is
//    tp_aggregate_bwd_edge_idx_kernel: a block per receiver's slots (up to
//    32), a thread per channel with its P in registers, formed once for the
//    receiver's K slots (the first design formed it per 8 slots; the dense
//    design above ran the mode 1-29% slower: 24 slots fill three quarters of
//    its lanes).  dx (tp_aggregate_bwd_x_idx_l2_kernel) takes each sender's
//    slots (the host's stable sort of the flat index) in
//    chunks of at most 32 (tp_aggregate.idx_dx_lists), so that a sender
//    that most receivers read spreads over several blocks, a block a chunk
//    (blocks that each walked several chunks, their constants loaded once,
//    ran slower: fewer blocks hid less of each one's barriers).  A block
//    marks its chunk's live slots from the live pass's bits (made once in
//    the autograd forward) and loads only those, 4 at a time on a
//    two-stage cp.async ring: their rows of w and harmonics and their
//    receivers' g rows (the walk read g from device memory slot by slot,
//    most of its time in the first version); it forms t of each (slot,
//    path, i) with the path's shape fixed and walks them with thread =
//    channel; a second kernel adds each sender's chunks in order.  Fixed
//    orders, no atomics: reruns agree to the bit.
//  Where they stand: PERF.md (chip_smoke.py phases 16 and 17,
//  profile_kernels --k2_edge_l2 and --k2_index).
//
// Model widths past corpus2's (ns / nv up to 64 / 32: F up to 512 at 4 lanes,
// 1,152 at 8).  The split forward and dx run a thread pair a channel, so a
// 4-lane row wider than 256 channels takes the tiled forward and dx above at
// LANES = 4 (tp_aggregate.tiled: the live pass, channel tiles on the grid,
// dx's per-tile sums added by tp_aggregate_l2_dx_sum in a fixed order).  The
// 4-lane dw kernel loops its threads over a wide row's channels; the dsh
// kernel already walks every channel of its receiver's rows in one block (a
// warp a path), so its sums stay in one block and in order.  At 8 lanes the
// dense edge backward takes fewer senders a block (24, 16 or 8) where 32
// senders' x and w rows would not fit beside P (tp_aggregate.edge_slots_l2);
// the sender-index dw loops its threads over the channels, and the
// sender-index dx gives a thread up to three channels (XC) past 384.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 8;           // receivers per block (edge backward)
constexpr int SH_STRIDE = 12;   // padded harmonics row in shared memory
constexpr int J_MAX = 5;        // harmonic components of one path (l_sh <= 2)
constexpr int G_SIZE = 3 * J_MAX * 3;  // alpha*cg padded to (i < 3, j < 5, k < 3)
constexpr int MAX_THREADS = 256;
constexpr size_t MAX_SMEM = 227 * 1024;

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

// Four consecutive elements (16 bytes of f32, 8 of bf16, so aligned) as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

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
template <typename T>
__device__ __forceinline__ void stage_sh(float* s_sh, const T* __restrict__ sh, int b, int N,
                                         int M, int S, int n_base, int n_count, int m_base,
                                         int m_count, int tid, int nt) {
  for (int i = tid; i < n_count * m_count * SH_STRIDE; i += nt) {
    const int e = i / SH_STRIDE, j = i - e * SH_STRIDE;
    const int n = n_base + e / m_count, m = m_base + e % m_count;
    s_sh[i] = (n < N && m < M && j < S) ? to_f(sh[(((size_t)b * N + n) * M + m) * S + j]) : 0.f;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dw for every edge and channel, where dsh is not asked for.  It sums over no
// edges, so the grid tiles both receivers and senders: one block per (batch row,
// TN receivers, mt senders), its harmonics and sender features staged once, no
// barrier after that.  It does not read w.
constexpr int MT_MAX = 16;      // senders per block

template <typename T, bool LOOP>
__global__ void __launch_bounds__(MAX_THREADS, 3) tp_aggregate_bwd_edge_kernel(
    const T* __restrict__ x,         // (B, M, D)
    const T* __restrict__ sh,        // (B, N, M, S)
    const float* __restrict__ g,     // (B, N, F, 4) upstream gradient
    const int4* __restrict__ chan,   // (F): x_base, d_in, sh_off, path
    const int4* __restrict__ ptab,   // (n_paths): f_start, f_count, d_sh, d_out
    const float* __restrict__ gtab,  // (n_paths, 3, J_MAX, 3)
    T* __restrict__ dw,              // (B, N, M, F)
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
    s_x[i] = m < M ? to_f(x[((size_t)b * M + m) * D + (i % D)]) : 0.f;
  }
  __syncthreads();

  // thread = channel; a row wider than the block (LOOP) takes channels f,
  // f + nt, ...
  for (int f = tid; f < F; f += nt) {
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
        dw[(((size_t)b * N + n) * M + m) * F + f] = from_f<T>(dwv);
      }
    }
    if (!LOOP) break;
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

template <typename T>
__global__ void tp_aggregate_bwd_edge_kernel_dsh(
    const T* __restrict__ x,          // (B, M, D)
    const T* __restrict__ sh,         // (B, N, M, S)
    const T* __restrict__ w,          // (B, N, M, F)
    const float* __restrict__ g,      // (B, N, F, 4)
    const int4* __restrict__ chan,    // (F): x_base, d_in, sh_off, path
    const int4* __restrict__ ptab,    // (n_paths): f_start, f_count, d_sh, d_out
    const float* __restrict__ gtab,   // (n_paths, 3, J_MAX, 3)
    const int* __restrict__ seg_ptr,  // (S + 1): extents into seg per harmonic component
    const int2* __restrict__ seg,     // (path, j) of every path reaching the component
    T* __restrict__ dw,               // (B, N, M, F)
    T* __restrict__ dsh,              // (B, N, M, S)
    int N, int M, int D, int S, int F, int n_paths, int n_seg, int vec) {
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
  const T* wsrc = w + row0 * F;                 // count * F contiguous elements
  if (vec) {
    for (int i = tid; i < count * (F / 4); i += nt) {
      const int ml = i / (F / 4), f4 = 4 * (i - ml * (F / 4));
      const float4 v = load4(wsrc + 4 * i);
      float* d = s_w + ml * Fp + f4;
      d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
    }
  } else {
    for (int i = tid; i < count * F; i += nt) {
      const int ml = i / F;
      s_w[ml * Fp + (i - ml * F)] = to_f(wsrc[i]);
    }
  }
  const T* xsrc = x + ((size_t)b * M + m0) * D;
  for (int i = tid; i < count * D; i += nt) {
    const int ml = i / D;
    s_x[ml * Dp + (i - ml * D)] = to_f(xsrc[i]);
  }
  for (int i = tid; i < count * SHP; i += nt) {
    const int ml = i / SHP, j = i - ml * SHP;
    s_sh[i] = j < S ? to_f(sh[(row0 + ml) * S + j]) : 0.f;
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

  T* dwdst = dw + row0 * F;
  if (vec) {
    for (int i = tid; i < count * (F / 4); i += nt) {
      const int ml = i / (F / 4), f4 = 4 * (i - ml * (F / 4));
      const float* d = s_w + ml * Fp + f4;
      store4(dwdst + 4 * i, make_float4(d[0], d[1], d[2], d[3]));
    }
  } else {
    for (int i = tid; i < count * F; i += nt) {
      const int ml = i / F;
      dwdst[i] = from_f<T>(s_w[ml * Fp + (i - ml * F)]);
    }
  }
  for (int r = tid; r < count * S; r += nt) {
    const int ml = r / S, s = r - ml * S;
    float sum = 0.f;
    for (int k = s_segptr[s]; k < s_segptr[s + 1]; ++k)
      sum += s_part[(s_seg[k].x * SH_CHUNK + ml) * J_MAX + s_seg[k].y];
    dsh[row0 * S + r] = from_f<T>(sum);
  }
}

// ---- forward and dx: the summed axis split across blocks (head note) ----

constexpr int KEEP = 8;                 // receivers (forward) or senders (dx) a block keeps
constexpr int TILE_SUM = 4;             // entries of the summed axis per tile
constexpr int ROWS = KEEP * TILE_SUM;   // edges per tile, row r = (r / KEEP, r % KEEP)
constexpr int HALVES = 2;               // threads per channel, each keeps KEEP / HALVES entries
constexpr int QK = KEEP / HALVES;
constexpr int STAGES = 2;               // the ring: one tile in flight while one computes
constexpr int T_SIZE = 12;              // t[i][k] of one (edge, path), k padded to 4
constexpr int MAX_PATHS = 16;
constexpr int SPLIT_THREADS = HALVES * MAX_THREADS;

static_assert(ROWS == 32, "a warp's vote gives a tile's live edges, one bit a lane");

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// Elements of a row of w in the ring: F rounded up to 16 bytes.
__host__ __device__ inline int w_pitch(int F, int esize) {
  const int per = 16 / esize;
  return (F + per - 1) / per * per;
}

// The shared-memory layout in floats, the same on the host and the device.
// A stage holds a tile's rows of w (in the operands' type, esize bytes an
// element), its harmonics and its per-entry operand (x rows of the forward's
// senders, g rows of dx's receivers), both in f32.
struct SplitLayout {
  int w, sh, side, stage, t, g, poff, live, dlist, total;
};

__host__ __device__ inline SplitLayout split_layout(bool dx, int F, int D, int n_paths,
                                                    int n_items, int esize) {
  SplitLayout L;
  int o = 0;
  L.w = o;    o += ROWS * w_pitch(F, esize) * esize / 4;
  L.sh = o;   o += ROWS * SH_STRIDE;
  L.side = o; o += dx ? TILE_SUM * 4 * F : TILE_SUM * pad4(D);
  L.stage = pad4(o);
  o = STAGES * L.stage;
  L.t = o;    o += ROWS * n_paths * T_SIZE;
  L.g = o;    o += pad4(n_paths * G_SIZE);
  L.poff = o; o += MAX_PATHS;
  L.live = o; o += ROWS;
  L.dlist = o; o += dx ? pad4(D + 1) + pad4(n_items) : 0;   // dx: d_ptr, then d_item
  L.total = o;
  return L;
}

// Copies `count` elements of T from src to dst in pieces of `unit` bytes
// (16, 8 or 4 by cp.async, which both addresses allow; 0: plain loads), lane
// by lane.
template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* __restrict__ src, int count, int unit,
                                         int lane) {
  constexpr int P16 = 16 / sizeof(T), P8 = 8 / sizeof(T), P4 = 4 / sizeof(T);
  if (unit == 16) {
    for (int c = lane; c < count / P16; c += 32) cp_async16(dst + c * P16, src + c * P16);
  } else if (unit == 8) {
    for (int c = lane; c < count / P8; c += 32) cp_async8(dst + c * P8, src + c * P8);
  } else if (unit == 4) {
    for (int c = lane; c < count / P4; c += 32) cp_async4(dst + c * P4, src + c * P4);
  } else {
    for (int c = lane; c < count; c += 32) dst[c] = src[c];
  }
}

// One lane's share of the test whether a row of w (in shared memory) is all
// zero: -0 counts as zero, as it does in f32.
__device__ __forceinline__ bool any_nonzero(const float* wr, int F, int lane) {
  bool live = false;
  if (F % 4 == 0) {
    for (int c = lane; c < F / 4; c += 32) {
      const float4 v = *reinterpret_cast<const float4*>(wr + 4 * c);
      live |= (v.x != 0.f) | (v.y != 0.f) | (v.z != 0.f) | (v.w != 0.f);
    }
  } else {
    for (int c = lane; c < F; c += 32) live |= wr[c] != 0.f;
  }
  return live;
}
__device__ __forceinline__ bool any_nonzero(const __nv_bfloat16* wr, int F, int lane) {
  bool live = false;
  if (F % 4 == 0) {
    for (int c = lane; c < F / 4; c += 32) {
      const uint2 v = *reinterpret_cast<const uint2*>(wr + 4 * c);
      live |= ((v.x | v.y) & 0x7fff7fffu) != 0u;
    }
  } else {
    for (int c = lane; c < F; c += 32) live |= __bfloat162float(wr[c]) != 0.f;
  }
  return live;
}

template <bool DX, typename T>
__device__ __forceinline__ void split_body(
    const T* __restrict__ x, const T* __restrict__ sh, const T* __restrict__ w,
    const float* __restrict__ g, const int4* __restrict__ chan, const int4* __restrict__ ptab,
    const float* __restrict__ gtab, const int* __restrict__ d_ptr,
    const int* __restrict__ d_item, float* __restrict__ dst, T* __restrict__ dx_out, int B, int N,
    int M, int D, int S, int F, int n_paths, int n_items, int wunit, int gvec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ES = sizeof(T);
  constexpr bool F32 = ES == 4;
  const SplitLayout L = split_layout(DX, F, D, n_paths, n_items, ES);
  float* s_t = smem + L.t;
  float* s_g = smem + L.g;
  int* s_poff = reinterpret_cast<int*>(smem + L.poff);          // sh_off of each path
  int* s_live = reinterpret_cast<int*>(smem + L.live);           // a tile's rows: live or not
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int split = blockIdx.x, splits = gridDim.x, b = blockIdx.z;
  const int k0 = blockIdx.y * KEEP;
  const int n_keep = DX ? M : N, n_sum = DX ? N : M;
  const int count = split < n_sum ? (n_sum - split + splits - 1) / splits : 0;
  const int tiles = (count + TILE_SUM - 1) / TILE_SUM;
  const int FP = w_pitch(F, ES), DP = pad4(D);
  auto w_rows = [&](const float* st) { return reinterpret_cast<const T*>(st + L.w); };

  // The edge of row r of a tile, or -1 past the ragged ends.
  auto edge_of = [&](int tile, int r) -> long long {
    const int o = tile * TILE_SUM + r / KEEP, k = k0 + r % KEEP;
    if (o >= count || k >= n_keep) return -1;
    const int s = split + o * splits;
    return ((long long)b * N + (DX ? s : k)) * M + (DX ? k : s);
  };

  auto load_tile = [&](int tile) {
    if (tile < tiles) {
      float* st = smem + (tile % STAGES) * L.stage;
      for (int r = warp; r < ROWS; r += nwarps) {
        const long long e = edge_of(tile, r);
        if (e < 0) continue;
        copy_row(reinterpret_cast<T*>(st + L.w) + r * FP, w + e * F, F, wunit, lane);
        if (lane < S) {
          float* d = st + L.sh + r * SH_STRIDE + lane;
          if (F32) cp_async4(d, sh + e * S + lane);
          else *d = to_f(sh[e * S + lane]);
        }
      }
      for (int o = warp; o < TILE_SUM; o += nwarps) {
        const int oo = tile * TILE_SUM + o;
        if (oo >= count) continue;
        const int s = split + oo * splits;
        if (DX) {   // the receiver's upstream gradient, F float4
          const float* src = g + ((size_t)b * N + s) * F * 4;
          float* d = st + L.side + o * 4 * F;
          if (gvec) {
            for (int c = lane; c < F; c += 32) cp_async16(d + 4 * c, src + 4 * c);
          } else {
            for (int c = lane; c < 4 * F; c += 32) cp_async4(d + c, src + c);
          }
        } else {    // the sender's features
          const T* src = x + ((size_t)b * M + s) * D;
          float* d = st + L.side + o * DP;
          for (int c = lane; c < D; c += 32) {
            if (F32) cp_async4(d + c, src + c);
            else d[c] = to_f(src[c]);
          }
        }
      }
    }
    cp_async_commit();
  };

  // the first tiles' loads go out before anything else
  for (int i = tid; i < STAGES * ROWS * SH_STRIDE; i += nt) {   // pad lanes of the harmonics
    const int st = i / (ROWS * SH_STRIDE), j = i % SH_STRIDE;
    if (j >= S) smem[st * L.stage + L.sh + i % (ROWS * SH_STRIDE)] = 0.f;
  }
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) load_tile(s);
  for (int i = tid; i < n_paths * G_SIZE; i += nt) s_g[i] = gtab[i];
  if (tid < n_paths) s_poff[tid] = chan[ptab[tid].x].z;
  int* s_dptr = reinterpret_cast<int*>(smem + L.dlist);
  int* s_ditem = s_dptr + pad4(D + 1);
  if (DX) {
    for (int i = tid; i <= D; i += nt) s_dptr[i] = d_ptr[i];
    for (int i = tid; i < n_items; i += nt) s_ditem[i] = d_item[i];
  }

  // thread = (channel, half of the kept entries)
  const int c32 = 32 * ((F + 31) / 32);
  const int half = tid / c32, f = tid - half * c32;
  const bool active = f < F && half < HALVES;
  const int4 cm = active ? chan[f] : make_int4(0, 0, 0, 0);
  const int d_out = active ? ptab[cm.w].w : 0;
  const int tq = cm.w * T_SIZE;
  float acc[QK][3];
#pragma unroll
  for (int q = 0; q < QK; ++q) acc[q][0] = acc[q][1] = acc[q][2] = 0.f;

  // warp = edge: mark it live or not and form t for every (path, i) of the
  // live: lane = item p * 3 + i (zero rows of G where i >= d_in)
  const int items = 3 * n_paths;
  auto t_pass = [&](int tile) {
    const float* st = smem + (tile % STAGES) * L.stage;
    for (int r = warp; r < ROWS; r += nwarps) {
      bool live = false;
      if (edge_of(tile, r) >= 0) live = any_nonzero(w_rows(st) + r * FP, F, lane);
      live = __any_sync(0xffffffffu, live);
      if (lane == 0) s_live[r] = live;
      if (!live) continue;
      const float* sv = st + L.sh + r * SH_STRIDE;
      float* tr = s_t + r * n_paths * T_SIZE;
      for (int it = lane; it < items; it += 32) {
        const int p = it / 3;
        const float* G = s_g + it * J_MAX * 3;
        const float* svp = sv + s_poff[p];
        float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int j = 0; j < J_MAX; ++j) {
          const float v = svp[j];
          t0 = fmaf(G[j * 3], v, t0);
          t1 = fmaf(G[j * 3 + 1], v, t1);
          t2 = fmaf(G[j * 3 + 2], v, t2);
        }
        *reinterpret_cast<float4*>(tr + p * T_SIZE + 4 * (it - 3 * p)) = make_float4(t0, t1, t2, 0.f);
      }
    }
  };

  // `mask`: bit r set for each live row r of the tile
  auto channel_pass = [&](int tile, unsigned mask) {
    if (!active) return;
    const float* st = smem + (tile % STAGES) * L.stage;
    const T* wrows = w_rows(st);
#pragma unroll 1
    for (int o = 0; o < TILE_SUM; ++o) {
      const unsigned bits = (mask >> (o * KEEP + half * QK)) & ((1u << QK) - 1u);
      if (bits == 0u) continue;
      float a0, a1, a2;     // forward: x[m, x_base + i]; dx: g[n, f, k]
      if (DX) {
        const float4 gv = *reinterpret_cast<const float4*>(st + L.side + o * 4 * F + 4 * f);
        a0 = d_out > 0 ? gv.x : 0.f;
        a1 = d_out > 1 ? gv.y : 0.f;
        a2 = d_out > 2 ? gv.z : 0.f;
      } else {
        const float* xr = st + L.side + o * DP + cm.x;
        a0 = xr[0];
        a1 = cm.y == 3 ? xr[1] : 0.f;
        a2 = cm.y == 3 ? xr[2] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < QK; ++q) {
        if (!(bits >> q & 1u)) continue;
        const int r = o * KEEP + half * QK + q;
        const float wv = to_f(wrows[r * FP + f]);
        const float* tp = s_t + r * n_paths * T_SIZE + tq;
        const float4 t0 = *reinterpret_cast<const float4*>(tp);
        if (!DX) {
          const float v0 = wv * a0;
          acc[q][0] = fmaf(v0, t0.x, acc[q][0]);
          acc[q][1] = fmaf(v0, t0.y, acc[q][1]);
          acc[q][2] = fmaf(v0, t0.z, acc[q][2]);
          if (cm.y == 3) {
            const float4 t1 = *reinterpret_cast<const float4*>(tp + 4);
            const float4 t2 = *reinterpret_cast<const float4*>(tp + 8);
            const float v1 = wv * a1, v2 = wv * a2;
            acc[q][0] = fmaf(v2, t2.x, fmaf(v1, t1.x, acc[q][0]));
            acc[q][1] = fmaf(v2, t2.y, fmaf(v1, t1.y, acc[q][1]));
            acc[q][2] = fmaf(v2, t2.z, fmaf(v1, t1.z, acc[q][2]));
          }
        } else {
          acc[q][0] = fmaf(wv, fmaf(t0.z, a2, fmaf(t0.y, a1, t0.x * a0)), acc[q][0]);
          if (cm.y == 3) {
            const float4 t1 = *reinterpret_cast<const float4*>(tp + 4);
            const float4 t2 = *reinterpret_cast<const float4*>(tp + 8);
            acc[q][1] = fmaf(wv, fmaf(t1.z, a2, fmaf(t1.y, a1, t1.x * a0)), acc[q][1]);
            acc[q][2] = fmaf(wv, fmaf(t2.z, a2, fmaf(t2.y, a1, t2.x * a0)), acc[q][2]);
          }
        }
      }
    }
  };

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                 // the tile has landed; the stage it replaces is read
    load_tile(tile + STAGES - 1);
    t_pass(tile);
    __syncthreads();
    channel_pass(tile, __ballot_sync(0xffffffffu, s_live[lane] != 0));
  }
  cp_async_wait<0>();

  if (!DX) {
    if (active) {
      float4* o4 = reinterpret_cast<float4*>(dst) + (size_t)split * B * N * F;
#pragma unroll
      for (int q = 0; q < QK; ++q) {
        const int n = k0 + half * QK + q;
        if (n < N)
          o4[((size_t)b * N + n) * F + f] = make_float4(acc[q][0], acc[q][1], acc[q][2], 0.f);
      }
    }
    return;
  }
  // dx: the channels that read one input element, added in the list's order
  __syncthreads();                   // the ring is free
  const int Fo = F | 1;
  float* s_d = smem;                 // [kept][i][f]
  if (active) {
#pragma unroll
    for (int q = 0; q < QK; ++q)
#pragma unroll
      for (int i = 0; i < 3; ++i) s_d[((half * QK + q) * 3 + i) * Fo + f] = acc[q][i];
  }
  __syncthreads();
  for (int r = tid; r < KEEP * D; r += nt) {
    const int k = r / D, d = r - k * D;
    const int m = k0 + k;
    if (m >= M) continue;
    float sum = 0.f;
    for (int e = s_dptr[d]; e < s_dptr[d + 1]; ++e) {
      const int it = s_ditem[e];
      sum += s_d[(k * 3 + (it & 3)) * Fo + (it >> 2)];
    }
    const size_t at = ((size_t)b * M + m) * D + d;
    if (dst != nullptr) dst[(size_t)split * B * M * D + at] = sum;   // a split's partial sum
    else dx_out[at] = from_f<T>(sum);
  }
}

template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS, 2) tp_aggregate_fwd_kernel(
    const T* __restrict__ x,         // (B, M, D) sender features
    const T* __restrict__ sh,        // (B, N, M, S) edge harmonics
    const T* __restrict__ w,         // (B, N, M, F) pre-masked edge weights
    const int4* __restrict__ chan,   // (F): x_base, d_in, sh_off, path
    const int4* __restrict__ ptab,   // (n_paths): f_start, f_count, d_sh, d_out
    const float* __restrict__ gtab,  // (n_paths, 3, J_MAX, 3)
    float* __restrict__ dst,         // out (B, N, F, 4), or the partial sums (splits, B, N, F, 4)
    int B, int N, int M, int D, int S, int F, int n_paths, int wunit) {
  split_body<false, T>(x, sh, w, nullptr, chan, ptab, gtab, nullptr, nullptr, dst, nullptr, B, N,
                       M, D, S, F, n_paths, 0, wunit, 0);
}

template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS, 2) tp_aggregate_bwd_x_kernel(
    const T* __restrict__ sh,        // (B, N, M, S)
    const T* __restrict__ w,         // (B, N, M, F)
    const float* __restrict__ g,     // (B, N, F, 4) upstream gradient
    const int4* __restrict__ chan,   // (F): x_base, d_in, sh_off, path
    const int4* __restrict__ ptab,   // (n_paths): f_start, f_count, d_sh, d_out
    const float* __restrict__ gtab,  // (n_paths, 3, J_MAX, 3)
    const int* __restrict__ d_ptr,   // (D + 1): extents into d_item per input element
    const int* __restrict__ d_item,  // f * 4 + i of every (channel, component) reading it
    float* __restrict__ part,        // the partial sums (splits, B, M, D), or null for one split
    T* __restrict__ dx,              // (B, M, D) when one split
    int B, int N, int M, int D, int S, int F, int n_paths, int n_items, int wunit, int gvec) {
  split_body<true, T>(nullptr, sh, w, g, chan, ptab, gtab, d_ptr, d_item, part, dx, B, N, M, D, S,
                      F, n_paths, n_items, wunit, gvec);
}

// out[i] = sum over the splits of part[k][i], in order.
template <typename T>
__global__ void tp_aggregate_sum_splits(const float* __restrict__ part, T* __restrict__ out,
                                        long long total, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[k * total + i];
  out[i] = from_f<T>(s);
}

// Threads of a dw-only block: a thread per channel, 128 to MAX_THREADS
// (wider rows loop over their channels).
int threads_for(int F) {
  const int t = ((F + 31) / 32) * 32;
  return t < 128 ? 128 : t > MAX_THREADS ? MAX_THREADS : t;
}

bool bad_shape(int B, int N, int M, int D, int S, int F, int n_paths) {
  return B < 1 || N < 1 || M < 1 || D < 1 || S < 1 || S > SH_STRIDE || F < 1 || n_paths < 1 ||
         B > 65535;
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Allows the forward (dx false) or dx kernel of operand type T all the shared
// memory an SM has, once per kernel.
template <typename T>
cudaError_t allow_split(bool dx) {
  static bool allowed[2] = {false, false};
  if (allowed[dx]) return cudaSuccess;
  const cudaError_t err = dx ? allow_shared(tp_aggregate_bwd_x_kernel<T>, MAX_SMEM)
                             : allow_shared(tp_aggregate_fwd_kernel<T>, MAX_SMEM);
  if (err == cudaSuccess) allowed[dx] = true;
  return err;
}

int split_threads(int F) { return HALVES * 32 * ((F + 31) / 32); }

// Checks what the forward (DX false) or dx kernel takes and gives its launch
// geometry.
template <bool DX, typename T>
int plan_split(const float* part, int B, int N, int M, int D, int S, int F, int n_paths,
               int n_items, int splits, dim3& grid, int& threads, size_t& bytes) {
  const int n_keep = DX ? M : N;
  if (bad_shape(B, N, M, D, S, F, n_paths) || F > MAX_THREADS || n_paths > MAX_PATHS ||
      n_items < 0 || splits < 1 ||
      splits > (DX ? N : M) || (splits > 1 && part == nullptr) ||
      (n_keep + KEEP - 1) / KEEP > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_split<T>(DX);
  if (err != cudaSuccess) return (int)err;
  bytes = (size_t)split_layout(DX, F, D, n_paths, n_items, sizeof(T)).total * sizeof(float);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  grid = dim3(splits, (n_keep + KEEP - 1) / KEEP, B);
  threads = split_threads(F);
  return 0;
}

// After the main kernel: its launch error, else, when the summed axis is
// split, the launch of the sum of the splits into `out` (`total` elements).
template <typename T>
int sum_splits(const float* part, T* out, long long total, int splits, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  tp_aggregate_sum_splits<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, out, total,
                                                                              splits);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// The widest cp.async piece (16, 8 or 4 bytes) that divides a row of F
// elements of esize bytes and the base address of w; 0 when none does.
int row_unit(const void* w, int F, int esize) {
  for (int unit = 16; unit >= 4; unit /= 2)
    if ((F * esize) % unit == 0 && aligned(w, unit)) return unit;
  return 0;
}

template <typename T>
int launch_fwd(const void* x, const void* sh, const void* w, const int* chan, const int* ptab,
               const float* gtab, float* out, float* part, int B, int N, int M, int D, int S,
               int F, int n_paths, int splits, cudaStream_t st) {
  dim3 grid;
  int threads;
  size_t bytes;
  const int rc = plan_split<false, T>(part, B, N, M, D, S, F, n_paths, 0, splits, grid, threads,
                                      bytes);
  if (rc != 0) return rc;
  tp_aggregate_fwd_kernel<T><<<grid, threads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(sh), static_cast<const T*>(w),
      reinterpret_cast<const int4*>(chan), reinterpret_cast<const int4*>(ptab), gtab,
      splits > 1 ? part : out, B, N, M, D, S, F, n_paths, row_unit(w, F, sizeof(T)));
  return sum_splits<float>(part, out, (long long)B * N * F * 4, splits, st);
}

template <typename T>
int launch_bwd_edge(const void* x, const void* sh, const void* w, const float* g,
                    const int* chan, const int* ptab, const float* gtab, const int* seg_ptr,
                    const int* seg, void* dw, void* dsh, int B, int N, int M, int D, int S, int F,
                    int n_paths, int mt, int n_seg, cudaStream_t st) {
  const int4* chan4 = reinterpret_cast<const int4*>(chan);
  const int4* ptab4 = reinterpret_cast<const int4*>(ptab);
  const size_t dw_bytes = sizeof(float) * ((size_t)n_paths * G_SIZE + (size_t)TN * mt * SH_STRIDE +
                                           (size_t)mt * D);
  const size_t sh_bytes =
      sizeof(float) * ((size_t)F * P_PITCH +
                       (size_t)SH_CHUNK * ((F | 1) + (D | 1) + SHP) +
                       (size_t)n_paths * SH_CHUNK * J_MAX + ((S + 1 + 3) / 4) * 4 + (size_t)n_seg * 2);
  if (dw_bytes > MAX_SMEM || sh_bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool allowed = false;   // the attributes are set once per operand type
  if (!allowed) {
    cudaError_t err = allow_shared(tp_aggregate_bwd_edge_kernel<T, false>, MAX_SMEM);
    if (err == cudaSuccess) err = allow_shared(tp_aggregate_bwd_edge_kernel<T, true>, MAX_SMEM);
    if (err == cudaSuccess) err = allow_shared(tp_aggregate_bwd_edge_kernel_dsh<T>, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const T* xt = static_cast<const T*>(x);
  const T* sht = static_cast<const T*>(sh);
  if (dsh == nullptr) {
    const dim3 grid((M + mt - 1) / mt, (N + TN - 1) / TN, B);
    if (F <= MAX_THREADS)   // a channel a thread
      tp_aggregate_bwd_edge_kernel<T, false><<<grid, threads_for(F), dw_bytes, st>>>(
          xt, sht, g, chan4, ptab4, gtab, static_cast<T*>(dw), N, M, D, S, F, n_paths, mt);
    else
      tp_aggregate_bwd_edge_kernel<T, true><<<grid, threads_for(F), dw_bytes, st>>>(
          xt, sht, g, chan4, ptab4, gtab, static_cast<T*>(dw), N, M, D, S, F, n_paths, mt);
  } else {
    // one warp per path, between 8 and 16 warps
    const int threads = 32 * (n_paths < 8 ? 8 : n_paths > 16 ? 16 : n_paths);
    const dim3 grid((M + SH_CHUNK - 1) / SH_CHUNK, N, B);
    const int vec = F % 4 == 0 && aligned(w, 4 * sizeof(T)) && aligned(dw, 4 * sizeof(T));
    tp_aggregate_bwd_edge_kernel_dsh<T><<<grid, threads, sh_bytes, st>>>(
        xt, sht, static_cast<const T*>(w), g, chan4, ptab4, gtab, seg_ptr,
        reinterpret_cast<const int2*>(seg), static_cast<T*>(dw), static_cast<T*>(dsh), N, M, D, S,
        F, n_paths, n_seg, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_x(const void* sh, const void* w, const float* g, const int* chan, const int* ptab,
                 const float* gtab, const int* d_ptr, const int* d_item, void* dx, float* part,
                 int B, int N, int M, int D, int S, int F, int n_paths, int n_items, int splits,
                 cudaStream_t st) {
  dim3 grid;
  int threads;
  size_t bytes;
  const int rc = plan_split<true, T>(part, B, N, M, D, S, F, n_paths, n_items, splits, grid,
                                     threads, bytes);
  if (rc != 0) return rc;
  T* out = static_cast<T*>(dx);
  tp_aggregate_bwd_x_kernel<T><<<grid, threads, bytes, st>>>(
      static_cast<const T*>(sh), static_cast<const T*>(w), g, reinterpret_cast<const int4*>(chan),
      reinterpret_cast<const int4*>(ptab), gtab, d_ptr, d_item, splits > 1 ? part : nullptr, out,
      B, N, M, D, S, F, n_paths, n_items, row_unit(w, F, sizeof(T)), aligned(g, 16));
  return sum_splits<T>(part, out, (long long)B * M * D, splits, st);
}

template <typename T>
int blocks_per_sm(int dx, int D, int F, int n_paths, int n_items) {
  cudaError_t err = allow_split<T>(dx != 0);
  if (err != cudaSuccess) return -(int)err;
  const size_t bytes =
      (size_t)split_layout(dx != 0, F, D, n_paths, n_items, sizeof(T)).total * sizeof(float);
  int blocks = 0;
  err = dx ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tp_aggregate_bwd_x_kernel<T>,
                                                           split_threads(F), bytes)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tp_aggregate_fwd_kernel<T>,
                                                           split_threads(F), bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// ---- the 8-lane kernels (irreps up to l = 2; head note) ----

constexpr int L2_K = 5;                 // components of an l <= 2 irrep
constexpr int L2_G = L2_K * L2_K * L2_K;   // alpha*cg padded to (5, 5, 5)
constexpr int L2_THREADS = 384;         // a thread per channel: F <= 384
constexpr int L2_MAX_PATHS = 32;

// ---- the dense 8-lane forward and dx by channel tile (head note) ----

constexpr int T2_KEEP = 8;              // receivers (forward) or senders (dx) a block keeps
constexpr int T2_SUM = 4;               // entries of the summed axis a tile
constexpr int T2_ROWS = T2_KEEP * T2_SUM;   // edges a tile, row r = (r / T2_KEEP, r % T2_KEEP)
constexpr int T2_THREADS = 256;
constexpr int T2_QMAX = 4;              // kept entries of one thread: 4 (two parts) or 2 (four)
constexpr int T2_STAGES = 2;            // the ring: one tile in flight while one computes
constexpr int T2_SHP = 13;              // staged harmonics row, odd: lane = row reads no bank twice
constexpr int T2_EW = 32;               // words of live bits a kept entry: 1,024 summed entries
constexpr int T2_WALK = 128;            // walk slots of a channel tile (tp_aggregate.walk_l2)
constexpr int T2_MAXT = T2_EW * 32 / T2_SUM;   // tiles a block walks at most
constexpr int T2_IDXW = 64;             // slots a block of the sender-index forward takes at most

static_assert(T2_THREADS / 32 == T2_KEEP, "warp = kept entry in the live pass and the loads");

static_assert(T2_ROWS == 32, "a warp's vote gives a tile's live edges, one bit a lane");

// The shared memory of the tiled forward (dx false) and dx, in floats, the
// same on the host and the device.  FTP: the channel pitch (64 or 128); DXW,
// TS, GS, PC: the widest x slice, t row, coupling slice and path count of a
// channel tile (tp_fused.tables_tiled_l2); NI: the longest of dx's per-tile
// item lists; esize: the operands' bytes.  A stage of the ring holds a tile's
// rows of w (in T), its harmonics (f32, or bf16 as the 4-byte words that
// cover the row) and its per-entry operand: the forward's sender x slices
// (in T; the sender-index forward (idx) one a row, each row its own sender),
// dx's receiver g rows (lanes 0-3 as a float4, lane 4 apart).  dx's end
// reuses the ring for its per-(sender, component, channel) sums; the
// sender-index forward keeps its kept entries' sender rows (T2_IDXW ints
// each) past the rest.
struct T2Layout {
  int w, sh, side, stage, t, g, ptab, pi, ebits, tmask, tlist, dlist, sidx, total;
};

__host__ __device__ inline T2Layout t2_layout(bool dx, int FTP, int DXW, int TS, int GS, int PC,
                                              int NI, int esize, bool idx = false) {
  T2Layout L;
  int o = 0;
  L.w = o;     o += T2_ROWS * FTP * esize / 4;
  L.sh = o;    o += T2_ROWS * T2_SHP;
  L.side = o;  o += dx ? T2_SUM * FTP * 5 : (idx ? T2_ROWS : T2_SUM) * DXW * esize / 4;
  L.stage = pad4(o);
  o = T2_STAGES * L.stage;
  L.t = o;     o += pad4(T2_ROWS * TS);
  L.g = o;     o += pad4(GS);
  L.ptab = o;  o += pad4(PC * 8);                   // ints
  L.pi = o;    o += pad4(PC * L2_K);                // ints: the tile's (path, i), i < d_in
  L.ebits = o; o += T2_KEEP * T2_EW;                // ints: each kept entry's live summed entries
  L.tmask = o; o += T2_MAXT;                        // ints: each tile's live rows
  L.tlist = o; o += T2_MAXT + 4;                    // ints: the live tiles, then their count
  L.dlist = o; o += dx ? pad4(DXW + 1) + pad4(NI) : 0;   // ints: d_ptr, then d_item
  L.sidx = o;  o += idx ? T2_KEEP * T2_IDXW : 0;        // ints: each live slot's sender row
  L.total = o;
  if (dx && L.total < T2_KEEP * L2_K * (FTP | 1)) L.total = T2_KEEP * L2_K * (FTP | 1);
  return L;
}

// t[i][k] = sum_j G[i, j, k] sh[j] of one (edge, path, i), k < DO, j < DS.
template <int DS, int DO, typename U>
__device__ __forceinline__ void t_entry(float* tq, const float* G, const U* sv) {
  float svj[DS];
#pragma unroll
  for (int j = 0; j < DS; ++j) svj[j] = to_f(sv[j]);
#pragma unroll
  for (int k = 0; k < DO; ++k) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < DS; ++j) t = fmaf(G[j * DO + k], svj[j], t);
    tq[k] = t;
  }
}

template <typename U>
__device__ __forceinline__ void t_item(int shape, float* tq, const float* G, const U* sv) {
  switch (shape) {
    case 011: t_entry<1, 1>(tq, G, sv); break;
    case 013: t_entry<1, 3>(tq, G, sv); break;
    case 015: t_entry<1, 5>(tq, G, sv); break;
    case 031: t_entry<3, 1>(tq, G, sv); break;
    case 033: t_entry<3, 3>(tq, G, sv); break;
    case 035: t_entry<3, 5>(tq, G, sv); break;
    case 051: t_entry<5, 1>(tq, G, sv); break;
    case 053: t_entry<5, 3>(tq, G, sv); break;
    default: t_entry<5, 5>(tq, G, sv); break;
  }
}

// The DI * DO values of an edge's t block of one path (padded to float4s).
template <int DI, int DO>
__device__ __forceinline__ void load_t(float (&t)[4 * ((DI * DO + 3) / 4)], const float* tq) {
#pragma unroll
  for (int q = 0; q < (DI * DO + 3) / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(tq + 4 * q);
    t[4 * q] = v.x, t[4 * q + 1] = v.y, t[4 * q + 2] = v.z, t[4 * q + 3] = v.w;
  }
}

// The forward's walk of one tile for a channel of shape (DI, DO): for each
// summed entry o (sender) its x values once, then each live edge of the
// thread's kept receivers (bits `base` .. of each entry's eight):
// acc[q][k] += w sum_i x[i] t[i][k].  xs, wc: the channel's x and w in the
// stage; tq: its path's t block of row 0.  IDX: every row its own sender,
// its x slice at the row's place.
template <int DI, int DO, bool IDX, typename T>
__device__ __forceinline__ void fwd_walk(float (&acc)[T2_QMAX][L2_K], unsigned mask, int base,
                                         int qk, const T* xs, int DXW, const T* wc, int FTP,
                                         const float* tq, int TS) {
#pragma unroll 1
  for (int o = 0; o < T2_SUM; ++o) {
    const unsigned bits = (mask >> (o * T2_KEEP + base)) & ((1u << qk) - 1u);
    if (bits == 0u) continue;
    float xv[DI];
    if (!IDX) {
#pragma unroll
      for (int i = 0; i < DI; ++i) xv[i] = to_f(xs[o * DXW + i]);
    }
#pragma unroll
    for (int q = 0; q < T2_QMAX; ++q) {
      if (!(bits >> q & 1u)) continue;
      const int r = o * T2_KEEP + base + q;
      if (IDX) {
#pragma unroll
        for (int i = 0; i < DI; ++i) xv[i] = to_f(xs[r * DXW + i]);
      }
      const float wv = to_f(wc[r * FTP]);
      float t[4 * ((DI * DO + 3) / 4)];
      load_t<DI, DO>(t, tq + r * TS);
#pragma unroll
      for (int i = 0; i < DI; ++i) {
        const float gi = wv * xv[i];
#pragma unroll
        for (int k = 0; k < DO; ++k) acc[q][k] = fmaf(gi, t[i * DO + k], acc[q][k]);
      }
    }
  }
}

// dx's walk of one tile for a channel of shape (DI, DO): for each summed
// entry o (receiver) its upstream gradient once, then each live edge of the
// thread's kept senders: acc[q][i] += w sum_k t[i][k] g[k].
template <int DI, int DO, typename T>
__device__ __forceinline__ void dx_walk(float (&acc)[T2_QMAX][L2_K], unsigned mask, int base,
                                        int qk, const float4* g4, const float* g1, int FTP,
                                        const T* wc, const float* tq, int TS) {
#pragma unroll 1
  for (int o = 0; o < T2_SUM; ++o) {
    const unsigned bits = (mask >> (o * T2_KEEP + base)) & ((1u << qk) - 1u);
    if (bits == 0u) continue;
    const float4 v = g4[o * FTP];
    const float ga[L2_K] = {v.x, v.y, v.z, v.w, DO > 4 ? g1[o * FTP] : 0.f};
#pragma unroll
    for (int q = 0; q < T2_QMAX; ++q) {
      if (!(bits >> q & 1u)) continue;
      const int r = o * T2_KEEP + base + q;
      const float wv = to_f(wc[r * FTP]);
      float t[4 * ((DI * DO + 3) / 4)];
      load_t<DI, DO>(t, tq + r * TS);
#pragma unroll
      for (int i = 0; i < DI; ++i) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < DO; ++k) s = fmaf(t[i * DO + k], ga[k], s);
        acc[q][i] = fmaf(wv, s, acc[q][i]);
      }
    }
  }
}

// One block of the tiled forward (DX false) or dx: batch row blockIdx.z,
// kept entries blockIdx.y * T2_KEEP .., channel tile blockIdx.x % n_ct,
// split blockIdx.x / n_ct of the summed axis (every splits-th entry).
//  * forward: dst is out (B, N, F, LANES) or, split, the partial sums
//    (splits, B, N, F, LANES); IDX: the sender-index forward (slot j of
//    receiver n reads sender row idx[b, n, j] of x (B, Mx, D); at most
//    T2_IDXW slots a split), each live row's x slice staged with it;
//  * dx: dst is null where one split and one tile write dx (B, M, D) in T
//    directly, else the partial sums (splits * n_ct, B, M, D) f32, each
//    (split, tile) writing the x elements of its tile's slice.
// wunit: the cp.async piece of a row of w (16, 8 or 4 bytes; 0: plain
// loads); vec: x slices (forward) or g rows (dx) in 16-byte (bf16 x: 8)
// pieces; shw: bf16 harmonics as the 4-byte words that cover a row.
template <bool DX, typename T, int LANES = 8, bool IDX = false>
__device__ __forceinline__ void tiled_body(
    const T* __restrict__ x, const T* __restrict__ sh, const T* __restrict__ w,
    const float* __restrict__ g, const int4* __restrict__ chan, const int* __restrict__ ptab,
    const float* __restrict__ gflat, const int* __restrict__ ctab, const int* __restrict__ walk,
    const unsigned* __restrict__ bits, const int* __restrict__ dptr,
    const int* __restrict__ ditem, float* __restrict__ dst, T* __restrict__ dx_out, int B, int N,
    int M, int D, int S, int F, int n_ct, int FTP, int DXW, int TS, int GS, int PC, int NI,
    int wunit, int vec, int shw, const int* __restrict__ idx = nullptr, int Mx = 0) {
  static_assert(!(DX && IDX), "the sender-index dx has kernels of its own");
  extern __shared__ __align__(16) float smem[];
  constexpr bool F32 = sizeof(T) == 4;
  const T2Layout L = t2_layout(DX, FTP, DXW, TS, GS, PC, NI, sizeof(T), IDX);
  float* s_t = smem + L.t;                                      // [row][TS]
  float* s_g = smem + L.g;                                      // the tile's coupling entries
  int* s_ptab = reinterpret_cast<int*>(smem + L.ptab);          // the tile's paths
  int* s_pi = reinterpret_cast<int*>(smem + L.pi);              // p * 8 + i, i < d_in(p)
  unsigned* s_ebits = reinterpret_cast<unsigned*>(smem + L.ebits);
  unsigned* s_tmask = reinterpret_cast<unsigned*>(smem + L.tmask);
  int* s_tlist = reinterpret_cast<int*>(smem + L.tlist);
  int* s_dptr = reinterpret_cast<int*>(smem + L.dlist);
  int* s_ditem = s_dptr + pad4(DXW + 1);
  int* s_idx = reinterpret_cast<int*>(smem + L.sidx);           // IDX: [kept][slot] sender row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = T2_THREADS / 32;
  const int ct = blockIdx.x % n_ct, split = blockIdx.x / n_ct, splits = gridDim.x / n_ct;
  const int b = blockIdx.z, k0 = blockIdx.y * T2_KEEP;
  const int n_keep = DX ? M : N, n_sum = DX ? N : M;
  const int count = split < n_sum ? (n_sum - split + splits - 1) / splits : 0;
  const int tiles = (count + T2_SUM - 1) / T2_SUM;
  const int f0 = ctab[ct * 8], fc = ctab[ct * 8 + 1], p0 = ctab[ct * 8 + 2];
  const int pc = ctab[ct * 8 + 3], x_lo = ctab[ct * 8 + 4], xw = ctab[ct * 8 + 5];
  const int g0 = ctab[ct * 8 + 6], gs = ctab[ct * 8 + 7];
  const long long sh_elems = (long long)B * N * M * S;

  // warp w stages row o * T2_KEEP + w of each tile (kept entry k0 + w,
  // summed entry tile * T2_SUM + o); its edge moves by `step` a summed entry
  const bool kept_ok = k0 + warp < n_keep;
  const long long step = (long long)splits * (DX ? M : 1);
  const long long e00 = DX ? ((long long)b * N + split) * M + k0 + warp
                           : ((long long)b * N + k0 + warp) * M + split;
  auto row_edge = [&](int tile, int o) -> long long {
    const int j = tile * T2_SUM + o;
    return kept_ok && j < count ? e00 + j * step : -1;
  };
  // the edge of row r of a tile (any warp's), or -1 past the ragged ends
  auto edge_of = [&](int tile, int r) -> long long {
    const int o = tile * T2_SUM + r / T2_KEEP, k = k0 + r % T2_KEEP;
    if (o >= count || k >= n_keep) return -1;
    const int s = split + o * splits;
    return ((long long)b * N + (DX ? s : k)) * M + (DX ? k : s);
  };

  // The live edges, from the bits of the live pass: per kept entry the live
  // summed entries (warp = kept entry, lane = entry), then per tile its
  // 32 edges' bits (row r = o * T2_KEEP + kk) and the list of tiles with a
  // live edge.  Only those tiles are loaded, and of them only live rows
  // (IDX: with each live slot's sender row, read here once).
  const int ewords = (count + 31) / 32;
  for (int j0 = 0; j0 < 32 * ewords; j0 += 32) {
    const long long e = row_edge(0, j0 + lane);
    const bool on = e >= 0 && (__ldg(bits + (e >> 5)) >> (e & 31) & 1u);
    if (IDX && on) s_idx[warp * T2_IDXW + j0 + lane] = __ldg(idx + e);
    const unsigned m = __ballot_sync(0xffffffffu, on);
    if (lane == 0) s_ebits[warp * T2_EW + j0 / 32] = m;
  }
  __syncthreads();
  for (int t = tid; t < tiles; t += T2_THREADS) {
    unsigned m = 0u;
#pragma unroll
    for (int kk = 0; kk < T2_KEEP; ++kk) {
      const unsigned nib = s_ebits[kk * T2_EW + (T2_SUM * t) / 32] >> ((T2_SUM * t) % 32) & 0xfu;
#pragma unroll
      for (int o = 0; o < T2_SUM; ++o) m |= (nib >> o & 1u) << (o * T2_KEEP + kk);
    }
    s_tmask[t] = m;
  }
  __syncthreads();
  if (warp == 0) {   // the live tiles, in order
    int n = 0;
    for (int t0 = 0; t0 < tiles; t0 += 32) {
      const bool on = t0 + lane < tiles && s_tmask[t0 + lane] != 0u;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) s_tlist[n + __popc(m & ((1u << lane) - 1u))] = t0 + lane;
      n += __popc(m);
    }
    if (lane == 0) s_tlist[T2_MAXT] = n;
  }
  __syncthreads();
  const int n_live = s_tlist[T2_MAXT];

  // a sender's x slice [x_lo, x_lo + xw) into the stage (a warp's lanes)
  auto copy_slice = [&](T* d, const T* src, int ln) {
    if (vec) {
      for (int q = ln; q < xw / 4; q += 32) {
        if (F32) cp_async16(d + 4 * q, src + 4 * q);
        else cp_async8(d + 4 * q, src + 4 * q);
      }
    } else {
      for (int c = ln; c < xw && x_lo + c < D; c += 32) {
        if (F32) cp_async4(d + c, src + c);
        else d[c] = src[c];
      }
    }
  };

  // the i-th live tile's live rows of w, their harmonics, and the operand of
  // each of its summed entries with a live edge (IDX: of each live row)
  auto load_tile = [&](int i) {
    if (i < n_live) {
      const int tile = s_tlist[i];
      const unsigned mask = s_tmask[tile];
      float* st = smem + (i % T2_STAGES) * L.stage;
#pragma unroll
      for (int o = 0; o < T2_SUM; ++o) {
        const int r = o * T2_KEEP + warp;
        if (!(mask >> r & 1u)) continue;
        const long long e = row_edge(tile, o);
        copy_row(reinterpret_cast<T*>(st + L.w) + r * FTP, w + e * F + f0, fc, wunit, lane);
        float* srow = st + L.sh + r * T2_SHP;
        if (F32) {
          if (lane < S) cp_async4(srow + lane, sh + e * S + lane);
        } else if (shw) {   // the words covering elements e S .. e S + S - 1
          const long long w0 = (e * S) >> 1;
          if (lane < (int)(((e * S + S + 1) >> 1) - w0)) {
            const long long wd = w0 + lane;
            if (2 * wd + 2 <= sh_elems)
              cp_async4(srow + lane, reinterpret_cast<const unsigned*>(sh) + wd);
            else   // the tensor's last element, alone in its word
              reinterpret_cast<T*>(srow + lane)[0] = sh[2 * wd];
          }
        } else if (lane < S) {
          reinterpret_cast<T*>(srow)[lane] = sh[e * S + lane];
        }
        if (IDX) {    // the slot's sender's x slice [x_lo, x_lo + xw), at the row's place
          const T* src = x + ((size_t)b * Mx + s_idx[warp * T2_IDXW + tile * T2_SUM + o]) * D +
                         x_lo;
          copy_slice(reinterpret_cast<T*>(st + L.side) + r * DXW, src, lane);
        }
      }
      if (!IDX && warp < T2_SUM) {
        const int o = warp, oo = tile * T2_SUM + o;
        if (mask >> (o * T2_KEEP) & 0xffu) {
          const int s = split + oo * splits;
          if (DX) {   // the receiver's upstream gradient, the tile's channels, lanes 0-4
            // (LANES 4: lanes 0-3; d_out <= 3, so lane 4 is never read)
            const float* src = g + ((size_t)b * N + s) * F * LANES + (size_t)f0 * LANES;
            float* d4 = st + L.side + o * FTP * 4;
            float* d1 = st + L.side + T2_SUM * FTP * 4 + o * FTP;
            for (int c = lane; c < fc; c += 32) {
              if (vec) {
                cp_async16(d4 + 4 * c, src + LANES * c);
              } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) cp_async4(d4 + 4 * c + k, src + LANES * c + k);
              }
              if (LANES == 8) cp_async4(d1 + c, src + 8 * c + 4);
            }
          } else {    // the sender's x slice [x_lo, x_lo + xw)
            copy_slice(reinterpret_cast<T*>(st + L.side) + o * DXW,
                       x + ((size_t)b * M + s) * D + x_lo, lane);
          }
        }
      }
    }
    cp_async_commit();
  };

  // the first live tiles' loads go out before anything else
#pragma unroll 1
  for (int i = 0; i < T2_STAGES - 1; ++i) load_tile(i);
  for (int i = tid; i < gs; i += T2_THREADS) s_g[i] = gflat[g0 + i];
  for (int i = tid; i < pc * 8; i += T2_THREADS) s_ptab[i] = ptab[p0 * 8 + i];
  int n_pi = 0;         // the tile's (path, i) pairs of the t step, in path order
  for (int p = 0; p < pc; ++p) {
    const int d_in = ptab[(p0 + p) * 8 + 1];
    if (tid < d_in) s_pi[n_pi + tid] = p * 8 + tid;
    n_pi += d_in;
  }
  if (DX) {
    const int* row = dptr + ct * (DXW + 1);
    const int base = row[0];
    for (int i = tid; i <= xw; i += T2_THREADS) s_dptr[i] = row[i] - base;
    for (int i = tid; i < row[xw] - base; i += T2_THREADS) s_ditem[i] = ditem[base + i];
  }

  // the walk's thread: slot fl of the tile's walk (channel fw of the tile,
  // or none), kept entries base .. base + qk - 1: two parts of four for a
  // tile of up to 128 channels, four of two for one of up to 64
  const int cw = fc > 64 ? 128 : 64, qk = T2_KEEP / (T2_THREADS / cw);
  const int fl = tid % cw, base = (tid / cw) * qk;
  const int slot = walk[ct * T2_WALK + fl];
  const bool walker = slot >= 0;
  const int fw = walker ? slot : 0;
  const int4 cm = walker ? chan[f0 + fw] : make_int4(0, 1, 1, 0);   // x offset, d_in, d_out, path
  const int t_off = walker ? ptab[(p0 + cm.w) * 8 + 4] : 0;
  const int shape = cm.y * 8 + cm.z;
  float acc[T2_QMAX][L2_K];
#pragma unroll
  for (int q = 0; q < T2_QMAX; ++q)
#pragma unroll
    for (int k = 0; k < L2_K; ++k) acc[q][k] = 0.f;

  // t of every (live row, path, i): warp = (path, i) item, lane = row, so a
  // warp runs one shape and reads one coupling block
  auto t_pass = [&](const float* st, int tile, unsigned mask) {
    const int r = lane;
    if (!(mask >> r & 1u)) return;
    const float* srow = st + L.sh + r * T2_SHP;
    const T* svb = reinterpret_cast<const T*>(srow) +
                   (!F32 && shw ? (int)((edge_of(tile, r) * S) & 1) : 0);
    float* tr = s_t + r * TS;
    for (int it = warp; it < n_pi; it += NW) {
      const int pi = s_pi[it];
      const int* pt = s_ptab + (pi >> 3) * 8;   // sh_off, d_in, d_sh, d_out, t_off, g_off
      const int k = pi & 7, d_sh = pt[2], d_out = pt[3];
      const float* G = s_g + pt[5] + k * d_sh * d_out;
      float* tq = tr + pt[4] + k * d_out;
      if (F32) t_item(d_sh * 8 + d_out, tq, G, srow + pt[0]);
      else t_item(d_sh * 8 + d_out, tq, G, svb + pt[0]);
    }
  };

  for (int i = 0; i < n_live; ++i) {
    cp_async_wait<T2_STAGES - 2>();
    __syncthreads();                 // the tile has landed; the stage it replaces is read
    load_tile(i + T2_STAGES - 1);
    const int tile = s_tlist[i];
    const unsigned mask = s_tmask[tile];
    const float* st = smem + (i % T2_STAGES) * L.stage;
    t_pass(st, tile, mask);
    __syncthreads();
    if (!walker) continue;
    const T* wc = reinterpret_cast<const T*>(st + L.w) + fw;
    const float* tq = s_t + t_off;
    if (!DX) {
      const T* xs = reinterpret_cast<const T*>(st + L.side) + cm.x;
#define T2_FWD(DI, DO) fwd_walk<DI, DO, IDX>(acc, mask, base, qk, xs, DXW, wc, FTP, tq, TS)
      switch (shape) {
        case 011: T2_FWD(1, 1); break;
        case 013: T2_FWD(1, 3); break;
        case 015: T2_FWD(1, 5); break;
        case 031: T2_FWD(3, 1); break;
        case 033: T2_FWD(3, 3); break;
        case 035: T2_FWD(3, 5); break;
        case 051: T2_FWD(5, 1); break;
        case 053: T2_FWD(5, 3); break;
        default: T2_FWD(5, 5); break;
      }
#undef T2_FWD
    } else {
      const float4* g4 = reinterpret_cast<const float4*>(st + L.side) + fw;
      const float* g1 = st + L.side + T2_SUM * FTP * 4 + fw;
#define T2_DX(DI, DO) dx_walk<DI, DO>(acc, mask, base, qk, g4, g1, FTP, wc, tq, TS)
      switch (shape) {
        case 011: T2_DX(1, 1); break;
        case 013: T2_DX(1, 3); break;
        case 015: T2_DX(1, 5); break;
        case 031: T2_DX(3, 1); break;
        case 033: T2_DX(3, 3); break;
        case 035: T2_DX(3, 5); break;
        case 051: T2_DX(5, 1); break;
        case 053: T2_DX(5, 3); break;
        default: T2_DX(5, 5); break;
      }
#undef T2_DX
    }
  }
  cp_async_wait<0>();

  if (!DX) {
    if (walker) {   // LANES 4: d_out <= 3, so acc[q][3] and acc[q][4] are 0
      constexpr int Q4 = LANES / 4;
      float4* o4 = reinterpret_cast<float4*>(dst) + (size_t)split * B * N * F * Q4;
#pragma unroll
      for (int q = 0; q < T2_QMAX; ++q) {
        const int n = k0 + base + q;
        if (q >= qk || n >= N) continue;
        const size_t at = ((size_t)b * N + n) * F + f0 + fw;
        o4[Q4 * at] = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
        if (LANES == 8) o4[Q4 * at + 1] = make_float4(acc[q][4], 0.f, 0.f, 0.f);
      }
    }
    return;
  }
  // dx: the tile's channels that read one x element, added in the order of
  // the tile's list
  __syncthreads();                   // the ring is free
  const int FO = FTP | 1;
  float* s_d = smem;                 // [kept][i][channel of the tile]
  if (walker) {
#pragma unroll
    for (int q = 0; q < T2_QMAX; ++q) {
      if (q >= qk) continue;
#pragma unroll
      for (int i = 0; i < L2_K; ++i) s_d[((base + q) * L2_K + i) * FO + fw] = acc[q][i];
    }
  }
  __syncthreads();
  const int width = dst != nullptr ? xw : D;   // dx written directly: every element of a row
  for (int r = tid; r < T2_KEEP * width; r += T2_THREADS) {
    const int kk = r / width, c = r - kk * width;
    const int m = k0 + kk;
    const int e = dst != nullptr ? c : c - x_lo;   // position in the tile's slice
    const int d = x_lo + e;
    if (m >= M || d >= D) continue;
    float sum = 0.f;
    if (e >= 0 && e < xw)
      for (int q = s_dptr[e]; q < s_dptr[e + 1]; ++q) {
        const int it = s_ditem[q];
        sum += s_d[(kk * L2_K + (it & 7)) * FO + (it >> 3)];
      }
    const size_t at = ((size_t)b * M + m) * D + d;
    if (dst != nullptr) dst[(size_t)(split * n_ct + ct) * B * M * D + at] = sum;
    else dx_out[at] = from_f<T>(sum);
  }
}

// LANES 8, or 4 for a 4-lane forward wider than the split kernels take.
template <typename T, int LANES>
__global__ void __launch_bounds__(T2_THREADS, 3) tp_aggregate_fwd_l2_tiled_kernel(
    const T* __restrict__ x,          // (B, M, D) sender features
    const T* __restrict__ sh,         // (B, N, M, S) edge harmonics
    const T* __restrict__ w,          // (B, N, M, F) pre-masked edge weights
    const int4* __restrict__ chan,    // (F): x offset in the tile's slice, d_in, d_out, tile path
    const int* __restrict__ ptab,     // (n_paths, 8): sh_off, d_in, d_sh, d_out, t_off, g_off, 0, 0
    const float* __restrict__ gflat,  // each path's alpha*cg, (d_in, d_sh, d_out) entries
    const int* __restrict__ ctab,     // (n_ct, 8): f0, fc, p0, pc, x_lo, xw, g0, gs
    const int* __restrict__ walk,     // (n_ct, 128): each walk slot's tile channel, or -1
    const unsigned* __restrict__ bits,   // bit e of the live pass: edge e's row of w not all zero
    float* __restrict__ dst,          // out (B, N, F, LANES), or the partial sums (splits, ...)
    int B, int N, int M, int D, int S, int F, int n_ct, int FTP, int DXW, int TS, int GS, int PC,
    int wunit, int xvec, int shw) {
  tiled_body<false, T, LANES>(x, sh, w, nullptr, chan, ptab, gflat, ctab, walk, bits, nullptr,
                              nullptr, dst, nullptr, B, N, M, D, S, F, n_ct, FTP, DXW, TS, GS, PC,
                              0, wunit, xvec, shw);
}

template <typename T, int LANES>
__global__ void __launch_bounds__(T2_THREADS, 3) tp_aggregate_bwd_x_l2_tiled_kernel(
    const T* __restrict__ sh,         // (B, N, M, S)
    const T* __restrict__ w,          // (B, N, M, F)
    const float* __restrict__ g,      // (B, N, F, LANES) upstream gradient
    const int4* __restrict__ chan,    // as the forward's
    const int* __restrict__ ptab,
    const float* __restrict__ gflat,
    const int* __restrict__ ctab,
    const int* __restrict__ walk,
    const unsigned* __restrict__ bits,
    const int* __restrict__ dptr,     // (n_ct, DXW + 1): extents into ditem per element of a slice
    const int* __restrict__ ditem,    // (f - f0) * 8 + i of each (tile channel, i) reading it
    float* __restrict__ part,         // the partial sums (splits * n_ct, B, M, D), or null
    T* __restrict__ dx,               // (B, M, D) when one split and one tile
    int B, int N, int M, int D, int S, int F, int n_ct, int FTP, int DXW, int TS, int GS, int PC,
    int NI, int wunit, int gvec, int shw) {
  tiled_body<true, T, LANES>(nullptr, sh, w, g, chan, ptab, gflat, ctab, walk, bits, dptr, ditem,
                             part, dx, B, N, M, D, S, F, n_ct, FTP, DXW, TS, GS, PC, NI, wunit,
                             gvec, shw);
}

// The sender-index forward at LANES = 4 (l <= 1) or 8: the tiled forward
// with every row of a tile its own sender (x (B, Mx, D) read at idx).
template <typename T, int LANES>
__global__ void __launch_bounds__(T2_THREADS, 3) tp_aggregate_fwd_idx_tiled_kernel(
    const T* __restrict__ x,          // (B, Mx, D) sender features
    const T* __restrict__ sh,         // (B, N, K, S) slot harmonics
    const T* __restrict__ w,          // (B, N, K, F) pre-masked slot weights
    const int* __restrict__ idx,      // (B, N, K) sender row of each slot
    const int4* __restrict__ chan,    // as the dense tiled forward's
    const int* __restrict__ ptab,
    const float* __restrict__ gflat,
    const int* __restrict__ ctab,
    const int* __restrict__ walk,
    const unsigned* __restrict__ bits,   // the live pass's bits of w
    float* __restrict__ dst,          // out (B, N, F, LANES), or the partial sums (splits, ...)
    int B, int N, int K, int Mx, int D, int S, int F, int n_ct, int FTP, int DXW, int TS, int GS,
    int PC, int wunit, int xvec, int shw) {
  tiled_body<false, T, LANES, true>(x, sh, w, nullptr, chan, ptab, gflat, ctab, walk, bits,
                                    nullptr, nullptr, dst, nullptr, B, N, K, D, S, F, n_ct, FTP,
                                    DXW, TS, GS, PC, 0, wunit, xvec, shw, idx, Mx);
}

// dx[r, d] = sum over the tiles whose x slice holds d, in order, of the
// sum over the splits, in order, of their partial sums; rounded once.
template <typename T>
__global__ void tp_aggregate_l2_dx_sum(const float* __restrict__ part,
                                       const int* __restrict__ ctab, T* __restrict__ out,
                                       long long total, int D, int n_ct, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int d = (int)(i % D);
  float s = 0.f;
  for (int ct = 0; ct < n_ct; ++ct) {
    const int lo = __ldg(ctab + ct * 8 + 4), xw = __ldg(ctab + ct * 8 + 5);
    if (d < lo || d >= lo + xw) continue;
    for (int k = 0; k < splits; ++k) s += part[(size_t)(k * n_ct + ct) * total + i];
  }
  out[i] = from_f<T>(s);
}

// The live pass: bit e % 32 of bits[e / 32] set where row e of w (F
// elements of T) holds a nonzero (-0 counts as zero, as in f32).  A warp
// takes LIVE_ROWS rows, a block of eight warps 8 LIVE_ROWS of them (whole
// words of bits): each lane loads U-byte pieces (U: 16, 8, 4 or 2 bytes,
// dividing a row and w's address), LIVE_UNROLL pieces of each of its warp's
// rows at once, so that their loads are in flight together, and the warp
// votes a row.
constexpr int LIVE_ROWS = 4;            // rows of a warp in the live pass
constexpr int LIVE_UNROLL = 3;          // pieces a lane loads of a row at once
constexpr int LIVE_BLOCK = 8 * LIVE_ROWS;   // rows of a block
static_assert(LIVE_BLOCK % 32 == 0 && 32 % LIVE_ROWS == 0, "whole words a block");

// The magnitude bits of a U-byte piece of w, ORed: nonzero iff an element is.
template <typename T, int U>
__device__ __forceinline__ unsigned piece_bits(const char* p) {
  constexpr unsigned MAG = sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu;
  if constexpr (U == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    return (v.x | v.y | v.z | v.w) & MAG;
  } else if constexpr (U == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return (v.x | v.y) & MAG;
  } else if constexpr (U == 4) {
    return __ldg(reinterpret_cast<const unsigned*>(p)) & MAG;
  } else {
    return __ldg(reinterpret_cast<const unsigned short*>(p)) & 0x7fffu;
  }
}

template <typename T, int U>
__device__ __forceinline__ void live_rows(bool (&nz)[LIVE_ROWS], const char* base, size_t pitch,
                                          int valid, int pieces, int lane) {
  for (int c0 = lane; c0 < pieces; c0 += 32 * LIVE_UNROLL) {
    unsigned v[LIVE_ROWS][LIVE_UNROLL];
#pragma unroll
    for (int q = 0; q < LIVE_ROWS; ++q)
#pragma unroll
      for (int u = 0; u < LIVE_UNROLL; ++u) {
        const int c = c0 + 32 * u;
        v[q][u] = q < valid && c < pieces ? piece_bits<T, U>(base + q * pitch + (size_t)c * U)
                                          : 0u;
      }
#pragma unroll
    for (int q = 0; q < LIVE_ROWS; ++q)
#pragma unroll
      for (int u = 0; u < LIVE_UNROLL; ++u) nz[q] |= v[q][u] != 0u;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) tp_aggregate_l2_live_kernel(
    const T* __restrict__ w, unsigned* __restrict__ bits, long long rows, int F, int unit) {
  __shared__ unsigned s_bits[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * LIVE_BLOCK + warp * LIVE_ROWS;
  const int pieces = F * (int)sizeof(T) / unit;
  const int valid = r0 >= rows ? 0 : (int)min((long long)LIVE_ROWS, rows - r0);
  const size_t pitch = (size_t)F * sizeof(T);
  const char* base = reinterpret_cast<const char*>(w) + r0 * pitch;
  bool nz[LIVE_ROWS];
#pragma unroll
  for (int q = 0; q < LIVE_ROWS; ++q) nz[q] = false;
  if (unit == 16) live_rows<T, 16>(nz, base, pitch, valid, pieces, lane);
  else if (unit == 8) live_rows<T, 8>(nz, base, pitch, valid, pieces, lane);
  else if (unit == 4) live_rows<T, 4>(nz, base, pitch, valid, pieces, lane);
  else live_rows<T, 2>(nz, base, pitch, valid, pieces, lane);
  unsigned mine = 0u;   // this warp's rows, at their place in their word
#pragma unroll
  for (int q = 0; q < LIVE_ROWS; ++q)
    mine |= (unsigned)__any_sync(0xffffffffu, nz[q]) << ((warp * LIVE_ROWS + q) % 32);
  if (lane == 0) s_bits[warp] = mine;
  __syncthreads();
  constexpr int PER_WORD = 32 / LIVE_ROWS;   // warps a word
  if (threadIdx.x < LIVE_BLOCK / 32) {
    const long long word = (long long)blockIdx.x * (LIVE_BLOCK / 32) + threadIdx.x;
    if (word * 32 < rows) {
      unsigned out = 0u;
#pragma unroll
      for (int k = 0; k < PER_WORD; ++k) out |= s_bits[threadIdx.x * PER_WORD + k];
      bits[word] = out;
    }
  }
}

// Allows the tiled forward (dx false) or dx kernel of operand type T and
// LANES all the shared memory an SM has, once per kernel.
template <typename T, int LANES>
cudaError_t allow_tiled(bool dx) {
  static bool allowed[2] = {false, false};
  if (allowed[dx]) return cudaSuccess;
  const cudaError_t err = dx ? allow_shared(tp_aggregate_bwd_x_l2_tiled_kernel<T, LANES>, MAX_SMEM)
                             : allow_shared(tp_aggregate_fwd_l2_tiled_kernel<T, LANES>, MAX_SMEM);
  if (err == cudaSuccess) allowed[dx] = true;
  return err;
}

size_t tiled_bytes(bool dx, int FTP, int DXW, int TS, int GS, int PC, int NI, int esize,
                   bool idx = false) {
  return (size_t)t2_layout(dx, FTP, DXW, TS, GS, PC, NI, esize, idx).total * sizeof(float);
}

// Allows the sender-index forward of operand type T and LANES all the
// shared memory an SM has, once per kernel.
template <typename T, int LANES>
cudaError_t allow_idx_fwd() {
  static bool allowed = false;
  if (allowed) return cudaSuccess;
  const cudaError_t err = allow_shared(tp_aggregate_fwd_idx_tiled_kernel<T, LANES>, MAX_SMEM);
  if (err == cudaSuccess) allowed = true;
  return err;
}

bool bad_tiling(int B, int N, int M, int D, int S, int F, int n_ct, int FTP, int DXW, int TS,
                int GS, int PC, int NI, int splits, int summed, const float* part, bool need_part) {
  return B < 1 || B > 65535 || N < 1 || M < 1 || D < 1 || S < 1 || S > SH_STRIDE || F < 1 ||
         n_ct < 1 || (FTP != 64 && FTP != 128) || DXW < 4 || DXW % 4 != 0 || TS < 4 ||
         TS % 4 != 0 || GS < 1 || PC < 1 || PC > L2_MAX_PATHS || NI < 0 || splits < 1 ||
         splits > summed || (summed + splits - 1) / splits > 32 * T2_EW ||
         (long long)splits * n_ct > 65535 || (need_part && part == nullptr);
}

template <typename T>
int launch_live(const void* w, unsigned* bits, long long rows, int F, int unit, cudaStream_t st) {
  if (rows < 1 || F < 1 || (unit != 16 && unit != 8 && unit != 4 && unit != (int)sizeof(T)) ||
      (F * (int)sizeof(T)) % unit != 0 || !aligned(w, unit) || bits == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + LIVE_BLOCK - 1) / LIVE_BLOCK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tp_aggregate_l2_live_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(static_cast<const T*>(w), bits,
                                                                   rows, F, unit);
  return (int)cudaGetLastError();
}

template <typename T, int LANES>
int launch_fwd_l2_tiled(const void* x, const void* sh, const void* w, const int* chan,
                        const int* ptab, const float* gflat, const int* ctab, const int* walk,
                        const unsigned* bits, float* out, float* part, int B, int N, int M, int D,
                        int S, int F,
                        int n_ct, int FTP, int DXW, int TS, int GS, int PC, int splits, int wunit,
                        cudaStream_t st) {
  if (bad_tiling(B, N, M, D, S, F, n_ct, FTP, DXW, TS, GS, PC, 0, splits, M, part, splits > 1) ||
      (N + T2_KEEP - 1) / T2_KEEP > 65535 || (wunit != 0 && !aligned(w, wunit)) ||
      bits == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = tiled_bytes(false, FTP, DXW, TS, GS, PC, 0, sizeof(T));
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_tiled<T, LANES>(false);
  if (err != cudaSuccess) return (int)err;
  const int xvec = D % 4 == 0 && aligned(x, 4 * sizeof(T));
  const int shw = sizeof(T) == 2 && aligned(sh, 4);
  tp_aggregate_fwd_l2_tiled_kernel<T, LANES><<<dim3(splits * n_ct, (N + T2_KEEP - 1) / T2_KEEP, B),
                                               T2_THREADS, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(sh), static_cast<const T*>(w),
      reinterpret_cast<const int4*>(chan), ptab, gflat, ctab, walk, bits, splits > 1 ? part : out,
      B, N, M, D, S, F, n_ct, FTP, DXW, TS, GS, PC, wunit, xvec, shw);
  return sum_splits<float>(part, out, (long long)B * N * F * LANES, splits, st);
}

template <typename T, int LANES>
int launch_fwd_idx_tiled(const void* x, const void* sh, const void* w, const int* idx,
                         const int* chan, const int* ptab, const float* gflat, const int* ctab,
                         const int* walk, const unsigned* bits, float* out, float* part, int B,
                         int N, int K, int Mx, int D, int S, int F, int n_ct, int FTP, int DXW,
                         int TS, int GS, int PC, int splits, int wunit, cudaStream_t st) {
  if (bad_tiling(B, N, K, D, S, F, n_ct, FTP, DXW, TS, GS, PC, 0, splits, K, part, splits > 1) ||
      (K + splits - 1) / splits > T2_IDXW || Mx < 1 || idx == nullptr ||
      (N + T2_KEEP - 1) / T2_KEEP > 65535 || (wunit != 0 && !aligned(w, wunit)) ||
      bits == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = tiled_bytes(false, FTP, DXW, TS, GS, PC, 0, sizeof(T), true);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_idx_fwd<T, LANES>();
  if (err != cudaSuccess) return (int)err;
  const int xvec = D % 4 == 0 && aligned(x, 4 * sizeof(T));
  const int shw = sizeof(T) == 2 && aligned(sh, 4);
  tp_aggregate_fwd_idx_tiled_kernel<T, LANES><<<dim3(splits * n_ct, (N + T2_KEEP - 1) / T2_KEEP,
                                                     B),
                                                T2_THREADS, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(sh), static_cast<const T*>(w), idx,
      reinterpret_cast<const int4*>(chan), ptab, gflat, ctab, walk, bits, splits > 1 ? part : out,
      B, N, K, Mx, D, S, F, n_ct, FTP, DXW, TS, GS, PC, wunit, xvec, shw);
  return sum_splits<float>(part, out, (long long)B * N * F * LANES, splits, st);
}

template <typename T, int LANES>
int idx_fwd_blocks_per_sm(int FTP, int DXW, int TS, int GS, int PC) {
  cudaError_t err = allow_idx_fwd<T, LANES>();
  if (err != cudaSuccess) return -(int)err;
  const size_t bytes = tiled_bytes(false, FTP, DXW, TS, GS, PC, 0, sizeof(T), true);
  if (bytes > MAX_SMEM) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tp_aggregate_fwd_idx_tiled_kernel<T, LANES>, T2_THREADS, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <typename T, int LANES>
int launch_bwd_x_l2_tiled(const void* sh, const void* w, const float* g, const int* chan,
                          const int* ptab, const float* gflat, const int* ctab, const int* walk,
                          const unsigned* bits, const int* dptr, const int* ditem, void* dx,
                          float* part, int B, int N,
                          int M, int D, int S, int F, int n_ct, int FTP, int DXW, int TS, int GS,
                          int PC, int NI, int splits, int wunit, cudaStream_t st) {
  const bool partial = splits > 1 || n_ct > 1;
  if (bad_tiling(B, N, M, D, S, F, n_ct, FTP, DXW, TS, GS, PC, NI, splits, N, part, partial) ||
      (M + T2_KEEP - 1) / T2_KEEP > 65535 || (wunit != 0 && !aligned(w, wunit)) ||
      bits == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = tiled_bytes(true, FTP, DXW, TS, GS, PC, NI, sizeof(T));
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_tiled<T, LANES>(true);
  if (err != cudaSuccess) return (int)err;
  T* out = static_cast<T*>(dx);
  tp_aggregate_bwd_x_l2_tiled_kernel<T, LANES><<<dim3(splits * n_ct, (M + T2_KEEP - 1) / T2_KEEP, B),
                                                 T2_THREADS, bytes, st>>>(
      static_cast<const T*>(sh), static_cast<const T*>(w), g, reinterpret_cast<const int4*>(chan),
      ptab, gflat, ctab, walk, bits, dptr, ditem, partial ? part : nullptr, out, B, N, M, D, S, F,
      n_ct,
      FTP, DXW, TS, GS, PC, NI, wunit, aligned(g, 16), sizeof(T) == 2 && aligned(sh, 4));
  err = cudaGetLastError();
  if (err != cudaSuccess || !partial) return (int)err;
  const long long total = (long long)B * M * D;
  tp_aggregate_l2_dx_sum<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, ctab, out, total,
                                                                           D, n_ct, splits);
  return (int)cudaGetLastError();
}

template <typename T, int LANES>
int tiled_blocks_per_sm(int dx, int FTP, int DXW, int TS, int GS, int PC, int NI) {
  cudaError_t err = allow_tiled<T, LANES>(dx != 0);
  if (err != cudaSuccess) return -(int)err;
  const size_t bytes = tiled_bytes(dx != 0, FTP, DXW, TS, GS, PC, NI, sizeof(T));
  if (bytes > MAX_SMEM) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  err = dx ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, tp_aggregate_bwd_x_l2_tiled_kernel<T, LANES>, T2_THREADS, bytes)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, tp_aggregate_fwd_l2_tiled_kernel<T, LANES>, T2_THREADS, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// ---- the 8-lane edge backward (dense), and the sender-index mode's dw ----

constexpr int PT_W = 12;        // ints of a path's row (tp_aggregate.path_tables_l2)
constexpr int EB_SLOTS = 32;    // senders of a block: lane = sender
constexpr int EB_WARPS = 8;
constexpr int EB_THREADS = 32 * EB_WARPS;
constexpr int EB_SHP = 13;      // a staged harmonics row: odd, so lane = row reads no bank twice
constexpr int IDX_EDGE_SLOTS = 32;  // slots of a block of the sender-index dw: a receiver's K

// P[b, n, f, i, j] = sum_k G[i, j, k] g[b, n, f, k] of every receiver and
// channel, one block a receiver, thread = entry of the P row (PT floats,
// entry e of the host's table pent: (channel, its coupling entries' offset
// in gflat, d_out, 1), or zeros for a pad entry).  The edge backward's
// blocks read it: a receiver's P is formed once, not once per block of
// senders.  (Blocks of 8 receivers that read each entry's coupling values
// once ran twice as long: a quarter of the blocks.)
__global__ void __launch_bounds__(256) tp_aggregate_l2_p_kernel(
    const float* __restrict__ g,      // (B, N, F, 8)
    const int4* __restrict__ pent,    // (PT)
    const float* __restrict__ gflat,  // each path's alpha*cg, (d_in, d_sh, d_out) entries
    float* __restrict__ Pg,           // (B, N, PT)
    int F, int PT) {
  const size_t row = blockIdx.x;     // b * N + n
  const float* gr = g + row * F * 8;
  float* out = Pg + row * PT;
  for (int e = threadIdx.x; e < PT; e += blockDim.x) {
    const int4 en = __ldg(pent + e);
    float v = 0.f;
    for (int k = 0; k < en.z; ++k) v = fmaf(__ldg(gflat + en.y + k), __ldg(gr + en.x * 8 + k), v);
    out[e] = v;
  }
}

// The edge backward's shared memory, in floats: the receiver's P (PT
// floats: each channel's d_in x d_sh entries padded to float4s), the
// block's senders' x rows (slots x (D | 1)), their rows of w and then of
// dw (slots x (F | 1)), their harmonics (slots x EB_SHP) and, with
// dsh, each (path, component, sender)'s sum over the path's channels (PS
// floats).
struct EdgeLayout {
  int p, x, w, sh, part, total;
};

// `slots`: the senders a block takes, EB_SLOTS or, where their rows would
// not fit, fewer (tp_aggregate.edge_slots_l2).
__host__ __device__ inline EdgeLayout edge_layout(bool dsh, int D, int F, int PT, int PS,
                                                  int slots = EB_SLOTS) {
  EdgeLayout L;
  int o = 0;
  L.p = o;    o += pad4(PT);
  L.x = o;    o += slots * (D | 1);
  L.w = o;    o += slots * (F | 1);
  L.sh = o;   o += slots * EB_SHP;
  L.part = o; o += dsh ? PS : 0;
  L.total = o;
  return L;
}

// One path's channels for the lane's sender, the path's shape (DI, DS)
// fixed: per channel q[j] = sum_i x[i] P[i][j] (P a broadcast, x from the
// lane's row), dw = sum_j sh[j] q[j] (the harmonics in registers) left in
// the place of w; with DSH the sums over the path's channels of w q[j],
// in channel order, written to part[j * EB_SLOTS].
template <int DI, int DS, bool DSH>
__device__ __forceinline__ void edge_path(const float* __restrict__ P, const float* xr, float* wr,
                                          const float* shr, int fc, float* part) {
  constexpr int PP = (DI * DS + 3) / 4 * 4;
  float shj[DS], acc[DS];
#pragma unroll
  for (int j = 0; j < DS; ++j) {
    shj[j] = shr[j];
    acc[j] = 0.f;
  }
#pragma unroll 2
  for (int u = 0; u < fc; ++u) {
    float pv[PP];
#pragma unroll
    for (int q = 0; q < PP / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(P + u * PP + 4 * q);
      pv[4 * q] = v.x, pv[4 * q + 1] = v.y, pv[4 * q + 2] = v.z, pv[4 * q + 3] = v.w;
    }
    float xi[DI];
#pragma unroll
    for (int i = 0; i < DI; ++i) xi[i] = xr[u * DI + i];
    const float wv = DSH ? wr[u] : 0.f;
    float dwv = 0.f;
#pragma unroll
    for (int j = 0; j < DS; ++j) {
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < DI; ++i) q = fmaf(xi[i], pv[i * DS + j], q);
      dwv = fmaf(shj[j], q, dwv);
      if (DSH) acc[j] = fmaf(wv, q, acc[j]);
    }
    wr[u] = dwv;
  }
  if (DSH) {
#pragma unroll
    for (int j = 0; j < DS; ++j) part[j * EB_SLOTS] = acc[j];
  }
}

// dw (and, with DSH, dsh) of the edges (b, n, m0 .. m0 + slots - 1) for
// the receivers n of a block: a block per (sender chunk blockIdx.x, run of
// `rn` receivers blockIdx.y, batch row blockIdx.z).  The chunk's x rows go
// into shared memory once; per receiver its P row (tp_aggregate_l2_p_kernel)
// and harmonics arrive by cp.async while the previous receiver's dw leaves;
// warp = the paths of the host's plan, lane = sender, computes dw in place;
// dw leaves row by row (four elements a store where F allows); with DSH the
// block stages the receiver's live rows of w and adds the paths that reach
// each component.
template <typename T, bool DSH>
__global__ void __launch_bounds__(EB_THREADS, 2) tp_aggregate_bwd_edge_l2_kernel(
    const T* __restrict__ x,          // (B, M, D)
    const T* __restrict__ sh,         // (B, N, M, S)
    const T* __restrict__ w,          // (B, N, M, F) (read with DSH)
    const unsigned* __restrict__ bits,   // the live pass's bits of w, or null (read with DSH)
    const float* __restrict__ Pg,     // (B, N, PT) of tp_aggregate_l2_p_kernel
    const int* __restrict__ ptab,     // (n_paths, PT_W)
    const int* __restrict__ plan,     // (EB_WARPS, plan_w): each warp's paths, -1 past the last
    const int* __restrict__ seg_ptr,  // (S + 1): extents into seg per harmonic component
    const int2* __restrict__ seg,     // (path, j) of every path reaching the component
    T* __restrict__ dw,               // (B, N, M, F)
    T* __restrict__ dsh,              // (B, N, M, S)
    int N, int M, int D, int S, int F, int PT, int PS, int plan_w, int rn, int xpair, int vec,
    int slots) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool F32 = sizeof(T) == 4;
  const EdgeLayout L = edge_layout(DSH, D, F, PT, PS, slots);
  float* s_p = smem + L.p;
  float* s_x = smem + L.x;
  float* s_w = smem + L.w;
  float* s_sh = smem + L.sh;
  float* s_part = smem + L.part;
  const int XP = D | 1, WP = F | 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * slots, b = blockIdx.z;
  const int n0 = blockIdx.y * rn, n_end = min(N, n0 + rn);
  const int count = min(slots, M - m0);

  // the chunk's x rows as f32 (warp = row): cp.async at f32, two elements a
  // load at bf16 where x allows (xpair)
  for (int ml = warp; ml < count; ml += EB_WARPS) {
    const T* xs = x + ((size_t)b * M + m0 + ml) * D;
    float* xd = s_x + ml * XP;
    if (F32) {
      for (int d = lane; d < D; d += 32) cp_async4(xd + d, xs + d);
    } else if (xpair) {
      for (int c = lane; c < D / 2; c += 32) {
        const float2 v = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(xs)[c]);
        xd[2 * c] = v.x, xd[2 * c + 1] = v.y;
      }
    } else {
      for (int d = lane; d < D; d += 32) xd[d] = to_f(xs[d]);
    }
  }
  // receiver n's P row and harmonics, by cp.async (bf16 harmonics by plain
  // loads)
  auto stage_receiver = [&](int n) {
    const float* pr = Pg + ((size_t)b * N + n) * PT;
    for (int i = tid; i < PT / 4; i += EB_THREADS) cp_async16(s_p + 4 * i, pr + 4 * i);
    const size_t row0 = ((size_t)b * N + n) * M + m0;
    for (int i = tid; i < count * EB_SHP; i += EB_THREADS) {
      const int ml = i / EB_SHP, j = i - ml * EB_SHP;
      if (F32 && j < S) cp_async4(s_sh + i, sh + (row0 + ml) * S + j);
      else s_sh[i] = j < S ? to_f(sh[(row0 + ml) * S + j]) : 0.f;
    }
    cp_async_commit();
  };
  stage_receiver(n0);

  for (int n = n0; n < n_end; ++n) {
    const size_t row0 = ((size_t)b * N + n) * M + m0;   // the receiver's first edge
    cp_async_wait<0>();
    __syncthreads();   // P, harmonics (and x) landed; the previous receiver's dw has left s_w
    if (DSH) {         // its rows of w (warp = row); a dead row (bits) is zero and not read
      for (int ml = warp; ml < count; ml += EB_WARPS) {
        const size_t e = row0 + ml;
        const bool live = bits == nullptr || (__ldg(bits + (e >> 5)) >> (e & 31) & 1u);
        const T* ws = w + e * F;
        float* wd = s_w + ml * WP;
        if (vec) {
          for (int c = lane; c < F / 4; c += 32) {
            const float4 v = live ? load4(ws + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
            wd[4 * c] = v.x, wd[4 * c + 1] = v.y, wd[4 * c + 2] = v.z, wd[4 * c + 3] = v.w;
          }
        } else {
          for (int c = lane; c < F; c += 32) wd[c] = live ? to_f(ws[c]) : 0.f;
        }
      }
      __syncthreads();
    }

    if (lane < count) {
      for (int k = 0; k < plan_w; ++k) {   // warp = path, lane = sender
        const int p = plan[warp * plan_w + k];
        if (p < 0) break;
        const int* pt = ptab + p * PT_W;
        const int sh_off = pt[0], d_in = pt[1], d_sh = pt[2], f0 = pt[4], fc = pt[5];
        const float* P = s_p + pt[9];
        const float* xr = s_x + lane * XP + pt[6];
        float* wr = s_w + lane * WP + f0;
        const float* shr = s_sh + lane * EB_SHP + sh_off;
        float* part = s_part + pt[10] + lane;
#define EB_PATH(DI, DS) edge_path<DI, DS, DSH>(P, xr, wr, shr, fc, part)
        switch (d_in * 8 + d_sh) {
          case 011: EB_PATH(1, 1); break;
          case 013: EB_PATH(1, 3); break;
          case 015: EB_PATH(1, 5); break;
          case 031: EB_PATH(3, 1); break;
          case 033: EB_PATH(3, 3); break;
          case 035: EB_PATH(3, 5); break;
          case 051: EB_PATH(5, 1); break;
          case 053: EB_PATH(5, 3); break;
          default: EB_PATH(5, 5); break;
        }
#undef EB_PATH
      }
    }
    __syncthreads();
    if (n + 1 < n_end) stage_receiver(n + 1);   // s_p and s_sh were last read above

    // dw row by row (four elements a store where F and dw allow), then dsh
    for (int ml = warp; ml < count; ml += EB_WARPS) {
      T* dst = dw + (row0 + ml) * F;
      const float* src = s_w + ml * WP;
      if (vec) {
        for (int c = lane; c < F / 4; c += 32)
          store4(dst + 4 * c, make_float4(src[4 * c], src[4 * c + 1], src[4 * c + 2],
                                          src[4 * c + 3]));
      } else {
        for (int c = lane; c < F; c += 32) dst[c] = from_f<T>(src[c]);
      }
    }
    if (DSH) {
      // per (sender, component): the paths that reach it, in the host list's order
      for (int r = tid; r < count * S; r += EB_THREADS) {
        const int ml = r / S, s = r - ml * S;
        float sum = 0.f;
        for (int q = seg_ptr[s]; q < seg_ptr[s + 1]; ++q) {
          const int2 pj = seg[q];
          sum += s_part[ptab[pj.x * PT_W + 10] + pj.y * EB_SLOTS + ml];
        }
        dsh[(row0 + ml) * S + s] = from_f<T>(sum);
      }
    }
  }
}

// The sender-index mode's dw (both lane counts) of the slots (b, n, m0 ..
// m0 + IDX_EDGE_SLOTS - 1): a block per (receiver, run of its slots: all K
// of them at K <= 32), a thread per channel.  The thread forms its channel's
// P[i][j] = sum_k G[i,j,k] g[k] in registers once for the receiver's slots
// (the first design formed it for every 8 slots), then per slot q[j] =
// sum_i x[i] P[i][j] with x read at the index, dw = sum_j sh[j] q[j].  (The
// dense design above, a block per 32 senders, ran it 1-29% slower: a
// receiver's 24 slots fill three quarters of its lanes.)
template <typename T, int LANES>
__global__ void __launch_bounds__(L2_THREADS) tp_aggregate_bwd_edge_idx_kernel(
    const T* __restrict__ x,          // (B, Mx, D)
    const T* __restrict__ sh,         // (B, N, M, S)
    const int* __restrict__ idx,      // (B, N, M) sender of each slot
    const float* __restrict__ g,      // (B, N, F, LANES)
    const int4* __restrict__ chan,    // (F): x_base, d_in, d_out, path
    const int* __restrict__ ptab,     // (n_paths, 8) of tp_fused.tables_l2
    const float* __restrict__ gtab,   // (n_paths, 5, 5, 5)
    T* __restrict__ dw,               // (B, N, M, F)
    int N, int M, int Mx, int D, int S, int F) {
  const int m0 = blockIdx.x * IDX_EDGE_SLOTS, n = blockIdx.y, b = blockIdx.z;
  const int count = min(IDX_EDGE_SLOTS, M - m0);
  // thread = channel (channels f, f + blockDim.x, ... where F > L2_THREADS)
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const int4 cm = chan[f];
    const int* pt = ptab + cm.w * 8;
    const int sh_off = pt[0], d_sh = pt[2];
    const float* G = gtab + cm.w * L2_G;
    const float4* gr =
        reinterpret_cast<const float4*>(g) + (((size_t)b * N + n) * F + f) * (LANES / 4);
    const float4 g0 = gr[0];
    const float ga[L2_K] = {g0.x, g0.y, g0.z, g0.w, LANES == 8 ? gr[1].x : 0.f};
    float gk[L2_K];
#pragma unroll
    for (int kk = 0; kk < L2_K; ++kk) gk[kk] = kk < cm.z ? ga[kk] : 0.f;   // pad lanes ignored
    float P[L2_K][L2_K];
#pragma unroll
    for (int i = 0; i < L2_K; ++i)
#pragma unroll
      for (int j = 0; j < L2_K; ++j) {
        float v = 0.f;
#pragma unroll
        for (int kk = 0; kk < L2_K; ++kk) v = fmaf(G[(i * L2_K + j) * L2_K + kk], gk[kk], v);
        P[i][j] = v;
      }
    for (int ml = 0; ml < count; ++ml) {
      const size_t e = ((size_t)b * N + n) * M + m0 + ml;
      const T* xr = x + ((size_t)b * Mx + idx[e]) * D + cm.x;
      float xi[L2_K];
#pragma unroll
      for (int i = 0; i < L2_K; ++i) xi[i] = i < cm.y ? to_f(xr[i]) : 0.f;
      float dwv = 0.f;
#pragma unroll
      for (int j = 0; j < L2_K; ++j) {
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < L2_K; ++i) v = fmaf(xi[i], P[i][j], v);
        if (j < d_sh) dwv = fmaf(to_f(sh[e * S + sh_off + j]), v, dwv);
      }
      dw[e * F + f] = from_f<T>(dwv);
    }
  }
}

// ---- the sender-index dx, both lane counts ----

constexpr int XI_Q = 32;          // slots a chunk takes at most (tp_aggregate.plan_idx_chunk)
constexpr int XI_ROWS = 4;        // live slots a tile
constexpr int XI_STAGES = 2;      // the ring: one tile in flight while one computes
constexpr int XI_SHP = 13;

// The chunk kernel's shared memory, in floats: the ring's stages, each a
// tile's rows of w (in T, a 16-byte pitch), harmonics (XI_SHP floats a
// row; bf16 as the 4-byte words that cover the row) and its receivers' g
// rows (lanes 0-3 of each channel as a float4, at 8 lanes lane 4 apart); t
// of a tile's rows (XI_ROWS x TS); the coupling entries (GS); the (path, i)
// items; the chunk's live slots and their count; then the d lists, past the
// per (component, channel) sums (5 x F) that the end writes over the ring.
struct XiLayout {
  int w, sh, g4, g1, stage, t, g, pi, rows, dlist, total;
};

__host__ __device__ inline XiLayout xi_layout(int D, int F, int n_paths, int TS, int GS,
                                              int n_items, int esize, int lanes) {
  XiLayout L;
  int o = 0;
  L.w = o;     o += XI_ROWS * w_pitch(F, esize) * esize / 4;
  L.sh = o;    o += pad4(XI_ROWS * XI_SHP);
  L.g4 = o;    o += XI_ROWS * F * 4;
  L.g1 = o;    o += lanes == 8 ? XI_ROWS * F : 0;
  L.stage = pad4(o);
  o = XI_STAGES * L.stage;
  L.t = o;     o += pad4(XI_ROWS * TS);
  L.g = o;     o += pad4(GS);
  L.pi = o;    o += pad4(n_paths * L2_K);
  L.rows = o;  o += XI_Q + 4;
  o = max(o, pad4(L2_K * F));
  L.dlist = o; o += pad4(D + 1) + pad4(n_items);
  L.total = o;
  return L;
}

// dx's walk of one tile for a channel of shape (DI, DO): per live slot r,
// acc[i] += w sum_k t[i][k] g[k], g the slot's receiver's row in the stage.
template <int DI, int DO, typename T>
__device__ __forceinline__ void xi_walk(float (&acc)[L2_K], const T* wc, int FP, const float* tq,
                                        int TS, const float4* g4, const float* g1, int F, int n) {
  for (int r = 0; r < n; ++r) {
    const float4 v = g4[r * F];
    const float gk[L2_K] = {v.x, v.y, v.z, v.w, DO > 4 ? g1[r * F] : 0.f};
    const float wv = to_f(wc[r * FP]);
    float t[4 * ((DI * DO + 3) / 4)];
    load_t<DI, DO>(t, tq + r * TS);
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < DO; ++k) s = fmaf(t[i * DO + k], gk[k], s);
      acc[i] = fmaf(wv, s, acc[i]);
    }
  }
}

// The sender-index dx, first pass: a block per chunk of one sender's slots
// (blockIdx.x; order[cuts[c] .. cuts[c + 1]], ascending slots), a thread
// per channel.  Of the chunk only the live slots
// (bits) are loaded: their rows of w, harmonics and receivers' g rows, a
// tile of XI_ROWS on the ring at a time; per tile t of each (slot, path,
// i), then each channel's walk; at the end the channels reading each x
// element are added in the d list's order into part[c] (D floats).  XC:
// channels a thread takes (f, f + blockDim.x, ...: 1 up to L2_THREADS
// channels, XI_XC up to XI_XC L2_THREADS).
template <typename T, int LANES, int XC>
__global__ void __launch_bounds__(L2_THREADS) tp_aggregate_bwd_x_idx_l2_kernel(
    const T* __restrict__ sh,         // (B, N, K, S)
    const T* __restrict__ w,          // (B, N, K, F)
    const float* __restrict__ g,      // (B, N, F, LANES)
    const unsigned* __restrict__ bits,   // the live pass's bits of w
    const int4* __restrict__ chan,    // (F): x_base, d_in, d_out, path
    const int* __restrict__ ptab,     // (n_paths, PT_W)
    const float* __restrict__ gflat,  // each path's alpha*cg, (d_in, d_sh, d_out) entries
    const int* __restrict__ pi_items,   // p * 8 + i of every (path, i < d_in), in path order
    const int* __restrict__ order,    // the slots by sender
    const int* __restrict__ cuts,     // (chunks + 1): chunk c is order[cuts[c] .. cuts[c + 1]]
    const int* __restrict__ d_ptr,    // (D + 1): extents into d_item per input element
    const int* __restrict__ d_item,   // f * 8 + i of every (channel, component) reading it
    float* __restrict__ part,         // (chunks, D)
    int K, int D, int S, int F, int n_paths, int TS, int GS, int n_pi, int n_items, int chunks,
    int wunit, int shw, int gvec, long long sh_elems) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool F32 = sizeof(T) == 4;
  const XiLayout L = xi_layout(D, F, n_paths, TS, GS, n_items, sizeof(T), LANES);
  float* s_t = smem + L.t;
  float* s_g = smem + L.g;
  int* s_pi = reinterpret_cast<int*>(smem + L.pi);
  int* s_rows = reinterpret_cast<int*>(smem + L.rows);
  int* s_dptr = reinterpret_cast<int*>(smem + L.dlist);
  int* s_ditem = s_dptr + pad4(D + 1);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int FP = w_pitch(F, sizeof(T));
  for (int i = tid; i < GS; i += nt) s_g[i] = gflat[i];
  for (int i = tid; i < n_pi; i += nt) s_pi[i] = pi_items[i];
  for (int i = tid; i <= D; i += nt) s_dptr[i] = d_ptr[i];
  for (int i = tid; i < n_items; i += nt) s_ditem[i] = d_item[i];
  int4 cm[XC];                                                // x_base, d_in, d_out, path
  int t_off[XC];
#pragma unroll
  for (int q = 0; q < XC; ++q) {
    const int f = tid + q * nt;
    cm[q] = f < F ? chan[f] : make_int4(0, 1, 1, 0);
    t_off[q] = f < F ? ptab[cm[q].w * PT_W + 7] : 0;
  }

  {
    const int c = blockIdx.x;
    const int c0 = cuts[c], cnt = cuts[c + 1] - c0;
    if (cnt <= 0) return;           // past the last chunk
    // the chunk's live slots, in order
    if (warp == 0) {
      const int e = lane < cnt ? order[c0 + lane] : 0;
      const bool on = lane < cnt && (__ldg(bits + (e >> 5)) >> (e & 31) & 1u);
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) s_rows[__popc(m & ((1u << lane) - 1u))] = e;
      if (lane == 0) s_rows[XI_Q] = __popc(m);
    }
    __syncthreads();
    const int n_live = s_rows[XI_Q];
    const int tiles = (n_live + XI_ROWS - 1) / XI_ROWS;

    // the t-th tile's rows of w and harmonics (warp = row) and its slots'
    // receivers' g rows (thread = (row, channel))
    auto load_tile = [&](int t) {
      if (t < tiles) {
        float* st = smem + (t % XI_STAGES) * L.stage;
        const int n = min(XI_ROWS, n_live - t * XI_ROWS);
        for (int r = warp; r < n; r += nwarps) {
          const long long e = s_rows[t * XI_ROWS + r];
          copy_row(reinterpret_cast<T*>(st + L.w) + r * FP, w + e * F, F, wunit, lane);
          float* srow = st + L.sh + r * XI_SHP;
          if (F32) {
            if (lane < S) cp_async4(srow + lane, sh + e * S + lane);
          } else if (shw) {   // the words covering elements e S .. e S + S - 1
            const long long w0 = (e * S) >> 1;
            if (lane < (int)(((e * S + S + 1) >> 1) - w0)) {
              const long long wd = w0 + lane;
              if (2 * wd + 2 <= sh_elems)
                cp_async4(srow + lane, reinterpret_cast<const unsigned*>(sh) + wd);
              else   // the tensor's last element, alone in its word
                reinterpret_cast<T*>(srow + lane)[0] = sh[2 * wd];
            }
          } else if (lane < S) {
            reinterpret_cast<T*>(srow)[lane] = sh[e * S + lane];
          }
        }
        for (int i = tid; i < n * F; i += nt) {
          const int r = i / F, ff = i - r * F;
          const float* src = g + ((size_t)(s_rows[t * XI_ROWS + r] / K) * F + ff) * LANES;
          float* d4 = st + L.g4 + (size_t)i * 4;
          if (gvec) {
            cp_async16(d4, src);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) cp_async4(d4 + k, src + k);
          }
          if (LANES == 8) cp_async4(st + L.g1 + i, src + 4);
        }
      }
      cp_async_commit();
    };

#pragma unroll 1
    for (int t = 0; t < XI_STAGES - 1; ++t) load_tile(t);
    float acc[XC][L2_K];
#pragma unroll
    for (int q = 0; q < XC; ++q)
#pragma unroll
      for (int i = 0; i < L2_K; ++i) acc[q][i] = 0.f;

    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<XI_STAGES - 2>();
      __syncthreads();                 // the tile has landed; the stage it replaces is read
      load_tile(t + XI_STAGES - 1);
      const float* st = smem + (t % XI_STAGES) * L.stage;
      const int* rows = s_rows + t * XI_ROWS;
      const int n = min(XI_ROWS, n_live - t * XI_ROWS);
      // t of every (row, path, i)
      for (int it = tid; it < n * n_pi; it += nt) {
        const int r = it / n_pi, pi = s_pi[it - r * n_pi];
        const int* pt = ptab + (pi >> 3) * PT_W;   // sh_off, d_in, d_sh, d_out, .., t_off, g_off
        const int i = pi & 7, d_sh = pt[2], d_out = pt[3];
        const float* G = s_g + pt[8] + i * d_sh * d_out;
        float* tq = s_t + r * TS + pt[7] + i * d_out;
        const float* srow = st + L.sh + r * XI_SHP;
        if (F32) {
          t_item(d_sh * 8 + d_out, tq, G, srow + pt[0]);
        } else {
          const T* svb = reinterpret_cast<const T*>(srow) +
                         (shw ? (int)(((long long)rows[r] * S) & 1) : 0);
          t_item(d_sh * 8 + d_out, tq, G, svb + pt[0]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < XC; ++q) {
        const int f = tid + q * nt;
        if (f >= F) continue;
        const T* wc = reinterpret_cast<const T*>(st + L.w) + f;
        const float* tq = s_t + t_off[q];
        const float4* g4 = reinterpret_cast<const float4*>(st + L.g4) + f;
        const float* g1 = st + L.g1 + f;
#define XI_WALK(DI, DO) xi_walk<DI, DO>(acc[q], wc, FP, tq, TS, g4, g1, F, n)
        switch (cm[q].y * 8 + cm[q].z) {
          case 011: XI_WALK(1, 1); break;
          case 013: XI_WALK(1, 3); break;
          case 015: XI_WALK(1, 5); break;
          case 031: XI_WALK(3, 1); break;
          case 033: XI_WALK(3, 3); break;
          case 035: XI_WALK(3, 5); break;
          case 051: XI_WALK(5, 1); break;
          case 053: XI_WALK(5, 3); break;
          default: XI_WALK(5, 5); break;
        }
#undef XI_WALK
      }
    }
    cp_async_wait<0>();

    // the channels that read one x element, added in the list's order
    __syncthreads();                   // the ring is free
    float* s_d = smem;                 // [i][f]
#pragma unroll
    for (int q = 0; q < XC; ++q) {
      const int f = tid + q * nt;
      if (f >= F) continue;
#pragma unroll
      for (int i = 0; i < L2_K; ++i) s_d[i * F + f] = acc[q][i];
    }
    __syncthreads();
    for (int d = tid; d < D; d += nt) {
      float sum = 0.f;
      for (int q = s_dptr[d]; q < s_dptr[d + 1]; ++q) {
        const int it = s_ditem[q];
        sum += s_d[(it & 7) * F + (it >> 3)];
      }
      part[(size_t)c * D + d] = sum;
    }
  }
}

// dx[r, d] = the sum over sender row r's chunks, in order, of part[c][d];
// zero for a sender no slot reads; rounded once.
template <typename T>
__global__ void tp_aggregate_bwd_x_idx_sum(const float* __restrict__ part,
                                           const int* __restrict__ row_ptr, T* __restrict__ dx,
                                           long long total, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long r = i / D;
  const int d = (int)(i - r * D);
  float s = 0.f;
  for (int c = row_ptr[r]; c < row_ptr[r + 1]; ++c) s += part[(size_t)c * D + d];
  dx[i] = from_f<T>(s);
}
bool bad_shape_l2(int B, int N, int M, int D, int S, int F, int n_paths) {
  return B < 1 || N < 1 || M < 1 || D < 1 || S < 1 || S > SH_STRIDE || F < 1 || n_paths < 1 ||
         n_paths > L2_MAX_PATHS || B > 65535;
}

// The sender-index mode's arguments: idx null means dense (Mx = M, 8 lanes).
bool bad_mode(const void* idx, int M, int Mx, int lanes) {
  return Mx < 1 || (lanes != 4 && lanes != 8) || (idx == nullptr && (Mx != M || lanes != 8));
}

// Threads of an 8-lane block: one per channel.
int threads_l2(int F) { return ((F + 31) / 32) * 32; }

size_t edge_bytes(bool dsh, int D, int F, int PT, int PS, int slots = EB_SLOTS) {
  return (size_t)edge_layout(dsh, D, F, PT, PS, slots).total * sizeof(float);
}

size_t xi_bytes(int D, int F, int n_paths, int TS, int GS, int n_items, int esize, int lanes) {
  return (size_t)xi_layout(D, F, n_paths, TS, GS, n_items, esize, lanes).total * sizeof(float);
}

// Allows the edge backward of operand type T (with or without dsh) all the
// shared memory an SM has, once per kernel.
template <typename T, bool DSH>
cudaError_t allow_edge() {
  static bool allowed = false;
  if (allowed) return cudaSuccess;
  const cudaError_t err = allow_shared(tp_aggregate_bwd_edge_l2_kernel<T, DSH>, MAX_SMEM);
  if (err == cudaSuccess) allowed = true;
  return err;
}

template <typename T>
int launch_bwd_edge_l2(const void* x, const void* sh, const void* w, const unsigned* bits,
                       const float* g, const int* pent, const float* gflat, const int* ptab,
                       const int* plan, const int* seg_ptr, const int* seg, float* Pg, void* dw,
                       void* dsh, int B, int N, int M, int D, int S, int F, int PT, int PS,
                       int plan_w, int rn, int slots, cudaStream_t st) {
  const bool with_dsh = dsh != nullptr;
  const size_t bytes = edge_bytes(with_dsh, D, F, PT, PS, slots);
  if (bytes > MAX_SMEM || PT % 4 != 0 || !aligned(Pg, 16)) return (int)cudaErrorInvalidValue;
  tp_aggregate_l2_p_kernel<<<(unsigned)(B * N), 256, 0, st>>>(
      g, reinterpret_cast<const int4*>(pent), gflat, Pg, F, PT);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + slots - 1) / slots, (N + rn - 1) / rn, B);
  const T* xt = static_cast<const T*>(x);
  const T* sht = static_cast<const T*>(sh);
  const int xpair = D % 2 == 0 && aligned(x, 4);
  const int vec = F % 4 == 0 && aligned(dw, 4 * sizeof(T)) &&
                  (!with_dsh || aligned(w, 4 * sizeof(T)));
  if (!with_dsh) {
    if ((err = allow_edge<T, false>()) != cudaSuccess) return (int)err;
    tp_aggregate_bwd_edge_l2_kernel<T, false><<<grid, EB_THREADS, bytes, st>>>(
        xt, sht, nullptr, nullptr, Pg, ptab, plan, nullptr, nullptr, static_cast<T*>(dw),
        nullptr, N, M, D, S, F, PT, PS, plan_w, rn, xpair, vec, slots);
  } else {
    if ((err = allow_edge<T, true>()) != cudaSuccess) return (int)err;
    tp_aggregate_bwd_edge_l2_kernel<T, true><<<grid, EB_THREADS, bytes, st>>>(
        xt, sht, static_cast<const T*>(w), bits, Pg, ptab, plan, seg_ptr,
        reinterpret_cast<const int2*>(seg), static_cast<T*>(dw), static_cast<T*>(dsh), N, M, D,
        S, F, PT, PS, plan_w, rn, xpair, vec, slots);
  }
  return (int)cudaGetLastError();
}

template <typename T, int LANES>
int launch_bwd_edge_idx(const void* x, const void* sh, const int* idx, const float* g,
                        const int* chan, const int* ptab, const float* gtab, void* dw, int B,
                        int N, int M, int Mx, int D, int S, int F, cudaStream_t st) {
  const dim3 grid((M + IDX_EDGE_SLOTS - 1) / IDX_EDGE_SLOTS, N, B);
  tp_aggregate_bwd_edge_idx_kernel<T, LANES><<<grid, min(threads_l2(F), L2_THREADS), 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(sh), idx, g,
      reinterpret_cast<const int4*>(chan), ptab, gtab, static_cast<T*>(dw), N, M, Mx, D, S, F);
  return (int)cudaGetLastError();
}

template <typename T, int LANES, int XC>
cudaError_t allow_xi() {
  static bool allowed = false;
  if (allowed) return cudaSuccess;
  const cudaError_t err = allow_shared(tp_aggregate_bwd_x_idx_l2_kernel<T, LANES, XC>, MAX_SMEM);
  if (err == cudaSuccess) allowed = true;
  return err;
}

constexpr int XI_XC = 3;   // channels a thread of the sender-index dx takes at most

// Threads of a block of the sender-index dx: a thread per channel, four
// warps at least (the tile's loads take a warp a row), L2_THREADS at most
// (wider rows: XI_XC channels a thread).
int xi_threads(int F) { return min(L2_THREADS, max(128, threads_l2(F))); }

template <typename T, int LANES>
int launch_bwd_x_idx_l2(const void* sh, const void* w, const float* g, const unsigned* bits,
                        const int* chan, const int* ptab, const float* gflat, const int* pi_items,
                        const int* order, const int* cuts, const int* row_ptr, const int* d_ptr,
                        const int* d_item, void* dx, float* part, int B, int N, int K, int Mx,
                        int D, int S, int F, int n_paths, int TS, int GS, int n_pi, int n_items,
                        int chunks, cudaStream_t st) {
  const size_t bytes = xi_bytes(D, F, n_paths, TS, GS, n_items, sizeof(T), LANES);
  if (bytes > MAX_SMEM || F > XI_XC * L2_THREADS) return (int)cudaErrorInvalidValue;
  const bool one = F <= L2_THREADS;   // a channel a thread
  cudaError_t err = one ? allow_xi<T, LANES, 1>() : allow_xi<T, LANES, XI_XC>();
  if (err != cudaSuccess) return (int)err;
  const long long sh_elems = (long long)B * N * K * S;
  if (chunks > 0) {
    const int wunit = row_unit(w, F, sizeof(T)), shw = sizeof(T) == 2 && aligned(sh, 4);
    if (one)
      tp_aggregate_bwd_x_idx_l2_kernel<T, LANES, 1><<<chunks, xi_threads(F), bytes, st>>>(
          static_cast<const T*>(sh), static_cast<const T*>(w), g, bits,
          reinterpret_cast<const int4*>(chan), ptab, gflat, pi_items, order, cuts, d_ptr, d_item,
          part, K, D, S, F, n_paths, TS, GS, n_pi, n_items, chunks, wunit, shw, aligned(g, 16),
          sh_elems);
    else
      tp_aggregate_bwd_x_idx_l2_kernel<T, LANES, XI_XC><<<chunks, xi_threads(F), bytes, st>>>(
          static_cast<const T*>(sh), static_cast<const T*>(w), g, bits,
          reinterpret_cast<const int4*>(chan), ptab, gflat, pi_items, order, cuts, d_ptr, d_item,
          part, K, D, S, F, n_paths, TS, GS, n_pi, n_items, chunks, wunit, shw, aligned(g, 16),
          sh_elems);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = (long long)B * Mx * D;
  tp_aggregate_bwd_x_idx_sum<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, row_ptr, static_cast<T*>(dx), total, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each function returns a cudaError_t value: 0 when the launches were accepted.
// `bf16` selects the type of x, sh and w (and of dw, dsh and dx): 0 f32, 1 bf16.

// `part` holds (splits, B, N, F, 4) floats when the senders are split
// (splits > 1), else it is not read.
int dp_tp_aggregate_fwd(const void* x, const void* sh, const void* w, const int* chan,
                        const int* ptab, const float* gtab, float* out, float* part, int B, int N,
                        int M, int D, int S, int F, int n_paths, int splits, int bf16,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, sh, w, chan, ptab, gtab, out, part, B, N, M, D, S, F,
                                          n_paths, splits, st)
              : launch_fwd<float>(x, sh, w, chan, ptab, gtab, out, part, B, N, M, D, S, F,
                                  n_paths, splits, st);
}

// dsh may be null: then only dw is computed, by the kernel that tiles receivers
// and senders (mt senders a block, 1 <= mt <= 16), and w, seg_ptr and seg are
// not read.  Else one kernel computes dw and dsh in one pass over w.
int dp_tp_aggregate_bwd_edge(const void* x, const void* sh, const void* w, const float* g,
                             const int* chan, const int* ptab, const float* gtab,
                             const int* seg_ptr, const int* seg, void* dw, void* dsh, int B,
                             int N, int M, int D, int S, int F, int n_paths, int mt, int n_seg,
                             int bf16, void* stream) {
  if (bad_shape(B, N, M, D, S, F, n_paths) || mt < 1 || mt > MT_MAX || n_seg < 0 ||
      (N + TN - 1) / TN > 65535 || N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_edge<__nv_bfloat16>(x, sh, w, g, chan, ptab, gtab, seg_ptr, seg, dw,
                                               dsh, B, N, M, D, S, F, n_paths, mt, n_seg, st)
              : launch_bwd_edge<float>(x, sh, w, g, chan, ptab, gtab, seg_ptr, seg, dw, dsh, B, N,
                                       M, D, S, F, n_paths, mt, n_seg, st);
}

// `part` holds (splits, B, M, D) floats when the receivers are split
// (splits > 1), else it is not read.
int dp_tp_aggregate_bwd_x(const void* sh, const void* w, const float* g, const int* chan,
                          const int* ptab, const float* gtab, const int* d_ptr, const int* d_item,
                          void* dx, float* part, int B, int N, int M, int D, int S, int F,
                          int n_paths, int n_items, int splits, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_x<__nv_bfloat16>(sh, w, g, chan, ptab, gtab, d_ptr, d_item, dx, part,
                                            B, N, M, D, S, F, n_paths, n_items, splits, st)
              : launch_bwd_x<float>(sh, w, g, chan, ptab, gtab, d_ptr, d_item, dx, part, B, N, M,
                                    D, S, F, n_paths, n_items, splits, st);
}

// Blocks of the forward (dx = 0) or dx kernel that one SM holds at once at
// these widths and operand type (n_items: the length of dx's d_item list), or
// minus a cudaError_t value.
int dp_tp_aggregate_blocks_per_sm(int dx, int D, int F, int n_paths, int n_items, int bf16) {
  return bf16 ? blocks_per_sm<__nv_bfloat16>(dx, D, F, n_paths, n_items)
              : blocks_per_sm<float>(dx, D, F, n_paths, n_items);
}

// The 8-lane kernels (l <= 2): out and g (B, N, F, 8).
//
// The dense forward and dx by channel tile: tables from
// tp_fused.tables_tiled_l2 (chan (F, 4), ptab (n_paths, 8), gflat, ctab
// (n_ct, 8), walk (F)) and their sizes (FTP, DXW, TS, GS, PC); dx's per-tile
// lists from tp_aggregate.dx_lists_l2 (dptr (n_ct, DXW + 1), ditem, NI the
// longest list); `bits`, the live pass's bits of w (dp_tp_aggregate_l2_live).
// `splits` of the summed axis (1 <= splits <= its length, at most 1,024
// summed entries a split); `part` holds the forward's (splits, B, N, F, 8)
// floats when splits > 1 and dx's (splits * n_ct, B, M, D) when splits > 1
// or n_ct > 1, else it is not read.  `wunit`: the cp.async piece (16, 8 or
// 4 bytes; 0 for plain loads) that divides a row of w, each tile's first
// channel and width, and w's address.

// `lanes`: 8, or 4 for a 4-lane forward or dx wider than the split kernels
// take (F > 256; out and g (B, N, F, 4)).
int dp_tp_aggregate_fwd_l2_tiled(const void* x, const void* sh, const void* w, const int* chan,
                                 const int* ptab, const float* gflat, const int* ctab,
                                 const int* walk, const unsigned* bits, float* out, float* part,
                                 int B, int N, int M, int D, int S, int F, int n_ct, int FTP,
                                 int DXW, int TS, int GS, int PC, int splits, int wunit, int lanes,
                                 int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes == 4)
    return bf16 ? launch_fwd_l2_tiled<__nv_bfloat16, 4>(x, sh, w, chan, ptab, gflat, ctab, walk,
                                                        bits, out, part, B, N, M, D, S, F, n_ct,
                                                        FTP, DXW, TS, GS, PC, splits, wunit, st)
                : launch_fwd_l2_tiled<float, 4>(x, sh, w, chan, ptab, gflat, ctab, walk, bits, out,
                                                part, B, N, M, D, S, F, n_ct, FTP, DXW, TS, GS,
                                                PC, splits, wunit, st);
  if (lanes != 8) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_fwd_l2_tiled<__nv_bfloat16, 8>(x, sh, w, chan, ptab, gflat, ctab, walk,
                                                      bits, out, part, B, N, M, D, S, F, n_ct, FTP,
                                                      DXW, TS, GS, PC, splits, wunit, st)
              : launch_fwd_l2_tiled<float, 8>(x, sh, w, chan, ptab, gflat, ctab, walk, bits, out,
                                              part, B, N, M, D, S, F, n_ct, FTP, DXW, TS, GS, PC,
                                              splits, wunit, st);
}

int dp_tp_aggregate_bwd_x_l2_tiled(const void* sh, const void* w, const float* g, const int* chan,
                                   const int* ptab, const float* gflat, const int* ctab,
                                   const int* walk, const unsigned* bits, const int* dptr,
                                   const int* ditem, void* dx, float* part, int B, int N, int M,
                                   int D, int S, int F, int n_ct, int FTP, int DXW, int TS, int GS,
                                   int PC, int NI, int splits, int wunit, int lanes, int bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes == 4)
    return bf16 ? launch_bwd_x_l2_tiled<__nv_bfloat16, 4>(sh, w, g, chan, ptab, gflat, ctab, walk,
                                                          bits, dptr, ditem, dx, part, B, N, M, D,
                                                          S, F, n_ct, FTP, DXW, TS, GS, PC, NI,
                                                          splits, wunit, st)
                : launch_bwd_x_l2_tiled<float, 4>(sh, w, g, chan, ptab, gflat, ctab, walk, bits,
                                                  dptr, ditem, dx, part, B, N, M, D, S, F, n_ct,
                                                  FTP, DXW, TS, GS, PC, NI, splits, wunit, st);
  if (lanes != 8) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_bwd_x_l2_tiled<__nv_bfloat16, 8>(sh, w, g, chan, ptab, gflat, ctab, walk,
                                                        bits, dptr, ditem, dx, part, B, N, M, D, S,
                                                        F, n_ct, FTP, DXW, TS, GS, PC, NI, splits,
                                                        wunit, st)
              : launch_bwd_x_l2_tiled<float, 8>(sh, w, g, chan, ptab, gflat, ctab, walk, bits,
                                                dptr, ditem, dx, part, B, N, M, D, S, F, n_ct, FTP,
                                                DXW, TS, GS, PC, NI, splits, wunit, st);
}

// The live pass of w (rows of F elements, rows = B N M): bits (rows + 31) /
// 32 words.  `unit`: the load piece (16, 8, 4 or the element's bytes), which
// must divide a row and w's address.
int dp_tp_aggregate_l2_live(const void* w, unsigned* bits, long long rows, int F, int unit,
                            int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_live<__nv_bfloat16>(w, bits, rows, F, unit, st)
              : launch_live<float>(w, bits, rows, F, unit, st);
}

// Bytes of shared memory a block of the tiled forward (dx = 0) or dx takes
// at these sizes and operand bytes (esize 4 or 2).
int dp_tp_aggregate_l2_smem(int dx, int FTP, int DXW, int TS, int GS, int PC, int NI, int esize) {
  return (int)tiled_bytes(dx != 0, FTP, DXW, TS, GS, PC, NI, esize);
}

// Blocks of the tiled forward (dx = 0) or dx that one SM holds at once at
// these sizes and operand type, or minus a cudaError_t value.
int dp_tp_aggregate_l2_blocks_per_sm(int dx, int FTP, int DXW, int TS, int GS, int PC, int NI,
                                     int lanes, int bf16) {
  if (lanes == 4)
    return bf16 ? tiled_blocks_per_sm<__nv_bfloat16, 4>(dx, FTP, DXW, TS, GS, PC, NI)
                : tiled_blocks_per_sm<float, 4>(dx, FTP, DXW, TS, GS, PC, NI);
  return bf16 ? tiled_blocks_per_sm<__nv_bfloat16, 8>(dx, FTP, DXW, TS, GS, PC, NI)
              : tiled_blocks_per_sm<float, 8>(dx, FTP, DXW, TS, GS, PC, NI);
}

// The sender-index mode (idx, or the dx lists, never null; x and dx (B, Mx,
// D), sh, w and dw (B, N, K, .) with K the slots).  `lanes` (4 or 8) is the
// floats of a channel in out and g.  The forward: the dense tiled
// forward's tables and sizes (tp_fused.tables_tiled_l2, tp_aggregate.walk_l2)
// and `bits`, the live pass's bits of w; `splits` of the slots (at most 64
// slots a split), `part` (splits, B, N, F, lanes) floats when splits > 1.

int dp_tp_aggregate_fwd_idx_tiled(const void* x, const void* sh, const void* w, const int* idx,
                                  const int* chan, const int* ptab, const float* gflat,
                                  const int* ctab, const int* walk, const unsigned* bits,
                                  float* out, float* part, int B, int N, int K, int Mx, int D,
                                  int S, int F, int n_ct, int FTP, int DXW, int TS, int GS, int PC,
                                  int splits, int wunit, int lanes, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes == 4)
    return bf16 ? launch_fwd_idx_tiled<__nv_bfloat16, 4>(x, sh, w, idx, chan, ptab, gflat, ctab,
                                                         walk, bits, out, part, B, N, K, Mx, D,
                                                         S, F, n_ct, FTP, DXW, TS, GS, PC, splits,
                                                         wunit, st)
                : launch_fwd_idx_tiled<float, 4>(x, sh, w, idx, chan, ptab, gflat, ctab, walk,
                                                 bits, out, part, B, N, K, Mx, D, S, F, n_ct, FTP,
                                                 DXW, TS, GS, PC, splits, wunit, st);
  if (lanes != 8) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_fwd_idx_tiled<__nv_bfloat16, 8>(x, sh, w, idx, chan, ptab, gflat, ctab,
                                                       walk, bits, out, part, B, N, K, Mx, D, S,
                                                       F, n_ct, FTP, DXW, TS, GS, PC, splits,
                                                       wunit, st)
              : launch_fwd_idx_tiled<float, 8>(x, sh, w, idx, chan, ptab, gflat, ctab, walk, bits,
                                               out, part, B, N, K, Mx, D, S, F, n_ct, FTP, DXW,
                                               TS, GS, PC, splits, wunit, st);
}

// Bytes of shared memory a block of the sender-index forward takes at these
// sizes and operand bytes (esize 4 or 2), and the blocks of it (lanes 4 or
// 8) that one SM holds at once, or minus a cudaError_t value.
int dp_tp_aggregate_idx_fwd_smem(int FTP, int DXW, int TS, int GS, int PC, int esize) {
  return (int)tiled_bytes(false, FTP, DXW, TS, GS, PC, 0, esize, true);
}

int dp_tp_aggregate_idx_fwd_blocks_per_sm(int FTP, int DXW, int TS, int GS, int PC, int lanes,
                                          int bf16) {
  if (lanes == 4)
    return bf16 ? idx_fwd_blocks_per_sm<__nv_bfloat16, 4>(FTP, DXW, TS, GS, PC)
                : idx_fwd_blocks_per_sm<float, 4>(FTP, DXW, TS, GS, PC);
  if (lanes != 8) return -(int)cudaErrorInvalidValue;
  return bf16 ? idx_fwd_blocks_per_sm<__nv_bfloat16, 8>(FTP, DXW, TS, GS, PC)
              : idx_fwd_blocks_per_sm<float, 8>(FTP, DXW, TS, GS, PC);
}

// The dense 8-lane edge backward: P of every receiver into Pg (B, N, PT)
// floats (tp_aggregate_l2_p_kernel, from the host's entry table pent (PT,
// 4) and gflat), then the edge kernel on tables from
// tp_aggregate.path_tables_l2 (ptab (n_paths, 12), PT and PS), its warps'
// paths (plan (8, plan_w)), the receivers a block takes (rn) and its
// senders (slots, 1 to 32).  dsh may be null: then only dw is computed and
// w, bits, seg_ptr and seg are not read.  bits: the live pass's bits of w,
// or null (every row of w read).
int dp_tp_aggregate_bwd_edge_l2(const void* x, const void* sh, const void* w,
                                const unsigned* bits, const float* g, const int* pent,
                                const float* gflat, const int* ptab, const int* plan,
                                const int* seg_ptr, const int* seg, float* Pg, void* dw,
                                void* dsh, int B, int N, int M, int D, int S, int F, int n_paths,
                                int PT, int PS, int plan_w, int rn, int slots, int bf16,
                                void* stream) {
  if (bad_shape_l2(B, N, M, D, S, F, n_paths) || slots < 1 || slots > EB_SLOTS ||
      (M + slots - 1) / slots > 65535 || PT < 4 || PS < 0 || plan_w < 1 || rn < 1 ||
      (N + rn - 1) / rn > 65535 || (long long)B * N > 0x7fffffffLL || Pg == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_edge_l2<__nv_bfloat16>(x, sh, w, bits, g, pent, gflat, ptab, plan,
                                                  seg_ptr, seg, Pg, dw, dsh, B, N, M, D, S, F,
                                                  PT, PS, plan_w, rn, slots, st)
              : launch_bwd_edge_l2<float>(x, sh, w, bits, g, pent, gflat, ptab, plan, seg_ptr,
                                          seg, Pg, dw, dsh, B, N, M, D, S, F, PT, PS, plan_w, rn,
                                          slots, st);
}

// The sender-index mode's dw (idx never null; x (B, Mx, D), sh and dw (B,
// N, M, .) with M the slots): tables from tp_fused.tables_l2 (chan (F, 4),
// ptab (n_paths, 8), gtab (n_paths, 5, 5, 5)); `lanes` (4 or 8) is the
// floats of a channel in g.
int dp_tp_aggregate_bwd_edge_idx(const void* x, const void* sh, const int* idx, const float* g,
                                 const int* chan, const int* ptab, const float* gtab, void* dw,
                                 int B, int N, int M, int Mx, int D, int S, int F, int n_paths,
                                 int lanes, int bf16, void* stream) {
  if (bad_shape_l2(B, N, M, D, S, F, n_paths) || N > 65535 || idx == nullptr ||
      bad_mode(idx, M, Mx, lanes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes == 4)
    return bf16 ? launch_bwd_edge_idx<__nv_bfloat16, 4>(x, sh, idx, g, chan, ptab, gtab, dw, B, N,
                                                        M, Mx, D, S, F, st)
                : launch_bwd_edge_idx<float, 4>(x, sh, idx, g, chan, ptab, gtab, dw, B, N, M, Mx,
                                                D, S, F, st);
  return bf16 ? launch_bwd_edge_idx<__nv_bfloat16, 8>(x, sh, idx, g, chan, ptab, gtab, dw, B, N, M,
                                                      Mx, D, S, F, st)
              : launch_bwd_edge_idx<float, 8>(x, sh, idx, g, chan, ptab, gtab, dw, B, N, M, Mx, D,
                                              S, F, st);
}

// The sender-index dx: the chunk kernel over `chunks` chunks (order, cuts
// and row_ptr from tp_aggregate.idx_dx_lists; bits, the live pass's bits
// of w), then the sum of each sender's chunks in order.  Tables from tp_aggregate.path_tables_l2 (TS floats of
// t a slot, GS coupling entries; pi_items, its n_pi (path, i) items) and
// d_ptr / d_item (entries f * 8 + i); `part` holds (chunks, D) floats.
int dp_tp_aggregate_bwd_x_idx_l2(const void* sh, const void* w, const float* g,
                                 const unsigned* bits, const int* chan, const int* ptab,
                                 const float* gflat, const int* pi_items, const int* order,
                                 const int* cuts, const int* row_ptr, const int* d_ptr,
                                 const int* d_item, void* dx, float* part, int B, int N, int K,
                                 int Mx, int D, int S, int F, int n_paths, int TS, int GS,
                                 int n_pi, int n_items, int chunks, int lanes, int bf16,
                                 void* stream) {
  if (bad_shape_l2(B, N, K, D, S, F, n_paths) || Mx < 1 || TS < 4 || TS % 4 != 0 || GS < 1 ||
      n_pi < 1 || n_pi > n_paths * L2_K || n_items < 1 || chunks < 0 || order == nullptr ||
      cuts == nullptr || row_ptr == nullptr || bits == nullptr || pi_items == nullptr ||
      (chunks > 0 && part == nullptr) || (lanes != 4 && lanes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes == 4)
    return bf16 ? launch_bwd_x_idx_l2<__nv_bfloat16, 4>(sh, w, g, bits, chan, ptab, gflat,
                                                        pi_items, order, cuts, row_ptr, d_ptr,
                                                        d_item, dx, part, B, N, K, Mx, D, S, F,
                                                        n_paths, TS, GS, n_pi, n_items, chunks,
                                                        st)
                : launch_bwd_x_idx_l2<float, 4>(sh, w, g, bits, chan, ptab, gflat, pi_items,
                                                order, cuts, row_ptr, d_ptr, d_item, dx, part, B,
                                                N, K, Mx, D, S, F, n_paths, TS, GS, n_pi, n_items,
                                                chunks, st);
  return bf16 ? launch_bwd_x_idx_l2<__nv_bfloat16, 8>(sh, w, g, bits, chan, ptab, gflat,
                                                      pi_items, order, cuts, row_ptr, d_ptr,
                                                      d_item, dx, part, B, N, K, Mx, D, S, F,
                                                      n_paths, TS, GS, n_pi, n_items, chunks, st)
              : launch_bwd_x_idx_l2<float, 8>(sh, w, g, bits, chan, ptab, gflat, pi_items, order,
                                              cuts, row_ptr, d_ptr, d_item, dx, part, B, N, K, Mx,
                                              D, S, F, n_paths, TS, GS, n_pi, n_items, chunks,
                                              st);
}

// Bytes of shared memory a block of the edge backward (dsh = 0 or 1) or of
// the sender-index dx's chunk kernel (operands of esize bytes, 4 or 2, and
// `lanes` floats of g a channel) takes at these sizes.
int dp_tp_aggregate_edge_l2_smem(int dsh, int D, int F, int PT, int PS, int slots) {
  return (int)edge_bytes(dsh != 0, D, F, PT, PS, slots);
}

int dp_tp_aggregate_idx_dx_l2_smem(int D, int F, int n_paths, int TS, int GS, int n_items,
                                   int esize, int lanes) {
  return (int)xi_bytes(D, F, n_paths, TS, GS, n_items, esize, lanes);
}

// Blocks of the edge backward (dsh = 0 or 1) that one SM holds at once at
// these sizes and operand type, or minus a cudaError_t value.
int dp_tp_aggregate_edge_l2_blocks_per_sm(int dsh, int D, int F, int PT, int PS, int slots,
                                          int bf16) {
  const size_t bytes = edge_bytes(dsh != 0, D, F, PT, PS, slots);
  cudaError_t err = dsh ? (bf16 ? allow_edge<__nv_bfloat16, true>() : allow_edge<float, true>())
                        : (bf16 ? allow_edge<__nv_bfloat16, false>() : allow_edge<float, false>());
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  if (dsh)
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_aggregate_bwd_edge_l2_kernel<__nv_bfloat16, true>, EB_THREADS, bytes)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_aggregate_bwd_edge_l2_kernel<float, true>, EB_THREADS, bytes);
  else
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_aggregate_bwd_edge_l2_kernel<__nv_bfloat16, false>, EB_THREADS, bytes)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, tp_aggregate_bwd_edge_l2_kernel<float, false>, EB_THREADS, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}
const char* dp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
