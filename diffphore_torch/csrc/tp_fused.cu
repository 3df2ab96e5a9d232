// K1: fused edge MLP + channelwise tensor-product aggregate, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   diffphore_tpu/ops/pallas/tp_fused.py::tp_aggregate_fused
// and computes the same function:
//   w[b,n,m,:]  = (sum_c relu(attr_c[b,n,m,:] W1 + b1) * mask_c[b,n,m]) W2
//                 + (sum_c mask_c[b,n,m]) b2
//   out[b,n,f,k] = sum_m w[b,n,m,f] * sum_{i,j} G_p(f)[i,j,k]
//                  * x[b,m,x_base(f)+i] * sh[b,n,m,sh_off(f)+j]
// where channel f belongs to tensor-product path p(f) and G_p = alpha_p * cg_p
// (Wigner-3j block, l_in, l_out <= 1, l_sh <= 2).  Output (B, N, F, 4) f32,
// component k < 3 of each channel, lane 3 zero.
//
// What bounds it on an H100.  The function reads every (receiver, sender)
// pair's attributes (C*E values), harmonics and masks once and writes a small
// output; the edge MLP (2*C*E*H + 2*H*F f32 flops) and the tensor product run
// only on live edges (a mask set), about a third of the grid on the serving
// inputs (corpus2, 40 poses of a 24x96x8 complex: padded atoms and phore points
// are dead).  Counted so, per conv family of a forward: the ligand-ligand convs
// (two attribute channels) and the phore-phore convs are bound by device memory
// at every width, and so are the two small heads (final_conv, tor_bond_conv);
// the phore-to-ligand convs are bound by memory at F = 40 and by f32 arithmetic
// from F = 80 up; the ligand-to-phore convs by memory at F = 40 and 80 and by
// arithmetic at F = 120: 8 of the 23 convs by arithmetic, 15 by bytes.  Either
// bound is 4 to 33 microseconds per call, so what the design has to remove is
// everything else: idle SMs (narrow grids), serial chains, shared-memory
// traffic per FMA, barriers per sender, and work on dead edges.
//
// Design.
//  * Grid = (sender split, tile of TN = 8 receivers, batch row).  The host
//    picks the senders per block so that every shape of the model gets about
//    two blocks per SM or more, also N = 1, N = 8 and B = 1; split k takes
//    senders k, k + splits, ..., because padded graphs keep their live senders
//    first and contiguous ranges would load the splits unevenly.  When the
//    senders are split the blocks write partial sums to a scratch buffer and a
//    second kernel adds the splits in a fixed order: no float atomics, two runs
//    agree to the bit.
//  * The edge MLP is two tiled matrix products over LIVE edges only.  A block
//    reads its masks once, compacts its live edges with warp ballots into one
//    list in receiver-major order, and takes them ROWS = 32 at a time: every
//    tile but the last is full, dead edges cost no load and no flop, and the
//    warps stay converged.
//  * W1, b1, W2, b2 and the block's sender features stay in shared memory for
//    the block's life; the hidden tile (written over the attribute rows it came
//    from) and the edge-weight tile never leave the chip.
//  * Register tiles: warp = 4 rows, lane = columns lane + 32 c.  The hidden
//    product keeps 4 x 2 sums per thread, the second 4 x NC (NC = F / 32
//    rounded up, a template bound); A and the hidden rows are read as float4
//    broadcasts, the weights conflict-free: 0.3 to 0.4 shared loads per FMA
//    instead of 2.  A warp reads only its own rows of both, so the two
//    products need no block barrier between them.
//  * A tile's attribute rows are gathered with 16-byte cp.async into a
//    two-stage ring, its harmonics with 4-byte ones: the next tile loads while
//    this one computes (bf16 inputs are converted on the way in with plain
//    loads).  The weights and sender features come in the same way, behind the
//    block's mask and compaction work.
//  * The tensor product in two steps.  Per (edge, path) of a tile, once for all
//    the path's channels: t[i,k] = sum_j G_p[i,j,k] sh[j].  Then thread =
//    channel f walks the tile's rows: w[r,f] * sum_i x[m(r), x_base(f)+i]
//    t[r,p(f)][i,:], 6 to 12 FMAs a row, no work per sender and no chain of
//    dependent loads.  The rows come receiver by receiver, so a thread keeps a
//    running sum and adds it to the receiver's three sums (registers, for the
//    whole block) when the receiver changes.
//  All arithmetic is f32 FMA (1e-7 of scale against the plain version).  x,
//  sh and attrs may be f32 or bf16; masks bool or f32, read as they come.
//  With bf16 inputs the kernel computes what the JAX package's bf16
//  convolution computes: W1, b1, W2 and b2 are rounded to bf16 as they come
//  into shared memory; the pre-activation is rounded after the product and
//  again after the bias, and each channel's edge weights likewise; the
//  channels then get a hidden tile and a second product each (the masked sum
//  is formed on the weights, rounded once, not on the hidden rows); the
//  host's tables hold alpha * bf16(cg).  Kernel and plain version then differ
//  only where f32 sums in another order flip a bf16 rounding.
//  Where it stands: 4 to 10 times its bound per conv.  A block has three or
//  four tiles of work on the serving shapes, so its start-up (masks, compaction,
//  the first gather: three round trips to device memory) is a quarter of its
//  life, and a tile waits on three barriers with eight warps a block; at
//  F = 160 the weights and tiles leave room for one block per SM only.  The
//  products are not the limit: run on the tensor cores (3xTF32 mma.sync, inside
//  the f32 tolerance) the kernel was 7 to 32% slower.
//
// The 8-lane kernel, tp_fused_l2_kernel: the same function where the irreps
// reach l = 2 (the second-order features): l_in, l_sh, l_out <= 2, output
// (B, N, F, 8) (lanes 5-7 zero).  The kernel above is left as it is for
// l <= 1.  At l = 2 a layer-3 convolution has F = 360 channels, 30 paths and
// D = 200 features a sender, and the edge MLP's second product (2 H F = 43,200
// flops an edge) is most of the arithmetic: f32 it is bound by operations
// from F = 180 up (bytes below), bf16 by bytes.  Its first version kept a W2
// column a thread (384 threads, one block an SM) and formed w[r, f] as one
// chain of H dependent FMAs a row: 5% of its f32 bound.
//  * Channel tiles.  The host cuts the channels at path boundaries into
//    tiles filled up to 128 (tp_fused.channel_tiles: 60 | 120 + 60 |
//    120 + 120 + 60 | 3 x 120 on the probe); a block takes one (batch row,
//    tile of L2_TN = 4 receivers, sender split of up to 96, channel tile)
//    and keeps only its tile's W2 columns, b2, coupling entries (flat,
//    d_in x d_sh x d_out a path) and t rows.  So W2 leaves the registers, the
//    shared memory stays under 113 KB (two blocks of eight warps an SM), and
//    the grid has the channel tiles as a factor (plan_senders counts them).
//    The hidden layer is computed once a tile (a quarter to a third of the
//    flops again at F = 360).  A block whose masks are all dead writes zeros
//    and loads no weight.
//  * Register tiles.  A warp takes two of a tile's L2_ROWS = 16 live rows:
//    the hidden layer with lane = units 2 lane, 2 lane + 1 (a float4 of
//    each row's attributes and a float2 of W1 a step: 4 independent sums),
//    then, f32, w[r, f] with lane = channels 2 lane + 64 j, + 1 (8
//    independent sums at 128 channels, 0.31 shared loads an FMA; one 64-
//    channel group for a tile of 64 or fewer), without a block barrier
//    between them (a warp reads only its own rows).  bf16: the hidden rows
//    and W2 (stored transposed, pitch 72: conflict-free fragment loads) are
//    bf16 values, so w = hid W2 runs on the tensor cores, mma.sync m16n8k16
//    with f32 sums over all 16 rows after one barrier.
//  * A cp.async ring.  Each tile's attribute rows, harmonics (f32) and its
//    rows' sender features (the tile's x slice [x_lo, x_lo + xw), in both
//    modes) are copied into the second of two stages while the first is
//    computed; bf16 operands stay bf16 in shared memory (8-byte copies) and
//    are widened where they are read.
//  * t[i][k] = sum_j G[i, j, k] sh[j] once a (row, path, i < d_in), rows
//    fastest so a warp shares one loop shape.  The walk: a thread per (tile
//    channel, part of the rows: two parts, four for a tile of up to 64
//    channels); the tile's channels are walked in the order of their (d_in,
//    d_out) (the host's walk order), so a warp runs one unrolled shape; each
//    row adds w x t into a running sum that moves into the receiver's five
//    sums when the receiver (a per-row table) changes; the parts' sums are
//    added in order at the end.
//  Exactness as above: the bf16 rounding points (W1, b1, W2, b2 rounded on
//  entry; pre-activation rounded after the product and after the bias; each
//  channel's edge weights rounded, summed and rounded), the receiver-major
//  compaction of live pairs, fixed-order split sums, no float atomics: two
//  runs agree to the bit.
//
// Sender-index mode (the KNN phore grid): an int32 index (B, N, K) names the
// sender of each (receiver, slot); the edge tensors are (B, N, K, ...), x is
// (B, M_x, D), and the function is the one above with the sum over slots:
//   out[b,n,f,k] = sum_s w[b,n,s,f] sum_{i,j} G x[b, idx[b,n,s], .] sh[b,n,s,.]
// A block of TN receivers has up to TN * K distinct sender rows (192 at K =
// 24, over MS_MAX), so in this mode a block keeps no sender features: each
// tile's rows bring their sender's features into the ring with their
// attributes and harmonics, and the split axis is the slot axis.  Dead slots
// are never gathered (the compaction drops them) and cost no flop.  Both
// kernels take the mode, tp_fused_kernel as a template flag IDX (l <= 1; its
// dense instantiations are as they were) and tp_fused_l2_kernel (l = 2) at
// run time: its rows' sender features ride the ring in either mode, so the
// index only changes which sender row a tile row copies.
//
// The wide kernels (a template flag WIDE on both; the model widths past
// corpus2's: ns up to 64, so E = H up to 192).  The narrow kernels above
// keep W1 (E x 64) and W2 in shared memory and form the hidden layer a
// lane's two units at a time, so they take H <= 64 and E, H multiples of
// four (4 lanes also F <= 160).  The wide kernels take any E, H <= 192 and
// share one edge MLP (wide_load, wide_chunk_f32 / _bf16, wide_finish_*).
// Their first version read W1 and W2 from device memory (L2) in every warp
// for the warp's own rows: eight times a tile, 32-136 times the tile's
// attribute bytes, with 2-4 FMAs a load and each bf16 weight rounded at
// every load.  So:
//  * Weights in shared memory, read from device memory once a block.  A
//    block keeps W1 and its channel tile's W2 columns for its life where
//    they fit beside its tiles (resident); else a two-stage ring holds one
//    chunk of hcw hidden units (W1[:, hc:hc+hcw], W2[hc:hc+hcw, tile]), the
//    next chunk copied while this one computes: once a tile for the whole
//    block.  tp_fused.plan picks resident, else the widest chunk (64, 32,
//    16 or 8 units) that fits, from the shapes alone: bf16 weights stay
//    resident on every conv of phase 19's models; f32 ones are staged with
//    two edge channels at E = 144 and at E = 192.  A chunk narrower than 64
//    keeps the 64-unit loop shape (lanes past the chunk compute nothing
//    kept): it only serves the f32 convs of the widest models, 8 units only
//    a 4-lane sender-index block of two edge channels, whose senders' rows
//    take the room (test_k1_wide_plan_picks_every_weight_form lists them).
//  * bf16 weights as bf16.  The ROUND path only ever uses bf16(w), so W1
//    and W2 are rounded once, as they enter shared memory, and stored
//    transposed (W^T [n][k] at a pitch of an odd number of 16-byte units:
//    ldmatrix rows meet no bank conflict), the attribute rows kept bf16 at
//    such a pitch.  Both products run on the tensor cores (mma.sync
//    m16n8k16, f32 sums): per channel, warp w forms hidden units hc + 8 w ..
//    + 7 of all the tile's rows, h_c = relu(bf16(bf16(A_c W1) + b1)) as bf16
//    rows; after a barrier, column tiles w + 8 j of h_c W2, summed over the
//    chunks in the mma's registers and rounded once; the rounding points
//    stay the JAX package's (above).
//  * f32 stays on FMA (3xTF32 was slower, above): per warp its rows (four
//    at 4 lanes, two at 8), lane = units 2 lane, 2 lane + 1 of a chunk (a
//    float2 of W1 and a float4 of each row's attributes a step), then
//    channels 2 lane + 64 j, + 1 (a float2 of W2 a step): 0.2-0.3 shared
//    loads an FMA, no block barrier while the weights are resident.
//  * Tiles of 128 channels at both lane counts (tp_fused.channel_tiles),
//    so a block's edge-weight rows are 64 or 128 wide; 32 live rows a tile
//    at 4 lanes; at 8 lanes 32 in bf16 (two m-tiles a weight fragment) and
//    16 in f32 (its weights and tiles fit beside each other).
//  * The 4-lane walk: a tile of 64 (128) channels splits its rows over four
//    (two) parts of the block's threads, the parts' sums added in order at
//    the end, as at 8 lanes.  Blocks with no live edge load no weight.
//  Kept from the first version: the live-edge compaction and the attribute
//  ring, the t step and the receiver-major walk, fixed-order split sums and
//  no float atomics (reruns agree to the bit), every unit formed whole over
//  E, and the sender-index mode of the 4-lane form.  What the wide kernels
//  do not take (E or H past 192, a path wider than a tile) raises.  Every
//  shipped convolution takes the narrow kernels, unchanged.
//  Where it stands (chip_smoke.py phase 19, the 23 convs of a 40-pose
//  forward, f32 / bf16, one run; NVIDIA H100 80GB HBM3, 700 W): 2.94 / 2.23
//  ms at ns / nv = 32 / 16 (6.7x / 14x the bound; the first version 7.05 /
//  9.44) and 14.23 / 9.24 at 48 / 10, l = 2 (13x / 36x; 38.34 / 56.26).
//  Kept because they measured faster (analysis/k1_wide_variants.py): both
//  bf16 products on the tensor cores (the first on FMA ran 1.6-1.8x slower), 32-row bf16
//  tiles at 8 lanes (16: 4% slower), the whole hidden layer in one pass
//  where bf16 weights are resident (64-unit chunks: 4% slower at 8 lanes),
//  one block an SM for the f32 4-lane form only (bf16: 8% slower; 8 lanes:
//  no gain).  What is left: in bf16 the edge MLP's latency (a few mma a
//  warp between barriers), the walk and each block's weight loads (at 8
//  lanes a block of four receivers loads ~80 KB of bf16 weights, four times
//  its attribute rows); in f32 the FMA products at one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int TN = 8;            // receivers per block
constexpr int ROWS = 32;         // live edges per tile
constexpr int MS_MAX = 128;      // senders per block
constexpr int HP = 64;           // padded hidden width (pitch of W1)
constexpr int SH_STRIDE = 12;    // padded harmonics row in shared memory
constexpr int J_MAX = 5;         // harmonic components of one path (l_sh <= 2)
constexpr int G_SIZE = 3 * J_MAX * 3;  // alpha*cg padded to (i < 3, j < 5, k < 3)
constexpr int T_SIZE = 12;       // t[i][k] of one (edge, path), k padded to 4
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RT = ROWS / WARPS;  // rows per warp = rows per thread tile
constexpr int NC_MAX = 5;         // F <= 160
constexpr int MAX_PATHS = 16;
constexpr int WIDE_MAX = 192;     // the wide kernel's E and H (ns <= 64)
constexpr int MAX_SMEM = 227 * 1024;

static_assert(RT == 4, "the register tiles assume four rows per warp");
static_assert(WARPS == TN, "the compaction gives each receiver a warp");
static_assert(THREADS / 8 == ROWS, "the gather gives each row eight threads");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
// v rounded to the nearest bf16, as f32.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}
// Four neighbouring elements of a staged row, as f32.
__device__ __forceinline__ float4 ld4s(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4s(const __nv_bfloat16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// A 16-byte (f32) or 8-byte (bf16) asynchronous copy of four elements.
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src) { cp_async16(dst, src); }
__device__ __forceinline__ void cp_async_quad(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  cp_async8(dst, src);
}

// d += a b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory (ldmatrix): lane l names row
// l % 8 of matrix l / 8; r[i] is matrix i's fragment (the mma's A operand).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// Two of them (lanes 0-15 name the rows): the mma's B operand from W^T rows.
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__host__ __device__ inline int pad_to(int n, int m) { return (n + m - 1) / m * m; }

// ---- the wide kernels' edge MLP (head note), shared by both lane counts ----

constexpr int WHC = 64;           // hidden units of a chunk (the most a staged one holds)
constexpr int WKB = 72;           // bf16 pitch of the hidden rows (conflict-free ldmatrix rows)
constexpr int WIDE_NT = 256;      // threads of a wide block (eight warps)

// Floats of shared memory the wide kernels' weights take (tp_fused.wide_weights):
// hcw = 0 resident (W1 and the tile's FTP W2 columns whole), else a
// two-stage ring of chunks of hcw hidden units.  f32 weights as they come
// (W1 [pad4(E)][pad4(H)], W2 [pad4(H)][FTP]; a chunk W1 [pad4(E)][hcw], W2
// [hcw][FTP]); bf16 rounded once and stored transposed as bf16 (W1^T
// [pad8(H)][pad16(E) + 8], W2^T [FTP][pad16(H) + 8]; a chunk W1^T
// [hcw][pad16(E) + 8], W2^T [FTP][hcw + 8]): rows at a pitch of an odd
// number of 16-byte units, so the fragment loads meet no bank conflict.
__host__ __device__ inline int wide_weights(int E, int H, int FTP, int esize, int hcw) {
  if (esize == 4)
    return hcw ? 2 * (pad4(E) * hcw + hcw * FTP) : pad4(E) * pad4(H) + pad4(H) * FTP;
  const int q1 = pad_to(E, 16) + 8;
  return hcw ? hcw * q1 + FTP * (hcw + 8) : (pad_to(H, 8) * q1 + FTP * (pad_to(H, 16) + 8)) / 2;
}
// bf16 elements of a hidden row: a staged chunk's (at most WHC units), or,
// with the weights resident, the whole hidden layer's (one chunk of H).
__host__ __device__ inline int wide_hid_pitch(int H, int hcw) {
  return hcw ? WKB : pad_to(H, 16) + 8;
}
// Elements of a staged attribute row: pad4(E) f32, pad16(E) + 8 bf16.
__host__ __device__ inline int wide_a_pitch(int E, int esize) {
  return esize == 4 ? pad4(E) : pad_to(E, 16) + 8;
}

// One hidden chunk's weights in shared memory: f32 W1[k][hc + u] at
// w1[k * p1 + u], W2[hc + u][n] at w2[u * FTP + n]; bf16 W1[k][hc + u] at
// w1t[u * q1 + k], W2[hc + u][n] at w2t[n * q2 + u].
struct WideChunk {
  const float* w1;
  const float* w2;
  const __nv_bfloat16* w1t;
  const __nv_bfloat16* w2t;
  int p1, q1, q2;
};

// Chunk hc of the resident weights (hcw = 0), or slot `slot` of the ring.
__device__ __forceinline__ WideChunk wide_chunk(const float* s_w, int E, int H, int FTP, bool bf,
                                                int hcw, int hc, int slot) {
  WideChunk v{};
  if (!bf) {
    if (hcw == 0) {
      v.w1 = s_w + hc;
      v.p1 = pad4(H);
      v.w2 = s_w + pad4(E) * pad4(H) + hc * FTP;
    } else {
      const float* base = s_w + slot * (pad4(E) * hcw + hcw * FTP);
      v.w1 = base;
      v.p1 = hcw;
      v.w2 = base + pad4(E) * hcw;
    }
    return v;
  }
  const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(s_w);
  v.q1 = pad_to(E, 16) + 8;
  if (hcw == 0) {
    v.w1t = sb + hc * v.q1;
    v.w2t = sb + pad_to(H, 8) * v.q1 + hc;
    v.q2 = pad_to(H, 16) + 8;
  } else {
    v.w1t = sb + slot * (hcw * v.q1 + FTP * (hcw + 8));
    v.w2t = v.w1t + hcw * v.q1;
    v.q2 = hcw + 8;
  }
  return v;
}

// The block's weights: all of them (hcw = 0), or chunk [hc, hc + hcw) into
// slot `slot` of the ring; the tile's columns f0 .. f0 + fc - 1 of W2, zero
// past H, E and fc where a product reads them.  f32 by cp.async (16-byte
// copies where rows allow), bf16 rounded once and transposed, with plain
// loads (they are then complete at the caller's next barrier).
template <bool BF>
__device__ void wide_load(float* s_w, const float* __restrict__ w1, const float* __restrict__ w2,
                          int E, int H, int F, int f0, int fc, int FTP, int hcw, int hc, int slot,
                          int tid) {
  const int u_end = hcw ? min(hcw, H - hc) : H;   // units of this load
  if constexpr (!BF) {
    const int u_all = hcw ? hcw : pad4(H);        // W1's pitch
    const int E4 = pad4(E);
    float* W1 = s_w + (hcw ? slot * (E4 * hcw + hcw * FTP) : 0);
    float* W2 = W1 + E4 * u_all;
    if (H % 4 == 0) {   // then u_end is a multiple of four too
      const int q = u_end / 4;
      for (int i = tid; i < E * q; i += WIDE_NT) {
        const int k = i / q, c = 4 * (i - k * q);
        cp_async16(W1 + k * u_all + c, w1 + (size_t)k * H + hc + c);
      }
    } else {
      for (int i = tid; i < E * u_end; i += WIDE_NT) {
        const int k = i / u_end, c = i - k * u_end;
        cp_async4(W1 + k * u_all + c, w1 + (size_t)k * H + hc + c);
      }
    }
    for (int i = tid; i < E * (u_all - u_end); i += WIDE_NT) {   // units past H
      const int k = i / (u_all - u_end);
      W1[k * u_all + u_end + i - k * (u_all - u_end)] = 0.f;
    }
    for (int i = tid; i < (E4 - E) * u_all; i += WIDE_NT) W1[E * u_all + i] = 0.f;   // k past E
    if (F % 4 == 0 && f0 % 4 == 0 && fc % 4 == 0) {
      const int q = FTP / 4;
      for (int i = tid; i < u_end * q; i += WIDE_NT) {
        const int k = i / q, c = 4 * (i - k * q);
        if (c < fc) cp_async16(W2 + k * FTP + c, w2 + (size_t)(hc + k) * F + f0 + c);
        else *reinterpret_cast<float4*>(W2 + k * FTP + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = tid; i < u_end * FTP; i += WIDE_NT) {
        const int k = i / FTP, c = i - k * FTP;
        if (c < fc) cp_async4(W2 + i, w2 + (size_t)(hc + k) * F + f0 + c);
        else W2[i] = 0.f;
      }
    }
    // rows past H up to the next multiple of four (the product reads them)
    for (int i = tid; i < (min(pad4(u_end), u_all) - u_end) * FTP; i += WIDE_NT)
      W2[u_end * FTP + i] = 0.f;
  } else {
    const int q1 = pad_to(E, 16) + 8;
    const int urows = hcw ? hcw : pad_to(H, 8);          // W1^T's rows
    const int q2 = hcw ? hcw + 8 : pad_to(H, 16) + 8;
    const int k2 = hcw ? min(hcw + 8, pad_to(u_end, 16)) : pad_to(H, 16);   // W2^T's columns read
    __nv_bfloat16* W1 = reinterpret_cast<__nv_bfloat16*>(s_w) +
                        (hcw ? slot * (hcw * q1 + FTP * (hcw + 8)) : 0);
    __nv_bfloat16* W2 = W1 + urows * q1;
    // a thread takes one row of W^T (consecutive threads, consecutive rows:
    // each load a coalesced row of W) and eight k, one 16-byte store
    auto put8 = [](__nv_bfloat16* dst, const float (&v)[8]) {
      uint4 q;
      unsigned* w = reinterpret_cast<unsigned*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        w[j] = *reinterpret_cast<const unsigned*>(&p);
      }
      *reinterpret_cast<uint4*>(dst) = q;
    };
    const int k8 = pad_to(E, 16) / 8;
#pragma unroll 2
    for (int i = tid; i < urows * k8; i += WIDE_NT) {
      const int u = i % urows, k = 8 * (i / urows);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = u < u_end && k + j < E ? w1[(size_t)(k + j) * H + hc + u] : 0.f;
      put8(W1 + u * q1 + k, v);
    }
#pragma unroll 2
    for (int i = tid; i < FTP * (k2 / 8); i += WIDE_NT) {
      const int n = i % FTP, k = 8 * (i / FTP);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = n < fc && k + j < u_end ? w2[(size_t)(hc + k + j) * F + f0 + n] : 0.f;
      put8(W2 + n * q2 + k, v);
    }
  }
}

// f32, one hidden chunk (kn units from hc), per warp: its RT rows r0 .. r0 +
// RT - 1 of the tile, lane = units 2 lane, 2 lane + 1 of the chunk, each
// formed whole over E: hid = sum_c mask_c relu(A_c W1 + b1) into the warp's
// rows of `hid` [RT][WHC], then wacc[i][j] (channels 2 lane + 64 j, + 1) +=
// hid W2 over the chunk.  A_c's rows at a + c * cstride + r * AP (f32,
// zero past E up to pad4(E)).
template <int RT, int NCH>
__device__ __forceinline__ void wide_chunk_f32(float (&wacc)[RT][NCH][2], const WideChunk& w,
                                               const float* a, int cstride, int AP, int C, int E,
                                               int kn, int hc, int r0, int rows, int groups,
                                               const float (&mrow)[2][RT], const float* s_b1,
                                               float* hid, int FTP, int lane) {
  const int u0 = 2 * lane;
  float hs[RT][2];
#pragma unroll
  for (int i = 0; i < RT; ++i) hs[i][0] = hs[i][1] = 0.f;
  const int E4 = pad4(E);
  for (int c = 0; c < C; ++c) {
    const float* A = a + c * cstride + r0 * AP;
    float pre[RT][2];
#pragma unroll
    for (int i = 0; i < RT; ++i) pre[i][0] = pre[i][1] = 0.f;
#pragma unroll 2
    for (int k = 0; k < E4; k += 4) {
      float4 av[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) av[i] = *reinterpret_cast<const float4*>(A + i * AP + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 wv = *reinterpret_cast<const float2*>(w.w1 + (k + kk) * w.p1 + u0);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
          pre[i][0] = fmaf(x, wv.x, pre[i][0]);
          pre[i][1] = fmaf(x, wv.y, pre[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      // rows past the tile's end: their mask is 0 and relu drops a NaN
      const float mc = c == 0 ? mrow[0][i] : mrow[1][i];
      hs[i][0] = fmaf(mc, fmaxf(pre[i][0] + s_b1[hc + u0], 0.f), hs[i][0]);
      hs[i][1] = fmaf(mc, fmaxf(pre[i][1] + s_b1[hc + u0 + 1], 0.f), hs[i][1]);
    }
  }
  __syncwarp();                                  // the last chunk's rows are read
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const bool ok = r0 + i < rows;
    *reinterpret_cast<float2*>(hid + i * WHC + u0) =
        make_float2(ok && u0 < kn ? hs[i][0] : 0.f, ok && u0 + 1 < kn ? hs[i][1] : 0.f);
  }
  __syncwarp();
#pragma unroll 2
  for (int k = 0; k < kn; k += 4) {
    float4 hv[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) hv[i] = *reinterpret_cast<const float4*>(hid + i * WHC + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float2 wv[NCH];
#pragma unroll
      for (int j = 0; j < NCH; ++j)
        wv[j] = j < groups ? *reinterpret_cast<const float2*>(w.w2 + (k + kk) * FTP + u0 + 64 * j)
                           : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float h = kk == 0 ? hv[i].x : kk == 1 ? hv[i].y : kk == 2 ? hv[i].z : hv[i].w;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          wacc[i][j][0] = fmaf(h, wv[j].x, wacc[i][j][0]);
          wacc[i][j][1] = fmaf(h, wv[j].y, wacc[i][j][1]);
        }
      }
    }
  }
}

// f32: the warp's rows of the edge weights, w = wacc + msum b2.
template <int RT, int NCH>
__device__ __forceinline__ void wide_finish_f32(const float (&wacc)[RT][NCH][2],
                                                const float (&mrow)[2][RT], int r0, int groups,
                                                const float* s_b2, float* s_wt, int FTP,
                                                int lane) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float msum = mrow[0][i] + mrow[1][i];
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (j >= groups) break;
      const int col = 2 * lane + 64 * j;
      const float2 bv = *reinterpret_cast<const float2*>(s_b2 + col);
      *reinterpret_cast<float2*>(s_wt + (r0 + i) * FTP + col) =
          make_float2(fmaf(msum, bv.x, wacc[i][j][0]), fmaf(msum, bv.y, wacc[i][j][1]));
    }
  }
}

// bf16, one hidden chunk (kn units from hc: a staged chunk, or the whole
// hidden layer where the weights are resident), the whole block on the
// tensor cores (mma.sync m16n8k16, f32 sums; every operand is a bf16 value):
// for each channel c, warp w forms units hc + 8 w .. + 7 and every 64th
// group after (two groups at a time) of the tile's MT x 16 rows, h_c =
// relu(bf16(bf16(A_c W1) + b1)), into the hidden rows (bf16 [c][row][hp]);
// after a barrier, warp w adds h_c W2 over the chunk into d[c][j][mt]
// (column tile w + 8 j of the tile's channels, m-tile mt).  Ends on a
// barrier: the hidden rows are free for the next chunk.
template <int MT, int NCH>
__device__ __forceinline__ void wide_chunk_bf16(float (&d)[2][NCH][MT][4], const WideChunk& w,
                                                const __nv_bfloat16* a, int AP, int C, int E,
                                                int kn, int hc, int rows, int groups,
                                                const float* s_b1, __nv_bfloat16* s_hidb, int hp,
                                                int lane, int warp) {
  constexpr int R = 16 * MT;
  const int g = lane >> 2, tq = lane & 3;
  const int ks1 = (E + 15) / 16;
  for (int c = 0; c < C; ++c) {
    // the warp's groups of eight units, two at a time (one A fragment for
    // both, four independent mma chains); up to the product's depth, zeros
    // past kn
    for (int ub0 = 8 * warp; ub0 < pad_to(kn, 16); ub0 += 128) {
      const bool on0 = ub0 < kn, on1 = ub0 + 64 < kn, in1 = ub0 + 64 < pad_to(kn, 16);
      float pre[2][MT][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          pre[j][mt][0] = pre[j][mt][1] = pre[j][mt][2] = pre[j][mt][3] = 0.f;
      if (on0) {
        const __nv_bfloat16* bp = w.w1t + (ub0 + (lane & 7)) * w.q1 + 8 * ((lane >> 3) & 1);
        const __nv_bfloat16* ap = a + ((size_t)c * R + (lane & 15)) * AP + 8 * (lane >> 4);
#pragma unroll 2
        for (int ks = 0; ks < ks1; ++ks) {
          unsigned b0[2], b1[2];
          ldsm_x2(b0, bp + 16 * ks);
          if (on1) ldsm_x2(b1, bp + 64 * w.q1 + 16 * ks);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            unsigned af[4];
            ldsm_x4(af, ap + 16 * mt * AP + 16 * ks);
            mma_bf16(pre[0][mt], af, b0);
            if (on1) mma_bf16(pre[1][mt], af, b1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !in1) break;
        const int ub = ub0 + 64 * j;
        const bool on = j == 0 ? on0 : on1;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {   // rows past the tile's end and units past H: 0
            const int r = 16 * mt + g + 8 * i, u = ub + 2 * tq;
            const bool ok = on && r < rows;
            const float h0 =
                ok && u < kn
                    ? fmaxf(bf16_round(bf16_round(pre[j][mt][2 * i]) + s_b1[hc + u]), 0.f)
                    : 0.f;
            const float h1 =
                ok && u + 1 < kn
                    ? fmaxf(bf16_round(bf16_round(pre[j][mt][2 * i + 1]) + s_b1[hc + u + 1]), 0.f)
                    : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(s_hidb + (c * R + r) * hp + u) =
                __floats2bfloat162_rn(h0, h1);
          }
      }
    }
  }
  __syncthreads();
  const int ks2 = (kn + 15) / 16;
  for (int c = 0; c < C; ++c) {
    for (int ks = 0; ks < ks2; ++ks) {
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], s_hidb + (c * R + 16 * mt + (lane & 15)) * hp + 16 * ks + 8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        if (j >= groups) break;
        unsigned b[2];
        ldsm_x2(b, w.w2t + ((warp + 8 * j) * 8 + (lane & 7)) * w.q2 + 16 * ks +
                       8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(d[c][j][mt], af[mt], b);
      }
    }
  }
  __syncthreads();
}

// bf16: the edge weights w = bf16(sum_c bf16(bf16(h_c W2) + b2) * mask_c),
// channel 0's term stored, channel 1's added by the same thread and rounded;
// maskf(c, r) the mask of row r (0 past the tile's end).
template <int MT, int NCH, typename MaskF>
__device__ __forceinline__ void wide_finish_bf16(const float (&d)[2][NCH][MT][4], int C, int groups,
                                                 const float* s_b2, float* s_wt, int FTP,
                                                 int lane, int warp, MaskF maskf) {
  const int g = lane >> 2, tq = lane & 3;
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (j >= groups) break;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = 16 * mt + g + 8 * (q >> 1), col = (warp + 8 * j) * 8 + 2 * tq + (q & 1);
          const float v = bf16_round(bf16_round(d[c][j][mt][q]) + s_b2[col]) * maskf(c, row);
          float* wt = s_wt + row * FTP + col;
          *wt = c == 0 ? v : bf16_round(*wt + v);
        }
    }
  }
}

// The shared-memory layout, in floats, the same on the host and the device
// (tp_fused.layout_bytes restates it).
struct Layout {
  int w1, b1, w2, b2, g, poff, x, mask, edges, a, wt, sh, t, hid, total;
};

// `idx`: the sender-index mode, whose sender features ride in the ring (two
// stages of ROWS rows) instead of the block's MS senders.  `wide`: the wide
// kernel (head note): NC = FTP / 32 (two or four: a channel tile pitch of 64
// or 128), its weights (wide_weights: resident, or a ring of chunks of hcw
// hidden units) instead of W1 and W2, b1 padded to whole chunks, attribute
// rows in the operands' type (esize bytes) at wide_a_pitch(E), the hidden
// rows of a chunk, and t of a channel tile's paths (at most tpaths) only.
__host__ __device__ inline Layout make_layout(int C, int E, int H, int D, int n_paths, int MS,
                                              int NC, bool idx, bool wide = false,
                                              int tpaths = 0, int esize = 4, int hcw = 0) {
  Layout L;
  int o = 0;
  L.w1 = o;    o += wide ? wide_weights(E, H, 32 * NC, esize, hcw) : E * HP;
  L.b1 = o;    o += wide ? pad_to(H, WHC) : HP;
  L.w2 = o;    o += wide ? 0 : H * 32 * NC;
  L.b2 = o;    o += 32 * NC;
  L.g = o;     o += pad4(n_paths * G_SIZE);
  L.poff = o;  o += MAX_PATHS;
  L.x = o;     o += (idx ? 2 * ROWS : MS) * pad4(D);
  L.mask = o;  o += C * TN * MS;
  L.edges = o; o += pad4(TN * MS / 2 + 1) + 12;   // the live edges (16 bits each), then 9 prefix counts
  L.a = o;     o += wide ? pad4((2 * C * ROWS * wide_a_pitch(E, esize) * esize + 3) / 4)
                         : 2 * C * ROWS * E;       // two stages
  L.wt = o;    o += ROWS * 32 * NC;
  L.sh = o;    o += 2 * ROWS * SH_STRIDE;         // two stages
  L.t = o;     o += ROWS * (wide ? tpaths : n_paths) * T_SIZE;
  L.hid = o;   o += wide ? (esize == 4 ? ROWS * WHC : C * ROWS * wide_hid_pitch(H, hcw) / 2) : 0;
  L.total = o;
  return L;
}

// (The f32 wide form asks for one block an SM: its block holds that much
// shared memory, and the registers it gains ran it 5% faster.)
template <typename T, int NC, bool IDX, bool WIDE>
__global__ void __launch_bounds__(THREADS, WIDE && sizeof(T) == 4 ? 1 : 2) tp_fused_kernel(
    const T* __restrict__ x,         // (B, M, D) sender features; IDX: (B, Mx, D)
    const T* __restrict__ sh,        // (B, N, M, S) edge harmonics
    const T* __restrict__ attr0,     // (B, N, M, E) edge attributes, channel 0
    const T* __restrict__ attr1,     // (B, N, M, E) channel 1 (read when C == 2)
    const void* __restrict__ mask0,  // (B, N, M) bool or f32
    const void* __restrict__ mask1,  // (B, N, M) (read when C == 2)
    const int* __restrict__ idx,     // IDX: (B, N, M) the sender of each slot
    const float* __restrict__ w1,    // (E, H)
    const float* __restrict__ b1,    // (H)
    const float* __restrict__ w2,    // (H, F)
    const float* __restrict__ b2,    // (F)
    const int4* __restrict__ chan,   // (F): x_base, d_in, sh_off, path
    const float* __restrict__ gtab,  // (n_paths, 3, J_MAX, 3)
    const int* __restrict__ ctab,    // WIDE: (n_ct, 4) each channel tile's f0, fc, p0, pc
    float* __restrict__ dst,         // out (B, N, F, 4), or the partial sums (splits, B, N, F, 4)
    int B, int N, int M, int Mx, int D, int S, int C, int E, int H, int F, int n_paths, int MS,
    int mask_is_f32, int n_ct, int tpaths, int hcw) {
  extern __shared__ __align__(16) float smem[];
  constexpr int FP = 32 * NC;
  constexpr bool ROUND = sizeof(T) == 2;   // the JAX package's bf16 convolution
  constexpr int NCH = NC / 2;              // WIDE: 64-channel groups of the tile pitch
  const Layout L = make_layout(C, E, H, D, n_paths, MS, NC, IDX, WIDE, tpaths, sizeof(T), hcw);
  const int AP = WIDE ? wide_a_pitch(E, sizeof(T)) : E;   // the attribute rows' pitch
  float* s_w1 = smem + L.w1;                                    // WIDE: the weights (wide_chunk)
  float* s_b1 = smem + L.b1;
  float* s_w2 = smem + L.w2;
  float* s_b2 = smem + L.b2;
  float* s_g = smem + L.g;
  int* s_poff = reinterpret_cast<int*>(smem + L.poff);          // sh_off of each path
  float* s_x = smem + L.x;                                      // [ml][DP]; IDX: [stage][row][DP]
  float* s_mask = smem + L.mask;                                // [c][nl * MS + ml]
  uint16_t* s_edges = reinterpret_cast<uint16_t*>(smem + L.edges);   // nl << 8 | ml, receiver-major
  int* s_pref = reinterpret_cast<int*>(smem + L.edges + pad4(TN * MS / 2 + 1));  // live edges before nl
  float* s_a = smem + L.a;                                      // [stage][c][row][E]
  T* s_at = reinterpret_cast<T*>(smem + L.a);                   // WIDE: [stage][c][row][AP]
  float* s_wt = smem + L.wt;                                    // [row][FP]
  float* s_sh = smem + L.sh;                                    // [stage][row][SH_STRIDE]
  float* s_t = smem + L.t;                                      // [row][path][i][4]
  float* s_hid = smem + L.hid;                                  // WIDE f32: [row][WHC]
  __nv_bfloat16* s_hidb = reinterpret_cast<__nv_bfloat16*>(s_hid);   // WIDE bf16: [c][row][WKB]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * TN;
  // the block's senders are m0, m0 + mstep, ...: interleaved with the other
  // splits'; WIDE: its channel tile ct (channels f0 .. f0 + fc - 1)
  const int ct = WIDE ? blockIdx.x % n_ct : 0;
  const int m0 = WIDE ? blockIdx.x / n_ct : blockIdx.x, mstep = WIDE ? gridDim.x / n_ct : gridDim.x;
  const int f0 = WIDE ? ctab[4 * ct] : 0, fc = WIDE ? ctab[4 * ct + 1] : F;
  // the paths whose t the block forms: WIDE its tile's
  const int p_lo = WIDE ? ctab[4 * ct + 2] : 0, n_tp = WIDE ? ctab[4 * ct + 3] : n_paths;
  const int ms = (M - m0 + mstep - 1) / mstep;   // senders of this block, <= MS
  const int DP = pad4(D);
  // WIDE: hidden units a chunk: staged, hcw; resident, all H (bf16) or WHC (f32)
  const int hstep = hcw ? hcw : ROUND ? H : WHC;

  // ---- resident operands: the weights and sender features (asynchronously:
  // they are first needed by the first tile's products), tables, masks.
  // Columns past H and F are never read back.  WIDE: the weights come after
  // the compaction, in blocks with live edges only; the attribute rows' pad
  // past E (to the products' depth) stays 0.
  if (WIDE) {
    const int ez = (ROUND ? pad_to(E, 16) : pad4(E)) - E;
    for (int i = tid; i < 2 * C * ROWS * ez; i += THREADS) {
      const int r = i / ez;
      s_at[(size_t)r * AP + E + i - r * ez] = T(0.f);
    }
  } else if (ROUND) {
    for (int i = tid; i < E * H; i += THREADS) s_w1[(i / H) * HP + i % H] = bf16_round(w1[i]);
    for (int i = tid; i < H * F; i += THREADS) s_w2[(i / F) * FP + i % F] = bf16_round(w2[i]);
  } else if (F % 4 == 0) {
    for (int i = tid; i < E * (H / 4); i += THREADS) {
      const int k = i / (H / 4), q = i - k * (H / 4);
      cp_async16(s_w1 + k * HP + 4 * q, w1 + k * H + 4 * q);
    }
    for (int i = tid; i < H * (F / 4); i += THREADS) {
      const int k = i / (F / 4), q = i - k * (F / 4);
      cp_async16(s_w2 + k * FP + 4 * q, w2 + k * F + 4 * q);
    }
  } else {
    for (int i = tid; i < E * H; i += THREADS) s_w1[(i / H) * HP + i % H] = w1[i];
    for (int i = tid; i < H * F; i += THREADS) s_w2[(i / F) * FP + i % F] = w2[i];
  }
  for (int ml = tid >> 3; ml < (IDX ? 0 : ms); ml += THREADS / 8) {
    const T* src = x + ((size_t)b * M + m0 + ml * mstep) * D;
    for (int d = tid & 7; d < D; d += 8) {
      if (sizeof(T) == 4) cp_async4(s_x + ml * DP + d, src + d);
      else s_x[ml * DP + d] = to_f(src[d]);
    }
  }
  cp_async_commit();
  const int HB = WIDE ? pad_to(H, WHC) : HP;
  for (int i = tid; i < HB; i += THREADS) s_b1[i] = i < H ? (ROUND ? bf16_round(b1[i]) : b1[i]) : 0.f;
  for (int i = tid; i < FP; i += THREADS)
    s_b2[i] = i < fc ? (ROUND ? bf16_round(b2[f0 + i]) : b2[f0 + i]) : 0.f;
  for (int i = tid; i < n_paths * G_SIZE; i += THREADS) s_g[i] = gtab[i];
  for (int i = tid; i < 2 * ROWS * SH_STRIDE; i += THREADS) s_sh[i] = 0.f;   // the pad lanes stay 0
  for (int i = tid; i < C * TN * MS; i += THREADS) {
    const int c = i / (TN * MS);
    const int r = i - c * TN * MS;
    const int nl = r / MS, ml = r - nl * MS;     // ml fastest: along M in memory
    const int n = n0 + nl;
    float v = 0.f;
    if (n < N && ml < ms) {
      const size_t at = ((size_t)b * N + n) * M + m0 + ml * mstep;
      const void* mp = c == 0 ? mask0 : mask1;
      v = mask_is_f32 ? static_cast<const float*>(mp)[at]
                      : (static_cast<const uint8_t*>(mp)[at] ? 1.f : 0.f);
    }
    s_mask[i] = v;
  }
  // the walk's thread: channel f of the tile; WIDE, a tile of cw = 64 or 128
  // channels takes THREADS / cw parts of its rows, f = tid % cw in part tid / cw
  const int cw = WIDE ? (fc > 64 ? 128 : 64) : THREADS;
  const int parts = THREADS / cw, part = tid / cw;
  const int f = tid % cw;
  const bool active = f < fc;
  const int4 cm = active ? chan[f0 + f] : make_int4(0, 0, 0, 0);
  if (WIDE) {   // every path's, also those of the other tiles (t is formed for all)
    for (int i = tid; i < F; i += THREADS) s_poff[chan[i].w] = chan[i].z;
  } else if (active) {
    s_poff[cm.w] = cm.z;                         // the same value from every channel of a path
  }
  __syncthreads();

  // ---- compaction: warp nl lists receiver nl's live senders, in order
  auto live_ballot = [&](int nl, int ml) {
    bool live = ml < MS && s_mask[nl * MS + ml] != 0.f;
    if (C == 2) live = live || (ml < MS && s_mask[TN * MS + nl * MS + ml] != 0.f);
    return __ballot_sync(0xffffffffu, live);
  };
  {
    int count = 0;
    for (int base = 0; base < MS; base += 32) count += __popc(live_ballot(warp, base + lane));
    if (lane == 0) s_pref[warp + 1] = count;
    if (tid == 0) s_pref[0] = 0;
  }
  __syncthreads();
  if (tid == 0)
    for (int nl = 0; nl < TN; ++nl) s_pref[nl + 1] += s_pref[nl];
  __syncthreads();
  {
    int at = s_pref[warp];
    for (int base = 0; base < MS; base += 32) {
      const unsigned bal = live_ballot(warp, base + lane);
      if (bal >> lane & 1)
        s_edges[at + __popc(bal & ((1u << lane) - 1))] = (uint16_t)(warp << 8 | (base + lane));
      at += __popc(bal);
    }
  }
  __syncthreads();
  const int total = s_pref[TN];

  // gather a tile's attribute rows and harmonics (asynchronously for f32
  // inputs; bf16 inputs are converted on the way in, WIDE: copied as bf16,
  // the harmonics into registers that put_sh stores at the tile's start, so
  // no thread waits on their loads); eight threads per row
  float shv[2];                                  // WIDE bf16: harmonics sub, sub + 8 of a row
  int sh_at = -1;                                // their row of s_sh, or none
  auto put_sh = [&]() {
    if (sh_at < 0) return;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      if ((tid & 7) + 8 * jj < S) s_sh[sh_at * SH_STRIDE + (tid & 7) + 8 * jj] = shv[jj];
    sh_at = -1;
  };
  auto gather_tile = [&](int stage, int first) {
    const int row = tid >> 3, sub = tid & 7;
    if (first + row >= total) return;
    const int e = s_edges[first + row];
    const size_t edge = ((size_t)b * N + n0 + (e >> 8)) * M + m0 + (e & 255) * mstep;
    for (int c = 0; c < C; ++c) {
      const T* src = (c == 0 ? attr0 : attr1) + edge * E;
      if (WIDE) {
        T* arow = s_at + ((size_t)(stage * C + c) * ROWS + row) * AP;
        if (E % 4 == 0) {
          for (int q = sub; q < E / 4; q += 8) cp_async_quad(arow + 4 * q, src + 4 * q);
        } else {   // rows not aligned to four elements
          for (int k = sub; k < E; k += 8) {
            if (sizeof(T) == 4) cp_async4(arow + k, src + k);
            else arow[k] = src[k];
          }
        }
        continue;
      }
      float* arow = s_a + ((size_t)(stage * C + c) * ROWS + row) * E;
      if (sizeof(T) == 4) {
        for (int q = sub; q < E / 4; q += 8) cp_async16(arow + 4 * q, src + 4 * q);
      } else {
        for (int k = sub; k < E; k += 8) arow[k] = to_f(src[k]);
      }
    }
    float* srow = s_sh + (stage * ROWS + row) * SH_STRIDE;
    if (WIDE && ROUND) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        shv[jj] = sub + 8 * jj < S ? to_f(sh[edge * S + sub + 8 * jj]) : 0.f;
      sh_at = stage * ROWS + row;
    } else {
      for (int j = sub; j < S; j += 8) {
        if (sizeof(T) == 4) cp_async4(srow + j, sh + edge * S + j);
        else srow[j] = to_f(sh[edge * S + j]);
      }
    }
    if (IDX) {   // the row's sender features
      const T* src = x + ((size_t)b * Mx + idx[edge]) * D;
      float* xrow = s_x + (stage * ROWS + row) * DP;
      for (int d = sub; d < D; d += 8) {
        if (sizeof(T) == 4) cp_async4(xrow + d, src + d);
        else xrow[d] = to_f(src[d]);
      }
    }
  };

  float acc[TN][3];
#pragma unroll
  for (int nl = 0; nl < TN; ++nl) acc[nl][0] = acc[nl][1] = acc[nl][2] = 0.f;
  // the running sums of the receiver whose rows are being walked
  int cur = 0;
  float r0s = 0.f, r1s = 0.f, r2s = 0.f;
  auto flush = [&](int to) {
#pragma unroll
    for (int nl = 0; nl < TN; ++nl) {
      if (nl == cur) {
        acc[nl][0] += r0s;
        acc[nl][1] += r1s;
        acc[nl][2] += r2s;
      }
    }
    cur = to;
    r0s = r1s = r2s = 0.f;
  };

  gather_tile(0, 0);
  if (WIDE && total > 0)   // the weights, or the ring's first chunk, behind the first tile's rows
    wide_load<ROUND>(s_w1, w1, w2, E, H, F, f0, fc, FP, hcw, 0, 0, tid);
  cp_async_commit();

  for (int first = 0, stage = 0, tile = 0; first < total; first += ROWS, stage ^= 1, ++tile) {
    const int rows = min(ROWS, total - first);
    if (!WIDE || hcw == 0) {   // the ring holds the tiles; WIDE staged: it steps by chunks below
      put_sh();                                    // this tile's harmonics (WIDE bf16)
      gather_tile(stage ^ 1, first + ROWS);        // the next tile's loads
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }

    // ---- t[r, p][i, k] = sum_j G_p[i, j, k] sh[r, sh_off(p) + j]
    auto t_step = [&]() {
      for (int i = tid; i < rows * n_tp; i += THREADS) {
        const int r = i / n_tp, p = p_lo + i - r * n_tp;
        const float* G = s_g + p * G_SIZE;
        const float* sv = s_sh + (stage * ROWS + r) * SH_STRIDE + s_poff[p];
        float svj[J_MAX];
#pragma unroll
        for (int j = 0; j < J_MAX; ++j) svj[j] = sv[j];
        float* tp = s_t + (size_t)i * T_SIZE;
#pragma unroll
        for (int ii = 0; ii < 3; ++ii) {
          float tk[3] = {0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < J_MAX; ++j)
#pragma unroll
            for (int k = 0; k < 3; ++k) tk[k] = fmaf(G[(ii * J_MAX + j) * 3 + k], svj[j], tk[k]);
          *reinterpret_cast<float4*>(tp + 4 * ii) = make_float4(tk[0], tk[1], tk[2], 0.f);
        }
      }
    };

    const int r0 = warp * RT;
    // the mask of the tile's row r in channel c (0 past the tile's end)
    auto row_mask = [&](int c, int r) {
      if (r >= rows || c >= C) return 0.f;
      const int e = s_edges[first + r];
      return s_mask[c * TN * MS + (e >> 8) * MS + (e & 255)];
    };
    if constexpr (WIDE) {
      // The edge MLP chunk by chunk from weights in shared memory (head
      // note), then t.  f32: hid = sum_c mask_c relu(A_c W1 + b1), w = hid W2
      // + msum b2, per warp (its RT rows); bf16 on the tensor cores, channel
      // by channel: w = bf16(sum_c bf16(bf16(h_c W2) + b2) mask_c), h_c =
      // relu(bf16(bf16(A_c W1) + b1)).
      const int groups = fc > 64 ? NCH : 1;
      const T* a_t = s_at + (size_t)stage * C * ROWS * AP;
      float mrow[2][RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        mrow[0][i] = row_mask(0, r0 + i);
        mrow[1][i] = row_mask(1, r0 + i);
      }
      float wacc[RT][NCH][2];
      float d[2][NCH][2][4];
      if constexpr (ROUND) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int j = 0; j < NCH; ++j)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              d[c][j][mt][0] = d[c][j][mt][1] = d[c][j][mt][2] = d[c][j][mt][3] = 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < NCH; ++j) wacc[i][j][0] = wacc[i][j][1] = 0.f;
      }
      const int steps = (H + hstep - 1) / hstep;
      for (int q = 0; q < steps; ++q) {
        const int hc = q * hstep, slot = (tile * steps + q) & 1;
        if (hcw) {
          // the ring: the next step's chunk into the other slot (the next
          // tile's first after this tile's last), the next tile's rows with
          // this tile's first chunk; then this step's are complete
          const bool last = q + 1 == steps;
          if (!last || first + ROWS < total)
            wide_load<ROUND>(s_w1, w1, w2, E, H, F, f0, fc, FP, hcw, last ? 0 : hc + hcw, slot ^ 1,
                             tid);
          if (q == 0) {
            put_sh();
            gather_tile(stage ^ 1, first + ROWS);
          }
          cp_async_commit();
          cp_async_wait<1>();
          __syncthreads();
        }
        const WideChunk wc = wide_chunk(s_w1, E, H, FP, ROUND, hcw, hc, slot);
        const int kn = min(hstep, H - hc);
        if constexpr (ROUND) {
          wide_chunk_bf16<2, NCH>(d, wc, reinterpret_cast<const __nv_bfloat16*>(a_t), AP, C, E, kn,
                                  hc, rows, groups, s_b1, s_hidb, wide_hid_pitch(H, hcw), lane,
                                  warp);
        } else {
          if (r0 < rows)
            wide_chunk_f32<RT, NCH>(wacc, wc, reinterpret_cast<const float*>(a_t), ROWS * AP, AP,
                                    C, E, kn, hc, r0, rows, groups, mrow, s_b1, s_hid + r0 * WHC,
                                    FP, lane);
          if (hcw) __syncthreads();              // every warp is done with this slot
        }
      }
      if constexpr (ROUND) {
        wide_finish_bf16<2, NCH>(d, C, groups, s_b2, s_wt, FP, lane, warp, row_mask);
      } else {
        if (r0 < rows) wide_finish_f32<RT, NCH>(wacc, mrow, r0, groups, s_b2, s_wt, FP, lane);
      }
      t_step();
    } else {
      t_step();
    }
    if (!WIDE && r0 < rows) {
      float mrow[2][RT];                          // the rows' masks; 0 past the tile's end
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const bool ok = r0 + i < rows;
        const int e = ok ? s_edges[first + r0 + i] : 0;
        const int at = (e >> 8) * MS + (e & 255);
        mrow[0][i] = ok ? s_mask[at] : 0.f;
        mrow[1][i] = ok && C == 2 ? s_mask[TN * MS + at] : 0.f;
      }
      if constexpr (ROUND) {
        // the JAX package's bf16 convolution, channel by channel:
        // h_c = relu(bf16(bf16(A_c W1) + b1)), in place of the warp's rows of A_c
        for (int c = 0; c < C; ++c) {
          float* A = s_a + ((size_t)(stage * C + c) * ROWS + r0) * E;
          float pre[RT][2];
#pragma unroll
          for (int i = 0; i < RT; ++i) pre[i][0] = pre[i][1] = 0.f;
#pragma unroll 5
          for (int k = 0; k < E; k += 4) {
            float4 av[RT];
#pragma unroll
            for (int i = 0; i < RT; ++i) av[i] = *reinterpret_cast<const float4*>(A + i * E + k);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float wa = s_w1[(k + kk) * HP + lane];
              const float wb = s_w1[(k + kk) * HP + lane + 32];
#pragma unroll
              for (int i = 0; i < RT; ++i) {
                const float a = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
                pre[i][0] = fmaf(a, wa, pre[i][0]);
                pre[i][1] = fmaf(a, wb, pre[i][1]);
              }
            }
          }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            // rows past the tile's end hold stale data: written as zeros
            const bool ok = r0 + i < rows;
            const float h0 = fmaxf(bf16_round(bf16_round(pre[i][0]) + s_b1[lane]), 0.f);
            const float h1 = fmaxf(bf16_round(bf16_round(pre[i][1]) + s_b1[lane + 32]), 0.f);
            if (lane < H) A[i * E + lane] = ok ? h0 : 0.f;
            if (lane + 32 < H) A[i * E + lane + 32] = ok ? h1 : 0.f;
          }
          __syncwarp();
        }
        // w = bf16(sum_c bf16(bf16(h_c W2) + b2) * mask_c): channel 0's term
        // is stored, channel 1's added to it by the same thread and rounded
        for (int c = 0; c < C; ++c) {
          const float* hid = s_a + ((size_t)(stage * C + c) * ROWS + r0) * E;
          float wacc[RT][NC];
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) wacc[i][cc] = 0.f;
#pragma unroll 5
          for (int k = 0; k < H; k += 4) {
            float4 hv[RT];
#pragma unroll
            for (int i = 0; i < RT; ++i) hv[i] = *reinterpret_cast<const float4*>(hid + i * E + k);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              float wv[NC];
#pragma unroll
              for (int cc = 0; cc < NC; ++cc) wv[cc] = s_w2[(k + kk) * FP + lane + 32 * cc];
#pragma unroll
              for (int i = 0; i < RT; ++i) {
                const float h = kk == 0 ? hv[i].x : kk == 1 ? hv[i].y : kk == 2 ? hv[i].z : hv[i].w;
#pragma unroll
                for (int cc = 0; cc < NC; ++cc) wacc[i][cc] = fmaf(h, wv[cc], wacc[i][cc]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float mc = c == 0 ? mrow[0][i] : mrow[1][i];
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
              float* wt = s_wt + (r0 + i) * FP + lane + 32 * cc;
              const float v = bf16_round(bf16_round(wacc[i][cc]) + s_b2[lane + 32 * cc]) * mc;
              *wt = c == 0 ? v : bf16_round(*wt + v);
            }
          }
        }
      } else {
        // ---- hid[r, h] = sum_c mask_c[r] relu(A_c[r, :] W1 + b1)[h]
        float hs[RT][2];
  #pragma unroll
        for (int i = 0; i < RT; ++i) hs[i][0] = hs[i][1] = 0.f;
        for (int c = 0; c < C; ++c) {
          const float* A = s_a + ((size_t)(stage * C + c) * ROWS + r0) * E;
          float pre[RT][2];
  #pragma unroll
          for (int i = 0; i < RT; ++i) pre[i][0] = pre[i][1] = 0.f;
  #pragma unroll 5
          for (int k = 0; k < E; k += 4) {
            float4 av[RT];
  #pragma unroll
            for (int i = 0; i < RT; ++i) av[i] = *reinterpret_cast<const float4*>(A + i * E + k);
  #pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float wa = s_w1[(k + kk) * HP + lane];
              const float wb = s_w1[(k + kk) * HP + lane + 32];
  #pragma unroll
              for (int i = 0; i < RT; ++i) {
                const float a = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
                pre[i][0] = fmaf(a, wa, pre[i][0]);
                pre[i][1] = fmaf(a, wb, pre[i][1]);
              }
            }
          }
  #pragma unroll
          for (int i = 0; i < RT; ++i) {
            // rows past the tile's end hold stale data: their mask is 0 and relu drops a NaN
            const float mc = c == 0 ? mrow[0][i] : mrow[1][i];
            hs[i][0] = fmaf(mc, fmaxf(pre[i][0] + s_b1[lane], 0.f), hs[i][0]);
            hs[i][1] = fmaf(mc, fmaxf(pre[i][1] + s_b1[lane + 32], 0.f), hs[i][1]);
          }
        }
        // the hidden rows take the place of the warp's own rows of A (H <= E)
        float* hid = s_a + ((size_t)(stage * C) * ROWS + r0) * E;
        __syncwarp();
  #pragma unroll
        for (int i = 0; i < RT; ++i) {
          const bool ok = r0 + i < rows;
          if (lane < H) hid[i * E + lane] = ok ? hs[i][0] : 0.f;
          if (lane + 32 < H) hid[i * E + lane + 32] = ok ? hs[i][1] : 0.f;
        }
        __syncwarp();

        // ---- w[r, f] = hid[r, :] W2 + msum[r] b2
        float wacc[RT][NC];
  #pragma unroll
        for (int i = 0; i < RT; ++i)
  #pragma unroll
          for (int c = 0; c < NC; ++c) wacc[i][c] = 0.f;
  #pragma unroll 5
        for (int k = 0; k < H; k += 4) {
          float4 hv[RT];
  #pragma unroll
          for (int i = 0; i < RT; ++i)
            hv[i] = *reinterpret_cast<const float4*>(hid + i * E + k);
  #pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float wv[NC];
  #pragma unroll
            for (int c = 0; c < NC; ++c) wv[c] = s_w2[(k + kk) * FP + lane + 32 * c];
  #pragma unroll
            for (int i = 0; i < RT; ++i) {
              const float h = kk == 0 ? hv[i].x : kk == 1 ? hv[i].y : kk == 2 ? hv[i].z : hv[i].w;
  #pragma unroll
              for (int c = 0; c < NC; ++c) wacc[i][c] = fmaf(h, wv[c], wacc[i][c]);
            }
          }
        }
  #pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float msum = mrow[0][i] + mrow[1][i];
  #pragma unroll
          for (int c = 0; c < NC; ++c)
            s_wt[(r0 + i) * FP + lane + 32 * c] = fmaf(msum, s_b2[lane + 32 * c], wacc[i][c]);
        }
      }
    }
    __syncthreads();

    // ---- the channel's share of its part of the rows, summed receiver by receiver
    if (active) {
      const int rb = part * (ROWS / parts), re = min(rows, rb + ROWS / parts);
#pragma unroll 4
      for (int r = rb; r < re; ++r) {
        const int e = s_edges[first + r];
        if ((e >> 8) != cur) flush(e >> 8);
        const float w = s_wt[r * FP + f];
        const float* xr = s_x + (IDX ? (stage * ROWS + r) : (e & 255)) * DP + cm.x;
        const float* tp = s_t + (r * n_tp + cm.w - p_lo) * T_SIZE;
        const float4 t0 = *reinterpret_cast<const float4*>(tp);
        const float g0 = w * xr[0];
        r0s = fmaf(g0, t0.x, r0s);
        r1s = fmaf(g0, t0.y, r1s);
        r2s = fmaf(g0, t0.z, r2s);
        if (cm.y == 3) {
          const float4 t1 = *reinterpret_cast<const float4*>(tp + 4);
          const float4 t2 = *reinterpret_cast<const float4*>(tp + 8);
          const float g1 = w * xr[1], g2 = w * xr[2];
          r0s = fmaf(g2, t2.x, fmaf(g1, t1.x, r0s));
          r1s = fmaf(g2, t2.y, fmaf(g1, t1.y, r1s));
          r2s = fmaf(g2, t2.z, fmaf(g1, t1.z, r2s));
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (active) flush(0);

  // WIDE: the other parts' sums, added to part 0's in order (over the
  // attribute ring and the edge-weight tile, free now)
  float* red = smem + L.a;                                      // [nl][cw][3]
  for (int q = 1; q < parts; ++q) {
    __syncthreads();
    if (active && part == q) {
#pragma unroll
      for (int nl = 0; nl < TN; ++nl)
#pragma unroll
        for (int k = 0; k < 3; ++k) red[(nl * cw + f) * 3 + k] = acc[nl][k];
    }
    __syncthreads();
    if (active && part == 0) {
#pragma unroll
      for (int nl = 0; nl < TN; ++nl)
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[nl][k] += red[(nl * cw + f) * 3 + k];
    }
  }
  if (active && part == 0) {
    float4* o = reinterpret_cast<float4*>(dst) + (size_t)m0 * B * N * F + f0;
#pragma unroll
    for (int nl = 0; nl < TN; ++nl) {
      const int n = n0 + nl;
      if (n < N) o[((size_t)b * N + n) * F + f] = make_float4(acc[nl][0], acc[nl][1], acc[nl][2], 0.f);
    }
  }
}

// out[i] = sum over the sender splits, in order.
__global__ void tp_fused_kernel_sum_splits(const float4* __restrict__ part, float4* __restrict__ out,
                                       int total, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float4 s = part[i];
  for (int k = 1; k < splits; ++k) {
    const float4 v = part[(size_t)k * total + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
  }
  s.w = 0.f;
  out[i] = s;
}

// ---- the 8-lane kernel (irreps up to l = 2; head note) ----

constexpr int L2_THREADS = 256;   // eight warps
constexpr int L2_WARPS = L2_THREADS / 32;
constexpr int L2_TN = 4;          // receivers per block
constexpr int L2_ROWS = 16;       // live edges per tile: two a warp
constexpr int L2_RW = L2_ROWS / L2_WARPS;
constexpr int L2_MS_MAX = 96;     // senders per block: a 96-point phore in one split
constexpr int L2_HP = 64;         // padded hidden width: two units a lane
constexpr int L2_KB = 72;         // bf16 pitch of W2^T and the hidden rows (conflict-free mma loads)
constexpr int L2_K = 5;           // components of an l <= 2 irrep
constexpr int L2_MAX_PATHS = 32;
constexpr int L2_SMEM = 113 * 1024;   // two blocks an SM
// live edges per tile of the wide kernel: f32 16 (its weights and tiles fit
// beside each other), bf16 32 (two m-tiles a weight fragment)
constexpr int L2_WIDE_ROWS_F32 = 16;
constexpr int L2_WIDE_ROWS_BF16 = 32;
__host__ __device__ constexpr int l2_rows(bool wide, int esize) {
  return wide ? (esize == 2 ? L2_WIDE_ROWS_BF16 : L2_WIDE_ROWS_F32) : L2_ROWS;
}

static_assert(L2_RW == 2, "the hidden layer and the edge-weight product take two rows a warp");
static_assert(L2_THREADS / 16 == L2_ROWS, "the gather gives each row sixteen threads");

// The 8-lane kernel's shared memory, in floats (every piece 16-byte aligned);
// `esize` the operands' bytes (the staged attribute and feature rows keep
// their type).  dp_tp_fused_l2_smem returns its size to the wrapper.
struct LayoutL2 {
  int w1, b1, w2, b2, g, ptab, pi, mask, edges, wcnt, rn, a, sh, x, hid, wt, t, total;
};

__host__ __device__ inline LayoutL2 make_layout_l2(int C, int E, int H, int DX, int TS, int GS,
                                                   int PC, int MS, int FTP, int esize,
                                                   bool wide = false, int hcw = 0) {
  LayoutL2 L;
  int o = 0;
  const int rows = l2_rows(wide, esize);
  // the wide kernel: its weights (wide_weights) instead of W1 and W2 (head note)
  const int EP = wide ? wide_a_pitch(E, esize) : E;
  L.w1 = o;    o += wide ? wide_weights(E, H, FTP, esize, hcw) : E * L2_HP;
  L.b1 = o;    o += wide ? pad_to(H, WHC) : L2_HP;
  L.w2 = o;    o += wide ? 0 : esize == 2 ? FTP * L2_KB / 2 : H * FTP;   // bf16: W2^T [n][L2_KB]
  L.b2 = o;    o += FTP;
  L.g = o;     o += pad4(GS);
  L.ptab = o;  o += pad4(PC * 8);                     // ints
  L.pi = o;    o += pad4(PC * L2_K);                  // ints: the tile's (path, i), i < d_in
  L.mask = o;  o += pad4(C * L2_TN * MS);
  L.edges = o; o += pad4(L2_TN * MS);                 // ints: nl * MS + ml of the live pairs
  L.wcnt = o;  o += 20;                               // ints: per-warp counts, then the total
  L.rn = o;    o += 2 * rows;                         // ints: each staged row's receiver
  L.a = o;     o += pad4((2 * C * rows * EP * esize + 3) / 4);   // two stages
  L.sh = o;    o += 2 * rows * SH_STRIDE;                        // two stages
  L.x = o;     o += pad4((2 * rows * DX * esize + 3) / 4);       // two stages
  L.hid = o;   o += wide ? (esize == 2 ? C * rows * wide_hid_pitch(H, hcw) / 2 : rows * WHC)
                     : C * rows * (esize == 2 ? L2_KB / 2 : L2_HP);   // bf16: [c][row][L2_KB]
  L.wt = o;    o += rows * FTP;
  L.t = o;     o += pad4(rows * TS);
  L.total = o;
  return L;
}

// One row of the walk for a channel of shape (DI, DO): its edge weight w,
// its DI sender features xr and the row's t block of its path (DI x DO,
// padded to float4s) into the running sums.
template <int DI, int DO, typename T>
__device__ __forceinline__ void walk_row(float (&run)[5], float w, const T* xr, const float* tq) {
  constexpr int NT = (DI * DO + 3) / 4;
  float t[4 * NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(tq + 4 * q);
    t[4 * q] = v.x;
    t[4 * q + 1] = v.y;
    t[4 * q + 2] = v.z;
    t[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < DI; ++i) {
    const float g = w * to_f(xr[i]);
#pragma unroll
    for (int k = 0; k < DO; ++k) run[k] = fmaf(g, t[i * DO + k], run[k]);
  }
}

// The running sums of receiver `cur` moved into its five sums (registers:
// the receiver is chosen by comparison, not by an index), and `cur` = to.
__device__ __forceinline__ void flush_run(float (&acc)[L2_TN][L2_K], float (&run)[L2_K], int& cur,
                                          int to) {
#pragma unroll
  for (int q = 0; q < L2_TN; ++q)
    if (q == cur) {
#pragma unroll
      for (int k = 0; k < L2_K; ++k) acc[q][k] += run[k];
    }
  cur = to;
#pragma unroll
  for (int k = 0; k < L2_K; ++k) run[k] = 0.f;
}

// Rows [rb, re) of a tile for one channel of shape (DI, DO): row r's
// receiver rn[r], edge weight wt[r * wp], features xr + r * xp and t block
// tq + r * tp (the pointers at the channel's column of row 0).
template <int DI, int DO, typename T>
__device__ __forceinline__ void walk_rows(float (&acc)[L2_TN][L2_K], float (&run)[L2_K], int& cur,
                                          int rb, int re, const int* rn, const float* wt, int wp,
                                          const T* xr, int xp, const float* tq, int tp) {
#pragma unroll 2
  for (int r = rb; r < re; ++r) {
    const int nl = rn[r];
    if (nl != cur) flush_run(acc, run, cur, nl);
    walk_row<DI, DO>(run, wt[r * wp], xr + (size_t)r * xp, tq + r * tp);
  }
}

// t[i][k] = sum_j G[i, j, k] sh[j] of one (row, path, i), k < DO, j < DS.
template <int DS, int DO>
__device__ __forceinline__ void t_entry(float* tq, const float* G, const float* sv) {
  float svj[DS];
#pragma unroll
  for (int j = 0; j < DS; ++j) svj[j] = sv[j];
#pragma unroll
  for (int k = 0; k < DO; ++k) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < DS; ++j) t = fmaf(G[j * DO + k], svj[j], t);
    tq[k] = t;
  }
}

// NCH: 64-channel groups of a tile (FTP = 64 NCH channels, lane = two
// neighbouring channels of each group).  WIDE: the wide kernel (head note).
template <typename T, int NCH, bool WIDE>
__global__ void __launch_bounds__(L2_THREADS, 2) tp_fused_l2_kernel(
    const T* __restrict__ x,         // (B, Mx, D) sender features (Mx = M without idx)
    const T* __restrict__ sh,        // (B, N, M, S) edge harmonics
    const T* __restrict__ attr0,     // (B, N, M, E) edge attributes, channel 0
    const T* __restrict__ attr1,     // (B, N, M, E) channel 1 (read when C == 2)
    const void* __restrict__ mask0,  // (B, N, M) bool or f32
    const void* __restrict__ mask1,  // (B, N, M) (read when C == 2)
    const int* __restrict__ idx,     // (B, N, M) sender of each slot, or null (dense)
    const float* __restrict__ w1,    // (E, H)
    const float* __restrict__ b1,    // (H)
    const float* __restrict__ w2,    // (H, F)
    const float* __restrict__ b2,    // (F)
    const int4* __restrict__ chan,   // (F): x offset in the tile's slice, d_in, d_out, tile path
    const int* __restrict__ ptab,    // (n_paths, 8): sh_off, d_in, d_sh, d_out, t_off, g_off, 0, 0
    const float* __restrict__ gflat, // each path's alpha*cg, (d_in, d_sh, d_out) entries
    const int* __restrict__ ctab,    // (n_ct, 8): f0, fc, p0, pc, x_lo, xw, g0, gs
    const int* __restrict__ walk,    // (F): each tile's channels in the walk's order
    float* __restrict__ dst,         // out (B, N, F, 8), or the partial sums (splits, B, N, F, 8)
    int B, int N, int M, int Mx, int D, int S, int C, int E, int H, int F, int n_ct, int DX,
    int TS, int GS, int PC, int MS, int mask_is_f32, int xvec, int hcw) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool ROUND = sizeof(T) == 2;   // the JAX package's bf16 convolution
  constexpr int FTP = 64 * NCH;
  constexpr int RWS = l2_rows(WIDE, sizeof(T));   // live edges a tile
  constexpr int TPR = L2_THREADS / RWS;           // the gather's threads a row
  const bool indexed = idx != nullptr;
  const LayoutL2 L = make_layout_l2(C, E, H, DX, TS, GS, PC, MS, FTP, sizeof(T), WIDE, hcw);
  const int EP = WIDE ? wide_a_pitch(E, sizeof(T)) : E;   // the attribute rows' pitch
  float* s_w1 = smem + L.w1;                                    // [k][L2_HP]
  float* s_b1 = smem + L.b1;
  float* s_w2 = smem + L.w2;                                    // [k][FTP]: the tile's columns
  __nv_bfloat16* s_w2t = reinterpret_cast<__nv_bfloat16*>(s_w2);   // bf16: [n][L2_KB]
  float* s_b2 = smem + L.b2;
  float* s_g = smem + L.g;                                      // the tile's coupling entries
  int* s_ptab = reinterpret_cast<int*>(smem + L.ptab);          // the tile's paths
  int* s_pi = reinterpret_cast<int*>(smem + L.pi);              // p * 8 + i, i < d_in(p)
  float* s_mask = smem + L.mask;                                // [c][nl * MS + ml]
  int* s_edges = reinterpret_cast<int*>(smem + L.edges);
  int* s_wcnt = reinterpret_cast<int*>(smem + L.wcnt);
  int* s_rn = reinterpret_cast<int*>(smem + L.rn);              // [stage][row]: nl
  T* s_a = reinterpret_cast<T*>(smem + L.a);                    // [stage][c][row][E]
  float* s_sh = smem + L.sh;                                    // [stage][row][SH_STRIDE]
  T* s_x = reinterpret_cast<T*>(smem + L.x);                    // [stage][row][DX]
  float* s_hid = smem + L.hid;                                  // f32: [row][L2_HP]
  __nv_bfloat16* s_hidb = reinterpret_cast<__nv_bfloat16*>(s_hid);   // bf16: [c][row][L2_KB]
  float* s_wt = smem + L.wt;                                    // [row][FTP]
  float* s_t = smem + L.t;                                      // [row][TS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * L2_TN;
  const int ct = blockIdx.x % n_ct, split = blockIdx.x / n_ct;
  const int m0 = split, mstep = gridDim.x / n_ct;
  const int ms = (M - m0 + mstep - 1) / mstep;   // senders of this block, <= MS
  const int f0 = ctab[ct * 8], fc = ctab[ct * 8 + 1], p0 = ctab[ct * 8 + 2];
  const int pc = ctab[ct * 8 + 3], x_lo = ctab[ct * 8 + 4], xw = ctab[ct * 8 + 5];
  const int g0 = ctab[ct * 8 + 6], gs = ctab[ct * 8 + 7];

  for (int i = tid; i < 2 * RWS * SH_STRIDE; i += L2_THREADS) s_sh[i] = 0.f;   // pad lanes 0
  for (int i = tid; i < C * L2_TN * MS; i += L2_THREADS) {
    const int c = i / (L2_TN * MS);
    const int r = i - c * L2_TN * MS;
    const int nl = r / MS, ml = r - nl * MS;
    const int n = n0 + nl;
    float v = 0.f;
    if (n < N && ml < ms) {
      const size_t at = ((size_t)b * N + n) * M + m0 + ml * mstep;
      const void* mp = c == 0 ? mask0 : mask1;
      v = mask_is_f32 ? static_cast<const float*>(mp)[at]
                      : (static_cast<const uint8_t*>(mp)[at] ? 1.f : 0.f);
    }
    s_mask[i] = v;
  }
  // the walk's thread: slot fl of the tile's walk order (channel fw of the
  // tile), rows of part `part` of each tile: two parts of a tile of up to
  // 128 channels, four of one of up to 64
  const int cw = fc > 64 ? 128 : 64, parts = L2_THREADS / cw;
  const int fl = tid % cw, part = tid / cw;
  const bool walker = fl < fc;
  const int fw = walker ? walk[f0 + fl] - f0 : 0;
  const int4 cm = walker ? chan[f0 + fw] : make_int4(0, 0, 0, 0);   // x offset, d_in, d_out, path
  const int t_off = walker ? ptab[(p0 + cm.w) * 8 + 4] : 0;
  const int shape = cm.y * 8 + cm.z;
  __syncthreads();

  // ---- compaction: the live pairs nl * MS + ml, in order (receiver-major)
  const int pairs = L2_TN * MS;
  int total = 0;
  for (int base = 0; base < pairs; base += L2_THREADS) {
    const int pi = base + tid;
    bool live = false;
    if (pi < pairs) {
      live = s_mask[pi] != 0.f;
      if (C == 2) live = live || s_mask[pairs + pi] != 0.f;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_wcnt[warp] = __popc(bal);
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int w = 0; w < L2_WARPS; ++w) {
        const int c = s_wcnt[w];
        s_wcnt[w] = run;
        run += c;
      }
      s_wcnt[16] = run;
    }
    __syncthreads();
    if (live) s_edges[total + s_wcnt[warp] + __popc(bal & ((1u << lane) - 1u))] = pi;
    total += s_wcnt[16];
    __syncthreads();
  }

  if (total == 0) {   // no live pair: zeros, and no weight is loaded
    if (walker && part == 0) {
      float4* o = reinterpret_cast<float4*>(dst) + (size_t)split * B * N * F * 2;
      for (int nl = 0; nl < L2_TN && n0 + nl < N; ++nl) {
        const size_t at = ((size_t)b * N + n0 + nl) * F + f0 + fw;
        o[2 * at] = o[2 * at + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  // ---- resident operands of a block with live pairs: W1, b1, the tile's W2
  // columns, b2, coupling entries and path rows (f32 weights asynchronously,
  // with the first tile's rows).  Padding columns are zero.  WIDE: the
  // weights, or the ring's first chunk (wide_load); the attribute rows' pad
  // past E (to the products' depth) is zero.
  if (WIDE) {
    const int ez = (ROUND ? pad_to(E, 16) : pad4(E)) - E;
    for (int i = tid; i < 2 * C * RWS * ez; i += L2_THREADS) {
      const int r = i / ez;
      s_a[(size_t)r * EP + E + i - r * ez] = T(0.f);
    }
  } else if (ROUND) {
    for (int i = tid; i < E * L2_HP; i += L2_THREADS) {
      const int k = i / L2_HP, h = i - k * L2_HP;
      s_w1[i] = h < H ? bf16_round(w1[k * H + h]) : 0.f;
    }
    for (int i = tid; i < L2_HP * FTP; i += L2_THREADS) {
      const int k = i / FTP, c = i - k * FTP;
      s_w2t[c * L2_KB + k] =
          __float2bfloat16_rn(c < fc && k < H ? w2[(size_t)k * F + f0 + c] : 0.f);
    }
  } else {
    for (int i = tid; i < E * (H / 4); i += L2_THREADS) {
      const int k = i / (H / 4), q = i - k * (H / 4);
      cp_async16(s_w1 + k * L2_HP + 4 * q, w1 + k * H + 4 * q);
    }
    for (int i = tid; i < E * (L2_HP - H); i += L2_THREADS) {
      const int k = i / (L2_HP - H);
      s_w1[k * L2_HP + H + i - k * (L2_HP - H)] = 0.f;
    }
    if (F % 4 == 0 && f0 % 4 == 0 && fc % 4 == 0) {   // W2's rows in 16-byte pieces
      for (int i = tid; i < H * (FTP / 4); i += L2_THREADS) {
        const int k = i / (FTP / 4), c = 4 * (i - k * (FTP / 4));
        if (c < fc) cp_async16(s_w2 + k * FTP + c, w2 + (size_t)k * F + f0 + c);
        else *reinterpret_cast<float4*>(s_w2 + k * FTP + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = tid; i < H * FTP; i += L2_THREADS) {
        const int k = i / FTP, c = i - k * FTP;
        if (c < fc) cp_async4(s_w2 + i, w2 + (size_t)k * F + f0 + c);
        else s_w2[i] = 0.f;
      }
    }
  }
  cp_async_commit();
  const int HB = WIDE ? (H + L2_HP - 1) / L2_HP * L2_HP : L2_HP;
  for (int i = tid; i < HB; i += L2_THREADS)
    s_b1[i] = i < H ? (ROUND ? bf16_round(b1[i]) : b1[i]) : 0.f;
  for (int i = tid; i < FTP; i += L2_THREADS)
    s_b2[i] = i < fc ? (ROUND ? bf16_round(b2[f0 + i]) : b2[f0 + i]) : 0.f;
  for (int i = tid; i < gs; i += L2_THREADS) s_g[i] = gflat[g0 + i];
  for (int i = tid; i < pc * 8; i += L2_THREADS) s_ptab[i] = ptab[p0 * 8 + i];
  int n_pi = 0;         // the tile's (path, i) pairs of the t step, in order
  for (int p = 0; p < pc; ++p) {
    const int d_in = ptab[(p0 + p) * 8 + 1];
    if (tid < d_in) s_pi[n_pi + tid] = p * 8 + tid;
    n_pi += d_in;
  }

  // gather a tile's attribute rows, harmonics and sender features into a
  // stage of the ring, TPR threads a row (asynchronously where the
  // alignment allows; bf16 harmonics with plain loads, WIDE into registers
  // that put_sh stores at the tile's start, so no thread waits on them)
  float shv[2];                                  // WIDE bf16 (TPR = 8): harmonics sub, sub + 8
  int sh_at = -1;                                // their row of s_sh, or none
  auto put_sh = [&]() {
    if (sh_at < 0) return;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      if (tid % TPR + TPR * jj < S) s_sh[sh_at * SH_STRIDE + tid % TPR + TPR * jj] = shv[jj];
    sh_at = -1;
  };
  auto gather_tile = [&](int stage, int first) {
    const int row = tid / TPR, sub = tid % TPR;
    if (first + row >= total) return;
    const int e = s_edges[first + row];
    const int nl = e / MS, ml = e - nl * MS;
    const size_t edge = ((size_t)b * N + n0 + nl) * M + m0 + ml * mstep;
    if (sub == 0) s_rn[stage * RWS + row] = nl;
    for (int c = 0; c < C; ++c) {
      const T* src = (c == 0 ? attr0 : attr1) + edge * E;
      T* arow = s_a + ((size_t)(stage * C + c) * RWS + row) * EP;
      if (WIDE && E % 4) {   // rows not aligned to four elements
        for (int k = sub; k < E; k += TPR) {
          if (sizeof(T) == 4) cp_async4(arow + k, src + k);
          else arow[k] = src[k];
        }
      } else {
        for (int q = sub; q < E / 4; q += TPR) cp_async_quad(arow + 4 * q, src + 4 * q);
      }
    }
    float* srow = s_sh + (stage * RWS + row) * SH_STRIDE;
    if (WIDE && ROUND) {
      static_assert(!(WIDE && ROUND) || 2 * TPR >= SH_STRIDE, "two harmonics a thread");
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        shv[jj] = sub + TPR * jj < S ? to_f(sh[edge * S + sub + TPR * jj]) : 0.f;
      sh_at = stage * RWS + row;
    } else {
      for (int j = sub; j < S; j += TPR) {
        if (sizeof(T) == 4) cp_async4(srow + j, sh + edge * S + j);
        else srow[j] = to_f(sh[edge * S + j]);
      }
    }
    const int m = indexed ? __ldg(idx + edge) : m0 + ml * mstep;
    const T* xs = x + ((size_t)b * Mx + m) * D + x_lo;
    T* xrow = s_x + (size_t)(stage * RWS + row) * DX;
    if (xvec) {
      for (int q = sub; q < xw / 4; q += TPR) cp_async_quad(xrow + 4 * q, xs + 4 * q);
    } else {
      for (int d = sub; d < xw && x_lo + d < D; d += TPR) {
        if (sizeof(T) == 4) cp_async4(xrow + d, xs + d);
        else xrow[d] = xs[d];
      }
    }
  };

  float acc[L2_TN][L2_K];
#pragma unroll
  for (int nl = 0; nl < L2_TN; ++nl)
#pragma unroll
    for (int k = 0; k < L2_K; ++k) acc[nl][k] = 0.f;
  int cur = 0;          // the receiver whose rows are being walked, and its running sums
  float run[L2_K];
#pragma unroll
  for (int k = 0; k < L2_K; ++k) run[k] = 0.f;

  gather_tile(0, 0);
  if (WIDE)   // the weights, or the ring's first chunk, behind the first tile's rows
    wide_load<ROUND>(s_w1, w1, w2, E, H, F, f0, fc, FTP, hcw, 0, 0, tid);
  cp_async_commit();

  for (int first = 0, stage = 0, tile = 0; first < total; first += RWS, stage ^= 1, ++tile) {
    const int rows = min(RWS, total - first);
    if (!WIDE || hcw == 0) {   // the ring holds the tiles; WIDE staged: it steps by chunks below
      put_sh();                                   // this tile's harmonics (WIDE bf16)
      gather_tile(stage ^ 1, first + RWS);        // the next tile's loads
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }

    if constexpr (WIDE) {
      // The edge MLP chunk by chunk from weights in shared memory (head
      // note).  f32, per warp (its RT rows): hid = sum_c mask_c relu(A_c W1
      // + b1), w = hid W2 + msum b2; bf16, the block on the tensor cores,
      // channel by channel: w = bf16(sum_c bf16(bf16(h_c W2) + b2) mask_c),
      // h_c = relu(bf16(bf16(A_c W1) + b1)).
      constexpr int RT = RWS / L2_WARPS, MT = RWS / 16;
      const int groups = NCH == 2 && fc > 64 ? 2 : 1;
      const int r0 = warp * RT;
      const T* a_t = s_a + (size_t)stage * C * RWS * EP;
      auto row_mask = [&](int c, int r) {
        return r < rows && c < C ? s_mask[c * pairs + s_edges[first + r]] : 0.f;
      };
      float mrow[2][RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        mrow[0][i] = row_mask(0, r0 + i);
        mrow[1][i] = row_mask(1, r0 + i);
      }
      float wacc[RT][NCH][2];
      float d[2][NCH][MT][4];
      if constexpr (ROUND) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int j = 0; j < NCH; ++j)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              d[c][j][mt][0] = d[c][j][mt][1] = d[c][j][mt][2] = d[c][j][mt][3] = 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < NCH; ++j) wacc[i][j][0] = wacc[i][j][1] = 0.f;
      }
      // hidden units a chunk: staged, hcw; resident, all H (bf16) or WHC (f32)
      const int hstep = hcw ? hcw : ROUND ? H : WHC;
      const int steps = (H + hstep - 1) / hstep;
      for (int q = 0; q < steps; ++q) {
        const int hc = q * hstep, slot = (tile * steps + q) & 1;
        if (hcw) {
          // the ring: the next step's chunk into the other slot (the next
          // tile's first after this tile's last), the next tile's rows with
          // this tile's first chunk; then this step's are complete
          const bool last = q + 1 == steps;
          if (!last || first + RWS < total)
            wide_load<ROUND>(s_w1, w1, w2, E, H, F, f0, fc, FTP, hcw, last ? 0 : hc + hcw,
                             slot ^ 1, tid);
          if (q == 0) {
            put_sh();
            gather_tile(stage ^ 1, first + RWS);
          }
          cp_async_commit();
          cp_async_wait<1>();
          __syncthreads();
        }
        const WideChunk wc = wide_chunk(s_w1, E, H, FTP, ROUND, hcw, hc, slot);
        const int kn = min(hstep, H - hc);
        if constexpr (ROUND) {
          wide_chunk_bf16<MT, NCH>(d, wc, reinterpret_cast<const __nv_bfloat16*>(a_t), EP, C, E,
                                   kn, hc, rows, groups, s_b1, s_hidb, wide_hid_pitch(H, hcw),
                                   lane, warp);
        } else {
          if (r0 < rows)
            wide_chunk_f32<RT, NCH>(wacc, wc, reinterpret_cast<const float*>(a_t), RWS * EP, EP,
                                    C, E, kn, hc, r0, rows, groups, mrow, s_b1,
                                    s_hid + r0 * WHC, FTP, lane);
          if (hcw) __syncthreads();              // every warp is done with this slot
        }
      }
      if constexpr (ROUND) {
        wide_finish_bf16<MT, NCH>(d, C, groups, s_b2, s_wt, FTP, lane, warp, row_mask);
      } else {
        if (r0 < rows) wide_finish_f32<RT, NCH>(wacc, mrow, r0, groups, s_b2, s_wt, FTP, lane);
      }
    } else {
      // ---- per warp, its two rows: the hidden layer, then (f32) the edge weights
      const int r0 = warp * L2_RW;
      float mrow[2][L2_RW];                       // the rows' masks; 0 past the tile's end
#pragma unroll
      for (int i = 0; i < L2_RW; ++i) {
        const bool ok = r0 + i < rows;
        const int e = ok ? s_edges[first + r0 + i] : 0;
        mrow[0][i] = ok ? s_mask[e] : 0.f;
        mrow[1][i] = ok && C == 2 ? s_mask[pairs + e] : 0.f;
      }
      if (r0 < rows) {
        // hidden units 2 lane, 2 lane + 1 of both rows: pre = A_c W1
        float hs[L2_RW][2] = {};
        for (int c = 0; c < C; ++c) {
          const T* A = s_a + ((size_t)(stage * C + c) * L2_ROWS + r0) * E;
          float pre[L2_RW][2] = {};
  #pragma unroll 3
          for (int k = 0; k < E; k += 4) {
            float4 av[L2_RW];
  #pragma unroll
            for (int i = 0; i < L2_RW; ++i) av[i] = ld4s(A + i * E + k);
  #pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float2 wv = *reinterpret_cast<const float2*>(s_w1 + (k + kk) * L2_HP + 2 * lane);
  #pragma unroll
              for (int i = 0; i < L2_RW; ++i) {
                const float a = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
                pre[i][0] = fmaf(a, wv.x, pre[i][0]);
                pre[i][1] = fmaf(a, wv.y, pre[i][1]);
              }
            }
          }
          const float2 bv = *reinterpret_cast<const float2*>(s_b1 + 2 * lane);
  #pragma unroll
          for (int i = 0; i < L2_RW; ++i) {
            // rows past the tile's end hold stale data: written as zeros
            const bool ok = r0 + i < rows;
            if (ROUND) {
              // the JAX package's bf16 convolution, channel by channel:
              // h_c = relu(bf16(bf16(A_c W1) + b1))
              const float h0 = fmaxf(bf16_round(bf16_round(pre[i][0]) + bv.x), 0.f);
              const float h1 = fmaxf(bf16_round(bf16_round(pre[i][1]) + bv.y), 0.f);
              *reinterpret_cast<__nv_bfloat162*>(s_hidb + (c * L2_ROWS + r0 + i) * L2_KB + 2 * lane) =
                  __floats2bfloat162_rn(ok ? h0 : 0.f, ok ? h1 : 0.f);
            } else {
              // hid = sum_c mask_c relu(A_c W1 + b1)
              const float mc = c == 0 ? mrow[0][i] : mrow[1][i];
              hs[i][0] = fmaf(mc, fmaxf(pre[i][0] + bv.x, 0.f), hs[i][0]);
              hs[i][1] = fmaf(mc, fmaxf(pre[i][1] + bv.y, 0.f), hs[i][1]);
            }
          }
        }
        if constexpr (!ROUND) {
  #pragma unroll
          for (int i = 0; i < L2_RW; ++i) {
            const bool ok = r0 + i < rows;
            *reinterpret_cast<float2*>(s_hid + (r0 + i) * L2_HP + 2 * lane) =
                ok ? make_float2(hs[i][0], hs[i][1]) : make_float2(0.f, 0.f);
          }
          __syncwarp();
          // ---- w[r, f] = hid W2 + msum b2 of the tile's channels 2 lane + 64 j,
          // + 1, j < G (register tile of two rows x 2 G channels; G = 1 for a
          // tile of 64 or fewer)
          auto product = [&](auto groups) {
            constexpr int G = decltype(groups)::value;
            const float* hr = s_hid + r0 * L2_HP;
            float wacc[L2_RW][G][2] = {};
  #pragma unroll 3
            for (int k = 0; k < H; k += 4) {
              float4 hv[L2_RW];
  #pragma unroll
              for (int i = 0; i < L2_RW; ++i)
                hv[i] = *reinterpret_cast<const float4*>(hr + i * L2_HP + k);
  #pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                float2 wv[G];
  #pragma unroll
                for (int j = 0; j < G; ++j)
                  wv[j] = *reinterpret_cast<const float2*>(s_w2 + (k + kk) * FTP + 2 * lane + 64 * j);
  #pragma unroll
                for (int i = 0; i < L2_RW; ++i) {
                  const float h = kk == 0 ? hv[i].x : kk == 1 ? hv[i].y : kk == 2 ? hv[i].z : hv[i].w;
  #pragma unroll
                  for (int j = 0; j < G; ++j) {
                    wacc[i][j][0] = fmaf(h, wv[j].x, wacc[i][j][0]);
                    wacc[i][j][1] = fmaf(h, wv[j].y, wacc[i][j][1]);
                  }
                }
              }
            }
  #pragma unroll
            for (int i = 0; i < L2_RW; ++i) {
              const float msum = mrow[0][i] + mrow[1][i];
  #pragma unroll
              for (int j = 0; j < G; ++j) {
                const int col = 2 * lane + 64 * j;
                const float2 bv = *reinterpret_cast<const float2*>(s_b2 + col);
                *reinterpret_cast<float2*>(s_wt + (r0 + i) * FTP + col) =
                    make_float2(fmaf(msum, bv.x, wacc[i][j][0]), fmaf(msum, bv.y, wacc[i][j][1]));
              }
            }
          };
          if (NCH == 2 && fc > 64) product(std::integral_constant<int, NCH>{});
          else product(std::integral_constant<int, 1>{});
        }
      } else if (ROUND) {
        for (int c = 0; c < C; ++c)   // rows past the tile's end: zeros for the product below
          for (int i = 0; i < L2_RW; ++i)
            *reinterpret_cast<__nv_bfloat162*>(s_hidb + (c * L2_ROWS + r0 + i) * L2_KB + 2 * lane) =
                __floats2bfloat162_rn(0.f, 0.f);
      }
      if constexpr (ROUND) {
        // ---- bf16: w = hid_c W2 on the tensor cores (mma.sync m16n8k16, f32
        // sums; both operands are bf16 values), column tile warp + 8 j of the
        // 16 rows; lane g = lane / 4 holds rows g and g + 8, tq = lane % 4
        // their columns 2 tq, 2 tq + 1 (the fragment layout)
        __syncthreads();
        const int g = lane >> 2, tq = lane & 3;
        float mr[2][2];                           // [c][row g, g + 8]
  #pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = g + 8 * i;
          const bool ok = r < rows;
          const int e = ok ? s_edges[first + r] : 0;
          mr[0][i] = ok ? s_mask[e] : 0.f;
          mr[1][i] = ok && C == 2 ? s_mask[pairs + e] : 0.f;
        }
        auto product = [&](auto groups) {
          constexpr int G = decltype(groups)::value;
          for (int c = 0; c < C; ++c) {
            const __nv_bfloat16* hb = s_hidb + c * L2_ROWS * L2_KB;
            float d[G][4] = {};
            for (int k0 = 0; k0 < H; k0 += 16) {
              unsigned a[4];
  #pragma unroll
              for (int q = 0; q < 4; ++q)
                a[q] = *reinterpret_cast<const unsigned*>(
                    hb + (g + 8 * (q & 1)) * L2_KB + k0 + 2 * tq + 8 * (q >> 1));
  #pragma unroll
              for (int j = 0; j < G; ++j) {
                const __nv_bfloat16* wb = s_w2t + ((warp + 8 * j) * 8 + g) * L2_KB + k0 + 2 * tq;
                const unsigned bb[2] = {*reinterpret_cast<const unsigned*>(wb),
                                        *reinterpret_cast<const unsigned*>(wb + 8)};
                mma_bf16(d[j], a, bb);
              }
            }
            // w = bf16(sum_c bf16(bf16(h_c W2) + b2) * mask_c): channel 0's term
            // is stored, channel 1's added to it by the same thread and rounded
  #pragma unroll
            for (int j = 0; j < G; ++j) {
  #pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int row = g + 8 * (q >> 1), col = (warp + 8 * j) * 8 + 2 * tq + (q & 1);
                const float mc = c == 0 ? mr[0][q >> 1] : mr[1][q >> 1];
                const float v = bf16_round(bf16_round(d[j][q]) + s_b2[col]) * mc;
                float* wt = s_wt + row * FTP + col;
                *wt = c == 0 ? v : bf16_round(*wt + v);
              }
            }
          }
        };
        if (NCH == 2 && fc > 64) product(std::integral_constant<int, NCH>{});
        else product(std::integral_constant<int, 1>{});
      }
    }
    // ---- t of every (row, tile path, i): t[i][k] = sum_j G[i, j, k] sh[j]
    // (rows fastest, so a warp mostly shares one (path, i) and its shape)
    for (int it = tid; it < RWS * n_pi; it += L2_THREADS) {
      const int r = it % RWS, pi = s_pi[it / RWS];
      const int p = pi >> 3, i = pi & 7;
      const int* pt = s_ptab + p * 8;
      if (r >= rows) continue;
      const int d_sh = pt[2], d_out = pt[3];
      const float* G = s_g + pt[5] + i * d_sh * d_out;
      const float* sv = s_sh + (stage * RWS + r) * SH_STRIDE + pt[0];
      float* tq = s_t + r * TS + pt[4] + i * d_out;
      switch (d_sh * 8 + d_out) {
        case 9: t_entry<1, 1>(tq, G, sv); break;
        case 11: t_entry<1, 3>(tq, G, sv); break;
        case 13: t_entry<1, 5>(tq, G, sv); break;
        case 25: t_entry<3, 1>(tq, G, sv); break;
        case 27: t_entry<3, 3>(tq, G, sv); break;
        case 29: t_entry<3, 5>(tq, G, sv); break;
        case 41: t_entry<5, 1>(tq, G, sv); break;
        case 43: t_entry<5, 3>(tq, G, sv); break;
        default: t_entry<5, 5>(tq, G, sv); break;
      }
    }
    __syncthreads();

    // ---- the channel's share of its half of the rows, summed receiver by
    // receiver (the loops' bounds fixed by the channel's shape)
    if (walker) {
      const int rb = part * (RWS / parts), re = min(rows, rb + RWS / parts);
      const int* rn = s_rn + stage * RWS;
      const float* wt = s_wt + fw;
      const T* xr = s_x + (size_t)stage * RWS * DX + cm.x;
      const float* tq = s_t + t_off;
      switch (shape) {
        case 9: walk_rows<1, 1>(acc, run, cur, rb, re, rn, wt, FTP, xr, DX, tq, TS); break;
        case 11: walk_rows<1, 3>(acc, run, cur, rb, re, rn, wt, FTP, xr, DX, tq, TS); break;
        case 13: walk_rows<1, 5>(acc, run, cur, rb, re, rn, wt, FTP, xr, DX, tq, TS); break;
        case 25: walk_rows<3, 1>(acc, run, cur, rb, re, rn, wt, FTP, xr, DX, tq, TS); break;
        case 27: walk_rows<3, 3>(acc, run, cur, rb, re, rn, wt, FTP, xr, DX, tq, TS); break;
        case 29: walk_rows<3, 5>(acc, run, cur, rb, re, rn, wt, FTP, xr, DX, tq, TS); break;
        case 41: walk_rows<5, 1>(acc, run, cur, rb, re, rn, wt, FTP, xr, DX, tq, TS); break;
        case 43: walk_rows<5, 3>(acc, run, cur, rb, re, rn, wt, FTP, xr, DX, tq, TS); break;
        default: walk_rows<5, 5>(acc, run, cur, rb, re, rn, wt, FTP, xr, DX, tq, TS); break;
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  flush_run(acc, run, cur, 0);

  // the other parts' sums, added to part 0's in order (over the hidden and
  // edge-weight tiles, free now)
  float* red = smem + L.hid;                                    // [nl][cw][L2_K]
  for (int q = 1; q < parts; ++q) {
    __syncthreads();
    if (walker && part == q) {
#pragma unroll
      for (int nl = 0; nl < L2_TN; ++nl)
#pragma unroll
        for (int k = 0; k < L2_K; ++k) red[(nl * cw + fl) * L2_K + k] = acc[nl][k];
    }
    __syncthreads();
    if (walker && part == 0) {
#pragma unroll
      for (int nl = 0; nl < L2_TN; ++nl)
#pragma unroll
        for (int k = 0; k < L2_K; ++k) acc[nl][k] += red[(nl * cw + fl) * L2_K + k];
    }
  }
  if (walker && part == 0) {
    float4* o = reinterpret_cast<float4*>(dst) + (size_t)split * B * N * F * 2;
#pragma unroll
    for (int nl = 0; nl < L2_TN; ++nl) {
      const int n = n0 + nl;
      if (n < N) {
        const size_t at = ((size_t)b * N + n) * F + f0 + fw;
        o[2 * at] = make_float4(acc[nl][0], acc[nl][1], acc[nl][2], acc[nl][3]);
        o[2 * at + 1] = make_float4(acc[nl][4], 0.f, 0.f, 0.f);
      }
    }
  }
}

// out[i] = sum over the sender splits of part[k][i], in order (floats).
__global__ void tp_fused_l2_sum_splits(const float* __restrict__ part, float* __restrict__ out,
                                       long long total, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[k * total + i];
  out[i] = s;
}

struct ArgsL2 {
  const void *x, *sh, *attr0, *attr1, *mask0, *mask1;
  const int* idx;
  const float *w1, *b1, *w2, *b2;
  const int *chan, *ptab;
  const float* gflat;
  const int *ctab, *walk;
  float *out, *part;
  int B, N, M, Mx, D, S, C, E, H, F, n_ct, DX, TS, GS, PC, FTP, MS, mask_is_f32, hcw;
};

// The most shared memory a block of the 8-lane kernel takes: two blocks an
// SM, or the wide kernel one.
constexpr int smem_l2_limit(bool wide) { return wide ? MAX_SMEM : L2_SMEM; }

template <typename T, int NCH, bool WIDE>
int launch_l2(const ArgsL2& a, cudaStream_t stream) {
  static bool allowed = false;   // the attribute is set once per instantiation
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(tp_fused_l2_kernel<T, NCH, WIDE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_l2_limit(WIDE));
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const LayoutL2 L = make_layout_l2(a.C, a.E, a.H, a.DX, a.TS, a.GS, a.PC, a.MS, 64 * NCH,
                                    sizeof(T), WIDE, a.hcw);
  const size_t bytes = (size_t)L.total * sizeof(float);
  if (bytes > (size_t)smem_l2_limit(WIDE)) return (int)cudaErrorInvalidValue;
  const int splits = (a.M + a.MS - 1) / a.MS;
  const dim3 grid(splits * a.n_ct, (a.N + L2_TN - 1) / L2_TN, a.B);
  float* dst = splits > 1 ? a.part : a.out;
  static_assert(L2_THREADS == WIDE_NT, "the wide helpers take eight warps");
  // the sender rows' slices go four elements at a time where every row's
  // slice starts on such a boundary (x_lo is a multiple of four)
  const int xvec = a.D % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % (4 * sizeof(T)) == 0;
  tp_fused_l2_kernel<T, NCH, WIDE><<<grid, L2_THREADS, bytes, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.sh), static_cast<const T*>(a.attr0),
      static_cast<const T*>(a.attr1), a.mask0, a.mask1, a.idx, a.w1, a.b1, a.w2, a.b2,
      reinterpret_cast<const int4*>(a.chan), a.ptab, a.gflat, a.ctab, a.walk, dst, a.B, a.N, a.M,
      a.Mx,
      a.D, a.S, a.C, a.E, a.H, a.F, a.n_ct, a.DX, a.TS, a.GS, a.PC, a.MS, a.mask_is_f32, xvec,
      a.hcw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)a.B * a.N * a.F * 8;
  tp_fused_l2_sum_splits<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a.part, a.out,
                                                                             total, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_l2_nch(const ArgsL2& a, bool wide, cudaStream_t stream) {
  if (wide) return a.FTP == 64 ? launch_l2<T, 1, true>(a, stream) : launch_l2<T, 2, true>(a, stream);
  return a.FTP == 64 ? launch_l2<T, 1, false>(a, stream) : launch_l2<T, 2, false>(a, stream);
}

struct Args {
  const void *x, *sh, *attr0, *attr1, *mask0, *mask1;
  const int* idx;
  const float *w1, *b1, *w2, *b2;
  const int* chan;
  const float* gtab;
  const int* ctab;
  float *out, *part;
  int B, N, M, Mx, D, S, C, E, H, F, n_paths, MS, mask_is_f32, n_ct, tpaths, hcw;
};

template <typename T, int NC, bool IDX, bool WIDE>
int launch(const Args& a, cudaStream_t stream) {
  static bool allowed = false;   // the attribute is set once per instantiation
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(tp_fused_kernel<T, NC, IDX, WIDE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  static_assert(THREADS == WIDE_NT, "the wide helpers take eight warps");
  const Layout L = make_layout(a.C, a.E, a.H, a.D, a.n_paths, a.MS, NC, IDX, WIDE, a.tpaths,
                               sizeof(T), a.hcw);
  const size_t bytes = (size_t)L.total * sizeof(float);
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int splits = (a.M + a.MS - 1) / a.MS;
  const dim3 grid(splits * a.n_ct, (a.N + TN - 1) / TN, a.B);
  float* dst = splits > 1 ? a.part : a.out;
  tp_fused_kernel<T, NC, IDX, WIDE><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.sh), static_cast<const T*>(a.attr0),
      static_cast<const T*>(a.attr1), a.mask0, a.mask1, a.idx, a.w1, a.b1, a.w2, a.b2,
      reinterpret_cast<const int4*>(a.chan), a.gtab, a.ctab, dst, a.B, a.N, a.M, a.Mx, a.D, a.S,
      a.C, a.E, a.H, a.F, a.n_paths, a.MS, a.mask_is_f32, a.n_ct, a.tpaths, a.hcw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int total = a.B * a.N * a.F;
  tp_fused_kernel_sum_splits<<<(total + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(a.part), reinterpret_cast<float4*>(a.out), total, splits);
  return (int)cudaGetLastError();
}

// The narrow kernel: NC from F; the wide one NC = FTP / 32 (its tile pitch).
template <typename T, bool IDX>
int launch_nc(const Args& a, int ftp, cudaStream_t stream) {
  if (ftp) return ftp == 64 ? launch<T, 2, IDX, true>(a, stream) : launch<T, 4, IDX, true>(a, stream);
  switch ((a.F + 31) / 32) {
    case 1:
    case 2: return launch<T, 2, IDX, false>(a, stream);
    case 3: return launch<T, 3, IDX, false>(a, stream);
    case 4: return launch<T, 4, IDX, false>(a, stream);
    case 5: return launch<T, 5, IDX, false>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 when the launch was accepted.  `part` holds
// (ceil(M / MS), B, N, F, 4) floats when the senders are split (MS < M), else
// it is not read.  Sender-index mode: idx (B, N, M) int32 the sender of each
// slot, x (B, Mx, D); dense: idx null, Mx = M.  ctab null: the narrow kernel
// (E, H multiples of 4, H <= min(E, 64), F <= 160); else the wide kernel on
// the n_ct channel tiles of ctab ((first channel, width, first path, paths)
// each, width <= ftp, at most tpaths paths), E and H <= WIDE_MAX, ftp 64 or
// 128 the tiles' pitch, hcw 0 (weights resident) or the hidden units of a
// staged chunk (64, 32, 16 or 8).
int dp_tp_fused(const void* x, const void* sh, const void* attr0, const void* attr1,
                const void* mask0, const void* mask1, const int* idx, const float* w1,
                const float* b1, const float* w2, const float* b2, const int* chan,
                const float* gtab, const int* ctab, float* out, float* part, int B, int N, int M,
                int Mx, int D, int S, int C, int E, int H, int F, int n_paths, int MS,
                int mask_is_f32, int n_ct, int tpaths, int ftp, int hcw, int bf16, void* stream) {
  const bool wide = ctab != nullptr;
  if (B < 1 || N < 1 || M < 1 || D < 1 || E < 1 || H < 1 || C < 1 || C > 2 || S < 1 ||
      S > SH_STRIDE || F < 1 || n_paths < 1 || n_paths > MAX_PATHS || B > 65535 ||
      (N + TN - 1) / TN > 65535 || MS < 1 || MS > MS_MAX || (MS < M && part == nullptr) ||
      Mx < 1 || (idx == nullptr && Mx != M) ||
      (wide ? (E > WIDE_MAX || H > WIDE_MAX || n_ct < 1 || tpaths < 1 || tpaths > n_paths ||
               (ftp != 64 && ftp != 128) || (hcw != 0 && hcw != 8 && hcw != 16 && hcw != 32 &&
                                             hcw != 64) ||
               (long long)((M + MS - 1) / MS) * n_ct > INT_MAX)
            : (E < 4 || E % 4 || H < 4 || H % 4 || H > HP || H > E || F > 32 * NC_MAX || n_ct != 1 ||
               ftp != 0 || hcw != 0)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, sh, attr0, attr1, mask0, mask1, idx, w1, b1, w2, b2, chan, gtab, ctab, out, part,
               B, N, M, Mx, D, S, C, E, H, F, n_paths, MS, mask_is_f32, n_ct, tpaths, hcw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx != nullptr)
    return bf16 ? launch_nc<__nv_bfloat16, true>(a, ftp, st) : launch_nc<float, true>(a, ftp, st);
  return bf16 ? launch_nc<__nv_bfloat16, false>(a, ftp, st) : launch_nc<float, false>(a, ftp, st);
}

// Bytes of shared memory a block of the 4-lane kernel takes at these sizes
// (the narrow kernel at NC = ceil(F / 32), ftp 0; the wide one at its tile
// pitch ftp, esize the operands' bytes, hcw as dp_tp_fused takes it).
int dp_tp_fused_smem(int C, int E, int H, int D, int n_paths, int MS, int F, int idx, int ftp,
                     int tpaths, int esize, int hcw) {
  const int nc = ftp ? ftp / 32 : ((F + 31) / 32 < 2 ? 2 : (F + 31) / 32);
  return make_layout(C, E, H, D, n_paths, MS, nc, idx != 0, ftp != 0, tpaths, esize, hcw).total *
         (int)sizeof(float);
}

// The 8-lane kernel (irreps up to l = 2): out (B, N, F, 8); tables from
// tp_fused.tables_tiled_l2 (chan, ptab, gflat, ctab of n_ct channel tiles, the
// walk order and the layout's sizes DX, TS, GS, PC and FTP, 64 or 128); `part` holds
// (ceil(M / MS), B, N, F, 8) floats when the senders (slots) are split (MS <
// M).  Sender-index mode: idx (B, N, M) int32, x (B, Mx, D); dense: idx null,
// Mx = M.  `wide`: the wide kernel (any E, H <= WIDE_MAX; else E and H
// multiples of four, H <= 64), its weights resident (hcw 0) or staged in
// chunks of hcw hidden units.  Returns a cudaError_t value.
int dp_tp_fused_l2(const void* x, const void* sh, const void* attr0, const void* attr1,
                   const void* mask0, const void* mask1, const int* idx, const float* w1,
                   const float* b1, const float* w2, const float* b2, const int* chan,
                   const int* ptab, const float* gflat, const int* ctab, const int* walk,
                   float* out, float* part, int B, int N, int M, int Mx, int D, int S, int C,
                   int E, int H, int F,
                   int n_ct, int DX, int TS, int GS, int PC, int FTP, int MS, int mask_is_f32,
                   int wide, int hcw, int bf16, void* stream) {
  if (B < 1 || N < 1 || M < 1 || D < 1 || E < 1 || H < 1 ||
      (wide ? (E > WIDE_MAX || H > WIDE_MAX) : (E < 4 || E % 4 || H < 4 || H % 4 || H > L2_HP)) ||
      C < 1 || C > 2 || S < 1 || S > SH_STRIDE || F < 1 || n_ct < 1 || DX < 4 || DX % 4 ||
      TS < 1 || GS < 1 || PC < 1 || PC > L2_MAX_PATHS || (FTP != 64 && FTP != 128) ||
      B > 65535 || (N + L2_TN - 1) / L2_TN > 65535 || MS < 1 || MS > L2_MS_MAX ||
      (MS < M && part == nullptr) || Mx < 1 || (idx == nullptr && Mx != M) ||
      (long long)((M + MS - 1) / MS) * n_ct > INT_MAX ||
      (wide ? hcw != 0 && hcw != 8 && hcw != 16 && hcw != 32 && hcw != 64 : hcw != 0))
    return (int)cudaErrorInvalidValue;
  const ArgsL2 a{x, sh, attr0, attr1, mask0, mask1, idx, w1, b1, w2, b2, chan, ptab, gflat, ctab,
                 walk, out, part, B, N, M, Mx, D, S, C, E, H, F, n_ct, DX, TS, GS, PC, FTP, MS,
                 mask_is_f32, hcw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_l2_nch<__nv_bfloat16>(a, wide != 0, st)
              : launch_l2_nch<float>(a, wide != 0, st);
}

// Bytes of shared memory the 8-lane kernel takes at these sizes (the
// arguments of dp_tp_fused_l2, esize the operands' bytes); a launch that
// needs more than L2_SMEM (the wide kernel: MAX_SMEM) is refused.
int dp_tp_fused_l2_smem(int C, int E, int H, int DX, int TS, int GS, int PC, int MS, int FTP,
                        int esize, int wide, int hcw) {
  return make_layout_l2(C, E, H, DX, TS, GS, PC, MS, FTP, esize, wide != 0, hcw).total *
         (int)sizeof(float);
}

const char* dp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
