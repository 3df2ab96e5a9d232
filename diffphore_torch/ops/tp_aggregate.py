"""K2: channelwise tensor-product aggregate over pre-masked edge weights,
with its backward.

The port of ``diffphore_tpu/ops/pallas/tp_aggregate.py::tp_aggregate_pallas``
(the TPU kernel) as CUDA kernels for Hopper, ``csrc/tp_aggregate.cu``.  It is
``ChannelwiseTP.aggregate`` with every path in one launch:

    out[b,n,f,k] = alpha_p sum_{m,i,j} x[b,m,u_p(f),i] sh[b,n,m,j] C_p[i,j,k] w[b,n,m,f]

Output (B, N, F, L) f32, L = :func:`tp_fused.lanes` (4 where every irrep
has l <= 1, else 8): channel f's l_out components in lanes [:2*l_out+1],
the rest zero; :func:`tp_fused.blocks_from_padded` splits it into the
per-irrep blocks.  The training branch of ``DenseTPConv`` runs it
(the fused kernel K1 has no dropout and no backward).

:func:`tp_aggregate` launches the kernels for CUDA tensors, forward and,
through :class:`TPAggregate`, backward (``dw`` per edge and, where the
harmonics carry gradient, ``dsh`` per edge in one kernel, ``dx`` per sender
in another), and runs :func:`tp_aggregate_plain`,
the same function in plain PyTorch under autograd, for CPU tensors.
The forward and ``dx`` split the axis they sum over (senders, receivers)
across blocks as :func:`launch_splits` says; split blocks write partial sums
that a second kernel adds in a fixed order.  ``FWD``, ``BWD_EDGE`` and
``BWD_X`` count the wrapper calls that launched (one each, whether one
kernel ran or two).  A product whose irreps reach l = 2 runs the 8-lane
kernels of the same source, counted by ``FWD_L2``, ``BWD_EDGE_L2`` and
``BWD_X_L2``: the forward and dx by channel tile (``*_l2_tiled``: a block
per (batch row, ``KEEP`` kept entries, channel tile of
:func:`tp_fused.channel_tiles`, split of the summed axis as
:func:`launch_splits_l2` says), on the live edges that a streaming pass over
w marks (:func:`live_rows_l2`; made once by the autograd forward, read by
dx and by the edge backward's dsh), their split or per-tile partial sums
added by a second kernel in a fixed order); the edge backward forms each
receiver's P once (``tp_aggregate_l2_p_kernel``, :func:`p_entries_l2`),
then a block per (``EDGE_SLOTS`` senders, run of receivers, batch row) runs
warp = path (the paths of :func:`edge_plan_l2`, each with its shape fixed),
lane = sender, from :func:`path_tables_l2`.

Sender-index mode (the KNN phore grid): with ``sender_index`` (B, N, K)
int32, x is (B, M_x, D), sh and w are (B, N, K, .) and slot k of receiver n
reads the sender row ``x[b, sender_index[b, n, k]]``; dx adds each sender's
slots.  At both lane counts (4 where l <= 1): the forward is the dense
8-lane tiled forward with the slots as its summed axis (:func:`forward_idx`:
a block per (batch row, ``KEEP`` receivers, channel tile, split of at most
``IDX_SUMMED`` slots), each live slot's x slice read at the index into the
ring, on w's live bits, which the autograd forward makes once for it and
dx); the edge backward a block per receiver's slots (up to
``IDX_EDGE_SLOTS``), a thread per channel with P in registers formed once
for them, x read at the index (dw only: no phore conv needs dsh, which the
mode refuses); dx takes each sender's slots in chunks of at most ``IDX_Q``
(:func:`idx_dx_lists`, in the fixed order of :func:`tp_fused.sender_lists`,
built by the autograd forward), loads only the live ones (the forward's
live bits), and a second kernel adds each sender's chunks in order.
``FWD_IDX``, ``BWD_EDGE_IDX`` and ``BWD_X_IDX`` count the 4-lane launches,
the ``*_IDX_L2`` counters the 8-lane ones.

Widths.  A 4-lane row wider than ``SPLIT_F_MAX`` channels takes the tiled
forward and dx at 4 lanes (:func:`tiled`; counted by ``FWD`` and
``BWD_X``); the dense 8-lane edge backward takes fewer senders a block
where 32 would not fit (:func:`edge_slots_l2`).  :func:`check_shapes` gives
what each launch of a convolution needs from its shapes alone (no card)
and raises, naming the limit, on what the kernels do not take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build
from .tensor_product import ChannelwiseTP
from .tp_fused import (K_PAD, K_PAD_L2, MAX_PATHS_L2, SMEM, TARGET_BLOCKS, TILE_N, _check_tp,
                       _device_tables, _device_tables_tiled_l2, _Kernel, _pad4, _ptr,
                       check_index, counter, coupling, device_tables_l2, lanes,
                       padded_from_blocks, sender_lists, tables_l2, tables_tiled_l2)
from .tp_scalar import slot_chunks

FWD = _Kernel()        # tp_aggregate_fwd_kernel (+ tp_aggregate_sum_splits)
BWD_EDGE = _Kernel()   # tp_aggregate_bwd_edge_kernel (dw, and dsh when needed)
BWD_X = _Kernel()      # tp_aggregate_bwd_x_kernel (dx, + tp_aggregate_sum_splits)
FWD_L2 = _Kernel()       # tp_aggregate_fwd_l2_tiled_kernel (+ tp_aggregate_sum_splits)
BWD_EDGE_L2 = _Kernel()  # tp_aggregate_l2_p_kernel + tp_aggregate_bwd_edge_l2_kernel<T, DSH>
BWD_X_L2 = _Kernel()     # tp_aggregate_bwd_x_l2_tiled_kernel (+ tp_aggregate_l2_dx_sum)
FWD_IDX = _Kernel()          # the sender-index mode: tp_aggregate_l2_live_kernel +
#                              tp_aggregate_fwd_idx_tiled_kernel<T, 4> (+ tp_aggregate_sum_splits)
BWD_EDGE_IDX = _Kernel()     # tp_aggregate_bwd_edge_idx_kernel<T, 4>
BWD_X_IDX = _Kernel()        # tp_aggregate_bwd_x_idx_l2_kernel<T, 4> + tp_aggregate_bwd_x_idx_sum
FWD_IDX_L2 = _Kernel()       # the same at 8 lanes (l = 2)
BWD_EDGE_IDX_L2 = _Kernel()
BWD_X_IDX_L2 = _Kernel()
KEEP = 8               # receivers (forward) or senders (dx) one block keeps (both lane counts)
TILE_SUM = 4           # entries of the summed axis in one tile of a block
SPLIT_F_MAX = 256      # widest 4-lane row the split forward and dx take (a thread pair a channel)
IDX_THREADS = 384      # most threads of a sender-index dw or dx block (a channel a thread)
IDX_XC = 3             # channels a thread of the sender-index dx takes at most


def tp_aggregate_plain(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
                       w: torch.Tensor, sender_index: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``tp.aggregate`` packed into
    (B, N, F, lanes(tp)) f32 (bf16 operands multiplied and summed in f32, with the
    coupling tensors rounded to bf16).  Differentiable by autograd in x, sh
    and w.  ``sender_index``: the sender-index mode (module note)."""
    _check_tp(tp)
    return padded_from_blocks(tp, tp.aggregate(x, sh, w, sender_index))


@functools.lru_cache(maxsize=None)
def tiled(tp: ChannelwiseTP) -> bool:
    """True when the dense forward and dx run the tiled kernels (by channel
    tile of :func:`tp_fused.channel_tiles`, on the live pass's bits): at 8
    lanes always, at 4 lanes where a row is wider than the split kernels'
    ``SPLIT_F_MAX`` channels."""
    return lanes(tp) == K_PAD_L2 or tp.weight_numel > SPLIT_F_MAX


@functools.lru_cache(maxsize=None)
def _backward_tables(tp: ChannelwiseTP, stride: int = 4
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per path (f_start, f_count, d_sh, d_out) int32 (n_paths, 4); and, per
    input element d, the (channel, component) pairs that read it: extents
    ``d_ptr`` (D + 1) into ``d_item`` (entries f * stride + i, ascending)."""
    in_slices = tp.irreps_in.slices()
    ptab = np.zeros((len(tp.paths), 4), np.int32)
    readers = [[] for _ in range(tp.irreps_in.dim)]
    for q, p in enumerate(tp.paths):
        d1 = 2 * p.l_in + 1
        ptab[q] = (p.w_slice[0], p.mul_in, 2 * p.l_sh + 1, 2 * p.l_out + 1)
        for u in range(p.mul_in):
            for i in range(d1):
                readers[in_slices[p.i_in].start + u * d1 + i].append(
                    (p.w_slice[0] + u) * stride + i)
    d_ptr = np.zeros(len(readers) + 1, np.int32)
    d_ptr[1:] = np.cumsum([len(r) for r in readers])
    d_item = np.array([it for r in readers for it in sorted(r)] or [0], np.int32)
    return ptab, d_ptr, d_item


@functools.lru_cache(maxsize=None)
def _device_backward_tables(tp: ChannelwiseTP, device: str, stride: int = 4):
    return tuple(torch.as_tensor(t, device=device) for t in _backward_tables(tp, stride))


@functools.lru_cache(maxsize=None)
def _dsh_segments(tp: ChannelwiseTP) -> Tuple[np.ndarray, np.ndarray]:
    """Per harmonic component s, the paths whose harmonics reach it: extents
    ``seg_ptr`` (S + 1) into ``seg`` (rows path index, j = s - sh_off, in path
    order).  ``dsh[..., s]`` is the sum of term j of every listed path."""
    sh_slices = tp.irreps_sh.slices()
    rows = [[] for _ in range(tp.irreps_sh.dim)]
    for q, p in enumerate(tp.paths):
        off = sh_slices[p.i_sh].start
        for j in range(2 * p.l_sh + 1):
            rows[off + j].append((q, j))
    seg_ptr = np.zeros(len(rows) + 1, np.int32)
    seg_ptr[1:] = np.cumsum([len(r) for r in rows])
    seg = np.array([it for r in rows for it in r] or [(0, 0)], np.int32)
    return seg_ptr, seg


@functools.lru_cache(maxsize=None)
def _device_dsh_segments(tp: ChannelwiseTP, device: str):
    return tuple(torch.as_tensor(t, device=device) for t in _dsh_segments(tp))


EDGE_SENDERS = (16, 8, 4, 2)   # senders a block of the edge backward may take


@functools.lru_cache(maxsize=None)
def plan_edge_senders(B: int, N: int, M: int) -> int:
    """Senders per block of the edge backward on (B, N, M): the most of
    ``EDGE_SENDERS`` that still gives ``TARGET_BLOCKS`` blocks of (batch row,
    ``TILE_N`` receivers, that many senders), else the fewest.  The kernel
    takes any count from 1 to 16."""
    tiles = B * -(-N // TILE_N)
    for mt in EDGE_SENDERS:
        if tiles * -(-M // mt) >= TARGET_BLOCKS:
            return mt
    return EDGE_SENDERS[-1]


@functools.lru_cache(maxsize=None)
def plan_splits(B: int, kept: int, summed: int, target: int = TARGET_BLOCKS) -> int:
    """Splits of the summed axis of the forward (``plan_splits(B, N, M)``:
    senders) or of dx (``plan_splits(B, M, N)``: receivers).

    A block takes one batch row, ``KEEP`` entries of the kept axis and
    every ``splits``-th entry of the summed one (split k: k, k + splits,
    ...), ``TILE_SUM`` of them a tile.  The fewest splits that give
    ``target`` blocks, but none with less than a tile of work where the
    summed axis has one.  One split needs no scratch buffer and no second
    kernel.
    """
    tiles = B * -(-kept // KEEP)
    return max(1, min(-(-target // tiles), summed // TILE_SUM))


@functools.lru_cache(maxsize=None)
def _resident_blocks(tp: ChannelwiseTP, dx: bool, device: str, bf16: bool) -> int:
    """Blocks of the forward (or dx) kernel the card holds at once at this
    convolution's widths and operand type (its shared memory and registers
    decide)."""
    n_items = len(_backward_tables(tp)[2])
    per_sm = _library().dp_tp_aggregate_blocks_per_sm(
        int(dx), tp.irreps_in.dim, tp.weight_numel, len(tp.paths), n_items, int(bf16))
    _raise_on(max(0, -per_sm), "tp_aggregate occupancy query")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def launch_splits(tp: ChannelwiseTP, B: int, N: int, M: int, dx: bool, device,
                  dtype: torch.dtype = torch.float32) -> int:
    """The splits the forward (or dx) launch takes on the card: enough
    blocks for two per SM and for every block the card can hold at once."""
    target = max(TARGET_BLOCKS,
                 _resident_blocks(tp, dx, str(device), dtype == torch.bfloat16))
    return plan_splits(B, M, N, target) if dx else plan_splits(B, N, M, target)


@functools.lru_cache(maxsize=None)
def dx_lists_l2(tp: ChannelwiseTP) -> Tuple[np.ndarray, np.ndarray, int]:
    """The 8-lane dx's lists by channel tile (:func:`tp_fused.channel_tiles`):
    for tile t and element e of its x slice [x_lo, x_lo + xw)
    (``tables_tiled_l2``), the (tile channel, component) pairs that read x
    element x_lo + e, extents ``dptr[t, e]`` .. ``dptr[t, e + 1]`` ((tiles,
    DXW + 1) int32, absolute, flat past xw) into ``ditem`` (entries (f - f0)
    * 8 + i, ascending within an element); and the longest tile's list."""
    chan, _, _, ctab, _, dims = tables_tiled_l2(tp)
    dxw = dims[0]
    dptr = np.zeros((len(ctab), dxw + 1), np.int32)
    items = []
    for t, (f0, fc, _, _, _, xw, _, _) in enumerate(ctab.tolist()):
        readers = [[] for _ in range(xw)]
        for f in range(f0, f0 + fc):
            xo, d1 = int(chan[f, 0]), int(chan[f, 1])
            for i in range(d1):
                readers[xo + i].append((f - f0) * K_PAD_L2 + i)
        dptr[t] = len(items)
        for e in range(xw):
            items.extend(sorted(readers[e]))
            dptr[t, e + 1:] = len(items)
    longest = int((dptr[:, -1] - dptr[:, 0]).max())
    return dptr, np.array(items or [0], np.int32), longest


WALK_L2 = 128   # walk slots of a channel tile: the channels a part of a block's threads takes


@functools.lru_cache(maxsize=None)
def walk_l2(tp: ChannelwiseTP) -> np.ndarray:
    """The tiled forward's and dx's walk by channel tile: (tiles, WALK_L2)
    int32, the tile channel (f - f0) of each slot of a part of the block's
    threads, or -1.  A tile of up to 64 channels takes 64 slots (four
    parts), a wider one 128 (two).  A warp (32 slots) runs each channel
    shape (d_in, d_out) it holds in turn, so the channels are packed to
    warps by shape: shapes by falling cost (d_in d_out + d_in), each into
    the warps that already hold it, else the warp with the most free
    slots, its channels in order."""
    chan, _, _, ctab, _, _ = tables_tiled_l2(tp)
    slots = np.full((len(ctab), WALK_L2), -1, np.int32)
    for t, (f0, fc, *_) in enumerate(ctab.tolist()):
        shapes = [(int(chan[f0 + f, 1]), int(chan[f0 + f, 2])) for f in range(fc)]
        groups = {}
        for f, shape in enumerate(shapes):
            groups.setdefault(shape, []).append(f)
        warps = [[] for _ in range((128 if fc > 64 else 64) // 32)]
        for shape, chs in sorted(groups.items(), key=lambda kv: (-(kv[0][0] * (kv[0][1] + 1)),
                                                                 kv[0])):
            while chs:
                k = min((k for k, wp in enumerate(warps) if len(wp) < 32),
                        key=lambda k: (shape not in {shapes[f] for f in warps[k]},
                                       len(warps[k]), k))
                n = min(32 - len(warps[k]), len(chs))
                warps[k] += chs[:n]
                chs = chs[n:]
        for k, wp in enumerate(warps):
            slots[t, 32 * k:32 * k + len(wp)] = wp
    return slots


@functools.lru_cache(maxsize=None)
def _device_walk_l2(tp: ChannelwiseTP, device: str) -> torch.Tensor:
    return torch.as_tensor(walk_l2(tp), device=device)


@functools.lru_cache(maxsize=None)
def _device_dx_lists_l2(tp: ChannelwiseTP, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    dptr, ditem, _ = dx_lists_l2(tp)
    return torch.as_tensor(dptr, device=device), torch.as_tensor(ditem, device=device)


MAX_SUMMED_L2 = 1024   # summed entries one block of the 8-lane tiled kernels takes at most


@functools.lru_cache(maxsize=None)
def plan_splits_l2(B: int, kept: int, summed: int, tiles: int,
                   target: int = TARGET_BLOCKS) -> int:
    """Splits of the summed axis of the 8-lane tiled forward
    (``plan_splits_l2(B, N, M, tiles)``: senders) or dx (``(B, M, N,
    tiles)``: receivers): as :func:`plan_splits`, with the channel tiles a
    factor of the grid, and at most ``MAX_SUMMED_L2`` entries a split."""
    blocks = B * -(-kept // KEEP) * tiles
    return max(1, min(-(-target // blocks), summed // TILE_SUM), -(-summed // MAX_SUMMED_L2))


PT_W = 12          # ints of a path's row in :func:`path_tables_l2`
EDGE_SLOTS = 32    # senders (slots) a block of the 8-lane edge backward takes: lane = sender
EDGE_WARPS = 8     # warps of that block, each walking the paths :func:`edge_plan_l2` gives it
IDX_Q = 32         # slots a chunk of the sender-index dx takes at most
MIN_SLOTS = 4      # fewest slots a chunk takes, where there are enough


@functools.lru_cache(maxsize=None)
def path_tables_l2(tp: ChannelwiseTP, dtype: torch.dtype = torch.float32):
    """The tables of the 8-lane edge backward and of the sender-index dx:
    per channel (x_base, d_in, d_out, path) int32 (F, 4)
    (:func:`tp_fused.tables_l2`'s); per path int32 (n_paths, ``PT_W``):
    (sh_off, d_in, d_sh, d_out, f0, fc, x0 (the x offset of its first
    channel), t_off (its t block in a slot's t row, d_in x d_out padded to
    float4s), g_off (its coupling entries in ``gflat``), p_off (its
    channels' P blocks, d_in x d_sh each padded to float4s), part_off (its
    d_sh dsh sums over the edge backward's ``EDGE_SLOTS`` senders), 0);
    alpha * cg of every path (cg rounded to ``dtype``), its d_in x d_sh x
    d_out entries flat in path order (f32); and the sizes (PT, PS, TS, GS):
    the floats of P, of the dsh sums, of a t row and of ``gflat``."""
    chan, _, _, _ = tables_l2(tp, dtype)
    sh_slices = tp.irreps_sh.slices()
    ptab = np.zeros((len(tp.paths), PT_W), np.int32)
    gflat = []
    t_off = g_off = p_off = part_off = 0
    for q, p in enumerate(tp.paths):
        d1, d2, d3 = 2 * p.l_in + 1, 2 * p.l_sh + 1, 2 * p.l_out + 1
        f0, fc = p.w_slice[0], p.mul_in
        ptab[q] = (sh_slices[p.i_sh].start, d1, d2, d3, f0, fc, chan[f0, 0], t_off, g_off, p_off,
                   part_off, 0)
        gflat.append(coupling(p, dtype).reshape(-1))
        t_off += -(-d1 * d3 // 4) * 4
        g_off += d1 * d2 * d3
        p_off += fc * (-(-d1 * d2 // 4) * 4)
        part_off += d2 * EDGE_SLOTS
    return chan, ptab, np.concatenate(gflat).astype(np.float32), (p_off, part_off, t_off, g_off)


@functools.lru_cache(maxsize=None)
def _device_path_tables_l2(tp: ChannelwiseTP, device: str, dtype: torch.dtype):
    *tables, sizes = path_tables_l2(tp, dtype)
    return tuple(torch.as_tensor(t, device=device) for t in tables) + (sizes,)


@functools.lru_cache(maxsize=None)
def p_entries_l2(tp: ChannelwiseTP) -> np.ndarray:
    """The edge backward's P row, entry by entry: (PT, 4) int32, entry
    p_off + u * pad4(d_in d_sh) + i d_sh + j of path p is (its channel f0 +
    u, the offset of G_p[i, j, :] in ``path_tables_l2``'s gflat, d_out, 1);
    a pad entry is zeros.  P[e] = sum_k gflat[e.1 + k] g[receiver, e.0, k],
    k < e.2."""
    _, ptab, _, (PT, _, _, _) = path_tables_l2(tp)
    out = np.zeros((PT, 4), np.int32)
    for row in ptab.tolist():
        d1, d2, d3, f0, fc, g_off, p_off = row[1], row[2], row[3], row[4], row[5], row[8], row[9]
        pp = -(-d1 * d2 // 4) * 4
        for u in range(fc):
            for ij in range(d1 * d2):
                out[p_off + u * pp + ij] = (f0 + u, g_off + ij * d3, d3, 1)
    return out


@functools.lru_cache(maxsize=None)
def _device_p_entries_l2(tp: ChannelwiseTP, device: str) -> torch.Tensor:
    return torch.as_tensor(p_entries_l2(tp), device=device)


@functools.lru_cache(maxsize=None)
def pi_items_l2(tp: ChannelwiseTP) -> np.ndarray:
    """The sender-index dx's t items: p * 8 + i of every (path p, i <
    d_in), in path order (int32)."""
    return np.array([q * 8 + i for q, p in enumerate(tp.paths) for i in range(2 * p.l_in + 1)],
                    np.int32)


@functools.lru_cache(maxsize=None)
def _device_pi_items_l2(tp: ChannelwiseTP, device: str) -> torch.Tensor:
    return torch.as_tensor(pi_items_l2(tp), device=device)


def _path_cost(row: np.ndarray) -> int:
    """A path's work in the edge backward, per sender: its channels x
    (d_in d_sh + 2 d_sh + d_in)."""
    d_in, d_sh, fc = int(row[1]), int(row[2]), int(row[5])
    return fc * (d_in * d_sh + 2 * d_sh + d_in)


@functools.lru_cache(maxsize=None)
def edge_plan_l2(tp: ChannelwiseTP) -> np.ndarray:
    """Each warp's paths in the edge backward (warp = path, lane = sender):
    (EDGE_WARPS, width) int32, -1 past a warp's last.  The paths by falling
    cost (:func:`_path_cost`), each to the warp with the least work so far
    (the lowest such warp); a warp walks its paths in the order taken."""
    ptab = path_tables_l2(tp)[1]
    load = [0] * EDGE_WARPS
    lists = [[] for _ in range(EDGE_WARPS)]
    for q in sorted(range(len(ptab)), key=lambda q: (-_path_cost(ptab[q]), q)):
        k = min(range(EDGE_WARPS), key=lambda k: (load[k], k))
        lists[k].append(q)
        load[k] += _path_cost(ptab[q])
    width = max(len(lt) for lt in lists)
    plan = np.full((EDGE_WARPS, width), -1, np.int32)
    for k, lt in enumerate(lists):
        plan[k, :len(lt)] = lt
    return plan


@functools.lru_cache(maxsize=None)
def _device_edge_plan_l2(tp: ChannelwiseTP, device: str) -> torch.Tensor:
    return torch.as_tensor(edge_plan_l2(tp), device=device)


EDGE_RN_MAX = 8    # receivers a block of the edge backward takes at most
IDX_EDGE_SLOTS = 32  # slots a block of the sender-index dw takes: a receiver's K up to 32


@functools.lru_cache(maxsize=None)
def plan_edge_receivers(B: int, N: int, M: int, target: int = 2 * TARGET_BLOCKS,
                        slots: int = EDGE_SLOTS) -> int:
    """Receivers a block of the dense 8-lane edge backward takes, one after
    another: the most (up to ``EDGE_RN_MAX``) that still leave ``target``
    blocks of (``slots`` senders, receivers, batch row), so that the
    chunk's x rows are staged once for them."""
    units = B * N * -(-M // slots)
    return max(1, min(EDGE_RN_MAX, N, units // target))


def edge_smem_l2(need_dsh: bool, D: int, F: int, PT: int, PS: int, slots: int) -> int:
    """Bytes of shared memory a block of the dense 8-lane edge backward
    takes (``edge_layout`` in csrc/tp_aggregate.cu)."""
    return 4 * (_pad4(PT) + slots * ((D | 1) + (F | 1) + 13) + (PS if need_dsh else 0))


@functools.lru_cache(maxsize=None)
def edge_slots_l2(tp: ChannelwiseTP, need_dsh: bool) -> int:
    """Senders a block of the dense 8-lane edge backward takes:
    ``EDGE_SLOTS`` (lane = sender), or, where their x and w rows would not
    fit the block's shared memory beside the receiver's P, the most of 24,
    16 and 8 that do."""
    _, _, _, (PT, PS, _, _) = path_tables_l2(tp)
    D, F = tp.irreps_in.dim, tp.weight_numel
    for slots in (EDGE_SLOTS, 24, 16, 8):
        if edge_smem_l2(need_dsh, D, F, PT, PS, slots) <= SMEM:
            return slots
    raise ValueError(f"tp_aggregate: D = {D}, F = {F}: the 8-lane edge backward's block needs "
                     f"more than the {SMEM} bytes of shared memory it has")


def edge_grid_l2(B: int, N: int, M: int, indexed: bool = False,
                 slots: int = EDGE_SLOTS) -> Tuple[int, int]:
    """(blocks, receivers a block) of an edge-backward launch: dense at 8
    lanes a block per (sender chunk of ``slots``, run of receivers, batch
    row); in the sender-index mode a block per (``IDX_EDGE_SLOTS`` slots,
    receiver, batch row)."""
    if indexed:
        return -(-M // IDX_EDGE_SLOTS) * N * B, 1
    rn = plan_edge_receivers(B, N, M, slots=slots)
    return -(-M // slots) * -(-N // rn) * B, rn


@functools.lru_cache(maxsize=None)
def plan_idx_chunk(slots: int, senders: int, target: int = 4 * TARGET_BLOCKS
                   ) -> Tuple[int, int]:
    """(Q, bound) of the sender-index dx over ``slots`` slots and
    ``senders`` sender rows: Q, the most slots one chunk (one block) takes:
    ``IDX_Q`` where the slots give ``target`` chunks of it, fewer (down to
    ``MIN_SLOTS``) where they do not; ``bound``, the most chunks any index can
    give at that Q (each sender's last chunk may be short): the grid and the
    scratch's rows."""
    Q = min(IDX_Q, max(MIN_SLOTS, slots // target))
    return Q, slots // Q + min(senders, slots)


class IdxDxLists(NamedTuple):
    """What the sender-index dx reads of an index: (order, ptr) of
    :func:`tp_fused.sender_lists` and (cuts, row_ptr) of
    :func:`tp_scalar.slot_chunks` at :func:`plan_idx_chunk`'s Q."""

    order: torch.Tensor
    ptr: torch.Tensor
    cuts: torch.Tensor
    row_ptr: torch.Tensor
    Q: int


def idx_dx_lists(sender_index: torch.Tensor, m_x: int) -> IdxDxLists:
    """The sender-index dx's lists for a (B, N, K) index over B * m_x
    senders, on the index's device and without waiting for it: each
    sender's slots in ascending order, cut into chunks of at most Q.  The
    autograd forward builds them once."""
    B, N, K = sender_index.shape
    Q, bound = plan_idx_chunk(B * N * K, B * m_x)
    order, ptr = sender_lists(sender_index, m_x)
    return IdxDxLists(order, ptr, *slot_chunks(ptr, Q, bound), Q)


def live_rows_plain(w: torch.Tensor) -> torch.Tensor:
    """The live pass's function in plain PyTorch: bit e % 32 of word e // 32
    (int32, (E + 31) // 32 words, E = w's rows) set where row e of w
    (B, N, M, F) holds a nonzero."""
    live = (w != 0).any(-1).reshape(-1)
    pad = torch.zeros(-(-live.numel() // 32) * 32, dtype=torch.int64, device=w.device)
    pad[:live.numel()] = live.to(torch.int64)
    words = (pad.reshape(-1, 32) << torch.arange(32, device=w.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def live_rows_l2(w: torch.Tensor) -> torch.Tensor:
    """The live pass on the card (``tp_aggregate_l2_live_kernel``): the bits
    of :func:`live_rows_plain` for a CUDA w (B, N, M, F), f32 or bf16,
    contiguous.  The dense 8-lane forward and dx load and walk only the
    edges it marks; the autograd forward makes it once for both."""
    if w.device.type != "cuda" or w.dtype not in (torch.float32, torch.bfloat16) \
            or w.dim() != 4 or not w.is_contiguous():
        raise ValueError("tp_aggregate: the live pass takes a contiguous f32 or bf16 CUDA w "
                         "(B, N, M, F)")
    rows, F, es = w.numel() // w.shape[-1], w.shape[-1], w.element_size()
    unit = next(u for u in (16, 8, 4, es) if F * es % u == 0 and w.data_ptr() % u == 0)
    bits = torch.empty(-(-rows // 32), dtype=torch.int32, device=w.device)
    _raise_on(_library().dp_tp_aggregate_l2_live(w.data_ptr(), bits.data_ptr(), rows, F, unit,
                                                 int(w.dtype == torch.bfloat16),
                                                 _stream(w.device)),
              "tp_aggregate_l2_live")
    return bits


def layout_sizes_l2(tp: ChannelwiseTP, dx: bool) -> Tuple[int, ...]:
    """(FTP, DXW, TS, GS, PC, NI) of the tiled forward's (NI 0) or dx's
    shared memory at this convolution's channel tiles."""
    *_, (dxw, ts, gs, pc, ftp) = tables_tiled_l2(tp)
    return ftp, dxw, ts, gs, pc, dx_lists_l2(tp)[2] if dx else 0


@functools.lru_cache(maxsize=None)
def _resident_blocks_l2(tp: ChannelwiseTP, dx: bool, device: str, bf16: bool) -> int:
    """Blocks of the tiled forward (or dx) the card holds at once at this
    convolution's channel tiles, lanes and operand type."""
    per_sm = _library().dp_tp_aggregate_l2_blocks_per_sm(int(dx), *layout_sizes_l2(tp, dx),
                                                         lanes(tp), int(bf16))
    _raise_on(max(0, -per_sm), "tp_aggregate_l2 occupancy query")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def launch_splits_l2(tp: ChannelwiseTP, B: int, N: int, M: int, dx: bool, device,
                     dtype: torch.dtype = torch.float32) -> int:
    """The splits the 8-lane tiled forward (or dx) takes on the card: enough
    blocks for two per SM and for every block the card can hold at once."""
    tiles = len(tables_tiled_l2(tp)[3])
    target = max(TARGET_BLOCKS,
                 _resident_blocks_l2(tp, dx, str(device), dtype == torch.bfloat16))
    return plan_splits_l2(B, M, N, tiles, target) if dx else plan_splits_l2(B, N, M, tiles, target)


def grid_l2(tp: ChannelwiseTP, B: int, N: int, M: int, dx: bool, device,
            dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(blocks, splits) of an 8-lane tiled forward (or dx) launch."""
    splits = launch_splits_l2(tp, B, N, M, dx, device, dtype)
    kept = M if dx else N
    return B * -(-kept // KEEP) * len(tables_tiled_l2(tp)[3]) * splits, splits


IDX_SUMMED = 64   # slots one block of the sender-index forward takes at most (a split's)


@functools.lru_cache(maxsize=None)
def plan_splits_idx(B: int, N: int, K: int, tiles: int, target: int = TARGET_BLOCKS) -> int:
    """Splits of the slots of the sender-index forward (a block per (batch
    row, ``KEEP`` receivers, channel tile, split)): :func:`plan_splits_l2`,
    and enough that no split takes more than ``IDX_SUMMED`` slots (a block
    keeps its slots' sender rows in shared memory)."""
    return max(plan_splits_l2(B, N, K, tiles, target), -(-K // IDX_SUMMED))


@functools.lru_cache(maxsize=None)
def _resident_blocks_idx(tp: ChannelwiseTP, device: str, bf16: bool) -> int:
    """Blocks of the sender-index forward the card holds at once at this
    convolution's channel tiles and operand type."""
    per_sm = _library().dp_tp_aggregate_idx_fwd_blocks_per_sm(
        *layout_sizes_l2(tp, False)[:5], lanes(tp), int(bf16))
    _raise_on(max(0, -per_sm), "tp_aggregate_fwd_idx occupancy query")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def grid_idx(tp: ChannelwiseTP, B: int, N: int, K: int, device,
             dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(blocks, splits) of a sender-index forward launch on (B, N, K):
    enough blocks for two per SM and for every block the card can hold at
    once."""
    tiles = len(tables_tiled_l2(tp)[3])
    target = max(TARGET_BLOCKS, _resident_blocks_idx(tp, str(device), dtype == torch.bfloat16))
    splits = plan_splits_idx(B, N, K, tiles, target)
    return B * -(-N // KEEP) * tiles * splits, splits


@functools.lru_cache(maxsize=None)
def _row_unit_l2(tp: ChannelwiseTP, esize: int) -> int:
    """The widest cp.async piece (16, 8 or 4 bytes) dividing a row of w and
    each channel tile's first channel and width, at esize bytes an element."""
    ctab = tables_tiled_l2(tp)[3]
    sizes = [tp.weight_numel] + ctab[:, 0].tolist() + ctab[:, 1].tolist()
    for unit in (16, 8, 4):
        if all(n * esize % unit == 0 for n in sizes):
            return unit
    return 0


def _w_unit_l2(tp: ChannelwiseTP, w: torch.Tensor) -> int:
    """:func:`_row_unit_l2`, narrowed to what w's address allows."""
    unit = _row_unit_l2(tp, w.element_size())
    while unit and w.data_ptr() % unit:
        unit //= 2
    return unit if unit >= 4 else 0


def split_smem(dx: bool, F: int, D: int, n_paths: int, n_items: int, esize: int) -> int:
    """Bytes of shared memory a block of the 4-lane split forward (dx False)
    or dx takes (``split_layout`` in csrc/tp_aggregate.cu)."""
    per = 16 // esize
    stage = _pad4(32 * (-(-F // per) * per) * esize // 4 + 32 * 12
                  + (TILE_SUM * 4 * F if dx else TILE_SUM * _pad4(D)))
    return 4 * (2 * stage + 32 * n_paths * 12 + _pad4(n_paths * 45) + 16 + 32
                + (_pad4(D + 1) + _pad4(n_items) if dx else 0))


def tiled_smem(dx: bool, FTP: int, DXW: int, TS: int, GS: int, PC: int, NI: int, esize: int,
               idx: bool = False) -> int:
    """Bytes of shared memory a block of the tiled forward (dx False, the
    sender-index forward with ``idx``) or dx takes (``t2_layout``)."""
    side = 4 * FTP * 5 if dx else (32 if idx else 4) * DXW * esize // 4
    stage = _pad4(32 * FTP * esize // 4 + 32 * 13 + side)
    floats = (2 * stage + _pad4(32 * TS) + _pad4(GS) + _pad4(PC * 8) + _pad4(PC * 5) + 8 * 32
              + 256 + 260 + (_pad4(DXW + 1) + _pad4(NI) if dx else 0) + (8 * 64 if idx else 0))
    return 4 * (max(floats, 8 * 5 * (FTP | 1)) if dx else floats)


def idx_dx_smem(D: int, F: int, n_paths: int, TS: int, GS: int, n_items: int, esize: int,
                k_pad: int) -> int:
    """Bytes of shared memory a block of the sender-index dx's chunk kernel
    takes (``xi_layout``)."""
    per = 16 // esize
    stage = _pad4(4 * (-(-F // per) * per) * esize // 4 + _pad4(4 * 13) + 4 * F * 4
                  + (4 * F if k_pad == K_PAD_L2 else 0))
    floats = 2 * stage + _pad4(4 * TS) + _pad4(GS) + _pad4(n_paths * 5) + 36
    return 4 * (max(floats, _pad4(5 * F)) + _pad4(D + 1) + _pad4(n_items))


def check_shapes(tp: ChannelwiseTP, esize: int, indexed: bool = False,
                 need_dsh: bool = False) -> dict:
    """What the K2 launches of a convolution need, from its shapes alone (no
    card): the shared memory a block of each kernel takes, by kernel
    (``fwd``, ``bwd_edge``, ``bwd_x``); raises where a kernel does not take
    the convolution (the limit in the message).  ``indexed``: the
    sender-index mode (dw only), else dense, with dsh where ``need_dsh``."""
    _check_tp(tp)
    k_pad, D, F, n_paths = lanes(tp), tp.irreps_in.dim, tp.weight_numel, len(tp.paths)
    if k_pad == K_PAD_L2 and n_paths > MAX_PATHS_L2:
        raise ValueError(f"tp_aggregate: at most {MAX_PATHS_L2} paths")
    out = {}
    if indexed or tiled(tp):
        *_, dims = tables_tiled_l2(tp)
        out["fwd"] = tiled_smem(False, dims[4], *dims[:4], 0, esize, indexed)
    else:
        if n_paths > 16:
            raise ValueError("tp_aggregate: at most 16 paths")
        out["fwd"] = split_smem(False, F, D, n_paths, len(_backward_tables(tp)[2]), esize)
    if indexed:
        if F > IDX_XC * IDX_THREADS:
            raise ValueError(f"tp_aggregate: F = {F}: the sender-index dx takes at most "
                             f"{IDX_XC * IDX_THREADS} channels")
        _, _, _, (_, _, TS, GS) = path_tables_l2(tp)
        out["bwd_edge"] = 0
        out["bwd_x"] = idx_dx_smem(D, F, n_paths, TS, GS, len(_backward_tables(tp, 8)[2]), esize,
                                   k_pad)
    else:
        if k_pad == K_PAD_L2:
            _, _, _, (PT, PS, _, _) = path_tables_l2(tp)
            out["bwd_edge"] = edge_smem_l2(need_dsh, D, F, PT, PS, edge_slots_l2(tp, need_dsh))
        elif need_dsh:
            n_seg = len(_dsh_segments(tp)[1])
            S = tp.irreps_sh.dim
            out["bwd_edge"] = 4 * (F * 16 + 32 * ((F | 1) + (D | 1) + 13) + n_paths * 32 * 5
                                   + _pad4(S + 1) + n_seg * 2)
        else:
            out["bwd_edge"] = 4 * (n_paths * 45 + TILE_N * EDGE_SENDERS[0] * 12
                                   + EDGE_SENDERS[0] * D)
        if tiled(tp):
            out["bwd_x"] = tiled_smem(True, *layout_sizes_l2(tp, True), esize)
        else:
            out["bwd_x"] = split_smem(True, F, D, n_paths, len(_backward_tables(tp)[2]), esize)
    for kernel, smem in out.items():
        if smem > SMEM:
            raise ValueError(f"tp_aggregate: the {kernel} kernel's block needs {smem} bytes of "
                             f"shared memory, more than the {SMEM} it has")
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("tp_aggregate")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dp_tp_aggregate_fwd.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.dp_tp_aggregate_bwd_edge.argtypes = [p] * 11 + [i] * 10 + [p]
    lib.dp_tp_aggregate_bwd_x.argtypes = [p] * 10 + [i] * 10 + [p]
    lib.dp_tp_aggregate_blocks_per_sm.argtypes = [i] * 6
    lib.dp_tp_aggregate_fwd_idx_tiled.argtypes = [p] * 12 + [i] * 17 + [p]
    lib.dp_tp_aggregate_idx_fwd_smem.argtypes = [i] * 6
    lib.dp_tp_aggregate_idx_fwd_blocks_per_sm.argtypes = [i] * 7
    lib.dp_tp_aggregate_bwd_edge_l2.argtypes = [p] * 14 + [i] * 13 + [p]
    lib.dp_tp_aggregate_bwd_edge_idx.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.dp_tp_aggregate_bwd_x_idx_l2.argtypes = [p] * 15 + [i] * 15 + [p]
    lib.dp_tp_aggregate_fwd_l2_tiled.argtypes = [p] * 11 + [i] * 16 + [p]
    lib.dp_tp_aggregate_bwd_x_l2_tiled.argtypes = [p] * 13 + [i] * 17 + [p]
    lib.dp_tp_aggregate_l2_smem.argtypes = [i] * 8
    lib.dp_tp_aggregate_l2_blocks_per_sm.argtypes = [i] * 9
    lib.dp_tp_aggregate_l2_live.argtypes = [p, p, ctypes.c_longlong, i, i, i, p]
    lib.dp_tp_aggregate_edge_l2_smem.argtypes = [i] * 6
    lib.dp_tp_aggregate_idx_dx_l2_smem.argtypes = [i] * 8
    lib.dp_tp_aggregate_edge_l2_blocks_per_sm.argtypes = [i] * 7
    for fn in (lib.dp_tp_aggregate_fwd, lib.dp_tp_aggregate_bwd_edge, lib.dp_tp_aggregate_bwd_x,
               lib.dp_tp_aggregate_blocks_per_sm, lib.dp_tp_aggregate_fwd_idx_tiled,
               lib.dp_tp_aggregate_idx_fwd_smem, lib.dp_tp_aggregate_idx_fwd_blocks_per_sm,
               lib.dp_tp_aggregate_bwd_edge_l2, lib.dp_tp_aggregate_bwd_x_idx_l2,
               lib.dp_tp_aggregate_fwd_l2_tiled, lib.dp_tp_aggregate_bwd_x_l2_tiled,
               lib.dp_tp_aggregate_l2_smem, lib.dp_tp_aggregate_l2_blocks_per_sm,
               lib.dp_tp_aggregate_l2_live, lib.dp_tp_aggregate_edge_l2_smem,
               lib.dp_tp_aggregate_idx_dx_l2_smem, lib.dp_tp_aggregate_edge_l2_blocks_per_sm,
               lib.dp_tp_aggregate_bwd_edge_idx):
        fn.restype = i
    lib.dp_cuda_error_string.argtypes = [i]
    lib.dp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_library().dp_cuda_error_string(rc).decode()}")


def _check_inputs(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                  g: Optional[torch.Tensor] = None,
                  sender_index: Optional[torch.Tensor] = None) -> Tuple[int, ...]:
    """Shapes (B, N, M, D, S, F) of a launch; raises on what the kernels do
    not take: x, sh and w of one type, f32 or bf16; g f32 (B, N, F,
    lanes(tp)); with ``sender_index`` (B, N, M) int32, x (B, M_x, D)."""
    k_pad = lanes(tp)
    if sh.dim() != 4:
        raise ValueError(f"tp_aggregate: sh must be (B, N, M, S), got {tuple(sh.shape)}")
    B, N, M, S = sh.shape
    D, F = tp.irreps_in.dim, tp.weight_numel
    m_x = M if sender_index is None else x.shape[1]
    if sender_index is not None:
        check_index(sender_index, (B, N, M), x.device, "tp_aggregate")
    expected = {"x": (x, (B, m_x, D)), "sh": (sh, (B, N, M, tp.irreps_sh.dim)),
                "w": (w, (B, N, M, F))}
    if g is not None:
        expected["grad"] = (g, (B, N, F, k_pad))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tp_aggregate: x must be f32 or bf16, got {x.dtype}")
    for name, (t, shape) in expected.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"tp_aggregate: {name} on {t.device}; all tensors must be on one "
                             f"CUDA device")
        want = torch.float32 if name == "grad" else x.dtype
        if t.dtype != want:
            raise TypeError(f"tp_aggregate: {name} must be {want} (x, sh and w of one type, the "
                            f"gradient f32), got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"tp_aggregate: {name} {tuple(t.shape)}, expected {shape} for "
                             f"{tp.irreps_in!r} x {tp.irreps_sh!r}")
        if not t.is_contiguous():
            raise ValueError(f"tp_aggregate: {name} must be contiguous")
    if k_pad == K_PAD_L2 and len(tp.paths) > MAX_PATHS_L2:
        raise ValueError(f"tp_aggregate: at most {MAX_PATHS_L2} paths")
    return B, N, M, D, S, F


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _scratch(splits: int, shape: Tuple[int, ...], device: torch.device) -> Optional[torch.Tensor]:
    """The scratch buffer of the splits' partial sums, or None for one split."""
    if splits == 1:
        return None
    return torch.empty((splits,) + shape, dtype=torch.float32, device=device)


def _check_live(live: Optional[torch.Tensor], w: torch.Tensor) -> torch.Tensor:
    """The live pass's bits of w: ``live`` checked, or made now."""
    if live is None:
        return live_rows_l2(w)
    words = -(-(w.numel() // w.shape[-1]) // 32)
    if live.dtype != torch.int32 or tuple(live.shape) != (words,) or live.device != w.device:
        raise ValueError(f"tp_aggregate: live must be {words} int32 words on {w.device}")
    return live


def forward_l2(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
               w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense tiled forward on CUDA tensors (:func:`tiled`: 8 lanes, or 4
    lanes wider than ``SPLIT_F_MAX``) -> (out (B, N, F, lanes(tp)) f32, the
    live bits of w): the live pass (:func:`live_rows_l2`), the tiled kernel
    on the live tiles and, when :func:`launch_splits_l2` splits, the sum of
    the splits' partial sums; one ``FWD_L2`` (4 lanes: ``FWD``) launch.  dx
    reads the same bits (the autograd forward keeps them)."""
    B, N, M, D, S, F = _check_inputs(tp, x, sh, w)
    if not tiled(tp):
        raise ValueError(f"tp_aggregate: forward_l2 takes an 8-lane product (an irrep of l = 2) "
                         f"or a 4-lane one wider than {SPLIT_F_MAX} channels")
    k_pad = lanes(tp)
    live = live_rows_l2(w)
    chan, ptab, gflat, ctab, _, _ = _device_tables_tiled_l2(tp, str(x.device), x.dtype)
    walk = _device_walk_l2(tp, str(x.device))
    splits = launch_splits_l2(tp, B, N, M, False, x.device, x.dtype)
    out = torch.empty((B, N, F, k_pad), dtype=torch.float32, device=x.device)
    part = _scratch(splits, (B, N, F, k_pad), x.device)
    rc = _library().dp_tp_aggregate_fwd_l2_tiled(
        x.data_ptr(), sh.data_ptr(), w.data_ptr(), chan.data_ptr(), ptab.data_ptr(),
        gflat.data_ptr(), ctab.data_ptr(), walk.data_ptr(), live.data_ptr(), out.data_ptr(),
        _ptr(part), B, N, M, D, S, F, ctab.shape[0], *layout_sizes_l2(tp, False)[:5], splits,
        _w_unit_l2(tp, w), k_pad, int(x.dtype == torch.bfloat16), _stream(x.device))
    _raise_on(rc, "tp_aggregate_fwd_l2_tiled")
    (FWD_L2 if k_pad == K_PAD_L2 else FWD).launches += 1
    return out, live


def forward_idx(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                sender_index: torch.Tensor, live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sender-index forward on CUDA tensors, at 4 or 8 lanes -> (out (B,
    N, F, lanes(tp)) f32, the live bits of w): ``live`` (the bits of
    :func:`live_rows_l2` of w), or the live pass now where it is not given;
    then ``tp_aggregate_fwd_idx_tiled_kernel``, the dense tiled forward by
    channel tile with each slot's x slice read at the index, on the live
    tiles, and, when :func:`grid_idx` splits the slots, the sum of the
    splits' partial sums; one ``FWD_IDX`` (``FWD_IDX_L2``) launch.  dx reads
    the same bits (the autograd forward keeps them)."""
    B, N, K, D, S, F = _check_inputs(tp, x, sh, w, sender_index=sender_index)
    k_pad = lanes(tp)
    live = _check_live(live, w)
    chan, ptab, gflat, ctab, _, _ = _device_tables_tiled_l2(tp, str(x.device), x.dtype)
    walk = _device_walk_l2(tp, str(x.device))
    _, splits = grid_idx(tp, B, N, K, x.device, x.dtype)
    out = torch.empty((B, N, F, k_pad), dtype=torch.float32, device=x.device)
    part = _scratch(splits, (B, N, F, k_pad), x.device)
    rc = _library().dp_tp_aggregate_fwd_idx_tiled(
        x.data_ptr(), sh.data_ptr(), w.data_ptr(), sender_index.data_ptr(), chan.data_ptr(),
        ptab.data_ptr(), gflat.data_ptr(), ctab.data_ptr(), walk.data_ptr(), live.data_ptr(),
        out.data_ptr(), _ptr(part), B, N, K, x.shape[1], D, S, F, ctab.shape[0],
        *layout_sizes_l2(tp, False)[:5], splits, _w_unit_l2(tp, w), k_pad,
        int(x.dtype == torch.bfloat16), _stream(x.device))
    _raise_on(rc, "tp_aggregate_fwd_idx_tiled")
    counter(FWD, FWD_L2, FWD_IDX, FWD_IDX_L2, sender_index, k_pad == K_PAD_L2).launches += 1
    return out, live


def launch_forward(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
                   w: torch.Tensor, sender_index: Optional[torch.Tensor] = None,
                   live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel on CUDA tensors -> (B, N, F, lanes(tp)) f32 (and
    the sum of the sender splits' partial sums when :func:`launch_splits`
    splits; dense at 8 lanes, :func:`forward_l2`; with a sender index,
    :func:`forward_idx` on ``live``, the live bits of w, made here when not
    given)."""
    if sender_index is not None:
        return forward_idx(tp, x, sh, w, sender_index, live)[0]
    if tiled(tp):
        return forward_l2(tp, x, sh, w)[0]
    B, N, M, D, S, F = _check_inputs(tp, x, sh, w)
    dev = str(x.device)
    chan, gtab = _device_tables(tp, dev, x.dtype)
    ptab, _, _ = _device_backward_tables(tp, dev)
    out = torch.empty((B, N, F, K_PAD), dtype=torch.float32, device=x.device)
    splits = launch_splits(tp, B, N, M, False, x.device, x.dtype)
    part = _scratch(splits, (B, N, F, K_PAD), x.device)
    rc = _library().dp_tp_aggregate_fwd(
        x.data_ptr(), sh.data_ptr(), w.data_ptr(), chan.data_ptr(), ptab.data_ptr(),
        gtab.data_ptr(), out.data_ptr(), _ptr(part), B, N, M, D, S, F, gtab.shape[0], splits,
        int(x.dtype == torch.bfloat16), _stream(x.device))
    _raise_on(rc, "tp_aggregate_fwd")
    FWD.launches += 1
    return out


def launch_backward_edge(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                         g: torch.Tensor, need_dsh: bool,
                         sender_index: Optional[torch.Tensor] = None,
                         live: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dw, dsh or None) from the per-edge backward, in w's and sh's type.
    At 4 lanes, dense: a kernel for dw alone, which does not read w, or,
    when dsh is asked for, one that computes both in one pass over w (its
    dw differs from the other's by summation order).  At 8 lanes, dense:
    ``tp_aggregate_l2_p_kernel`` (each receiver's P once), then
    ``tp_aggregate_bwd_edge_l2_kernel``, a block per (32 senders, run of
    :func:`plan_edge_receivers` receivers, batch row), dw alone or with
    dsh; with dsh it reads w, and of w only the rows that ``live`` marks
    (the bits of :func:`live_rows_l2` of w, which the autograd forward
    makes: a dead row is zero), every row when ``live`` is None.  In the
    sender-index mode, at 4 or 8 lanes: ``tp_aggregate_bwd_edge_idx_kernel``,
    a block per receiver's K slots; it computes dw only and refuses
    ``need_dsh``."""
    if sender_index is not None and need_dsh:
        raise ValueError("tp_aggregate: the sender-index mode computes no dsh (the KNN phore "
                         "grid's harmonics carry no gradient)")
    B, N, M, D, S, F = _check_inputs(tp, x, sh, w, g, sender_index)
    dev = str(x.device)
    seg_ptr, seg = _device_dsh_segments(tp, dev)
    dw = torch.empty_like(w)
    dsh = torch.empty_like(sh) if need_dsh else None
    k_pad = lanes(tp)
    bf16 = int(x.dtype == torch.bfloat16)
    if sender_index is not None:
        chan, ptab, gtab, _ = device_tables_l2(tp, dev, x.dtype)
        rc = _library().dp_tp_aggregate_bwd_edge_idx(
            x.data_ptr(), sh.data_ptr(), sender_index.data_ptr(), g.data_ptr(), chan.data_ptr(),
            ptab.data_ptr(), gtab.data_ptr(), dw.data_ptr(), B, N, M, x.shape[1], D, S, F,
            gtab.shape[0], k_pad, bf16, _stream(x.device))
        _raise_on(rc, "tp_aggregate_bwd_edge_idx")
        counter(BWD_EDGE, BWD_EDGE_L2, BWD_EDGE_IDX, BWD_EDGE_IDX_L2, sender_index,
                k_pad == K_PAD_L2).launches += 1
        return dw, dsh
    if k_pad == K_PAD_L2:
        if live is not None and need_dsh:
            live = _check_live(live, w)
        _, ptab, gflat, (PT, PS, _, _) = _device_path_tables_l2(tp, dev, x.dtype)
        plan = _device_edge_plan_l2(tp, dev)
        pent = _device_p_entries_l2(tp, dev)
        slots = edge_slots_l2(tp, need_dsh)
        P = torch.empty((B, N, PT), dtype=torch.float32, device=x.device)
        rc = _library().dp_tp_aggregate_bwd_edge_l2(
            x.data_ptr(), sh.data_ptr(), w.data_ptr(), _ptr(live) if need_dsh else None,
            g.data_ptr(), pent.data_ptr(), gflat.data_ptr(), ptab.data_ptr(), plan.data_ptr(),
            seg_ptr.data_ptr(), seg.data_ptr(), P.data_ptr(), dw.data_ptr(), _ptr(dsh), B, N, M,
            D, S, F, ptab.shape[0], PT, PS, plan.shape[1],
            plan_edge_receivers(B, N, M, slots=slots), slots, bf16, _stream(x.device))
        _raise_on(rc, "tp_aggregate_bwd_edge_l2")
        BWD_EDGE_L2.launches += 1
        return dw, dsh
    chan, gtab = _device_tables(tp, dev, x.dtype)
    ptab, _, _ = _device_backward_tables(tp, dev)
    rc = _library().dp_tp_aggregate_bwd_edge(
        x.data_ptr(), sh.data_ptr(), w.data_ptr(), g.data_ptr(), chan.data_ptr(),
        ptab.data_ptr(), gtab.data_ptr(), seg_ptr.data_ptr(), seg.data_ptr(), dw.data_ptr(),
        dsh.data_ptr() if need_dsh else None,
        B, N, M, D, S, F, gtab.shape[0], plan_edge_senders(B, N, M), seg.shape[0],
        int(x.dtype == torch.bfloat16), _stream(x.device))
    _raise_on(rc, "tp_aggregate_bwd_edge")
    BWD_EDGE.launches += 1
    return dw, dsh


def launch_backward_x(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                      g: torch.Tensor, sender_index: Optional[torch.Tensor] = None,
                      lists: Optional[IdxDxLists] = None,
                      live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx in x's type from the per-sender backward kernel (x gives only its
    shape and type; and the sum of the receiver splits' f32 partial sums when
    :func:`launch_splits` splits; at 8 lanes, of the splits' and channel
    tiles' partial sums where there is more than one).  At 8 lanes, dense,
    and in the sender-index mode it reads ``live``, the bits of
    :func:`live_rows_l2` of w that the autograd forward made (the
    forward's own, :func:`forward_l2`, :func:`forward_idx`), made here when
    not given.  The sender-index mode (both lane counts) adds each sender's
    slots in chunks of ``lists`` (:func:`idx_dx_lists` of the index, built
    here when not given), loading only live slots, then each sender's
    chunks in order: two kernels, one launch."""
    B, N, M, D, S, F = _check_inputs(tp, x, sh, w, g, sender_index)
    dev = str(x.device)
    dx = torch.empty_like(x)
    k_pad = lanes(tp)
    if tiled(tp) and sender_index is None:
        live = _check_live(live, w)
        chan, ptab, gflat, ctab, _, _ = _device_tables_tiled_l2(tp, dev, x.dtype)
        walk = _device_walk_l2(tp, dev)
        dptr, ditem = _device_dx_lists_l2(tp, dev)
        sizes = layout_sizes_l2(tp, True)
        n_ct = ctab.shape[0]
        splits = launch_splits_l2(tp, B, N, M, True, x.device, x.dtype)
        part = _scratch(splits * n_ct, (B, M, D), x.device)
        rc = _library().dp_tp_aggregate_bwd_x_l2_tiled(
            sh.data_ptr(), w.data_ptr(), g.data_ptr(), chan.data_ptr(), ptab.data_ptr(),
            gflat.data_ptr(), ctab.data_ptr(), walk.data_ptr(), live.data_ptr(), dptr.data_ptr(),
            ditem.data_ptr(), dx.data_ptr(), _ptr(part), B, N, M, D, S, F, n_ct, *sizes, splits,
            _w_unit_l2(tp, w), k_pad, int(x.dtype == torch.bfloat16), _stream(x.device))
        _raise_on(rc, "tp_aggregate_bwd_x_l2_tiled")
        (BWD_X_L2 if k_pad == K_PAD_L2 else BWD_X).launches += 1
        return dx
    if sender_index is not None:
        m_x = x.shape[1]
        lists = lists if lists is not None else idx_dx_lists(sender_index, m_x)
        live = _check_live(live, w)
        chan, ptab, gflat, (_, _, TS, GS) = _device_path_tables_l2(tp, dev, x.dtype)
        _, d_ptr, d_item = _device_backward_tables(tp, dev, K_PAD_L2)
        chunks = lists.cuts.shape[0] - 1
        part = torch.empty((chunks, D), dtype=torch.float32, device=x.device)
        pi_items = _device_pi_items_l2(tp, dev)
        rc = _library().dp_tp_aggregate_bwd_x_idx_l2(
            sh.data_ptr(), w.data_ptr(), g.data_ptr(), live.data_ptr(), chan.data_ptr(),
            ptab.data_ptr(), gflat.data_ptr(), pi_items.data_ptr(), lists.order.data_ptr(),
            lists.cuts.data_ptr(), lists.row_ptr.data_ptr(), d_ptr.data_ptr(), d_item.data_ptr(),
            dx.data_ptr(), part.data_ptr(), B, N, M, m_x, D, S, F, ptab.shape[0], TS, GS,
            pi_items.shape[0], d_item.shape[0], chunks, k_pad, int(x.dtype == torch.bfloat16),
            _stream(x.device))
        _raise_on(rc, "tp_aggregate_bwd_x_idx_l2")
        counter(BWD_X, BWD_X_L2, BWD_X_IDX, BWD_X_IDX_L2, sender_index,
                k_pad == K_PAD_L2).launches += 1
        return dx
    chan, gtab = _device_tables(tp, dev, x.dtype)
    ptab, d_ptr, d_item = _device_backward_tables(tp, dev)
    splits = launch_splits(tp, B, N, M, True, x.device, x.dtype)
    part = _scratch(splits, (B, M, D), x.device)
    rc = _library().dp_tp_aggregate_bwd_x(
        sh.data_ptr(), w.data_ptr(), g.data_ptr(), chan.data_ptr(), ptab.data_ptr(),
        gtab.data_ptr(), d_ptr.data_ptr(), d_item.data_ptr(), dx.data_ptr(), _ptr(part),
        B, N, M, D, S, F, gtab.shape[0], d_item.shape[0], splits,
        int(x.dtype == torch.bfloat16), _stream(x.device))
    _raise_on(rc, "tp_aggregate_bwd_x")
    BWD_X.launches += 1
    return dx


class TPAggregate(torch.autograd.Function):
    """The kernels under autograd.  ``dsh`` is computed only when sh requires
    grad (the cross-graph convs, whose edge vectors carry learned weights),
    ``dx`` only when x does.  The forward makes w's live bits once: at 8
    lanes, dense, for itself, the edge backward's dsh and dx; with a sender
    index for itself and dx, and, when x requires grad, dx's chunk lists."""

    @staticmethod
    def forward(ctx, tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                sender_index: Optional[torch.Tensor] = None):
        ctx.tp = tp
        ctx.sender_index = sender_index
        ctx.save_for_backward(x, sh, w)
        ctx.lists = ctx.live = None
        if sender_index is not None:
            if ctx.needs_input_grad[1]:
                ctx.lists = idx_dx_lists(sender_index, x.shape[1])
            out, ctx.live = forward_idx(tp, x, sh, w, sender_index)
            return out
        if tiled(tp):
            out, ctx.live = forward_l2(tp, x, sh, w)
            return out
        return launch_forward(tp, x, sh, w)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        x, sh, w = ctx.saved_tensors
        _, need_dx, need_dsh, need_dw, _ = ctx.needs_input_grad
        g = grad_out.to(torch.float32).contiguous()
        dx = dw = dsh = None
        if need_dw or need_dsh:
            dw, dsh = launch_backward_edge(ctx.tp, x, sh, w, g, need_dsh, ctx.sender_index,
                                           ctx.live)
        if need_dx:
            dx = launch_backward_x(ctx.tp, x, sh, w, g, ctx.sender_index, ctx.lists, ctx.live)
        return None, dx, dsh, dw if need_dw else None, None


def tp_aggregate(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                 sender_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-path aggregate -> (B, N, F, lanes(tp)) f32, differentiable in x, sh, w
    (their gradients in their own type).

    x (B, M, D_in); sh (B, N, M, S); w (B, N, M, F) pre-masked; all f32 or
    all bf16 (read as they are, multiplied and summed in f32), contiguous.
    ``sender_index`` (B, N, K) int32: the sender-index mode, x (B, M_x,
    D_in) and M = K (module note; sh must not require grad there).  CPU
    tensors take the plain version; CUDA tensors launch the kernels or
    raise.
    """
    if x.device.type == "cpu":
        return tp_aggregate_plain(tp, x, sh, w, sender_index)
    return TPAggregate.apply(tp, x, sh, w, sender_index)
