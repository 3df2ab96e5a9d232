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
dx), their split or per-tile partial sums added by a second kernel in a
fixed order), the edge backward a block per receiver and run of senders, a
thread per channel.

Sender-index mode (the KNN phore grid): with ``sender_index`` (B, N, K)
int32, x is (B, M_x, D), sh and w are (B, N, K, .) and slot k of receiver n
reads the sender row ``x[b, sender_index[b, n, k]]``; dx adds each sender's
slots.  The three functions run those ``*_l2`` kernels' bodies at both lane
counts (4 where l <= 1): the forward reads x at the index, the edge
backward too (dw only: no phore conv needs dsh, which the mode refuses),
and dx walks each sender's slots in the fixed order of
:func:`tp_fused.sender_lists`.  ``FWD_IDX``, ``BWD_EDGE_IDX`` and
``BWD_X_IDX`` count the 4-lane launches, the ``*_IDX_L2`` counters the
8-lane ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import build
from .tensor_product import ChannelwiseTP
from .tp_fused import (K_PAD, K_PAD_L2, MAX_F_L2, MAX_PATHS_L2, TARGET_BLOCKS, TILE_N,
                       _check_tp, _device_tables, _device_tables_tiled_l2, _Kernel, _ptr,
                       check_index, counter, device_tables_l2, lanes, padded_from_blocks,
                       sender_lists, tables_tiled_l2)

FWD = _Kernel()        # tp_aggregate_fwd_kernel (+ tp_aggregate_sum_splits)
BWD_EDGE = _Kernel()   # tp_aggregate_bwd_edge_kernel (dw, and dsh when needed)
BWD_X = _Kernel()      # tp_aggregate_bwd_x_kernel (dx, + tp_aggregate_sum_splits)
FWD_L2 = _Kernel()       # tp_aggregate_fwd_l2_tiled_kernel (+ tp_aggregate_sum_splits)
BWD_EDGE_L2 = _Kernel()  # tp_aggregate_bwd_edge_l2_kernel (dw, and dsh when needed)
BWD_X_L2 = _Kernel()     # tp_aggregate_bwd_x_l2_tiled_kernel (+ tp_aggregate_l2_dx_sum)
FWD_IDX = _Kernel()          # the sender-index mode: tp_aggregate_fwd_l2_kernel<T, 4>
BWD_EDGE_IDX = _Kernel()     # tp_aggregate_bwd_edge_l2_kernel<T, false, 4>
BWD_X_IDX = _Kernel()        # tp_aggregate_bwd_x_l2_kernel<T, 4>
FWD_IDX_L2 = _Kernel()       # the same at 8 lanes (l = 2)
BWD_EDGE_IDX_L2 = _Kernel()
BWD_X_IDX_L2 = _Kernel()
KEEP = 8               # receivers (forward) or senders (dx) one block keeps (both lane counts)
TILE_SUM = 4           # entries of the summed axis in one tile of a block


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
    """Blocks of the 8-lane tiled forward (or dx) the card holds at once at
    this convolution's channel tiles and operand type."""
    per_sm = _library().dp_tp_aggregate_l2_blocks_per_sm(int(dx), *layout_sizes_l2(tp, dx),
                                                         int(bf16))
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("tp_aggregate")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dp_tp_aggregate_fwd.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.dp_tp_aggregate_bwd_edge.argtypes = [p] * 11 + [i] * 10 + [p]
    lib.dp_tp_aggregate_bwd_x.argtypes = [p] * 10 + [i] * 10 + [p]
    lib.dp_tp_aggregate_blocks_per_sm.argtypes = [i] * 6
    lib.dp_tp_aggregate_fwd_l2.argtypes = [p] * 8 + [i] * 11 + [p]
    lib.dp_tp_aggregate_bwd_edge_l2.argtypes = [p] * 12 + [i] * 11 + [p]
    lib.dp_tp_aggregate_bwd_x_l2.argtypes = [p] * 11 + [i] * 12 + [p]
    lib.dp_tp_aggregate_fwd_l2_tiled.argtypes = [p] * 11 + [i] * 15 + [p]
    lib.dp_tp_aggregate_bwd_x_l2_tiled.argtypes = [p] * 13 + [i] * 16 + [p]
    lib.dp_tp_aggregate_l2_smem.argtypes = [i] * 8
    lib.dp_tp_aggregate_l2_blocks_per_sm.argtypes = [i] * 8
    lib.dp_tp_aggregate_l2_live.argtypes = [p, p, ctypes.c_longlong, i, i, i, p]
    for fn in (lib.dp_tp_aggregate_fwd, lib.dp_tp_aggregate_bwd_edge, lib.dp_tp_aggregate_bwd_x,
               lib.dp_tp_aggregate_blocks_per_sm, lib.dp_tp_aggregate_fwd_l2,
               lib.dp_tp_aggregate_bwd_edge_l2, lib.dp_tp_aggregate_bwd_x_l2,
               lib.dp_tp_aggregate_fwd_l2_tiled, lib.dp_tp_aggregate_bwd_x_l2_tiled,
               lib.dp_tp_aggregate_l2_smem, lib.dp_tp_aggregate_l2_blocks_per_sm,
               lib.dp_tp_aggregate_l2_live):
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
    if k_pad == K_PAD_L2 and (F > MAX_F_L2 or len(tp.paths) > MAX_PATHS_L2):
        raise ValueError(f"tp_aggregate: F = {F} <= {MAX_F_L2} and at most {MAX_PATHS_L2} paths")
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
    """The dense 8-lane forward on CUDA tensors -> (out (B, N, F, 8) f32,
    the live bits of w): the live pass (:func:`live_rows_l2`), the tiled
    kernel on the live tiles and, when :func:`launch_splits_l2` splits, the
    sum of the splits' partial sums; one ``FWD_L2`` launch.  dx reads the
    same bits (the autograd forward keeps them)."""
    B, N, M, D, S, F = _check_inputs(tp, x, sh, w)
    if lanes(tp) != K_PAD_L2:
        raise ValueError("tp_aggregate: forward_l2 takes an 8-lane product (an irrep of l = 2)")
    live = live_rows_l2(w)
    chan, ptab, gflat, ctab, _, _ = _device_tables_tiled_l2(tp, str(x.device), x.dtype)
    walk = _device_walk_l2(tp, str(x.device))
    splits = launch_splits_l2(tp, B, N, M, False, x.device, x.dtype)
    out = torch.empty((B, N, F, K_PAD_L2), dtype=torch.float32, device=x.device)
    part = _scratch(splits, (B, N, F, K_PAD_L2), x.device)
    rc = _library().dp_tp_aggregate_fwd_l2_tiled(
        x.data_ptr(), sh.data_ptr(), w.data_ptr(), chan.data_ptr(), ptab.data_ptr(),
        gflat.data_ptr(), ctab.data_ptr(), walk.data_ptr(), live.data_ptr(), out.data_ptr(),
        _ptr(part), B, N, M, D, S, F, ctab.shape[0], *layout_sizes_l2(tp, False)[:5], splits,
        _w_unit_l2(tp, w), int(x.dtype == torch.bfloat16), _stream(x.device))
    _raise_on(rc, "tp_aggregate_fwd_l2_tiled")
    FWD_L2.launches += 1
    return out, live


def launch_forward(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
                   w: torch.Tensor, sender_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel on CUDA tensors -> (B, N, F, lanes(tp)) f32 (and
    the sum of the sender splits' partial sums when :func:`launch_splits`
    splits; dense at 8 lanes, :func:`forward_l2`)."""
    if lanes(tp) == K_PAD_L2 and sender_index is None:
        return forward_l2(tp, x, sh, w)[0]
    B, N, M, D, S, F = _check_inputs(tp, x, sh, w, sender_index=sender_index)
    dev = str(x.device)
    k_pad = lanes(tp)
    if sender_index is not None:
        chan, ptab, gtab, t_size = device_tables_l2(tp, dev, x.dtype)
        out = torch.empty((B, N, F, k_pad), dtype=torch.float32, device=x.device)
        rc = _library().dp_tp_aggregate_fwd_l2(
            x.data_ptr(), sh.data_ptr(), w.data_ptr(), _ptr(sender_index), chan.data_ptr(),
            ptab.data_ptr(), gtab.data_ptr(), out.data_ptr(), B, N, M, x.shape[1], D, S, F,
            gtab.shape[0], t_size, k_pad, int(x.dtype == torch.bfloat16), _stream(x.device))
        _raise_on(rc, "tp_aggregate_fwd_l2")
        counter(FWD, FWD_L2, FWD_IDX, FWD_IDX_L2, sender_index,
                k_pad == K_PAD_L2).launches += 1
        return out
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
                         sender_index: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dw, dsh or None) from the per-edge backward, in w's and sh's type: a
    kernel for dw alone, which does not read w, or, when dsh is asked for,
    one that computes both in one pass over w (its dw differs from the
    other's by summation order).  The sender-index mode computes dw only and
    refuses ``need_dsh``."""
    if sender_index is not None and need_dsh:
        raise ValueError("tp_aggregate: the sender-index mode computes no dsh (the KNN phore "
                         "grid's harmonics carry no gradient)")
    B, N, M, D, S, F = _check_inputs(tp, x, sh, w, g, sender_index)
    dev = str(x.device)
    seg_ptr, seg = _device_dsh_segments(tp, dev)
    dw = torch.empty_like(w)
    dsh = torch.empty_like(sh) if need_dsh else None
    k_pad = lanes(tp)
    if k_pad == K_PAD_L2 or sender_index is not None:
        chan, ptab, gtab, _ = device_tables_l2(tp, dev, x.dtype)
        rc = _library().dp_tp_aggregate_bwd_edge_l2(
            x.data_ptr(), sh.data_ptr(), w.data_ptr(), _ptr(sender_index), g.data_ptr(),
            chan.data_ptr(), ptab.data_ptr(), gtab.data_ptr(), seg_ptr.data_ptr(), seg.data_ptr(),
            dw.data_ptr(), _ptr(dsh), B, N, M, x.shape[1], D, S, F, gtab.shape[0], seg.shape[0],
            k_pad, int(x.dtype == torch.bfloat16), _stream(x.device))
        _raise_on(rc, "tp_aggregate_bwd_edge_l2")
        counter(BWD_EDGE, BWD_EDGE_L2, BWD_EDGE_IDX, BWD_EDGE_IDX_L2, sender_index,
                k_pad == K_PAD_L2).launches += 1
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
                      lists: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx in x's type from the per-sender backward kernel (x gives only its
    shape and type; and the sum of the receiver splits' f32 partial sums when
    :func:`launch_splits` splits; at 8 lanes, of the splits' and channel
    tiles' partial sums where there is more than one; it reads ``live``,
    the bits of :func:`live_rows_l2` of w, made here when not given).  The
    sender-index mode walks each
    sender's slots in the order of ``lists`` (:func:`tp_fused.sender_lists`
    of the index, built here when not given)."""
    B, N, M, D, S, F = _check_inputs(tp, x, sh, w, g, sender_index)
    dev = str(x.device)
    dx = torch.empty_like(x)
    k_pad = lanes(tp)
    if k_pad == K_PAD_L2 and sender_index is None:
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
            _w_unit_l2(tp, w), int(x.dtype == torch.bfloat16), _stream(x.device))
        _raise_on(rc, "tp_aggregate_bwd_x_l2_tiled")
        BWD_X_L2.launches += 1
        return dx
    if sender_index is not None:
        order, ptr = lists if lists is not None else sender_lists(sender_index, x.shape[1])
        chan, ptab, gtab, t_size = device_tables_l2(tp, dev, x.dtype)
        _, d_ptr, d_item = _device_backward_tables(tp, dev, K_PAD_L2)
        rc = _library().dp_tp_aggregate_bwd_x_l2(
            sh.data_ptr(), w.data_ptr(), g.data_ptr(), chan.data_ptr(), ptab.data_ptr(),
            gtab.data_ptr(), d_ptr.data_ptr(), d_item.data_ptr(), _ptr(order), _ptr(ptr),
            dx.data_ptr(), B, N, M, x.shape[1], D, S, F, gtab.shape[0], t_size, d_item.shape[0],
            k_pad, int(x.dtype == torch.bfloat16), _stream(x.device))
        _raise_on(rc, "tp_aggregate_bwd_x_l2")
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
    ``dx`` only when x does.  With a sender index the forward builds the
    index's inverse lists for dx once, when x requires grad; at 8 lanes,
    dense, it makes w's live bits once for the forward and dx."""

    @staticmethod
    def forward(ctx, tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                sender_index: Optional[torch.Tensor] = None):
        ctx.tp = tp
        ctx.sender_index = sender_index
        ctx.lists = (sender_lists(sender_index, x.shape[1])
                     if sender_index is not None and ctx.needs_input_grad[1] else None)
        ctx.save_for_backward(x, sh, w)
        ctx.live = None
        if sender_index is None and lanes(tp) == K_PAD_L2:
            out, ctx.live = forward_l2(tp, x, sh, w)
            return out
        return launch_forward(tp, x, sh, w, sender_index)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        x, sh, w = ctx.saved_tensors
        _, need_dx, need_dsh, need_dw, _ = ctx.needs_input_grad
        g = grad_out.to(torch.float32).contiguous()
        dx = dw = dsh = None
        if need_dw or need_dsh:
            dw, dsh = launch_backward_edge(ctx.tp, x, sh, w, g, need_dsh, ctx.sender_index)
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
