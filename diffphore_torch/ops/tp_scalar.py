"""K3: the scalar-path (l_in = 0) tensor-product aggregate, with its backward.

The port of ``diffphore_tpu/ops/pallas/tp_scalar.py::scalar_path_aggregate``
(the TPU kernel) as CUDA kernels for Hopper, ``csrc/tp_scalar.cu``.  Per path:

    out[b,n,u,k] = c_p * sum_m x[b,m,u] * sh[b,n,m,k] * w[b,n,m,u]

For a path with l_in = 0 the coupling tensor times the path's normalization
is a multiple c_p of the identity (``wigner_3j(0, l, l)[0] = I / sqrt(2l+1)``,
alpha = ``sqrt(2l+1)``): c_p = 1 in f32, and ``alpha * bf16(1 / sqrt(2l+1))``
(1.00135 for l = 1) where the convolution computes in bf16, as the JAX
package rounds the coupling tensor to the operands' type
(:func:`path_scale`).  So this is the whole of the path's block in
``ChannelwiseTP.aggregate``.  The layer-0 convolutions of the score model
(``ns x 0e`` in) have only such paths; their training branch runs
:func:`scalar_paths_aggregate`, the other convolutions stay on K2.

The forward and ``dx`` are one launch per convolution for all its paths (a
thread per channel of the full weight row; the summed axis split across
blocks, the splits' partial sums added in order by a second kernel); ``dw``
and ``dsh`` are one edge-backward launch per convolution (four channels of
the full row a lane, dsh summed over an edge's lanes in a fixed order).
Operands are f32 or bf16, read as they are and multiplied and summed in
f32; gradients come back in each operand's type.  CPU tensors run
:func:`scalar_paths_aggregate_plain`, the einsums under autograd, and
:func:`scalar_paths_backward_edge_plain` is the edge backward's plain
version.  ``FWD``, ``BWD_EDGE`` and ``BWD_X`` count the wrapper calls that
launched.  A convolution whose irreps reach l = 2 (the layer-0 convolutions
of ``use_second_order_repr``, whose ``0e x 2e -> 2e`` path has K = 5 and
reads harmonic components 4-8; the upstream gradient and the output (B, N,
F, 8)) runs kernels of its own, counted by ``FWD_L2``, ``BWD_EDGE_L2`` and
``BWD_X_L2``; past 32 units (ns = 48 and 64) the edge backward gives a lane
two units.  Their lane is a unit of :func:`units_l2`: up to four
neighbouring channels of one path, so it loads its x and w as one access
each (where every path is four channels wide at a multiple of four, else
element by element) and only its path's K harmonic components.  The
forward (``tp_scalar_fwd_l2_kernel``) gives a block whole receivers and all
their senders, split over SL slices of the block's lanes and added in
shared memory in order (:func:`plan_fwd_l2`): no partial sums in device
memory, the output written once.  The edge backward
(``tp_scalar_bwd_edge_l2_kernel``) holds each lane's coefficients c_p g[k]
for its path's K components only, and adds dsh component s over the units
whose path reads it (``comp_ptr`` / ``comp_item``).  dx
(``tp_scalar_bwd_x_l2_kernel``: thread = (channel, ``X2_Q`` senders), each
g row loaded once for the thread's senders; a block per (batch row, run of
:func:`plan_run_l2` senders, chunk of receivers), the receivers split as
:func:`plan_chunk_l2` says).

Sender-index mode (the KNN phore grid): with ``sender_index`` (B, N, K)
int32, x is (B, M_x, D), sh and w (B, N, K, .) and slot k of receiver n
reads the sender row ``x[b, sender_index[b, n, k]]``.  The forward and the
edge backward (dw only; the mode refuses dsh) are one kernel at both lane
counts, ``tp_scalar_idx_kernel`` (:func:`plan_idx`): the dense 8-lane
forward's design with x read at the index, whole receivers a block and all
their K slots in one pass, the slots' harmonics staged once for the
block's units, a lane a unit of :func:`units_l2`.
dx has kernels of its own: a first forms
each slot's term w * sum_k sh g (receiver by receiver, so each g row is read
once), each sender's slots, in the order of :func:`tp_fused.sender_lists`,
are cut into chunks of at most Q (:func:`slot_chunks`, Q from
:func:`plan_slot_chunk` so that the chunks fill the card), a thread sums one
(chunk, channel) of terms into a scratch row, and a third kernel adds each
sender's chunks in order.  Both lane counts; ``FWD_IDX``, ``BWD_EDGE_IDX``,
``BWD_X_IDX`` (and ``*_IDX_L2``) count them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from . import build
from .tensor_product import ChannelwiseTP, gather_senders
from .tp_fused import (K_PAD_L2, _check_tp, _Kernel, _ptr, check_index, counter, coupling,
                       lanes, sender_lists)
from .wigner import wigner_3j

FWD = _Kernel()       # tp_scalar_fwd_kernel (+ tp_scalar_sum_splits), one per convolution
BWD_EDGE = _Kernel()  # tp_scalar_bwd_edge_kernel (dw, and dsh where asked), one per convolution
BWD_X = _Kernel()     # tp_scalar_bwd_x_kernel (+ tp_scalar_sum_splits), one per convolution
FWD_L2 = _Kernel()       # tp_scalar_fwd_l2_kernel, one per convolution (l = 2)
BWD_EDGE_L2 = _Kernel()  # tp_scalar_bwd_edge_l2_kernel
BWD_X_L2 = _Kernel()     # tp_scalar_bwd_x_l2_kernel (+ tp_scalar_sum_splits)
FWD_IDX = _Kernel()       # the sender-index mode (l <= 1): tp_scalar_idx_kernel<T, 4, VEC, false>
BWD_EDGE_IDX = _Kernel()  # tp_scalar_idx_kernel<T, 4, VEC, true> (dw)
BWD_X_IDX = _Kernel()      # tp_scalar_bwd_x_idx_slots, _chunks and _sum
FWD_IDX_L2 = _Kernel()    # the sender-index mode at l = 2
BWD_EDGE_IDX_L2 = _Kernel()
BWD_X_IDX_L2 = _Kernel()

THREADS = 256        # threads of a forward or dx block: KEEP = THREADS // F entries kept
X2_THREADS = 256     # threads of an 8-lane dx block at most: (channel, X2_Q senders) each
X2_Q = 4             # senders of an 8-lane dx thread
X2_MIN_CHUNK = 4     # fewest receivers one split of the 8-lane dx takes
X2_WAVES = 4         # the 8-lane dx's grid: blocks for this many of each block slot of the card
EDGE_F_MAX = 128     # channels of a row the edge backward takes (four a lane)
EDGE_REACH = 4       # harmonic components the edge backward reads (0e and 1o first)
KM = 5               # harmonic components of a channel at l = 2, at most
F2_THREADS = 256     # threads of a dense 8-lane forward block at most: (receiver, slice, unit)
F2_U = 4             # senders whose w a forward lane loads at once (the source's F2_U)
F2_FIXED = 2         # a forward block's fixed cost in batches of F2_U senders (plan_fwd_l2's model)
F2_STAGE = 8192      # floats of a forward block's staged harmonics and x at most (32 KB)
E2_UNITS = 64        # units of an edge the dense 8-lane edge backward takes (two a lane past 32)
IDX_SLOTS = 16       # slots a thread of the sender-index forward takes at most
IDX_SLOTS_DW = 8     # ... of its dw
MIN_CHUNK = 8        # fewest entries of the summed axis one split takes
MIN_SLOTS = 4        # fewest slots a chunk of the sender-index dx takes, where there are enough
TARGET_BLOCKS = 2 * 132


def path_scale(p, dtype: torch.dtype = torch.float32) -> float:
    """c_p: the path's alpha * cg(0, l, l) diagonal, cg rounded to ``dtype``
    (exactly 1 in f32)."""
    if dtype == torch.float32:
        return 1.0
    return float(coupling(p, dtype)[0, 0, 0])


def scalar_path_aggregate_plain(x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                                scale: float = 1.0) -> torch.Tensor:
    """One path in plain PyTorch -> (B, N, U, K) f32: ``scale * sum_m x sh
    w`` of the operands read in f32; x (B, M, U), or (B, N, M, U) senders
    gathered per receiver.  Differentiable by autograd in x, sh and w."""
    f32 = torch.float32
    m = "bnm" if x.dim() == sh.dim() else "bm"
    out = torch.einsum(f"{m}u,bnmk,bnmu->bnuk", x.to(f32), sh.to(f32), w.to(f32))
    return out if scale == 1.0 else scale * out


@functools.lru_cache(maxsize=None)
def all_scalar_paths(tp: ChannelwiseTP) -> bool:
    """True when every path of ``tp`` has l_in = 0 (and its scaled coupling
    tensor is the identity, which the wigner tables make it): then the
    aggregate is K3's function path by path."""
    for p in tp.paths:
        if p.l_in != 0:
            return False
        if not np.allclose(p.alpha * wigner_3j(0, p.l_sh, p.l_out)[0], np.eye(2 * p.l_sh + 1),
                           atol=1e-6):
            return False
    return bool(tp.paths)


def path_views(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor):
    """Per path, in launch order, the (x, sh, w) last-axis slices of a
    convolution's full tensors that its path reads."""
    in_slices, sh_slices = tp.irreps_in.slices(), tp.irreps_sh.slices()
    return [(x[..., in_slices[p.i_in]], sh[..., sh_slices[p.i_sh]],
             w[..., p.w_slice[0]:p.w_slice[1]]) for p in tp.paths]


def _check_paths(tp: ChannelwiseTP) -> None:
    _check_tp(tp)
    if not all_scalar_paths(tp):
        raise ValueError("scalar_paths_aggregate: every path must have l_in = 0")


def scalar_paths_aggregate_plain(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
                                 w: torch.Tensor, sender_index: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """:func:`scalar_paths_aggregate` in plain PyTorch: the einsum of every
    path on the operands read in f32, times its :func:`path_scale` for their
    type, packed into (B, N, F, lanes(tp)).  ``sender_index``: x gathered
    per receiver first (the sender-index mode)."""
    _check_paths(tp)
    k_pad = lanes(tp)
    dtype = x.dtype
    x, sh, w = x.float(), sh.float(), w.float()
    if sender_index is not None:
        x = gather_senders(x, sender_index)      # in f32: slots' gradients add in f32
    pieces = []
    for p, (xv, shv, wv) in zip(tp.paths, path_views(tp, x, sh, w)):   # channel order
        part = scalar_path_aggregate_plain(xv, shv, wv, path_scale(p, dtype))
        pieces.append(Fn.pad(part, (0, k_pad - part.shape[-1])))
    return torch.cat(pieces, dim=-2)


def scalar_paths_backward_edge_plain(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
                                     w: torch.Tensor, g: torch.Tensor, need_dsh: bool,
                                     need_dw: bool = True,
                                     sender_index: Optional[torch.Tensor] = None
                                     ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """:func:`launch_backward_edge` in plain PyTorch: per path the einsums
    of dw and dsh on the operands read in f32, times its :func:`path_scale`,
    written into full-size gradients (dsh zero in the components no path
    reads) and returned in w's and sh's type.  ``sender_index``: x gathered
    per receiver first."""
    _check_paths(tp)
    c_dtype = x.dtype
    xf, shf, wf, gf = x.float(), sh.float(), w.float(), g.float()
    if sender_index is not None:
        xf = gather_senders(xf, sender_index)
    m = "bnm" if xf.dim() == shf.dim() else "bm"
    dw = torch.zeros_like(wf) if need_dw else None
    dsh = torch.zeros_like(shf) if need_dsh else None
    sh_slices = tp.irreps_sh.slices()
    for p, (xv, shv, wv) in zip(tp.paths, path_views(tp, xf, shf, wf)):
        c = path_scale(p, c_dtype)
        lo, hi = p.w_slice
        gv = gf[:, :, lo:hi, :shv.shape[-1]]
        if need_dw:
            dw[..., lo:hi] = c * torch.einsum(f"{m}u,bnmk,bnuk->bnmu", xv, shv, gv)
        if need_dsh:
            dsh[..., sh_slices[p.i_sh]] += c * torch.einsum(f"{m}u,bnmu,bnuk->bnmk", xv, wv, gv)
    return (None if dw is None else dw.to(w.dtype)), (None if dsh is None else dsh.to(sh.dtype))


@functools.lru_cache(maxsize=None)
def _conv_tables(tp: ChannelwiseTP, dtype: torch.dtype):
    """The forward's and dx's tables: per channel (x element, sh offset, K,
    0) int32 (F, 4) and c_p f32 (F,); per input element d the channels that
    read it, extents ``d_ptr`` (D + 1) into ``d_item`` (ascending)."""
    in_slices, sh_slices = tp.irreps_in.slices(), tp.irreps_sh.slices()
    chan = np.zeros((tp.weight_numel, 4), np.int32)
    scale = np.zeros(tp.weight_numel, np.float32)
    readers = [[] for _ in range(tp.irreps_in.dim)]
    for p in tp.paths:
        for u in range(p.mul_in):
            f, d = p.w_slice[0] + u, in_slices[p.i_in].start + u
            chan[f] = (d, sh_slices[p.i_sh].start, 2 * p.l_sh + 1, 0)
            scale[f] = path_scale(p, dtype)
            readers[d].append(f)
    d_ptr = np.zeros(len(readers) + 1, np.int32)
    d_ptr[1:] = np.cumsum([len(r) for r in readers])
    d_item = np.array([f for r in readers for f in sorted(r)] or [0], np.int32)
    return chan, scale, d_ptr, d_item


class UnitTables(NamedTuple):
    """The dense 8-lane kernels' lanes (:func:`units_l2`): ``units`` (G, 4)
    int32 of (f0, d0, off, K + 8 cnt), a unit being channels f0 .. f0 + cnt
    - 1 (cnt <= 4) of one path reading x elements d0 .. d0 + cnt - 1 and
    harmonic components off .. off + K - 1; ``scale`` (G,) f32 its path's
    c_p; per harmonic component s, the units whose path reads it, ``comp_ptr``
    (S + 1) extents into ``comp_item`` (j * KM + s - off of unit j,
    ascending j; one entry at least); ``vec``: every unit four channels at a
    multiple of four reading four x elements at a multiple of four, F and D
    multiples of four (then a lane reads x and w as one access each where
    their bases are aligned)."""

    units: np.ndarray
    scale: np.ndarray
    comp_ptr: np.ndarray
    comp_item: np.ndarray
    vec: bool


@functools.lru_cache(maxsize=None)
def units_l2(tp: ChannelwiseTP, dtype: torch.dtype = torch.float32) -> UnitTables:
    """Each path's channels cut into units of four from its first (its last
    unit shorter where its width is not a multiple of four), in channel
    order; c_p for operands of ``dtype``."""
    in_slices, sh_slices = tp.irreps_in.slices(), tp.irreps_sh.slices()
    rows, scales = [], []
    for p in tp.paths:
        f, d, off, K = (p.w_slice[0], in_slices[p.i_in].start, sh_slices[p.i_sh].start,
                        2 * p.l_sh + 1)
        for u in range(0, p.mul_in, 4):
            cnt = min(4, p.mul_in - u)
            rows.append((f + u, d + u, off, K + 8 * cnt))
            scales.append(path_scale(p, dtype))
    units = np.array(rows, np.int32).reshape(-1, 4)
    readers = [[j * KM + s - off for j, (_, _, off, kc) in enumerate(rows)
                if off <= s < off + (kc & 7)] for s in range(tp.irreps_sh.dim)]
    comp_ptr = np.zeros(len(readers) + 1, np.int32)
    comp_ptr[1:] = np.cumsum([len(r) for r in readers])
    comp_item = np.array([i for r in readers for i in r] or [0], np.int32)
    vec = (all(f0 % 4 == 0 and d0 % 4 == 0 and kc >> 3 == 4 for f0, d0, _, kc in rows)
           and tp.weight_numel % 4 == 0 and tp.irreps_in.dim % 4 == 0)
    return UnitTables(units, np.array(scales, np.float32), comp_ptr, comp_item, vec)


@functools.lru_cache(maxsize=None)
def _device_units(tp: ChannelwiseTP, device: str, dtype: torch.dtype):
    t = units_l2(tp, dtype)
    return tuple(torch.as_tensor(a, device=device) for a in t[:4]) + (t.vec,)


@functools.lru_cache(maxsize=None)
def plan_fwd_l2(B: int, N: int, M: int, G: int, target: int = TARGET_BLOCKS
                ) -> Tuple[int, int]:
    """(R, SL) of the dense 8-lane forward: a block per (batch row, R
    receivers), each receiver's senders split over SL slices of G lanes
    (slice s takes senders s, s + SL, ...), at most ``F2_THREADS`` threads.
    Of the SL that fill a block with as many receivers as fit (none past N),
    the one whose grid, in waves of ``target`` blocks, costs least: waves x
    (a slice's batches of ``F2_U`` senders + ``F2_FIXED``), the fewer slices
    on a tie."""
    best = None
    for SL in range(1, max(1, min(M, F2_THREADS // G)) + 1):
        R = max(1, min(N, F2_THREADS // (SL * G)))
        cost = -(-B * -(-N // R) // target) * (-(-M // (SL * F2_U)) + F2_FIXED)
        if best is None or cost < best[0]:
            best = (cost, R, SL)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def chunk_fwd_l2(R: int, SL: int, M: int, S: int, D: int) -> int:
    """MC, the senders the dense 8-lane forward stages at a time: a multiple
    of SL, all M where their harmonics (R receivers) and rows of x fit
    ``F2_STAGE`` floats, else as many as fit (SL at least)."""
    fit = (F2_STAGE - 3) // (R * S + D) // SL * SL
    return max(SL, min(-(-M // SL) * SL, fit))


@functools.lru_cache(maxsize=None)
def chunk_idx(R: int, SL: int, K: int, S: int) -> int:
    """MC, the slots the sender-index forward and dw stage at a time: a
    multiple of SL, all K where their harmonics (R receivers each) fit
    ``F2_STAGE`` floats, else as many as fit (SL at least)."""
    fit = F2_STAGE // (R * S) // SL * SL
    return max(SL, min(-(-K // SL) * SL, fit))


def idx_smem(dw: bool, R: int, SL: int, F: int, MC: int, S: int) -> int:
    """Bytes of shared memory a block of the sender-index forward (or dw)
    takes (``idx_floats`` in csrc/tp_scalar.cu): the staged harmonics (or
    the forward's sums), then the forward's per-channel K and c_p."""
    work = max(0 if dw else R * SL * F * KM, R * MC * S)
    return 4 * (-(-work // 4) * 4 + (0 if dw else 2 * F))


@functools.lru_cache(maxsize=None)
def plan_idx(tp: ChannelwiseTP, B: int, N: int, K: int, dw: bool = False
             ) -> Tuple[int, int, int]:
    """(R, SL, MC) of the sender-index forward (or, ``dw``, its dw) on (B,
    N, K): a block of R receivers x SL slices x G units, the slices enough
    that a thread takes at most ``IDX_SLOTS`` (``IDX_SLOTS_DW``) slots (fewer
    slices where SL G would pass ``F2_THREADS``), as many receivers as fit,
    and :func:`chunk_idx`; raises where the block would not fit (its
    threads, or 48 KB of shared memory).  The forward adds its slices' sums
    at the end, so it takes fewer slices than dw, whose slots are
    independent (analysis/k3_idx_variants.py)."""
    G, S = len(units_l2(tp).units), tp.irreps_sh.dim
    if G > F2_THREADS:
        raise ValueError(f"tp_scalar: {G} units of four channels, more than the sender-index "
                         f"kernels' {F2_THREADS} threads")
    SL = max(1, min(K, -(-K // (IDX_SLOTS_DW if dw else IDX_SLOTS)), F2_THREADS // G))
    R = max(1, min(N, F2_THREADS // (SL * G)))
    MC = chunk_idx(R, SL, K, S)
    if idx_smem(False, R, SL, tp.weight_numel, MC, S) > 48 * 1024:
        raise ValueError("tp_scalar: the sender-index block needs more than 48 KB of shared "
                         "memory")
    return R, SL, MC


def launch_plan_fwd_l2(tp: ChannelwiseTP, B: int, N: int, M: int, device,
                       dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """(R, SL, MC) of the dense 8-lane forward on the card
    (:func:`plan_fwd_l2`, :func:`chunk_fwd_l2`): waves of every block slot
    the card holds of its fullest block."""
    t = units_l2(tp, dtype)
    G, S, D = len(t.units), tp.irreps_sh.dim, tp.irreps_in.dim
    target = max(TARGET_BLOCKS, _resident_blocks_f2(tp.weight_numel, G, S, D, t.vec,
                                                    dtype == torch.bfloat16, str(device)))
    R, SL = plan_fwd_l2(B, N, M, G, target)
    return R, SL, chunk_fwd_l2(R, SL, M, S, D)


@functools.lru_cache(maxsize=None)
def _resident_blocks_f2(F: int, G: int, S: int, D: int, vec: bool, bf16: bool,
                        device: str) -> int:
    """Blocks of the dense 8-lane forward the card holds at once, at its
    fullest block (``F2_THREADS // G`` slices of one receiver, as many
    senders staged as ``F2_STAGE`` holds)."""
    SL = F2_THREADS // G
    per_sm = _library().dp_tp_scalar_fwd_l2_dense_blocks_per_sm(
        1, SL, G, F, chunk_fwd_l2(1, SL, F2_STAGE, S, D), S, D, int(vec), int(bf16))
    _raise_on(max(0, -per_sm), "tp_scalar_fwd_l2 occupancy query")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _edge_blocks_l2(need_dsh: bool, vec: bool, S: int, n_items: int, G: int, bf16: bool,
                    device: str) -> int:
    """Blocks of the dense 8-lane edge backward of G units the card holds
    at once."""
    per_sm = _library().dp_tp_scalar_bwd_edge_l2_dense_blocks_per_sm(
        int(need_dsh), int(vec), S, n_items, G, int(bf16))
    _raise_on(max(0, -per_sm), "tp_scalar_bwd_edge_l2 occupancy query")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def sh_reach(tp: ChannelwiseTP) -> int:
    """One past the last harmonic component any path of ``tp`` reads."""
    sh_slices = tp.irreps_sh.slices()
    return max(sh_slices[p.i_sh].stop for p in tp.paths)


@functools.lru_cache(maxsize=None)
def x_quads(tp: ChannelwiseTP) -> bool:
    """True when channels 4i..4i+3 read elements d..d+3 of x, d a multiple of
    four, for every i: the edge backward then reads x four elements at a
    time."""
    d = _conv_tables(tp, torch.float32)[0][:, 0]
    return len(d) % 4 == 0 and all(d[i] % 4 == 0 and list(d[i:i + 4]) == list(range(d[i], d[i] + 4))
                                   for i in range(0, len(d), 4))


@functools.lru_cache(maxsize=None)
def _device_conv_tables(tp: ChannelwiseTP, device: str, dtype: torch.dtype):
    return tuple(torch.as_tensor(t, device=device) for t in _conv_tables(tp, dtype))


def keep_of(F: int) -> int:
    """Entries of the kept axis (receivers for the forward, senders for dx)
    one block takes: a thread for each of their channels."""
    return max(1, THREADS // F)


@functools.lru_cache(maxsize=None)
def plan_chunk(B: int, kept: int, summed: int, F: int, target: int = TARGET_BLOCKS
               ) -> Tuple[int, int]:
    """(chunk, splits) of the summed axis of the forward (senders) or dx
    (receivers): split k takes entries [k * chunk, (k + 1) * chunk).  The
    fewest splits that give ``target`` blocks of (batch row, ``keep_of(F)``
    kept entries), none with fewer than ``MIN_CHUNK`` entries where the axis
    has them: a split's partial sums cost bytes of their own."""
    tiles = B * -(-kept // keep_of(F))
    splits = max(1, min(-(-target // tiles), summed // MIN_CHUNK))
    chunk = -(-summed // splits)
    return chunk, -(-summed // chunk)


@functools.lru_cache(maxsize=None)
def plan_run_l2(M: int, F: int) -> int:
    """Senders one block of the 8-lane dx takes (a run): a thread per
    (channel, group of ``X2_Q`` senders), at most ``X2_THREADS`` threads, the
    runs of the M senders as even as that allows."""
    runs = -(-M // (X2_Q * max(1, X2_THREADS // F)))
    return -(-M // runs)


@functools.lru_cache(maxsize=None)
def plan_chunk_l2(B: int, N: int, M: int, F: int, target: int = TARGET_BLOCKS
                  ) -> Tuple[int, int, int]:
    """(run, chunk, splits) of the 8-lane dx: a block per (batch row, run of
    :func:`plan_run_l2` senders, chunk of receivers [k * chunk, (k + 1) *
    chunk)); at least the fewest splits that give ``target`` blocks, none
    with fewer than ``X2_MIN_CHUNK`` receivers where there are that many.
    Each thread reads each of its receivers' g rows once for its senders."""
    run = plan_run_l2(M, F)
    tiles = B * -(-M // run)
    splits = max(1, min(-(-target // tiles), N // X2_MIN_CHUNK))
    chunk = max(1, N // splits)
    return run, chunk, -(-N // chunk)


@functools.lru_cache(maxsize=None)
def plan_slot_chunk(slots: int, senders: int, F: int, target: int = TARGET_BLOCKS
                    ) -> Tuple[int, int]:
    """(Q, bound) of the sender-index dx over ``slots`` slots and ``senders``
    sender rows: Q, the most slots one chunk takes, the largest (and at
    least ``MIN_SLOTS``) whose chunks still give ``target`` blocks of
    ``keep_of(F)`` chunks whatever the index; ``bound``, the most chunks any
    index can give at that Q (each sender's last chunk may be short), the
    kernel's grid-stride range and the scratch's rows."""
    Q = max(MIN_SLOTS, slots // (target * keep_of(F)))
    return Q, slots // Q + min(senders, slots)


def slot_chunks(ptr: torch.Tensor, Q: int, bound: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sender's slots of :func:`tp_fused.sender_lists` cut into chunks of
    at most ``Q``, on ptr's device and without waiting for it: ``cuts``
    (bound + 1,) int32, chunk i is ``order[cuts[i]:cuts[i + 1]]`` (the chunks
    tile ``order`` in its own order; those past the last are empty), and
    ``row_ptr`` (senders + 1,) int32, sender r's chunks ``row_ptr[r]:row_ptr[r
    + 1]`` (none for a sender no slot reads)."""
    p = ptr.long()
    count = p[1:] - p[:-1]
    row_ptr = torch.zeros_like(p)
    row_ptr[1:] = torch.cumsum((count + Q - 1) // Q, 0)
    i = torch.arange(bound, device=p.device)
    row = torch.searchsorted(row_ptr[1:], i, right=True).clamp(max=max(len(count) - 1, 0))
    start = torch.where(i < row_ptr[-1], p[row] + (i - row_ptr[row]) * Q, p[-1])
    return torch.cat([start, p[-1:]]).int(), row_ptr.int()


class DxLists(NamedTuple):
    """What the sender-index dx reads of an index: (order, ptr) of
    :func:`tp_fused.sender_lists`, (cuts, row_ptr) of :func:`slot_chunks`,
    the chunks' Q and the blocks that cover their ``len(cuts) - 1`` rows."""

    order: torch.Tensor
    ptr: torch.Tensor
    cuts: torch.Tensor
    row_ptr: torch.Tensor
    Q: int
    blocks: int


def dx_lists(tp: ChannelwiseTP, sender_index: torch.Tensor, m_x: int,
             dtype: torch.dtype = torch.float32) -> DxLists:
    """The sender-index dx's lists and plan for a (B, N, K) index over B *
    m_x senders: Q from :func:`plan_slot_chunk` against every block slot the
    card holds of the chunk kernel (an occupancy query).  The autograd
    forward builds them once."""
    B, N, K = sender_index.shape
    F = tp.weight_numel
    target = TARGET_BLOCKS
    if sender_index.device.type == "cuda":
        target = max(target, _resident_blocks(2, F, tp.irreps_in.dim, 1, dtype == torch.bfloat16,
                                              str(sender_index.device), lanes(tp) == K_PAD_L2))
    Q, bound = plan_slot_chunk(B * N * K, B * m_x, F, target)
    order, ptr = sender_lists(sender_index, m_x)
    return DxLists(order, ptr, *slot_chunks(ptr, Q, bound), Q, -(-bound // keep_of(F)))


@functools.lru_cache(maxsize=None)
def _resident_blocks(dx: int, F: int, D: int, n_items: int, bf16: bool, device: str,
                     l2: bool = False) -> int:
    """Blocks of the forward (dx = 0), the dense dx (1) or the sender-index
    dx's chunk kernel (2) the card holds at once."""
    query = (_library().dp_tp_scalar_blocks_per_sm_l2 if l2
             else _library().dp_tp_scalar_blocks_per_sm)
    per_sm = query(int(dx), F, D, n_items, int(bf16))
    _raise_on(max(0, -per_sm), "tp_scalar occupancy query")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _resident_blocks_x2(F: int, D: int, n_items: int, run: int, bf16: bool,
                        device: str) -> int:
    """Blocks of the 8-lane dx the card holds at once at these widths and
    run of senders."""
    per_sm = _library().dp_tp_scalar_bwd_x_l2_blocks_per_sm(F, D, n_items, run, int(bf16))
    _raise_on(max(0, -per_sm), "tp_scalar_bwd_x_l2 occupancy query")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _edge_blocks(need_dsh: bool, bf16: bool, device: str) -> int:
    """Blocks of the dense 4-lane edge backward the card holds at once."""
    per_sm = _library().dp_tp_scalar_bwd_edge_blocks_per_sm(int(need_dsh), int(bf16))
    _raise_on(max(0, -per_sm), "tp_scalar edge-backward occupancy query")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("tp_scalar")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dp_tp_scalar_fwd.argtypes = [p] * 7 + [i] * 10 + [p]
    lib.dp_tp_scalar_bwd_x.argtypes = [p] * 9 + [i] * 11 + [p]
    lib.dp_tp_scalar_bwd_x_idx.argtypes = [p] * 13 + [i] * 10 + [p]
    lib.dp_tp_scalar_bwd_edge.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.dp_tp_scalar_blocks_per_sm.argtypes = [i] * 5
    lib.dp_tp_scalar_bwd_edge_blocks_per_sm.argtypes = [i] * 2
    lib.dp_tp_scalar_bwd_x_l2.argtypes = lib.dp_tp_scalar_bwd_x.argtypes
    lib.dp_tp_scalar_bwd_x_idx_l2.argtypes = lib.dp_tp_scalar_bwd_x_idx.argtypes
    lib.dp_tp_scalar_blocks_per_sm_l2.argtypes = [i] * 5
    lib.dp_tp_scalar_bwd_x_l2_smem.argtypes = [i] * 4
    lib.dp_tp_scalar_bwd_x_l2_blocks_per_sm.argtypes = [i] * 5
    lib.dp_tp_scalar_fwd_l2_dense.argtypes = [p] * 7 + [i] * 12 + [p]
    lib.dp_tp_scalar_fwd_l2_dense_smem.argtypes = [i] * 6
    lib.dp_tp_scalar_fwd_l2_dense_blocks_per_sm.argtypes = [i] * 9
    lib.dp_tp_scalar_bwd_edge_l2_dense.argtypes = [p] * 10 + [i] * 11 + [p]
    lib.dp_tp_scalar_bwd_edge_l2_dense_blocks_per_sm.argtypes = [i] * 6
    lib.dp_tp_scalar_bwd_edge_l2_dense_smem.argtypes = [i] * 4
    lib.dp_tp_scalar_idx.argtypes = [p] * 11 + [i] * 15 + [p]
    lib.dp_tp_scalar_idx_smem.argtypes = [i] * 6
    for fn in (lib.dp_tp_scalar_fwd, lib.dp_tp_scalar_bwd_edge, lib.dp_tp_scalar_bwd_x,
               lib.dp_tp_scalar_blocks_per_sm, lib.dp_tp_scalar_bwd_edge_blocks_per_sm,
               lib.dp_tp_scalar_bwd_x_l2, lib.dp_tp_scalar_blocks_per_sm_l2,
               lib.dp_tp_scalar_bwd_x_idx, lib.dp_tp_scalar_bwd_x_idx_l2,
               lib.dp_tp_scalar_bwd_x_l2_smem, lib.dp_tp_scalar_bwd_x_l2_blocks_per_sm,
               lib.dp_tp_scalar_fwd_l2_dense, lib.dp_tp_scalar_fwd_l2_dense_smem,
               lib.dp_tp_scalar_fwd_l2_dense_blocks_per_sm, lib.dp_tp_scalar_bwd_edge_l2_dense,
               lib.dp_tp_scalar_bwd_edge_l2_dense_blocks_per_sm,
               lib.dp_tp_scalar_bwd_edge_l2_dense_smem, lib.dp_tp_scalar_idx,
               lib.dp_tp_scalar_idx_smem):
        fn.restype = i
    lib.dp_cuda_error_string.argtypes = [i]
    lib.dp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_library().dp_cuda_error_string(rc).decode()}")


def _check_views(dtype: torch.dtype, **views: Tuple[torch.Tensor, Tuple[int, ...]]) -> None:
    """Each (tensor, expected shape): on one CUDA device, of that shape and
    contiguous; the gradient ``grad`` f32, every other tensor of ``dtype``
    (f32 or bf16)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tp_scalar: operands must be f32 or bf16, got {dtype}")
    device = next(iter(views.values()))[0].device
    for name, (t, shape) in views.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"tp_scalar: {name} on {t.device}; all tensors must be on one "
                             f"CUDA device")
        want = torch.float32 if name == "grad" else dtype
        if t.dtype != want:
            raise TypeError(f"tp_scalar: {name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"tp_scalar: {name} {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"tp_scalar: {name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_conv(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                sender_index: Optional[torch.Tensor] = None) -> Tuple[int, ...]:
    """(B, N, M, D, S, F) of a convolution-level launch; raises on what the
    forward and dx kernels do not take (with ``sender_index`` (B, N, M)
    int32, x is (B, M_x, D))."""
    _check_paths(tp)
    if sh.dim() != 4:
        raise ValueError(f"tp_scalar: sh must be (B, N, M, S), got {tuple(sh.shape)}")
    B, N, M, S = sh.shape
    D, F = tp.irreps_in.dim, tp.weight_numel
    if F > THREADS:
        raise ValueError(f"tp_scalar: F = {F} channels, more than a block's {THREADS} threads")
    m_x = M if sender_index is None else x.shape[1]
    if sender_index is not None:
        check_index(sender_index, (B, N, M), x.device, "tp_scalar")
    views = {"x": (x, (B, m_x, D)), "sh": (sh, (B, N, M, tp.irreps_sh.dim)),
             "w": (w, (B, N, M, F))}
    if g is not None:
        views["grad"] = (g, (B, N, F, lanes(tp)))
    _check_views(x.dtype, **views)
    return B, N, M, D, S, F


def launch_forward(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
                   w: torch.Tensor, sender_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every path of the convolution in one forward launch -> (B, N, F,
    lanes(tp)) f32 (and the sum of the sender splits' partial sums where
    :func:`launch_chunk` splits).  The dense 8-lane forward is
    ``tp_scalar_fwd_l2_kernel``: whole receivers a block, their senders
    split over slices of the block's lanes (:func:`launch_plan_fwd_l2`), a
    lane a unit of :func:`units_l2`, the output written once."""
    B, N, M, D, S, F = _check_conv(tp, x, sh, w, sender_index=sender_index)
    k_pad = lanes(tp)
    l2 = k_pad == K_PAD_L2
    chan, scale, _, _ = _device_conv_tables(tp, str(x.device), x.dtype)
    out = torch.empty((B, N, F, k_pad), dtype=torch.float32, device=x.device)
    bf16 = int(x.dtype == torch.bfloat16)
    if sender_index is not None:
        _launch_idx(tp, x, sh, w, sender_index, None, out, None)
        counter(FWD, FWD_L2, FWD_IDX, FWD_IDX_L2, sender_index, l2).launches += 1
        return out
    if l2:
        units, _, _, _, vec = _device_units(tp, str(x.device), x.dtype)
        R, SL, MC = launch_plan_fwd_l2(tp, B, N, M, x.device, x.dtype)
        rc = _library().dp_tp_scalar_fwd_l2_dense(
            x.data_ptr(), sh.data_ptr(), w.data_ptr(), units.data_ptr(), chan.data_ptr(),
            scale.data_ptr(), out.data_ptr(), B, N, M, D, S, F, units.shape[0], R, SL, MC,
            int(vec), bf16, _stream(x.device))
        _raise_on(rc, "tp_scalar_fwd_l2")
        FWD_L2.launches += 1
        return out
    chunk, splits = launch_chunk(tp, B, N, M, False, x.device, x.dtype)
    part = (torch.empty((splits, B, N, F, k_pad), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    rc = _library().dp_tp_scalar_fwd(
        x.data_ptr(), sh.data_ptr(), w.data_ptr(), chan.data_ptr(), scale.data_ptr(),
        out.data_ptr(), _ptr(part), B, N, M, D, S, F, keep_of(F), chunk, splits, bf16,
        _stream(x.device))
    _raise_on(rc, "tp_scalar_fwd")
    FWD.launches += 1
    return out


def _launch_idx(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: Optional[torch.Tensor],
                sender_index: torch.Tensor, g: Optional[torch.Tensor],
                out: Optional[torch.Tensor], dw: Optional[torch.Tensor]) -> None:
    """``tp_scalar_idx_kernel`` on checked inputs: the sender-index forward
    into ``out`` (w read), or, given ``g``, dw into ``dw``; a block per
    (:func:`plan_idx` receivers, batch row), whole receivers, all their
    slots in one pass."""
    B, N, K, S = sh.shape
    D, F = tp.irreps_in.dim, tp.weight_numel
    dev = str(x.device)
    chan, scale, _, _ = _device_conv_tables(tp, dev, x.dtype)
    units, uscale, _, _, vec = _device_units(tp, dev, x.dtype)
    R, SL, MC = plan_idx(tp, B, N, K, g is not None)
    rc = _library().dp_tp_scalar_idx(
        x.data_ptr(), sh.data_ptr(), _ptr(w), sender_index.data_ptr(), _ptr(g),
        units.data_ptr(), uscale.data_ptr(), chan.data_ptr(), scale.data_ptr(), _ptr(out),
        _ptr(dw), B, N, K, x.shape[1], D, S, F, units.shape[0], R, SL, MC, int(vec), lanes(tp),
        int(g is not None), int(x.dtype == torch.bfloat16), _stream(x.device))
    _raise_on(rc, "tp_scalar_idx")


def launch_backward_x(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                      g: torch.Tensor, sender_index: Optional[torch.Tensor] = None,
                      lists: Optional[DxLists] = None) -> torch.Tensor:
    """dx of every path in one launch, in x's type (x gives its shape and
    type only; and the sum of the receiver splits' f32 partial sums where
    :func:`launch_chunk` splits; at 8 lanes by runs of senders and receiver
    chunks, :func:`launch_plan_l2`).  The sender-index mode forms each
    slot's f32 term once (receiver by receiver), sums each sender's terms in
    chunks (:func:`dx_lists`: ``lists``, built here when not given), then
    each sender's chunks in order: three kernels, one launch."""
    B, N, M, D, S, F = _check_conv(tp, x, sh, w, g, sender_index)
    chan, scale, d_ptr, d_item = _device_conv_tables(tp, str(x.device), x.dtype)
    dx = torch.empty_like(x)
    l2 = lanes(tp) == K_PAD_L2
    bf16 = int(x.dtype == torch.bfloat16)
    if sender_index is None:
        if l2:
            keep, chunk, splits = launch_plan_l2(tp, B, N, M, x.device, x.dtype)
        else:
            keep = keep_of(F)
            chunk, splits = launch_chunk(tp, B, N, M, True, x.device, x.dtype)
        part = (torch.empty((splits, B, M, D), dtype=torch.float32, device=x.device)
                if splits > 1 else None)
        launch = _library().dp_tp_scalar_bwd_x_l2 if l2 else _library().dp_tp_scalar_bwd_x
        rc = launch(
            sh.data_ptr(), w.data_ptr(), g.data_ptr(), chan.data_ptr(), scale.data_ptr(),
            d_ptr.data_ptr(), d_item.data_ptr(), dx.data_ptr(), _ptr(part), B, N, M, D, S, F,
            d_item.shape[0], keep, chunk, splits, bf16, _stream(x.device))
    else:
        m_x = x.shape[1]
        if lists is None:
            lists = dx_lists(tp, sender_index, m_x, x.dtype)
        y = torch.empty((B * N * M, F), dtype=torch.float32, device=x.device)
        part = torch.empty((len(lists.cuts) - 1, F), dtype=torch.float32, device=x.device)
        launch = (_library().dp_tp_scalar_bwd_x_idx_l2 if l2
                  else _library().dp_tp_scalar_bwd_x_idx)
        rc = launch(
            sh.data_ptr(), w.data_ptr(), g.data_ptr(), chan.data_ptr(), scale.data_ptr(),
            d_ptr.data_ptr(), d_item.data_ptr(), lists.order.data_ptr(), lists.cuts.data_ptr(),
            lists.row_ptr.data_ptr(), dx.data_ptr(), y.data_ptr(), part.data_ptr(), B, N, M, m_x,
            D, S, F, keep_of(F), lists.blocks, bf16, _stream(x.device))
    _raise_on(rc, "tp_scalar_bwd_x_l2" if l2 else "tp_scalar_bwd_x")
    counter(BWD_X, BWD_X_L2, BWD_X_IDX, BWD_X_IDX_L2, sender_index, l2).launches += 1
    return dx


def launch_plan_l2(tp: ChannelwiseTP, B: int, N: int, M: int, device,
                   dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """(run, chunk, splits) of the 8-lane dx launch on the card
    (:func:`plan_chunk_l2`): blocks for ``X2_WAVES`` times every block slot
    the card holds at these widths, so that the last wave's share is small."""
    F = tp.weight_numel
    run = plan_run_l2(M, F)
    n_items = len(_conv_tables(tp, dtype)[3])
    target = max(TARGET_BLOCKS, X2_WAVES * _resident_blocks_x2(
        F, tp.irreps_in.dim, n_items, run, dtype == torch.bfloat16, str(device)))
    return plan_chunk_l2(B, N, M, F, target)


def launch_chunk(tp: ChannelwiseTP, B: int, N: int, M: int, dx: bool, device,
                 dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(chunk, splits) of the forward (or the 4-lane dx) launch on the card:
    enough blocks for every block slot the card holds at these widths (the
    8-lane dx: :func:`launch_plan_l2`)."""
    F = tp.weight_numel
    n_items = len(_conv_tables(tp, dtype)[3])
    target = max(TARGET_BLOCKS, _resident_blocks(int(dx), F, tp.irreps_in.dim, n_items,
                                                 dtype == torch.bfloat16, str(device),
                                                 lanes(tp) == K_PAD_L2))
    return plan_chunk(B, M, N, F, target) if dx else plan_chunk(B, N, M, F, target)


def check_edge(tp: ChannelwiseTP, indexed: bool) -> None:
    """Raises where the edge backward does not take the convolution: the
    dense 4-lane kernel at most ``EDGE_F_MAX`` channels reading the first
    ``EDGE_REACH`` harmonic components, the dense 8-lane one at most
    ``E2_UNITS`` units (the sender-index kernel: :func:`plan_idx`'s
    limits)."""
    if indexed:
        return
    if lanes(tp) == K_PAD_L2:
        if len(units_l2(tp).units) > E2_UNITS:
            raise ValueError(f"tp_scalar: {len(units_l2(tp).units)} units of four channels, "
                             f"more than the 8-lane edge backward's {E2_UNITS} an edge")
        return
    F = tp.weight_numel
    if F > EDGE_F_MAX:
        raise ValueError(f"tp_scalar: F = {F} channels, more than the edge backward's "
                         f"{EDGE_F_MAX}")
    if sh_reach(tp) > EDGE_REACH:
        raise ValueError(f"tp_scalar: the paths read {sh_reach(tp)} harmonic components, more "
                         f"than the edge backward's {EDGE_REACH}")


def check_shapes(tp: ChannelwiseTP, B: int, N: int, M: int, indexed: bool = False) -> dict:
    """What the K3 launches of a convolution on (B, N, M) need, from the
    shapes alone (no card): each kernel's plan (``fwd``, ``bwd_edge``,
    ``bwd_x``); raises where a kernel does not take the convolution, the
    limit in the message.  ``indexed``: the sender-index mode (M = K
    slots)."""
    _check_paths(tp)
    F, D, S = tp.weight_numel, tp.irreps_in.dim, tp.irreps_sh.dim
    if F > THREADS:
        raise ValueError(f"tp_scalar: F = {F} channels, more than a block's {THREADS} threads")
    l2 = lanes(tp) == K_PAD_L2
    n_items = len(_conv_tables(tp, torch.float32)[3])
    out = {}
    if indexed:
        out["fwd"], out["bwd_edge"] = plan_idx(tp, B, N, M), plan_idx(tp, B, N, M, True)
        out["bwd_x"] = keep_of(F)
        return out
    check_edge(tp, False)
    out["bwd_edge"] = len(units_l2(tp).units) if l2 else -(-F // 4)
    if l2:
        G = len(units_l2(tp).units)
        R, SL = plan_fwd_l2(B, N, M, G)
        MC = chunk_fwd_l2(R, SL, M, S, D)
        if R * SL * G > F2_THREADS or 4 * max(R * SL * F * KM, -(-R * MC * S // 4) * 4 + MC * D) \
                > 48 * 1024:
            raise ValueError("tp_scalar: the 8-lane forward's block does not fit")
        out["fwd"] = (R, SL, MC)
        run, chunk, splits = plan_chunk_l2(B, N, M, F)
        if -(-run // X2_Q) * F > X2_THREADS or 4 * (-(-run * F // 4) * 4 + -(-(D + 1) // 4) * 4
                                                   + -(-n_items // 4) * 4) > 48 * 1024:
            raise ValueError("tp_scalar: the 8-lane dx's block does not fit")
        out["bwd_x"] = (run, chunk, splits)
        return out
    keep = keep_of(F)
    out["fwd"] = plan_chunk(B, N, M, F)
    if 4 * (keep * F + D + 1 + n_items) > 48 * 1024:
        raise ValueError("tp_scalar: the dx block does not fit")
    out["bwd_x"] = plan_chunk(B, M, N, F)
    return out


def launch_backward_edge(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                         g: torch.Tensor, need_dsh: bool, need_dw: bool = True,
                         sender_index: Optional[torch.Tensor] = None
                         ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dw, dsh) of every path of a convolution in one launch, in w's and
    sh's type: dw only with ``need_dw``, dsh (the full S-component row, zero
    in the components no path reads) only with ``need_dsh``.  g is the (B,
    N, F, lanes(tp)) f32 upstream gradient.  The sender-index mode computes
    dw only and refuses ``need_dsh``.  The dense 8-lane edge backward is
    ``tp_scalar_bwd_edge_l2_kernel``, a lane a unit of :func:`units_l2`
    (at most ``E2_UNITS`` units, two a lane past 32)."""
    if sender_index is not None and need_dsh:
        raise ValueError("tp_scalar: the sender-index mode computes no dsh (the KNN phore "
                         "grid's harmonics carry no gradient)")
    B, N, M, D, S, F = _check_conv(tp, x, sh, w, g, sender_index)
    if B * N * M * max(F, S) + B * x.shape[1] * D >= 2**31 - 1:
        raise ValueError("tp_scalar: the edge backward indexes its operands with 32-bit offsets")
    l2 = lanes(tp) == K_PAD_L2
    check_edge(tp, sender_index is not None)
    if not (need_dw or need_dsh):
        return None, None
    dw = torch.empty_like(w) if need_dw else None
    dsh = torch.empty_like(sh) if need_dsh else None
    bf16 = x.dtype == torch.bfloat16
    if sender_index is not None:
        _launch_idx(tp, x, sh, None, sender_index, g, None, dw)
        counter(BWD_EDGE, BWD_EDGE_L2, BWD_EDGE_IDX, BWD_EDGE_IDX_L2, sender_index,
                l2).launches += 1
        return dw, dsh
    if l2:
        units, uscale, comp_ptr, comp_item, vec = _device_units(tp, str(x.device), x.dtype)
        n_items = int(units_l2(tp).comp_ptr[-1])
        G = units.shape[0]
        rc = _library().dp_tp_scalar_bwd_edge_l2_dense(
            x.data_ptr(), sh.data_ptr(), w.data_ptr(), g.data_ptr(), units.data_ptr(),
            uscale.data_ptr(), comp_ptr.data_ptr(), comp_item.data_ptr(), _ptr(dw), _ptr(dsh), B,
            N, M, D, S, F, G, n_items, int(vec),
            _edge_blocks_l2(need_dsh, vec, S, n_items, G, bf16, str(x.device)), int(bf16),
            _stream(x.device))
        _raise_on(rc, "tp_scalar_bwd_edge_l2")
        BWD_EDGE_L2.launches += 1
        return dw, dsh
    chan, scale, _, _ = _device_conv_tables(tp, str(x.device), x.dtype)
    rc = _library().dp_tp_scalar_bwd_edge(
        x.data_ptr(), sh.data_ptr(), w.data_ptr(), g.data_ptr(), chan.data_ptr(),
        scale.data_ptr(), _ptr(dw), _ptr(dsh), B, N, M, D, S, F, sh_reach(tp),
        int(x_quads(tp)), _edge_blocks(need_dsh, bf16, str(x.device)), int(bf16),
        _stream(x.device))
    _raise_on(rc, "tp_scalar_bwd_edge")
    BWD_EDGE.launches += 1
    return dw, dsh


class ScalarPathsAggregate(torch.autograd.Function):
    """Every path of an all-l_in-0 convolution under autograd, on the
    convolution's full tensors: one forward launch, one edge-backward launch
    (dw, and dsh where asked) and one dx launch for the convolution.
    ``dsh`` is computed only when sh requires grad, ``dx`` only when x does,
    ``dw`` only when w does."""

    @staticmethod
    def forward(ctx, tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                sender_index: Optional[torch.Tensor] = None):
        ctx.tp = tp
        ctx.sender_index = sender_index
        ctx.lists = (dx_lists(tp, sender_index, x.shape[1], x.dtype)
                     if sender_index is not None and ctx.needs_input_grad[1] else None)
        ctx.save_for_backward(x, sh, w)
        return launch_forward(tp, x, sh, w, sender_index)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        tp = ctx.tp
        x, sh, w = ctx.saved_tensors
        _, need_dx, need_dsh, need_dw, _ = ctx.needs_input_grad
        g = grad_out.to(torch.float32).contiguous()
        idx = ctx.sender_index
        dw, dsh = launch_backward_edge(tp, x, sh, w, g, need_dsh, need_dw, idx)
        dx = launch_backward_x(tp, x, sh, w, g, idx, ctx.lists) if need_dx else None
        return None, dx, dsh, dw, None


def scalar_paths_aggregate(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
                           w: torch.Tensor, sender_index: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The aggregate of a convolution whose paths all have l_in = 0 -> (B, N,
    F, lanes(tp)) f32 in the layout :func:`tp_fused.blocks_from_padded` reads;
    differentiable in x, sh, w (their gradients in their own type).

    x (B, M, D_in); sh (B, N, M, S); w (B, N, M, F) pre-masked, F <= 256;
    all f32 or all bf16, contiguous.  ``sender_index`` (B, N, K) int32: the
    sender-index mode, x (B, M_x, D_in) and M = K (module note).  CPU
    tensors take the plain version; CUDA tensors launch the kernels or
    raise.
    """
    _check_paths(tp)
    if x.device.type == "cpu" and sh.device.type == "cpu" and w.device.type == "cpu":
        return scalar_paths_aggregate_plain(tp, x, sh, w, sender_index)
    _check_conv(tp, x, sh, w, sender_index=sender_index)
    return ScalarPathsAggregate.apply(tp, x, sh, w, sender_index)
