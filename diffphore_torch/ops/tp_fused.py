"""K1: fused edge MLP + channelwise tensor-product aggregate.

The port of ``diffphore_tpu/ops/pallas/tp_fused.py::tp_aggregate_fused``
(the TPU kernel) as a CUDA kernel for Hopper, ``csrc/tp_fused.cu``.  Per
(batch row, receiver) it computes the edge weights

    w = (sum_c relu(attr_c W1 + b1) * mask_c) W2 + (sum_c mask_c) b2

on chip and sums the channelwise tensor product of the sender features and
edge harmonics, weighted by w, over all senders.  With bf16 inputs it
computes what the JAX package's bf16 convolution computes instead
(:func:`edge_weights` in bf16, then ``ChannelwiseTP.aggregate``): the MLP
parameters, the pre-activation, the hidden layer, each channel's weights and
their masked sum are rounded to bf16, the coupling tensors too, and the
tensor product is summed in f32.  Output (B, N, F, L) f32, L =
:func:`lanes` (4 where every irrep has l <= 1, else 8): channel f's l_out
components in lanes [:2*l_out+1], which :func:`blocks_from_padded` splits
into the per-irrep blocks of ``ChannelwiseTP.aggregate``.

:func:`tp_aggregate_fused` launches the kernel for CUDA tensors and runs
:func:`tp_aggregate_fused_plain`, the same function in plain PyTorch, for
CPU tensors.  A product whose irreps reach l = 2 (``use_second_order_repr``)
runs the 8-lane kernel ``tp_fused_l2_kernel`` (same source; a block per
channel tile of :func:`channel_tiles`, its tables by tile from
:func:`tables_tiled_l2`), the others the 4-lane one.  ``KERNEL.launches``
and ``KERNEL_L2.launches`` count the launches of each.

Sender-index mode (the KNN phore grid, ``phore_knn``): with
``sender_index`` (B, N, K) int32 the edge tensors are (B, N, K, ...) and
slot k of receiver n reads the sender row ``x[b, sender_index[b, n, k]]``
of x (B, M_x, D).  Each kernel takes it (``tp_fused_kernel`` for l <= 1, as a
template flag, and ``tp_fused_l2_kernel`` for l = 2): a tile's rows bring
their senders' features with their attributes instead of the block keeping
its senders'.  ``KERNEL_IDX`` and ``KERNEL_IDX_L2`` count those launches.

Widths.  Each kernel has a narrow form (W1 and W2 in shared memory: E and
H multiples of four, H <= 64, at 4 lanes F <= 160) and a wide one (a
template flag of the same kernel: any E and H up to ``MAX_WIDE``, channel
tiles of up to ``TILE_F_L2`` from :func:`channel_tiles` at both lane
counts).  The wide form keeps W1 and its tile's W2 columns in shared memory
for the block's life where they fit (resident), else stages them one hidden
chunk at a time through a two-stage ring (staged); bf16 weights are stored
as bf16, rounded once.  :func:`plan` picks the form, resident or staged, the
tiles and the senders a block from the shapes alone (no card), restating the
blocks' shared-memory sums (:func:`layout_bytes`, :func:`layout_bytes_l2`),
and raises, naming the limit, on what none takes.  Every shipped convolution
takes the narrow kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from .tensor_product import ChannelwiseTP, gather_senders
from .wigner import wigner_3j

K_PAD = 4         # output lanes per channel where every irrep has l <= 1
K_PAD_L2 = 8      # where an irrep has l = 2 (five components, padded to 8)
_J_MAX = 5        # harmonic components of one path in the kernel's tables
_SH_STRIDE = 12   # the kernel's padded harmonics row
TILE_N = 8        # receivers per block of the kernel
MAX_SENDERS = 96  # most senders one block takes
MIN_SENDERS = 4   # fewest, when the grid would otherwise leave SMs idle
MAX_F = 160       # widest edge-weight row (or channel tile) the kernel's register tiles hold
MAX_H = 64        # widest hidden layer whose weights a block keeps (and no wider than E)
MAX_PATHS = 16    # most tensor-product paths
MAX_WIDE = 192    # widest edge attributes and hidden layer of the wide kernels (ns <= 64)
ROWS = 32         # live edges per tile of the 4-lane kernel (narrow and wide)
WIDE_HC = 64      # hidden units of a wide kernel's chunk (resident f32, or staged at most)
SMEM = 227 * 1024  # shared memory a block may take
TARGET_BLOCKS = 2 * 132   # two blocks for each SM of an H100
# the 8-lane kernel (l <= 2)
TILE_N_L2 = 4         # receivers per block
MAX_SENDERS_L2 = 96   # most senders one block takes (a 96-point phore in one split)
MAX_F_L2 = 384        # widest edge-weight row
MAX_PATHS_L2 = 32
ROWS_L2 = 16          # live edges per tile
ROWS_L2_WIDE = {4: 16, 2: 32}   # live edges per tile of the wide kernel, f32 and bf16
TILE_F_L2 = 128       # widest channel tile of a block (two channels a lane, two lane groups)
SMEM_L2 = 113 * 1024  # shared memory a block may take so that two fit on an SM


class _Kernel:
    """Launch count of a kernel: one per accepted launch, nowhere else."""

    launches = 0


KERNEL = _Kernel()      # tp_fused_kernel, the 4-lane product
KERNEL_L2 = _Kernel()   # tp_fused_l2_kernel, the 8-lane product
KERNEL_IDX = _Kernel()      # tp_fused_kernel<T, NC, true>: the sender-index mode (l <= 1)
KERNEL_IDX_L2 = _Kernel()   # tp_fused_l2_kernel in the sender-index mode (l = 2)


def counter(dense: _Kernel, dense_l2: _Kernel, idx: _Kernel, idx_l2: _Kernel,
            sender_index: Optional[torch.Tensor], l2: bool) -> _Kernel:
    """The counter of the kernel a launch ran: by its mode (a sender index or
    none) and its lanes (``l2``: 8)."""
    if sender_index is None:
        return dense_l2 if l2 else dense
    return idx_l2 if l2 else idx


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def check_index(sender_index: torch.Tensor, shape: Tuple[int, int, int], device,
                what: str) -> None:
    """Raises unless ``sender_index`` is a contiguous int32 (B, N, K) tensor
    on ``device``: what the kernels' sender-index mode reads.  Its values
    must lie in [0, M_x) (not checked: that would wait for the card)."""
    if sender_index.dtype != torch.int32 or tuple(sender_index.shape) != tuple(shape):
        raise ValueError(f"{what}: sender_index must be int32 {tuple(shape)}, got "
                         f"{sender_index.dtype} {tuple(sender_index.shape)}")
    if sender_index.device != device or not sender_index.is_contiguous():
        raise ValueError(f"{what}: sender_index must be contiguous on {device}")


def sender_lists(sender_index: torch.Tensor, m_x: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of a sender index (B, N, K): ``order`` (B * N * K,) int32,
    the flat slots (b * N + n) * K + k sorted by their sender row b * m_x +
    sender_index[b, n, k] (a stable sort: ascending slots within a sender),
    and ``ptr`` (B * m_x + 1,) int32, each sender row's extent in
    ``order``.  The backward kernels add a sender's slots in this fixed
    order, so the sum needs no atomics and reruns agree to the bit."""
    B = sender_index.shape[0]
    rows = (sender_index.long()
            + m_x * torch.arange(B, device=sender_index.device)[:, None, None]).reshape(-1)
    order = torch.sort(rows, stable=True).indices.to(torch.int32)
    ptr = torch.zeros(B * m_x + 1, dtype=torch.int64, device=rows.device)
    ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=B * m_x), 0)
    return order, ptr.to(torch.int32)


def _check_tp(tp: ChannelwiseTP) -> None:
    if any(ir.l > 2 for _, ir in tp.irreps_in.items) or any(
            ir.l > 2 for _, ir in tp.irreps_out.items):
        raise ValueError("tp_fused supports l_in, l_out <= 2")


@functools.lru_cache(maxsize=None)
def lanes(tp: ChannelwiseTP) -> int:
    """Output lanes per channel: 4 where every input and output irrep has
    l <= 1 (the 4-lane kernels), else 8 (l = 2, the 8-lane ones)."""
    _check_tp(tp)
    l_max = max(ir.l for _, ir in tp.irreps_in.items + tp.irreps_out.items)
    return K_PAD if l_max <= 1 else K_PAD_L2


def edge_weights(attrs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 dtype: torch.dtype = torch.float32, drop=None) -> torch.Tensor:
    """The masked sum over edge channels of the edge MLP, channel by channel,
    every operation in ``dtype`` as the JAX package's convolution computes
    it: ``sum_c (drop(relu(attr_c W1 + b1)) W2 + b2) * mask_c`` ->
    (B, N, M, F) in ``dtype``.  Differentiable; ``drop`` is the dropout
    between the two layers (training mode)."""
    w1, b1, w2, b2 = (t.to(dtype) for t in (w1, b1, w2, b2))
    w = 0.0
    for a, m in zip(attrs, masks):
        h = torch.relu(a.to(dtype) @ w1 + b1)
        if drop is not None:
            h = drop(h)
        w = w + (h @ w2 + b2) * m.to(dtype)[..., None]
    return w


def padded_from_blocks(tp: ChannelwiseTP, blocks: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """``ChannelwiseTP.aggregate``'s blocks packed into (B, N, F, lanes(tp)):
    the inverse of :func:`blocks_from_padded`."""
    k_pad = lanes(tp)
    taken = [0] * len(blocks)
    pieces = []
    for p in tp.paths:                      # channel order = path order
        start = taken[p.i_out]
        taken[p.i_out] = start + p.mul_in
        part = blocks[p.i_out][..., start:start + p.mul_in, :]
        pieces.append(torch.nn.functional.pad(part, (0, k_pad - part.shape[-1])))
    return torch.cat(pieces, dim=-2)


def tp_aggregate_fused_plain(
    tp: ChannelwiseTP,
    x: torch.Tensor,
    sh: torch.Tensor,
    attrs: Sequence[torch.Tensor],
    masks: Sequence[torch.Tensor],
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    sender_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: all arithmetic in f32 for f32
    inputs; for bf16 inputs (x, sh and attrs) the JAX package's bf16
    convolution, :func:`edge_weights` in bf16 and ``tp.aggregate``.

    x (B, M, D_in); sh (B, N, M, S); attrs C x (B, N, M, E);
    masks C x (B, N, M); w1 (E, H), b1 (H,), w2 (H, F), b2 (F,).  With
    ``sender_index`` (B, N, K) the edge tensors' M is K and x is (B, M_x,
    D_in), slot k of receiver n reading sender row ``sender_index[b, n,
    k]``.  Returns (B, N, F, lanes(tp)) f32.
    """
    k_pad = lanes(tp)
    f32 = torch.float32
    if x.dtype == torch.bfloat16:
        w = edge_weights(attrs, masks, w1, b1, w2, b2, torch.bfloat16)
        return padded_from_blocks(tp, tp.aggregate(x, sh, w, sender_index))
    x, sh = x.to(f32), sh.to(f32)
    hsum, msum = 0.0, 0.0
    for a, m in zip(attrs, masks):
        m = m.to(f32)
        h = torch.relu(a.to(f32) @ w1.to(f32) + b1.to(f32))
        hsum = hsum + h * m[..., None]
        msum = msum + m
    w = hsum @ w2.to(f32) + msum[..., None] * b2.to(f32)      # (B, N, M, F)

    B, N = sh.shape[:2]
    out = torch.zeros((B, N, tp.weight_numel, k_pad), dtype=f32, device=x.device)
    in_slices, sh_slices = tp.irreps_in.slices(), tp.irreps_sh.slices()
    for p in tp.paths:
        d1, d2, d3 = 2 * p.l_in + 1, 2 * p.l_sh + 1, 2 * p.l_out + 1
        xb = x[..., in_slices[p.i_in]].reshape(x.shape[:2] + (p.mul_in, d1))
        cg = torch.as_tensor(p.alpha * wigner_3j(p.l_in, p.l_sh, p.l_out), dtype=f32,
                             device=x.device)
        z = torch.einsum("bmui,ijk->bmujk", xb, cg)          # node-level (f32)
        m = "bm"
        if sender_index is not None:
            z, m = gather_senders(z, sender_index), "bnm"    # (B, N, K, u, j, k)
        wb = w[..., p.w_slice[0]:p.w_slice[1]]               # (B, N, M, u)
        acc = 0.0
        for j in range(d2):
            ws = wb * sh[..., sh_slices[p.i_sh].start + j, None]
            acc = acc + torch.einsum(f"bnmu,{m}uk->bnuk", ws, z[..., j, :])
        out[:, :, p.w_slice[0]:p.w_slice[1], :d3] = acc
    return out


def coupling(p, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """alpha * cg of path ``p`` in f32, with cg rounded to ``dtype`` first
    (the JAX package rounds the coupling tensor to the operands' type)."""
    cg = wigner_3j(p.l_in, p.l_sh, p.l_out)
    if dtype != torch.float32:
        cg = torch.as_tensor(cg, dtype=dtype).double().numpy()
    return (p.alpha * cg).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(tp: ChannelwiseTP, dtype: torch.dtype = torch.float32
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Per channel (x_base, d_in, sh_off, path) int32 (F, 4), and per path
    alpha * cg (cg rounded to ``dtype``) zero-padded to (3, 5, 3) f32."""
    in_slices, sh_slices = tp.irreps_in.slices(), tp.irreps_sh.slices()
    chan = np.zeros((tp.weight_numel, 4), np.int32)
    gtab = np.zeros((len(tp.paths), 3, _J_MAX, 3), np.float32)
    for q, p in enumerate(tp.paths):
        d1 = 2 * p.l_in + 1
        sh_off = sh_slices[p.i_sh].start
        if sh_off + _J_MAX > _SH_STRIDE or 2 * p.l_sh + 1 > _J_MAX:
            raise ValueError("harmonics layout outside the kernel's table")
        cg = coupling(p, dtype)
        gtab[q, :cg.shape[0], :cg.shape[1], :cg.shape[2]] = cg
        for u in range(p.mul_in):
            chan[p.w_slice[0] + u] = (in_slices[p.i_in].start + u * d1, d1, sh_off, q)
    return chan, gtab


@functools.lru_cache(maxsize=None)
def _device_tables(tp: ChannelwiseTP, device: str, dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    chan, gtab = _tables(tp, dtype)
    return torch.as_tensor(chan, device=device), torch.as_tensor(gtab, device=device)


@functools.lru_cache(maxsize=None)
def tables_l2(tp: ChannelwiseTP, dtype: torch.dtype = torch.float32
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The 8-lane kernels' tables: per channel (x_base, d_in, d_out, path)
    int32 (F, 4); per path (sh_off, d_in, d_sh, d_out, t_off, f_start,
    f_count, 0) int32 (n_paths, 8); per path alpha * cg (cg rounded to
    ``dtype``) zero-padded to (5, 5, 5) f32; and the floats of an edge's
    harmonic half-product t, ``sum_p d_in * d_out`` (path p's t[i, k] =
    sum_j G_p[i, j, k] sh[sh_off + j] at t_off + i * d_out + k)."""
    in_slices, sh_slices = tp.irreps_in.slices(), tp.irreps_sh.slices()
    chan = np.zeros((tp.weight_numel, 4), np.int32)
    ptab = np.zeros((len(tp.paths), 8), np.int32)
    gtab = np.zeros((len(tp.paths), _J_MAX, _J_MAX, _J_MAX), np.float32)
    t_off = 0
    for q, p in enumerate(tp.paths):
        d1, d2, d3 = 2 * p.l_in + 1, 2 * p.l_sh + 1, 2 * p.l_out + 1
        sh_off = sh_slices[p.i_sh].start
        if sh_off + d2 > _SH_STRIDE or max(d1, d2, d3) > _J_MAX:
            raise ValueError("harmonics layout outside the kernel's table")
        gtab[q, :d1, :d2, :d3] = coupling(p, dtype)
        ptab[q] = (sh_off, d1, d2, d3, t_off, p.w_slice[0], p.mul_in, 0)
        t_off += d1 * d3
        for u in range(p.mul_in):
            chan[p.w_slice[0] + u] = (in_slices[p.i_in].start + u * d1, d1, d3, q)
    return chan, ptab, gtab, t_off


@functools.lru_cache(maxsize=None)
def device_tables_l2(tp: ChannelwiseTP, device: str, dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    chan, ptab, gtab, t_size = tables_l2(tp, dtype)
    return (torch.as_tensor(chan, device=device), torch.as_tensor(ptab, device=device),
            torch.as_tensor(gtab, device=device), t_size)


@functools.lru_cache(maxsize=None)
def channel_tiles(tp: ChannelwiseTP) -> Tuple[Tuple[int, int, int, int], ...]:
    """Channel tiles of at most ``TILE_F_L2`` channels: (first channel,
    channels, first path, paths) of each, cut at path boundaries, each
    filled with paths up to ``TILE_F_L2`` channels.  The 8-lane kernels' and
    the 4-lane wide kernel's: a block takes one tile, its W2 columns, t
    tables and coupling tensors only, and computes its product in 64-channel
    groups (so a tile of 120 wastes 8 columns, one of 90 would waste 38)."""
    width = TILE_F_L2
    if any(p.mul_in > width for p in tp.paths):
        raise ValueError(f"tp_fused: a path of more than {width} channels (the widest channel "
                         f"tile)")
    tiles, f0, p0 = [], 0, 0
    for q, p in enumerate(tp.paths):
        end = p.w_slice[1]
        if q + 1 == len(tp.paths) or tp.paths[q + 1].w_slice[1] - f0 > width:
            tiles.append((f0, end - f0, p0, q + 1 - p0))
            f0, p0 = end, q + 1
    return tuple(tiles)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def wide_weights(E: int, H: int, ftp: int, esize: int, staged: int) -> int:
    """Floats of shared memory the wide kernels' weights take
    (``wide_weights`` in csrc/tp_fused.cu): resident (``staged`` 0), W1 and
    the tile's ``ftp`` W2 columns whole; staged, two hidden chunks of
    ``staged`` units.  f32 weights keep their layout (W1 [pad4(E)][pad4(H)],
    W2 [pad4(H)][ftp]; a chunk W1 [pad4(E)][hc], W2 [hc][ftp]); bf16 ones are
    stored transposed as bf16 (W1^T [pad8(H)][pad16(E) + 8], W2^T
    [ftp][pad16(H) + 8]; a chunk W1^T [hc][pad16(E) + 8], W2^T [ftp][hc +
    8]), rows at a pitch the tensor cores' fragment loads read without bank
    conflicts."""
    hc = staged
    if esize == 4:
        if hc:
            return 2 * (_pad4(E) * hc + hc * ftp)
        return _pad4(E) * _pad4(H) + _pad4(H) * ftp
    q1 = _pad(E, 16) + 8
    if hc:
        return hc * q1 + ftp * (hc + 8)
    return (_pad(H, 8) * q1 + ftp * (_pad(H, 16) + 8)) // 2


def _hid_pitch(H: int, staged: int) -> int:
    """bf16 elements of a wide kernel's hidden row: a staged chunk's, or,
    with the weights resident, the whole hidden layer's."""
    return WIDE_HC + 8 if staged else _pad(H, 16) + 8


def _a_pitch(E: int, esize: int) -> int:
    """Elements a staged attribute row of the wide kernels takes: pad4(E)
    f32, pad16(E) + 8 bf16 (the tensor cores' conflict-free pitch)."""
    return _pad4(E) if esize == 4 else _pad(E, 16) + 8


def layout_bytes(C: int, E: int, H: int, D: int, n_paths: int, MS: int, NC: int, idx: bool,
                 wide: bool, tpaths: int = 0, esize: int = 4, staged: int = 0,
                 ftp: int = TILE_F_L2) -> int:
    """Bytes of shared memory a block of the 4-lane kernel takes
    (``make_layout`` in csrc/tp_fused.cu, summed as it sums them).  The wide
    kernel: its weights (:func:`wide_weights`, resident or ``staged`` in
    chunks of that many hidden units) at a channel tile pitch of ``ftp`` (64
    or 128), t of at most ``tpaths`` paths (its tile's), attribute rows in
    the operands' type (``esize``)."""
    hp = WIDE_HC
    if not wide:
        floats = (E * hp + hp + H * 32 * NC + 32 * NC + _pad4(n_paths * 45) + MAX_PATHS
                  + (2 * ROWS if idx else MS) * _pad4(D) + C * TILE_N * MS
                  + _pad4(TILE_N * MS // 2 + 1) + 12 + 2 * C * ROWS * E + ROWS * 32 * NC
                  + 2 * ROWS * _SH_STRIDE + ROWS * n_paths * 12)
        return 4 * floats
    rows = ROWS
    floats = (wide_weights(E, H, ftp, esize, staged) + _pad(H, hp) + ftp + _pad4(n_paths * 45)
              + MAX_PATHS + (2 * rows if idx else MS) * _pad4(D) + C * TILE_N * MS
              + _pad4(TILE_N * MS // 2 + 1) + 12
              + _pad4((2 * C * rows * _a_pitch(E, esize) * esize + 3) // 4) + rows * ftp
              + 2 * rows * _SH_STRIDE + rows * tpaths * 12
              + (rows * hp if esize == 4 else C * rows * _hid_pitch(H, staged) // 2))
    return 4 * floats


def layout_bytes_l2(C: int, E: int, H: int, DX: int, TS: int, GS: int, PC: int, MS: int,
                    FTP: int, esize: int, wide: bool, staged: int = 0) -> int:
    """Bytes of shared memory a block of the 8-lane kernel takes
    (``make_layout_l2``); the wide kernel as :func:`layout_bytes` says, on
    tiles of ``ROWS_L2_WIDE[esize]`` rows."""
    hp, kb = WIDE_HC, 72
    rows = ROWS_L2_WIDE[esize] if wide else ROWS_L2
    if wide:
        head = wide_weights(E, H, FTP, esize, staged) + _pad(H, hp)
        ep = _a_pitch(E, esize)
        hid = C * rows * _hid_pitch(H, staged) // 2 if esize == 2 else rows * hp
    else:
        head = E * hp + hp + (FTP * kb // 2 if esize == 2 else H * FTP)
        ep = E
        hid = C * rows * (kb // 2 if esize == 2 else hp)
    floats = (head + FTP + _pad4(GS) + _pad4(PC * 8) + _pad4(PC * 5) + _pad4(C * TILE_N_L2 * MS)
              + _pad4(TILE_N_L2 * MS) + 20 + 2 * rows
              + _pad4((2 * C * rows * ep * esize + 3) // 4) + 2 * rows * _SH_STRIDE
              + _pad4((2 * rows * DX * esize + 3) // 4) + hid + rows * FTP + _pad4(rows * TS))
    return 4 * floats


def narrow(E: int, H: int, F: int) -> bool:
    """True when the 4-lane kernel keeps the weights in shared memory (the
    narrow kernel, every shipped convolution): E and H multiples of four, H
    <= min(E, ``MAX_H``), F <= ``MAX_F``; else the wide kernel runs."""
    return E % 4 == 0 and H % 4 == 0 and 4 <= H <= min(E, MAX_H) and F <= MAX_F


def narrow_l2(E: int, H: int) -> bool:
    """The 8-lane kernel's counterpart of :func:`narrow` (its channel tiles
    take any F)."""
    return E % 4 == 0 and H % 4 == 0 and 4 <= H <= MAX_H and E >= 4


class Plan(NamedTuple):
    """A K1 launch: ``wide`` (the kernel that takes any E and H up to
    ``MAX_WIDE``), ``staged`` (0: the wide kernel's weights resident; else
    staged a chunk of that many hidden units at a time), the channel tiles
    ((first channel, channels) each), senders per block and splits, and the
    shared memory a block takes."""

    wide: bool
    staged: int
    tiles: Tuple[Tuple[int, int], ...]
    per_block: int
    splits: int
    smem: int


def _check_widths(tp: ChannelwiseTP, C: int, E: int, H: int) -> None:
    if C not in (1, 2):
        raise ValueError("tp_aggregate_fused: one or two edge channels")
    if not (1 <= E <= MAX_WIDE and 1 <= H <= MAX_WIDE):
        raise ValueError(f"tp_aggregate_fused: E = {E} and H = {H} must lie in [1, {MAX_WIDE}] "
                         f"(ns <= {MAX_WIDE // 3})")


def _senders(size, limit: int, most: int) -> List[int]:
    """The senders a block may take, most first, where ``size(ms)`` bytes fit
    ``limit``."""
    return [ms for ms in range(most, MIN_SENDERS - 1, -1) if size(ms) <= limit]


#: the wide kernels' weights, in order of preference: resident (0), else
#: staged in chunks of 64, 32, 16 or 8 hidden units (the f32 weights of the
#: widest convs, beside f32 tiles; 8 only where a 4-lane sender-index block
#: of two edge channels holds its senders' rows too)
WIDE_FORMS = (0, 64, 32, 16, 8)


def _wide_form(size, most: int) -> Tuple[int, List[int]]:
    """(staged, the senders a block may take) of the wide kernel: its weights
    resident where they fit beside a block's tiles, else staged in the
    widest chunks that fit; ``size(ms, staged)`` its bytes."""
    for staged in WIDE_FORMS:
        fits = _senders(lambda ms: size(ms, staged), SMEM, most)
        if fits:
            return staged, fits
    return WIDE_FORMS[-1], []


def wide_tile_pitch(tp: ChannelwiseTP) -> int:
    """Channels a wide block's edge-weight rows hold: 64 where every tile of
    :func:`channel_tiles` has at most 64, else 128."""
    return 64 if max(fc for _, fc, _, _ in channel_tiles(tp)) <= 64 else 128


def wide_layout_bytes(tp: ChannelwiseTP, C: int, E: int, H: int, esize: int, indexed: bool,
                      MS: int, staged: int) -> int:
    """Bytes of shared memory a block of the wide kernel takes on this
    product (either lane count) with ``MS`` senders a block, its weights
    resident (``staged`` 0) or staged in chunks of ``staged`` units."""
    if lanes(tp) == K_PAD_L2:
        *_, dims = tables_tiled_l2(tp)
        return layout_bytes_l2(C, E, H, *dims[:4], MS, dims[4], esize, True, staged)
    tpaths = max(pc for _, _, _, pc in channel_tiles(tp))
    return layout_bytes(C, E, H, tp.irreps_in.dim, len(tp.paths), MS, 0, indexed, True, tpaths,
                        esize, staged, wide_tile_pitch(tp))


@functools.lru_cache(maxsize=None)
def plan(tp: ChannelwiseTP, B: int, N: int, M: int, C: int, E: int, H: int, esize: int,
         indexed: bool) -> Plan:
    """The launch of :func:`tp_aggregate_fused` on these shapes, from the
    shapes alone (no card): raises where the kernels do not take them.  At
    4 lanes the narrow kernel where :func:`narrow` holds (one tile, the
    grid of :func:`plan_senders`), at 8 lanes where :func:`narrow_l2` holds
    and its block fits ``SMEM_L2`` (two blocks an SM); else the wide one on
    the channel tiles of :func:`channel_tiles`, its weights resident where
    they fit ``SMEM`` beside the block's tiles, else staged, with at most as
    many senders a block as its shared memory holds."""
    _check_widths(tp, C, E, H)
    F = tp.weight_numel
    if lanes(tp) == K_PAD_L2:
        if len(tp.paths) > MAX_PATHS_L2:
            raise ValueError(f"tp_aggregate_fused: at most {MAX_PATHS_L2} paths")
        *_, ctab, _, dims = tables_tiled_l2(tp)

        def size(ms: int, wide: bool, staged: int = 0) -> int:
            if wide:
                return wide_layout_bytes(tp, C, E, H, esize, indexed, ms, staged)
            return layout_bytes_l2(C, E, H, *dims[:4], ms, dims[4], esize, False)
        # the narrow kernel where its weights fit beside two blocks an SM, else the wide one
        wide, staged = False, 0
        fits = (_senders(lambda ms: size(ms, False), SMEM_L2, MAX_SENDERS_L2)
                if narrow_l2(E, H) else [])
        if not fits:
            wide = True
            staged, fits = _wide_form(lambda ms, st: size(ms, True, st), MAX_SENDERS_L2)
        if not fits:
            raise ValueError(f"tp_aggregate_fused: E = {E}, H = {H} and the channel tiles' sizes "
                             f"{dims} need more than the {SMEM} bytes of shared memory a block "
                             f"has")
        per_block, splits, _, _ = grid_l2(tp, B, N, M, fits[0])
        return Plan(wide, staged, tuple((int(r[0]), int(r[1])) for r in ctab), per_block,
                    splits, size(per_block, wide, staged))
    if len(tp.paths) > MAX_PATHS:
        raise ValueError(f"tp_aggregate_fused: at most {MAX_PATHS} paths")
    D = tp.irreps_in.dim
    if narrow(E, H, F):
        per_block, splits = plan_senders(B, N, M)
        smem = layout_bytes(C, E, H, D, len(tp.paths), per_block, max(2, -(-F // 32)),
                            indexed, False)
        if smem > SMEM:
            raise ValueError(f"tp_aggregate_fused: {smem} bytes of shared memory, more than "
                             f"the {SMEM} a block has")
        return Plan(False, 0, ((0, F),), per_block, splits, smem)
    tiles = channel_tiles(tp)

    def size4(ms: int, staged: int) -> int:
        return wide_layout_bytes(tp, C, E, H, esize, indexed, ms, staged)
    staged, fits = _wide_form(size4, MAX_SENDERS)
    if not fits:
        raise ValueError(f"tp_aggregate_fused: E = {E}, H = {H}, D = {D}: the wide kernel's "
                         f"block needs more than the {SMEM} bytes of shared memory it has")
    per_block, splits = plan_senders(B, N, M, TILE_N, fits[0], len(tiles))
    return Plan(True, staged, tuple((f0, fc) for f0, fc, _, _ in tiles), per_block, splits,
                size4(per_block, staged))


@functools.lru_cache(maxsize=None)
def tables_tiled_l2(tp: ChannelwiseTP, dtype: torch.dtype = torch.float32):
    """The 8-lane K1's tables, by channel tile (:func:`channel_tiles`): per
    channel (x offset from its tile's x_lo, d_in, d_out, path within the
    tile) int32 (F, 4); per path (sh_off, d_in, d_sh, d_out, t_off and g_off
    within its tile, 0, 0) int32 (n_paths, 8), each path's t block starting
    on a multiple of four floats; alpha * cg of every path (cg rounded to
    ``dtype``), its d_in x d_sh x d_out entries flat in path order (f32); per
    tile (f0, fc, p0, pc, x_lo, xw, g0, gs) int32 (tiles, 8): its channels,
    paths, the x elements [x_lo, x_lo + xw) its channels read (x_lo and xw
    multiples of four) and its coupling entries; the walk's order (F,)
    int32, each tile's channels sorted by (d_in, d_out), so that a warp of
    the walk mostly shares one loop shape; and the layout's sizes (DX, TS,
    GS, PC, FTP): the widest x slice, t row, coupling slice and path count
    of a tile, and the channel pitch (64 or 128)."""
    in_slices, sh_slices = tp.irreps_in.slices(), tp.irreps_sh.slices()
    tiles = channel_tiles(tp)
    chan = np.zeros((tp.weight_numel, 4), np.int32)
    ptab = np.zeros((len(tp.paths), 8), np.int32)
    ctab = np.zeros((len(tiles), 8), np.int32)
    walk = np.zeros(tp.weight_numel, np.int32)
    gflat, t_sizes = [], []
    for k, (f0, fc, p0, pc) in enumerate(tiles):
        paths = tp.paths[p0:p0 + pc]
        x_lo = min(in_slices[p.i_in].start for p in paths) // 4 * 4
        x_hi = max(in_slices[p.i_in].start + p.mul_in * (2 * p.l_in + 1) for p in paths)
        g0 = sum(len(g) for g in gflat)
        t_off = g_off = 0
        for q, p in enumerate(paths, start=p0):
            d1, d2, d3 = 2 * p.l_in + 1, 2 * p.l_sh + 1, 2 * p.l_out + 1
            sh_off = sh_slices[p.i_sh].start
            if sh_off + d2 > _SH_STRIDE or max(d1, d2, d3) > _J_MAX:
                raise ValueError("harmonics layout outside the kernel's table")
            ptab[q] = (sh_off, d1, d2, d3, t_off, g_off, 0, 0)
            gflat.append(coupling(p, dtype).reshape(-1))
            for u in range(p.mul_in):
                chan[p.w_slice[0] + u] = (in_slices[p.i_in].start + u * d1 - x_lo, d1, d3, q - p0)
            t_off += -(-d1 * d3 // 4) * 4
            g_off += d1 * d2 * d3
        ctab[k] = (f0, fc, p0, pc, x_lo, -(-(x_hi - x_lo) // 4) * 4, g0, g_off)
        walk[f0:f0 + fc] = f0 + np.argsort(chan[f0:f0 + fc, 1] * 8 + chan[f0:f0 + fc, 2],
                                           kind="stable")
        t_sizes.append(t_off)
    dims = (int(ctab[:, 5].max()), max(t_sizes), int(ctab[:, 7].max()), int(ctab[:, 3].max()),
            64 if ctab[:, 1].max() <= 64 else 128)
    return chan, ptab, np.concatenate(gflat).astype(np.float32), ctab, walk, dims


@functools.lru_cache(maxsize=None)
def _device_ctab(tp: ChannelwiseTP, device: str) -> torch.Tensor:
    """The 4-lane wide kernel's channel tiles, (first channel, width, first
    path, paths) int32."""
    return torch.as_tensor(np.array(channel_tiles(tp), np.int32), device=device)


@functools.lru_cache(maxsize=None)
def _device_tables_tiled_l2(tp: ChannelwiseTP, device: str, dtype: torch.dtype):
    *tables, dims = tables_tiled_l2(tp, dtype)
    return tuple(torch.as_tensor(t, device=device) for t in tables) + (dims,)


def grid_l2(tp: ChannelwiseTP, B: int, N: int, M: int, max_senders: int = MAX_SENDERS_L2
            ) -> Tuple[int, int, int, int]:
    """(senders per block, sender splits, channel tiles, blocks) of an
    8-lane K1 launch on (B, N, M), at most ``max_senders`` senders a block
    (:func:`plan`: as many as its shared memory holds)."""
    tiles = len(channel_tiles(tp))
    per_block, splits = plan_senders(B, N, M, TILE_N_L2, max_senders, tiles)
    return per_block, splits, tiles, B * -(-N // TILE_N_L2) * splits * tiles


@functools.lru_cache(maxsize=None)
def plan_senders(B: int, N: int, M: int, tile_n: int = TILE_N,
                 max_senders: int = MAX_SENDERS, channel_tiles: int = 1) -> Tuple[int, int]:
    """(senders per block, sender splits) of a launch on (B, N, M).

    A block takes one batch row, ``tile_n`` receivers, one of
    ``channel_tiles`` tiles of the channels and every ``splits``-th sender.
    It takes as many as the kernel allows (``max_senders``) unless that
    leaves fewer than ``TARGET_BLOCKS`` blocks; then fewer, down to
    ``MIN_SENDERS``, and the partial sums of the splits are added by a second
    kernel.  One split needs no scratch buffer.
    The 4-lane kernel takes ``TILE_N`` and ``MAX_SENDERS``, the 8-lane one
    ``TILE_N_L2`` and ``MAX_SENDERS_L2``.
    """
    tiles = B * -(-N // tile_n) * channel_tiles
    splits_wanted = -(-TARGET_BLOCKS // tiles)
    per_block = min(M, max_senders, max(MIN_SENDERS, M // splits_wanted))
    return per_block, -(-M // per_block)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("tp_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dp_tp_fused.argtypes = [p] * 16 + [i] * 18 + [p]
    lib.dp_tp_fused.restype = i
    lib.dp_tp_fused_smem.argtypes = [i] * 12
    lib.dp_tp_fused_smem.restype = i
    lib.dp_tp_fused_l2.argtypes = [p] * 18 + [i] * 21 + [p]
    lib.dp_tp_fused_l2.restype = i
    lib.dp_tp_fused_l2_smem.argtypes = [i] * 12
    lib.dp_tp_fused_l2_smem.restype = i
    lib.dp_cuda_error_string.argtypes = [i]
    lib.dp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tp_aggregate_fused(
    tp: ChannelwiseTP,
    x: torch.Tensor,
    sh: torch.Tensor,
    attrs: Sequence[torch.Tensor],
    masks: Sequence[torch.Tensor],
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    sender_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused edge MLP + aggregate -> (B, N, F, lanes(tp)) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  x, sh and attrs share one dtype, f32 or bf16 (then the kernel
    rounds where :func:`tp_aggregate_fused_plain` does); the MLP parameters
    are f32; masks are all bool or all f32 and are read as they come.  A
    launch is the main kernel and, when the senders are split across
    blocks (:func:`plan_senders`), a second one that adds the splits' partial
    sums in order; it counts once.  The kernel has no
    backward: with grad mode on and an input that requires grad it raises
    (training goes through ``ops.tp_aggregate``); the plain version on CPU
    tensors stays differentiable.  ``sender_index`` (B, N, K) int32: the
    sender-index mode (module note), x (B, M_x, D) and the edge tensors'
    M = K.
    """
    if x.device.type == "cpu":
        return tp_aggregate_fused_plain(tp, x, sh, attrs, masks, w1, b1, w2, b2, sender_index)
    if x.device.type != "cuda":
        raise ValueError(f"tp_aggregate_fused: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, sh, *attrs, w1, b1, w2, b2]):
        raise RuntimeError(
            "tp_aggregate_fused has no backward: call it under torch.no_grad(), or put the "
            "model in training mode so the convolution runs ops.tp_aggregate")
    dev = x.device
    B, N, M, S = sh.shape
    D = x.shape[-1]
    C = len(attrs)
    E, H = w1.shape
    F = tp.weight_numel
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tp_aggregate_fused: inputs must be f32 or bf16, got {dt}")
    if C not in (1, 2) or len(masks) != C:
        raise ValueError("tp_aggregate_fused: one or two edge channels")
    m_x = M if sender_index is None else x.shape[1]
    if tuple(x.shape) != (B, m_x, tp.irreps_in.dim) or S != tp.irreps_sh.dim:
        raise ValueError(f"tp_aggregate_fused: x {tuple(x.shape)} / sh {tuple(sh.shape)} "
                         f"do not match {tp.irreps_in!r} x {tp.irreps_sh!r}")
    for t in list(attrs) + list(masks) + [x, sh, w1, b1, w2, b2]:
        if t.device != dev:
            raise ValueError("tp_aggregate_fused: all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("tp_aggregate_fused: tensors must be contiguous")
    for a in attrs:
        if tuple(a.shape) != (B, N, M, E) or a.dtype != dt:
            raise ValueError(f"tp_aggregate_fused: attr {tuple(a.shape)} {a.dtype}, "
                             f"expected {(B, N, M, E)} {dt}")
    if sh.dtype != dt:
        raise TypeError("tp_aggregate_fused: x and sh dtypes differ")
    for m in masks:
        if tuple(m.shape) != (B, N, M):
            raise ValueError(f"tp_aggregate_fused: mask {tuple(m.shape)}, expected {(B, N, M)}")
        if m.dtype != masks[0].dtype or m.dtype not in (torch.bool, torch.float32):
            raise TypeError("tp_aggregate_fused: masks must all be bool or all be f32")
    if (tuple(b1.shape), tuple(w2.shape), tuple(b2.shape)) != ((H,), (H, F), (F,)):
        raise ValueError("tp_aggregate_fused: edge-MLP parameter shapes")
    if any(t.dtype != torch.float32 for t in (w1, b1, w2, b2)):
        raise TypeError("tp_aggregate_fused: edge-MLP parameters must be f32")
    if sender_index is not None:
        check_index(sender_index, (B, N, M), dev, "tp_aggregate_fused")
    pl = plan(tp, B, N, M, C, E, H, x.element_size(), sender_index is not None)
    return _launch_planned(tp, x, sh, attrs, masks, w1, b1, w2, b2, pl, sender_index)


def _launch_planned(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
                   attrs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                   w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   pl: Plan, sender_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on inputs :func:`tp_aggregate_fused` has checked, on the
    launch ``pl`` (:func:`plan`'s, or another form of it that the card
    tests choose: the staged weights where the resident ones fit)."""
    E = w1.shape[0]
    aligned = [] if pl.wide and E % 4 else list(attrs)   # rows the kernels copy in 16 bytes
    if any(t.data_ptr() % 16 for t in aligned + [w1, w2]):
        raise ValueError("tp_aggregate_fused: attrs (where E is a multiple of four), w1 and w2 "
                         "must be 16-byte aligned")
    if lanes(tp) == K_PAD_L2:
        return _launch_l2(tp, x, sh, attrs, masks, w1, b1, w2, b2, pl, sender_index)

    dev = x.device
    B, N, M, S = sh.shape
    D = x.shape[-1]
    C = len(attrs)
    H = w1.shape[1]
    F = tp.weight_numel
    dt = x.dtype
    chan, gtab = _device_tables(tp, str(dev), dt)
    ctab = _device_ctab(tp, str(dev)) if pl.wide else None
    out = torch.empty((B, N, F, K_PAD), dtype=torch.float32, device=dev)
    part = (torch.empty((pl.splits, B, N, F, K_PAD), dtype=torch.float32, device=dev)
            if pl.splits > 1 else None)
    lib = _library()
    rc = lib.dp_tp_fused(
        x.data_ptr(), sh.data_ptr(), attrs[0].data_ptr(), attrs[-1].data_ptr(),
        masks[0].data_ptr(), masks[-1].data_ptr(),
        _ptr(sender_index),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), chan.data_ptr(),
        gtab.data_ptr(), _ptr(ctab), out.data_ptr(), _ptr(part),
        B, N, M, x.shape[1], D, S, C, E, H, F, gtab.shape[0], pl.per_block,
        int(masks[0].dtype == torch.float32), len(pl.tiles),
        max(pc for _, _, _, pc in channel_tiles(tp)) if pl.wide else 1,
        wide_tile_pitch(tp) if pl.wide else 0, pl.staged, int(dt == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tp_fused launch failed: {lib.dp_cuda_error_string(rc).decode()}")
    counter(KERNEL, KERNEL_L2, KERNEL_IDX, KERNEL_IDX_L2, sender_index, False).launches += 1
    return out


def _launch_l2(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
               attrs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
               w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
               pl: Plan, sender_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``tp_fused_l2_kernel`` on inputs :func:`tp_aggregate_fused` has
    checked, on :func:`plan`'s launch: the 8-lane product, dense or in the
    sender-index mode, one block a (batch row, receiver tile, sender split,
    channel tile)."""
    dev = x.device
    B, N, M, S = sh.shape
    E, H = w1.shape
    F = tp.weight_numel
    chan, ptab, gflat, ctab, walk, dims = _device_tables_tiled_l2(tp, str(dev), x.dtype)
    per_block, splits, n_ct = pl.per_block, pl.splits, len(pl.tiles)
    lib = _library()
    out = torch.empty((B, N, F, K_PAD_L2), dtype=torch.float32, device=dev)
    part = (torch.empty((splits, B, N, F, K_PAD_L2), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    rc = lib.dp_tp_fused_l2(
        x.data_ptr(), sh.data_ptr(), attrs[0].data_ptr(), attrs[-1].data_ptr(),
        masks[0].data_ptr(), masks[-1].data_ptr(), _ptr(sender_index),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), chan.data_ptr(),
        ptab.data_ptr(), gflat.data_ptr(), ctab.data_ptr(), walk.data_ptr(), out.data_ptr(),
        _ptr(part),
        B, N, M, x.shape[1], x.shape[-1], S, len(attrs), E, H, F, n_ct, *dims, per_block,
        int(masks[0].dtype == torch.float32), int(pl.wide), pl.staged,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tp_fused_l2 launch failed: {lib.dp_cuda_error_string(rc).decode()}")
    counter(KERNEL, KERNEL_L2, KERNEL_IDX, KERNEL_IDX_L2, sender_index, True).launches += 1
    return out


def blocks_from_padded(tp: ChannelwiseTP, padded: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """Split the (B, N, F, lanes) output into per-irrep blocks aligned with
    ``ChannelwiseTP.aggregate``'s return value."""
    out: List[Optional[torch.Tensor]] = [None] * len(tp.irreps_out.items)
    for k_blk, (mul, ir) in enumerate(tp.irreps_out.items):
        parts = [padded[..., p.w_slice[0]:p.w_slice[1], :ir.dim]
                 for p in tp.paths if p.i_out == k_blk]
        if parts:
            out[k_blk] = torch.cat(parts, dim=-2)
    return out
