"""The host-side plans and tables of the redesigned kernels, on the CPU.

K3's sender-index dx cuts each sender's slots (``tp_fused.sender_lists``) into
chunks (``tp_scalar.slot_chunks``) and adds the chunks' sums in order; the
8-lane K1 splits the channels into tiles at path boundaries
(``tp_fused.channel_tiles``) and reads its tables by tile
(``tp_fused.tables_tiled_l2``); the dense 8-lane K2 forward and dx read the
same tiles, dx through per-tile lists (``tp_aggregate.dx_lists_l2``), and
split the summed axis (``tp_aggregate.plan_splits_l2``).  The CUDA kernels run only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold them there); here the plans
are checked for coverage and grid size, and a plain emulation of each
kernel's arithmetic in the kernel's order, read from the same tables, is held
against the port's plain version and the JAX package's aggregate on the same
numpy-seeded inputs: f32 to 1e-5 of the result's scale (the sides differ by
summation order, as in tests/test_torch_knn.py).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_kernel_layouts as layouts
from torch_kernel_layouts import pad4
from diffphore_torch.ops import tp_aggregate, tp_fused, tp_scalar
from diffphore_torch.ops.tensor_product import channelwise_tp
from diffphore_tpu.ops import tensor_product as jtp

torch.set_num_threads(2)

TOL = 1e-5                 # of a result's scale, f32
SH = "1x0e + 1x1o + 1x2e"
SEQ = ["20x0e", "20x0e + 10x1o", "20x0e + 10x1o + 10x1e", "20x0e + 10x1o + 10x1e + 20x0o"]
SEQ2 = ["20x0e", "20x0e + 10x1o + 10x2e", "20x0e + 10x1o + 10x2e + 10x1e + 10x2o",
        "20x0e + 10x1o + 10x2e + 10x1e + 10x2o + 20x0o"]
#: (in irreps, sh irreps, out irreps, E = H) of the second-order model's convs
#: at corpus2's width (runs/second_order_probe)
SIGNATURES_L2 = {
    "layer0": (SEQ2[0], SH, SEQ2[1], 60),
    "layer1": (SEQ2[1], SH, SEQ2[2], 60),
    "layer2": (SEQ2[2], SH, SEQ2[3], 60),
    "layer3": (SEQ2[3], SH, SEQ2[3], 60),
    "final_conv": (SEQ2[3], SH, "2x1o + 2x1e", 40),
    "tor_bond_conv": (SEQ2[3], "1x1o + 1x0e + 1x1e", "20x0o + 20x0e", 60),
}
#: (signature, N, M, edge channels) of the 23 conv calls of one second-order
#: forward on a 24 x 96 x 8 complex; rows None: the batch's (40 poses to
#: serve, 24 for the calibrated step's frozen forward), 1: once per complex
PROBE_CALLS = (
    [(f"layer{i}", 24, 24, 2, None) for i in range(4)]
    + [(f"layer{i}", 24, 96, 1, None) for i in range(4) for _ in range(2)]
    + [("layer0", 96, 96, 1, 1), ("layer1", 96, 96, 1, None), ("layer2", 96, 96, 1, None)]
    + [(f"layer{i}", 96, 24, 1, None) for i in range(3) for _ in range(2)]
    + [("final_conv", 1, 24, 1, None), ("tor_bond_conv", 8, 24, 1, None)])
H100_SMS = 132
#: block slots of the dx chunk kernel on an H100 at 240 threads a block and
#: few registers: eight blocks an SM
DX_RESIDENT = 8 * H100_SMS
T = lambda a: torch.from_numpy(np.asarray(a).copy())


def knn_index(rng, B, P, K):
    """(index (B, P, K) int32, live (B, P)): each row's phore points at
    random positions, the first 30-60 live, every receiver's K nearest live
    points in order of distance (ties to the lower index), as the KNN grid
    selects them."""
    pos = rng.random((B, P, 3)) * 20.0
    live = np.arange(P)[None, :] < rng.integers(30, 61, (B, 1))
    d = np.linalg.norm(pos[:, :, None] - pos[:, None, :], axis=-1)
    d = np.where(live[:, None, :], d, np.inf)
    return np.argsort(d, axis=-1, kind="stable")[..., :K].astype(np.int32), live


# ---- K3: the sender-index dx's slot chunks


@pytest.mark.parametrize("B,N,K,Mx,named,Q", [
    (1, 9, 4, 7, 7, 3),        # every sender named
    (3, 7, 5, 9, 4, 8),        # senders 4-8 of each row unnamed, B > 1
    (2, 13, 6, 20, 2, 4),      # two senders take every slot: long lists
    (4, 5, 3, 6, 6, 1),        # one slot a chunk
])
def test_slot_chunks_cover_every_slot_once_in_order(B, N, K, Mx, named, Q):
    """Each sender's chunks are consecutive, hold at most Q of its slots and
    together exactly its slots in ``order``'s order; a sender no slot names
    has no chunk; chunks past the last are empty and end at the slot count;
    the plan's bound holds them all."""
    rng = np.random.default_rng(B * 100 + N)
    idx = T(rng.integers(0, named, (B, N, K)).astype(np.int32))
    order, ptr = tp_fused.sender_lists(idx, Mx)
    _, bound = tp_scalar.plan_slot_chunk(B * N * K, B * Mx, 40, 1)
    bound = max(bound, B * N * K // Q + min(B * Mx, B * N * K))
    cuts, row_ptr = tp_scalar.slot_chunks(ptr, Q, bound)
    assert cuts.dtype == row_ptr.dtype == torch.int32
    assert cuts.shape == (bound + 1,) and row_ptr.shape == (B * Mx + 1,)
    cuts, row_ptr, ptr = cuts.long(), row_ptr.long(), ptr.long()
    chunks = int(row_ptr[-1])
    assert chunks <= bound and int(cuts[0]) == 0
    assert bool((cuts[1:] >= cuts[:-1]).all())
    assert bool((cuts[chunks:] == B * N * K).all())          # the tail: empty chunks
    for r in range(B * Mx):
        lo, hi = int(row_ptr[r]), int(row_ptr[r + 1])
        count = int(ptr[r + 1] - ptr[r])
        assert hi - lo == -(-count // Q), r
        if count:
            assert int(cuts[lo]) == int(ptr[r]) and int(cuts[hi]) == int(ptr[r + 1]), r
        sizes = (cuts[lo + 1:hi + 1] - cuts[lo:hi]).tolist()
        assert all(0 < s <= Q for s in sizes), r
    walked = torch.cat([order[int(cuts[i]):int(cuts[i + 1])] for i in range(chunks)])
    assert torch.equal(walked, order)                         # every slot once, in order


@pytest.mark.parametrize("lanes,seq", [(4, SEQ), (8, SEQ2)])
def test_slot_chunk_plan_fills_the_card_on_the_knn_step(lanes, seq):
    """Phase 17's training shapes (24 rows, 96 phore points, K = 24, the
    layer-0 phore conv): on an index of nearest live points, where the
    slots a sender holds run from none to dozens, the chunks give at least
    one block for each slot the card holds, with at least MIN_SLOTS slots
    a chunk."""
    tp = channelwise_tp(seq[0], SH, seq[1])
    assert tp_fused.lanes(tp) == lanes
    B, P, K = 24, 96, 24
    idx, _ = knn_index(np.random.default_rng(3), B, P, K)
    order, ptr = tp_fused.sender_lists(T(idx), P)
    counts = (ptr[1:] - ptr[:-1]).numpy()
    assert counts.max() >= 3 * K and (counts == 0).sum() >= B * 30    # uneven loads
    F = tp.weight_numel
    Q, bound = tp_scalar.plan_slot_chunk(B * P * K, B * P, F, DX_RESIDENT)
    cuts, row_ptr = tp_scalar.slot_chunks(ptr, Q, bound)
    chunks = int(row_ptr[-1])
    assert Q >= tp_scalar.MIN_SLOTS
    assert -(-chunks // tp_scalar.keep_of(F)) >= DX_RESIDENT
    assert chunks <= bound


def _chunked_dx(tp, sh, w, g, idx, m_x, Q):
    """K3's sender-index dx in the kernels' order, in plain PyTorch: per
    (chunk, channel) an f32 chain over the chunk's slots in ``order``'s
    order, w * sum_k sh g; per sender its chunks added in order; times c_p;
    the channels reading an element added in d_item order."""
    chan, scale, d_ptr, d_item = tp_scalar._conv_tables(tp, torch.float32)
    B, N, K, S = sh.shape
    F, D = tp.weight_numel, tp.irreps_in.dim
    order, ptr = tp_fused.sender_lists(idx, m_x)
    _, bound = tp_scalar.plan_slot_chunk(B * N * K, B * m_x, F)
    cuts, row_ptr = tp_scalar.slot_chunks(ptr, Q, max(bound, B * N * K // Q + B * m_x))
    shf, wf = sh.reshape(-1, S), w.reshape(-1, F)
    gf = g.reshape(B * N, F, -1)
    part = torch.zeros((int(row_ptr[-1]), F))
    for it in range(part.shape[0]):
        for e in order[int(cuts[it]):int(cuts[it + 1])].tolist():
            t = torch.zeros(F)
            for k in range(min(5, gf.shape[-1])):
                on = torch.from_numpy(chan[:, 2] > k)
                comp = torch.from_numpy(np.minimum(chan[:, 1] + k, S - 1))
                t = t + torch.where(on, shf[e, comp] * gf[e // K, :, k], torch.zeros(F))
            part[it] = part[it] + wf[e] * t
    dx = torch.zeros((B * m_x, D))
    for r in range(B * m_x):
        s = part[int(row_ptr[r]):int(row_ptr[r + 1])].sum(0)
        for d in range(D):
            for f in d_item[d_ptr[d]:d_ptr[d + 1]]:
                dx[r, d] += s[f] * float(scale[f])
    return dx.reshape(B, m_x, D)


@pytest.mark.parametrize("lanes,seq", [(4, SEQ), (8, SEQ2)])
@pytest.mark.parametrize("Q", [2, 5])
def test_chunked_dx_matches_the_plain_and_jax_dx(lanes, seq, Q):
    """The chunked, fixed-order dx (4 and 8 lanes, chunks of 2 and 5 slots,
    senders with no slot and senders with many) against the gradient in x
    of ``scalar_paths_aggregate_plain`` and of the JAX package's gathered
    aggregate: to 1e-5 of dx's scale."""
    tp = channelwise_tp(seq[0], SH, seq[1])
    assert tp_fused.lanes(tp) == lanes and tp_scalar.all_scalar_paths(tp)
    rng = np.random.default_rng(Q)
    B, N, K, Mx = 2, 11, 4, 9
    F, D = tp.weight_numel, tp.irreps_in.dim
    idx = np.minimum(rng.integers(0, Mx, (B, N, K)), rng.integers(0, Mx, (B, N, K)))
    idx[:, :, 0] = 1                                    # sender 1 in every row's first slot
    idx = idx.astype(np.int32)
    x = rng.normal(size=(B, Mx, D)).astype(np.float32)
    sh = rng.normal(size=(B, N, K, 9)).astype(np.float32)
    live = rng.integers(1, K + 1, (B, N, 1)) > np.arange(K)
    w = (rng.normal(size=(B, N, K, F)) * live[..., None]).astype(np.float32)
    g = rng.normal(size=(B, N, F, lanes)).astype(np.float32)
    mask = np.zeros_like(g)
    for p in tp.paths:
        mask[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    g = g * mask
    assert (np.bincount((idx + Mx * np.arange(B)[:, None, None]).ravel(),
                        minlength=B * Mx) == 0).any()
    got = _chunked_dx(tp, T(sh), T(w), T(g), T(idx), Mx, Q)

    xl = T(x).requires_grad_(True)
    out = tp_scalar.scalar_paths_aggregate_plain(tp, xl, T(sh), T(w), sender_index=T(idx))
    (want,) = torch.autograd.grad((out * T(g)).sum(), [xl])
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale

    jt = jtp.channelwise_tp(seq[0], SH, seq[1])
    bidx = np.arange(B)[:, None, None]

    def loss(x_):
        blocks = jt.aggregate(x_[bidx, idx], jnp.asarray(sh), jnp.asarray(w))
        return (_jax_padded(tp, blocks, lanes) * g).sum()

    jdx = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    assert float(np.abs(got.numpy() - jdx).max()) <= TOL * float(np.abs(jdx).max())


def _jax_padded(tp, blocks, lanes):
    """The JAX package's per-irrep blocks in the port's (B, N, F, lanes)
    layout (``tp_fused.padded_from_blocks`` in jnp)."""
    taken = [0] * len(blocks)
    pieces = []
    for p in tp.paths:
        start = taken[p.i_out]
        taken[p.i_out] = start + p.mul_in
        part = blocks[p.i_out][..., start:start + p.mul_in, :]
        pieces.append(jnp.pad(part, ((0, 0),) * 3 + ((0, lanes - part.shape[-1]),)))
    return jnp.concatenate(pieces, axis=-2)


# ---- the 8-lane K1: channel tiles, tables by tile, grid


def smem_l2(C, E, H, dims, MS, esize):
    """Bytes of the 8-lane kernel's shared memory, summed as its layout
    (``make_layout_l2`` in csrc/tp_fused.cu) sums them: each piece padded to
    four floats; in bf16 W2^T and the hidden rows at a pitch of 72 bf16.
    The card's own count, ``dp_tp_fused_l2_smem``, is held to the same budget
    in tests/test_torch_cuda.py."""
    DX, TS, GS, PC, FTP = dims
    p4 = lambda n: -(-n // 4) * 4
    bf16, rows, tn = esize == 2, tp_fused.ROWS_L2, tp_fused.TILE_N_L2
    floats = (E * 64 + 64 + (FTP * 36 if bf16 else H * FTP) + FTP + p4(GS) + p4(PC * 8)
              + p4(PC * 5) + p4(C * tn * MS) + p4(tn * MS) + 20 + 2 * rows
              + p4(-(-2 * C * rows * E * esize // 4)) + 2 * rows * 12
              + p4(-(-2 * rows * DX * esize // 4)) + C * rows * (36 if bf16 else 64)
              + rows * FTP + p4(rows * TS))
    return 4 * floats


@pytest.mark.parametrize("sig", list(SIGNATURES_L2))
def test_channel_tiles_cover_every_channel_at_path_boundaries(sig):
    """Each tile starts and ends on a path boundary, is at most TILE_F_L2
    wide, and the tiles cover the channels once, in order; their tables fit
    two blocks an SM (SMEM_L2) at one and two edge channels, f32 and bf16,
    with MAX_SENDERS_L2 senders a block."""
    irr_in, irr_sh, irr_out, E = SIGNATURES_L2[sig]
    tp = channelwise_tp(irr_in, irr_sh, irr_out)
    tiles = tp_fused.channel_tiles(tp)
    starts = {p.w_slice[0] for p in tp.paths} | {tp.weight_numel}
    f, p = 0, 0
    for f0, fc, p0, pc in tiles:
        assert (f0, p0) == (f, p) and 0 < fc <= tp_fused.TILE_F_L2
        assert f0 in starts and f0 + fc in starts
        assert tp.paths[p0].w_slice[0] == f0 and tp.paths[p0 + pc - 1].w_slice[1] == f0 + fc
        f, p = f0 + fc, p0 + pc
    assert (f, p) == (tp.weight_numel, len(tp.paths))
    assert len(tiles) <= -(-tp.weight_numel // tp_fused.TILE_F_L2) + 1
    chan, ptab, _, ctab, walk, dims = tp_fused.tables_tiled_l2(tp)
    assert (ctab[:, 4] % 4 == 0).all() and (ctab[:, 5] % 4 == 0).all()
    assert (ptab[:, 4] % 4 == 0).all() and dims[1] % 4 == 0      # t blocks on float4s
    for f0, fc, *_ in ctab.tolist():                  # the walk: the tile's channels by shape
        order = walk[f0:f0 + fc]
        assert sorted(order.tolist()) == list(range(f0, f0 + fc))
        shape = chan[order, 1] * 8 + chan[order, 2]
        assert (np.diff(shape) >= 0).all()
    assert (ctab[:, 4] + ctab[:, 5] <= tp.irreps_in.dim).all()
    for C in (1, 2):
        for esize in (4, 2):
            assert smem_l2(C, E, E, dims, tp_fused.MAX_SENDERS_L2, esize) <= tp_fused.SMEM_L2


@pytest.mark.parametrize("rows", [40, 24])
def test_k1_l2_grid_fills_the_card_on_the_probe_shapes(rows):
    """The 23 conv calls of one second-order forward, serving 40 poses of a
    24 x 96 x 8 complex or the calibrated step's 24 rows: every launch has at
    least two blocks for each SM of an H100 (two fit on one)."""
    for sig, N, M, _, b in PROBE_CALLS:
        irr_in, irr_sh, irr_out, _ = SIGNATURES_L2[sig]
        tp = channelwise_tp(irr_in, irr_sh, irr_out)
        per_block, splits, n_ct, blocks = tp_fused.grid_l2(tp, b or rows, N, M)
        assert blocks >= 2 * H100_SMS, (sig, N, M)
        assert per_block <= tp_fused.MAX_SENDERS_L2 and splits * per_block >= M
        assert n_ct == len(tp_fused.channel_tiles(tp))
    # the sender-index mode: the phore convs at K = 24
    for sig in ("layer0", "layer1", "layer2"):
        tp = channelwise_tp(*SIGNATURES_L2[sig][:3])
        assert tp_fused.grid_l2(tp, rows, 96, 24)[3] >= 2 * H100_SMS


def _tiled_k1(tp, x, sh, attrs, masks, w1, b1, w2, b2, idx=None):
    """The 8-lane K1's f32 arithmetic read from ``tables_tiled_l2`` as the
    kernel reads it, in plain PyTorch: per channel tile the t rows (t_off +
    i d_out + k of each tile path from its coupling entries at g_off), the
    tile's x slice from x_lo, each channel's x offset and path; the edge
    weights hid W2 + msum b2 with hid = sum_c mask_c relu(attr_c W1 + b1)."""
    chan, ptab, gflat, ctab, _, dims = tp_fused.tables_tiled_l2(tp)
    B, N, M, _ = sh.shape
    hid, msum = 0.0, 0.0
    for a, m in zip(attrs, masks):
        hid = hid + m.float()[..., None] * torch.relu(a @ w1 + b1)
        msum = msum + m.float()
    w = hid @ w2 + msum[..., None] * b2
    xs = (x[torch.arange(B)[:, None, None], idx.long()] if idx is not None
          else x[:, None].expand(B, N, M, x.shape[-1]))
    out = torch.zeros((B, N, tp.weight_numel, 8))
    for f0, fc, p0, pc, x_lo, xw, g0, _ in ctab.tolist():
        t = torch.zeros((B, N, M, dims[1]))
        for q in range(p0, p0 + pc):
            sh_off, d1, d2, d3, t_off, g_off = ptab[q, :6].tolist()
            G = torch.from_numpy(gflat[g0 + g_off:g0 + g_off + d1 * d2 * d3].reshape(d1, d2, d3))
            t[..., t_off:t_off + d1 * d3] = torch.einsum(
                "ijk,bnmj->bnmik", G, sh[..., sh_off:sh_off + d2]).reshape(B, N, M, d1 * d3)
        xt = xs[..., x_lo:x_lo + xw]
        for f in range(f0, f0 + fc):
            xo, d1, d3, pl = chan[f].tolist()
            t_off = int(ptab[p0 + pl, 4])
            for i in range(d1):
                gi = w[..., f] * xt[..., xo + i]
                out[:, :, f, :d3] += torch.einsum("bnm,bnmk->bnk", gi,
                                                  t[..., t_off + i * d3:t_off + (i + 1) * d3])
    return out


@pytest.mark.parametrize("sig,indexed", [("layer1", False), ("layer3", False),
                                         ("final_conv", False), ("tor_bond_conv", False),
                                         ("layer2", True)])
def test_tiled_tables_reproduce_the_plain_and_jax_aggregate(sig, indexed):
    """The 8-lane K1's tiled tables, read as the kernel reads them (f32),
    against ``tp_aggregate_fused_plain`` and the JAX package's aggregate
    (``ChannelwiseTP.aggregate`` with the same edge weights), dense and
    with a sender index: to 1e-5 of the output's scale."""
    irr_in, irr_sh, irr_out, E = SIGNATURES_L2[sig]
    tp = channelwise_tp(irr_in, irr_sh, irr_out)
    assert tp_fused.lanes(tp) == 8
    rng = np.random.default_rng(11)
    B, N, M, Mx, H = 2, 3, 5, 7, 8
    F, D = tp.weight_numel, tp.irreps_in.dim
    f = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)
    idx = rng.integers(0, Mx, (B, N, M)).astype(np.int32) if indexed else None
    x = f(B, Mx if indexed else M, D)
    sh = f(B, N, M, tp.irreps_sh.dim)
    attrs = [f(B, N, M, E) for _ in range(2)]
    masks = [rng.random((B, N, M)) > 0.3 * (c + 1) for c in range(2)]
    w1, b1, w2, b2 = f(E, H, s=0.2), f(H, s=0.1), f(H, F, s=0.2), f(F, s=0.1)
    args = (T(x), T(sh), [T(a) for a in attrs], [T(m) for m in masks], T(w1), T(b1), T(w2), T(b2))
    got = _tiled_k1(tp, *args, idx=None if idx is None else T(idx))
    want = tp_fused.tp_aggregate_fused_plain(tp, *args,
                                             sender_index=None if idx is None else T(idx))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale

    hid = sum(m[..., None] * np.maximum(a @ w1 + b1, 0) for a, m in zip(attrs, masks))
    w = (hid @ w2 + sum(m.astype(np.float32) for m in masks)[..., None] * b2).astype(np.float32)
    jt = jtp.channelwise_tp(irr_in, irr_sh, irr_out)
    xg = x[np.arange(B)[:, None, None], idx] if indexed else x
    blocks = jt.aggregate(jnp.asarray(xg), jnp.asarray(sh), jnp.asarray(w))
    jout = tp_fused.padded_from_blocks(tp, [None if blk is None else T(np.asarray(blk))
                                            for blk in blocks])
    assert float((got - jout).abs().max()) <= TOL * float(jout.abs().max())


# ---- the dense 8-lane K2 forward and dx: channel tiles, per-tile lists,
# splits, layout


@pytest.mark.parametrize("sig", list(SIGNATURES_L2))
def test_k2_l2_dx_lists_cover_every_reader_once(sig):
    """dx's per-tile lists (``tp_aggregate.dx_lists_l2``) name every
    (x element, channel, component) that the global list of the untiled
    kernels names, each exactly once across the tiles, within the tile
    that holds the channel and inside that tile's x slice, ascending within
    an element; the extents are flat past a slice and the longest list is
    the one reported."""
    tp = channelwise_tp(*SIGNATURES_L2[sig][:3])
    chan, _, _, ctab, _, dims = tp_fused.tables_tiled_l2(tp)
    dptr, ditem, longest = tp_aggregate.dx_lists_l2(tp)
    assert dptr.dtype == ditem.dtype == np.int32
    assert dptr.shape == (len(ctab), dims[0] + 1)
    _, g_ptr, g_item = tp_aggregate._backward_tables(tp, tp_fused.K_PAD_L2)
    want = sorted((d, int(it) >> 3, int(it) & 7) for d in range(tp.irreps_in.dim)
                  for it in g_item[g_ptr[d]:g_ptr[d + 1]])
    got, channels = [], []
    for t, (f0, fc, _, _, x_lo, xw, _, _) in enumerate(ctab.tolist()):
        assert (dptr[t, xw:] == dptr[t, xw]).all()
        for e in range(xw):
            items = ditem[dptr[t, e]:dptr[t, e + 1]].tolist()
            assert items == sorted(items)
            if items:
                assert x_lo + e < tp.irreps_in.dim
            got += [(x_lo + e, f0 + (it >> 3), it & 7) for it in items]
            assert all((it >> 3) < fc for it in items)
        channels += sorted({f0 + (it >> 3) for it in ditem[dptr[t, 0]:dptr[t, xw]].tolist()})
    assert sorted(got) == want and len(got) == len(set(got))
    assert channels == list(range(tp.weight_numel))       # each channel in one tile, in order
    assert longest == int((dptr[:, -1] - dptr[:, 0]).max())
    for f in range(tp.weight_numel):                      # every component of every channel
        assert sum(1 for _, c, _ in got if c == f) == chan[f, 1]


@pytest.mark.parametrize("sig", list(SIGNATURES_L2))
def test_k2_l2_walk_takes_each_channel_once_packed_by_shape(sig):
    """The tiled kernels' walk (``tp_aggregate.walk_l2``): each tile's
    channels once, in the first 64 slots (a tile of up to 64 channels) or
    128, at most 32 a warp; a warp runs no more channel shapes than the
    fewest warps could hold the tile's shapes in, plus one."""
    tp = channelwise_tp(*SIGNATURES_L2[sig][:3])
    chan, _, _, ctab, _, _ = tp_fused.tables_tiled_l2(tp)
    walk = tp_aggregate.walk_l2(tp)
    assert walk.shape == (len(ctab), tp_aggregate.WALK_L2) and walk.dtype == np.int32
    for t, (f0, fc, *_) in enumerate(ctab.tolist()):
        cw = 128 if fc > 64 else 64
        row = walk[t]
        assert (row[cw:] == -1).all()
        assert sorted(row[row >= 0].tolist()) == list(range(fc))
        shapes = {(int(chan[f0 + f, 1]), int(chan[f0 + f, 2])) for f in range(fc)}
        for k in range(0, cw, 32):
            warp = [f for f in row[k:k + 32].tolist() if f >= 0]
            held = {(int(chan[f0 + f, 1]), int(chan[f0 + f, 2])) for f in warp}
            assert len(held) <= max(1, -(-len(shapes) // (cw // 32))) + 1, (t, k, held)


#: (B, kept, summed) of the 8-lane K2 forward (kept = N, summed = M) and dx
#: (kept = M, summed = N) at the second-order probe's training shapes
#: (batch 24 of a 24 x 96 x 8 bucket), with B = 1 and N = 1
K2_L2_PLAN_SHAPES = [(24, 24, 24), (24, 24, 96), (24, 96, 24), (24, 96, 96), (24, 1, 24),
                     (24, 24, 1), (24, 8, 24), (24, 24, 8), (1, 24, 96), (1, 96, 24), (1, 1, 24),
                     (1, 24, 1), (1, 1, 1), (3, 5, 2)]


@pytest.mark.parametrize("sig", [s for s in SIGNATURES_L2 if s != "layer0"])
@pytest.mark.parametrize("dx", [False, True])
def test_k2_l2_split_plan(sig, dx):
    """Splits of the summed axis at the probe's shapes, at B = 1 and at
    N = 1, against the occupancy of an H100 at the kernel's layout (two or
    more blocks an SM): at least one split and never more than the summed
    axis has entries; a tile of work for each split where the axis has
    one; and the grid holds every block slot of the card unless the summed
    axis runs out of tiles."""
    tp = channelwise_tp(*SIGNATURES_L2[sig][:3])
    tiles = len(tp_fused.channel_tiles(tp))
    for esize in (4, 2):
        resident = H100_SMS * min(8, layouts.blocks_per_sm(
            layouts.k2_l2_smem(dx, *tp_aggregate.layout_sizes_l2(tp, dx), esize)))
        assert resident >= 2 * H100_SMS
        target = max(tp_fused.TARGET_BLOCKS, resident)
        for B, kept, summed in K2_L2_PLAN_SHAPES:
            splits = tp_aggregate.plan_splits_l2(B, kept, summed, tiles, target)
            assert 1 <= splits <= max(1, summed)
            if summed >= tp_aggregate.TILE_SUM:
                assert summed // splits >= tp_aggregate.TILE_SUM
            blocks = B * -(-kept // tp_aggregate.KEEP) * tiles * splits
            if splits < summed // tp_aggregate.TILE_SUM:
                assert blocks >= target, (B, kept, summed)
            if B * -(-kept // tp_aggregate.KEEP) * tiles >= target:   # no split needed
                assert splits == 1


@pytest.mark.parametrize("sig", list(SIGNATURES_L2))
def test_k2_l2_layout_fits_two_blocks_an_sm(sig):
    """The tiled forward's and dx's shared memory, summed as ``t2_layout``
    sums it (tests/torch_kernel_layouts.py), fits two blocks an SM of an
    H100 at every width of the probe, f32 and bf16; the forward three at
    f32 and dx three at bf16."""
    tp = channelwise_tp(*SIGNATURES_L2[sig][:3])
    for dx in (False, True):
        for esize in (4, 2):
            smem = layouts.k2_l2_smem(dx, *tp_aggregate.layout_sizes_l2(tp, dx), esize)
            assert smem <= tp_fused.SMEM_L2, (dx, esize, smem)
            assert layouts.blocks_per_sm(smem) >= (3 if esize == 2 or not dx else 2)


def _tiled_k2(tp, x, sh, w, g, splits):
    """The tiled forward and dx's f32 arithmetic read from
    ``tables_tiled_l2`` and ``dx_lists_l2`` as the kernels read them, in
    plain PyTorch: per channel tile its t rows (t_off + i d_out + k from the
    tile's coupling entries), each channel's x offset from x_lo; the
    summed axis cut into ``splits`` strided parts (part k takes k, k +
    splits, ...) whose sums are added in order; dx per (sender, tile
    channel, component), then per element of a tile's slice its list, then
    the tiles in order."""
    chan, ptab, gflat, ctab, _, dims = tp_fused.tables_tiled_l2(tp)
    dptr, ditem, _ = tp_aggregate.dx_lists_l2(tp)
    B, N, M, _ = sh.shape
    D, F = tp.irreps_in.dim, tp.weight_numel
    out = torch.zeros((B, N, F, 8))
    dx = torch.zeros((B, M, D))
    for t, (f0, fc, p0, pc, x_lo, xw, g0, _) in enumerate(ctab.tolist()):
        tt = torch.zeros((B, N, M, dims[1]))
        for q in range(p0, p0 + pc):
            sh_off, d1, d2, d3, t_off, g_off = ptab[q, :6].tolist()
            G = torch.from_numpy(gflat[g0 + g_off:g0 + g_off + d1 * d2 * d3].reshape(d1, d2, d3))
            tt[..., t_off:t_off + d1 * d3] = torch.einsum(
                "ijk,bnmj->bnmik", G, sh[..., sh_off:sh_off + d2]).reshape(B, N, M, d1 * d3)
        acc = torch.zeros((B, M, fc, 8))
        for f in range(f0, f0 + fc):
            xo, d1, d3, pl = chan[f].tolist()
            t_off = int(ptab[p0 + pl, 4])
            tf = tt[..., t_off:t_off + d1 * d3].reshape(B, N, M, d1, d3)
            xf = x[..., x_lo + xo:x_lo + xo + d1]                       # (B, M, d1)
            fwd = torch.einsum("bnm,bmi,bnmik->bnmk", w[..., f], xf, tf)
            bwd = torch.einsum("bnm,bnmik,bnk->bnmi", w[..., f], tf, g[:, :, f, :d3])
            out[:, :, f, :d3] = sum(fwd[:, :, s::splits].sum(2) for s in range(splits))
            acc[:, :, f - f0, :d1] = sum(bwd[:, s::splits].sum(1) for s in range(splits))
        for e in range(xw):
            for it in ditem[dptr[t, e]:dptr[t, e + 1]].tolist():
                dx[:, :, x_lo + e] += acc[:, :, it >> 3, it & 7]
    return out, dx


@pytest.mark.parametrize("sig,splits", [("layer1", 1), ("layer3", 3), ("final_conv", 2),
                                        ("tor_bond_conv", 1), ("layer0", 2)])
def test_tiled_k2_reproduces_the_plain_and_jax_aggregate_and_dx(sig, splits):
    """The tiled forward and dx, read from their tables as the kernels read
    them (f32, split sums in order), against ``tp_aggregate_plain`` and its
    gradient in x and against the JAX package's aggregate and its gradient:
    to 1e-5 of each result's scale; the upstream gradient's pad lanes are
    ignored."""
    tp = channelwise_tp(*SIGNATURES_L2[sig][:3])
    assert tp_fused.lanes(tp) == 8
    rng = np.random.default_rng(17)
    B, N, M = 2, 3, 7
    F, D = tp.weight_numel, tp.irreps_in.dim
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    x, sh = f(B, M, D), f(B, N, M, tp.irreps_sh.dim)
    w = f(B, N, M, F) * (rng.random((B, N, M, 1)) > 0.4).astype(np.float32)
    g = f(B, N, F, 8)                                     # noise in the pad lanes
    mask = np.zeros_like(g)
    for p in tp.paths:
        mask[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    got_out, got_dx = _tiled_k2(tp, T(x), T(sh), T(w), T(g), splits)

    xl = T(x).requires_grad_(True)
    want = tp_aggregate.tp_aggregate_plain(tp, xl, T(sh), T(w))
    (want_dx,) = torch.autograd.grad(want, [xl], T(g * mask))
    for got_, want_ in ((got_out, want.detach()), (got_dx, want_dx)):
        assert float((got_ - want_).abs().max()) <= TOL * float(want_.abs().max())

    jt = jtp.channelwise_tp(*SIGNATURES_L2[sig][:3])

    def jout(x_):
        return _jax_padded(tp, jt.aggregate(x_, jnp.asarray(sh), jnp.asarray(w)), 8)

    j_out = np.asarray(jout(jnp.asarray(x)))
    j_dx = np.asarray(jax.grad(lambda x_: (jout(x_) * g * mask).sum())(jnp.asarray(x)))
    for got_, want_ in ((got_out.numpy(), j_out), (got_dx.numpy(), j_dx)):
        assert float(np.abs(got_ - want_).max()) <= TOL * float(np.abs(want_).max())


# ---- the 8-lane K2 edge backward and the sender-index dx (both lane counts)

#: (in irreps, sh irreps, out irreps) of the KNN phore convs that K2 takes
#: at 4 lanes (l <= 1) and at 8
SIGNATURES_IDX = {4: [(SEQ[1], SH, SEQ[2]), (SEQ[2], SH, SEQ[3])],
                  8: [SIGNATURES_L2["layer1"][:3], SIGNATURES_L2["layer2"][:3]]}
DENSE_EDGE_SIGNATURES = [SIGNATURES_L2[s][:3] for s in ("layer1", "layer2", "layer3",
                                                        "final_conv", "tor_bond_conv")]
EDGE_SIGNATURES = DENSE_EDGE_SIGNATURES + SIGNATURES_IDX[4]


@pytest.mark.parametrize("sig", EDGE_SIGNATURES)
def test_path_tables_l2_cover_p_part_t_and_couplings(sig):
    """``path_tables_l2``: each path's channels, x offset and harmonics
    offset as the product defines them; the channels' P blocks (d_in x d_sh
    padded to float4s), the paths' dsh sums (d_sh x 32) and t blocks (d_in
    x d_out padded to float4s) tile their buffers in path order with no gap
    or overlap; the coupling entries are each path's alpha * cg."""
    tp = channelwise_tp(*sig)
    chan, ptab, gflat, (PT, PS, TS, GS) = tp_aggregate.path_tables_l2(tp)
    assert ptab.shape == (len(tp.paths), tp_aggregate.PT_W) and chan.shape == (tp.weight_numel, 4)
    sh_slices, in_slices = tp.irreps_sh.slices(), tp.irreps_in.slices()
    p_at = part_at = t_at = g_at = 0
    for q, (p, row) in enumerate(zip(tp.paths, ptab.tolist())):
        sh_off, d1, d2, d3, f0, fc, x0, t_off, g_off, p_off, part_off, zero = row
        assert (d1, d2, d3) == (2 * p.l_in + 1, 2 * p.l_sh + 1, 2 * p.l_out + 1) and zero == 0
        assert (f0, fc, sh_off) == (p.w_slice[0], p.mul_in, sh_slices[p.i_sh].start)
        assert x0 == in_slices[p.i_in].start and (chan[f0:f0 + fc, 3] == q).all()
        assert (p_off, part_off, t_off, g_off) == (p_at, part_at, t_at, g_at)
        assert t_off % 4 == 0 and p_off % 4 == 0
        np.testing.assert_array_equal(gflat[g_off:g_off + d1 * d2 * d3],
                                      tp_fused.coupling(p).reshape(-1))
        p_at += fc * layouts.pad4(d1 * d2)
        part_at += d2 * tp_aggregate.EDGE_SLOTS
        t_at += layouts.pad4(d1 * d3)
        g_at += d1 * d2 * d3
    assert (PT, PS, TS, GS) == (p_at, part_at, t_at, g_at) == (p_at, part_at, t_at, len(gflat))
    # dsh's sum order: each (path, j < d_sh) in exactly one component's list
    # (its sh_off + j), the paths of a component in path order
    seg_ptr, seg = tp_aggregate._dsh_segments(tp)
    seen = []
    for c in range(tp.irreps_sh.dim):
        pairs = seg[seg_ptr[c]:seg_ptr[c + 1]].tolist()
        assert [q for q, _ in pairs] == sorted(q for q, _ in pairs)
        for q, j in pairs:
            assert ptab[q, 0] + j == c and j < ptab[q, 2]
        seen += [tuple(pj) for pj in pairs]
    assert sorted(seen) == [(q, j) for q in range(len(ptab)) for j in range(ptab[q, 2])]


@pytest.mark.parametrize("sig", DENSE_EDGE_SIGNATURES)
def test_p_entries_cover_each_channels_p_once(sig):
    """``p_entries_l2``: each channel's d_in x d_sh entries of P, at its
    path's p_off + u * pad4(d_in d_sh), once, pads zero; P formed from the
    entries (sum over k < d_out of gflat and g) equals the path's einsum of
    its coupling tensor with g."""
    tp = channelwise_tp(*sig)
    _, ptab, gflat, (PT, _, _, _) = tp_aggregate.path_tables_l2(tp)
    ent = tp_aggregate.p_entries_l2(tp)
    assert ent.shape == (PT, 4)
    rng = np.random.default_rng(3)
    g = rng.normal(size=(tp.weight_numel, 8)).astype(np.float32)
    P = np.array([sum(gflat[e[1] + k] * g[e[0], k] for k in range(e[2])) for e in ent.tolist()],
                 np.float32)
    taken = np.zeros(PT, np.int64)
    for row in ptab.tolist():
        d1, d2, d3, f0, fc, g_off, p_off = row[1], row[2], row[3], row[4], row[5], row[8], row[9]
        pp = layouts.pad4(d1 * d2)
        G = gflat[g_off:g_off + d1 * d2 * d3].reshape(d1, d2, d3)
        for u in range(fc):
            block = slice(p_off + u * pp, p_off + u * pp + d1 * d2)
            taken[block] += 1
            assert (ent[block, 0] == f0 + u).all() and (ent[block, 2] == d3).all()
            want = np.einsum("ijk,k->ij", G, g[f0 + u, :d3]).reshape(-1)
            np.testing.assert_allclose(P[block], want, rtol=1e-5, atol=1e-6)
    assert (taken <= 1).all() and (ent[taken == 0] == 0).all()
    assert int(ent[:, 3].sum()) == int(taken.sum())


@pytest.mark.parametrize("sig", DENSE_EDGE_SIGNATURES)
def test_edge_plan_takes_each_path_once_balanced(sig):
    """``edge_plan_l2``: every path in exactly one warp's list, -1 only past
    a list's end; the warps' loads differ by no more than the costliest
    path (the greedy's bound)."""
    tp = channelwise_tp(*sig)
    plan = tp_aggregate.edge_plan_l2(tp)
    ptab = tp_aggregate.path_tables_l2(tp)[1]
    assert plan.shape[0] == tp_aggregate.EDGE_WARPS
    taken = []
    loads = []
    for row in plan.tolist():
        kept = [q for q in row if q >= 0]
        assert row[:len(kept)] == kept                     # -1 only at the end
        taken += kept
        loads.append(sum(tp_aggregate._path_cost(ptab[q]) for q in kept))
    assert sorted(taken) == list(range(len(tp.paths)))
    costs = [tp_aggregate._path_cost(r) for r in ptab]
    assert max(loads) - min(loads) <= max(costs)


@pytest.mark.parametrize("sig", EDGE_SIGNATURES)
def test_edge_and_index_dx_layouts_fit_two_blocks_an_sm(sig):
    """The edge backward's block (with dsh and without) and the sender-index
    dx's chunk block (f32 and bf16) fit two to an H100 SM at every width
    they take."""
    tp = channelwise_tp(*sig)
    _, ptab, _, (PT, PS, TS, GS) = tp_aggregate.path_tables_l2(tp)
    D, F = tp.irreps_in.dim, tp.weight_numel
    if tp_fused.lanes(tp) == 8:      # the dense edge backward takes 8-lane products
        for dsh in (False, True):
            assert layouts.blocks_per_sm(layouts.edge_l2_smem(dsh, D, F, PT, PS)) >= 2
    n_items = len(tp_aggregate._backward_tables(tp, 8)[2])
    for esize in (4, 2):
        smem = layouts.idx_dx_l2_smem(D, F, len(ptab), TS, GS, n_items, esize,
                                      tp_fused.lanes(tp))
        assert layouts.blocks_per_sm(smem) >= 2


def test_idx_chunk_plan_on_the_knn_step():
    """Phase 17's sender-index K2 calls (24 rows, 96 phore points, K = 24)
    on an index of nearest live points: chunks of the most slots a block
    takes, every slot in exactly one chunk in ``order``'s order, no chunk
    across two senders, and more chunks than the card has SMs four times
    over; at a toy size the chunks shrink to MIN_SLOTS."""
    B, P, K = 24, 96, 24
    idx, _ = knn_index(np.random.default_rng(5), B, P, K)
    lists = tp_aggregate.idx_dx_lists(T(idx), P)
    assert lists.Q == tp_aggregate.IDX_Q
    cuts, row_ptr, order, ptr = (t.long() for t in lists[2:4] + lists[:2])
    chunks = int(row_ptr[-1])
    assert chunks >= 4 * H100_SMS and chunks <= len(cuts) - 1
    sizes = cuts[1:chunks + 1] - cuts[:chunks]
    assert bool((sizes > 0).all()) and int(sizes.max()) <= lists.Q
    assert torch.equal(torch.cat([order[int(cuts[i]):int(cuts[i + 1])] for i in range(chunks)]),
                       order)
    for r in range(B * P):
        lo, hi = int(row_ptr[r]), int(row_ptr[r + 1])
        assert int(cuts[lo]) == int(ptr[r]) and int(cuts[hi]) == int(ptr[r + 1])
    assert tp_aggregate.plan_idx_chunk(56, 18) == (tp_aggregate.MIN_SLOTS, 56 // 4 + 18)


@pytest.mark.parametrize("shape,rn", [((24, 96, 96), 8), ((24, 96, 24), 4), ((24, 24, 96), 3),
                                      ((24, 24, 24), 1), ((24, 1, 24), 1), ((1, 96, 96), 1)])
def test_edge_receiver_plan_on_the_probe_shapes(shape, rn):
    """The dense edge backward's receivers a block: as many as leave two
    blocks for each slot of two an SM (at most EDGE_RN_MAX); every edge in
    one block's (receiver, lane); the sender-index dw's grid."""
    B, N, M = shape
    assert tp_aggregate.plan_edge_receivers(B, N, M) == rn
    blocks, got = tp_aggregate.edge_grid_l2(B, N, M)
    assert got == rn and blocks == -(-M // tp_aggregate.EDGE_SLOTS) * -(-N // rn) * B
    # every edge in exactly one block's (receiver, lane): block (chunk, run,
    # row) takes receivers run * rn .. and senders chunk * 32 + lane
    covered = np.zeros((B, N, M), np.int64)
    slots = tp_aggregate.EDGE_SLOTS
    for chunk in range(-(-M // slots)):
        for run in range(-(-N // rn)):
            n = np.arange(run * rn, min(N, run * rn + rn))
            m = np.arange(chunk * slots, min(M, chunk * slots + slots))
            covered[:, n[:, None], m[None, :]] += 1
    assert (covered == 1).all()
    assert rn == 1 or blocks >= 2 * tp_fused.TARGET_BLOCKS
    assert tp_aggregate.edge_grid_l2(B, N, M, indexed=True) == (
        -(-M // tp_aggregate.IDX_EDGE_SLOTS) * N * B, 1)


def _edge_k2(tp, x, sh, w, g, idx=None, live=None):
    """The 8-lane edge backward's f32 arithmetic read from
    ``path_tables_l2`` in the kernel's order, in plain PyTorch: per (edge,
    path) P = sum_k G g (k < d_out), per channel q[j] = sum_i x[i] P[i][j]
    and dw = sum_j sh[j] q[j]; per (edge, path, j) the sum over the path's
    channels, in order, of w q[j], a row that ``live`` marks dead read as
    zero; dsh per component its segment list's (path, j) sums in order.
    ``idx``: x read at the sender index."""
    chan, ptab, gflat, _ = tp_aggregate.path_tables_l2(tp)
    seg_ptr, seg = tp_aggregate._dsh_segments(tp)
    B, N, M, S = sh.shape
    F = tp.weight_numel
    xe = (x[:, None].expand(B, N, M, x.shape[-1]) if idx is None
          else x[torch.arange(B)[:, None, None], idx.long()])
    if live is not None:
        w = w * live[..., None]
    dw = torch.zeros(B, N, M, F)
    part = []
    for row in ptab.tolist():
        sh_off, d1, d2, d3, f0, fc, x0, _, g_off = row[:9]
        G = torch.from_numpy(gflat[g_off:g_off + d1 * d2 * d3].reshape(d1, d2, d3))
        P = torch.einsum("ijk,bnuk->bnuij", G, g[:, :, f0:f0 + fc, :d3])
        xp = xe[..., x0:x0 + fc * d1].reshape(B, N, M, fc, d1)
        q = torch.einsum("bnmui,bnuij->bnmuj", xp, P)
        dw[..., f0:f0 + fc] = torch.einsum("bnmuj,bnmj->bnmu", q, sh[..., sh_off:sh_off + d2])
        acc = torch.zeros(B, N, M, d2)
        for u in range(fc):
            acc = acc + w[..., f0 + u, None] * q[..., u, :]
        part.append(acc)
    dsh = torch.zeros(B, N, M, S)
    for s in range(S):
        for p_, j in seg[seg_ptr[s]:seg_ptr[s + 1]].tolist():
            dsh[..., s] += part[p_][..., j]
    return dw, dsh


def _upstream(tp, rng, B, N, lanes):
    """A seeded upstream gradient (B, N, F, lanes) and the mask of the lanes
    its paths define (the pad lanes carry noise, which the kernels ignore)."""
    g = rng.normal(size=(B, N, tp.weight_numel, lanes)).astype(np.float32)
    mask = np.zeros_like(g)
    for p in tp.paths:
        mask[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    return g, mask


@pytest.mark.parametrize("sig,mode", [
    (SIGNATURES_L2["layer1"][:3], "dense"), (SIGNATURES_L2["layer3"][:3], "dense"),
    (SIGNATURES_L2["final_conv"][:3], "dense"), (SIGNATURES_L2["tor_bond_conv"][:3], "dense"),
    (SIGNATURES_L2["layer2"][:3], "dead"), (SIGNATURES_IDX[8][0], "indexed"),
    (SIGNATURES_IDX[4][1], "indexed")])
def test_edge_k2_reproduces_the_plain_and_jax_dw_and_dsh(sig, mode):
    """The edge backward's emulation (dense at 8 lanes with dsh, on live
    bits of w; all rows dead; the sender-index mode at 4 and 8 lanes, dw
    only) against the gradients in w and sh of ``tp_aggregate_plain`` and
    of the JAX package's aggregate (``jax.vjp``; indexed: x gathered per
    receiver, the (B, N, K, D) form it takes): to 1e-5 of each result's
    scale.  dw is defined on dead edges too; there dsh is exactly zero."""
    tp = channelwise_tp(*sig)
    lanes = tp_fused.lanes(tp)
    rng = np.random.default_rng(len(mode) * 7 + tp.weight_numel)
    B, N, M, Mx = 2, 3, 37, 9
    D, S = tp.irreps_in.dim, tp.irreps_sh.dim
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(0, Mx, (B, N, M)).astype(np.int32) if mode == "indexed" else None
    x = f(B, Mx if idx is not None else M, D)
    sh = f(B, N, M, S)
    w = f(B, N, M, tp.weight_numel) * (rng.random((B, N, M, 1)) > 0.5).astype(np.float32)
    if mode == "dead":
        w = np.zeros_like(w)
    g, mask = _upstream(tp, rng, B, N, lanes)
    live = T(np.abs(w).max(-1) > 0).float()
    got_dw, got_dsh = _edge_k2(tp, T(x), T(sh), T(w), T(g), None if idx is None else T(idx), live)
    if mode == "dead":
        assert float(got_dsh.abs().max()) == 0.0 and float(got_dw.abs().max()) > 0.0

    kw = {} if idx is None else {"sender_index": T(idx)}
    shl, wl = T(sh).requires_grad_(True), T(w).requires_grad_(True)
    out = tp_aggregate.tp_aggregate_plain(tp, T(x), shl, wl, **kw)
    want_dw, want_dsh = torch.autograd.grad(out, [wl, shl], T(g * mask))
    checks = [(got_dw, want_dw)] + ([(got_dsh, want_dsh)] if idx is None else [])
    for got_, want_ in checks:
        assert float((got_ - want_).abs().max()) <= TOL * float(want_.abs().max())

    jt = jtp.channelwise_tp(*sig)
    xj = jnp.asarray(x) if idx is None else jnp.asarray(x)[np.arange(B)[:, None, None], idx]
    _, vjp = jax.vjp(lambda w_, sh_: _jax_padded(tp, jt.aggregate(xj, sh_, w_), lanes),
                     jnp.asarray(w), jnp.asarray(sh))
    j_dw, j_dsh = (np.asarray(a) for a in vjp(jnp.asarray(g * mask)))
    jchecks = [(got_dw, j_dw)] + ([(got_dsh, j_dsh)] if idx is None else [])
    for got_, want_ in jchecks:
        assert float(np.abs(got_.numpy() - want_).max()) <= TOL * float(np.abs(want_).max())


def _idx_dx_k2(tp, sh, w, g, idx, m_x, Q):
    """The sender-index dx's f32 arithmetic in the kernels' order, in plain
    PyTorch: per chunk of ``idx_dx_lists``' cut (at most Q of a sender's
    slots, in order) its live slots in order, per channel acc[i] += w sum_k
    t[i][k] g[k] with t[i][k] = sum_j G sh from ``path_tables_l2``; per
    chunk the channels reading an x element in d_item order; per sender its
    chunks in order."""
    _, ptab, gflat, _ = tp_aggregate.path_tables_l2(tp)
    _, d_ptr, d_item = tp_aggregate._backward_tables(tp, 8)
    B, N, K, S = sh.shape
    F, D = tp.weight_numel, tp.irreps_in.dim
    order, ptr = tp_fused.sender_lists(idx, m_x)
    cuts, row_ptr = tp_scalar.slot_chunks(ptr, Q, B * N * K // Q + B * m_x)
    shf, wf, gf = sh.reshape(-1, S), w.reshape(-1, F), g.reshape(B * N, F, -1)
    part = torch.zeros((int(row_ptr[-1]), D))
    for c in range(part.shape[0]):
        acc = torch.zeros((F, 8))
        for e in order[int(cuts[c]):int(cuts[c + 1])].tolist():
            if not bool((wf[e] != 0).any()):
                continue                                   # a dead slot is not loaded
            for row in ptab.tolist():
                sh_off, d1, d2, d3, f0, fc, _, _, g_off = row[:9]
                G = torch.from_numpy(gflat[g_off:g_off + d1 * d2 * d3].reshape(d1, d2, d3))
                t = torch.einsum("ijk,j->ik", G, shf[e, sh_off:sh_off + d2])
                s = torch.einsum("ik,uk->ui", t, gf[e // K, f0:f0 + fc, :d3])
                acc[f0:f0 + fc, :d1] += wf[e, f0:f0 + fc, None] * s
        for d in range(D):
            for it in d_item[d_ptr[d]:d_ptr[d + 1]].tolist():
                part[c, d] += acc[it >> 3, it & 7]
    dx = torch.stack([part[int(row_ptr[r]):int(row_ptr[r + 1])].sum(0)
                      for r in range(B * m_x)])
    return dx.reshape(B, m_x, D)


@pytest.mark.parametrize("lanes,k", [(4, 0), (4, 1), (8, 0), (8, 1)])
@pytest.mark.parametrize("Q", [3, 32])
def test_index_dx_k2_reproduces_the_plain_and_jax_dx(lanes, k, Q):
    """The sender-index dx's emulation (4 and 8 lanes, chunks of 3 and of
    32 slots, senders no slot reads, one sender in every receiver's first
    slot, dead receivers) against the gradient in x of
    ``tp_aggregate_plain`` in the sender-index mode and of the JAX
    package's aggregate on x gathered per receiver: to 1e-5 of dx's
    scale."""
    tp = channelwise_tp(*SIGNATURES_IDX[lanes][k])
    assert tp_fused.lanes(tp) == lanes
    rng = np.random.default_rng(lanes * 10 + k + Q)
    B, N, K, Mx = 2, 11, 4, 9
    D = tp.irreps_in.dim
    idx = np.minimum(rng.integers(0, Mx, (B, N, K)), rng.integers(0, Mx, (B, N, K)))
    idx[:, :, 0] = 1
    idx = idx.astype(np.int32)
    x = rng.normal(size=(B, Mx, D)).astype(np.float32)
    sh = rng.normal(size=(B, N, K, 9)).astype(np.float32)
    live = rng.integers(0, K + 1, (B, N, 1)) > np.arange(K)
    w = (rng.normal(size=(B, N, K, tp.weight_numel)) * live[..., None]).astype(np.float32)
    g, mask = _upstream(tp, rng, B, N, lanes)
    g = g * mask
    got = _idx_dx_k2(tp, T(sh), T(w), T(g), T(idx), Mx, Q)

    xl = T(x).requires_grad_(True)
    out = tp_aggregate.tp_aggregate_plain(tp, xl, T(sh), T(w), sender_index=T(idx))
    (want,) = torch.autograd.grad(out, [xl], T(g))
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())

    jt = jtp.channelwise_tp(*SIGNATURES_IDX[lanes][k])
    bidx = np.arange(B)[:, None, None]
    jdx = np.asarray(jax.grad(lambda x_: (_jax_padded(
        tp, jt.aggregate(x_[bidx, idx], jnp.asarray(sh), jnp.asarray(w)), lanes) * g).sum())(
            jnp.asarray(x)))
    assert float(np.abs(got.numpy() - jdx).max()) <= TOL * float(np.abs(jdx).max())


# ---- the sender-index K2 forward (both lane counts): the dense tiled
# forward's channel tiles, each slot's x slice read at the index

#: (B, N, K) of the sender-index forward: the KNN step's and serving shapes,
#: B = 1, short and long slot rows (K = 7, 40, 100: more than a split takes)
IDX_FWD_SHAPES = [(24, 96, 24), (40, 96, 24), (1, 96, 24), (1, 5, 7), (2, 3, 40), (1, 8, 100),
                  (3, 37, 5)]


@pytest.mark.parametrize("lanes", [4, 8])
def test_idx_forward_split_plan_and_layout(lanes):
    """The sender-index forward's shared memory (``t2_layout`` with idx,
    tests/torch_kernel_layouts.py) fits two blocks an SM of an H100 on the
    KNN phore convs, f32 and bf16; its slot splits (``plan_splits_idx``)
    are the dense tiled forward's or more, none takes more than
    ``IDX_SUMMED`` slots, and more than that fill the card."""
    for sig in SIGNATURES_IDX[lanes]:
        tp = channelwise_tp(*sig)
        assert tp_fused.lanes(tp) == lanes
        tiles = len(tp_fused.channel_tiles(tp))
        sizes = tp_aggregate.layout_sizes_l2(tp, False)[:5]
        for esize in (4, 2):
            smem = layouts.k2_idx_fwd_smem(*sizes, esize)
            assert smem <= tp_fused.SMEM_L2, (sig, esize, smem)
            assert layouts.blocks_per_sm(smem) >= 2
            target = max(tp_fused.TARGET_BLOCKS, H100_SMS * min(8, layouts.blocks_per_sm(smem)))
            for B, N, K in IDX_FWD_SHAPES:
                splits = tp_aggregate.plan_splits_idx(B, N, K, tiles, target)
                assert tp_aggregate.plan_splits_l2(B, N, K, tiles, target) <= splits <= max(1, K)
                assert -(-K // splits) <= tp_aggregate.IDX_SUMMED, (B, N, K)
                if -(-K // tp_aggregate.IDX_SUMMED) < splits < K // tp_aggregate.TILE_SUM:
                    assert B * -(-N // tp_aggregate.KEEP) * tiles * splits >= target


def _tiled_k2_idx(tp, x, sh, w, idx, splits, lanes):
    """The sender-index forward's f32 arithmetic read from
    ``tables_tiled_l2`` as the kernel reads it, in plain PyTorch: per channel
    tile its t rows, each slot's x slice gathered at the index from the
    tile's x_lo, the slots cut into ``splits`` strided parts (part k takes
    k, k + splits, ...) whose sums are added in order."""
    chan, ptab, gflat, ctab, _, dims = tp_fused.tables_tiled_l2(tp)
    B, N, K, _ = sh.shape
    xs = x[torch.arange(B)[:, None, None], idx.long()]               # (B, N, K, D)
    out = torch.zeros((B, N, tp.weight_numel, lanes))
    for f0, fc, p0, pc, x_lo, xw, g0, _ in ctab.tolist():
        tt = torch.zeros((B, N, K, dims[1]))
        for q in range(p0, p0 + pc):
            sh_off, d1, d2, d3, t_off, g_off = ptab[q, :6].tolist()
            G = torch.from_numpy(gflat[g0 + g_off:g0 + g_off + d1 * d2 * d3].reshape(d1, d2, d3))
            tt[..., t_off:t_off + d1 * d3] = torch.einsum(
                "ijk,bnmj->bnmik", G, sh[..., sh_off:sh_off + d2]).reshape(B, N, K, d1 * d3)
        for f in range(f0, f0 + fc):
            xo, d1, d3, pl = chan[f].tolist()
            t_off = int(ptab[p0 + pl, 4])
            tf = tt[..., t_off:t_off + d1 * d3].reshape(B, N, K, d1, d3)
            xf = xs[..., x_lo + xo:x_lo + xo + d1]
            fwd = torch.einsum("bnm,bnmi,bnmik->bnmk", w[..., f], xf, tf)
            out[:, :, f, :d3] = sum(fwd[:, :, s::splits].sum(2) for s in range(splits))
    return out


@pytest.mark.parametrize("lanes,k", [(4, 0), (4, 1), (8, 0), (8, 1)])
@pytest.mark.parametrize("K,splits", [(7, 1), (7, 3), (40, 1)])
def test_idx_forward_reproduces_the_plain_and_jax_aggregate(lanes, k, K, splits):
    """The sender-index forward's emulation (4 and 8 lanes; K = 7 whole and
    in three strided splits, K = 40; dead receivers and dead slots; one
    sender in every receiver's first slot) against ``tp_aggregate_plain`` in
    the sender-index mode and the JAX package's aggregate on x gathered per
    receiver: to 1e-5 of the output's scale; the pad lanes stay zero."""
    tp = channelwise_tp(*SIGNATURES_IDX[lanes][k])
    rng = np.random.default_rng(lanes + 10 * k + K + splits)
    B, N, Mx = 2, 9, 11
    D = tp.irreps_in.dim
    idx = rng.integers(0, Mx, (B, N, K)).astype(np.int32)
    idx[:, :, 0] = 3
    x = rng.normal(size=(B, Mx, D)).astype(np.float32)
    sh = rng.normal(size=(B, N, K, 9)).astype(np.float32)
    live = rng.integers(0, K + 1, (B, N, 1)) > np.arange(K)
    live[:, 4] = False                                   # a dead receiver
    w = (rng.normal(size=(B, N, K, tp.weight_numel)) * live[..., None]).astype(np.float32)
    got = _tiled_k2_idx(tp, T(x), T(sh), T(w), T(idx), splits, lanes)
    want = tp_aggregate.tp_aggregate_plain(tp, T(x), T(sh), T(w), sender_index=T(idx))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    assert float(got[:, 4].abs().max()) == 0.0

    jt = jtp.channelwise_tp(*SIGNATURES_IDX[lanes][k])
    jout = np.asarray(_jax_padded(tp, jt.aggregate(jnp.asarray(x[np.arange(B)[:, None, None],
                                                                    idx]),
                                                   jnp.asarray(sh), jnp.asarray(w)), lanes))
    assert float(np.abs(got.numpy() - jout).max()) <= TOL * float(np.abs(jout).max())


# ---- the 8-lane K3 dx: runs of senders, four a thread, chunks of receivers

#: (B, N, M) of the six layer-0 training convs at batch 24 and the edge cases
K3_DX_SHAPES = [(24, 24, 24), (24, 24, 96), (24, 96, 24), (24, 96, 96), (1, 1, 1), (24, 1, 24),
                (1, 96, 1), (3, 37, 29), (2, 9, 300)]


@pytest.mark.parametrize("F", [60, 40, 7, 256])
def test_k3_dx_l2_plan_covers_the_convs_and_fills_the_card(F):
    """The 8-lane dx's plan (``plan_chunk_l2``): runs of senders, ``X2_Q``
    a thread, at most ``X2_THREADS`` threads a block, that tile the senders
    as evenly as that allows, receiver chunks that tile the receivers, none
    under ``X2_MIN_CHUNK`` receivers where there are that many, and a grid
    that holds every block slot of the card unless the receivers run out;
    its shared memory (``x2_floats``) fits eight blocks an SM at F = 60."""
    D, ni = 20, 3 * 20
    for B, N, M in K3_DX_SHAPES:
        run = tp_scalar.plan_run_l2(M, F)
        smem = layouts.k3_dx_l2_smem(F, D, ni, run)
        if F == 60:
            assert layouts.blocks_per_sm(smem) >= 8, (M, smem)
        for target in (tp_scalar.TARGET_BLOCKS, 8 * H100_SMS):
            run_, chunk, splits = tp_scalar.plan_chunk_l2(B, N, M, F, target)
            threads = -(-run // tp_scalar.X2_Q) * F
            assert run_ == run and 1 <= threads <= max(F, tp_scalar.X2_THREADS)
            runs = -(-M // run)
            assert run * (runs - 1) < M <= run * runs                  # no empty run
            assert run * runs - M < runs                               # as even as it can be
            assert chunk * (splits - 1) < N <= chunk * splits          # no empty chunk
            if N >= tp_scalar.X2_MIN_CHUNK:
                assert chunk >= tp_scalar.X2_MIN_CHUNK
            if splits < N // tp_scalar.X2_MIN_CHUNK:
                assert B * runs * splits >= target


def _k3_dx_l2(tp, sh, w, g, run, chunk):
    """The 8-lane dx's f32 arithmetic in the kernel's grouping, in plain
    PyTorch: per (run of senders, chunk of receivers) each (sender,
    channel)'s sum over the chunk of w sum_{k < K} sh[off + k] g[k], times
    c_p, then the channels reading an element in d_item order; the chunks'
    partial sums added in order."""
    chan, scale, d_ptr, d_item = tp_scalar._conv_tables(tp, torch.float32)
    B, N, M, S = sh.shape
    F, D = tp.weight_numel, tp.irreps_in.dim
    t = torch.zeros((B, N, M, F))
    for k in range(5):
        on = torch.from_numpy(chan[:, 2] > k)
        comp = torch.from_numpy(np.minimum(chan[:, 1] + k, S - 1))
        t = t + torch.where(on, sh[..., comp] * g[:, :, None, :, k], torch.zeros(F))
    dx = torch.zeros((B, M, D))
    for m0 in range(0, M, run):
        total = 0.0
        for n0 in range(0, N, chunk):
            acc = (w[:, n0:n0 + chunk, m0:m0 + run] * t[:, n0:n0 + chunk, m0:m0 + run]).sum(1)
            acc = acc * torch.from_numpy(scale)
            part = torch.zeros(acc.shape[:2] + (D,))
            for d in range(D):
                for f in d_item[d_ptr[d]:d_ptr[d + 1]].tolist():
                    part[..., d] += acc[..., f]
            total = total + part
        dx[:, m0:m0 + run] = total
    return dx


@pytest.mark.parametrize("B,N,M,run,chunk", [(2, 9, 7, 3, 4), (1, 1, 1, 1, 1), (2, 5, 11, 11, 5),
                                             (3, 17, 4, 2, 8)])
def test_k3_dx_l2_reproduces_the_plain_and_jax_dx(B, N, M, run, chunk):
    """The 8-lane dx's emulation (runs of senders and chunks of receivers,
    the upstream gradient's pad lanes noise) against the gradient in x of
    ``scalar_paths_aggregate_plain`` and of the JAX package's aggregate on
    the second-order layer-0 conv: to 1e-5 of dx's scale."""
    tp = channelwise_tp(SEQ2[0], SH, SEQ2[1])
    assert tp_fused.lanes(tp) == 8 and tp_scalar.all_scalar_paths(tp)
    rng = np.random.default_rng(B * 100 + N + M)
    D = tp.irreps_in.dim
    x = rng.normal(size=(B, M, D)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, 9)).astype(np.float32)
    w = (rng.normal(size=(B, N, M, tp.weight_numel))
         * (rng.random((B, N, M, 1)) > 0.3)).astype(np.float32)
    g, mask = _upstream(tp, rng, B, N, 8)
    got = _k3_dx_l2(tp, T(sh), T(w), T(g), run, chunk)

    xl = T(x).requires_grad_(True)
    out = tp_scalar.scalar_paths_aggregate_plain(tp, xl, T(sh), T(w))
    (want,) = torch.autograd.grad(out, [xl], T(g * mask))
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())

    jt = jtp.channelwise_tp(SEQ2[0], SH, SEQ2[1])
    jdx = np.asarray(jax.grad(lambda x_: (_jax_padded(
        tp, jt.aggregate(x_, jnp.asarray(sh), jnp.asarray(w)), 8) * g * mask).sum())(
            jnp.asarray(x)))
    assert float(np.abs(got.numpy() - jdx).max()) <= TOL * float(np.abs(jdx).max())


# ---- the dense 8-lane K3 forward and edge backward: lane = a unit of one path

#: (in irreps, out irreps) of all-l_in-0 convs at 8 lanes: the second-order
#: layer-0 conv (three paths of 20 channels: four-channel units), one whose
#: paths are 6 and 3 channels wide (units of 2 and 3 channels, two paths
#: sharing the 0e harmonic), a wider one and a narrow one (one channel a path)
K3_L2_SIGNATURES = {
    "layer0": (SEQ2[0], SEQ2[1]),
    "odd": ("6x0e + 3x0o", "6x0e + 2x1o + 2x2e + 3x0o"),
    "wide": ("32x0e", "32x0e + 8x1o + 8x2e"),
    "narrow": ("1x0e", "1x0e + 1x1o + 1x2e"),
}
#: (B, N, M) of the six layer-0 training convs at batch 24 and the edge cases
K3_FWD_SHAPES = [(24, 24, 24), (24, 24, 96), (24, 96, 24), (24, 96, 96), (1, 1, 1), (24, 1, 24),
                 (1, 96, 1), (3, 37, 29), (2, 9, 300)]


def _k3_l2_tp(sig):
    irr_in, irr_out = K3_L2_SIGNATURES[sig]
    tp = channelwise_tp(irr_in, SH, irr_out)
    assert tp_fused.lanes(tp) == 8 and tp_scalar.all_scalar_paths(tp)
    return tp


@pytest.mark.parametrize("sig", list(K3_L2_SIGNATURES))
def test_k3_l2_units_take_each_channel_once_within_a_path(sig):
    """``units_l2``: units of at most four neighbouring channels that cover
    every channel once, each within one path (one harmonic offset, K and
    c_p; neighbouring x elements), in channel order; the four-channel check
    holds where every path is four channels wide at a multiple of four (not
    for widths 6 and 3 or 1); at most 32 units an edge; and the component
    lists name, for each harmonic component, the units whose path reads it,
    in unit order, with the component's place in the path."""
    tp = _k3_l2_tp(sig)
    chan, scale, _, _ = tp_scalar._conv_tables(tp, torch.float32)
    t = tp_scalar.units_l2(tp)
    F, S = tp.weight_numel, tp.irreps_sh.dim
    seen = []
    for (f0, d0, off, kc), c in zip(t.units.tolist(), t.scale.tolist()):
        K, cnt = kc & 7, kc >> 3
        assert 1 <= cnt <= 4 and 1 <= K <= tp_scalar.KM
        for i in range(cnt):
            assert tuple(chan[f0 + i][:3]) == (d0 + i, off, K) and scale[f0 + i] == c
        seen += range(f0, f0 + cnt)
    assert seen == list(range(F))
    assert t.vec == (sig in ("layer0", "wide"))
    assert len(t.units) <= tp_scalar.E2_UNITS
    for s in range(S):
        want = [j * tp_scalar.KM + s - off for j, (_, _, off, kc) in enumerate(t.units.tolist())
                if off <= s < off + (kc & 7)]
        assert t.comp_item[t.comp_ptr[s]:t.comp_ptr[s + 1]].tolist() == want, s
    if sig == "layer0":   # each component read by the five units of one path
        assert t.comp_ptr.tolist() == list(range(0, 50, 5))


@pytest.mark.parametrize("sig", ["layer0", "odd", "wide"])
def test_k3_fwd_l2_plan_covers_the_senders_and_fills_the_card(sig):
    """The dense 8-lane forward's plan (``plan_fwd_l2``): at most
    ``F2_THREADS`` threads of (receiver, slice, unit), receivers that tile N
    and slices that take every sender once (slice s the senders s, s + SL,
    ...), blocks as full of receivers as N allows, the least cost of its
    model over every slice count at ``TARGET_BLOCKS`` and at eight blocks an
    SM, a grid of more than one wave only where every one-wave grid takes
    more senders a slice, and shared memory for four blocks an SM."""
    tp = _k3_l2_tp(sig)
    F, G = tp.weight_numel, len(tp_scalar.units_l2(tp).units)
    for B, N, M in K3_FWD_SHAPES:
        for target in (tp_scalar.TARGET_BLOCKS, 8 * H100_SMS):
            R, SL = tp_scalar.plan_fwd_l2(B, N, M, G, target)
            assert 1 <= R <= N and 1 <= SL <= M and R * SL * G <= tp_scalar.F2_THREADS
            taken = sorted(m for s in range(SL) for m in range(s, M, SL))
            assert taken == list(range(M))
            blocks = B * -(-N // R)

            def cost(sl):
                r = max(1, min(N, tp_scalar.F2_THREADS // (sl * G)))
                return -(-B * -(-N // r) // target) * (-(-M // (sl * tp_scalar.F2_U))
                                                        + tp_scalar.F2_FIXED)

            assert cost(SL) == min(cost(sl) for sl in range(1, min(M, 256 // G) + 1))
            assert R == N or R * SL * G > tp_scalar.F2_THREADS - SL * G    # blocks full
            if blocks > target:                  # more waves only where they save steps
                one_wave = [sl for sl in range(1, min(M, 256 // G) + 1)
                            if B * -(-N // max(1, min(N, 256 // (sl * G)))) <= target]
                assert all(-(-M // (sl * tp_scalar.F2_U)) > -(-M // (SL * tp_scalar.F2_U))
                           for sl in one_wave)
            S, D = tp.irreps_sh.dim, tp.irreps_in.dim
            MC = tp_scalar.chunk_fwd_l2(R, SL, M, S, D)
            assert MC % SL == 0 and (MC >= M or MC * (R * S + D) <= tp_scalar.F2_STAGE)
            assert pad4(R * MC * S) + MC * D <= tp_scalar.F2_STAGE
            smem = layouts.k3_fwd_l2_smem(R, SL, F, MC, S, D)
            assert smem <= 48 * 1024 and layouts.blocks_per_sm(smem) >= 4


def test_k3_l2_layouts_fit():
    """The dense 8-lane forward's largest block (its sums, or a chunk of 24,
    96 or 300 senders staged) and the edge backward's with dsh fit four
    blocks an SM (the edge backward eight without dsh)."""
    tp = _k3_l2_tp("layer0")
    t = tp_scalar.units_l2(tp)
    F, G, S = tp.weight_numel, len(t.units), tp.irreps_sh.dim
    SL = tp_scalar.F2_THREADS // G
    for M in (24, 96, 300):
        MC = tp_scalar.chunk_fwd_l2(1, SL, M, S, tp.irreps_in.dim)
        smem = layouts.k3_fwd_l2_smem(1, SL, F, MC, S, tp.irreps_in.dim)
        assert layouts.blocks_per_sm(smem) >= 4
    n_items = int(t.comp_ptr[-1])
    assert n_items == 45
    assert layouts.blocks_per_sm(layouts.k3_edge_l2_smem(True, S, n_items)) >= 4
    assert layouts.blocks_per_sm(layouts.k3_edge_l2_smem(False, S, n_items)) >= 8


def _k3_fwd_l2(tp, x, sh, w, SL):
    """The dense 8-lane forward's f32 arithmetic in the kernel's grouping, in
    plain PyTorch: per (receiver, unit), each slice s's chain over its
    senders s, s + SL, ... in order of x w sh[off + k] (k < K), the slices
    added in order, times c_p; lanes past K zero."""
    t = tp_scalar.units_l2(tp)
    B, N, M, _ = sh.shape
    out = torch.zeros((B, N, tp.weight_numel, 8))
    for (f0, d0, off, kc), c in zip(t.units.tolist(), t.scale.tolist()):
        K, cnt = kc & 7, kc >> 3
        xw = x[:, None, :, d0:d0 + cnt] * w[..., f0:f0 + cnt]          # (B, N, M, cnt)
        term = xw[..., None] * sh[..., None, off:off + K]              # (B, N, M, cnt, K)
        total = torch.zeros((B, N, cnt, K))
        for s in range(SL):
            acc = torch.zeros((B, N, cnt, K))
            for m in range(s, M, SL):
                acc = acc + term[:, :, m]
            total = total + acc
        out[:, :, f0:f0 + cnt, :K] = c * total
    return out


@pytest.mark.parametrize("sig", list(K3_L2_SIGNATURES))
@pytest.mark.parametrize("B,N,M,SL", [(2, 5, 7, 3), (1, 1, 1, 1), (2, 3, 11, 11), (3, 4, 9, 2)])
def test_k3_fwd_l2_reproduces_the_plain_and_jax_aggregate(sig, B, N, M, SL):
    """The dense 8-lane forward's emulation (slices of the senders added in
    order, a slice count that does not divide M, rows of w all zero)
    against ``scalar_paths_aggregate_plain`` and the JAX package's
    aggregate: to 1e-5 of the output's scale."""
    tp = _k3_l2_tp(sig)
    rng = np.random.default_rng(B * 100 + N * 10 + M)
    x = rng.normal(size=(B, M, tp.irreps_in.dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, 9)).astype(np.float32)
    w = (rng.normal(size=(B, N, M, tp.weight_numel))
         * (rng.random((B, N, M, 1)) > 0.3)).astype(np.float32)
    got = _k3_fwd_l2(tp, T(x), T(sh), T(w), SL)
    want = tp_scalar.scalar_paths_aggregate_plain(tp, T(x), T(sh), T(w))
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    jt = jtp.channelwise_tp(*(K3_L2_SIGNATURES[sig][0], SH, K3_L2_SIGNATURES[sig][1]))
    jout = np.asarray(_jax_padded(tp, jt.aggregate(jnp.asarray(x), jnp.asarray(sh),
                                                   jnp.asarray(w)), 8))
    assert float(np.abs(got.numpy() - jout).max()) <= TOL * float(np.abs(jout).max())


def _k3_edge_l2(tp, x, sh, w, g):
    """The dense 8-lane edge backward's f32 arithmetic in the kernel's
    grouping, in plain PyTorch: per unit, coef = c_p g[k] (k < K); dw = x
    sum_k sh[off + k] coef; each unit's sums sum_c x w coef[c][k]; dsh[s] the
    sum of the units of its component list, in order (0 where none)."""
    t = tp_scalar.units_l2(tp)
    dw, dsh = torch.zeros_like(w), torch.zeros_like(sh)
    parts = []
    for (f0, d0, off, kc), c in zip(t.units.tolist(), t.scale.tolist()):
        K, cnt = kc & 7, kc >> 3
        coef = c * g[:, :, None, f0:f0 + cnt, :K]                     # (B, N, 1, cnt, K)
        xs = x[:, None, :, d0:d0 + cnt]                               # (B, 1, M, cnt)
        dw[..., f0:f0 + cnt] = xs * (sh[..., None, off:off + K] * coef).sum(-1)
        parts.append(((xs * w[..., f0:f0 + cnt])[..., None] * coef).sum(-2))   # (B, N, M, K)
    for s in range(sh.shape[-1]):
        for item in t.comp_item[t.comp_ptr[s]:t.comp_ptr[s + 1]].tolist():
            j, k = divmod(item, tp_scalar.KM)
            dsh[..., s] = dsh[..., s] + parts[j][..., k]
    return dw, dsh


@pytest.mark.parametrize("sig", list(K3_L2_SIGNATURES))
@pytest.mark.parametrize("B,N,M", [(2, 5, 7), (1, 1, 1), (3, 4, 9)])
def test_k3_edge_l2_reproduces_the_plain_and_jax_dw_and_dsh(sig, B, N, M):
    """The dense 8-lane edge backward's emulation (units, component lists,
    the upstream gradient's pad lanes noise, rows of w all zero) against
    ``scalar_paths_backward_edge_plain`` and the gradients in w and sh of
    the JAX package's aggregate: to 1e-5 of each result's scale; dsh zero
    in the components no path reads."""
    tp = _k3_l2_tp(sig)
    rng = np.random.default_rng(B * 100 + N * 10 + M + 7)
    x = rng.normal(size=(B, M, tp.irreps_in.dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, 9)).astype(np.float32)
    w = (rng.normal(size=(B, N, M, tp.weight_numel))
         * (rng.random((B, N, M, 1)) > 0.3)).astype(np.float32)
    g, mask = _upstream(tp, rng, B, N, 8)
    dw, dsh = _k3_edge_l2(tp, T(x), T(sh), T(w), T(g))
    want_dw, want_dsh = tp_scalar.scalar_paths_backward_edge_plain(tp, T(x), T(sh), T(w), T(g),
                                                                   True)
    for got, want in ((dw, want_dw), (dsh, want_dsh)):
        assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    t = tp_scalar.units_l2(tp)
    unread = [s for s in range(sh.shape[-1]) if t.comp_ptr[s] == t.comp_ptr[s + 1]]
    assert float(dsh[..., unread].abs().sum()) == 0.0
    irr_in, irr_out = K3_L2_SIGNATURES[sig]
    jt = jtp.channelwise_tp(irr_in, SH, irr_out)
    jdsh, jdw = jax.grad(lambda s_, w_: (_jax_padded(
        tp, jt.aggregate(jnp.asarray(x), s_, w_), 8) * g * mask).sum(), argnums=(0, 1))(
            jnp.asarray(sh), jnp.asarray(w))
    for got, want in ((dw, np.asarray(jdw)), (dsh, np.asarray(jdsh))):
        assert float(np.abs(got.numpy() - want).max()) <= TOL * float(np.abs(want).max())


# ---- model widths past corpus2's: the wide K1, the 4-lane tiled K2, the
# 8-lane edge backward's slots, K3's two unit groups and its sender-index kernel

def _seq(ns, nv, l2):
    from diffphore_torch.models.encoder import irrep_seq
    return irrep_seq(ns, nv, l2)


#: (in irreps, out irreps) of wide convs at 4 lanes: F = 256, 272 and 512
WIDE_SIGNATURES = {
    "32-16-layer3": (_seq(32, 16, False)[3], _seq(32, 16, False)[3]),
    "48-10-layer3": (_seq(48, 10, False)[3], _seq(48, 10, False)[3]),
    "64-32-layer3": (_seq(64, 32, False)[3], _seq(64, 32, False)[3]),
    "64-32-layer2": (_seq(64, 32, False)[2], _seq(64, 32, False)[3]),
}


@pytest.mark.parametrize("sig", list(WIDE_SIGNATURES))
def test_k1_wide_channel_tiles_cover_every_channel_once_at_path_boundaries(sig):
    """The 4-lane wide K1's channel tiles (``channel_tiles(tp)``, as at 8
    lanes): consecutive, each starting at a path's first channel and holding
    whole paths (p0 .. p0 + pc - 1), at most ``TILE_F_L2`` channels, every
    channel of the row once; the launch plan takes them."""
    irr_in, irr_out = WIDE_SIGNATURES[sig]
    tp = channelwise_tp(irr_in, SH, irr_out)
    tiles = tp_fused.channel_tiles(tp)
    f_next, p_next = 0, 0
    for f0, fc, p0, pc in tiles:
        assert (f0, p0) == (f_next, p_next) and 1 <= fc <= tp_fused.TILE_F_L2
        assert tp.paths[p0].w_slice[0] == f0 and tp.paths[p0 + pc - 1].w_slice[1] == f0 + fc
        f_next, p_next = f0 + fc, p0 + pc
    assert (f_next, p_next) == (tp.weight_numel, len(tp.paths))
    pl = tp_fused.plan(tp, 40, 24, 96, 2, 96, 96, 4, False)
    assert pl.wide and pl.tiles == tuple((f0, fc) for f0, fc, _, _ in tiles)


def _wide_edge_weights(attrs, masks, w1, b1, w2, b2, hp=64):
    """The wide K1's f32 edge MLP in its grouping (``tp_fused_kernel`` with
    WIDE): attributes padded with zeros to a multiple of four; the hidden
    layer in chunks of ``hp`` units, lane l of a warp forming units hc + l
    and hc + l + 32, each whole over E; the second product summed over the
    chunks in order, then msum b2.  Returns w and the units each chunk
    formed."""
    E, H = w1.shape
    ep = -(-E // 4) * 4
    pad = lambda a: torch.nn.functional.pad(a, (0, ep - E))
    w1p = torch.nn.functional.pad(w1, (0, 0, 0, ep - E))
    wacc, formed = 0.0, []
    msum = sum(m.float() for m in masks)
    for hc in range(0, H, hp):
        units = [u for lane in range(32) for u in (hc + lane, hc + lane + 32) if u < H]
        formed += units
        cols = torch.tensor(sorted(units))
        hid = sum(m.float()[..., None] * torch.relu(pad(a) @ w1p[:, cols] + b1[cols])
                  for a, m in zip(attrs, masks))
        wacc = wacc + hid @ w2[cols]
    return wacc + msum[..., None] * b2, formed


@pytest.mark.parametrize("E,H", [(66, 66), (72, 72), (96, 96), (144, 144), (192, 192), (44, 44)])
def test_k1_wide_hidden_chunks_cover_every_unit_once(E, H):
    """The wide K1's hidden chunks form every hidden unit exactly once, and
    its grouping of the edge MLP (E padded to a multiple of four, the second
    product summed over the chunks) gives the plain version's edge weights
    to 1e-5 of their scale (f32)."""
    rng = np.random.default_rng(E + H)
    B, N, M, F = 2, 3, 5, 40
    f = lambda *shape: T(rng.normal(size=shape).astype(np.float32))
    attrs = [f(B, N, M, E) for _ in range(2)]
    masks = [T(rng.random((B, N, M)) > 0.3) for _ in range(2)]
    w1, b1, w2, b2 = f(E, H) / np.sqrt(E), f(H) * 0.1, f(H, F) / np.sqrt(H), f(F) * 0.1
    got, formed = _wide_edge_weights(attrs, masks, w1, b1, w2, b2)
    assert sorted(formed) == list(range(H))
    want = tp_fused.edge_weights(attrs, masks, w1, b1, w2, b2)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    assert not tp_fused.narrow(E, H, F) or (E, H) == (44, 44)


def _bf16(a):
    """a rounded to the nearest bf16, as f32."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _chunked_edge_weights(attrs, masks, w1, b1, w2, b2, hcw, bf16=False):
    """The redesigned wide K1's edge MLP in its order, in numpy: the rows of
    a tile, the hidden layer a chunk at a time from the staged weights
    (hcw units a chunk; 0: resident, f32 in chunks of 64, bf16 all H units
    in one pass; W1's rows zero-padded past E, its columns and W2's rows
    zero past H), each unit formed whole over E; f32: hid = sum_c mask_c relu(A_c
    W1 + b1), w += hid W2 over the chunks in order, then msum b2; bf16 (the
    weights rounded once, as they enter shared memory): channel by channel,
    h_c = relu(bf16(bf16(A_c W1) + b1)), w_c = bf16(bf16(h_c W2) + b2) mask_c
    (h_c W2 summed in f32 over the chunks), w = bf16(w_0 + w_1).  Returns w
    (rows, F) and the units the chunks formed, in order."""
    E, H = w1.shape
    hc_w = hcw or (H if bf16 else 64)
    ep = -(-E // (16 if bf16 else 4)) * (16 if bf16 else 4)
    if bf16:
        w1, b1, w2, b2 = (_bf16(v) for v in (w1, b1, w2, b2))
        attrs = [_bf16(a) for a in attrs]
    w1p = np.zeros((ep, -(-H // hc_w) * hc_w), np.float32)
    w1p[:E, :H] = w1
    w2p = np.zeros((w1p.shape[1], w2.shape[1]), np.float32)
    w2p[:H] = w2
    b1p = np.zeros(w1p.shape[1], np.float32)
    b1p[:H] = b1
    ap = [np.pad(a, ((0, 0), (0, ep - E))).astype(np.float32) for a in attrs]
    rows, F = ap[0].shape[0], w2.shape[1]
    acc = np.zeros((len(attrs) if bf16 else 1, rows, F), np.float32)
    formed = []
    for hc in range(0, H, hc_w):
        kn = min(hc_w, H - hc)
        formed += list(range(hc, hc + kn))
        w1c, w2c, b1c = w1p[:, hc:hc + hc_w], w2p[hc:hc + hc_w], b1p[hc:hc + hc_w]
        if bf16:
            for c, a in enumerate(ap):
                h = np.maximum(_bf16(_bf16(a @ w1c) + b1c), 0.0)
                h[:, kn:] = 0.0
                acc[c] += _bf16(h) @ w2c
        else:
            hid = sum(m[:, None] * np.maximum(a @ w1c + b1c, 0.0) for a, m in zip(ap, masks))
            hid[:, kn:] = 0.0
            acc[0] += hid @ w2c
    if not bf16:
        return acc[0] + sum(masks)[:, None] * b2, formed
    w = None
    for c, m in enumerate(masks):
        v = _bf16(_bf16(acc[c]) + b2) * m[:, None]
        w = v if w is None else _bf16(w + v)
    return w, formed


@pytest.mark.parametrize("hcw", [0, 64, 32, 16, 8])
@pytest.mark.parametrize("E,H", [(66, 66), (96, 96), (144, 144), (192, 192)])
def test_k1_wide_chunked_weights_reproduce_the_edge_mlp(E, H, hcw):
    """The redesigned wide K1's edge-MLP order (``_chunked_edge_weights``: a
    tile's rows, each hidden chunk from staged weights, or the resident
    ones) forms every hidden unit once and gives the parent
    wide kernel's grouping (``_wide_edge_weights``) to 1e-6 of scale in f32;
    in bf16, with the weights rounded once, it keeps the bf16 rounding points
    of the JAX package's conv: within 1e-2 of scale of ``edge_weights`` at
    bf16 (the JAX package's bf16 conv), most entries equal to the bit, and
    every entry a bf16 value."""
    rng = np.random.default_rng(E * 7 + hcw)
    rows, F = 32, 72
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    attrs = [f(rows, E) for _ in range(2)]
    masks = [(rng.random(rows) > 0.3).astype(np.float32) for _ in range(2)]
    w1, b1, w2, b2 = (v.astype(np.float32) for v in (f(E, H) / np.sqrt(E), f(H) * 0.1,
                                                     f(H, F) / np.sqrt(H), f(F) * 0.1))
    got, formed = _chunked_edge_weights(attrs, masks, w1, b1, w2, b2, hcw)
    assert formed == list(range(H))
    want, _ = _wide_edge_weights([T(a) for a in attrs], [T(m) for m in masks], T(w1), T(b1),
                                 T(w2), T(b2))
    assert float(np.abs(got - want.numpy()).max()) <= 1e-6 * float(want.abs().max())
    got_bf, _ = _chunked_edge_weights(attrs, masks, w1, b1, w2, b2, hcw, bf16=True)
    want_bf = tp_fused.edge_weights([T(a) for a in attrs], [T(m) for m in masks], T(w1), T(b1),
                                    T(w2), T(b2), torch.bfloat16).float().numpy()
    assert np.array_equal(got_bf, _bf16(got_bf))
    assert float(np.abs(got_bf - want_bf).max()) <= 1e-2 * float(np.abs(want_bf).max())
    assert float(np.mean(got_bf == want_bf)) >= 0.95


#: the model widths whose convs the K1 plans are checked at, l <= 1 and l = 2
PLAN_WIDTHS = [(22, 6), (24, 8), (32, 16), (48, 10), (64, 32)]


@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
@pytest.mark.parametrize("widths", PLAN_WIDTHS, ids=[f"{a}-{b}" for a, b in PLAN_WIDTHS])
def test_k1_wide_plan_keeps_weights_resident_where_they_fit(widths, l2):
    """On every conv of the model at these widths, one and two edge
    channels, f32 and bf16, dense and (phore-phore) sender-index, at the
    serving shapes: a wide launch's block fits 227 KB; its weights are
    resident where a block of MIN_SENDERS senders holds them, else staged in
    the widest chunks that fit (``WIDE_FORMS``); the forms' layouts differ
    by their weights (``wide_weights``: f32 W1 and the tile's W2 columns at
    their pitch, bf16 transposed at a conflict-free pitch, or two chunks)
    and, bf16, by the hidden rows (a chunk's, or the whole layer's where the
    weights are resident); and the convs of the two wide models phase 19
    serves (32 / 16, 48 / 10 at l = 2) keep their bf16 weights resident."""
    from diffphore_torch.models.layers import DenseTPConv
    from diffphore_torch.models.score_model import ScoreModel, ScoreModelConfig

    ns, nv = widths
    model = ScoreModel(ScoreModelConfig(ns=ns, nv=nv, use_second_order_repr=l2))
    pad = lambda n, m: -(-n // m) * m
    for name, conv in model.named_modules():
        if not (isinstance(conv, DenseTPConv) and conv.channelwise):
            continue
        tp = conv.tp
        E, H = conv.fc_w1.shape
        for indexed in (False, True) if ".phore_conv_" in name else (False,):
            for C in (1, 2):
                for esize in (4, 2):
                    B, N, M = (40, 96, 24) if indexed else (40, 24, 96)
                    pl = tp_fused.plan(tp, B, N, M, C, E, H, esize, indexed)
                    assert pl.smem <= tp_fused.SMEM == 227 * 1024, name
                    if not pl.wide:
                        assert pl.staged == 0
                        continue
                    size = lambda st, ms=tp_fused.MIN_SENDERS: tp_fused.wide_layout_bytes(
                        tp, C, E, H, esize, indexed, ms, st)
                    fit = [st for st in tp_fused.WIDE_FORMS if size(st) <= tp_fused.SMEM]
                    assert pl.staged == fit[0], (name, C, esize, indexed)
                    assert pl.smem == size(pl.staged, pl.per_block)
                    ftp = (tp_fused.wide_tile_pitch(tp) if tp_fused.lanes(tp) == 4
                           else tables_tiled_l2_ftp(tp))
                    rows = (tp_fused.ROWS if tp_fused.lanes(tp) == 4
                            else tp_fused.ROWS_L2_WIDE[esize])
                    for st in tp_fused.WIDE_FORMS:
                        hid = (0 if esize == 4 else 2 * C * rows * (
                            tp_fused._hid_pitch(H, st) - tp_fused._hid_pitch(H, 0)))
                        assert size(st) - size(0) == 4 * (
                            tp_fused.wide_weights(E, H, ftp, esize, st)
                            - tp_fused.wide_weights(E, H, ftp, esize, 0)) + hid
                    if esize == 4:
                        assert tp_fused.wide_weights(E, H, ftp, 4, 0) == (
                            pad(E, 4) * pad(H, 4) + pad(H, 4) * ftp)
                    else:
                        q1 = pad(E, 16) + 8
                        assert 2 * tp_fused.wide_weights(E, H, ftp, 2, 0) == (
                            pad(H, 8) * q1 + ftp * (pad(H, 16) + 8))
                        assert (q1 // 8) % 2 == 1 and ((pad(H, 16) + 8) // 8) % 2 == 1
                    if (ns, nv, l2) in ((32, 16, False), (48, 10, True)) and esize == 2:
                        assert pl.staged == 0, name


#: (lanes, operand bytes) -> the weight forms plan picks for the wide K1 on
#: FORM_GRID's convs: resident (0), else staged in chunks of that many units
FORMS_PICKED = {(4, 4): {0, 64, 32, 16, 8}, (4, 2): {0, 64, 32}, (8, 4): {0, 64, 32},
                (8, 2): {0, 64, 32}}
#: ns and nv of the models whose convs FORMS_PICKED lists, up to the kernels' ns <= 64
FORM_GRID = [(ns, nv) for ns in (22, 32, 40, 48, 56, 64) for nv in (2, 6, 10, 16, 24, 32)]


@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
def test_k1_wide_plan_picks_every_weight_form(l2):
    """The weight forms :func:`tp_fused.plan` picks for the wide kernel on
    every conv of the models of ``FORM_GRID`` (ns <= 64; a conv from each
    step of the irreps sequence to the next, one and two edge channels,
    dense and sender-index, f32 and bf16, at the serving shapes), by lane
    count and operand type, are those of ``FORMS_PICKED``: every form of
    ``WIDE_FORMS`` is picked somewhere.  The 8-unit chunk is picked only by
    f32 two-channel sender-index convs at 4 lanes (their sender rows of D
    floats take the room); the bf16 weights and the 8-lane ones never need
    chunks narrower than 32.  A shape that no form fits raises, naming the
    shared memory."""
    picked, by_eight = {}, set()
    for ns, nv in FORM_GRID:
        seq = _seq(ns, nv, l2)
        for i in range(len(seq)):
            tp = channelwise_tp(seq[i], SH, seq[min(i + 1, len(seq) - 1)])
            E = H = 3 * ns
            for C, indexed, esize in itertools.product((1, 2), (False, True), (4, 2)):
                B, N, M = (40, 96, 24) if indexed else (40, 24, 96)
                try:
                    pl = tp_fused.plan(tp, B, N, M, C, E, H, esize, indexed)
                except ValueError as e:
                    assert "shared memory" in str(e), e
                    continue
                if pl.wide:
                    picked.setdefault((tp_fused.lanes(tp), esize), set()).add(pl.staged)
                    if pl.staged == 8:
                        by_eight.add((tp_fused.lanes(tp), esize, C, indexed))
    want = {k: v for k, v in FORMS_PICKED.items() if k[0] == (8 if l2 else 4)}
    assert picked == want
    assert set().union(*picked.values()) <= set(tp_fused.WIDE_FORMS)
    assert by_eight == (set() if l2 else {(4, 4, 2, True)})
    if not l2:
        assert set().union(*FORMS_PICKED.values()) == set(tp_fused.WIDE_FORMS)


def tables_tiled_l2_ftp(tp):
    """The 8-lane K1's channel tile pitch (64 or 128)."""
    return tp_fused.tables_tiled_l2(tp)[-1][4]


@pytest.mark.parametrize("sig,splits", [("48-10-layer3", 1), ("64-32-layer2", 2)])
def test_tiled_k2_at_4_lanes_reproduces_the_plain_and_jax_aggregate_and_dx(sig, splits):
    """A 4-lane row wider than the split kernels' ``SPLIT_F_MAX`` takes the
    tiled forward and dx (``tp_aggregate.tiled``) at 4 lanes: read from their
    tables as the kernels read them, on several channel tiles, against
    ``tp_aggregate_plain`` and its gradient in x and the JAX package's
    aggregate and gradient, to 1e-5 of each result's scale."""
    irr_in, irr_out = WIDE_SIGNATURES[sig]
    tp = channelwise_tp(irr_in, SH, irr_out)
    assert tp_fused.lanes(tp) == 4 and tp_aggregate.tiled(tp)
    assert len(tp_fused.channel_tiles(tp)) > 1
    rng = np.random.default_rng(23)
    B, N, M = 2, 3, 5
    F, D = tp.weight_numel, tp.irreps_in.dim
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    x, sh = f(B, M, D), f(B, N, M, tp.irreps_sh.dim)
    w = f(B, N, M, F) * (rng.random((B, N, M, 1)) > 0.4).astype(np.float32)
    g, mask = _upstream(tp, rng, B, N, 4)
    got_out, got_dx = _tiled_k2(tp, T(x), T(sh), T(w), T(np.pad(g, [(0, 0)] * 3 + [(0, 4)])),
                                splits)
    got_out = got_out[..., :4]
    xl = T(x).requires_grad_(True)
    want = tp_aggregate.tp_aggregate_plain(tp, xl, T(sh), T(w))
    (want_dx,) = torch.autograd.grad(want, [xl], T(g * mask))
    for got_, want_ in ((got_out, want.detach()), (got_dx, want_dx)):
        assert float((got_ - want_).abs().max()) <= TOL * float(want_.abs().max())
    jt = jtp.channelwise_tp(irr_in, SH, irr_out)

    def jout(x_):
        return _jax_padded(tp, jt.aggregate(x_, jnp.asarray(sh), jnp.asarray(w)), 4)

    j_dx = np.asarray(jax.grad(lambda x_: (jout(x_) * g * mask).sum())(jnp.asarray(x)))
    for got_, want_ in ((got_out.numpy(), np.asarray(jout(jnp.asarray(x)))),
                        (got_dx.numpy(), j_dx)):
        assert float(np.abs(got_ - want_).max()) <= TOL * float(np.abs(want_).max())


@pytest.mark.parametrize("ns,nv", [(32, 16), (48, 10), (64, 32), (4, 32)])
def test_edge_slots_l2_fit_and_cover_the_senders(ns, nv):
    """The dense 8-lane edge backward's senders a block
    (``edge_slots_l2``): 32 where the block's rows fit, else the most of 24,
    16 and 8 that fit the shared memory beside P; the grid's blocks take
    every sender once."""
    for i in range(1, 4):
        tp = channelwise_tp(_seq(ns, nv, True)[i], SH, _seq(ns, nv, True)[min(i + 1, 3)])
        _, _, _, (PT, PS, _, _) = tp_aggregate.path_tables_l2(tp)
        D, F = tp.irreps_in.dim, tp.weight_numel
        for dsh in (False, True):
            slots = tp_aggregate.edge_slots_l2(tp, dsh)
            assert layouts.edge_l2_smem(dsh, D, F, PT, PS, slots) <= tp_fused.SMEM
            bigger = [s for s in (32, 24, 16, 8) if s > slots]
            assert all(layouts.edge_l2_smem(dsh, D, F, PT, PS, s) > tp_fused.SMEM
                       for s in bigger)
            for M in (1, 24, 96, 97):
                blocks, rn = tp_aggregate.edge_grid_l2(24, 96, M, slots=slots)
                taken = sorted(m for bx in range(-(-M // slots))
                               for m in range(bx * slots, min(M, (bx + 1) * slots)))
                assert taken == list(range(M)) and blocks == -(-M // slots) * -(-96 // rn) * 24
    assert tp_aggregate.edge_slots_l2(
        channelwise_tp(_seq(20, 10, True)[3], SH, _seq(20, 10, True)[3]), True) == 32


@pytest.mark.parametrize("ns", [32, 48, 64])
def test_k3_edge_l2_two_unit_groups_take_each_unit_once(ns):
    """Past 32 units of four channels (ns = 48, 64 at l = 2) the dense
    8-lane edge backward gives lane j units j and j + 32: every unit once;
    at most ``E2_UNITS``; the emulation of its arithmetic (the same per unit
    whatever its lane) against the plain version."""
    tp = channelwise_tp(_seq(ns, 10, True)[0], SH, _seq(ns, 10, True)[1])
    G = len(tp_scalar.units_l2(tp).units)
    assert G <= tp_scalar.E2_UNITS and (G > 32) == (ns > 32)
    lanes = [j + 32 * ug for j in range(32) for ug in range(2 if G > 32 else 1) if j + 32 * ug < G]
    assert sorted(lanes) == list(range(G))
    tp_scalar.check_edge(tp, False)
    rng = np.random.default_rng(ns)
    B, N, M = 2, 3, 4
    x = rng.normal(size=(B, M, tp.irreps_in.dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, 9)).astype(np.float32)
    w = rng.normal(size=(B, N, M, tp.weight_numel)).astype(np.float32)
    g, _ = _upstream(tp, rng, B, N, 8)
    dw, dsh = _k3_edge_l2(tp, T(x), T(sh), T(w), T(g))
    want_dw, want_dsh = tp_scalar.scalar_paths_backward_edge_plain(tp, T(x), T(sh), T(w), T(g),
                                                                   True)
    for got, want in ((dw, want_dw), (dsh, want_dsh)):
        assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


def _k3_idx(tp, x, sh, w, idx, g, SL, MC, lanes):
    """The sender-index K3 forward's and dw's f32 arithmetic in the kernel's
    grouping (``tp_scalar_idx_kernel``), in plain PyTorch: per receiver and
    unit, its slots in chunks of MC, slice s taking slots s, s + SL, ... of
    each chunk in order (x read at the index), the slices added in order,
    times c_p; dw = x sum_k sh[off + k] c_p g[k] slot by slot."""
    t = tp_scalar.units_l2(tp)
    B, N, K, _ = sh.shape
    xg = torch.stack([x[b][idx[b].long()] for b in range(B)])          # (B, N, K, D)
    out = torch.zeros((B, N, tp.weight_numel, lanes))
    dw = torch.zeros_like(w)
    for (f0, d0, off, kc), c in zip(t.units.tolist(), t.scale.tolist()):
        Kp, cnt = kc & 7, kc >> 3
        term = (xg[..., d0:d0 + cnt] * w[..., f0:f0 + cnt])[..., None] * sh[..., None, off:off + Kp]
        total = torch.zeros((B, N, cnt, Kp))
        for s in range(SL):
            acc = torch.zeros((B, N, cnt, Kp))
            for c0 in range(0, K, MC):
                for m in range(c0 + s, min(K, c0 + MC), SL):
                    acc = acc + term[:, :, m]
            total = total + acc
        out[:, :, f0:f0 + cnt, :Kp] = c * total
        coef = c * g[:, :, None, f0:f0 + cnt, :Kp]
        dw[..., f0:f0 + cnt] = xg[..., d0:d0 + cnt] * (sh[..., None, off:off + Kp] * coef).sum(-1)
    return out, dw


@pytest.mark.parametrize("ns,l2", [(20, False), (48, False), (64, True), (7, True)],
                         ids=["20-4-lanes", "48-4-lanes", "64-8-lanes", "7-8-lanes"])
def test_k3_idx_plan_and_grouping_match_the_plain_and_jax(ns, l2):
    """The sender-index K3 forward and dw (``tp_scalar_idx_kernel``): its
    plan (``plan_idx``) keeps a block within ``F2_THREADS`` threads and 48
    KB, its chunks (a multiple of the slices) and slices take every slot
    once, and its grouping of the arithmetic gives the plain version's and
    the JAX package's forward and dw on an uneven index (most slots on a few
    senders) to 1e-5 of their scale; odd widths (ns = 7: units of three)
    too."""
    tp = channelwise_tp(_seq(ns, 4, l2)[0], SH, _seq(ns, 4, l2)[1])
    lanes = 8 if l2 else 4
    assert tp_fused.lanes(tp) == lanes and tp_scalar.all_scalar_paths(tp)
    G = len(tp_scalar.units_l2(tp).units)
    S, D, F = tp.irreps_sh.dim, tp.irreps_in.dim, tp.weight_numel
    for (B, N, K), dw in itertools.product(((24, 96, 24), (40, 96, 24), (1, 1, 1), (3, 37, 50)),
                                           (False, True)):
        R, SL, MC = tp_scalar.plan_idx(tp, B, N, K, dw)
        assert R * SL * G <= tp_scalar.F2_THREADS and MC % SL == 0 and R <= N
        # a thread takes at most IDX_SLOTS (dw: IDX_SLOTS_DW) slots of a chunk, unless the
        # block's threads forbid
        most = tp_scalar.IDX_SLOTS_DW if dw else tp_scalar.IDX_SLOTS
        assert -(-min(K, MC) // SL) <= most or (SL + 1) * G > tp_scalar.F2_THREADS
        assert tp_scalar.idx_smem(dw, R, SL, F, MC, S) <= 48 * 1024
        taken = sorted(m for c0 in range(0, K, MC) for s in range(SL)
                       for m in range(c0 + s, min(K, c0 + MC), SL))
        assert taken == list(range(K))
    rng = np.random.default_rng(ns + lanes)
    B, N, K, Mx = 2, 5, 7, 6
    hot = rng.integers(0, Mx, 2)
    idx = np.where(rng.random((B, N, K)) < 0.6, hot[rng.integers(0, 2, (B, N, K))],
                   rng.integers(0, Mx, (B, N, K))).astype(np.int32)
    x = rng.normal(size=(B, Mx, D)).astype(np.float32)
    sh = rng.normal(size=(B, N, K, S)).astype(np.float32)
    w = (rng.normal(size=(B, N, K, F)) * (rng.random((B, N, K, 1)) > 0.3)).astype(np.float32)
    g, mask = _upstream(tp, rng, B, N, lanes)
    for SL, MC in ((1, 7), (3, 3), (2, 4)):
        out, dw = _k3_idx(tp, T(x), T(sh), T(w), T(idx), T(g), SL, MC, lanes)
        want = tp_scalar.scalar_paths_aggregate_plain(tp, T(x), T(sh), T(w), T(idx))
        want_dw, _ = tp_scalar.scalar_paths_backward_edge_plain(tp, T(x), T(sh), T(w), T(g),
                                                                False, sender_index=T(idx))
        for got, ref in ((out, want), (dw, want_dw)):
            assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())
    jt = jtp.channelwise_tp(_seq(ns, 4, l2)[0], SH, _seq(ns, 4, l2)[1])
    xg = jnp.asarray(np.stack([x[b][idx[b]] for b in range(B)]))    # the senders by slot

    def jout(w_):
        return _jax_padded(tp, jt.aggregate(xg, jnp.asarray(sh), w_), lanes)

    jdw = np.asarray(jax.grad(lambda w_: (jout(w_) * g * mask).sum())(jnp.asarray(w)))
    for got, ref in ((out.numpy(), np.asarray(jout(jnp.asarray(w)))), (dw.numpy(), jdw)):
        assert float(np.abs(got - ref).max()) <= TOL * float(np.abs(ref).max())
