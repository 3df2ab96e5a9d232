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

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_kernel_layouts as layouts
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
