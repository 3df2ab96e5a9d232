"""K2's plain version (``diffphore_torch.ops.tp_aggregate``) against the JAX
package: the Pallas kernel ``tp_aggregate_pallas`` in interpret mode, the
einsum form ``ChannelwiseTP.aggregate``, and ``jax.grad`` of the latter for
the gradients that the CUDA backward kernels are held against on the card.
Everything is f32; tolerances are relative to each result's scale and cover
summation order only."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.ops import tp_aggregate, tp_fused
from diffphore_torch.ops.tensor_product import channelwise_tp as t_channelwise_tp
from diffphore_tpu.ops.pallas.tp_aggregate import tp_aggregate_pallas
from diffphore_tpu.ops.tensor_product import channelwise_tp as j_channelwise_tp

from torch_port_helpers import assert_close

torch.set_num_threads(1)

SH = "1x0e + 1x1o + 1x2e"
SEQ = ["8x0e", "8x0e + 4x1o", "8x0e + 4x1o + 4x1e", "8x0e + 4x1o + 4x1e + 8x0o"]
SIGNATURES = {
    "layer0": (SEQ[0], SH, SEQ[1]),
    "layer2": (SEQ[2], SH, SEQ[3]),
    "layer3": (SEQ[3], SH, SEQ[3]),
    "final_conv": (SEQ[3], SH, "2x1o + 2x1e"),
    "tor_bond_conv": (SEQ[3], "1x1o + 1x0e + 1x1e", "8x0o + 8x0e"),
}
T = lambda a: torch.from_numpy(np.asarray(a).copy())


def _inputs(sig, B, N, M, seed=0):
    irr_in, irr_sh, irr_out = SIGNATURES[sig]
    jtp = j_channelwise_tp(irr_in, irr_sh, irr_out)
    ttp = t_channelwise_tp(irr_in, irr_sh, irr_out)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, M, jtp.irreps_in.dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, jtp.irreps_sh.dim)).astype(np.float32)
    w = rng.normal(size=(B, N, M, jtp.weight_numel)).astype(np.float32)
    w *= rng.random((B, N, M, 1)) > 0.3          # pre-masked edge weights
    return jtp, ttp, x, sh, w


@pytest.mark.parametrize("sig", list(SIGNATURES))
@pytest.mark.parametrize("N", [12, 13])        # 13: not a multiple of tile_n = 4
def test_plain_matches_pallas_kernel_in_interpret_mode(sig, N):
    """1e-5 of the output scale: both sum M = 24 f32 products per element."""
    jtp, ttp, x, sh, w = _inputs(sig, 2, N, 24)
    ref = tp_aggregate_pallas(jtp, jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w),
                              tile_n=4, interpret=True)
    got = tp_aggregate.tp_aggregate(ttp, T(x), T(sh), T(w))      # CPU tensors: plain version
    assert got.shape == (2, N, ttp.weight_numel, tp_fused.K_PAD)
    assert_close(got, ref, 1e-5, f"{sig} N={N}")


@pytest.mark.parametrize("sig", list(SIGNATURES))
def test_plain_matches_aggregate_blocks(sig):
    """Split back into irrep blocks it is ChannelwiseTP.aggregate (1e-5),
    and the lanes beyond 2*l_out+1 are zero."""
    jtp, ttp, x, sh, w = _inputs(sig, 3, 7, 9, seed=1)
    want = jtp.aggregate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w))
    padded = tp_aggregate.tp_aggregate_plain(ttp, T(x), T(sh), T(w))
    got = tp_fused.blocks_from_padded(ttp, padded)
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        assert (g is None) == (wv is None)
        if g is not None:
            assert_close(g, wv, 1e-5, sig)
    for p in ttp.paths:
        assert float(padded[:, :, p.w_slice[0]:p.w_slice[1], 2 * p.l_out + 1:].abs().max()) == 0.0


@pytest.mark.parametrize("sig", list(SIGNATURES))
def test_plain_gradients_match_jax_grad(sig):
    """d/dx, d/dsh, d/dw of <aggregate, g> for a seeded upstream gradient g:
    autograd through the plain version against jax.grad of
    ChannelwiseTP.aggregate, 2e-5 of each gradient's scale."""
    jtp, ttp, x, sh, w = _inputs(sig, 2, 6, 10, seed=2)
    rng = np.random.default_rng(3)
    want_blocks = jtp.aggregate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w))
    gs = [None if b is None else rng.normal(size=b.shape).astype(np.float32) for b in want_blocks]

    def jloss(x_, sh_, w_):
        blocks = jtp.aggregate(x_, sh_, w_)
        return sum((b * g).sum() for b, g in zip(blocks, gs) if b is not None)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w))

    leaves = [T(v).requires_grad_(True) for v in (x, sh, w)]
    blocks = tp_fused.blocks_from_padded(ttp, tp_aggregate.tp_aggregate(ttp, *leaves))
    loss = sum((b * T(g)).sum() for b, g in zip(blocks, gs) if b is not None)
    got = torch.autograd.grad(loss, leaves)
    for name, g, r in zip(("dx", "dsh", "dw"), got, ref):
        assert_close(g, r, 2e-5, f"{sig} {name}")


def test_backward_tables_cover_every_input_element():
    """The dx kernel's reader lists: every (channel, component) appears once,
    under the input element it reads."""
    ttp = t_channelwise_tp(*SIGNATURES["layer3"])
    chan, _ = tp_fused._tables(ttp)
    ptab, d_ptr, d_item = tp_aggregate._backward_tables(ttp)
    assert d_ptr[0] == 0 and d_ptr[-1] == len(d_item) == int(chan[:, 1].sum())
    seen = set()
    for d in range(ttp.irreps_in.dim):
        for it in d_item[d_ptr[d]:d_ptr[d + 1]]:
            f, i = divmod(int(it), 4)
            assert chan[f, 0] + i == d and i < chan[f, 1]
            seen.add((f, i))
    assert len(seen) == len(d_item)
    for q, p in enumerate(ttp.paths):
        assert tuple(ptab[q]) == (p.w_slice[0], p.mul_in, 2 * p.l_sh + 1, 2 * p.l_out + 1)


def test_fused_plain_stays_differentiable_on_cpu():
    """K1's CUDA launch refuses grad-requiring inputs; its plain version on
    CPU tensors keeps working under autograd."""
    ttp = t_channelwise_tp(*SIGNATURES["layer0"])
    rng = np.random.default_rng(4)
    B, N, M, E, H = 1, 3, 4, 6, 5
    x = T(rng.normal(size=(B, M, ttp.irreps_in.dim)).astype(np.float32))
    sh = T(rng.normal(size=(B, N, M, 9)).astype(np.float32))
    attr = T(rng.normal(size=(B, N, M, E)).astype(np.float32))
    mask = torch.ones(B, N, M, dtype=torch.bool)
    w1 = T(rng.normal(size=(E, H)).astype(np.float32)).requires_grad_(True)
    b1, b2 = torch.zeros(H), torch.zeros(ttp.weight_numel)
    w2 = T(rng.normal(size=(H, ttp.weight_numel)).astype(np.float32))
    out = tp_fused.tp_aggregate_fused(ttp, x, sh, [attr], [mask], w1, b1, w2, b2)
    (grad,) = torch.autograd.grad(out.sum(), [w1])
    assert grad.shape == w1.shape and float(grad.abs().max()) > 0


@pytest.mark.parametrize("shape,expected", [
    ((24, 24, 96), 16), ((24, 96, 96), 16), ((24, 96, 24), 16), ((24, 24, 24), 4),
    ((24, 1, 24), 2), ((24, 8, 24), 2), ((3, 37, 29), 2), ((2000, 24, 24), 16)])
def test_plan_edge_senders(shape, expected):
    """The most senders per block that still gives two blocks per SM, else
    the fewest the kernel's pairs of senders allow."""
    B, N, M = shape
    mt = tp_aggregate.plan_edge_senders(B, N, M)
    assert mt == expected and mt in tp_aggregate.EDGE_SENDERS
    blocks = B * -(-N // tp_fused.TILE_N) * -(-M // mt)
    assert blocks >= tp_fused.TARGET_BLOCKS or mt == min(tp_aggregate.EDGE_SENDERS)


@pytest.mark.parametrize("sig", list(SIGNATURES))
def test_dsh_segments_reproduce_the_harmonics_gradient(sig):
    """The dsh kernel's list of (path, term) per harmonic component: every
    term of every path stands once, under the component of sh it reads, and
    adding the paths' partial sums as the kernel does gives autograd's dsh."""
    ttp = t_channelwise_tp(*SIGNATURES[sig])
    seg_ptr, seg = tp_aggregate._dsh_segments(ttp)
    chan, gtab = tp_fused._tables(ttp)
    ptab, _, _ = tp_aggregate._backward_tables(ttp)
    S = ttp.irreps_sh.dim
    assert seg_ptr[0] == 0 and seg_ptr[-1] == len(seg) == sum(2 * p.l_sh + 1 for p in ttp.paths)
    listed = set()
    for s in range(S):
        for q, j in seg[seg_ptr[s]:seg_ptr[s + 1]]:
            assert chan[ptab[q, 0], 2] + j == s and j < ptab[q, 2]
            listed.add((int(q), int(j)))
    assert listed == {(q, j) for q, p in enumerate(ttp.paths) for j in range(2 * p.l_sh + 1)}

    B, N, M = 1, 2, 3
    _, _, x, sh, w = _inputs(sig, B, N, M, seed=5)
    rng = np.random.default_rng(6)
    g = rng.normal(size=(B, N, ttp.weight_numel, 4)).astype(np.float32)
    for p in ttp.paths:
        g[:, :, p.w_slice[0]:p.w_slice[1], 2 * p.l_out + 1:] = 0.0
    leaf = T(sh).requires_grad_(True)
    out = tp_aggregate.tp_aggregate_plain(ttp, T(x), leaf, T(w))
    (ref,) = torch.autograd.grad(out, [leaf], T(g))
    # the paths' partial sums: part[q][b,n,m,j] = sum_u w[f] sum_i P[n,f,i,j] x[m,x_base(f)+i]
    P = np.einsum("fijk,bnfk->bnfij", gtab[chan[:, 3]], g[..., :3])
    part = []
    for f0, count, d_sh, _ in ptab:
        acc = np.zeros(sh.shape[:3] + (5,), np.float32)
        for f in range(f0, f0 + count):
            x_base, d_in = chan[f, 0], chan[f, 1]
            t = np.einsum("bnij,bmi->bnmj", P[:, :, f, :d_in], x[:, :, x_base:x_base + d_in])
            acc += w[..., f, None] * t
        part.append(acc)
    got = np.zeros_like(sh)
    for s in range(S):
        for q, j in seg[seg_ptr[s]:seg_ptr[s + 1]]:
            got[..., s] += part[q][..., j]
    assert_close(got, ref.numpy(), 2e-5, f"{sig} dsh from the paths' partial sums")


#: (conv, B, N, M) of the 17 K2 convs of a training-mode forward at batch 24
#: (corpus2, bucket 24 x 96 x 8), then ragged, N = 1, N = 8 and B = 1 shapes
TRAINING_K2_SHAPES = (
    [(f"lig_conv_{i}", 24, 24, 24) for i in (1, 2, 3)]
    + [(f"phore_to_lig{n}_conv_{i}", 24, 24, 96) for n in ("", "_norm") for i in (1, 2, 3)]
    + [(f"phore_conv_{i}", 24, 96, 96) for i in (1, 2)]
    + [(f"lig_to_phore{n}_conv_{i}", 24, 96, 24) for n in ("", "_norm") for i in (1, 2)]
    + [("final_conv", 24, 1, 24), ("tor_bond_conv", 24, 8, 24)])
SPLIT_SHAPES = TRAINING_K2_SHAPES + [
    ("ragged", 3, 37, 29), ("N=1, B=1", 1, 1, 24), ("N=8, B=1", 1, 8, 24), ("B=1", 1, 96, 96),
    ("one sender", 24, 24, 1)]


@pytest.mark.parametrize("name,B,N,M", SPLIT_SHAPES)
@pytest.mark.parametrize("target", [tp_fused.TARGET_BLOCKS, 5 * 132])
def test_plan_splits(name, B, N, M, target):
    """The forward splits the senders, dx the receivers: split k takes k,
    k + splits, ...; every entry of the summed axis falls in exactly one
    non-empty split; the fewest splits that give ``target`` blocks of (batch
    row, KEEP kept entries, split) where the summed axis holds a tile for
    each, else one split per tile (a split of its own for a short axis).
    ``target`` is two blocks per SM, or what the card holds at once (five
    per SM at F = 80)."""
    for kept, summed in ((N, M), (M, N)):
        splits = tp_aggregate.plan_splits(B, kept, summed, target)
        assert 1 <= splits <= max(1, summed // tp_aggregate.TILE_SUM)
        members = [list(range(k, summed, splits)) for k in range(splits)]
        assert all(members)
        assert sorted(i for m in members for i in m) == list(range(summed))
        tiles = B * -(-kept // tp_aggregate.KEEP)
        wanted = -(-target // tiles)
        if summed >= tp_aggregate.TILE_SUM * wanted:
            assert tiles * splits >= target
            assert splits == 1 or tiles * (splits - 1) < target
            assert all(len(m) >= tp_aggregate.TILE_SUM for m in members)
        else:
            assert splits == max(1, summed // tp_aggregate.TILE_SUM)


def _split_schedule(ttp, x, sh, w, g, splits_fwd, splits_dx):
    """The forward and dx as the kernels order them, in numpy: per (edge,
    path) t[i,k] = sum_j G[i,j,k] sh[j]; the forward adds w x t over each
    sender split (split k: senders k, k + splits, ...), dx adds w t g over
    each receiver split and then the channels that read one input element in
    the order of the d_ptr / d_item list; the splits are added in order."""
    chan, gtab = tp_fused._tables(ttp)
    ptab, d_ptr, d_item = tp_aggregate._backward_tables(ttp)
    B, N, M, _ = sh.shape
    F, D = ttp.weight_numel, ttp.irreps_in.dim
    t = np.zeros((B, N, M, len(ptab), 3, 3), np.float32)      # [.., path, i, k]
    for q, (f0, _, d_sh, _) in enumerate(ptab):
        off = chan[f0, 2]
        t[..., q, :, :] = np.einsum("ijk,bnmj->bnmik", gtab[q, :, :d_sh], sh[..., off:off + d_sh])
    d_in = chan[:, 1]
    mask_in = (np.arange(3)[None, :] < d_in[:, None]).astype(np.float32)     # (F, 3)
    xf = np.stack([x[..., np.minimum(chan[:, 0] + i, D - 1)] for i in range(3)], -1) * mask_in
    tf = t[..., chan[:, 3], :, :]                                            # (B, N, M, F, 3, 3)
    out = np.zeros((B, N, F, 4), np.float32)
    for k in range(splits_fwd):
        ms = list(range(k, M, splits_fwd))
        part = np.einsum("bnmf,bmfi,bnmfik->bnfk", w[:, :, ms], xf[:, ms], tf[:, :, ms])
        out[..., :3] += part
    d_out = ptab[chan[:, 3], 3]
    gm = g[..., :3] * (np.arange(3)[None, :] < d_out[:, None])
    dx = np.zeros((B, M, D), np.float32)
    for k in range(splits_dx):
        ns = list(range(k, N, splits_dx))
        per = np.einsum("bnmf,bnmfik,bnfk->bmfi", w[:, ns], tf[:, ns], gm[:, ns])
        part = np.zeros((B, M, D), np.float32)
        for d in range(D):
            for it in d_item[d_ptr[d]:d_ptr[d + 1]]:
                part[..., d] += per[..., it >> 2, it & 3]
        dx += part
    return out, dx


@pytest.mark.parametrize("sig", list(SIGNATURES))
def test_split_schedule_matches_plain(sig):
    """The kernels' factorization and order, modelled in numpy, against the
    plain version and autograd through it (1e-5 of scale), with the splits
    the kernels would take and with others."""
    B, N, M = 2, 11, 13
    jtp, ttp, x, sh, w = _inputs(sig, B, N, M, seed=7)
    rng = np.random.default_rng(8)
    g = rng.normal(size=(B, N, ttp.weight_numel, 4)).astype(np.float32)
    lanes = np.zeros_like(g)
    for p in ttp.paths:
        lanes[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    leaf = T(x).requires_grad_(True)
    ref = tp_aggregate.tp_aggregate_plain(ttp, leaf, T(sh), T(w))
    (ref_dx,) = torch.autograd.grad(ref, [leaf], T(g * lanes))
    for splits in ((tp_aggregate.plan_splits(B, N, M), tp_aggregate.plan_splits(B, M, N)),
                   (1, 1), (3, 4)):
        out, dx = _split_schedule(ttp, x, sh, w, g, *splits)
        assert_close(out, ref.detach().numpy(), 1e-5, f"{sig} forward, splits {splits}")
        assert_close(dx, ref_dx.numpy(), 1e-5, f"{sig} dx, splits {splits}")
