"""K1, the fused edge-MLP + channelwise tensor-product aggregate
(diffphore_torch/ops/tp_fused.py): its plain PyTorch version against the
JAX package's Pallas kernel (interpret mode) + blocks_from_padded and
against the JAX einsum form ChannelwiseTP.aggregate, at every conv
signature of the corpus2 forward.  The CUDA kernel itself is held against
the plain version by tests/test_torch_cuda.py and by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffphore_torch.ops import tp_fused as ttp
from diffphore_torch.ops.tensor_product import channelwise_tp as t_channelwise_tp
from diffphore_tpu.ops.pallas.tp_aggregate import blocks_from_padded
from diffphore_tpu.ops.pallas.tp_fused import tp_aggregate_fused
from diffphore_tpu.ops.tensor_product import channelwise_tp

torch.set_num_threads(1)

SEQ = ["20x0e", "20x0e + 10x1o", "20x0e + 10x1o + 10x1e", "20x0e + 10x1o + 10x1e + 20x0o"]
SH = "1x0e + 1x1o + 1x2e"
TOR_SH = "1x1o + 1x0e + 1x1e"
#: (in irreps, out irreps, sh irreps, E = H) of the six signatures
SIGNATURES = {
    "layer0": (SEQ[0], SEQ[1], SH, 60),
    "layer1": (SEQ[1], SEQ[2], SH, 60),
    "layer2": (SEQ[2], SEQ[3], SH, 60),
    "layer3": (SEQ[3], SEQ[3], SH, 60),
    "final_conv": (SEQ[3], "2x1o + 2x1e", SH, 40),
    "tor_bond_conv": (SEQ[3], "20x0o + 20x0e", TOR_SH, 60),
}
# plain K1 vs the JAX kernel / einsum: both f32, summation order differs
RTOL = 2e-5


def _inputs(sig, n_chan, B=2, N=10, M=12, seed=0):
    """N = 10 is not a multiple of the Pallas tile (8)."""
    irr_in, irr_out, irr_sh, E = SIGNATURES[sig]
    tp = channelwise_tp(irr_in, irr_sh, irr_out)
    rng = np.random.default_rng(seed)
    F, H = tp.weight_numel, E
    x = rng.normal(size=(B, M, tp.irreps_in.dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, tp.irreps_sh.dim)).astype(np.float32)
    attrs = [rng.normal(size=(B, N, M, E)).astype(np.float32) for _ in range(n_chan)]
    masks = [rng.random((B, N, M)) > 0.3 for _ in range(n_chan)]
    w1 = (rng.normal(size=(E, H)) * 0.2).astype(np.float32)
    b1 = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(H, F)) * 0.2).astype(np.float32)
    b2 = (rng.normal(size=(F,)) * 0.1).astype(np.float32)
    return tp, t_channelwise_tp(irr_in, irr_sh, irr_out), (x, sh, attrs, masks, w1, b1, w2, b2)


def _port(tp_t, args):
    x, sh, attrs, masks, w1, b1, w2, b2 = args
    t = torch.from_numpy
    return ttp.tp_aggregate_fused(tp_t, t(x), t(sh), [t(a) for a in attrs],
                                  [t(m) for m in masks], t(w1), t(b1), t(w2), t(b2))


def _close(got, ref, what):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max())
    assert err <= RTOL * scale, f"{what}: {err:.3e} > {RTOL} * {scale:.3e}"


@pytest.mark.parametrize("sig", list(SIGNATURES))
@pytest.mark.parametrize("n_chan", [1, 2])
def test_plain_matches_pallas_kernel(sig, n_chan):
    tp, tp_t, args = _inputs(sig, n_chan)
    x, sh, attrs, masks, w1, b1, w2, b2 = args
    ref = tp_aggregate_fused(tp, jnp.asarray(x), jnp.asarray(sh),
                             tuple(jnp.asarray(a) for a in attrs),
                             tuple(jnp.asarray(m) for m in masks),
                             jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
                             tile_n=8, interpret=True)
    got = _port(tp_t, args)
    assert got.shape == ref.shape and got.dtype == torch.float32
    _close(got.numpy(), ref, f"{sig} C={n_chan}")
    # blocks_from_padded: the port's split equals the JAX split
    for gb, rb in zip(ttp.blocks_from_padded(tp_t, got), blocks_from_padded(tp, ref)):
        assert (gb is None) == (rb is None)
        if rb is not None:
            _close(gb.numpy(), rb, f"{sig} blocks")


@pytest.mark.parametrize("sig", list(SIGNATURES))
def test_plain_matches_einsum_aggregate(sig):
    """Against the JAX einsum path: explicit edge MLP + ChannelwiseTP.aggregate,
    and against the port's own torch ChannelwiseTP.aggregate."""
    tp, tp_t, args = _inputs(sig, 2, seed=1)
    x, sh, attrs, masks, w1, b1, w2, b2 = args
    w = 0.0
    for a, m in zip(attrs, masks):
        h = np.maximum(a @ w1 + b1, 0.0)
        w = w + (h @ w2 + b2) * m[..., None]
    w = w.astype(np.float32)
    ref_blocks = tp.aggregate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w))
    own_blocks = tp_t.aggregate(torch.from_numpy(x), torch.from_numpy(sh), torch.from_numpy(w))
    got_blocks = ttp.blocks_from_padded(tp_t, _port(tp_t, args))
    for gb, ob, rb in zip(got_blocks, own_blocks, ref_blocks):
        assert (gb is None) == (rb is None) == (ob is None)
        if rb is not None:
            _close(gb.numpy(), rb, f"{sig} fused vs einsum")
            _close(ob.numpy(), rb, f"{sig} torch aggregate vs jax aggregate")


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    tp, tp_t, args = _inputs("layer1", 2, B=1, N=3, M=5)
    before = ttp.KERNEL.launches
    got = _port(tp_t, args)
    x, sh, attrs, masks, w1, b1, w2, b2 = args
    t = torch.from_numpy
    plain = ttp.tp_aggregate_fused_plain(tp_t, t(x), t(sh), [t(a) for a in attrs],
                                         [t(m) for m in masks], t(w1), t(b1), t(w2), t(b2))
    assert torch.equal(got, plain)
    assert ttp.KERNEL.launches == before


def test_rejects_l2_irreps():
    """Irreps of l = 2 take the 8-lane layout (five components a channel,
    padded to 8); beyond l = 2 the product is refused."""
    args = (torch.zeros(1, 2, 2, 9), [torch.zeros(1, 2, 2, 4)], [torch.ones(1, 2, 2)],
            torch.zeros(4, 4), torch.zeros(4), torch.zeros(4, 8), torch.zeros(8))
    tp_t = t_channelwise_tp("4x0e + 2x2e", SH, "4x0e")
    out = ttp.tp_aggregate_fused_plain(tp_t, torch.zeros(1, 2, 14), *args)
    assert out.shape == (1, 2, tp_t.weight_numel, 8)
    tp_3 = t_channelwise_tp("4x0e + 2x3o", SH, "4x0e")
    with pytest.raises(ValueError, match="l_in, l_out <= 2"):
        ttp.tp_aggregate_fused_plain(tp_3, torch.zeros(1, 2, 18), *args)



#: (B, N, M) of the serving forward's convs (40 poses of a 24 x 96 x 8
#: complex), then ragged and tiny shapes
PLAN_SHAPES = [(40, 24, 24), (40, 24, 96), (40, 96, 96), (40, 96, 24), (40, 1, 24), (40, 8, 24),
               (1, 96, 96), (3, 37, 29), (1, 9, 3), (2, 21, 97), (512, 24, 96), (1, 1, 1),
               (2, 24, 300)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_senders_covers_the_senders_and_fills_the_card(shape):
    """The sender split of a K1 launch: the ranges tile [0, M) without an
    empty block, stay within the kernel's limits, and give two blocks per SM
    wherever MIN_SENDERS senders per block allow it."""
    B, N, M = shape
    per_block, splits = ttp.plan_senders(B, N, M)
    assert 1 <= per_block <= ttp.MAX_SENDERS
    assert splits * per_block >= M > (splits - 1) * per_block
    tiles = B * -(-N // ttp.TILE_N)
    if splits > 1:                       # never fewer senders than the floor allows
        assert per_block >= min(M, ttp.MIN_SENDERS)
    if tiles * splits < ttp.TARGET_BLOCKS:   # short of the target only at the floor
        assert per_block <= ttp.MIN_SENDERS or M <= ttp.MIN_SENDERS
    if tiles * -(-M // ttp.MAX_SENDERS) >= ttp.TARGET_BLOCKS:   # wide enough: most senders
        assert splits == -(-M // ttp.MAX_SENDERS)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_senders_at_the_8_lane_kernels_limits(shape):
    """The same split with the 8-lane kernel's tile and sender cap
    (TILE_N_L2, MAX_SENDERS_L2): the ranges tile [0, M), stay within the cap
    and fill the card as far as MIN_SENDERS allows."""
    B, N, M = shape
    per_block, splits = ttp.plan_senders(B, N, M, ttp.TILE_N_L2, ttp.MAX_SENDERS_L2)
    assert 1 <= per_block <= ttp.MAX_SENDERS_L2
    assert splits * per_block >= M > (splits - 1) * per_block
    tiles = B * -(-N // ttp.TILE_N_L2)
    if splits > 1:
        assert per_block >= min(M, ttp.MIN_SENDERS)
    if tiles * splits < ttp.TARGET_BLOCKS:
        assert per_block <= ttp.MIN_SENDERS or M <= ttp.MIN_SENDERS
    if tiles * -(-M // ttp.MAX_SENDERS_L2) >= ttp.TARGET_BLOCKS:
        assert splits == -(-M // ttp.MAX_SENDERS_L2)


@pytest.mark.parametrize("n_chan", [1, 2])
def test_float_masks_weigh_the_hidden_sum_and_the_bias(n_chan):
    """Masks are read as they come: a float mask is a weight on its
    channel's hidden activations and on b2, as in the function's definition;
    a bool mask is the weights 0 and 1."""
    _, tp_t, (x, sh, attrs, masks, w1, b1, w2, b2) = _inputs("layer1", n_chan)
    rng = np.random.default_rng(7)
    weights = [m * rng.random(m.shape).astype(np.float32) for m in masks]
    t = torch.from_numpy
    got = ttp.tp_aggregate_fused(tp_t, t(x), t(sh), [t(a) for a in attrs],
                                 [t(v.astype(np.float32)) for v in weights],
                                 t(w1), t(b1), t(w2), t(b2)).numpy()
    hid = sum(np.maximum(a @ w1 + b1, 0.0) * v[..., None] for a, v in zip(attrs, weights))
    w = hid @ w2 + sum(weights)[..., None] * b2
    blocks = tp_t.aggregate(t(x), t(sh), t(w.astype(np.float32)))
    ref = ttp.blocks_from_padded(tp_t, torch.from_numpy(got))
    for b_ref, b_got in zip(blocks, ref):
        if b_ref is not None:
            _close(b_got.numpy(), b_ref.numpy(), f"float masks, C = {n_chan}")
    as_bool = _port(tp_t, (x, sh, attrs, masks, w1, b1, w2, b2)).numpy()
    as_float = _port(tp_t, (x, sh, attrs, [m.astype(np.float32) for m in masks],
                            w1, b1, w2, b2)).numpy()
    np.testing.assert_array_equal(as_bool, as_float)
