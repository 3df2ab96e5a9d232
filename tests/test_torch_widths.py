"""Model widths on the kernels: every convolution of the port's ScoreModel
at ns / nv up to 64 / 32, l <= 1 and l = 2, dense and sender-index, passes
the kernels' host-side shape checks and plans (no card: the checks are
shape arithmetic), a shape past the kernels' reach still raises, naming its
limit.  (tests/test_torch_wide_models.py holds the port's model at two wide
configurations against the JAX package.)"""

import pytest
import torch

from diffphore_torch.models.layers import DenseTPConv
from diffphore_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffphore_torch.ops import tp_aggregate, tp_fused, tp_scalar
from diffphore_torch.ops.tensor_product import channelwise_tp

NS = (4, 20, 22, 24, 32, 48, 64)
NV = (4, 8, 10, 16, 32)
#: (B, N, M) of the launches: a 40-pose dispatch of a 24 x 96 complex both
#: ways, a 24-complex training batch, one receiver of one sender
SHAPES = ((40, 24, 96), (40, 96, 24), (24, 24, 96), (1, 1, 1))
#: (B, N, K) of the sender-index phore convs: 96 phore points, 24 slots
IDX_SHAPES = ((24, 96, 24), (40, 96, 24), (1, 1, 1))


def _convs(model):
    """(name, conv) of every channelwise convolution of a model."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, DenseTPConv) and m.channelwise]


def _check_conv(name, conv, knn):
    """Every kernel launch the convolution can make, through its shape
    checks and plans: eval (K1: one or two edge channels, f32 and bf16) and
    training (K3 where every path has l_in = 0, else K2, with and without
    dsh), dense, and in the sender-index mode where the conv takes an index
    (the phore-phore convs of a phore_knn model)."""
    tp = conv.tp
    E, H = conv.fc_w1.shape
    modes = [False] + ([True] if knn and name.startswith("encoder.phore_conv_") else [])
    scalar = tp_scalar.all_scalar_paths(tp)
    for indexed in modes:
        for B, N, M in (IDX_SHAPES if indexed else SHAPES):
            for C in (1, 2):
                for esize in (4, 2):
                    pl = tp_fused.plan(tp, B, N, M, C, E, H, esize, indexed)
                    assert 0 < pl.smem <= tp_fused.SMEM and pl.per_block * pl.splits >= M
                    assert [fc for _, fc in pl.tiles] and sum(fc for _, fc in pl.tiles) == \
                        tp.weight_numel
            if scalar:
                tp_scalar.check_shapes(tp, B, N, M, indexed)
        if not scalar:
            for esize in (4, 2):
                for need_dsh in ((False,) if indexed else (False, True)):
                    got = tp_aggregate.check_shapes(tp, esize, indexed, need_dsh)
                    assert max(got.values()) <= tp_fused.SMEM


@pytest.mark.parametrize("second_order", [False, True], ids=["l1", "l2"])
@pytest.mark.parametrize("ns", NS)
def test_every_conv_takes_the_kernels(ns, second_order):
    """Nothing is refused over the grid of nv at this ns: each conv of the
    model, dense and under phore_knn, at both operand types."""
    for nv in NV:
        model = ScoreModel(ScoreModelConfig(ns=ns, nv=nv, use_second_order_repr=second_order))
        convs = _convs(model)
        assert len(convs) == 23
        for name, conv in convs:
            _check_conv(name, conv, knn=True)


def test_shipped_convs_keep_the_narrow_kernels():
    """corpus2's widths (ns / nv = 20 / 10, l <= 1) keep the 4-lane K1's
    narrow kernel (weights in shared memory), one channel tile and the
    grid of plan_senders; K2's split kernels."""
    model = ScoreModel(ScoreModelConfig(ns=20, nv=10))
    for name, conv in _convs(model):
        E, H = conv.fc_w1.shape
        for B, N, M in SHAPES:
            pl = tp_fused.plan(conv.tp, B, N, M, 2, E, H, 2, False)
            assert not pl.wide and pl.tiles == ((0, conv.tp.weight_numel),), name
            assert (pl.per_block, pl.splits) == tp_fused.plan_senders(B, N, M)
        assert not tp_aggregate.tiled(conv.tp)


def test_widths_past_the_kernels_raise():
    """ns = 65 (E = H = 195) is past the wide K1's 192, and an l = 2 path
    of 130 channels past the 8-lane kernels' 128-channel tile: both raise,
    naming the limit."""
    model = ScoreModel(ScoreModelConfig(ns=65, nv=10))
    conv = next(c for _, c in _convs(model) if c.fc_w1.shape[0] > tp_fused.MAX_WIDE)
    E, H = conv.fc_w1.shape
    with pytest.raises(ValueError, match=f"\\[1, {tp_fused.MAX_WIDE}\\]"):
        tp_fused.plan(conv.tp, 24, 24, 96, 1, E, H, 4, False)
    tp = channelwise_tp("130x0e + 4x2e", "1x0e + 1x1o + 1x2e", "130x0e + 4x2e")
    with pytest.raises(ValueError, match=f"more than {tp_fused.TILE_F_L2} channels"):
        tp_fused.plan(tp, 24, 24, 96, 1, 60, 60, 4, False)
    with pytest.raises(ValueError, match=f"more than {tp_fused.TILE_F_L2} channels"):
        tp_aggregate.check_shapes(tp, 4)
