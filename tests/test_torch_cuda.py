"""The port's CUDA kernels on the card, held against their plain PyTorch
versions.  Needs an NVIDIA GPU and nvcc; every test skips without a card
(a CUDA kernel has no CPU mode).  Imports only torch and the port, so it
runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import torch_kernel_layouts as layouts
from diffphore_torch.ops import tp_aggregate, tp_fused, tp_scalar
from diffphore_torch.ops.tensor_product import channelwise_tp

SEQ = ["20x0e", "20x0e + 10x1o", "20x0e + 10x1o + 10x1e", "20x0e + 10x1o + 10x1e + 20x0o"]
SH = "1x0e + 1x1o + 1x2e"
#: (in irreps, out irreps, sh irreps, E = H) of the corpus2 conv signatures
SIGNATURES = {
    "layer0": (SEQ[0], SEQ[1], SH, 60),
    "layer1": (SEQ[1], SEQ[2], SH, 60),
    "layer2": (SEQ[2], SEQ[3], SH, 60),
    "layer3": (SEQ[3], SEQ[3], SH, 60),
    "final_conv": (SEQ[3], "2x1o + 2x1e", SH, 40),
    "tor_bond_conv": (SEQ[3], "20x0o + 20x0e", "1x1o + 1x0e + 1x1e", 60),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sig", list(SIGNATURES))
@pytest.mark.parametrize("n_chan", [1, 2])
def test_tp_fused_kernel_matches_plain(cuda, sig, n_chan):
    """f32 inputs differ from the plain version by summation order only
    (1e-4 of the output scale); bf16 inputs take the JAX package's bf16
    convolution and are held against the plain version's (3e-2).  N = 37
    and M = 29 leave ragged receiver tiles and sender chunks."""
    irr_in, irr_out, irr_sh, E = SIGNATURES[sig]
    tp = channelwise_tp(irr_in, irr_sh, irr_out)
    rng = np.random.default_rng(0)
    B, N, M, H, F = 3, 37, 29, E, tp.weight_numel
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    x = t(rng.normal(size=(B, M, tp.irreps_in.dim)))
    sh = t(rng.normal(size=(B, N, M, tp.irreps_sh.dim)))
    attrs = [t(rng.normal(size=(B, N, M, E))) for _ in range(n_chan)]
    masks = [torch.from_numpy(rng.random((B, N, M)) > 0.3).to(cuda) for _ in range(n_chan)]
    w1, b1 = t(rng.normal(size=(E, H)) * 0.2), t(rng.normal(size=(H,)) * 0.1)
    w2, b2 = t(rng.normal(size=(H, F)) * 0.2), t(rng.normal(size=(F,)) * 0.1)

    ref = tp_fused.tp_aggregate_fused_plain(tp, x, sh, attrs, masks, w1, b1, w2, b2)
    before = tp_fused.KERNEL.launches
    got = tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, w1, b1, w2, b2)
    bf = torch.bfloat16
    low = (x.to(bf), sh.to(bf), [a.to(bf) for a in attrs])
    got_bf = tp_fused.tp_aggregate_fused(tp, *low, masks, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert tp_fused.KERNEL.launches == before + 2
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-4 * scale
    ref_bf = tp_fused.tp_aggregate_fused_plain(tp, *low, masks, w1, b1, w2, b2)
    assert float((got_bf - ref_bf).abs().max()) <= 3e-2 * float(ref_bf.abs().max())
    assert float(got[..., 3].abs().max()) == 0.0  # the pad lane


@pytest.mark.cuda
def test_tp_fused_rejects_bad_inputs(cuda):
    tp = channelwise_tp(SEQ[0], SH, SEQ[1])
    B, N, M, E = 1, 4, 5, 60
    x = torch.zeros(B, M, tp.irreps_in.dim, device=cuda)
    sh = torch.zeros(B, N, M, 9, device=cuda)
    attr = torch.zeros(B, N, M, E, device=cuda)
    mask = torch.ones(B, N, M, dtype=torch.bool, device=cuda)
    w1, b1 = torch.zeros(E, E, device=cuda), torch.zeros(E, device=cuda)
    w2, b2 = torch.zeros(E, 40, device=cuda), torch.zeros(40, device=cuda)
    with pytest.raises(ValueError):  # non-contiguous attrs
        tp_fused.tp_aggregate_fused(tp, x, sh, [attr.transpose(1, 2)], [mask.transpose(1, 2)],
                                    w1, b1, w2, b2)
    with pytest.raises(ValueError):  # attrs on the CPU
        tp_fused.tp_aggregate_fused(tp, x, sh, [attr.cpu()], [mask], w1, b1, w2, b2)
    with pytest.raises(TypeError):  # f64 inputs
        tp_fused.tp_aggregate_fused(tp, x.double(), sh.double(), [attr.double()], [mask],
                                    w1, b1, w2, b2)


@pytest.mark.cuda
def test_tp_fused_raises_under_grad(cuda):
    """K1 has no backward: a CUDA call with grad-requiring inputs under grad
    mode raises instead of returning a tensor without a grad_fn."""
    tp = channelwise_tp(SEQ[0], SH, SEQ[1])
    B, N, M, E = 1, 4, 5, 60
    x = torch.zeros(B, M, tp.irreps_in.dim, device=cuda)
    sh = torch.zeros(B, N, M, 9, device=cuda)
    attr = torch.zeros(B, N, M, E, device=cuda)
    mask = torch.ones(B, N, M, dtype=torch.bool, device=cuda)
    w1 = torch.zeros(E, E, device=cuda, requires_grad=True)
    b1 = torch.zeros(E, device=cuda)
    w2, b2 = torch.zeros(E, 40, device=cuda), torch.zeros(40, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        tp_fused.tp_aggregate_fused(tp, x, sh, [attr], [mask], w1, b1, w2, b2)
    with torch.no_grad():
        tp_fused.tp_aggregate_fused(tp, x, sh, [attr], [mask], w1, b1, w2, b2)


def _k1_inputs(sig, cuda, B, N, M, n_chan, keep=0.7, seed=0):
    irr_in, irr_out, irr_sh, E = SIGNATURES[sig]
    tp = channelwise_tp(irr_in, irr_sh, irr_out)
    rng = np.random.default_rng(seed)
    F = tp.weight_numel
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    x = t(rng.normal(size=(B, M, tp.irreps_in.dim)))
    sh = t(rng.normal(size=(B, N, M, tp.irreps_sh.dim)))
    attrs = [t(rng.normal(size=(B, N, M, E))) for _ in range(n_chan)]
    masks = [torch.from_numpy(rng.random((B, N, M)) < keep).to(cuda) for _ in range(n_chan)]
    params = (t(rng.normal(size=(E, E)) * 0.2), t(rng.normal(size=(E,)) * 0.1),
              t(rng.normal(size=(E, F)) * 0.2), t(rng.normal(size=(F,)) * 0.1))
    return tp, x, sh, attrs, masks, params


#: (B, N, M): one split; senders split and ragged (M = 96 + 1, N not a
#: multiple of the receiver tile); one receiver; one batch row, many splits
K1_SHAPES = [(2, 24, 24), (3, 21, 97), (5, 1, 24), (1, 96, 96), (2, 8, 24), (1, 9, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("sig,n_chan", [("layer0", 1), ("layer3", 2), ("final_conv", 1),
                                        ("tor_bond_conv", 2)])
def test_tp_fused_sender_split_and_ragged_shapes(cuda, shape, sig, n_chan):
    """The sender split (partial sums added by the second kernel), ragged
    receiver tiles and sender ranges, N = 1 and B = 1, with sparse masks (0.3
    of the edges live: tiles span several senders): f32 within 1e-4 of scale,
    bf16 within 3e-2 of the bf16 plain version, two runs equal to the bit, one
    launch counted per call."""
    B, N, M = shape
    tp, x, sh, attrs, masks, params = _k1_inputs(sig, cuda, B, N, M, n_chan, keep=0.3)
    ref = tp_fused.tp_aggregate_fused_plain(tp, x, sh, attrs, masks, *params)
    before = tp_fused.KERNEL.launches
    got = tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params)
    again = tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params)
    bf = torch.bfloat16
    low = (x.to(bf), sh.to(bf), [a.to(bf) for a in attrs])
    got_bf = tp_fused.tp_aggregate_fused(tp, *low, masks, *params)
    torch.cuda.synchronize()
    assert tp_fused.KERNEL.launches == before + 3
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-4 * scale
    ref_bf = tp_fused.tp_aggregate_fused_plain(tp, *low, masks, *params)
    assert float((got_bf - ref_bf).abs().max()) <= 3e-2 * float(ref_bf.abs().max())
    assert torch.equal(got, again)
    assert float(got[..., 3].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_fused_dead_rows_and_float_masks(cuda, dtype):
    """A receiver row with every edge dead gives exact zeros, a batch row
    with no live edge at all too, and float masks (weights, not only 0 / 1)
    are read as they come and agree with the plain version."""
    tp, x, sh, attrs, masks, params = _k1_inputs("layer2", cuda, 3, 24, 96, 2)
    for m in masks:
        m[0, 5] = False          # one receiver without senders
        m[1] = False             # one batch row without edges
    fmasks = [m.to(torch.float32) * 0.5 for m in masks]
    if dtype == "bf16":
        cast = lambda v: v.to(torch.bfloat16)
        tol = 3e-2
    else:
        cast = lambda v: v
        tol = 1e-4
    for mk in (masks, fmasks):
        low = (cast(x), cast(sh), [cast(a) for a in attrs])
        ref = tp_fused.tp_aggregate_fused_plain(tp, *low, mk, *params)
        got = tp_fused.tp_aggregate_fused(tp, *low, mk, *params)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
        assert float(got[0, 5].abs().max()) == 0.0
        assert float(got[1].abs().max()) == 0.0
    with pytest.raises(TypeError):   # mixed mask types
        tp_fused.tp_aggregate_fused(tp, x, sh, attrs, [masks[0], fmasks[1]], *params)


@pytest.mark.cuda
def test_tp_fused_all_edges_dead(cuda):
    tp, x, sh, attrs, masks, params = _k1_inputs("layer1", cuda, 2, 10, 40, 1)
    masks = [torch.zeros_like(masks[0])]
    got = tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params)
    torch.cuda.synchronize()
    assert float(got.abs().max()) == 0.0


def _k2_inputs(sig, cuda, B=3, N=37, M=29, seed=0):
    irr_in, irr_out, irr_sh, _ = SIGNATURES[sig]
    tp = channelwise_tp(irr_in, irr_sh, irr_out)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    x = t(rng.normal(size=(B, M, tp.irreps_in.dim)))
    sh = t(rng.normal(size=(B, N, M, tp.irreps_sh.dim)))
    w = t(rng.normal(size=(B, N, M, tp.weight_numel)) * (rng.random((B, N, M, 1)) > 0.3))
    g = t(rng.normal(size=(B, N, tp.weight_numel, 4)))
    return tp, x, sh, w, g


@pytest.mark.cuda
@pytest.mark.parametrize("sig", list(SIGNATURES))
def test_tp_aggregate_kernels_match_plain(cuda, sig):
    """K2 forward and its three gradients against autograd through the plain
    version: f32 on both sides, they differ by summation order only (1e-4
    of each result's scale).  N = 37 and M = 29 leave ragged tiles; the
    upstream gradient's padding lanes hold noise, which must be ignored."""
    tp, x, sh, w, g = _k2_inputs(sig, cuda)
    leaves = [v.clone().requires_grad_(True) for v in (x, sh, w)]
    ref = tp_aggregate.tp_aggregate_plain(tp, *leaves)
    lanes = torch.zeros_like(g)
    for p in tp.paths:
        lanes[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    ref_grads = torch.autograd.grad(ref, leaves, g * lanes)

    counts = [k.launches for k in (tp_aggregate.FWD, tp_aggregate.BWD_EDGE, tp_aggregate.BWD_X)]
    mine = [v.clone().requires_grad_(True) for v in (x, sh, w)]
    out = tp_aggregate.tp_aggregate(tp, *mine)
    grads = torch.autograd.grad(out, mine, g)
    torch.cuda.synchronize()
    assert [k.launches for k in (tp_aggregate.FWD, tp_aggregate.BWD_EDGE, tp_aggregate.BWD_X)] \
        == [c + 1 for c in counts]
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert float(out[..., 3].abs().max()) == 0.0  # the pad lane
    for name, got, want in zip(("dx", "dsh", "dw"), grads, ref_grads):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


@pytest.mark.cuda
def test_tp_aggregate_is_deterministic_and_skips_unneeded_grads(cuda):
    """No atomics: two runs agree to the bit.  Without a gradient into sh the
    edge kernel skips dsh; without one into x the dx kernel is not launched."""
    tp, x, sh, w, g = _k2_inputs("layer2", cuda)
    runs = []
    for _ in range(2):
        leaves = [v.clone().requires_grad_(True) for v in (x, sh, w)]
        out = tp_aggregate.tp_aggregate(tp, *leaves)
        runs.append((out,) + torch.autograd.grad(out, leaves, g))
    for a, b in zip(*runs):
        assert torch.equal(a, b)

    w_only = w.clone().requires_grad_(True)
    before = tp_aggregate.BWD_X.launches
    out = tp_aggregate.tp_aggregate(tp, x, sh, w_only)
    (dw,) = torch.autograd.grad(out, [w_only], g)
    assert tp_aggregate.BWD_X.launches == before
    # the dw-only kernel and the one that also computes dsh sum in another order
    assert float((dw - runs[0][3]).abs().max()) <= 1e-5 * float(dw.abs().max())


#: (B, N, M) of the edge backward: every sender tile size of its planning,
#: ragged receiver tiles and an odd number of senders
K2_EDGE_SHAPES = [(3, 37, 29), (24, 24, 96), (2, 1, 24), (1, 9, 3), (40, 8, 24), (12, 24, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K2_EDGE_SHAPES)
@pytest.mark.parametrize("sig", ["layer1", "layer3", "final_conv", "tor_bond_conv"])
@pytest.mark.parametrize("need_dsh", [True, False])
def test_tp_aggregate_edge_backward_shapes(cuda, shape, sig, need_dsh):
    """dw and dsh of the edge backward against autograd through the plain
    version (1e-4 of scale), dsh on and off (two kernels whose dw differ by
    summation order only), reruns equal to the bit."""
    tp, x, sh, w, g = _k2_inputs(sig, cuda, *shape)
    leaves = [v.clone().requires_grad_(True) for v in (sh, w)]
    ref = tp_aggregate.tp_aggregate_plain(tp, x, *leaves)
    lanes = torch.zeros_like(g)
    for p in tp.paths:
        lanes[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    ref_dsh, ref_dw = torch.autograd.grad(ref, leaves, g * lanes)

    dw, dsh = tp_aggregate.launch_backward_edge(tp, x, sh, w, g, need_dsh)
    dw2, dsh2 = tp_aggregate.launch_backward_edge(tp, x, sh, w, g, need_dsh)
    dw_other, _ = tp_aggregate.launch_backward_edge(tp, x, sh, w, g, not need_dsh)
    torch.cuda.synchronize()
    assert float((dw - ref_dw).abs().max()) <= 1e-4 * float(ref_dw.abs().max())
    assert torch.equal(dw, dw2)
    assert float((dw_other - ref_dw).abs().max()) <= 1e-4 * float(ref_dw.abs().max())
    if need_dsh:
        assert float((dsh - ref_dsh).abs().max()) <= 1e-4 * float(ref_dsh.abs().max())
        assert torch.equal(dsh, dsh2)
    else:
        assert dsh is None and dsh2 is None


#: (B, N, M) of the forward and dx: one split of the summed axis (B = 24, N =
#: 96 for the forward; M = 96 for dx), many splits, ragged N and M, N = 1,
#: B = 1, a single sender tile
K2_SPLIT_SHAPES = [(24, 96, 24), (24, 24, 96), (3, 37, 29), (2, 1, 24), (1, 96, 96),
                   (40, 8, 24), (12, 24, 24), (1, 9, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K2_SPLIT_SHAPES)
@pytest.mark.parametrize("sig", ["layer1", "layer3", "final_conv", "tor_bond_conv"])
def test_tp_aggregate_forward_and_dx_shapes(cuda, shape, sig):
    """The forward and dx, the summed axis split as planned, against the
    plain version and autograd through it (1e-4 of scale); tor_bond_conv
    has S = 7 harmonics.  Reruns equal to the bit; each wrapper's counter
    rises by one per call, whether it launched one kernel or two."""
    tp, x, sh, w, g = _k2_inputs(sig, cuda, *shape)
    leaf = x.clone().requires_grad_(True)
    ref = tp_aggregate.tp_aggregate_plain(tp, leaf, sh, w)
    lanes = torch.zeros_like(g)
    for p in tp.paths:
        lanes[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    (ref_dx,) = torch.autograd.grad(ref, [leaf], g * lanes)

    before = (tp_aggregate.FWD.launches, tp_aggregate.BWD_X.launches)
    outs = [tp_aggregate.launch_forward(tp, x, sh, w) for _ in range(2)]
    dxs = [tp_aggregate.launch_backward_x(tp, x, sh, w, g) for _ in range(2)]
    torch.cuda.synchronize()
    assert (tp_aggregate.FWD.launches, tp_aggregate.BWD_X.launches) == (before[0] + 2,
                                                                        before[1] + 2)
    assert float((outs[0] - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert float(outs[0][..., 3].abs().max()) == 0.0
    assert float((dxs[0] - ref_dx).abs().max()) <= 1e-4 * float(ref_dx.abs().max())
    assert torch.equal(outs[0], outs[1]) and torch.equal(dxs[0], dxs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 24, 96), (3, 37, 29), (1, 96, 96)])
def test_tp_aggregate_dead_receivers_and_senders_give_exact_zeros(cuda, shape):
    """A receiver row with no live sender gives exact zeros out (every
    split's partial sum is 0), a sender with no live receiver dx of exactly
    0, a batch row without live edges both."""
    B, N, M = shape
    tp, x, sh, w, g = _k2_inputs("layer2", cuda, B, N, M)
    w[0, N // 2] = 0.0            # a receiver without senders
    w[-1, :, M // 3] = 0.0        # a sender without receivers
    w[B // 2] = 0.0               # a batch row without edges (alone when B = 1)
    out = tp_aggregate.launch_forward(tp, x, sh, w)
    dx = tp_aggregate.launch_backward_x(tp, x, sh, w, g)
    torch.cuda.synchronize()
    assert float(out[0, N // 2].abs().max()) == 0.0
    assert float(dx[-1, M // 3].abs().max()) == 0.0
    assert float(out[B // 2].abs().max()) == 0.0 and float(dx[B // 2].abs().max()) == 0.0
    if B > 1:
        assert float(out[-1].abs().max()) > 0.0 and float(dx[0].abs().max()) > 0.0


@pytest.mark.cuda
def test_tp_aggregate_rejects_bad_inputs(cuda):
    tp, x, sh, w, _ = _k2_inputs("layer0", cuda, B=1, N=4, M=5)
    with pytest.raises(ValueError):  # non-contiguous weights
        tp_aggregate.tp_aggregate(tp, x, sh, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):  # sh on the CPU
        tp_aggregate.tp_aggregate(tp, x, sh.cpu(), w)
    with pytest.raises(TypeError):  # x, sh and w of two types
        tp_aggregate.tp_aggregate(tp, x.bfloat16(), sh, w.bfloat16())
    with pytest.raises(TypeError):  # f64 inputs
        tp_aggregate.tp_aggregate(tp, x.double(), sh.double(), w.double())
    with pytest.raises(ValueError):  # wrong channel count
        tp_aggregate.tp_aggregate(tp, x, sh, w[..., :-1].contiguous())


def _bf16_step(want: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding step of each element of an f32 result, plus 1e-6 of
    its scale: where a kernel's f32 sum and the plain version's, taken in
    another order, fall on two sides of a bf16 rounding boundary."""
    return want.abs() * 2.0 ** -7 + 1e-6 * float(want.abs().max())


def _lanes(tp, g):
    lanes = torch.zeros_like(g)
    for p in tp.paths:
        lanes[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    return lanes


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 29), (24, 1, 24), (24, 24, 96), (24, 96, 24)])
@pytest.mark.parametrize("sig", list(SIGNATURES))
def test_tp_aggregate_bf16_matches_plain(cuda, shape, sig):
    """bf16 x, sh and w (a convolution at compute_dtype bfloat16): the
    forward within 1e-5 of scale of the plain version on the same bf16
    operands (f32 sums in another order), dx, dsh and dw, stored in bf16,
    within one bf16 rounding step of each element; reruns equal to the bit.
    final_conv's F = 100 makes a bf16 row of w 200 bytes: its rows are not
    16-byte aligned."""
    tp, x, sh, w, g = _k2_inputs(sig, cuda, *shape)
    bf = torch.bfloat16
    x, sh, w = x.to(bf), sh.to(bf), w.to(bf)
    leaves = [v.float().requires_grad_(True) for v in (x, sh, w)]
    ref = tp_aggregate.tp_aggregate_plain(tp, *[v.to(bf) for v in leaves])
    ref_grads = torch.autograd.grad(ref, leaves, g * _lanes(tp, g))
    runs = []
    for _ in range(2):
        out = tp_aggregate.launch_forward(tp, x, sh, w)
        dw, dsh = tp_aggregate.launch_backward_edge(tp, x, sh, w, g, True)
        dw_only, _ = tp_aggregate.launch_backward_edge(tp, x, sh, w, g, False)
        dx = tp_aggregate.launch_backward_x(tp, x, sh, w, g)
        runs.append((out, dx, dsh, dw, dw_only))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, dx, dsh, dw, dw_only = runs[0]
    assert out.dtype == torch.float32 and float(out[..., 3].abs().max()) == 0.0
    assert float((out - ref.detach()).abs().max()) <= 1e-5 * float(ref.abs().max())
    for name, got, want in zip(("dx", "dsh", "dw", "dw without dsh"), (dx, dsh, dw, dw_only),
                               ref_grads + (ref_grads[2],)):
        assert got.dtype == bf, name
        assert bool(((got.float() - want).abs() <= _bf16_step(want)).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_tp_aggregate_bf16_rows_at_every_alignment(cuda, offset):
    """final_conv's F = 100 with w starting 2, 4, 8 or 16 bytes past a
    16-byte boundary: the ring copies rows in pieces of 4 or 8 bytes (or
    loads them plainly) and the results do not change."""
    tp, x, sh, w, g = _k2_inputs("final_conv", cuda, 24, 1, 24)
    bf = torch.bfloat16
    x, sh, w = x.to(bf), sh.to(bf), w.to(bf)
    buf = torch.zeros(w.numel() + 8, dtype=bf, device=cuda)
    shifted = buf[offset:offset + w.numel()].view(w.shape)
    shifted.copy_(w)
    assert shifted.is_contiguous()
    for fn in (lambda v: tp_aggregate.launch_forward(tp, x, sh, v),
               lambda v: tp_aggregate.launch_backward_x(tp, x, sh, v, g),
               lambda v: tp_aggregate.launch_backward_edge(tp, x, sh, v, g, True)[1]):
        a, b = fn(w), fn(shifted)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


K3_COUNTERS = (tp_scalar.FWD, tp_scalar.BWD_EDGE, tp_scalar.BWD_X)


def _k3_conv_inputs(cuda, tp, B, N, M, seed=1):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    return [t(rng.normal(size=(B, M, tp.irreps_in.dim))), t(rng.normal(size=(B, N, M, 9))),
            t(rng.normal(size=(B, N, M, tp.weight_numel)) * (rng.random((B, N, M, 1)) > 0.3))]


@pytest.mark.cuda
@pytest.mark.parametrize("irreps_in,irreps_out", [
    ("20x0e", "20x0e + 10x1o"),
    ("6x0e + 3x0o", "6x0e + 2x1o + 2x1e + 3x0o"),    # two paths share the l = 1 harmonics
])
def test_tp_scalar_conv_level_matches_plain_and_is_deterministic(cuda, irreps_in, irreps_out):
    """Every path of an all-l_in-0 convolution: the packed output and the
    gradients into the full x, sh and w against the plain version (1e-4),
    the pad lanes zero, two runs equal to the bit, one forward, one edge
    backward and one dx launch for the convolution, and dsh and dx skipped
    when sh and x carry no gradient."""
    tp = channelwise_tp(irreps_in, SH, irreps_out)
    vals = _k3_conv_inputs(cuda, tp, 3, 13, 29)
    B, N = vals[1].shape[:2]
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, N, tp.weight_numel, 4)).astype(np.float32)).to(cuda)   # noise in the pad lanes
    lanes = _lanes(tp, g)
    leaves = [v.clone().requires_grad_(True) for v in vals]
    ref = tp_scalar.scalar_paths_aggregate_plain(tp, *leaves)
    ref_grads = torch.autograd.grad(ref, leaves, g * lanes)

    runs = []
    for _ in range(2):
        before = [k.launches for k in K3_COUNTERS]
        mine = [v.clone().requires_grad_(True) for v in vals]
        out = tp_scalar.scalar_paths_aggregate(tp, *mine)
        runs.append((out,) + torch.autograd.grad(out, mine, g))
        assert [k.launches - b for k, b in zip(K3_COUNTERS, before)] == [1, 1, 1]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, *grads = runs[0]
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert float((out * (1 - lanes)).abs().max()) == 0.0
    for name, got, want in zip(("dx", "dsh", "dw"), grads, ref_grads):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name

    w_only = vals[2].clone().requires_grad_(True)
    before = [k.launches for k in K3_COUNTERS]
    out = tp_scalar.scalar_paths_aggregate(tp, vals[0], vals[1], w_only)
    (dw,) = torch.autograd.grad(out, [w_only], g)
    assert [k.launches - b for k, b in zip(K3_COUNTERS, before)] == [1, 1, 0]
    assert torch.equal(dw, grads[2])


#: (B, N, M) of the six layer-0 training convs of a 24-complex batch, a
#: ragged shape and one batch row
K3_CONV_SHAPES = [(24, 24, 24), (24, 24, 96), (24, 96, 24), (24, 96, 96), (3, 37, 29), (1, 9, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_CONV_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_scalar_conv_level_training_shapes(cuda, shape, dtype):
    """The redesigned forward and dx at the layer-0 convs' widths (F = 40),
    the summed axis split as planned: against the per-path plain version,
    f32 within 1e-5 of scale, in bf16 the output within 1e-5 of scale and
    dx within one bf16 rounding step of each element; reruns equal to the
    bit."""
    tp = channelwise_tp(SEQ[0], SH, SEQ[1])
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, sh, w = [v.to(dt) for v in _k3_conv_inputs(cuda, tp, *shape)]
    B, N, M, _ = sh.shape
    g = torch.randn((B, N, tp.weight_numel, 4), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    leaves = [v.float().requires_grad_(True) for v in (x, sh, w)]
    ref = tp_scalar.scalar_paths_aggregate_plain(tp, *[v.to(dt) for v in leaves])
    (ref_dx,) = torch.autograd.grad(ref, [leaves[0]], g * _lanes(tp, g))
    outs = [tp_scalar.launch_forward(tp, x, sh, w) for _ in range(2)]
    dxs = [tp_scalar.launch_backward_x(tp, x, sh, w, g) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(dxs[0], dxs[1])
    assert outs[0].dtype == torch.float32 and dxs[0].dtype == dt
    assert float((outs[0] - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    if dt == torch.float32:
        assert float((dxs[0] - ref_dx).abs().max()) <= 1e-5 * float(ref_dx.abs().max())
    else:
        assert bool(((dxs[0].float() - ref_dx).abs() <= _bf16_step(ref_dx)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_CONV_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("need_dsh", [True, False])
def test_tp_scalar_edge_backward_matches_plain(cuda, shape, dtype, need_dsh):
    """The edge backward (dw, and dsh where asked) of the layer-0 convs'
    widths (F = 40) in one launch against its plain version: f32 within 1e-4
    of each result's scale, bf16 within one bf16 rounding step of each
    element plus 1e-6 of scale; reruns equal to the bit; dead receivers and
    senders, and the harmonic components no path reads, exact zeros in dsh;
    w moved 2 to 16 bytes off its base (scalar accesses where four elements
    are not aligned) gives the same bits.  One launch per call."""
    tp = channelwise_tp(SEQ[0], SH, SEQ[1])
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, sh, w = [v.to(dt) for v in _k3_conv_inputs(cuda, tp, *shape)]
    B, N, M, _ = sh.shape
    n_dead, m_dead = max(1, N // 3), max(1, M // 4)
    w[:, N - n_dead:] = 0                          # dead receivers
    w[:, :, M - m_dead:] = 0                       # dead senders
    g = torch.randn((B, N, tp.weight_numel, 4), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    ref_dw, ref_dsh = tp_scalar.scalar_paths_backward_edge_plain(tp, x, sh, w, g, need_dsh)
    before = tp_scalar.BWD_EDGE.launches
    runs = [tp_scalar.launch_backward_edge(tp, x, sh, w, g, need_dsh) for _ in range(2)]
    torch.cuda.synchronize()
    assert tp_scalar.BWD_EDGE.launches == before + 2
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)
    dw, dsh = runs[0]
    assert (dsh is None) == (not need_dsh) and dw.dtype == dt
    for name, got, want in (("dw", dw, ref_dw), ("dsh", dsh, ref_dsh)):
        if want is None:
            continue
        assert got.dtype == dt, name
        want = want.float()
        if dt == torch.float32:
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
        else:
            assert bool(((got.float() - want).abs() <= _bf16_step(want)).all()), name
    if need_dsh:
        assert float(dsh[:, N - n_dead:].abs().max()) == 0.0
        assert float(dsh[:, :, M - m_dead:].abs().max()) == 0.0
        assert float(dsh[..., tp_scalar.sh_reach(tp):].abs().max()) == 0.0
    buf = torch.zeros(w.numel() + 16, dtype=dt, device=cuda)
    for offset in sorted({max(1, 2 // w.element_size()), 4 // w.element_size(),
                          8 // w.element_size(), 16 // w.element_size()}):
        shifted = buf[offset:offset + w.numel()].view(w.shape)
        shifted.copy_(w)
        got = tp_scalar.launch_backward_edge(tp, x, sh, shifted, g, need_dsh)
        torch.cuda.synchronize()
        for a, b in zip(got, runs[0]):
            assert (a is None and b is None) or torch.equal(a, b), offset


@pytest.mark.cuda
def test_tp_scalar_rejects_bad_inputs(cuda):
    tp = channelwise_tp(SEQ[0], SH, SEQ[1])
    x, sh, w = _k3_conv_inputs(cuda, tp, 1, 4, 5)
    g = torch.zeros(1, 4, tp.weight_numel, 4, device=cuda)
    edge = tp_scalar.launch_backward_edge
    with pytest.raises(ValueError):  # a CPU tensor among CUDA tensors
        edge(tp, x, sh.cpu(), w, g, True)
    with pytest.raises(TypeError):   # x and sh of two types
        edge(tp, x.bfloat16(), sh, w, g, True)
    with pytest.raises(TypeError):   # a bf16 upstream gradient
        edge(tp, x, sh, w, g.bfloat16(), True)
    with pytest.raises(ValueError):  # a weight tensor that is not contiguous
        edge(tp, x, sh, w.transpose(1, 2).contiguous().transpose(1, 2), g, True)
    with pytest.raises(ValueError):  # wrong channel count
        edge(tp, x, sh, w[..., :-1], g, True)
    wide = channelwise_tp("65x0e", SH, "65x0e + 1x1o")
    with pytest.raises(ValueError):  # more channels than four a lane of one warp
        xw, shw, ww = _k3_conv_inputs(cuda, wide, 1, 4, 5)
        edge(wide, xw, shw, ww, torch.zeros(1, 4, wide.weight_numel, 4, device=cuda), True)
    late = channelwise_tp(SEQ[0], "1x1e + 1x1o + 1x0e", SEQ[1])
    with pytest.raises(ValueError):  # a path reads harmonic components past the fourth
        xl, _, wl = _k3_conv_inputs(cuda, late, 1, 4, 5)
        edge(late, xl, torch.zeros(1, 4, 5, 7, device=cuda), wl, g, True)
    tp = channelwise_tp(SEQ[1], SH, SEQ[2])
    with pytest.raises(ValueError):  # a convolution with l_in = 1 paths belongs to K2
        tp_scalar.scalar_paths_aggregate(tp, torch.zeros(1, 5, tp.irreps_in.dim, device=cuda),
                                         torch.zeros(1, 4, 5, 9, device=cuda),
                                         torch.zeros(1, 4, 5, tp.weight_numel, device=cuda))
    tp = channelwise_tp(SEQ[0], SH, SEQ[1])
    vals = _k3_conv_inputs(cuda, tp, 1, 4, 5)
    with pytest.raises(TypeError):   # x, sh and w of two types
        tp_scalar.scalar_paths_aggregate(tp, vals[0].bfloat16(), vals[1], vals[2])
    with pytest.raises(ValueError):  # a non-contiguous weight tensor
        tp_scalar.scalar_paths_aggregate(tp, vals[0], vals[1],
                                         vals[2].transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.cuda
def test_confidence_head_train_step_kernels_match_plain_convs(cuda):
    """One train step of the confidence head at corpus2's width (ns 20, nv
    10, 4 conv layers, dropout 0.1, f32 convs) from fresh weights on six
    cached complexes: with the kernels against the plain convs, same noise
    and dropout masks, the loss and every gradient leaf (1e-3 of the leaf's
    scale plus 5e-6 of the largest gradient, for the two transition MLPs
    whose true gradient is zero); K2 launches 15 forward + 15 edge backward +
    15 dx, K3 6 + 6 + 6, K1 none."""
    import glob
    import os

    from diffphore_torch.data.graphs import concat_batches, load_cached
    from diffphore_torch.data.transforms import draw_noise
    from diffphore_torch.models.layers import DenseTPConv
    from diffphore_torch.models.score_model import ScoreModelConfig
    from diffphore_torch.train.confidence import (create_confidence_train_state,
                                                  make_confidence_train_step)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    batches = []
    for f in sorted(glob.glob(os.path.join(root, "data", "cache", "val_f1112e7d33", "*.npz"))):
        b = load_cached(f)
        if (b.num_atoms, b.num_phore, b.num_torsions) == (24, 96, 8):
            batches.append(b)
    batch = concat_batches(batches[:6]).replace(names=(), meta=()).to(cuda)
    cfg = ScoreModelConfig(compute_dtype="float32")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    draws = draw_noise(batch.batch_size, batch.num_torsions, gen, cuda)
    counters = (tp_fused.KERNEL, tp_aggregate.FWD, tp_aggregate.BWD_EDGE, tp_aggregate.BWD_X,
                tp_scalar.FWD, tp_scalar.BWD_EDGE, tp_scalar.BWD_X)
    results = []
    for use_kernel in (True, False):
        state = create_confidence_train_state(cfg, seed=0, device="cuda")
        for m in state.model.modules():
            if isinstance(m, DenseTPConv):
                m.use_kernel = use_kernel
        drop = torch.Generator(device=cuda)
        drop.manual_seed(1)
        before = [c.launches for c in counters]
        state, metrics = make_confidence_train_step(cfg)(state, batch, drop, draws=draws)
        torch.cuda.synchronize()
        launches = [c.launches - b for c, b in zip(counters, before)]
        assert launches == ([0, 15, 15, 15, 6, 6, 6] if use_kernel else [0] * 7)
        assert float(metrics["grad_finite"]) == 1.0
        results.append((float(metrics["loss"]),
                        {k: p.grad.clone() for k, p in state.model.named_parameters()}))
    (loss_k, gk), (loss_p, gp) = results
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    floor = 5e-6 * max(float(g.abs().max()) for g in gp.values())
    for name, g in gp.items():
        err = float((gk[name] - g).abs().max())
        assert err <= 1e-3 * float(g.abs().max()) + floor, (name, err)


# ---- the 8-lane instantiations: irreps up to l = 2 (use_second_order_repr) ----

SEQ2 = ["20x0e", "20x0e + 10x1o + 10x2e", "20x0e + 10x1o + 10x2e + 10x1e + 10x2o",
        "20x0e + 10x1o + 10x2e + 10x1e + 10x2o + 20x0o"]
#: (in irreps, out irreps, sh irreps, E = H) of the second-order model's conv
#: signatures at corpus2's width
SIGNATURES_L2 = {
    "layer0": (SEQ2[0], SEQ2[1], SH, 60),
    "layer1": (SEQ2[1], SEQ2[2], SH, 60),
    "layer2": (SEQ2[2], SEQ2[3], SH, 60),
    "layer3": (SEQ2[3], SEQ2[3], SH, 60),
    "final_conv": (SEQ2[3], "2x1o + 2x1e", SH, 40),
    "tor_bond_conv": (SEQ2[3], "20x0o + 20x0e", "1x1o + 1x0e + 1x1e", 60),
}
#: (B, N, M): ragged tiles, sender splits (B = 1), the serving shapes
L2_SHAPES = [(3, 37, 29), (1, 96, 96), (40, 24, 96), (40, 96, 24)]


def _l2_tp(sig):
    irr_in, irr_out, irr_sh, E = SIGNATURES_L2[sig]
    tp = channelwise_tp(irr_in, irr_sh, irr_out)
    assert tp_fused.lanes(tp) == 8
    return tp, E


@pytest.mark.cuda
@pytest.mark.parametrize("sig", list(SIGNATURES_L2))
@pytest.mark.parametrize("n_chan", [1, 2])
@pytest.mark.parametrize("shape", L2_SHAPES)
def test_tp_fused_l2_kernel_matches_plain(cuda, sig, n_chan, shape):
    """The 8-lane K1 against its plain version: f32 within 1e-4 of the
    output scale, bf16 (the JAX package's bf16 convolution) within 3e-2;
    lanes 5-7 zero; reruns equal to the bit; one launch a call."""
    tp, E = _l2_tp(sig)
    rng = np.random.default_rng(0)
    B, N, M = shape
    H, F = E, tp.weight_numel
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    x = t(rng.normal(size=(B, M, tp.irreps_in.dim)))
    sh = t(rng.normal(size=(B, N, M, tp.irreps_sh.dim)))
    attrs = [t(rng.normal(size=(B, N, M, E))) for _ in range(n_chan)]
    masks = [torch.from_numpy(rng.random((B, N, M)) > 0.6).to(cuda) for _ in range(n_chan)]
    params = (t(rng.normal(size=(E, H)) * 0.2), t(rng.normal(size=(H,)) * 0.1),
              t(rng.normal(size=(H, F)) * 0.2), t(rng.normal(size=(F,)) * 0.1))

    ref = tp_fused.tp_aggregate_fused_plain(tp, x, sh, attrs, masks, *params)
    before = (tp_fused.KERNEL.launches, tp_fused.KERNEL_L2.launches)
    got = tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params)
    again = tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params)
    bf = torch.bfloat16
    low = (x.to(bf), sh.to(bf), [a.to(bf) for a in attrs])
    got_bf = tp_fused.tp_aggregate_fused(tp, *low, masks, *params)
    torch.cuda.synchronize()
    assert (tp_fused.KERNEL.launches, tp_fused.KERNEL_L2.launches) == (before[0], before[1] + 3)
    assert got.shape == (B, N, F, 8) and torch.equal(got, again)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    ref_bf = tp_fused.tp_aggregate_fused_plain(tp, *low, masks, *params)
    assert float((got_bf - ref_bf).abs().max()) <= 3e-2 * float(ref_bf.abs().max())
    assert float(got[..., 5:].abs().max()) == 0.0  # the pad lanes


@pytest.mark.cuda
@pytest.mark.parametrize("sig", list(SIGNATURES_L2))
def test_tp_fused_l2_layout_fits_two_blocks_an_sm(cuda, sig):
    """The kernel's own count of its shared memory (dp_tp_fused_l2_smem)
    stays within SMEM_L2 at one and two edge channels, f32 and bf16, with
    MAX_SENDERS_L2 senders a block, on each signature's channel tiles."""
    tp, E = _l2_tp(sig)
    *_, dims = tp_fused.tables_tiled_l2(tp)
    lib = tp_fused._library()
    for C in (1, 2):
        for esize in (4, 2):
            smem = lib.dp_tp_fused_l2_smem(C, E, E, *dims[:4], tp_fused.MAX_SENDERS_L2,
                                           dims[4], esize)
            assert 0 < smem <= tp_fused.SMEM_L2, (C, esize, smem)


def _l2_k2_inputs(tp, cuda, B, N, M, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    x = t(rng.normal(size=(B, M, tp.irreps_in.dim)))
    sh = t(rng.normal(size=(B, N, M, tp.irreps_sh.dim)))
    w = t(rng.normal(size=(B, N, M, tp.weight_numel)) * (rng.random((B, N, M, 1)) > 0.3))
    g = t(rng.normal(size=(B, N, tp.weight_numel, 8)))   # noise in the pad lanes
    return x, sh, w, g


L2_K2_COUNTERS = (tp_aggregate.FWD_L2, tp_aggregate.BWD_EDGE_L2, tp_aggregate.BWD_X_L2)


@pytest.mark.cuda
@pytest.mark.parametrize("sig", [s for s in SIGNATURES_L2 if s != "layer0"])
@pytest.mark.parametrize("shape", [(3, 37, 29), (2, 1, 24), (24, 24, 96), (24, 96, 24)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_aggregate_l2_kernels_match_plain(cuda, sig, shape, dtype):
    """The 8-lane K2 (forward, edge backward with and without dsh, dx)
    against autograd through the plain version: f32 within 1e-4 of each
    result's scale; bf16 operands: the f32 output within 1e-5 of scale and
    the bf16 gradients within one bf16 rounding step of each element; the
    upstream gradient's pad lanes ignored; reruns equal to the bit."""
    tp, _ = _l2_tp(sig)
    x, sh, w, g = _l2_k2_inputs(tp, cuda, *shape)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, sh, w = x.to(dt), sh.to(dt), w.to(dt)
    leaves = [v.float().requires_grad_(True) for v in (x, sh, w)]
    ref = tp_aggregate.tp_aggregate_plain(tp, *[v.to(dt) for v in leaves])
    ref_grads = torch.autograd.grad(ref, leaves, g * _lanes(tp, g))
    runs = []
    for _ in range(2):
        before = [k.launches for k in L2_K2_COUNTERS]
        out = tp_aggregate.launch_forward(tp, x, sh, w)
        dw, dsh = tp_aggregate.launch_backward_edge(tp, x, sh, w, g, True)
        dw_only, none = tp_aggregate.launch_backward_edge(tp, x, sh, w, g, False)
        dx = tp_aggregate.launch_backward_x(tp, x, sh, w, g)
        assert none is None
        assert [k.launches - b for k, b in zip(L2_K2_COUNTERS, before)] == [1, 2, 1]
        runs.append((out, dx, dsh, dw, dw_only))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, dx, dsh, dw, dw_only = runs[0]
    assert out.shape == ref.shape and float(out[..., 5:].abs().max()) == 0.0
    tol = 1e-4 if dt == torch.float32 else 1e-5
    assert float((out - ref.detach()).abs().max()) <= tol * float(ref.abs().max())
    for name, got, want in zip(("dx", "dsh", "dw", "dw without dsh"), (dx, dsh, dw, dw_only),
                               ref_grads + (ref_grads[2],)):
        assert got.dtype == dt, name
        if dt == torch.float32:
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
        else:
            assert bool(((got.float() - want).abs() <= _bf16_step(want)).all()), name


@pytest.mark.cuda
def test_tp_aggregate_l2_autograd_launches_the_8_lane_kernels(cuda):
    """tp_aggregate under autograd on an l = 2 product: one launch of each
    8-lane kernel, none of the 4-lane ones."""
    tp, _ = _l2_tp("layer2")
    x, sh, w, g = _l2_k2_inputs(tp, cuda, 3, 37, 29)
    l1 = (tp_aggregate.FWD, tp_aggregate.BWD_EDGE, tp_aggregate.BWD_X)
    before = [k.launches for k in l1 + L2_K2_COUNTERS]
    leaves = [v.clone().requires_grad_(True) for v in (x, sh, w)]
    out = tp_aggregate.tp_aggregate(tp, *leaves)
    torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(l1 + L2_K2_COUNTERS, before)] == [0, 0, 0, 1, 1, 1]


#: (B, N, M) of the dense 8-lane K2 forward and dx: the probe's training
#: shapes (batch 24 of a 24 x 96 x 8 bucket: split and unsplit grids), B = 1
#: (the most splits), N = 1 (final_conv), N and M below a tile, ragged tiles
K2_TILED_SHAPES = [(24, 24, 96), (24, 96, 24), (24, 24, 24), (1, 96, 96), (24, 1, 24),
                   (2, 3, 2), (3, 37, 29)]


@pytest.mark.cuda
@pytest.mark.parametrize("sig", list(SIGNATURES_L2))
@pytest.mark.parametrize("shape", K2_TILED_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_aggregate_l2_tiled_forward_and_dx(cuda, sig, shape, dtype):
    """The dense 8-lane forward and dx by channel tile at the probe's six
    widths (F = 60 to 360; F = 140 has bf16 rows of w that are not a
    multiple of 16 bytes), on live-first edge weights with dead edges
    inside (whole tiles dead at the far ends): against autograd through the
    plain version, f32 within 1e-4 of each result's scale, bf16 the output
    within 1e-5 and dx within one bf16 rounding step of each element; the
    upstream gradient's pad lanes ignored; the output's pad lanes zero;
    reruns equal to the bit; one launch a call; B = 1 splits both summed
    axes."""
    tp, _ = _l2_tp(sig)
    B, N, M = shape
    x, sh, w, g = _l2_k2_inputs(tp, cuda, B, N, M, seed=3)
    live_n, live_m = -(-2 * N // 5), -(-M // 2)
    w[:, live_n:] = 0.0
    w[:, :, live_m:] = 0.0
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, sh, w = x.to(dt), sh.to(dt), w.to(dt)
    xl = x.float().requires_grad_(True)
    ref = tp_aggregate.tp_aggregate_plain(tp, xl.to(dt), sh, w)
    (ref_dx,) = torch.autograd.grad(ref, [xl], g * _lanes(tp, g))
    runs = []
    for _ in range(2):
        before = [k.launches for k in L2_K2_COUNTERS]
        runs.append((tp_aggregate.launch_forward(tp, x, sh, w),
                     tp_aggregate.launch_backward_x(tp, x, sh, w, g)))
        assert [k.launches - b for k, b in zip(L2_K2_COUNTERS, before)] == [1, 0, 1]
    torch.cuda.synchronize()
    (out, dx), (out2, dx2) = runs
    assert torch.equal(out, out2) and torch.equal(dx, dx2)
    assert out.shape == ref.shape and float(out[..., 5:].abs().max()) == 0.0
    assert dx.dtype == dt and dx.shape == x.shape
    tol = 1e-4 if dt == torch.float32 else 1e-5
    assert float((out - ref.detach()).abs().max()) <= tol * float(ref.abs().max())
    if dt == torch.float32:
        assert float((dx - ref_dx).abs().max()) <= 1e-4 * float(ref_dx.abs().max())
    else:
        assert bool(((dx.float() - ref_dx).abs() <= _bf16_step(ref_dx)).all())
    if shape == (1, 96, 96):
        for k in (False, True):
            assert tp_aggregate.grid_l2(tp, B, N, M, k, cuda, dt)[1] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 96, 96, 300), (3, 37, 29, 140), (1, 1, 5, 80),
                                   (2, 5, 7, 60)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_aggregate_l2_live_pass_matches_plain(cuda, shape, dtype):
    """The live pass's bits equal the plain version's on rows dead, live in
    one channel only (the first, a middle one, the last) and live
    throughout, -0 counting as zero; rows that end inside a word of bits
    and w at an offset that allows only narrow loads."""
    B, N, M, F = shape
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(B, N, M, F)).astype(np.float32))
    kind = torch.from_numpy(rng.integers(0, 6, (B, N, M)))   # 5: live throughout
    w[kind == 0] = 0.0
    w[kind == 1] = -0.0
    for k, col in ((2, 0), (3, F // 2), (4, F - 1)):
        keep = w[kind == k][:, col].clone()
        w[kind == k] = 0.0
        w[(kind == k).nonzero(as_tuple=True) + (torch.full((int((kind == k).sum()),), col),)] = keep
    w = w.to(dt).to(cuda)
    got = tp_aggregate.live_rows_l2(w)
    torch.cuda.synchronize()
    assert torch.equal(got, tp_aggregate.live_rows_plain(w))
    flat = torch.empty(w.numel() + 1, dtype=dt, device=cuda)[1:].view(w.shape)   # 2-byte offset
    flat.copy_(w)
    assert torch.equal(tp_aggregate.live_rows_l2(flat), tp_aggregate.live_rows_plain(w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_aggregate_l2_tiled_all_dead_gives_exact_zeros(cuda, dtype):
    """Every edge dead: the tiled forward and dx write exact zeros, split or
    not."""
    tp, _ = _l2_tp("layer3")
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    for B, N, M in ((24, 24, 96), (1, 96, 96), (2, 3, 2)):
        x, sh, w, g = _l2_k2_inputs(tp, cuda, B, N, M)
        x, sh, w = x.to(dt), sh.to(dt), torch.zeros_like(w, dtype=dt)
        out = tp_aggregate.launch_forward(tp, x, sh, w)
        dx = tp_aggregate.launch_backward_x(tp, x, sh, w, g)
        torch.cuda.synchronize()
        assert float(out.abs().max()) == 0.0 and float(dx.float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("sig", list(SIGNATURES_L2))
def test_tp_aggregate_l2_layout_count_matches_the_plain_count(cuda, sig):
    """The library's count of the tiled forward's and dx's shared memory
    (dp_tp_aggregate_l2_smem) equals the plain copy of the layout's sums
    that tests/test_torch_kernel_plans.py holds to two blocks an SM, f32
    and bf16; the occupancy query gives two blocks an SM or more."""
    tp, _ = _l2_tp(sig)
    lib = tp_aggregate._library()
    for dx in (False, True):
        sizes = tp_aggregate.layout_sizes_l2(tp, dx)
        for esize in (4, 2):
            assert lib.dp_tp_aggregate_l2_smem(int(dx), *sizes, esize) == \
                layouts.k2_l2_smem(dx, *sizes, esize), (dx, esize)
            assert lib.dp_tp_aggregate_l2_blocks_per_sm(int(dx), *sizes, int(esize == 2)) >= 2


L2_K3_COUNTERS = (tp_scalar.FWD_L2, tp_scalar.BWD_EDGE_L2, tp_scalar.BWD_X_L2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_CONV_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_scalar_l2_conv_matches_plain(cuda, shape, dtype):
    """The second-order layer-0 conv (20x0e in; 0e, 1o and 2e out: the 2e
    path has K = 5 and reads harmonic components 4-8) on K3's 8-lane
    instantiation: forward, edge backward (dw with and without dsh) and dx
    against autograd through the plain version; f32 within 1e-4 of scale,
    bf16 outputs within 1e-5 and gradients within one bf16 rounding step;
    reruns equal to the bit; one launch each of the 8-lane counters."""
    tp = channelwise_tp(SEQ2[0], SH, SEQ2[1])
    assert tp_scalar.all_scalar_paths(tp) and tp_fused.lanes(tp) == 8
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, sh, w = [v.to(dt) for v in _k3_conv_inputs(cuda, tp, *shape)]
    B, N, M, _ = sh.shape
    g = torch.randn((B, N, tp.weight_numel, 8), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    leaves = [v.float().requires_grad_(True) for v in (x, sh, w)]
    ref = tp_scalar.scalar_paths_aggregate_plain(tp, *[v.to(dt) for v in leaves])
    ref_grads = torch.autograd.grad(ref, leaves, g * _lanes(tp, g))
    runs = []
    for _ in range(2):
        before = [k.launches for k in L2_K3_COUNTERS]
        out = tp_scalar.launch_forward(tp, x, sh, w)
        dw, dsh = tp_scalar.launch_backward_edge(tp, x, sh, w, g, True)
        dw_only, none = tp_scalar.launch_backward_edge(tp, x, sh, w, g, False)
        dx = tp_scalar.launch_backward_x(tp, x, sh, w, g)
        assert none is None
        assert [k.launches - b for k, b in zip(L2_K3_COUNTERS, before)] == [1, 2, 1]
        runs.append((out, dx, dsh, dw, dw_only))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, dx, dsh, dw, dw_only = runs[0]
    assert out.shape == (B, N, tp.weight_numel, 8) and float(out[..., 5:].abs().max()) == 0.0
    tol = 1e-4 if dt == torch.float32 else 1e-5
    assert float((out - ref.detach()).abs().max()) <= tol * float(ref.abs().max())
    for name, got, want in zip(("dx", "dsh", "dw", "dw without dsh"), (dx, dsh, dw, dw_only),
                               ref_grads + (ref_grads[2],)):
        assert got.dtype == dt, name
        if dt == torch.float32:
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
        else:
            assert bool(((got.float() - want).abs() <= _bf16_step(want)).all()), name


# ---- the sender-index mode (the KNN phore grid, phore_knn) ----

#: (B, N, K, M_x): ragged tiles, a slot split (B = 1), the serving and the
#: training shapes at K = 24 of a 96-point phore
INDEX_SHAPES = [(3, 37, 5, 29), (1, 96, 24, 96), (40, 96, 24, 96), (24, 96, 24, 96)]
#: the phore convs' signatures at 4 lanes (SEQ) and at 8 (SEQ2)
INDEX_SIGNATURES = {f"{tag}_{sig}": (seq[i], seq[i + 1], SH, 60)
                    for tag, seq in (("l1", SEQ), ("l2", SEQ2))
                    for i, sig in enumerate(("layer0", "layer1", "layer2"))}


def _index_inputs(tp, cuda, B, N, K, Mx, n_chan=1, E=60, seed=0):
    """x (B, Mx, D), a random sender index (B, N, K), edge tensors on (B, N,
    K) with a mask that leaves whole receivers (and every slot past a live
    count) dead, as a KNN grid's padded phore points and short rows do."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    x = t(rng.normal(size=(B, Mx, tp.irreps_in.dim)))
    idx = torch.from_numpy(rng.integers(0, Mx, (B, N, K)).astype(np.int32)).to(cuda)
    sh = t(rng.normal(size=(B, N, K, tp.irreps_sh.dim)))
    live = rng.integers(0, K + 1, (B, N, 1)) > np.arange(K)      # the first `live` slots
    live[:, N // 2:N // 2 + 3] = False                           # padded receivers
    masks = [torch.from_numpy(live & (rng.random((B, N, K)) > 0.2 * c)).to(cuda)
             for c in range(n_chan)]
    attrs = [t(rng.normal(size=(B, N, K, E))) for _ in range(n_chan)]
    return x, idx, sh, attrs, masks


@pytest.mark.cuda
@pytest.mark.parametrize("sig", list(INDEX_SIGNATURES))
@pytest.mark.parametrize("shape", INDEX_SHAPES)
def test_tp_fused_index_mode_matches_plain(cuda, sig, shape):
    """K1's sender-index mode (tp_fused_kernel<T, NC, true> at 4 lanes,
    tp_fused_l2_kernel at 8) against its plain version: f32 within 1e-4 of scale, bf16 within 3e-2;
    two runs bit-equal; one launch each on the index counter of its lanes;
    dead receivers all zero."""
    irr_in, irr_out, irr_sh, E = INDEX_SIGNATURES[sig]
    tp = channelwise_tp(irr_in, irr_sh, irr_out)
    k_pad = tp_fused.lanes(tp)
    counter = tp_fused.KERNEL_IDX if k_pad == 4 else tp_fused.KERNEL_IDX_L2
    x, idx, sh, attrs, masks = _index_inputs(tp, cuda, *shape)
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    F = tp.weight_numel
    params = (t(rng.normal(size=(E, E)) * 0.2), t(rng.normal(size=(E,)) * 0.1),
              t(rng.normal(size=(E, F)) * 0.2), t(rng.normal(size=(F,)) * 0.1))
    bf = torch.bfloat16
    for low in (False, True):
        ops = (x.to(bf), sh.to(bf), [a.to(bf) for a in attrs]) if low else (x, sh, attrs)
        ref = tp_fused.tp_aggregate_fused_plain(tp, *ops, masks, *params, sender_index=idx)
        before = (counter.launches, tp_fused.KERNEL.launches, tp_fused.KERNEL_L2.launches)
        got = tp_fused.tp_aggregate_fused(tp, *ops, masks, *params, sender_index=idx)
        again = tp_fused.tp_aggregate_fused(tp, *ops, masks, *params, sender_index=idx)
        torch.cuda.synchronize()
        assert (counter.launches, tp_fused.KERNEL.launches, tp_fused.KERNEL_L2.launches) == (
            before[0] + 2, before[1], before[2])
        assert torch.equal(got, again) and got.shape == (x.shape[0], shape[1], F, k_pad)
        tol = 3e-2 if low else 1e-4
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
        dead = ~masks[0].any(-1)
        assert float(got[dead].abs().max()) == 0.0


def _index_k2_leaves(tp, cuda, shape, dt):
    x, idx, sh, _, masks = _index_inputs(tp, cuda, *shape)
    B, N, K, _ = shape
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.normal(size=(B, N, K, tp.weight_numel))).astype(np.float32))
    w = (w.to(cuda) * masks[0][..., None]).to(dt)
    g = torch.from_numpy(rng.normal(size=(B, N, tp.weight_numel, tp_fused.lanes(tp)))
                         .astype(np.float32)).to(cuda)
    return x.to(dt), idx, sh.to(dt), w, g


def _assert_grads(names, gots, wants, dt):
    for name, got, want in zip(names, gots, wants):
        assert got.dtype == dt, name
        if dt == torch.float32:
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
        else:
            assert bool(((got.float() - want).abs() <= _bf16_step(want)).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("sig", [s for s in INDEX_SIGNATURES if not s.endswith("layer0")])
@pytest.mark.parametrize("shape", INDEX_SHAPES[::2] + [(2, 1, 24, 17)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_aggregate_index_mode_matches_plain(cuda, sig, shape, dtype):
    """K2's sender-index mode (forward, edge backward, dx by the inverse
    lists) against autograd through the plain version on gathered senders:
    f32 within 1e-4 of scale; bf16 outputs within 1e-5 and gradients within
    one bf16 rounding step; reruns bit-equal; one launch each on the index
    counters of its lanes, none on the dense ones; dsh refused."""
    irr_in, irr_out, irr_sh, _ = INDEX_SIGNATURES[sig]
    tp = channelwise_tp(irr_in, irr_sh, irr_out)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, idx, sh, w, g = _index_k2_leaves(tp, cuda, shape, dt)
    l2 = tp_fused.lanes(tp) == 8
    counters = ((tp_aggregate.FWD_IDX_L2, tp_aggregate.BWD_EDGE_IDX_L2, tp_aggregate.BWD_X_IDX_L2)
                if l2 else (tp_aggregate.FWD_IDX, tp_aggregate.BWD_EDGE_IDX,
                            tp_aggregate.BWD_X_IDX))
    dense = (tp_aggregate.FWD, tp_aggregate.BWD_EDGE, tp_aggregate.BWD_X, tp_aggregate.FWD_L2,
             tp_aggregate.BWD_EDGE_L2, tp_aggregate.BWD_X_L2)
    leaves = [v.float().requires_grad_(True) for v in (x, w)]
    ref = tp_aggregate.tp_aggregate_plain(tp, leaves[0].to(dt), sh, leaves[1].to(dt),
                                          sender_index=idx)
    ref_dx, ref_dw = torch.autograd.grad(ref, leaves, g * _lanes(tp, g))
    runs = []
    for _ in range(2):
        before = [k.launches for k in counters + dense]
        out = tp_aggregate.launch_forward(tp, x, sh, w, sender_index=idx)
        dw, none = tp_aggregate.launch_backward_edge(tp, x, sh, w, g, False, sender_index=idx)
        dx = tp_aggregate.launch_backward_x(tp, x, sh, w, g, sender_index=idx)
        assert none is None
        assert [k.launches - b for k, b in zip(counters + dense, before)] == [1, 1, 1] + [0] * 6
        runs.append((out, dx, dw))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, dx, dw = runs[0]
    tol = 1e-4 if dt == torch.float32 else 1e-5
    ref = ref.detach()
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    _assert_grads(("dx", "dw"), (dx, dw), (ref_dx, ref_dw), dt)
    with pytest.raises(ValueError, match="computes no dsh"):
        tp_aggregate.launch_backward_edge(tp, x, sh, w, g, True, sender_index=idx)


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("shape", INDEX_SHAPES + [(2, 1, 24, 17)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_scalar_index_mode_matches_plain(cuda, l2, shape, dtype):
    """K3's sender-index mode on the layer-0 phore conv (20x0e in): forward,
    edge backward (dw) and dx by the inverse lists against autograd through
    the plain version, tolerances as K2's; reruns bit-equal; one launch each
    on the index counters of its lanes; dsh refused."""
    tp = channelwise_tp(SEQ2[0] if l2 else SEQ[0], SH, SEQ2[1] if l2 else SEQ[1])
    assert tp_scalar.all_scalar_paths(tp)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, idx, sh, w, g = _index_k2_leaves(tp, cuda, shape, dt)
    counters = ((tp_scalar.FWD_IDX_L2, tp_scalar.BWD_EDGE_IDX_L2, tp_scalar.BWD_X_IDX_L2) if l2
                else (tp_scalar.FWD_IDX, tp_scalar.BWD_EDGE_IDX, tp_scalar.BWD_X_IDX))
    leaves = [v.float().requires_grad_(True) for v in (x, w)]
    ref = tp_scalar.scalar_paths_aggregate_plain(tp, leaves[0].to(dt), sh, leaves[1].to(dt),
                                                 sender_index=idx)
    ref_dx, ref_dw = torch.autograd.grad(ref, leaves, g * _lanes(tp, g))
    runs = []
    for _ in range(2):
        before = [k.launches for k in counters]
        out = tp_scalar.launch_forward(tp, x, sh, w, sender_index=idx)
        dw, none = tp_scalar.launch_backward_edge(tp, x, sh, w, g, False, sender_index=idx)
        dx = tp_scalar.launch_backward_x(tp, x, sh, w, g, sender_index=idx)
        assert none is None
        assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 1]
        runs.append((out, dx, dw))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, dx, dw = runs[0]
    tol = 1e-4 if dt == torch.float32 else 1e-5
    ref = ref.detach()
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    _assert_grads(("dx", "dw"), (dx, dw), (ref_dx, ref_dw), dt)
    with pytest.raises(ValueError, match="computes no dsh"):
        tp_scalar.launch_backward_edge(tp, x, sh, w, g, True, sender_index=idx)


@pytest.mark.cuda
def test_index_mode_under_autograd_launches_the_index_kernels(cuda):
    """tp_aggregate and scalar_paths_aggregate with a sender index under
    autograd: one launch of each index-mode kernel, none of the dense ones;
    the gradients equal the direct launches'."""
    for tp, fn, mod in ((channelwise_tp(SEQ[1], SH, SEQ[2]), tp_aggregate.tp_aggregate,
                         tp_aggregate),
                        (channelwise_tp(SEQ[0], SH, SEQ[1]), tp_scalar.scalar_paths_aggregate,
                         tp_scalar)):
        x, idx, sh, w, g = _index_k2_leaves(tp, cuda, (3, 37, 5, 29), torch.float32)
        idx_k = (mod.FWD_IDX, mod.BWD_EDGE_IDX, mod.BWD_X_IDX)
        dense = (mod.FWD, mod.BWD_EDGE, mod.BWD_X, mod.FWD_L2, mod.BWD_EDGE_L2, mod.BWD_X_L2)
        before = [k.launches for k in idx_k + dense]
        leaves = [v.clone().requires_grad_(True) for v in (x, w)]
        out = fn(tp, leaves[0], sh, leaves[1], sender_index=idx)
        gx, gw = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(idx_k + dense, before)] == [1, 1, 1] + [0] * 6
        assert torch.equal(gx, mod.launch_backward_x(tp, x, sh, w, g, sender_index=idx))
        assert torch.equal(gw, mod.launch_backward_edge(tp, x, sh, w, g, False,
                                                        sender_index=idx)[0])
