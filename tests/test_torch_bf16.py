"""The port at ``compute_dtype="bfloat16"``, the setting of every shipped
config, against the JAX package at bf16 on the CPU (its default, unfused
convolution: edge MLP in bf16, bf16 sender features, harmonics and coupling
tensors, f32 sums).

A convolution is held to 1e-5 of its output scale: the two sides round at
the same points and differ where f32 sums taken in another order flip a bf16
rounding.  Whole models and gradients, where such flips compound through
layers, are held to a quarter of the JAX package's own f32-vs-bf16
difference on the same inputs, measured in the same test; each test also
checks that this difference is far above what it allows, so a port that
computed in f32 would fail it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.models import layers as tl
from diffphore_torch.models.score_model import ScoreModel as TScoreModel
from diffphore_torch.ops import tp_aggregate, tp_fused, tp_scalar
from diffphore_torch.ops.tensor_product import channelwise_tp as t_channelwise_tp
from diffphore_torch.utils.checkpoints import convert_variables
from diffphore_tpu.models import layers as jl
from diffphore_tpu.models.score_model import ScoreModel as JScoreModel
from diffphore_tpu.ops.tensor_product import channelwise_tp as j_channelwise_tp

from torch_port_helpers import (SMALL_BF16, assert_within_gap, configs, corpus2,
                                noised_pair, port_model, randomize_stats)

torch.set_num_threads(2)

CONV_TOL = 1e-5      # of a convolution's output scale
GAP = 0.25           # of JAX's own f32-vs-bf16 difference
GRAD_TOL = 2e-2      # of a conv's edge-MLP and sender gradient norm (see the train-mode test)
SH = "1x0e + 1x1o + 1x2e"
T = lambda x: torch.from_numpy(np.asarray(x).copy())

#: (in irreps, out irreps, edge channels): an all-scalar (layer-0) conv with
#: the ligand's two edge channels, an l <= 1 conv, and a head's
CONVS = [
    ("8x0e", "8x0e + 4x1o", 2),
    ("8x0e + 4x1o", "8x0e + 4x1o + 4x1e", 1),
    ("8x0e + 4x1o + 4x1e + 8x0o", "2x1o + 2x1e", 1),
]


def _conv_inputs(irreps_in, n_chan, seed=0, B=2, N=24, M=40, E=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, M, jl.parse(irreps_in).dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, 9)).astype(np.float32)
    attrs = [rng.normal(size=(B, N, M, E)).astype(np.float32) for _ in range(n_chan)]
    masks = [rng.random((B, N, M)) > 0.4 for _ in range(n_chan)]
    return x, sh, attrs, masks


def _jconv(irreps_in, irreps_out, dtype, E=12):
    return jl.DenseTPConv(in_irreps=irreps_in, out_irreps=irreps_out, n_edge_features=E,
                          hidden_features=16, tp_mode="channelwise", compute_dtype=dtype,
                          dropout=0.0)


def _tconv(irreps_in, irreps_out, variables, E=12):
    conv = tl.DenseTPConv(irreps_in, irreps_out, n_edge_features=E, hidden_features=16,
                          compute_dtype="bfloat16")
    conv.load_state_dict(convert_variables(jax.tree_util.tree_map(np.asarray, dict(variables))),
                         strict=True)
    return conv


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()) / scale


@pytest.mark.parametrize("irreps_in,irreps_out,n_chan", CONVS)
def test_dense_tp_conv_eval_mode_matches_jax_at_bf16(irreps_in, irreps_out, n_chan):
    """Eval mode: K1's plain version in bf16, 1e-5 of the output scale."""
    x, sh, attrs, masks = _conv_inputs(irreps_in, n_chan)
    jargs = (jnp.asarray(x), [jnp.asarray(a) for a in attrs], jnp.asarray(sh),
             [jnp.asarray(m) for m in masks])
    j16 = _jconv(irreps_in, irreps_out, "bfloat16")
    variables = randomize_stats(j16.init(jax.random.PRNGKey(1), *jargs))
    ref = np.asarray(j16.apply(variables, *jargs))
    ref32 = np.asarray(_jconv(irreps_in, irreps_out, "float32").apply(variables, *jargs))
    conv = _tconv(irreps_in, irreps_out, variables).eval()
    with torch.no_grad():
        got = conv(T(x), [T(a) for a in attrs], T(sh), [T(m) for m in masks]).numpy()
    scale = float(np.abs(ref).max())
    err, gap = _rel(got, ref, scale), _rel(ref32, ref, scale)
    assert err <= CONV_TOL, f"{irreps_in} -> {irreps_out}: {err:.2e} of scale"
    assert gap >= 100 * CONV_TOL, f"JAX f32 vs bf16 only {gap:.2e} apart"


@pytest.mark.parametrize("irreps_in,irreps_out,n_chan", CONVS[:2])
def test_dense_tp_conv_train_mode_matches_jax_at_bf16(irreps_in, irreps_out, n_chan):
    """Training mode at dropout 0 (edge MLP under autograd, then K3's plain
    version for the all-scalar conv, K2's for the other), batch statistics:
    the output to 1e-5 of its scale.  The gradients of sum(out * g): those
    of the mix and batch-norm leaves, formed after the f32 sum over senders,
    to 1e-5 of their scale; the rest (edge MLP and sender features) as one
    vector to GRAD_TOL of its L2 norm.  JAX reduces the bias and sender
    gradients over edges in bf16 (the transpose of a broadcast bf16 add
    accumulates in bf16), which moves a bias leaf by percents; the port sums
    them in f32 and rounds once."""
    x, sh, attrs, masks = _conv_inputs(irreps_in, n_chan, seed=1)
    rng = np.random.default_rng(2)
    jattrs = ([jnp.asarray(a) for a in attrs], jnp.asarray(sh), [jnp.asarray(m) for m in masks])
    rmask = rng.random((2, 24)) > 0.2
    variables = _jconv(irreps_in, irreps_out, "bfloat16").init(
        jax.random.PRNGKey(3), jnp.asarray(x), *jattrs)
    g = rng.normal(size=(2, 24, jl.parse(irreps_out).dim)).astype(np.float32)

    def jgrads(dtype):
        conv = _jconv(irreps_in, irreps_out, dtype)

        def loss(params, x_):
            out, _ = conv.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                x_, *jattrs, receiver_mask=jnp.asarray(rmask),
                                deterministic=False, use_running_average=False,
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
            return (out * g).sum(), out

        (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            variables["params"], jnp.asarray(x))
        grads = convert_variables({"params": jax.tree_util.tree_map(np.asarray, dict(gp))})
        return np.asarray(out), {**{k: np.asarray(v) for k, v in grads.items()},
                                 "x": np.asarray(gx)}

    ref, want = jgrads("bfloat16")
    _, want32 = jgrads("float32")
    conv = _tconv(irreps_in, irreps_out, variables).train()
    tx = T(x).requires_grad_(True)
    out = conv(tx, [T(a) for a in attrs], T(sh), [T(m) for m in masks], T(rmask))
    assert _rel(out.detach().numpy(), ref, float(np.abs(ref).max())) <= CONV_TOL
    (out * T(g)).sum().backward()
    got = {name: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for name, p in conv.named_parameters()}
    got["x"] = tx.grad.numpy()
    late = [k for k in want if k.startswith(("mix_", "bn."))]
    for k in late:
        assert _rel(got[k], want[k], float(np.abs(want[k]).max())) <= CONV_TOL, k
    assert max(_rel(want32[k], want[k], float(np.abs(want[k]).max())) for k in late) \
        >= 100 * CONV_TOL
    early = [k for k in want if k not in late]
    err = np.linalg.norm(np.concatenate([(got[k] - want[k]).ravel() for k in early]))
    norm = np.linalg.norm(np.concatenate([np.asarray(want[k]).ravel() for k in early]))
    assert err <= GRAD_TOL * norm, f"edge MLP and sender gradients: {err / norm:.2e} of norm"


@pytest.mark.parametrize("irreps_in,irreps_out", [
    ("8x0e + 4x1o", "8x0e + 4x1o + 4x1e"),
    ("8x0e + 4x1o + 4x1e + 8x0o", "8x0e + 4x1o + 4x1e + 8x0o"),
])
def test_k2_plain_aggregate_matches_jax_at_bf16(irreps_in, irreps_out):
    """K2's plain version on bf16 operands against ``ChannelwiseTP.aggregate``
    of the JAX package on the same bf16 operands: 1e-5 of scale (f32 sums in
    another order), and the bf16-rounded coupling tensors matter."""
    rng = np.random.default_rng(5)
    jtp = j_channelwise_tp(irreps_in, SH, irreps_out)
    tp = t_channelwise_tp(irreps_in, SH, irreps_out)
    B, N, M = 2, 24, 40
    vals = [rng.normal(size=(B, M, tp.irreps_in.dim)), rng.normal(size=(B, N, M, 9)),
            rng.normal(size=(B, N, M, tp.weight_numel))]
    jvals = [jnp.asarray(v, jnp.bfloat16) for v in vals]
    ref = tp_fused.padded_from_blocks(
        tp, [None if b is None else T(np.asarray(b, np.float32)) for b in jtp.aggregate(*jvals)])
    got = tp_aggregate.tp_aggregate(tp, *[T(np.asarray(v, np.float32)).bfloat16() for v in jvals])
    assert got.dtype == torch.float32
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= CONV_TOL * scale
    f32_cg = tp_aggregate.tp_aggregate(tp, *[T(np.asarray(v, np.float32)) for v in jvals])
    assert float((f32_cg - ref).abs().max()) >= 100 * CONV_TOL * scale


@pytest.mark.parametrize("irreps_in,irreps_out", [
    ("8x0e", "8x0e + 4x1o"),
    ("6x0e + 3x0o", "6x0e + 2x1o + 2x1e + 3x0o"),
])
def test_k3_plain_matches_jax_at_bf16_with_its_path_scale(irreps_in, irreps_out):
    """K3's plain version on bf16 operands: the per-path scale alpha *
    bf16(cg) (1.00135 for an l = 1 path) against the JAX package's aggregate
    on the same bf16 operands, 1e-5 of scale; and its gradients, which come
    back in bf16, against autograd through the f32 einsum rounded once."""
    rng = np.random.default_rng(6)
    jtp = j_channelwise_tp(irreps_in, SH, irreps_out)
    tp = t_channelwise_tp(irreps_in, SH, irreps_out)
    scales = {p.l_sh: tp_scalar.path_scale(p, torch.bfloat16) for p in tp.paths}
    assert scales[0] == 1.0 and abs(scales[1] - 1.00135) < 1e-5
    B, N, M = 2, 24, 40
    vals = [rng.normal(size=(B, M, tp.irreps_in.dim)), rng.normal(size=(B, N, M, 9)),
            rng.normal(size=(B, N, M, tp.weight_numel))]
    jvals = [jnp.asarray(v, jnp.bfloat16) for v in vals]
    ref = tp_fused.padded_from_blocks(
        tp, [None if b is None else T(np.asarray(b, np.float32)) for b in jtp.aggregate(*jvals)])
    leaves = [T(np.asarray(v, np.float32)).bfloat16().requires_grad_(True) for v in jvals]
    got = tp_scalar.scalar_paths_aggregate(tp, *leaves)
    scale = float(ref.abs().max())
    assert float((got.detach() - ref).abs().max()) <= CONV_TOL * scale
    g = T(rng.normal(size=(B, N, tp.weight_numel, 4)).astype(np.float32))
    (got * g).sum().backward()
    f32 = [leaf.detach().float().requires_grad_(True) for leaf in leaves]
    ((tp_aggregate.tp_aggregate_plain(tp, f32[0].bfloat16(), f32[1].bfloat16(),
                                      f32[2].bfloat16())) * g).sum().backward()
    for name, leaf, want in zip(("dx", "dsh", "dw"), leaves, f32):
        assert leaf.grad.dtype == torch.bfloat16, name
        step = want.grad.abs() * 2.0 ** -7 + 1e-6 * float(want.grad.abs().max())
        assert bool(((leaf.grad.float() - want.grad).abs() <= step).all()), name


def _small_models(jb, seed=0):
    jcfg16, tcfg16 = configs(**SMALL_BF16)
    jcfg32, _ = configs(**{**SMALL_BF16, "compute_dtype": "float32"})
    variables = randomize_stats(jax.jit(JScoreModel(jcfg16).init)(jax.random.PRNGKey(seed), jb),
                                seed=seed)
    return JScoreModel(jcfg16), JScoreModel(jcfg32), variables, port_model(tcfg16, variables)


def test_small_score_model_matches_jax_at_bf16():
    """The SMALL config (2 conv layers, ns 8, nv 4) with bf16 convs: each
    output to a quarter of JAX's own f32-vs-bf16 difference."""
    jb, tb = noised_pair([0.7, 0.3], seed=8)
    j16, j32, variables, model = _small_models(jb)
    ref = jax.jit(lambda v, b: j16.apply(v, b))(variables, jb)
    ref32 = jax.jit(lambda v, b: j32.apply(v, b))(variables, jb)
    with torch.no_grad():
        got = model(tb)
    gaps = [assert_within_gap({name: g}, {name: r}, {name: r32}, GAP, f"SMALL {name}")
            for name, g, r, r32 in zip(("tr", "rot", "tor"), got, ref, ref32)]
    assert max(gaps) >= 1e-3, gaps


def test_small_score_model_training_gradients_match_jax_at_bf16():
    """One training-mode loss of the SMALL config at bf16, dropout 0, batch
    statistics: the loss, and its gradient into every parameter leaf as one
    vector (L2 norm), each to a quarter of JAX's own f32-vs-bf16
    difference.  The gradient is held as one vector, not leaf by leaf: JAX
    reduces each edge-MLP bias gradient over edges in bf16, which moves such
    a leaf far from f32 (the port sums in f32 and rounds once)."""
    jb, tb = noised_pair([0.6, 0.2], seed=9)
    j16, j32, variables, model = _small_models(jb, seed=1)
    rng = np.random.default_rng(7)
    wts = [rng.normal(size=s).astype(np.float32) for s in ((2, 3), (2, 3), (2, tb.num_torsions))]

    def jloss(jmodel):
        def loss(params):
            out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  jb, deterministic=False, use_running_average=False,
                                  mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(0)})
            return sum((o * w).sum() for o, w in zip(out, wts))
        val, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
        leaves = convert_variables({"params": jax.tree_util.tree_map(np.asarray, dict(grads))})
        return {**leaves, "loss": np.asarray([val])}

    want, want32 = jloss(j16), jloss(j32)
    model.train()
    loss = sum((o * T(w)).sum() for o, w in zip(model(tb), wts))
    loss.backward()
    got = {name: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for name, p in model.named_parameters()}
    assert_within_gap({"loss": np.asarray([float(loss.detach())])},
                      {"loss": want.pop("loss")}, {"loss": want32.pop("loss")}, GAP, "loss")
    gap = assert_within_gap(got, want, want32, GAP, "SMALL training gradients", norm="l2")
    assert gap >= 1e-2, gap


def test_corpus2_forward_matches_jax_at_the_shipped_bf16():
    """The shipped corpus2 checkpoint at its own compute_dtype, bfloat16:
    two cached complexes of bucket 24 x 96 x 8 at t = 0.7 and 0.3, noised
    with the same injected draws on both sides, one forward; each output to
    a quarter of JAX's own f32-vs-bf16 difference."""
    jcfg16, variables, tcfg16, model = corpus2(compute_dtype="bfloat16")
    jcfg32, _, _, _ = corpus2()
    assert tcfg16.compute_dtype == "bfloat16"
    jb, tb = noised_pair([0.7, 0.3], seed=8)
    ref = jax.jit(lambda v, b: JScoreModel(jcfg16).apply(v, b))(variables, jb)
    ref32 = jax.jit(lambda v, b: JScoreModel(jcfg32).apply(v, b))(variables, jb)
    with torch.no_grad():
        got = model(tb)
    assert float(got[2].abs().max()) > 0
    gaps = [assert_within_gap({name: g}, {name: r}, {name: r32}, GAP, f"corpus2 {name}")
            for name, g, r, r32 in zip(("tr", "rot", "tor"), got, ref, ref32)]
    assert min(gaps) >= 1e-3, gaps


def test_compute_dtype_selects_the_route():
    """``float32`` keeps every conv in f32; ``bfloat16`` reaches each conv of
    the score model; anything else is refused."""
    for dtype, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        _, tcfg = configs(**{**SMALL_BF16, "compute_dtype": dtype})
        convs = [m for m in TScoreModel(tcfg).modules() if isinstance(m, tl.DenseTPConv)]
        assert convs and all(m.compute_dtype == want for m in convs)
    with pytest.raises(ValueError, match="compute_dtype"):
        tl.DenseTPConv("8x0e", "8x0e", compute_dtype="float16")
