"""The model-family variants of the port against the JAX package on the CPU:
geometric attention (``use_att``), fully connected tensor products
(``tp_mode: fully_connected``) and the Fourier timestep embedding, at a
small size (ns 8, nv 4, 2 conv layers, 1-2 Trioformer blocks) with
flax-initialised weights carried across by ``convert_variables``.

Tolerances: a model's outputs at f32 within 1e-4 of their scale (1e-5 for a
single conv or product); gradients leaf by leaf within 1e-4 of the leaf's
scale plus 5e-6 of the largest (the two transition MLPs that only rescale
the cross-graph edge vector hold rounding noise on both sides); at bf16
within a quarter of JAX's own f32-vs-bf16 difference.  Also: the committed
Fourier table against JAX's draws, checkpoints in both directions, and a
KNN-grid model's train step."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from diffphore_torch.cli.pipeline import FitEngine, job_from_cached
from diffphore_torch.data.graphs import load_cached
from diffphore_torch.data.transforms import apply_noise as t_apply_noise
from diffphore_torch.models import layers as tl
from diffphore_torch.models.confidence import ConfidenceModel
from diffphore_torch.models.score_model import ScoreModel, init_parameters
from diffphore_torch.models.trioformer import TankPhore
from diffphore_torch.ops import diffusion as tdiff
from diffphore_torch.ops import tensor_product as ttp
from diffphore_torch.ops import tp_aggregate, tp_fused, tp_scalar
from diffphore_torch.sampler.sampling import SamplerSettings
from diffphore_torch.train.losses import score_matching_loss as t_loss
from diffphore_torch.utils import checkpoints, flax_msgpack
from diffphore_tpu.cli.pipeline import FitEngine as JFitEngine
from diffphore_tpu.data.dataset import load_complex
from diffphore_tpu.data.graphs import repeat_batch
from diffphore_tpu.data.transforms import apply_noise as j_apply_noise
from diffphore_tpu.models import layers as jl
from diffphore_tpu.models import trioformer as jt
from diffphore_tpu.models.confidence import ConfidenceModel as JConfidenceModel
from diffphore_tpu.models.score_model import ScoreModel as JScoreModel
from diffphore_tpu.ops import tensor_product as jtp
from diffphore_tpu.ops.fitscore import PhoreArrays
from diffphore_tpu.sampler.sampling import SamplerSettings as JSamplerSettings
from diffphore_tpu.train.losses import score_matching_loss as j_loss
from diffphore_tpu.utils import checkpoints as jckpt

from torch_port_helpers import (REPO, SMALL, SMALL_BF16, assert_close, assert_within_gap,
                                cached_files, configs, load_pair, load_pair_batch, port_leaves,
                                port_model, prior_noise, randomize_stats, step_noise,
                                train_step_draws)

torch.set_num_threads(2)
RTOL = 1e-4
T = lambda x: torch.from_numpy(np.array(x))

#: the variants and what they change; the Fourier model at scale 1: at the
#: default 1e4 the arguments of sin reach 1e5 and XLA's jit reassociates
#: t * w * 2 pi (JAX jit and eager differ by 7.5e-3 there; the port matches
#: eager JAX to 6e-8, tests/test_torch_ops.py)
VARIANTS = {
    "use_att": dict(use_att=True),
    "use_att_2_blocks": dict(use_att=True, trioformer_layer=2),
    "fully_connected": dict(tp_mode="fully_connected"),
    "fourier": dict(embedding_type="fourier", embedding_scale=1.0),
    "use_att_fully_connected": dict(use_att=True, tp_mode="fully_connected"),
}


def _small(seed, jb, base=SMALL, **overrides):
    """(JAX config, JAX model, variables with random running stats, port
    config, port model)."""
    jcfg, tcfg = configs(**{**base, **overrides})
    jmodel = JScoreModel(jcfg)
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jb), seed=seed)
    return jcfg, jmodel, variables, tcfg, port_model(tcfg, variables)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_score_model_matches_jax(variant):
    jb, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.7, 0.3])
    _, jmodel, variables, _, model = _small(0, jb, **VARIANTS[variant])
    ref = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, jb)
    with torch.no_grad():
        got = model(tb)
    for name, g, r in zip(("tr", "rot", "tor"), got, ref):
        assert_close(g, r, RTOL, f"{variant} {name}")
    if model.cfg.use_att:
        # the attention mixes the pose into the phore features: no pose-group
        # factoring, even for rows the hint calls poses of one complex
        with torch.no_grad():
            grouped = model(tb, pose_group=2)
        for g, p in zip(grouped, got):
            assert torch.equal(g, p)


@pytest.mark.parametrize("variant", ["use_att", "fully_connected"])
def test_variant_gradients_match_jax(variant):
    """One training-mode forward and backward (dropout 0, batch statistics)
    from the same weights and noise."""
    jcfg, tcfg = configs(**{**SMALL, **VARIANTS[variant]})
    jb, tb = load_pair_batch(cached_files(n=2))
    jmodel = JScoreModel(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jb)
    key = jax.random.PRNGKey(4)
    k_noise, k_drop = jax.random.split(key)
    schedule = jcfg.sigma_schedule

    @jax.jit
    def jax_side(params, batch_stats):
        noised, targets = j_apply_noise(jb, k_noise, schedule)

        def loss_fn(p):
            preds, _ = jmodel.apply({"params": p, "batch_stats": batch_stats}, noised,
                                    deterministic=False, use_running_average=False,
                                    mutable=["batch_stats"], rngs={"dropout": k_drop})
            return j_loss(preds, targets, noised.t, jb.tor_mask, schedule)["loss"]

        return jax.value_and_grad(loss_fn)(params)

    jloss, jgrads = jax_side(variables["params"], variables["batch_stats"])
    model = port_model(tcfg, variables).train()
    noised, targets = t_apply_noise(tb, tcfg.sigma_schedule,
                                    draws=train_step_draws(key, tb.batch_size, tb.num_torsions))
    loss = t_loss(model(noised), targets, noised.t, tb.tor_mask, tcfg.sigma_schedule)["loss"]
    loss.backward()
    assert_close(loss, jloss, RTOL, "loss")
    want = port_leaves(jgrads, model)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    floor = 5e-6 * max(float(v.abs().max()) for v in want.values() if v.numel())
    for name, p in params.items():
        ref = want[name].numpy()
        if not ref.size:
            continue
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        scale = float(np.abs(ref).max())
        assert float(np.abs(got - ref).max()) <= 1e-4 * scale + floor, name


@pytest.mark.parametrize("variant", ["use_att", "fully_connected"])
def test_variant_bf16_within_a_quarter_of_the_gap(variant):
    jb, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.6, 0.2])
    jcfg16, jmodel16, variables, _, model = _small(5, jb, base=SMALL_BF16, **VARIANTS[variant])
    jcfg32 = dataclasses.replace(jcfg16, compute_dtype="float32")
    ref = jax.jit(lambda v, b: jmodel16.apply(v, b))(variables, jb)
    ref32 = jax.jit(lambda v, b: JScoreModel(jcfg32).apply(v, b))(variables, jb)
    with torch.no_grad():
        got = model(tb)
    names = ("tr", "rot", "tor")
    gap = assert_within_gap(dict(zip(names, got)), dict(zip(names, ref)),
                            dict(zip(names, ref32)), 0.25, f"{variant} bf16")
    assert gap > 0


def test_use_att_confidence_head_matches_jax_loads_and_ranks(tmp_path):
    """A use_att head: the forward against JAX, then as a run directory the
    port loads, serving in FitEngine with its confidence row deciding the
    rank."""
    jcfg, tcfg = configs(**{**SMALL, "use_att": True})
    jb, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.5, 0.1])
    jhead = JConfidenceModel(jcfg)
    variables = randomize_stats(jax.jit(jhead.init)(jax.random.PRNGKey(6), jb), seed=6)
    ref = jax.jit(jhead.apply)(variables, jb)
    head = port_model(tcfg, variables, ConfidenceModel)
    with torch.no_grad():
        got = head(tb)
    for g, r in zip(got, ref):
        assert_close(g, r, RTOL, "use_att head")

    run = str(tmp_path / "head")
    jckpt.save_config_yaml(jcfg, run)
    jckpt.save_variables(variables, os.path.join(run, checkpoints.BEST_EMA_MODEL))
    _, loaded = checkpoints.load_confidence_dir(run, device="cpu")
    _, _, _, _, model = _small(7, jb, use_att=True)
    engine = FitEngine(tcfg, model, samples_per_complex=3,
                       settings=SamplerSettings(inference_steps=2), device="cpu",
                       confidence=loaded)
    (res,) = engine.run_complexes([job_from_cached(load_cached(cached_files(n=1)[0]))])
    conf = np.asarray(res["confidence"])
    assert np.isfinite(conf).all()
    np.testing.assert_array_equal(res["rank"], np.argsort(-conf, kind="stable"))


def _jax_engine_run(engine, batch, key, n):
    b = repeat_batch(batch.replace(meta=()), n).replace(names=(), meta=())
    ref = PhoreArrays(
        coord=np.asarray(batch.phore_pos[0]), type_onehot=np.asarray(batch.phoretype[0]),
        alpha=np.asarray(batch.phore_x[0, :, 3]), weight=np.asarray(batch.phore_x[0, :, 4]),
        anchor=np.ones(batch.num_phore, np.float32),
        is_ex=np.asarray(batch.phoretype[0, :, -1] == 1), mask=np.asarray(batch.phore_mask[0]))
    ref = jax.tree_util.tree_map(lambda x: np.repeat(np.asarray(x)[None], n, axis=0), ref)
    run = engine.compile_bucket((b.num_atoms, b.num_phore, b.num_torsions), n)
    pos, scores, _ = run(engine.variables, b, ref, key)
    return np.asarray(pos), {k: np.asarray(v) for k, v in scores.items()}


def test_use_att_fit_engine_dispatch_matches_the_jax_engine():
    """One complex x 4 poses x 3 reverse steps, the same noise, a use_att
    model (f32 convs) on both sides: poses and fitness."""
    n, steps = 4, 3
    path = cached_files(n=1)[0]
    jb, _ = load_pair(path, rows=1)
    jcfg, _, variables, tcfg, model = _small(8, jb, use_att=True)
    key = jax.random.PRNGKey(31)
    k1, k2 = jax.random.split(key)
    job = job_from_cached(load_cached(path))
    T_ = job.batch.num_torsions
    engine = FitEngine(tcfg, model, samples_per_complex=n,
                       settings=SamplerSettings(inference_steps=steps), device="cpu")
    counts = (tp_fused.KERNEL.launches, tp_aggregate.FWD.launches, tp_scalar.FWD.launches)
    (res,) = engine.run_complexes([job], [(prior_noise(k1, n, T_), step_noise(k2, steps, n, T_))])
    assert (tp_fused.KERNEL.launches, tp_aggregate.FWD.launches,
            tp_scalar.FWD.launches) == counts       # the CPU runs the plain versions
    jengine = JFitEngine(jcfg, variables, samples_per_complex=n,
                         settings=JSamplerSettings(inference_steps=steps))
    batch = load_complex(path)
    pos, scores = _jax_engine_run(jengine, batch, key, n)
    poses = pos[:, :job.n_atoms] + np.asarray(batch.orig_center[0])
    np.testing.assert_allclose(res["poses"], poses, atol=2e-3)
    np.testing.assert_allclose(res["fitscore"], scores["phscore1"], atol=1e-4)


# ------------------------------------------------------------------ fully connected products

FC_CASES = [
    ("8x0e", "1x0e + 1x1o + 1x2e", "8x0e + 4x1o"),
    ("8x0e + 4x1o + 4x1e + 8x0o", "1x0e + 1x1o + 1x2e", "8x0e + 4x1o + 4x1e + 8x0o"),
    ("8x0e + 4x1o + 4x1e + 8x0o", "1x1o + 1x0e + 1x1e", "8x0o + 8x0e"),
]


@pytest.mark.parametrize("irreps_in,irreps_sh,irreps_out", FC_CASES)
def test_fully_connected_tp_matches_jax(irreps_in, irreps_sh, irreps_out):
    """The path table, and the product summed over senders against JAX's
    per-edge product summed there."""
    jtab, ttab = (jtp.fully_connected_tp(irreps_in, irreps_sh, irreps_out),
                  ttp.fully_connected_tp(irreps_in, irreps_sh, irreps_out))
    assert ttab.weight_numel == jtab.weight_numel
    assert [(p.i_in, p.i_sh, p.i_out, p.w_slice, p.alpha) for p in ttab.paths] == \
        [(p.i_in, p.i_sh, p.i_out, p.w_slice, p.alpha) for p in jtab.paths]
    rng = np.random.default_rng(1)
    B, N, M = 2, 5, 7
    x = rng.normal(size=(B, M, ttab.irreps_in.dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, ttab.irreps_sh.dim)).astype(np.float32)
    w = rng.normal(size=(B, N, M, ttab.weight_numel)).astype(np.float32)
    xb = jnp.broadcast_to(jnp.asarray(x)[:, None], (B, N, M, x.shape[-1]))
    ref = np.asarray(jtab(xb, jnp.asarray(sh), jnp.asarray(w))).sum(axis=2)
    got = ttab.aggregate(T(x), T(sh), T(w))
    assert_close(got, ref, 1e-5, "fully connected product")


@pytest.mark.parametrize("n_chan", [1, 2])
@pytest.mark.parametrize("train", [False, True])
def test_fully_connected_conv_matches_jax(n_chan, train):
    """The conv at f32, eval mode (running statistics) and training mode
    (batch statistics, dropout 0): output, and in training the gradients of
    a random projection of it."""
    irreps_in, irreps_out = "8x0e + 4x1o", "8x0e + 4x1o + 4x1e"
    rng = np.random.default_rng(2)
    B, N, M, E = 2, 6, 9, 12
    x = rng.normal(size=(B, M, jl.parse(irreps_in).dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, 9)).astype(np.float32)
    attrs = [rng.normal(size=(B, N, M, E)).astype(np.float32) for _ in range(n_chan)]
    masks = [rng.random((B, N, M)) > 0.4 for _ in range(n_chan)]
    proj = rng.normal(size=(B, N, jl.parse(irreps_out).dim)).astype(np.float32)
    jconv = jl.DenseTPConv(in_irreps=irreps_in, out_irreps=irreps_out, n_edge_features=E,
                           hidden_features=16, tp_mode="fully_connected",
                           compute_dtype="float32")
    jargs = (jnp.asarray(x), [jnp.asarray(a) for a in attrs], jnp.asarray(sh),
             [jnp.asarray(m) for m in masks])
    variables = randomize_stats(jconv.init(jax.random.PRNGKey(1), *jargs))
    assert "fc" in variables["params"] and "fc_w1" not in variables["params"]

    def jfwd(params):
        out = jconv.apply({"params": params, "batch_stats": variables["batch_stats"]}, *jargs,
                          use_running_average=not train, mutable=["batch_stats"])[0]
        return out, (out * proj).sum()

    ref, _ = jfwd(variables["params"])
    conv = tl.DenseTPConv(irreps_in, irreps_out, n_edge_features=E, hidden_features=16,
                          tp_mode="fully_connected")
    conv.load_state_dict(checkpoints.convert_variables(
        jax.tree_util.tree_map(np.asarray, dict(variables)), conv), strict=True)
    conv.train(train)
    got = conv(T(x), [T(a) for a in attrs], T(sh), [T(m) for m in masks])
    assert_close(got, ref, 1e-5, "fully connected conv")
    if train:
        jgrads = jax.grad(lambda p: jfwd(p)[1])(variables["params"])
        (got * T(proj)).sum().backward()
        want = port_leaves(jgrads, conv)
        for name, p in conv.named_parameters():
            assert_close(p.grad, want[name].numpy(), 1e-5, f"grad {name}")


# ------------------------------------------------------------------ the Fourier table

def test_fourier_table_is_the_jax_draws():
    """Regenerate the committed table with JAX and compare bit for bit."""
    path = os.path.join(REPO, "analysis", "write_fourier_table.py")
    spec = importlib.util.spec_from_file_location("write_fourier_table", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with np.load(tdiff.FOURIER_TABLE) as z:
        committed = z["normal"]
    np.testing.assert_array_equal(committed, script.draws())
    for half in (1, 10, 128):
        np.testing.assert_array_equal(
            tdiff.fourier_draws(half),
            np.asarray(jax.random.normal(jax.random.PRNGKey(0), (half,), jnp.float32)))
    for half in (0, 129):
        with pytest.raises(ValueError):
            tdiff.fourier_draws(half)


# ------------------------------------------------------------------ checkpoints

def _flat_shapes(tree):
    return {path: np.shape(leaf) for path, leaf in flax_msgpack.flatten(tree)}


@pytest.mark.parametrize("kind", ["use_att", "fully_connected", "tank"])
def test_port_checkpoint_restores_strictly_in_jax(kind, tmp_path):
    """A checkpoint the port writes (fresh weights from a seed) holds exactly
    the leaves and shapes of the JAX template, restores there without the
    older format's migration, and gives the port's outputs; JAX's own
    writing of the same weights loads back into the port leaf for leaf."""
    jb, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.4, 0.8])
    if kind == "tank":
        jmodel, model = jt.TankPhore(8, 2), TankPhore(8, 2)
    else:
        jcfg, tcfg = configs(**{**SMALL, **VARIANTS[kind]})
        jmodel, model = JScoreModel(jcfg), ScoreModel(tcfg)
    model = init_parameters(model, seed=11).eval()
    template = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb)
    template = {"params": template["params"], "batch_stats": template.get("batch_stats", {})}
    path = str(tmp_path / "port.msgpack")
    flax_msgpack.dump({
        "params": checkpoints.variables_from_tensors(model, dict(model.named_parameters())),
        "batch_stats": checkpoints.variables_from_tensors(model, dict(model.named_buffers())),
    }, path)
    with open(path, "rb") as f:
        raw = f.read()
    assert _flat_shapes(serialization.msgpack_restore(raw)) == _flat_shapes(
        jax.tree_util.tree_map(np.asarray, template))
    restored = serialization.from_bytes(template, raw)            # strict: no migration
    ref = jax.jit(jmodel.apply)(restored, jb)
    with torch.no_grad():
        got = model(tb)
    for g, r in zip(got, ref):
        assert_close(g, r, RTOL, f"{kind} restored in JAX")

    back = str(tmp_path / "jax.msgpack")
    jckpt.save_variables(restored, back)
    again = TankPhore(8, 2) if kind == "tank" else ScoreModel(model.cfg)
    again.load_state_dict(checkpoints.convert_variables(flax_msgpack.load(back), again),
                          strict=True)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


def test_fully_connected_checkpoint_keeps_its_fc_and_old_channelwise_migrate():
    """The older channelwise format's ``fc`` renames to ``fc_w1`` only where
    the model holds ``fc_w1``; a fully connected conv's ``fc`` stays."""
    jb, _ = load_pair(cached_files(n=1)[0], rows=1)
    _, _, variables, tcfg, model = _small(9, jb, tp_mode="fully_connected")
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    state = checkpoints.convert_variables(tree, model)
    assert "encoder.lig_conv_0.fc.Dense_0.weight" in state
    assert not any("fc_w1" in k for k in state)
    old = {"params": {"conv": {"fc": {"Dense_0": {"kernel": np.ones((3, 5), np.float32),
                                                  "bias": np.zeros(5, np.float32)},
                                      "Dense_1": {"kernel": np.ones((5, 3), np.float32),
                                                  "bias": np.zeros(3, np.float32)}}}}}
    conv = torch.nn.Module()
    conv.conv = tl.DenseTPConv("3x0e", "3x0e", n_edge_features=3, hidden_features=5,
                               batch_norm=False)
    assert {"conv.fc_w1", "conv.fc_b1", "conv.fc_w2", "conv.fc_b2"} <= set(
        checkpoints.convert_variables(old, conv))


def test_knn_model_builds_and_trains_one_step():
    """phore_knn (the KNN phore grid, once refused) builds, and takes one
    finite train step on the CPU that moves the parameters."""
    from diffphore_torch.train.state import create_train_state, make_train_step

    _, tcfg = configs(**{**SMALL, "phore_knn": 8})
    state = create_train_state(tcfg, seed=0, device="cpu")
    batch = load_pair_batch(cached_files(n=2))[1]
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = make_train_step(tcfg)(state, batch, torch.Generator().manual_seed(0))
    assert float(metrics["grad_finite"]) == 1.0 and np.isfinite(float(metrics["loss"]))
    after = state.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)


def test_second_order_model_builds_and_trains_one_step():
    """use_second_order_repr builds (2e/2o fields from layer 1 on, every conv
    on the 8-lane layout) and takes one finite train step on the CPU."""
    from diffphore_torch.train.state import create_train_state, make_train_step

    _, tcfg = configs(**{**SMALL, "use_second_order_repr": True})
    state = create_train_state(tcfg, seed=0, device="cpu")
    convs = [m for m in state.model.modules() if isinstance(m, tl.DenseTPConv)]
    assert "2e" in state.model.encoder.out_irreps
    assert all(tp_fused.lanes(m.tp) == 8 for m in convs)
    batch = load_pair_batch(cached_files(n=2))[1]
    gen = torch.Generator().manual_seed(0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = make_train_step(tcfg)(state, batch, gen)
    assert float(metrics["grad_finite"]) == 1.0 and np.isfinite(float(metrics["loss"]))
    after = state.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
