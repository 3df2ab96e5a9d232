"""The KNN phore grid (``phore_knn``) at the shipped width and through the
port's entry points, against the JAX package on the CPU: the corpus2 model
at K = 24 (the probe ``runs/knn_probe``, written by
``analysis/write_knn_probe.py``), K = 40 against the dense grid, a train
step, the confidence head, the split edge-attribute form of the JAX encoder
at B >= 96, the config round trip, and the inference and evaluation CLIs
serving a KNN model directory.

Tolerances: the corpus2 model at f32 to 1e-5 of the scale of each JAX
output (max |JAX|), its encoder outputs likewise; at bf16 to a quarter of
JAX's own f32-vs-bf16 difference; K = 40 against the dense grid to 1e-5 of
scale in each package (the same edges, sums in another order); a train
step's loss to 1e-4 and its gradient leaves to 1e-4 of the leaf's scale
plus 5e-6 of the largest (tests/test_torch_train_state.py); the small head
to 1e-4 of max(|JAX|, 1).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from diffphore_torch.cli import evaluate as tev
from diffphore_torch.cli import inference as tcli
from diffphore_torch.data import graphs as tgraphs
from diffphore_torch.data.transforms import apply_noise as t_apply_noise
from diffphore_torch.models.confidence import ConfidenceModel as TConfidenceModel
from diffphore_torch.models.layers import set_compute_dtype
from diffphore_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffphore_torch.train.losses import score_matching_loss as t_loss
from diffphore_torch.utils import checkpoints
from diffphore_tpu.data.transforms import apply_noise as j_apply_noise
from diffphore_tpu.models.confidence import ConfidenceModel as JConfidenceModel
from diffphore_tpu.models.score_model import ScoreModel as JScoreModel
from diffphore_tpu.train.losses import score_matching_loss as j_loss
from diffphore_tpu.utils.checkpoints import load_config_yaml as j_load_config_yaml

from torch_port_helpers import (REPO, SMALL, SMALL_BF16, assert_close,
                                assert_within_gap, cached_files, configs, load_pair,
                                noise_draws, noised_pair, port_leaves, port_model,
                                randomize_stats, to_port, train_step_draws)

sys.path.insert(0, os.path.join(REPO, "analysis"))
import write_knn_probe as probe  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5           # of the scale of a JAX output, f32
GAP = 0.25           # of JAX's own f32-vs-bf16 difference
EXAMPLES = os.path.join(REPO, "examples")
KEY = 11             # the corpus2 train step's key (noise levels 0.37 and 0.66)
NAMES = ("tr", "rot", "tor")


def _rel(a, b):
    a, b = (np.asarray(v.detach() if isinstance(v, torch.Tensor) else v, np.float64)
            for v in (a, b))
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.fixture(scope="module")
def corpus2_knn():
    """(JAX config at f32, JAX variables, port config) of corpus2 under the
    probe's config (phore_knn 24), and the reference rows (JAX, port)."""
    jcfg = dataclasses.replace(j_load_config_yaml(probe.OUT), compute_dtype="float32")
    assert jcfg.phore_knn == probe.KNN == 24
    with open(probe.WEIGHTS, "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    tcfg = ScoreModelConfig(**dataclasses.asdict(jcfg))
    jb = jax.tree_util.tree_map(jnp.asarray, probe.reference_batch())
    return jcfg, variables, tcfg, jb, to_port(jb)


def test_full_width_probe_matches_its_jax_reference(corpus2_knn):
    """The probe's config through the port's loader with the corpus2 weights
    (runs/knn_probe holds none: phore_knn adds no parameter): the f32
    forward within 1e-5 of max|JAX| of the committed reference; the shipped
    bf16 forward finite."""
    _, variables, _, _, tb = corpus2_knn
    cfg = checkpoints.load_config_yaml(probe.OUT)
    assert cfg.phore_knn == 24 and cfg.compute_dtype == "bfloat16"
    model = port_model(cfg, variables)
    ref = np.load(os.path.join(probe.OUT, "reference.npz"))
    set_compute_dtype(model, "float32")
    with torch.no_grad():
        got = model(tb)
    for name, g in zip(NAMES, got):
        assert _rel(g, ref[name]) <= TOL, name
    set_compute_dtype(model, "bfloat16")
    with torch.no_grad():
        assert all(bool(torch.isfinite(o).all()) for o in model(tb))


def test_probe_reference_regenerates_equal():
    """The JAX forward that wrote reference.npz, run again, gives the
    committed numbers bit for bit; and K = 24 drops neighbours there (its
    dense forward differs)."""
    ref = np.load(os.path.join(probe.OUT, "reference.npz"))
    again = probe.reference_outputs()
    assert set(again) == set(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(again[k], ref[k], err_msg=k)
    dense = probe.reference_outputs(phore_knn=0)
    assert max(_rel(dense[k], ref[k]) for k in NAMES) > 100 * TOL


def _jax_encoder(jmodel, variables, jb):
    out, state = jmodel.apply(variables, jb, mutable=["intermediates"],
                              capture_intermediates=lambda m, name: m.name == "encoder")
    return out, state["intermediates"]["encoder"]["__call__"][0]


def test_corpus2_knn_encoder_and_scores_match_jax(corpus2_knn):
    """corpus2 at K = 24, f32, on the reference rows: the encoder's ligand
    and phore node features and the three scores, each within 1e-5 of its
    JAX scale."""
    jcfg, variables, tcfg, jb, tb = corpus2_knn
    out, enc = jax.jit(lambda v, b: _jax_encoder(JScoreModel(jcfg), v, b))(variables, jb)
    model = port_model(tcfg, variables)
    captured = []
    hook = model.encoder.register_forward_hook(lambda m, a, o: captured.append(o))
    with torch.no_grad():
        got = model(tb)
    hook.remove()
    for name, g, r in zip(("lig_node_attr", "phore_node_attr"), captured[0], enc):
        assert _rel(g, r) <= TOL, name
    for name, g, r in zip(NAMES, got, out):
        assert _rel(g, r) <= TOL, name


def test_k40_equals_the_dense_grid_in_both_packages(corpus2_knn):
    """K = 40 is at least the largest in-degree of these phores, so the KNN
    grid holds every edge of the dense one: in each package the forward
    equals the dense forward within 1e-5 of scale (f32)."""
    jcfg, variables, tcfg, jb, tb = corpus2_knn
    m = np.asarray(jb.phore_mask)
    deg = (np.asarray(jb.phore_edge_mask) & m[:, :, None] & m[:, None, :]).sum(-1)
    assert 24 < deg.max() <= 40 and (deg.max(axis=1) > 24).all()
    outs = {}
    for k in (0, 40):
        jout = jax.jit(lambda v, b: JScoreModel(dataclasses.replace(jcfg, phore_knn=k)).apply(
            v, b))(variables, jb)
        with torch.no_grad():
            tout = port_model(dataclasses.replace(tcfg, phore_knn=k), variables)(tb)
        outs[k] = (jout, tout)
    for name, i in zip(NAMES, range(3)):
        assert _rel(outs[40][0][i], outs[0][0][i]) <= TOL, f"JAX {name}"
        assert _rel(outs[40][1][i], outs[0][1][i]) <= TOL, f"port {name}"


def test_corpus2_knn_matches_jax_at_the_shipped_bf16(corpus2_knn):
    """corpus2 at K = 24 and its own compute type, bf16, on two noised
    complexes: each score to a quarter of JAX's own f32-vs-bf16 difference."""
    jcfg, variables, tcfg, _, _ = corpus2_knn
    jb, tb = noised_pair([0.7, 0.3], seed=8)
    j16 = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    ref = jax.jit(lambda v, b: JScoreModel(j16).apply(v, b))(variables, jb)
    ref32 = jax.jit(lambda v, b: JScoreModel(jcfg).apply(v, b))(variables, jb)
    with torch.no_grad():
        got = port_model(dataclasses.replace(tcfg, compute_dtype="bfloat16"), variables)(tb)
    gaps = [assert_within_gap({n: g}, {n: r}, {n: r32}, GAP, f"corpus2 KNN {n}")
            for n, g, r, r32 in zip(NAMES, got, ref, ref32)]
    assert min(gaps) >= 1e-3, gaps


def test_corpus2_knn_train_step_matches_jax(corpus2_knn):
    """One training forward and backward of corpus2 at K = 24 (f32, dropout
    0, batch statistics) on the two reference complexes with the same noise
    (a key whose noise levels are t = 0.37 and 0.66: from the shipped
    weights, rows near t = 0 put an element on a step function): the loss
    to 1e-4 and every gradient leaf to 1e-4 of its scale plus 5e-6 of the
    largest."""
    jcfg, variables, tcfg, jb, tb = corpus2_knn
    jcfg, tcfg = (dataclasses.replace(c, dropout=0.0) for c in (jcfg, tcfg))
    key = jax.random.PRNGKey(KEY)
    k_noise, k_drop = jax.random.split(key)
    draws = train_step_draws(key, tb.batch_size, tb.num_torsions)
    assert float(draws.t.min()) > 0.3
    noised, targets = t_apply_noise(tb, tcfg.sigma_schedule, draws=draws)
    jmodel = JScoreModel(jcfg)
    schedule = jcfg.sigma_schedule

    @jax.jit
    def jax_side(params, batch_stats):
        jnoised, jtargets = j_apply_noise(jb, k_noise, schedule)

        def loss_fn(p):
            preds, _ = jmodel.apply({"params": p, "batch_stats": batch_stats}, jnoised,
                                    deterministic=False, use_running_average=False,
                                    mutable=["batch_stats"], rngs={"dropout": k_drop})
            return j_loss(preds, jtargets, jnoised.t, jb.tor_mask, schedule,
                          valid=jb.valid)["loss"]
        return jax.value_and_grad(loss_fn)(params)

    jloss, jgrads = jax_side(variables["params"], variables["batch_stats"])
    model = port_model(tcfg, variables).train()
    m = t_loss(model(noised), targets, noised.t, tb.tor_mask, tcfg.sigma_schedule,
               valid=tb.valid)
    m["loss"].backward()
    assert_close(m["loss"], jloss, 1e-4, "loss")
    want = port_leaves(jgrads)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    floor = 5e-6 * max(float(v.abs().max()) for v in want.values() if v.numel())
    for name, p in params.items():
        ref = want[name].numpy()
        if not ref.size:
            continue
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        assert float(np.abs(got - ref).max()) <= 1e-4 * float(np.abs(ref).max()) + floor, name


def test_confidence_head_under_knn_matches_jax():
    """The confidence head with a KNN encoder (small width, 4 layers,
    K = 8, flax-init weights with random running statistics), f32: its three
    outputs to 1e-4 of max(|JAX|, 1)."""
    jcfg, tcfg = configs(**{**SMALL, "num_conv_layers": 4, "phore_knn": 8})
    jb, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.6, 0.2])
    jmodel = JConfidenceModel(jcfg)
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(2), jb), seed=2)
    ref = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, jb)
    with torch.no_grad():
        got = port_model(tcfg, variables, TConfidenceModel)(tb)
    for name, g, r in zip(("fit", "ph", "ex"), got, ref):
        assert_close(g, r, 1e-4, name)


@pytest.mark.parametrize("k", [0, 8])
def test_split_edge_attributes_at_b96_against_the_port_at_bf16(k):
    """At B >= 96 rows the JAX encoder switches to its split edge-attribute
    matmul (SplitEdgeAttr); at bf16 it rounds otherwise than the dense form,
    which the port keeps at every B (ROADMAP, deliberate deviations).  96
    noised rows of the small bf16 model, on the dense grid and on a KNN one
    (K = 8): the port within a quarter of JAX's own f32-vs-bf16 difference
    of JAX's dense form (the same rows as two dispatches of 48, below the
    switch; eval mode, so rows are independent), and no farther from JAX's
    split form than JAX's dense form is, plus that quarter."""
    from diffphore_torch.data.transforms import apply_noise
    from diffphore_torch.ops.diffusion import SigmaSchedule

    jb, tb = load_pair(cached_files(n=1)[0], rows=96)
    draws = noise_draws(jax.random.PRNGKey(4), 96, tb.num_torsions)
    draws.t = torch.linspace(0.1, 0.9, 96)
    tb, _ = apply_noise(tb, SigmaSchedule(), draws=draws)
    jb = jb.replace(**{f: jnp.asarray(getattr(tb, f).numpy()) for f in tgraphs.ARRAY_FIELDS})
    jcfg16, tcfg16 = configs(**{**SMALL_BF16, "phore_knn": k})
    jcfg32 = dataclasses.replace(jcfg16, compute_dtype="float32")
    variables = randomize_stats(jax.jit(JScoreModel(jcfg16).init)(jax.random.PRNGKey(0), jb))
    f16 = jax.jit(lambda v, b: JScoreModel(jcfg16).apply(v, b))
    split = f16(variables, jb)
    half = lambda i: jax.tree_util.tree_map(
        lambda a: a[48 * i:48 * (i + 1)] if getattr(a, "ndim", 0) and a.shape[0] == 96 else a, jb)
    dense = [np.concatenate(h) for h in zip(f16(variables, half(0)), f16(variables, half(1)))]
    ref32 = jax.jit(lambda v, b: JScoreModel(jcfg32).apply(v, b))(variables, jb)
    with torch.no_grad():
        got = port_model(tcfg16, variables)(tb)
    for n, g, s_, d, r32 in zip(NAMES, got, split, dense, ref32):
        gap = assert_within_gap({n: g}, {n: d}, {n: r32}, GAP, f"B = 96, K = {k}, {n}")
        assert gap >= 1e-3
        scale = float(np.abs(np.asarray(r32)).max())
        port_split = float(np.abs(g.numpy() - np.asarray(s_)).max()) / scale
        dense_split = float(np.abs(d - np.asarray(s_)).max()) / scale
        assert port_split <= dense_split + GAP * gap, (n, port_split, dense_split, gap)


def test_config_round_trip_and_converter_carry_the_knn_model(tmp_path, corpus2_knn):
    """model_parameters.yml written by the port carries phore_knn back; the
    corpus2 checkpoint converts into a KNN model unchanged (the converter
    needs no change: the KNN model has the dense one's parameter names)."""
    _, variables, tcfg, _, _ = corpus2_knn
    checkpoints.save_config_yaml(tcfg, str(tmp_path))
    assert checkpoints.load_config_yaml(str(tmp_path)).phore_knn == 24
    knn = ScoreModel(tcfg)
    dense = ScoreModel(dataclasses.replace(tcfg, phore_knn=0))
    assert set(knn.state_dict()) == set(dense.state_dict())
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    knn.load_state_dict(checkpoints.convert_variables(tree, knn), strict=True)


def _knn_model_dir(tmp_path):
    d = tmp_path / "knn_model"
    d.mkdir()
    with open(os.path.join(probe.OUT, "model_parameters.yml")) as f:
        (d / "model_parameters.yml").write_text(f.read())
    os.symlink(probe.WEIGHTS, d / os.path.basename(probe.WEIGHTS))
    return str(d)


def test_cli_inference_and_evaluate_serve_a_knn_model_dir(tmp_path):
    """cli.inference and cli.evaluate (through FitEngine) on a model
    directory whose yml sets phore_knn: 24, on the CPU: the artifact sets,
    finite fitness and RMSDs."""
    model_dir = _knn_model_dir(tmp_path)
    out = str(tmp_path / "screen")
    task = tmp_path / "task.csv"
    task.write_text("name,ligand_description,phore\n"
                    f"EX01,{EXAMPLES}/EX01.sdf,{EXAMPLES}/example.phore\n")
    tcli.main(["--phore_ligand_csv", str(task), "--model_dir", model_dir, "--out_dir", out,
               "--sample_per_complex", "2", "--inference_steps", "2", "--device", "cpu",
               "--prefetch_workers", "0"])
    assert os.path.exists(os.path.join(out, "ranked_results.csv"))
    res = tev.main(["--test_csv", str(task), "--out_dir", str(tmp_path / "eval"),
                    "--cache_path", str(tmp_path / "cache"), "--model_dir", model_dir,
                    "--sample_per_complex", "2", "--inference_steps", "2",
                    "--bucket_a_min", "24", "--bucket_p_min", "96", "--device", "cpu"])
    assert res["names"] == ["ex01"] or res["names"] == ["EX01"]
    for fname in ("rmsds.npy", "fitscore.npy"):
        arr = np.load(tmp_path / "eval" / fname)
        assert arr.shape == (1, 2) and np.isfinite(arr).all(), fname
