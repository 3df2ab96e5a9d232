"""``diffphore_torch.cli.train.main`` on the CPU at a small size: a handful
of cached complexes, a narrow model, two epochs.  Checks what it writes,
that the run directory loads and samples, that a restart resumes, that a
JAX checkpoint initializes a fine-tune, that ``--rate_from_infer`` engages
the calibrated-sampler step by its schedule and floor, that
``--confidence_mode`` and ``--val_inference_freq`` write the JAX package's
records and checkpoints that load in both packages, and that
``--use_second_order_repr true`` trains a run directory that serves."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from flax import serialization

from diffphore_torch.cli import train as tcli
from diffphore_torch.cli.pipeline import FitEngine, job_from_cached
from diffphore_torch.data.graphs import load_cached
from diffphore_torch.sampler.sampling import SamplerSettings
from diffphore_torch.train.state import create_train_state, make_train_step
from diffphore_torch.utils import checkpoints, flat_yaml

from torch_port_helpers import CACHE, CORPUS2, REPO, cached_files

torch.set_num_threads(2)

SMALL_FLAGS = ["--ns", "8", "--nv", "4", "--num_conv_layers", "2", "--batch_size", "2",
               "--device", "cpu", "--val_inference_freq", "0"]


@pytest.fixture(scope="module")
def cache_path(tmp_path_factory):
    """5 training and 2 validation complexes of one bucket."""
    root = tmp_path_factory.mktemp("cache")
    files = cached_files(n=7)
    for sub, chunk in (("train_small", files[:5]), ("val_small", files[5:])):
        os.makedirs(root / sub)
        for f in chunk:
            shutil.copy(f, root / sub)
    return str(root)


@pytest.fixture(scope="module")
def run_dir(cache_path, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    tcli.main(["--cache_path", cache_path, "--run_dir", out, "--n_epochs", "2",
               "--test_sigma_intervals", "3", "--reject", *SMALL_FLAGS])
    return out


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_main_writes_metrics_config_and_checkpoint(run_dir):
    recs = _records(run_dir)
    train = [r for r in recs if r.get("mode") != "val"]
    val = [r for r in recs if r.get("mode") == "val"]
    assert [r["epoch"] for r in train] == [0, 1] and [r["epoch"] for r in val] == [0, 1]
    for r in train:
        assert r["steps"] == 3 and r["grad_finite"] == 1.0 and r["lr"] == 1e-3
        assert all(np.isfinite(r[k]) for k in tcli.TRAIN_KEYS)
    for r in val:
        assert all(np.isfinite(r[k]) for k in tcli.VAL_KEYS)
        assert any(k.startswith("int") for k in r)          # sigma-interval buckets
    cfg = flat_yaml.load(os.path.join(run_dir, checkpoints.MODEL_PARAMS_YAML))
    assert cfg["ns"] == 8 and cfg["batch_size"] == 2 and cfg["clash_cutoff"] == [1.0, 2.0, 3.0,
                                                                               4.0, 5.0]
    assert os.path.exists(os.path.join(run_dir, checkpoints.LAST_MODEL))


def test_checkpoint_is_flax_msgpack(run_dir):
    """flax's own reader restores the file: the JAX package's tree layout."""
    with open(os.path.join(run_dir, checkpoints.LAST_MODEL), "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    assert set(tree) == {"step", "params", "batch_stats", "ema_params", "opt_state"}
    assert tree["step"] == 6
    dense = tree["params"]["encoder"]["lig_edge_embedding"]["Dense_0"]
    assert dense["kernel"].shape == (4 + 20 + 20, 8)            # (in, out), flax's layout
    assert tree["params"]["encoder"]["lig_node_embedding"]["Embed_0"]["embedding"].ndim == 2
    assert set(tree["batch_stats"]["encoder"]["lig_conv_0"]["bn"]) == {"mean", "var"}
    assert tree["opt_state"]["mu"]["encoder"]["lig_conv_0"]["fc_w1"].shape == (24, 24)


def test_run_directory_loads_and_samples(run_dir):
    """load_model_dir reads the run directory (raw and EMA weights) and
    FitEngine samples finite poses with it."""
    cfg, model = checkpoints.load_model_dir(run_dir, device="cpu",
                                            checkpoint=checkpoints.LAST_MODEL)
    _, ema = checkpoints.load_model_dir(run_dir, device="cpu", checkpoint=checkpoints.LAST_MODEL,
                                        use_ema=True)
    assert cfg.ns == 8 and not model.training
    a, b = model.state_dict(), ema.state_dict()
    assert any(not torch.equal(a[k], b[k]) for k in a)
    assert float(model.encoder.lig_conv_0.bn.var.sub(1).abs().max()) > 0    # statistics moved
    engine = FitEngine(cfg, ema, samples_per_complex=2,
                       settings=SamplerSettings(inference_steps=2), seed=0, device="cpu")
    (res,) = engine.run_complexes([job_from_cached(load_cached(cached_files(n=1)[0]))])
    assert np.isfinite(res["poses"]).all() and np.isfinite(res["fitscore"]).all()


def test_save_and_load_train_state_round_trip(run_dir, tmp_path):
    cfg = checkpoints.load_config_yaml(run_dir)
    state = create_train_state(cfg, seed=5, device="cpu")
    checkpoints.load_train_state(state, os.path.join(run_dir, checkpoints.LAST_MODEL))
    assert state.step == 6 and state.learning_rate == 1e-3
    path = str(tmp_path / "copy.msgpack")
    checkpoints.save_train_state(state, path)
    again = create_train_state(cfg, seed=9, device="cpu")
    checkpoints.load_train_state(again, path)
    for (k, a), (_, b) in zip(state.model.state_dict().items(), again.model.state_dict().items()):
        assert torch.equal(a, b), k
    for k in state.ema_params:
        assert torch.equal(state.ema_params[k], again.ema_params[k])
    for pa, pb in zip(state.model.parameters(), again.model.parameters()):
        sa, sb = state.optimizer.state[pa], again.optimizer.state[pb]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
        assert float(sa["step"]) == float(sb["step"]) == 6.0
    # the restored optimizer steps exactly like the original
    tb = load_cached(cached_files(n=1)[0]).replace(names=(), meta=())
    step = make_train_step(cfg)
    for s in (state, again):
        step(s, tb, torch.Generator().manual_seed(0))
    for pa, pb in zip(state.model.parameters(), again.model.parameters()):
        assert torch.equal(pa, pb)


def test_restart_resumes_at_the_next_epoch(run_dir, cache_path):
    before = len(_records(run_dir))
    tcli.main(["--cache_path", cache_path, "--run_dir", run_dir, "--restart_dir", run_dir,
               "--n_epochs", "3", "--restart_lr", "5e-4", *SMALL_FLAGS])
    new = _records(run_dir)[before:]
    assert [r["epoch"] for r in new] == [2, 2]                 # one train, one val record
    assert new[0]["lr"] == 5e-4 and new[0]["steps"] == 3
    with open(os.path.join(run_dir, checkpoints.LAST_MODEL), "rb") as f:
        assert serialization.msgpack_restore(f.read())["step"] == 9


def test_pretrain_from_the_jax_checkpoint(cache_path, tmp_path):
    """corpus2's shipped msgpack initializes params, EMA and batch stats of a
    full-width fine-tune (one step of one batch); the step count starts at 0."""
    out = str(tmp_path / "ft")
    full = checkpoints.load_config_yaml(CORPUS2)
    tcli.main(["--cache_path", cache_path, "--run_dir", out, "--n_epochs", "1",
               "--limit_complexes", "2", "--batch_size", "2", "--device", "cpu",
               "--val_inference_freq", "0", "--lr", "1e-5", "--pretrain_model_pt",
               os.path.join(CORPUS2, checkpoints.BEST_EMA_MODEL)])
    cfg, model = checkpoints.load_model_dir(out, device="cpu", checkpoint=checkpoints.LAST_MODEL)
    assert cfg.ns == full.ns and cfg.num_conv_layers == full.num_conv_layers
    _, ref = checkpoints.load_model_dir(CORPUS2, device="cpu")
    a, b = model.state_dict(), ref.state_dict()
    w = "encoder.lig_conv_0.fc_w1"
    assert float((a[w] - b[w]).abs().max()) <= 2e-5            # one Adam step at lr 1e-5
    assert float((a[w] - b[w]).abs().max()) > 0
    recs = _records(out)
    assert recs[0]["steps"] == 1 and np.isfinite(recs[0]["loss"])


def test_second_order_trains_a_run_directory_that_serves(cache_path, tmp_path):
    """--use_second_order_repr true: one epoch on the CPU, a model_parameters.yml
    that carries the flag, a checkpoint that loads as an l = 2 model, and
    FitEngine samples finite poses with it."""
    out = str(tmp_path / "r")
    tcli.main(["--cache_path", cache_path, "--run_dir", out, "--n_epochs", "1",
               "--use_second_order_repr", "true", *SMALL_FLAGS])
    recs = [r for r in _records(out) if r.get("mode") != "val"]
    assert recs[0]["steps"] == 3 and recs[0]["grad_finite"] == 1.0
    assert flat_yaml.load(os.path.join(out, checkpoints.MODEL_PARAMS_YAML))[
        "use_second_order_repr"] is True
    cfg, model = checkpoints.load_model_dir(out, device="cpu", checkpoint=checkpoints.LAST_MODEL)
    assert cfg.use_second_order_repr and "2o" in model.encoder.out_irreps
    engine = FitEngine(cfg, model, samples_per_complex=2,
                       settings=SamplerSettings(inference_steps=2), seed=0, device="cpu")
    (res,) = engine.run_complexes([job_from_cached(load_cached(cached_files(n=1)[0]))])
    assert np.isfinite(res["poses"]).all() and np.isfinite(res["fitscore"]).all()


def test_unknown_flags_and_missing_caches_are_errors(tmp_path):
    with pytest.raises(SystemExit):          # a flag neither package defines
        tcli.main(["--no_such_flag", "16", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no train_"):
        tcli.main(["--cache_path", str(tmp_path), "--device", "cpu", "--run_dir",
                   str(tmp_path / "r")])
    with pytest.raises(RuntimeError):        # no GPU here and the CPU not asked for
        if torch.cuda.is_available():
            raise RuntimeError("a GPU is present")
        tcli.main(["--cache_path", os.path.dirname(CACHE), "--run_dir", str(tmp_path / "r")])


def test_config_file_overrides_flags(cache_path, tmp_path):
    cfg_file = tmp_path / "over.yml"
    cfg_file.write_text("ns: 8\nnv: 4\nnum_conv_layers: 2\ndropout: 0.0\n")
    args = tcli.parse_args(["--config", str(cfg_file), "--device", "cpu"])
    cfg = tcli.model_config_from_args(args)
    assert (cfg.ns, cfg.nv, cfg.num_conv_layers, cfg.dropout) == (8, 4, 2, 0.0)
    assert cfg.tp_mode == "channelwise" and cfg.consider_norm


def _cc_run(cache_path, out, n_epochs, *flags):
    tcli.main(["--cache_path", cache_path, "--run_dir", out, "--n_epochs", str(n_epochs),
               *SMALL_FLAGS, *flags])
    return [r for r in _records(out) if r.get("mode") != "val"]


def test_rate_from_infer_engages_at_epoch_from_infer(cache_path, tmp_path):
    """Two epochs that cross ``--epoch_from_infer 1``: epoch 0 runs the plain
    step, epoch 1 the calibrated-sampler step (its record holds the share of
    graphs that took the branch); the three values land in the YAML."""
    out = str(tmp_path / "cc")
    e0, e1 = _cc_run(cache_path, out, 2, "--rate_from_infer", "0.6", "--epoch_from_infer", "1")
    assert e0["p_from_infer"] == 0.0 and "cc_share" not in e0
    assert e1["p_from_infer"] == 0.6 and 0.0 <= e1["cc_share"] <= 1.0
    for r in (e0, e1):
        assert r["steps"] == 3 and r["grad_finite"] == 1.0
        assert all(np.isfinite(r[k]) for k in tcli.TRAIN_KEYS)
    cfg = flat_yaml.load(os.path.join(out, checkpoints.MODEL_PARAMS_YAML))
    assert (cfg["rate_from_infer"], cfg["epoch_from_infer"], cfg["dynamic_coeff"]) == (0.6, 1, 0.0)
    _, model = checkpoints.load_model_dir(out, device="cpu", checkpoint=checkpoints.LAST_MODEL)
    assert not model.training


@pytest.mark.parametrize("flags,engaged", [
    # the shipped recipe at epoch 0: the sigmoid gives 0.002, under the floor of 0.01
    (["--rate_from_infer", "0.6", "--epoch_from_infer", "300", "--dynamic_coeff", "6.0"], False),
    # the same schedule with u = 1 is on its plateau at once
    (["--rate_from_infer", "0.6", "--epoch_from_infer", "1", "--dynamic_coeff", "6.0"], True),
    # a small rate engages too: the floor is relative, min(0.01, rate / 2)
    (["--rate_from_infer", "0.008", "--epoch_from_infer", "0"], True),
    (["--rate_from_infer", "0.0", "--epoch_from_infer", "0"], False),
])
def test_cc_floor_gate(cache_path, tmp_path, flags, engaged):
    (rec,) = _cc_run(cache_path, str(tmp_path / "gate"), 1, "--limit_complexes", "2", *flags)
    assert ("cc_share" in rec) == engaged
    assert (rec["p_from_infer"] > 0) == engaged


def test_cc_probability_follows_the_jax_cli_gating():
    """``p_cc`` as diffphore_tpu/cli/train.py computes it: the dynamic
    schedule when --dynamic_coeff > 0, else the rate from the epoch on."""
    from diffphore_torch.train.ccsampler import dynamic_schedule

    args = tcli.parse_args(["--rate_from_infer", "0.6", "--dynamic_coeff", "6.0"])
    assert (args.epoch_from_infer, args.delta_t) == (300, 0.05)
    for epoch in (0, 150, 300, 600):
        assert tcli.cc_probability(args, epoch) == dynamic_schedule(epoch, 0.6, 300, 6.0)
    assert tcli.cc_probability(args, 0) < 0.01 < tcli.cc_probability(args, 150)
    args = tcli.parse_args(["--rate_from_infer", "0.4", "--epoch_from_infer", "7"])
    assert [tcli.cc_probability(args, e) for e in (0, 6, 7, 8)] == [0.0, 0.0, 0.4, 0.4]
    assert tcli.cc_probability(tcli.parse_args([]), 500) == 0.0


# ------------------------------------------------------------------ confidence head

CONF_KEYS = ("loss", "loss_ph", "loss_ex", "loss_total")


@pytest.fixture(scope="module")
def confidence_run(cache_path, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("conf"))
    tcli.main(["--confidence_mode", "--cache_path", cache_path, "--run_dir", out,
               "--n_epochs", "2", "--compute_dtype", "float32", "--confidence_label", "fitness",
               "--by_total", "--confidence_no_batchnorm", *SMALL_FLAGS])
    return out


def test_confidence_mode_writes_the_jax_records(confidence_run):
    recs = _records(confidence_run)
    assert [(r["mode"], r["epoch"]) for r in recs] == [
        ("confidence", 0), ("confidence_val", 0), ("confidence", 1), ("confidence_val", 1)]
    for r in recs:
        assert all(np.isfinite(r[k]) for k in CONF_KEYS)
        assert r["loss"] == r["loss_total"]                       # --by_total
    assert recs[0]["steps"] == 3 and recs[0]["lr"] == 1e-3
    cfg = flat_yaml.load(os.path.join(confidence_run, checkpoints.MODEL_PARAMS_YAML))
    assert (cfg["mode"], cfg["confidence_label"], cfg["by_total"], cfg["ns"]) == (
        "confidence", "fitness", True, 8)
    for name in (checkpoints.LAST_MODEL, checkpoints.BEST_EMA_MODEL):
        assert os.path.exists(os.path.join(confidence_run, name))


def test_confidence_run_directory_loads_in_both_packages(confidence_run):
    """The best-EMA file loads in the port (``load_confidence_dir``) and, as
    ``{"params", "batch_stats"}``, in the JAX package
    (``checkpoints.load_variables``); both heads give the same outputs.  The
    last-model file's EMA shadow loads in the port too."""
    import jax

    from diffphore_tpu.data.dataset import load_complex
    from diffphore_tpu.models.confidence import ConfidenceModel as JConfidenceModel
    from diffphore_tpu.utils import checkpoints as jckpt

    from torch_port_helpers import noised_pair

    cfg, head = checkpoints.load_confidence_dir(confidence_run, device="cpu")
    _, last = checkpoints.load_confidence_dir(confidence_run, device="cpu",
                                              checkpoint=checkpoints.LAST_MODEL, use_ema=True)
    for (k, a), b in zip(head.state_dict().items(), last.state_dict().values()):
        assert torch.equal(a, b), k          # the last epoch had the best val loss
    jcfg = jckpt.load_config_yaml(confidence_run)
    assert (jcfg.ns, jcfg.compute_dtype) == (cfg.ns, cfg.compute_dtype) == (8, "float32")
    jmodel = JConfidenceModel(jcfg)
    template = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                    load_complex(cached_files(n=1)[0]).replace(names=(), meta=()))
    for name in (checkpoints.BEST_EMA_MODEL, checkpoints.LAST_MODEL):
        jckpt.load_variables(template, os.path.join(confidence_run, name))
    variables = jckpt.load_variables(template,
                                     os.path.join(confidence_run, checkpoints.BEST_EMA_MODEL))
    jb, tb = noised_pair([0.5, 0.1], seed=2)
    want = jax.jit(jmodel.apply)(variables, jb)
    with torch.no_grad():
        got = head(tb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_confidence_restart_takes_the_state_and_learning_rate(confidence_run, cache_path,
                                                              tmp_path):
    """``--restart_dir`` restores the head's train state (its step count
    goes on from the 6 steps of the run) and ``--restart_lr`` sets the
    rate; the epochs count from 0, as in the JAX package's loop."""
    out = str(tmp_path / "again")
    tcli.main(["--confidence_mode", "--cache_path", cache_path, "--run_dir", out,
               "--restart_dir", confidence_run, "--restart_lr", "5e-4", "--n_epochs", "1",
               "--compute_dtype", "float32", *SMALL_FLAGS])
    rec = _records(out)[0]
    assert (rec["mode"], rec["epoch"], rec["lr"], rec["steps"]) == ("confidence", 0, 5e-4, 3)
    with open(os.path.join(out, checkpoints.LAST_MODEL), "rb") as f:
        assert serialization.msgpack_restore(f.read())["step"] == 9


def test_tank_with_confidence_mode_exits(tmp_path):
    with pytest.raises(SystemExit, match="diff-model"):
        tcli.main(["--confidence_mode", "--model_type", "tank", "--device", "cpu",
                   "--run_dir", str(tmp_path / "r")])


# ------------------------------------------------------------------ validation by inference

VALINF_KEYS = ("valinf_rmsds_lt2", "valinf_rmsds_lt5", "valinf_mean_rmsd",
               "valinf_mean_fitscore", "valinf_clash_fraction", "valinf_n")


def test_val_inference_writes_valinf_records_and_best_ema(cache_path, tmp_path):
    """One epoch with validation by inference (2 validation complexes x 3
    poses x 3 steps) on the EMA weights: the JAX keys, finite values, and a
    best-EMA file that loads in both packages with the same outputs."""
    import jax

    from diffphore_tpu.data.dataset import load_complex
    from diffphore_tpu.models import ScoreModel as JScoreModel
    from diffphore_tpu.utils import checkpoints as jckpt

    from torch_port_helpers import noised_pair

    out = str(tmp_path / "vi")
    tcli.main(["--cache_path", cache_path, "--run_dir", out, "--n_epochs", "1",
               *SMALL_FLAGS, "--val_inference_freq", "1", "--inference_steps", "3",
               "--inference_samples", "3", "--compute_dtype", "float32"])
    recs = _records(out)
    (vi,) = [r for r in recs if "valinf_n" in r]
    assert set(VALINF_KEYS) | {"epoch"} == set(vi)
    assert vi["valinf_n"] == 2 and vi["epoch"] == 0
    assert all(np.isfinite(vi[k]) for k in VALINF_KEYS)
    assert 0.0 <= vi["valinf_rmsds_lt2"] <= vi["valinf_rmsds_lt5"] <= 1.0
    _, model = checkpoints.load_model_dir(out, device="cpu")
    jcfg = jckpt.load_config_yaml(out)
    jmodel = JScoreModel(jcfg)
    template = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                    load_complex(cached_files(n=1)[0]).replace(names=(), meta=()))
    variables = jckpt.load_variables(template, os.path.join(out, checkpoints.BEST_EMA_MODEL))
    jb, tb = noised_pair([0.5, 0.3], seed=1)
    want = jax.jit(jmodel.apply)(variables, jb)
    with torch.no_grad():
        got = model(tb)
    for g, w in zip(got, want):
        scale = max(float(np.abs(np.asarray(w)).max()), 1.0)
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-5 * scale


def test_val_inference_matches_a_hand_computation(cache_path):
    """The valinf_* values from the poses FitEngine samples with the same
    seed: the fitness-ranked top pose's plain RMSD to the cached true pose
    and its least distance to an exclusion sphere's center."""
    from diffphore_torch.chem.rmsd import plain_rmsd
    from diffphore_torch.data.dataset import CachedDataset
    from diffphore_torch.models.score_model import ScoreModel, init_parameters

    args = tcli.parse_args(["--inference_steps", "2", "--inference_samples", "3", "--seed", "4",
                            "--ns", "8", "--nv", "4", "--num_conv_layers", "2"])
    cfg = tcli.model_config_from_args(args)
    model = init_parameters(ScoreModel(cfg), 0).eval()
    val = CachedDataset([os.path.join(cache_path, "train_small")])
    vm = tcli.val_inference(cfg, model, val, args, "cpu", max_complexes=3)
    engine = FitEngine(cfg, model, samples_per_complex=3,
                       settings=SamplerSettings(inference_steps=2), seed=4, device="cpu")
    results = engine.run_complexes([job_from_cached(val[i]) for i in range(3)])
    rmsds, clashes = [], []
    for i, r in enumerate(results):
        best = int(np.argmax(r["fitscore"]))
        rmsds.append(plain_rmsd(r["poses"][best], val[i].meta[0]["orig_pos"]))
        b = val[i]
        ex = (b.phoretype[0, :, -1] == 1) & b.phore_mask[0]
        if bool(ex.any()):
            centers = (b.phore_pos[0][ex] + b.orig_center[0]).numpy()
            d = np.linalg.norm(r["poses"][best][:, None] - centers[None], axis=-1)
            clashes.append(float(d.min() < 1.0))
    assert vm["valinf_n"] == 3
    assert vm["valinf_mean_rmsd"] == pytest.approx(np.mean(rmsds), rel=1e-6)
    assert vm["valinf_rmsds_lt5"] == np.mean(np.asarray(rmsds) < 5)
    assert vm["valinf_clash_fraction"] == (np.mean(clashes) if clashes else 0.0)
    assert vm["valinf_mean_fitscore"] == pytest.approx(
        np.mean([max(r["fitscore"]) for r in results]), rel=1e-6)


@pytest.fixture(scope="module")
def corpus2_cpu():
    return checkpoints.load_model_dir(CORPUS2, device="cpu")


@pytest.mark.parametrize("steps,fail_at", [(3, None), (5, None), (3, 1)])
def test_val_inference_matches_the_jax_val_inference(cache_path, corpus2_cpu, monkeypatch,
                                                     steps, fail_at):
    """The JAX trainer's ``val_inference``, given the poses and PhScore1
    that the port's engine samples for each complex, returns the port's
    dict key for key: the top pose chosen (ties included), the atoms cut
    off, the clash share and the aggregation agree.  The shipped model at
    3 steps puts some top poses within 1 A of an exclusion center, at 5
    steps some within 2 A of the true pose.  A complex whose sampling
    raises is logged and left out on both sides (``valinf_n`` one lower)."""
    from diffphore_torch.data.dataset import CachedDataset
    from diffphore_tpu.cli import pipeline as jpipeline
    from diffphore_tpu.cli import train as jtrain
    from diffphore_tpu.data.dataset import load_complex

    n = 5
    args = tcli.parse_args(["--inference_steps", str(steps), "--inference_samples", "4",
                            "--seed", "4", "--num_inference_complexes", str(n)])
    cfg, model = corpus2_cpu
    val = CachedDataset([os.path.join(cache_path, "train_small")])
    assert len(val) == n
    failing = val[fail_at].names[0] if fail_at is not None else None

    sampled = {}
    real_run_batch, real_run_complexes = FitEngine.run_batch, FitEngine.run_complexes
    calls = []

    def run_batch(self, *a, **k):
        calls.append(len(calls))
        if len(calls) - 1 == fail_at:
            raise ValueError("a complex the kernels cannot take")
        return real_run_batch(self, *a, **k)

    def run_complexes(self, jobs, *a, **k):
        results = real_run_complexes(self, jobs, *a, **k)
        for job, res in zip(jobs, results):
            sampled[job.name] = res
        return results

    monkeypatch.setattr(FitEngine, "run_batch", run_batch)
    monkeypatch.setattr(FitEngine, "run_complexes", run_complexes)
    port = tcli.val_inference(cfg, model, val, args, "cpu")
    assert port["valinf_n"] == (n if fail_at is None else n - 1)
    if fail_at is not None:
        assert "error" in sampled[failing]

    class StubEngine:
        def __init__(self, *a, **k):
            pass

    def dispatch(engine, batch):
        name = batch.names[0]
        if name == failing:
            raise ValueError("a complex the kernels cannot take")
        return name

    def collect(name):
        res = sampled[name]
        return res["poses"], res["scores"]["phscore1"].tolist(), None

    monkeypatch.setattr(jpipeline, "FitEngine", StubEngine)
    monkeypatch.setattr(jtrain, "_dispatch_batch_inference", dispatch)
    monkeypatch.setattr(jtrain, "_collect_batch_inference", collect)
    ref = jtrain.val_inference(None, None, [load_complex(f) for f in val.files], args)
    assert set(port) == set(ref)
    for k in ref:
        assert port[k] == ref[k], k


def test_run_complexes_raises_without_skip_failed(monkeypatch):
    """Without ``skip_failed`` a complex whose sampling raises ends the call."""
    from diffphore_torch.models.score_model import ScoreModel, init_parameters

    cfg = tcli.model_config_from_args(tcli.parse_args(["--ns", "8", "--nv", "4",
                                                       "--num_conv_layers", "2"]))
    engine = FitEngine(cfg, init_parameters(ScoreModel(cfg), 0), samples_per_complex=2,
                       settings=SamplerSettings(inference_steps=1), device="cpu")

    def run_batch(*a, **k):
        raise ValueError("a complex the kernels cannot take")

    monkeypatch.setattr(engine, "run_batch", run_batch)
    job = job_from_cached(load_cached(cached_files(n=1)[0]))
    with pytest.raises(ValueError, match="cannot take"):
        engine.run_complexes([job])
    (res,) = engine.run_complexes([job], skip_failed=True)
    assert res == {"name": job.name, "error": "ValueError('a complex the kernels cannot take')"}


def _scripted_val_inference(monkeypatch, values):
    """Replace sampling by a script of (metric, mean RMSD) per round."""
    calls = []

    def fake(cfg, model, val_ds, args, device, max_complexes=None):
        metric, rmsd = values[len(calls)]
        calls.append(max_complexes)
        return {"valinf_rmsds_lt2": metric, "valinf_mean_rmsd": rmsd, "valinf_n": 2}

    monkeypatch.setattr(tcli, "val_inference", fake)
    return calls


@pytest.mark.parametrize("values,rounds,best_at", [
    # no improvement in round 2: patience 1 stops after it
    ([(0.5, 3.0), (0.5, 3.0), (0.9, 1.0)], 2, [0]),
    # a tie on the metric goes to the lower mean RMSD
    ([(0.5, 3.0), (0.5, 2.0), (0.5, 2.5)], 3, [0, 1]),
])
def test_early_stop_and_tie_break(cache_path, tmp_path, monkeypatch, values, rounds, best_at):
    calls = _scripted_val_inference(monkeypatch, values)
    saved = []
    real_save = checkpoints.save_ema_variables
    monkeypatch.setattr(checkpoints, "save_ema_variables",
                        lambda state, path: (saved.append(len(calls) - 1), real_save(state, path)))
    out = str(tmp_path / "es")
    tcli.main(["--cache_path", cache_path, "--run_dir", out, "--n_epochs", "3",
               "--limit_complexes", "2", *SMALL_FLAGS, "--val_inference_freq", "1",
               "--early_stop_patience", "1", "--val_loss_freq", "5"])
    assert len(calls) == rounds and saved == best_at
    train = [r for r in _records(out) if "steps" in r]
    assert [r["epoch"] for r in train] == list(range(rounds))


def test_val_inference_count_cuts_warmup_epochs():
    args = tcli.parse_args(["--warmup_epochs", "2", "--valid_warmup_number", "7"])
    assert [tcli.val_inference_count(args, e, 500) for e in (0, 1, 2)] == [7, 7, None]
    args = tcli.parse_args(["--warmup_epochs", "1", "--valid_warmup_number", "0",
                            "--valid_warmup_propotion", "0.1"])
    assert [tcli.val_inference_count(args, e, 55) for e in (0, 1)] == [5, None]
    assert tcli.val_inference_count(args, 0, 3) == 1
    args = tcli.parse_args([])
    assert (args.num_inference_complexes, args.inference_steps, args.inference_samples,
            args.inference_earlystop_metric, args.inference_earlystop_goal,
            args.early_stop_patience, args.val_inference_freq) == (
        100, 20, 4, "valinf_rmsds_lt2", "max", 0, 5)


# ------------------------------------------------------------ from raw files
EXAMPLES = os.path.join(REPO, "examples")
TRAIN_ROWS = ("name,ligand_description,phore,aug_num_ex\n"
              f"ex01,{EXAMPLES}/EX01.sdf,{EXAMPLES}/example.phore,\n"
              f"ex02,{EXAMPLES}/EX02.sdf,{EXAMPLES}/example.phore,\n"
              "apap,CC(=O)Nc1ccc(O)cc1,,3\n"
              "bad,C1CC(=O,,3\n")
VAL_ROWS = ("name,ligand_description,phore\n"
            f"ex03,{EXAMPLES}/EX03.sdf,{EXAMPLES}/example.phore\n")
CSV_FLAGS = ["--phore_augment", "1", "--conf_augment", "1", "--phore_augment_ex", "3",
             "--bucket_a_min", "24", "--bucket_p_min", "96", "--bucket_p_step", "32"]


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    root = tmp_path_factory.mktemp("csv")
    (root / "train.csv").write_text(TRAIN_ROWS)
    (root / "val.csv").write_text(VAL_ROWS)
    return ["--train_csv", str(root / "train.csv"), "--val_csv", str(root / "val.csv")]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def csv_runs(csvs, tmp_path_factory):
    """One epoch of the port's trainer from the CSVs; the JAX trainer with
    the same flags and no epoch (it featurizes and writes its config)."""
    from diffphore_tpu.cli import train as jcli

    root = tmp_path_factory.mktemp("csvrun")
    common = [*csvs, *CSV_FLAGS, "--ns", "8", "--nv", "4", "--num_conv_layers", "2",
              "--batch_size", "16", "--val_inference_freq", "0"]
    tcli.main([*common, "--cache_path", str(root / "cache_port"), "--run_dir",
               str(root / "port"), "--n_epochs", "1", "--device", "cpu"])
    jcli.main([*common, "--cache_path", str(root / "cache_jax"), "--run_dir", str(root / "jax"),
               "--n_epochs", "0"])
    return root


def test_train_csv_featurizes_the_jax_trainers_records(csv_runs):
    tree = _tree(str(csv_runs / "cache_port"))
    assert tree == _tree(str(csv_runs / "cache_jax"))
    train = [p for p in tree if p.startswith("train_")]
    # 4 rows, each with one sub-phore and one conformer copy; the bad SMILES x3 skipped
    assert len(train) == 12 and sum(p.endswith(".skip") for p in train) == 3
    assert sum(p.startswith("val_") for p in tree) == 1
    recs = _records(str(csv_runs / "port"))
    assert recs[0]["steps"] >= 1 and np.isfinite(recs[0]["loss"])
    assert any(r.get("mode") == "val" for r in recs)


def test_train_csv_writes_the_jax_trainers_config_keys(csv_runs):
    got = flat_yaml.load(os.path.join(str(csv_runs / "port"), checkpoints.MODEL_PARAMS_YAML))
    want = flat_yaml.load(os.path.join(str(csv_runs / "jax"), checkpoints.MODEL_PARAMS_YAML))
    for k in ("phore_augment", "phore_augment_ex", "conf_augment", "inference_steps",
              "batch_size", "lr", "ema_rate", "rate_from_infer", "epoch_from_infer",
              "dynamic_coeff"):
        assert got[k] == want[k], k
    assert (got["phore_augment"], got["conf_augment"], got["phore_augment_ex"]) == (1, 1, 3)
    assert (got["n_epochs"], want["n_epochs"]) == (1, 0)


def test_featurize_only_writes_and_exits(csvs, tmp_path):
    """No device is needed: the caches are written, no run is trained."""
    tcli.main([*csvs, *CSV_FLAGS, "--featurize_only", "--cache_path", str(tmp_path / "c"),
               "--run_dir", str(tmp_path / "r")])
    assert len([p for p in _tree(str(tmp_path / "c")) if p.endswith(".npz")]) == 10
    assert not os.path.exists(tmp_path / "r" / "metrics.jsonl")
    assert not os.path.exists(tmp_path / "r" / checkpoints.LAST_MODEL)


@pytest.mark.parametrize("flags,n_train", [
    (["--conf_augment", "2"], 9),
    (["--phore_augment", "2"], 9),
    (["--ligand_only"], 3),
    (["--matching", "--matching_popsize", "3", "--matching_maxiter", "2"], 3),
    (["--limit_complexes", "2", "--max_lig_size", "12"], 1),
    (["--min_phore_num", "3", "--max_phore_num", "8", "--remove_hs", "false"], None),
    (["--consider_ex", "false", "--ex_connected", "false", "--neighbor_cutoff", "4.0"], 3),
])
def test_data_flags_are_ported(csvs, tmp_path, monkeypatch, flags, n_train):
    """Each data flag reaches the datasets as the JAX trainer's does: the
    same settings digest and records, and the complexes featurized."""
    from diffphore_tpu.cli import train as jcli

    argv = [*csvs, *flags, "--cache_path", str(tmp_path / "c"), "--featurize_only",
            "--run_dir", str(tmp_path / "r")]
    seen = {}
    real = tcli.PhoreDataset

    def spy(records, settings, *args, **kwargs):
        seen["port", kwargs["name"]] = ([r["name"] for r in records], settings.digest())
        return real(records, settings, *args, **kwargs)

    def jax_spy(records, settings, *args, **kwargs):
        seen["jax", kwargs["name"]] = ([r["name"] for r in records], settings.digest())

    monkeypatch.setattr(tcli, "PhoreDataset", spy)
    monkeypatch.setattr(jcli, "PhoreDataset", jax_spy)
    tcli.main(argv)
    jcli.build_datasets(jcli.parse_args(argv))
    for name in ("train", "val"):
        assert seen["port", name] == seen["jax", name]
    train_dir = tmp_path / "c" / f"train_{seen['port', 'train'][1]}"
    n = len([f for f in os.listdir(train_dir) if f.endswith(".npz")])
    if n_train is not None:
        assert n == n_train
