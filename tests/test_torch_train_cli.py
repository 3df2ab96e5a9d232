"""``diffphore_torch.cli.train.main`` on the CPU at a small size: a handful
of cached complexes, a narrow model, two epochs.  Checks what it writes,
that the run directory loads and samples, that a restart resumes, that a
JAX checkpoint initializes a fine-tune, that ``--rate_from_infer`` engages
the calibrated-sampler step by its schedule and floor, and that every flag
of a part that is not ported raises."""

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


@pytest.mark.parametrize("flags,match", [
    (["--model_type", "tank"], "variants slice"),
    (["--confidence_mode"], "confidence-head slice"),
    (["--conf_augment", "2"], "featurization slice"),
    (["--train_csv", "pairs.csv"], "featurization slice"),
    (["--data_dir", "x", "--split_train", "y"], "featurization slice"),
    (["--featurize_only"], "featurization slice"),
    (["--ligand_only"], "featurization slice"),
    (["--phore_augment", "2"], "featurization slice"),
    (["--val_inference_freq", "5"], "evaluation slice"),
])
def test_unported_flags_raise(cache_path, tmp_path, flags, match):
    base = ["--cache_path", cache_path, "--run_dir", str(tmp_path / "r"), "--n_epochs", "1",
            *SMALL_FLAGS]
    if "--val_inference_freq" in flags:
        base = [a for a in base if a not in ("--val_inference_freq", "0")] + ["--batch_size", "2"]
    with pytest.raises(NotImplementedError, match=match):
        tcli.main(base + flags)
    assert not os.path.exists(os.path.join(str(tmp_path / "r"), checkpoints.LAST_MODEL))


def test_unknown_flags_and_missing_caches_are_errors(tmp_path):
    with pytest.raises(SystemExit):          # a featurization knob the port does not define
        tcli.main(["--bucket_a_min", "16", "--device", "cpu"])
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
