"""The port's evaluation CLI (``diffphore_torch.cli.evaluate``) against the
JAX package's on the CPU: the same flags; the same poses injected into both
CLIs' sampling give the same artifacts (every ``.npy`` but the wall times,
``names.json``, ``performance_metrics.json``) within 1e-6, with the
confidence head's row, ``--test_no_overlap`` and ``--use_symmetry_rmsd``;
and one real run of the port's CLI from raw files to metrics."""

import json
import os

import numpy as np
import pytest
import torch

from diffphore_torch.cli import evaluate as tev
from diffphore_torch.utils.logging import PhaseTimers
from diffphore_tpu.cli import evaluate as jev

from torch_port_helpers import REPO

torch.set_num_threads(2)

EXAMPLES = os.path.join(REPO, "examples")
CORPUS2 = os.path.join(REPO, "runs", "corpus2")
POSES = 6
ROWS = ("name,ligand_description,phore,aug_num_ex\n"
        f"ex01,{EXAMPLES}/EX01.sdf,{EXAMPLES}/example.phore,\n"
        f"ex02,{EXAMPLES}/EX02.sdf,,3\n"
        "apap,CC(=O)Nc1ccc(O)cc1,,3\n"
        f"ex03,{EXAMPLES}/EX03.sdf,{EXAMPLES}/example.phore,\n")
FLAGS = ["--sample_per_complex", str(POSES), "--bucket_a_min", "24", "--bucket_p_min", "96",
         "--bucket_p_step", "32"]


@pytest.fixture(scope="module")
def test_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("csv") / "test.csv"
    path.write_text(ROWS)
    return str(path)


def test_flags_parse_as_the_jax_cli():
    argv = ["--test_csv", "t.csv", "--test_no_overlap", "n.txt", "--cache_path", "c",
            "--out_dir", "o", "--model_dir", "m", "--ckpt", "k.msgpack",
            "--allow_random_init", "true", "--confidence_model_dir", "cm",
            "--confidence_ckpt", "ck", "--sample_per_complex", "7", "--inference_steps", "9",
            "--limit_complexes", "3", "--min_phore_num", "2", "--max_phore_num", "12",
            "--num_workers", "4", "--seed", "5", "--bucket_a_min", "48", "--bucket_p_min", "160",
            "--bucket_t_min", "16", "--bucket_a_step", "8", "--bucket_p_step", "32",
            "--bucket_t_step", "4", "--use_symmetry_rmsd", "1", "--data_dir", "d",
            "--split_test", "s"]
    got = vars(tev.parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == vars(jev.parse_args(argv))
    assert vars(tev.parse_args([])) == {**vars(jev.parse_args([])), "device": None}


def _poses(name, batch_orig, n_atoms, a_pad, seed):
    """Poses near the true one (some within 2 A, some far), padded to the
    bucket, a fitness and a confidence row: what a sampler would hand back."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((POSES, a_pad, 3))
    scale = np.linspace(0.2, 3.0, POSES)[:, None, None]
    poses[:, :n_atoms] = batch_orig[None] + rng.normal(size=(POSES, n_atoms, 3)) * scale
    poses[:, n_atoms:] = rng.normal(size=(POSES, a_pad - n_atoms, 3))
    fits = [float(x) for x in rng.uniform(-0.5, 1.0, POSES).astype(np.float32)]
    conf = [float(x) for x in rng.normal(size=POSES).astype(np.float32)]
    return poses, fits, conf


class _Engine:
    """Stands in for both packages' FitEngine: no model is sampled."""

    def __init__(self, *args, **kwargs):
        self.timers = PhaseTimers()
        self.timers.totals["compile"] = 0.0

    def calibrate_batch_stats(self, batch):
        pass


def _port_engine(inject, fail=()):
    """The port's FitEngine stand-in: ``run_complexes`` hands back the
    injected poses as the engine's results (poses cut to the job's atoms;
    the names in ``fail`` as failed complexes)."""

    class Engine(_Engine):
        def run_complexes(self, jobs, skip_failed=False):
            assert skip_failed
            out = []
            for job in jobs:
                if job.name in fail:
                    out.append({"name": job.name, "error": "RuntimeError()"})
                    continue
                poses, fits, conf = inject(job.batch)
                res = {"name": job.name, "poses": poses[:, :job.n_atoms], "fitscore": fits}
                if conf is not None:
                    res["confidence"] = conf
                out.append(res)
            return out

    return Engine


def _run_both(tmp_path, monkeypatch, test_csv, flags, confidence):
    import diffphore_tpu.cli.inference as jinf
    import diffphore_tpu.cli.pipeline as jpipe
    import diffphore_tpu.cli.train as jtrain

    injected = {}

    def inject(batch):
        meta = batch.meta[0]
        name = batch.names[0]
        if name not in injected:
            injected[name] = _poses(name, np.asarray(meta["orig_pos"]), int(meta["n_atoms"]),
                                    int(np.asarray(batch.lig_pos).shape[1]), len(injected))
        poses, fits, conf = injected[name]
        return poses, fits, conf if confidence else None

    monkeypatch.setattr(jinf, "load_model", lambda args: (None, None))
    monkeypatch.setattr(jinf, "load_confidence_model", lambda args: None)
    monkeypatch.setattr(jpipe, "FitEngine", _Engine)
    monkeypatch.setattr(jtrain, "_dispatch_batch_inference", lambda engine, batch: batch)
    monkeypatch.setattr(jtrain, "_collect_batch_inference", inject)
    monkeypatch.setattr(tev, "load_model", lambda args, device: (None, None))
    monkeypatch.setattr(tev, "load_confidence_model", lambda args, device: None)
    monkeypatch.setattr(tev, "FitEngine", _port_engine(inject))
    outs = {}
    for tag, mod, extra in (("jax", jev, []), ("port", tev, ["--device", "cpu"])):
        out = tmp_path / tag
        mod.main(["--test_csv", test_csv, "--out_dir", str(out), "--cache_path",
                  str(tmp_path / f"cache_{tag}"), *FLAGS, *flags, *extra])
        outs[tag] = out
    return outs


@pytest.mark.parametrize("variant", ["plain", "confidence", "no_overlap", "symmetry"])
def test_same_poses_give_the_same_artifacts(variant, test_csv, tmp_path, monkeypatch):
    flags = []
    if variant == "no_overlap":
        (tmp_path / "keep.txt").write_text("ex02\napap\n")
        flags = ["--test_no_overlap", str(tmp_path / "keep.txt")]
    if variant == "symmetry":
        flags = ["--use_symmetry_rmsd", "true"]
    outs = _run_both(tmp_path, monkeypatch, test_csv, flags, confidence=variant == "confidence")
    jax_files = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == jax_files
    assert ("confidence.npy" in jax_files) == (variant == "confidence")
    with open(outs["port"] / "names.json") as f:
        names = json.load(f)
    with open(outs["jax"] / "names.json") as f:
        assert names == json.load(f)
    assert names == ["ex01", "ex02", "apap", "ex03"]
    for fname in jax_files:
        if fname.endswith(".npy") and fname != "run_times.npy":
            a, b = np.load(outs["jax"] / fname), np.load(outs["port"] / fname)
            assert a.shape == b.shape == (4, POSES), fname
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=fname)
    assert np.load(outs["port"] / "run_times.npy").shape == (4,)
    with open(outs["jax"] / "performance_metrics.json") as f:
        want = json.load(f)
    with open(outs["port"] / "performance_metrics.json") as f:
        got = json.load(f)
    assert sorted(got) == sorted(want)
    for k in want:
        if "run_times" not in k:              # wall times
            assert abs(got[k] - want[k]) <= 1e-6, k
    assert any(k.startswith("no_overlap") for k in got) == (variant == "no_overlap")
    assert any(k.startswith("rankbyConfidence") for k in got) == (variant == "confidence")


def test_symmetry_rmsd_is_taken_for_files(test_csv, tmp_path, monkeypatch):
    """With --use_symmetry_rmsd a file ligand's RMSD is the symmetry-corrected
    one (never above the plain one), a SMILES ligand's the plain one."""
    plain = _run_both(tmp_path / "a", monkeypatch, test_csv, [], confidence=False)
    sym = _run_both(tmp_path / "b", monkeypatch, test_csv, ["--use_symmetry_rmsd", "true"],
                    confidence=False)
    a, b = np.load(plain["port"] / "rmsds.npy"), np.load(sym["port"] / "rmsds.npy")
    assert (b <= a + 1e-12).all()
    assert np.array_equal(a[2], b[2])                       # the SMILES row


def test_a_failed_complex_is_left_out(test_csv, tmp_path, monkeypatch):
    """A complex whose sampling the engine reports as failed is logged and
    left out of every artifact; the others keep their rows."""

    def inject(batch):
        meta = batch.meta[0]
        return _poses(batch.names[0], np.asarray(meta["orig_pos"]), int(meta["n_atoms"]),
                      int(np.asarray(batch.lig_pos).shape[1]), 0)[:2] + (None,)

    monkeypatch.setattr(tev, "load_model", lambda args, device: (None, None))
    monkeypatch.setattr(tev, "load_confidence_model", lambda args, device: None)
    monkeypatch.setattr(tev, "FitEngine", _port_engine(inject, fail=("ex02",)))
    out = tmp_path / "out"
    res = tev.main(["--test_csv", test_csv, "--out_dir", str(out), "--cache_path",
                    str(tmp_path / "cache"), *FLAGS, "--device", "cpu"])
    assert res["names"] == ["ex01", "apap", "ex03"]
    with open(out / "names.json") as f:
        assert json.load(f) == res["names"]
    assert np.load(out / "rmsds.npy").shape == (3, POSES)
    assert np.load(out / "run_times.npy").shape == (3,)


def test_refuses_without_a_gpu_or_records(test_csv, tmp_path):
    with pytest.raises(SystemExit, match="Provide --test_csv"):
        tev.main(["--out_dir", str(tmp_path / "o"), "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        tev.main(["--test_csv", test_csv, "--out_dir", str(tmp_path / "o"),
                  "--cache_path", str(tmp_path / "c")])


def test_real_run_on_the_cpu(test_csv, tmp_path):
    """The corpus2 model and head sample 3 poses x 2 steps of each complex
    on the CPU; the artifacts and metrics are those of the JAX CLI's set."""
    out = tmp_path / "eval"
    res = tev.main(["--test_csv", test_csv, "--out_dir", str(out), "--cache_path",
                    str(tmp_path / "cache"), "--model_dir", os.path.join(CORPUS2, "main"),
                    "--confidence_model_dir", os.path.join(CORPUS2, "confidence"),
                    "--sample_per_complex", "3", "--inference_steps", "2",
                    "--bucket_a_min", "24", "--bucket_p_min", "96", "--bucket_p_step", "32",
                    "--use_symmetry_rmsd", "true", "--device", "cpu"])
    assert sorted(os.listdir(out)) == sorted(
        ["centroid_distances.npy", "confidence.npy", "fitscore.npy",
         "min_ex_cross_distances.npy", "min_self_distances.npy", "names.json",
         "performance_metrics.json", "rmsds.npy", "run_times.npy"])
    for fname in ("rmsds.npy", "fitscore.npy", "confidence.npy", "centroid_distances.npy"):
        arr = np.load(out / fname)
        assert arr.shape == (4, 3) and np.isfinite(arr).all(), fname
    with open(out / "performance_metrics.json") as f:
        metrics = json.load(f)
    assert "rankbyConfidence_top1_rmsds_below_2" in metrics
    assert all(np.isfinite(v) for v in metrics.values())
    assert res["names"] == ["ex01", "ex02", "apap", "ex03"]
    assert res["timings"]["featurized"] == 4 and res["timings"]["sample"] > 0


def test_battery_comparison_recomputes_the_stored_metrics():
    """``analysis/compare_eval_ood60_torch.py``: the TPU battery against
    itself, each complex's hit from ``evaluate_results`` on its row averages
    to ``performance_metrics.json`` and the paired differences are 0;
    against the port's committed battery, the same 57 complexes and the
    committed ``compare_eval_ood60.json``, number for number."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "compare_eval_ood60_torch", os.path.join(REPO, "analysis", "compare_eval_ood60_torch.py"))
    cmp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cmp)

    tpu, port = cmp.load(cmp.TPU), cmp.load(cmp.PORT)
    for battery in (tpu, port):
        assert set(battery["hits"]) == set(cmp.METRICS)
        for k, h in battery["hits"].items():
            assert set(np.unique(h)) <= {0.0, 1.0}
            assert abs(100 * h.mean() - battery["stored"][k]) <= 0.01, k
    same = cmp.compare(tpu, tpu, draws=500)
    assert same["n_common"] == 57
    for row in same["metrics"].values():
        assert row["first"] == row["second"]
        assert row["difference_common"] == 0.0 and row["difference_common_ci95"] == [0.0, 0.0]
        assert row["first_ci95"][0] <= row["first"] <= row["first_ci95"][1]
    got = cmp.compare(tpu, port)
    with open(cmp.OUT) as f:
        want = json.load(f)
    assert got["n_common"] == 57 and not got["only_first"] and not got["only_second"]
    assert got == {k: v for k, v in want.items() if k not in ("first", "second")}
