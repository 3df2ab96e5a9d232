"""The port's screening CLI (``diffphore_torch.cli.inference``) against the
JAX package's on the CPU: the writers give the same bytes for one result
dict, both CLIs give the same artifact tree, columns and names on
examples/task.csv, and the inputs, resume journal, ``--split_file``,
``--config``, ``--save_visualisation``, ``--min_similarity`` and
``--allow_random_init`` behave as the JAX package's do."""

import argparse
import contextlib
import csv
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from diffphore_torch.chem.sdf import read_molecule as t_read_molecule
from diffphore_torch.cli import inference as tcli
from diffphore_torch.cli.pipeline import FitEngine
from diffphore_torch.models.score_model import ScoreModel
from diffphore_torch.ops import tp_fused
from diffphore_tpu.chem.sdf import read_molecule as j_read_molecule
from diffphore_tpu.cli import inference as jcli

from torch_port_helpers import CORPUS2, REPO, SMALL, configs

torch.set_num_threads(2)

EXAMPLES = os.path.join(REPO, "examples")
TASK = os.path.join(EXAMPLES, "task.csv")
PHORE = os.path.join(EXAMPLES, "example.phore")
SMALL_YML = "ns: 8\nnv: 4\nnum_conv_layers: 2\ndropout: 0.0\ncompute_dtype: float32\n"
FAST = ["--sample_per_complex", "2", "--inference_steps", "2"]


def _result(n_atoms, n=5, steps=3, seed=0, confidence=True, trajectory=True):
    """One result dict as ``run_complexes`` returns it, with tied and
    awkward numbers for the writers."""
    rng = np.random.default_rng(seed)
    fit = [0.25, 0.5, 0.5, -0.125, 1.0 / 3.0][:n]
    keys = ["V_db", "V_ref", "V_overlap", "match_pct", "V_exOverlap", "anchor_pct", "ov_pct",
            "ex_pct", "fitness", "fishing", "phscore2", "phscore3", "phscore4"]
    scores = {k: rng.normal(size=n).astype(np.float32) * 10.0 ** rng.integers(-6, 4)
              for k in keys}
    scores.update(phscore1=np.asarray(fit, np.float32), n_ref=np.full(n, 7.0, np.float32),
                  n_matched=np.arange(n, dtype=np.int64))
    out = {"name": "example_phore_0__EX01", "poses": rng.normal(size=(n, n_atoms, 3)) * 5,
           "fitscore": [float(np.float32(f)) for f in fit], "scores": scores}
    if confidence:
        out["confidence"] = [float(x) for x in rng.normal(size=n).astype(np.float32)]
    if trajectory:
        out["trajectory"] = rng.normal(size=(steps, n, n_atoms, 3)) * 5
    return out


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _same_files(a, b):
    assert _tree(a) == _tree(b)
    for rel in _tree(a):
        with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("confidence,trajectory", [(False, False), (True, True)])
def test_writers_give_the_jax_packages_bytes(tmp_path, confidence, trajectory):
    path = os.path.join(EXAMPLES, "EX01.sdf")
    jmol, tmol = j_read_molecule(path, remove_hs=True), t_read_molecule(path, remove_hs=True)
    result = _result(tmol.num_atoms, confidence=confidence, trajectory=trajectory)
    for pkg, mol, tag in ((jcli, jmol, "j"), (tcli, tmol, "t")):
        out = tmp_path / tag
        args = argparse.Namespace(out_dir=str(out))
        os.makedirs(out / "ranked_poses")
        job = argparse.Namespace(mol=mol, name=result["name"])
        pkg._write_complex_outputs(args, job, result, run_time=1.0 / 7.0)
        pkg.write_score_file(str(out / "alone.score"), "cx", "ref", result["scores"])
    _same_files(tmp_path / "j", tmp_path / "t")


def test_ranked_tables_give_the_jax_packages_bytes(tmp_path):
    """Ties on the maximum broken by the top-5 mean, descending and stable;
    float formatting of pandas' to_csv; the cutoff table; the summary."""
    results = {
        "name": ["p__a", "p__b", "p__c", "q__d", "q__e", "q__f"],
        "fitscore": [[0.5, 0.25], [0.5, 0.25], [0.5, 0.375], [0.1 + 0.2, -1e-5],
                     [1e-7, 12.0], [-2.5, -3.0, 0.0, 0.0, 0.0, 0.0]],
        "run_time": [1.0 / 3.0, 2.5, 1e-05, 12.0, 123456789.125, 0.1],
    }
    for pkg, tag in ((jcli, "j"), (tcli, "t")):
        out = tmp_path / tag
        out.mkdir()
        args = argparse.Namespace(out_dir=str(out), cutoff=0.3, report_results=True)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            pkg.analyze_results(args, results)
        (tmp_path / f"{tag}.log").write_text(log.getvalue().replace(str(out), "OUT"))
    _same_files(tmp_path / "j", tmp_path / "t")
    assert (tmp_path / "j.log").read_text() == (tmp_path / "t.log").read_text()
    rows = list(csv.reader(open(tmp_path / "t" / "ranked_results.csv"), delimiter="\t"))
    assert [r[2] for r in rows[1:]] == ["q__e", "p__c", "p__a", "p__b", "q__d", "q__f"]


def test_inputs_are_read_as_the_jax_package_reads_them(tmp_path):
    smi = tmp_path / "ligands.smi"
    smi.write_text("CCO\n\nc1ccccc1O\n  CC(=O)N  \n")
    lig_dir = tmp_path / "ligs"
    lig_dir.mkdir()
    for name in ("EX03", "EX01"):
        shutil.copy(os.path.join(EXAMPLES, f"{name}.sdf"), lig_dir)
    phore_dir = tmp_path / "phores"
    phore_dir.mkdir()
    shutil.copy(PHORE, phore_dir / "b.phore")
    shutil.copy(PHORE, phore_dir / "a.phore")
    dup = tmp_path / "dup.csv"
    with open(TASK) as f:
        text = f.read()
    dup.write_text(text + text.splitlines()[1] + "\n")
    cases = [dict(phore_ligand_csv=TASK), dict(phore_ligand_csv=str(dup)),
             dict(phore=PHORE, ligand=str(smi)), dict(phore=str(phore_dir), ligand=str(lig_dir)),
             dict(phore=PHORE, ligand="CCO"), dict(phore=str(tmp_path / "missing"), ligand="C")]
    for kw in cases:
        got, want = tcli.read_input(**kw), jcli.read_input(**kw)
        assert got == want, kw
        assert [tcli.complex_name(r) for r in got] == [jcli.complex_name(r) for r in want]
    assert len(tcli.read_input(phore_ligand_csv=str(dup))) == 3


def test_flags_and_config_parse_as_the_jax_package(tmp_path):
    cfg = tmp_path / "cfg.yml"
    cfg.write_text("sample_per_complex: 3\ninference_steps: 7\ncutoff: 0.25\n"
                   "save_visualisation: true\nnot_a_flag: 1\n")
    for argv in ([], ["--config", str(cfg)], ["--target_fishing", "yes", "--ode", "--seed", "4"],
                 ["--overwrite", "1", "--keep_local_structures", "false", "--random_samples",
                  "3", "--min_similarity", "0.5"]):
        got, want = vars(tcli.parse_args(argv)), vars(jcli.parse_args(argv))
        assert got.pop("device") is None
        assert got == want, argv
    for argv in (["--num_processes", "2", "--process_rank", "1", "--prefetch_workers", "0",
                  "--use_mesh", "false"],):
        assert vars(tcli.parse_args(argv)) == dict(vars(jcli.parse_args(argv)), device=None)


def test_cli_artifacts_match_the_jax_cli(tmp_path):
    """examples/task.csv with the corpus2 weights, 2 poses x 2 steps: the
    same file tree, the same columns, names and pose counts; both resume
    without sampling."""
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    common = ["--phore_ligand_csv", TASK, "--model_dir", CORPUS2] + FAST
    jcli.main(common + ["--out_dir", out_j])
    before = tp_fused.KERNEL.launches
    tcli.main(common + ["--out_dir", out_t, "--device", "cpu"])
    assert tp_fused.KERNEL.launches == before          # CPU: plain convs
    assert _tree(out_t) == _tree(out_j)
    with open(os.path.join(out_t, "ranked_results.csv")) as ft, \
            open(os.path.join(out_j, "ranked_results.csv")) as fj:
        rt = list(csv.DictReader(ft, delimiter="\t"))
        rj = list(csv.DictReader(fj, delimiter="\t"))
    assert list(rt[0]) == list(rj[0]) == tcli.RANKED_COLUMNS
    assert sorted(r["name"] for r in rt) == sorted(r["name"] for r in rj)
    for out in (out_t, out_j):
        with open(os.path.join(out, "inference_results.json")) as f:
            journal = json.load(f)
        assert sorted(journal) == ["fitscore", "name", "run_time"]
        assert all(len(fit) == 2 for fit in journal["fitscore"])
    for rel in _tree(out_t):
        if rel.endswith(".sdf"):
            with open(os.path.join(out_t, rel)) as ft, open(os.path.join(out_j, rel)) as fj:
                assert ft.read().count("$$$$") == fj.read().count("$$$$") == 2
        if rel.endswith(".score"):
            with open(os.path.join(out_t, rel)) as ft:
                assert {len(line.split("\t")) for line in ft} == {19}
    with open(os.path.join(out_t, "ranked_results.csv"), "rb") as f:
        table = f.read()
    created = []
    original = tcli.FitEngine

    class Counting(original):
        def __init__(self, *a, **k):
            created.append(1)
            super().__init__(*a, **k)

    tcli.FitEngine = Counting
    try:
        tcli.main(common + ["--out_dir", out_t, "--device", "cpu"])
    finally:
        tcli.FitEngine = original
    assert not created
    with open(os.path.join(out_t, "ranked_results.csv"), "rb") as f:
        assert f.read() == table


@pytest.fixture
def small_model_dir(tmp_path):
    d = tmp_path / "model"
    d.mkdir()
    (d / "model_parameters.yml").write_text(SMALL_YML)
    return str(d)


def _run(argv):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tcli.main(argv + ["--device", "cpu"])
    return log.getvalue()


def test_random_init_calibrates_and_screens(tmp_path, small_model_dir):
    """Without a checkpoint the CLI refuses unless --allow_random_init,
    which calibrates the batch statistics once and then screens."""
    argv = ["--phore", PHORE, "--ligand", os.path.join(EXAMPLES, "EX02.sdf"),
            "--model_dir", small_model_dir, "--out_dir", str(tmp_path / "out")] + FAST
    with pytest.raises(FileNotFoundError, match="allow_random_init"):
        tcli.main(argv + ["--device", "cpu"])
    log = _run(argv + ["--allow_random_init", "true"])
    assert log.count("Batch-stats calibration done") == 1
    assert os.path.exists(tmp_path / "out" / "ranked_results.csv")


def test_resume_reuses_finished_complexes(tmp_path, small_model_dir):
    """With the journal gone, complexes whose ranked SDF and dock log exist
    are reused, not sampled again (the JAX package's per-complex resume)."""
    out = tmp_path / "out"
    argv = ["--phore_ligand_csv", TASK, "--model_dir", small_model_dir, "--out_dir", str(out),
            "--allow_random_init", "true"] + FAST
    _run(argv)
    name = "example_phore_0__EX02"
    log_file = out / "mapping_process" / name / f"{name}_dock.log"
    kept = json.loads(log_file.read_text())
    os.remove(out / "inference_results.json")
    os.remove(out / "ranked_poses" / "example_phore_0__EX01_ranked.sdf")
    sampled = []
    original = FitEngine.run_complexes

    def run_complexes(self, jobs, *a, **k):
        sampled.extend(j.name for j in jobs)
        return original(self, jobs, *a, **k)

    FitEngine.run_complexes = run_complexes
    try:
        _run(argv)
    finally:
        FitEngine.run_complexes = original
    assert sampled == ["example_phore_0__EX01"]
    journal = json.loads((out / "inference_results.json").read_text())
    assert journal["name"][:2] == [name, "example_phore_0__EX03"]
    assert journal["fitscore"][0] == kept["fitscore"] and journal["run_time"][0] == kept["run_time"]
    # --overwrite samples everything again
    sampled.clear()
    FitEngine.run_complexes = run_complexes
    try:
        _run(argv + ["--overwrite", "true"])
    finally:
        FitEngine.run_complexes = original
    assert len(sampled) == 3


def test_featurization_runs_on_the_main_thread(tmp_path, small_model_dir):
    """With ``--prefetch_workers 0`` each complex is featurized on the main
    thread, in input order, and an unparsable row is logged and skipped."""
    import threading

    task = tmp_path / "task.csv"
    task.write_text(open(TASK).read().rstrip("\n") + f"\nbad,C1CC(=O,{PHORE}\n")
    calls = []
    original = FitEngine.prepare

    def prepare(self, name, *a, **k):
        calls.append((name, threading.current_thread() is threading.main_thread()))
        return original(self, name, *a, **k)

    FitEngine.prepare = prepare
    try:
        log = _run(["--phore_ligand_csv", str(task), "--model_dir", small_model_dir,
                    "--out_dir", str(tmp_path / "out"), "--allow_random_init", "true",
                    "--prefetch_workers", "0"] + FAST)
    finally:
        FitEngine.prepare = original
    names = [f"example_phore_0__EX0{i}" for i in (1, 2, 3)] + ["example_phore_0__C1CC(=O"]
    assert calls == [(n, True) for n in names]
    assert "Featurization failed for `example_phore_0__C1CC(=O`, skipped" in log
    journal = json.loads((tmp_path / "out" / "inference_results.json").read_text())
    assert journal["name"] == names[:3]


def test_split_file_smi_list_and_visualisation(tmp_path, small_model_dir):
    """A .smi list screened against one phore, filtered by --split_file (by
    complex name or ligand name), with --config setting the poses and steps
    and --save_visualisation writing one record per step."""
    smi = tmp_path / "ligands.smi"
    smi.write_text("CC(=O)Nc1ccc(O)cc1\nCCOc1ccccc1\nC1CC(=O\n")
    keep = tmp_path / "keep.txt"
    keep.write_text("example_phore_0__CC(=O)Nc1ccc(O)cc1\nC1CC(=O\n")
    cfg = tmp_path / "cfg.yml"
    cfg.write_text("sample_per_complex: 3\ninference_steps: 4\nsave_visualisation: true\n")
    out = tmp_path / "out"
    log = _run(["--phore", PHORE, "--ligand", str(smi), "--model_dir", small_model_dir,
                "--out_dir", str(out), "--allow_random_init", "true", "--config", str(cfg),
                "--split_file", str(keep)])
    assert "split_file: kept 2 records" in log
    assert "Featurization failed for `example_phore_0__C1CC(=O`, skipped" in log
    name = "example_phore_0__CC(=O)Nc1ccc(O)cc1"
    assert json.loads((out / "inference_results.json").read_text())["name"] == [name]
    ranked = (out / "ranked_poses" / f"{name}_ranked.sdf").read_text()
    assert ranked.count("$$$$") == 3
    viz = (out / "mapping_process" / name / f"{name}_visualisation.sdf").read_text()
    assert viz.count("$$$$") == 4 and f"{name}_step_0" in viz
    log = _run(["--phore", PHORE, "--ligand", str(smi), "--model_dir", small_model_dir,
                "--out_dir", str(tmp_path / "none"), "--allow_random_init", "true",
                "--split_file", str(cfg)])
    assert "split_file: kept 0 records" in log


def test_min_similarity_filters_as_the_jax_package(tmp_path, small_model_dir):
    """``perfect_similarity`` of a prepared job equals the JAX package's, and
    a threshold above it leaves the complex out."""
    from diffphore_tpu.cli.pipeline import FitEngine as JFitEngine
    from torch_port_helpers import corpus2

    jcfg, variables, tcfg, _ = corpus2()
    jengine = JFitEngine(jcfg, variables, samples_per_complex=2)
    _, small = configs(**SMALL)
    engine = FitEngine(small, ScoreModel(small), samples_per_complex=2, device="cpu")
    sims = []
    for lig in ("EX01.sdf", "EX03.sdf"):
        path = os.path.join(EXAMPLES, lig)
        got = tcli.perfect_similarity(engine.prepare("cx", path, PHORE))
        want = jcli.perfect_similarity(jengine.prepare("cx", path, PHORE))
        assert got == pytest.approx(want, abs=1e-12)
        sims.append(got)
    threshold = (min(sims) + max(sims)) / 2 if min(sims) < max(sims) else max(sims) + 0.01
    out = tmp_path / "out"
    log = _run(["--phore_ligand_csv", TASK, "--model_dir", small_model_dir, "--out_dir",
                str(out), "--allow_random_init", "true", "--min_similarity", str(threshold)]
               + FAST)
    assert "excluded by fingerprint similarity" in log
    names = json.loads((out / "inference_results.json").read_text())["name"]
    assert len(names) < 3


def test_profile_dir_writes_a_trace(tmp_path, small_model_dir):
    """--profile_dir wraps the screen in torch.profiler and writes a chrome
    trace."""
    prof = tmp_path / "prof"
    _run(["--phore", PHORE, "--ligand", os.path.join(EXAMPLES, "EX03.sdf"), "--model_dir",
          small_model_dir, "--out_dir", str(tmp_path / "out"), "--allow_random_init", "true",
          "--profile_dir", str(prof)] + FAST)
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert (tmp_path / "out" / "ranked_results.csv").exists()
