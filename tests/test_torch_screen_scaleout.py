"""The screening CLI's scale-out (``diffphore_torch.cli.inference``) on the
CPU: striped runs (``--num_processes`` / ``--process_rank``) and their
merge, featurization in worker processes (``--prefetch_workers``) and the
multi-card screen (``--use_mesh``, here over two CPU workers).  A small
model with random weights, its batch statistics calibrated once as
``--allow_random_init`` calibrates them and saved as the model directory's
checkpoint, 2 poses x 2 steps, on examples/task.csv with a SMILES row
(embedded on the host) and an unparsable one.  Every run uses the same
``--seed``, so a complex's rows do not depend on which process screened
it."""

import argparse
import contextlib
import csv
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from diffphore_torch.cli import inference as tcli
from diffphore_torch.cli.pipeline import FitEngine, prepare_job
from diffphore_torch.cli.profile_screen import dispatch_window
from diffphore_torch.models.score_model import ScoreModel
from diffphore_torch.train.state import create_train_state
from diffphore_torch.utils import checkpoints
from diffphore_tpu.parallel.mesh import shard_records as j_shard_records

from torch_port_helpers import REPO, SMALL, configs

torch.set_num_threads(2)

EXAMPLES = os.path.join(REPO, "examples")
TASK = os.path.join(EXAMPLES, "task.csv")
PHORE = os.path.join(EXAMPLES, "example.phore")
SMALL_YML = "ns: 4\nnv: 2\nnum_conv_layers: 2\ndropout: 0.0\ncompute_dtype: float32\n"
FAST = ["--sample_per_complex", "2", "--inference_steps", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """(records CSV, model directory): the three SDF rows, a SMILES and an
    unparsable SMILES."""
    root = tmp_path_factory.mktemp("task")
    model_dir = root / "model"
    model_dir.mkdir()
    (model_dir / "model_parameters.yml").write_text(SMALL_YML)
    cfg = checkpoints.load_config_yaml(str(model_dir))
    torch.manual_seed(0)
    model = ScoreModel(cfg).eval()
    FitEngine(cfg, model, samples_per_complex=2, device="cpu").calibrate_batch_stats(
        prepare_job("EX01", os.path.join(EXAMPLES, "EX01.sdf"), PHORE))
    checkpoints.save_ema_variables(create_train_state(cfg, device="cpu", model=model),
                                   str(model_dir / checkpoints.BEST_EMA_MODEL))
    with open(TASK) as f:
        rows = list(csv.DictReader(f))
    rows += [{"name": "PCM", "ligand_description": "CC(=O)Nc1ccc(O)cc1", "phore": PHORE},
             {"name": "bad", "ligand_description": "C1CC(=O", "phore": PHORE}]
    for r in rows:
        for k in ("ligand_description", "phore"):
            if r[k].startswith("examples/"):
                r[k] = os.path.join(REPO, r[k])
    path = root / "task.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(path), str(model_dir)


def _run(argv, **kw):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tcli.main(argv, **kw)
    return log.getvalue()


def _journal(path):
    with open(path) as f:
        return json.load(f)


def _argv(task, out, *extra):
    csv_path, model = task
    return ["--phore_ligand_csv", csv_path, "--model_dir", model, "--out_dir", str(out),
            "--prefetch_workers", "0"] + FAST + list(extra)


def _stripe_csv(task, tmp, rank, count):
    """The records of stripe ``rank`` alone (the JAX package's stripe), as a
    CSV."""
    with open(task[0]) as f:
        rows = list(csv.DictReader(f))
    path = tmp / f"stripe{rank}.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(j_shard_records(rows, rank, count))
    return (str(path), task[1])


@pytest.fixture(scope="module")
def striped(task, tmp_path_factory):
    """Two striped runs into one directory (rank 1, then rank 0, which
    merges), and each stripe screened alone."""
    tmp = tmp_path_factory.mktemp("striped")
    out = tmp / "out"
    logs = {r: _run(_argv(task, out, "--num_processes", "2", "--process_rank", str(r)))
            for r in (1, 0)}
    alone = {r: tmp / f"alone{r}" for r in (0, 1)}
    for r, d in alone.items():
        _run(_argv(_stripe_csv(task, tmp, r, 2), d))
    return out, alone, logs


def test_striped_runs_give_each_stripe_alone(striped):
    """Rank r's journal holds the names and rows of a run over stripe r
    alone; rank 1 writes no table, rank 0 ranks the merged journals."""
    out, alone, logs = striped
    for r in (0, 1):
        journal = _journal(out / f"inference_results.rank{r}.json")
        want = _journal(alone[r] / "inference_results.json")
        assert journal["name"] == want["name"] and journal["fitscore"] == want["fitscore"]
        assert os.path.exists(out / f"inference_results.rank{r}.json.done")
    assert "rank 1: journal written; rank 0 merges and ranks" in logs[1]
    assert not os.path.exists(out / "inference_results.json")
    with open(out / "ranked_results.csv") as f:
        ranked = sorted(r["name"] for r in csv.DictReader(f, delimiter="\t"))
    names = _journal(out / "inference_results.rank0.json")["name"] + _journal(
        out / "inference_results.rank1.json")["name"]
    assert ranked == sorted(names) and len(names) == 4     # the unparsable row is skipped


def test_a_journal_without_its_marker_is_left_out(striped, task):
    """Rank 0 merges only finished journals: without rank 1's ``.done`` the
    table holds rank 0's complexes, and a warning says why; a run of one
    process never merges rank journals."""
    out, _, _ = striped
    os.remove(out / "inference_results.rank1.json.done")
    try:
        log = _run(_argv(task, out, "--num_processes", "2", "--process_rank", "0"))
    finally:
        open(out / "inference_results.rank1.json.done", "w").write("ok\n")
    assert "has no completion marker; skipping" in log
    with open(out / "ranked_results.csv") as f:
        ranked = [r["name"] for r in csv.DictReader(f, delimiter="\t")]
    assert sorted(ranked) == sorted(_journal(out / "inference_results.rank0.json")["name"])


def _artifacts(root):
    """Every file of an artifact set, ``run_time`` taken out: the JSON files
    without their run_time fields, the table without its column."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith((".json", "_dock.log")):
                obj = _journal(path)
                obj.pop("run_time")
                out[rel] = obj
            elif name.startswith("ranked_results"):
                with open(path) as f:
                    rows = list(csv.reader(f, delimiter="\t"))
                col = rows[0].index("run_time")
                out[rel] = [r[:col] + r[col + 1:] for r in rows]
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def test_prefetch_workers_give_the_inline_artifact_set(task, tmp_path):
    """``--prefetch_workers 2`` (spawn processes) against 0 (inline), same
    seed: the same files, byte for byte but for ``run_time``."""
    inline, workers = tmp_path / "inline", tmp_path / "workers"
    _run(_argv(task, inline))
    log = _run(_argv(task, workers, "--prefetch_workers", "2"))
    assert "Featurization failed for `example_phore_0__C1CC(=O`, skipped" in log
    complexes, start, end = dispatch_window(log)
    assert complexes == 4 and 0 < end - start < 600
    got, want = _artifacts(workers), _artifacts(inline)
    assert sorted(got) == sorted(want)
    assert len(want["inference_results.json"]["name"]) == 4
    for rel, v in want.items():
        assert got[rel] == v, rel


def test_worker_featurization_keeps_input_order_and_skips_what_raises(tmp_path):
    """Records come back in input order whatever finishes first; a record
    whose featurization raises in a worker is logged and gives None; a job
    crosses the process boundary as numpy arrays and comes back bit for
    bit; the module a worker imports does not import torch."""
    _, cfg = configs(**SMALL)
    engine = FitEngine(cfg, ScoreModel(cfg), samples_per_complex=2, device="cpu")
    todo = [("smiles", {"ligand_description": "CC(=O)Nc1ccc(O)cc1", "phore": PHORE}),
            ("missing phore", {"ligand_description": "CCO", "phore": str(tmp_path / "no")}),
            ("sdf", {"ligand_description": os.path.join(EXAMPLES, "EX01.sdf"), "phore": PHORE})]
    args = argparse.Namespace(keep_local_structures=True, prefetch_workers=2)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = list(tcli.featurized(args, engine, todo, lookahead=4))
    assert [name for name, _, _ in got] == ["smiles", "missing phore", "sdf"]
    assert got[1][1] is None and "Featurization of `missing phore` raised" in err.getvalue()
    for (name, job, seconds), (_, record) in zip(got[::2], todo[::2]):
        want = prepare_job(name, record["ligand_description"], PHORE)
        assert seconds > 0 and job.n_atoms == want.n_atoms
        for k, v in want.batch.tensors().items():
            assert torch.equal(getattr(job.batch, k), v), k
        for k, v in want.ref.tensors().items():
            assert torch.equal(getattr(job.ref, k), v), k
        assert job.mol.coords.tobytes() == want.mol.coords.tobytes()
    code = ("import sys, diffphore_torch.data.featurize as f; "
            "assert 'torch' not in sys.modules, 'torch imported'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def test_use_mesh_over_two_workers_equals_the_striped_runs(striped, task, tmp_path):
    """``main(devices=["cpu", "cpu"])``: each worker screens its stripe as
    the striped ranks do, and the journals merge in record order, also when
    a worker resumes part of its stripe."""
    out, _, _ = striped
    mesh_out = tmp_path / "mesh"
    log = _run(_argv(task, mesh_out), devices=["cpu", "cpu"])
    assert "Screening over 2 devices" in log
    for r in (0, 1):
        got = _journal(mesh_out / f"inference_results.rank{r}.json")
        want = _journal(out / f"inference_results.rank{r}.json")
        assert got["name"] == want["name"] and got["fitscore"] == want["fitscore"]
    merged = _journal(mesh_out / "inference_results.json")
    ranks = [_journal(out / f"inference_results.rank{r}.json") for r in (0, 1)]
    order = [n for pair in zip(ranks[0]["name"], ranks[1]["name"]) for n in pair]
    assert merged["name"] == order                          # record order
    for rel, v in _artifacts(out).items():
        if rel.startswith(("mapping_process", "ranked_poses")):
            assert _artifacts(mesh_out)[rel] == v, rel
    # resumed: a worker's journal lists the reused complex first, the merge
    # keeps record order
    os.remove(mesh_out / "ranked_poses" / f"{order[0]}_ranked.sdf")
    os.remove(mesh_out / "inference_results.json")
    _run(_argv(task, mesh_out), devices=["cpu", "cpu"])
    assert _journal(mesh_out / "inference_results.rank0.json")["name"][0] == order[2]
    assert _journal(mesh_out / "inference_results.json")["name"] == order


def test_a_failing_worker_fails_the_multi_device_screen(task, tmp_path):
    """No fallback: a worker that cannot take its device stops the screen."""
    with pytest.raises(Exception, match="nope"):
        _run(_argv(task, tmp_path / "o"), devices=["nope", "nope"])


PROBE_MAIN = '''
import contextlib, multiprocessing, sys
from concurrent.futures import ProcessPoolExecutor

import torch  # noqa: F401 - a main module that imports torch, as the CLI's does

from diffphore_torch.parallel.workers import bare_main
from probe_fn import has_torch

if __name__ == "__main__":
    for bare in (False, True):
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            with bare_main() if bare else contextlib.nullcontext():
                future = pool.submit(has_torch)
            print(bare, future.result())
    print(sys.modules["__main__"].__spec__.name)
'''


def test_featurization_workers_do_not_import_the_main_module(tmp_path):
    """Spawn re-imports the main module in every worker (``python -m
    diffphore_torch.cli.inference`` imports torch and the package); workers
    started under ``bare_main`` import only what their function needs, and
    the main module is restored."""
    (tmp_path / "probe_fn.py").write_text("import sys\n\n\ndef has_torch():\n"
                                          "    return 'torch' in sys.modules\n")
    (tmp_path / "probe_main.py").write_text(PROBE_MAIN)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    out = subprocess.run([sys.executable, "-m", "probe_main"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, check=True).stdout
    assert out.split("\n")[:3] == ["False True", "True False", "probe_main"]
