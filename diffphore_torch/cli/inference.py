"""Ligand-pharmacophore fitting / virtual screening CLI on the GPU.

The port of ``diffphore_tpu.cli.inference``: the same inputs
(``--phore_ligand_csv`` with columns ``phore`` and ``ligand_description``,
or ``--phore`` x ``--ligand``), the same artifacts and schemas, and the same
resume semantics (existing per-complex outputs are reused unless
``--overwrite``):

  out_dir/ranked_results.csv                       ranked table (tab separated)
  out_dir/ranked_results_gt{cutoff}.csv            with --cutoff
  out_dir/inference_results.json                   journal: name, fitscore, run_time
  out_dir/ranked_poses/{name}_ranked.sdf           poses, best first
  out_dir/mapping_process/{name}/{name}.sdf        poses in sampling order
  out_dir/mapping_process/{name}/{name}.score      19 columns per pose
  out_dir/mapping_process/{name}/{name}_dock.log   JSON: fitscore, run_time
  out_dir/mapping_process/{name}/{name}_visualisation.sdf   --save_visualisation

Records are featurized in ``--prefetch_workers`` spawn processes ahead of
the dispatches (inline with 0).  With several visible cards and
``--use_mesh`` (the default) one process per card screens a stripe of the
records and the journals are merged in record order.  ``--num_processes N
--process_rank r`` screens stripe r alone and writes
``inference_results.rank{r}.json`` (and a ``.done`` marker); rank 0 then
merges the finished journals and writes the ranked table.

Run:
  python -m diffphore_torch.cli.inference --phore_ligand_csv examples/task.csv \\
      --model_dir runs/corpus2/main --out_dir results/run1 \\
      [--confidence_model_dir runs/corpus2/confidence] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import csv
import glob
import itertools
import json
import multiprocessing
import os
import shutil
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..chem.sdf import write_sdf
from ..constants import PHORE_ALPHA
from ..data.featurize import featurize_timed
from ..data.phore import parse_phore
from ..device import resolve_device
from ..models.score_model import ScoreModel, ScoreModelConfig
from ..parallel import mesh
from ..parallel.mesh import shard_records
from ..parallel.workers import bare_main, worker_environment
from ..sampler.sampling import SamplerSettings
from ..utils import checkpoints, flat_yaml
from ..utils.logging import log_error, log_info, log_warn
from .pipeline import ComplexJob, FitEngine, job_from_arrays

RANKED_COLUMNS = ["target", "ligand", "name", "run_time", "max_fitscore",
                  "top5_mean_fitscore", "fitscore"]


def str2bool(v: str) -> bool:
    return str(v).lower() in ("y", "yes", "true", "t", "1")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # input / output
    p.add_argument("--config", type=str, default=None,
                   help="flat YAML file overriding any flag")
    p.add_argument("--phore_ligand_csv", type=str, default=None,
                   help="CSV with columns `phore` and `ligand_description`")
    p.add_argument("--split_file", type=str, default=None,
                   help="text file of complex names to keep (one per line)")
    p.add_argument("--phore", type=str, default=None, help=".phore file or directory")
    p.add_argument("--ligand", type=str, default=None,
                   help="SMILES, molecule file, .smi list or directory")
    p.add_argument("--out_dir", type=str, default="results/user_inference")
    p.add_argument("--overwrite", type=str2bool, default=False)
    p.add_argument("--keep_local_structures", type=str2bool, default=True)
    p.add_argument("--sample_per_complex", type=int, default=40)
    # model
    p.add_argument("--model_dir", type=str, default=None,
                   help="Directory with model_parameters.yml + checkpoint")
    p.add_argument("--ckpt", type=str, default=checkpoints.BEST_EMA_MODEL)
    p.add_argument("--allow_random_init", type=str2bool, default=False,
                   help="Run with random weights when no checkpoint exists (smoke tests)")
    p.add_argument("--confidence_model_dir", type=str, default=None,
                   help="Directory with a --confidence_mode run "
                        "(model_parameters.yml + checkpoint); poses are "
                        "ranked by its predicted fitness when set")
    p.add_argument("--confidence_ckpt", type=str, default=checkpoints.BEST_EMA_MODEL)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the GPU unless given (`cpu` runs there)")
    # sampling
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--actual_steps", type=int, default=None)
    p.add_argument("--no_random", action="store_true")
    p.add_argument("--no_final_step_noise", action="store_true")
    p.add_argument("--ode", action="store_true")
    p.add_argument("--no_torsion", action="store_true")
    p.add_argument("--random_samples", type=int, default=1,
                   help=">1: per-step candidate resampling ranked by fitness")
    p.add_argument("--seed", type=int, default=0)
    # scoring / reporting
    p.add_argument("--fitness", type=int, default=1)
    p.add_argument("--target_fishing", type=str2bool, default=False)
    p.add_argument("--cutoff", type=float, default=None)
    p.add_argument("--min_similarity", type=float, default=-1.0)
    p.add_argument("--report_results", type=str2bool, default=True)
    p.add_argument("--save_visualisation", type=str2bool, default=False,
                   help="write the per-step denoising trajectory of the "
                        "best pose as {name}_visualisation.sdf")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace (trace.json, chrome "
                        "format) covering the sampling run")
    p.add_argument("--batch_complexes", type=int, default=1,
                   help="complexes handed to the engine together (one "
                        "dispatch each, up to 16 in flight)")
    p.add_argument("--prefetch_workers", type=int, default=2,
                   help="featurization processes working ahead of the dispatches "
                        "(0: featurize inline, before each dispatch)")
    p.add_argument("--use_mesh", type=str2bool, default=True,
                   help="spread the screen over all visible cards, one process each")
    p.add_argument("--num_processes", type=int, default=0,
                   help="striped screening: total process count")
    p.add_argument("--process_rank", type=int, default=-1,
                   help="striped screening: this process's stripe")
    args = p.parse_args(argv)
    if args.config:
        overrides = flat_yaml.load(args.config) or {}
        for k, v in overrides.items():
            if hasattr(args, k):
                setattr(args, k, v)
    if args.target_fishing:
        args.fitness = 5
    return args


def read_csv_records(path: str) -> List[Dict]:
    """The rows of a CSV as dicts, duplicate rows dropped (first kept)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    seen, out = set(), []
    for row in rows:
        key = tuple(row.items())
        if key not in seen:
            seen.add(key)
            out.append(row)
    return out


def read_input(phore_ligand_csv=None, phore=None, ligand=None) -> List[Dict]:
    """Normalize inputs to [{'phore': path, 'ligand_description': str}]."""
    if phore_ligand_csv and os.path.exists(phore_ligand_csv):
        return read_csv_records(phore_ligand_csv)
    records: List[Dict] = []
    phore_list: List[str] = []
    ligand_list: List[str] = []
    if phore and os.path.exists(phore):
        phore_list = (
            sorted(os.path.join(phore, f) for f in os.listdir(phore))
            if os.path.isdir(phore) else [phore]
        )
    if ligand is not None:
        if os.path.isdir(ligand):
            ligand_list = sorted(os.path.join(ligand, f) for f in os.listdir(ligand))
        elif ligand.endswith(".smi") and os.path.exists(ligand):
            with open(ligand) as f:
                ligand_list = [line.strip() for line in f if line.strip()]
        else:
            ligand_list = [ligand]
    for p in phore_list:
        for lig in ligand_list:
            records.append({"phore": p, "ligand_description": lig})
    return records


def complex_name(record: Dict) -> str:
    phore_id = parse_phore(record["phore"])[0].id
    desc = record["ligand_description"]
    lig_id = os.path.basename(desc).split(".")[0] if os.path.exists(desc) else desc
    return f"{phore_id}__{lig_id}"


def write_score_file(path: str, name: str, ref_id: str, scores: Dict) -> None:
    """Tab-separated score file of the reference's column-index contract:
    raw[-6:] = [custom fitness, target-fishing score, PhScore1..4]."""
    n = len(scores["phscore1"])
    with open(path, "w") as f:
        for i in range(n):
            row = [
                f"{name}__{i}", "0.0", ref_id,
                f"{int(scores['n_ref'][i])}",
                f"{int(scores['n_matched'][i])}",
                f"{scores['V_db'][i]:.6g}", f"{scores['V_ref'][i]:.6g}",
                f"{scores['V_overlap'][i]:.6g}", f"{scores['match_pct'][i]:.6g}",
                f"{scores['V_exOverlap'][i]:.6g}", f"{scores['anchor_pct'][i]:.6g}",
                f"{scores['ov_pct'][i]:.6g}", f"{scores['ex_pct'][i]:.6g}",
                f"{scores['fitness'][i]:.6g}", f"{scores['fishing'][i]:.6g}",
                f"{scores['phscore1'][i]:.6g}", f"{scores['phscore2'][i]:.6g}",
                f"{scores['phscore3'][i]:.6g}", f"{scores['phscore4'][i]:.6g}",
            ]
            f.write("\t".join(row) + "\n")


def _write_complex_outputs(args, job: ComplexJob, result: Dict, run_time: float) -> None:
    name = result["name"]
    proc_dir = os.path.join(args.out_dir, "mapping_process", name)
    docked_file = os.path.join(args.out_dir, "ranked_poses", f"{name}_ranked.sdf")
    log_file = os.path.join(proc_dir, f"{name}_dock.log")
    os.makedirs(proc_dir, exist_ok=True)
    write_sdf(job.mol, os.path.join(proc_dir, f"{name}.sdf"),
              multi_coords=list(result["poses"]), name=name, marker="")
    ref_id = name.split("__")[0]
    write_score_file(os.path.join(proc_dir, f"{name}.score"), name, ref_id, result["scores"])
    # poses rank by the confidence head when one is attached, else by fitness
    rank_key = np.asarray(result.get("confidence", result["fitscore"]))
    order = np.argsort(rank_key)[::-1]
    props = {"fitscore": [f"{result['fitscore'][i]:.6g}" for i in order]}
    if "confidence" in result:
        props["confidence"] = [f"{result['confidence'][i]:.6g}" for i in order]
    write_sdf(job.mol, docked_file, multi_coords=[result["poses"][i] for i in order],
              name=name, marker="rank", properties=props)
    if "trajectory" in result:
        best = int(np.argmax(rank_key))
        steps = [result["trajectory"][s][best] for s in range(result["trajectory"].shape[0])]
        write_sdf(job.mol, os.path.join(proc_dir, f"{name}_visualisation.sdf"),
                  multi_coords=steps, name=name, marker="step")
    log = {"name": name, "fitscore": result["fitscore"], "run_time": run_time}
    if "confidence" in result:
        log["confidence"] = result["confidence"]
    with open(log_file, "w") as f:
        json.dump(log, f, indent=4)


def _dump_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=4)


def featurized(args, engine: FitEngine, todo: List, lookahead: int) -> Iterator:
    """(name, job or None, featurization seconds) of each (name, record) of
    ``todo``, in input order: inline with ``--prefetch_workers 0``, else in
    that many spawn processes (one numeric thread each; they import numpy
    and the host chemistry, not torch, nor the main module) with up to
    ``lookahead`` records in flight: the same jobs, from the same arrays.  A
    record whose featurization raises is logged and gives None; a worker
    that dies stops the screen
    (``BrokenProcessPool``).  The workers live as long as the screen: an
    executor that replaces them (``max_tasks_per_child``) hangs in CPython
    3.12 once a worker retires with records queued."""
    keep = args.keep_local_structures
    if args.prefetch_workers <= 0:
        for name, record in todo:
            t0 = time.time()
            try:
                job = engine.prepare(name, record["ligand_description"], record["phore"], keep)
            except Exception as e:  # noqa: BLE001 - one complex must not stop the screen
                log_error(f"Featurization of `{name}` raised {e!r}")
                job = None
            yield name, job, time.time() - t0
        return
    queue = iter(todo)
    in_flight: collections.deque = collections.deque()
    with worker_environment(), ProcessPoolExecutor(
            args.prefetch_workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        while True:
            with bare_main():           # the pool spawns its workers in submit
                for name, record in itertools.islice(queue, lookahead - len(in_flight)):
                    in_flight.append((name, pool.submit(featurize_timed, name,
                                                        record["ligand_description"],
                                                        record["phore"], keep)))
            if not in_flight:
                return
            name, future = in_flight.popleft()
            arrays, seconds, error = future.result()
            engine.timers.add("featurize", seconds)
            if error is not None:
                log_error(f"Featurization of `{name}` raised {error}")
            yield name, None if arrays is None else job_from_arrays(arrays), seconds


def fit(args, engine: FitEngine, records: List[Dict], result_file: str) -> Dict:
    """Screening loop with a per-complex resume journal.

    Records are featurized (numpy and scipy, CPU tensors) by
    :func:`featurized`, ahead of the dispatches in worker processes or
    inline, and dispatched in input order.  A complex whose featurization
    fails or raises, or whose sampling raises, is logged and skipped.
    ``run_time`` of a complex is its featurization time plus its share of
    the wall time of the ``run_complexes`` call it was sampled in.  Logs the
    dispatch window: from the first dispatch's start to the last one's end,
    on the host's clock."""
    names, fitscores, run_times = [], [], []
    spans: List = []        # (start, end, complexes) of each run_complexes call
    os.makedirs(os.path.join(args.out_dir, "ranked_poses"), exist_ok=True)
    dispatch = max(1, int(args.batch_complexes))
    pending: List = []
    done = [0]

    def flush():
        if not pending:
            return
        t0 = time.time()
        results = engine.run_complexes([j for j, _ in pending], skip_failed=True)
        spans.append((t0, time.time(), len(pending)))
        per = (spans[-1][1] - t0) / len(pending)
        for (job, t_feat), result in zip(pending, results):
            if "error" in result:
                log_error(f"Sampling failed for {job.name}: {result['error']}")
                continue
            run_time = t_feat + per
            _write_complex_outputs(args, job, result, run_time)
            names.append(result["name"])
            fitscores.append(result["fitscore"])
            run_times.append(run_time)
            done[0] += 1
            log_info(f"[{done[0]}/{len(records)}] {result['name']}: max fitscore "
                     f"{max(result['fitscore']):.4f} in {run_time:.2f}s")
        pending.clear()
        _dump_json({"name": names, "fitscore": fitscores, "run_time": run_times},
                   result_file + ".tmp")

    # resolve resume rows first, collecting the actual featurization work
    todo: List = []
    for record in records:
        try:
            name = complex_name(record)
        except Exception as e:  # noqa: BLE001 - a bad record is skipped, the screen goes on
            log_warn(f"Skipping record {record}: {e}")
            continue
        proc_dir = os.path.join(args.out_dir, "mapping_process", name)
        docked_file = os.path.join(args.out_dir, "ranked_poses", f"{name}_ranked.sdf")
        log_file = os.path.join(proc_dir, f"{name}_dock.log")
        if os.path.exists(docked_file) and os.path.exists(log_file) and not args.overwrite:
            with open(log_file) as f:
                log = json.load(f)
            names.append(log["name"])
            fitscores.append(log["fitscore"])
            run_times.append(log["run_time"])
            done[0] += 1
            continue
        todo.append((name, record))

    calibrated = False
    lookahead = max(2 * dispatch, 2 * args.prefetch_workers)
    for name, job, t_feat in featurized(args, engine, todo, lookahead):
        if job is None:
            log_warn(f"Featurization failed for `{name}`, skipped")
            continue
        if args.allow_random_init and not calibrated:
            engine.calibrate_batch_stats(job)
            calibrated = True
        if args.min_similarity > 0:
            sim = perfect_similarity(job)
            if sim < args.min_similarity:
                log_info(f"`{name}` excluded by fingerprint similarity "
                         f"({sim:.2f} < {args.min_similarity:.2f})")
                continue
        pending.append((job, t_feat))
        if len(pending) >= dispatch:
            flush()
    flush()
    if spans:
        start, end = spans[0][0], spans[-1][1]
        log_info(f"Dispatch window: {sum(n for *_, n in spans)} complexes in {end - start:.3f} s, "
                 f"from {start:.3f} to {end:.3f} (unix s)")
    return {"name": names, "fitscore": fitscores, "run_time": run_times}


def perfect_similarity(job: ComplexJob) -> float:
    """Type/count-only fingerprint similarity of the ligand to the phore."""
    weights = np.asarray([1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0], float)
    alpha = np.asarray(PHORE_ALPHA)
    phore_volume = job.batch.phoretype[0].cpu().numpy().sum(0)
    lig_ph = job.batch.lig_ph[0].cpu().numpy()
    overlap = np.minimum(lig_ph, phore_volume)
    coeff = weights * 7.999999999 * (alpha * np.pi / 2) ** 1.5
    wv = (phore_volume * coeff).sum()
    if wv == 0:
        return -1.0
    return float((overlap * coeff).sum() / wv)


def _desc(x: float):
    """Sort key of a descending column, NaN last."""
    return (1, 0.0) if x != x else (0, -x)


def _write_table(path: str, rows: List[List], columns: Sequence[str] = RANKED_COLUMNS,
                 sep: str = "\t") -> None:
    """Minimal quoting, header first, NaN as an empty cell: the text pandas'
    ``to_csv(sep=sep, index=False)`` writes for these columns (each of one
    type; no columns and no rows: an empty line)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        w.writerow(columns)
        w.writerows([["" if v != v else str(v) for v in row] for row in rows])


def analyze_results(args, results: Dict) -> None:
    """Rank by (max fitness, mean of the top 5) descending, stably, and
    write ``ranked_results.csv`` (and ``ranked_results_gt{cutoff}.csv``)."""
    rows = []
    for name, fit, run_time in zip(results["name"], results["fitscore"], results["run_time"]):
        best = float(max(fit)) if len(fit) else -2.0
        top5 = float(np.sort(fit)[-5:].mean())
        rows.append([name.split("__")[0], name.split("__")[1], name, float(run_time), best,
                     top5, list(fit)])
    rows.sort(key=lambda r: (_desc(r[4]), _desc(r[5])))
    dump_file = os.path.join(args.out_dir, "ranked_results.csv")
    log_info(f"Dumping results to `{dump_file}`")
    _write_table(dump_file, rows)
    if args.cutoff is not None:
        _write_table(os.path.join(args.out_dir, f"ranked_results_gt{args.cutoff}.csv"),
                     [r for r in rows if r[4] >= args.cutoff])
    if args.report_results and rows:
        best = np.asarray([r[4] for r in rows])
        n7 = int((best >= 0.7).sum())
        n4 = int((best >= 0.4).sum())
        print("#" * 25 + " Pharmacophore Alignment Summary " + "#" * 25)
        print(f"Number of ligands with fitscore greater than 0.7: {n7} "
              f"({100 * n7 / len(rows):.2f}%)")
        print(f"Number of ligands with fitscore greater than 0.4: {n4} "
              f"({100 * n4 / len(rows):.2f}%)")
        print(f"Max fitscore: {best.max():.4f}")
        print(f"Average max fitscore: {best.mean():.4f}")
        print(f"Average runtime: {np.mean([r[3] for r in rows]):.4f}")


def load_model(args, device):
    """Config and eval-mode model from --model_dir; random weights only
    with --allow_random_init."""
    if args.model_dir and os.path.exists(
            os.path.join(args.model_dir, checkpoints.MODEL_PARAMS_YAML)):
        cfg = checkpoints.load_config_yaml(args.model_dir)
    else:
        log_warn("No model_parameters.yml found; using default (shipped-best) config")
        cfg = ScoreModelConfig()
    ckpt_path = os.path.join(args.model_dir or "", args.ckpt)
    if args.model_dir and os.path.exists(ckpt_path):
        log_info(f"Loading checkpoint `{ckpt_path}`")
        return checkpoints.load_model_dir(args.model_dir, device=device, checkpoint=args.ckpt)
    if not args.allow_random_init:
        raise FileNotFoundError(
            f"Checkpoint not found at `{ckpt_path}`; pass --allow_random_init "
            "to smoke-test the pipeline without trained weights")
    log_warn("Running with RANDOM weights (--allow_random_init): poses are "
             "for pipeline smoke-testing only")
    torch.manual_seed(args.seed)
    return cfg, ScoreModel(cfg).to(device).eval()


def load_confidence_model(args, device):
    """The eval-mode confidence head of --confidence_model_dir, or None."""
    if not args.confidence_model_dir:
        return None
    ckpt_path = os.path.join(args.confidence_model_dir, args.confidence_ckpt)
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"Confidence checkpoint not found at `{ckpt_path}`")
    log_info(f"Loading confidence checkpoint `{ckpt_path}`")
    _, head = checkpoints.load_confidence_dir(args.confidence_model_dir, device=device,
                                              checkpoint=args.confidence_ckpt)
    return head


def screen(args, records: List[Dict], result_file: str, device) -> Dict:
    """Load the model on ``device`` and screen ``records`` with the
    per-complex journal ``result_file``; returns the journal."""
    cfg, model = load_model(args, device)
    settings = SamplerSettings(
        inference_steps=args.inference_steps, actual_steps=args.actual_steps,
        no_random=args.no_random, no_final_step_noise=args.no_final_step_noise,
        ode=args.ode, no_torsion=args.no_torsion, random_samples=args.random_samples)
    engine = FitEngine(cfg, model, args.sample_per_complex, settings, fitness=args.fitness,
                       seed=args.seed, device=str(device),
                       confidence=load_confidence_model(args, device),
                       save_trajectory=args.save_visualisation)
    log_info(f"Process files: {os.path.join(args.out_dir, 'mapping_process/')}")
    log_info(f"Ranked poses:  {os.path.join(args.out_dir, 'ranked_poses/')}")
    if args.profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            results = fit(args, engine, records, result_file)
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        log_info(f"torch.profiler trace written to {trace}")
    else:
        results = fit(args, engine, records, result_file)
    if os.path.exists(result_file + ".tmp"):
        shutil.move(result_file + ".tmp", result_file)
    else:
        _dump_json(results, result_file)
    log_info(f"Phase timings: {engine.timers.report()}")
    return results


def rank_journal(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"inference_results.rank{rank}.json")


def _screen_stripe(args, records: List[Dict], devices: Sequence[str]) -> None:
    """Worker r of a multi-card screen (r from the launch's ``RANK``):
    stripe r of the records on ``devices[r]``, its journal and its
    ``.done`` marker."""
    rank, _ = mesh.launched()
    stripe = shard_records(records, rank, len(devices))
    journal = rank_journal(args.out_dir, rank)
    log_info(f"card {devices[rank]}: {len(stripe)} records in stripe {rank}")
    screen(args, stripe, journal, resolve_device(devices[rank]))
    with open(journal + ".done", "w") as f:
        f.write("ok\n")


def screen_on_devices(args, records: List[Dict], devices: Sequence[str]) -> Dict:
    """One spawn process per device, each screening its stripe of the
    records (the JAX mesh's rows per device, in processes: one host thread
    issuing to several cards gains nothing on a host-bound path); returns
    the journals merged in record order.  A worker that fails fails the
    screen."""
    log_info(f"Screening over {len(devices)} devices ({', '.join(devices)}), one process each")
    mesh.launch(_screen_stripe, len(devices), args, records, list(devices))
    journals = []
    for r in range(len(devices)):
        with open(rank_journal(args.out_dir, r)) as f:
            journals.append(json.load(f))
    # a journal lists resumed complexes first: find each record's entry by name
    entries = [collections.defaultdict(collections.deque) for _ in devices]
    for by_name, journal in zip(entries, journals):
        for k, name in enumerate(journal["name"]):
            by_name[name].append(k)
    merged: Dict[str, List] = {"name": [], "fitscore": [], "run_time": []}
    for i, record in enumerate(records):
        r = i % len(devices)
        found = entries[r].get(_name_or_none(record))
        if found:
            k = found.popleft()
            for key in merged:
                merged[key].append(journals[r][key][k])
    return merged


def _name_or_none(record: Dict) -> Optional[str]:
    try:
        return complex_name(record)
    except Exception:  # noqa: BLE001 - fit skipped the record too
        return None


def merge_rank_journals(out_dir: str, rank: int, results: Dict) -> Dict:
    """Rank 0 of a striped screen: its journal followed by every other
    rank's that has a ``.done`` marker; the others are left out with a
    warning (their ranks may still be running)."""
    for rf in sorted(glob.glob(os.path.join(out_dir, "inference_results.rank*.json"))):
        if os.path.abspath(rf) == os.path.abspath(rank_journal(out_dir, rank)):
            continue
        if not os.path.exists(rf + ".done"):
            log_warn(f"Rank journal {rf} has no completion marker; "
                     f"skipping (its rank may still be running)")
            continue
        try:
            with open(rf) as f:
                other = json.load(f)
            for k in ("name", "fitscore", "run_time"):
                results[k] = list(results.get(k, [])) + list(other.get(k, []))
        except (OSError, ValueError) as e:
            log_warn(f"Could not merge rank journal {rf}: {e}")
    return results


def main(argv=None, devices: Optional[Sequence[str]] = None) -> None:
    """The CLI.  ``devices`` names the devices of a multi-card screen (all
    visible cards by default, when ``--use_mesh`` and more than one)."""
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    result_file = os.path.join(args.out_dir, "inference_results.json")

    records = read_input(args.phore_ligand_csv, args.phore, args.ligand)
    if args.split_file and os.path.exists(args.split_file):
        with open(args.split_file) as f:
            keep = {line.strip() for line in f if line.strip()}
        records = [r for r in records
                   if complex_name(r) in keep
                   or os.path.basename(str(r["ligand_description"])).split(".")[0] in keep]
        log_info(f"split_file: kept {len(records)} records")
    # striped screening: each process screens records[rank::n] into its own
    # journal; rank 0 merges the finished ones
    n_proc = max(args.num_processes, 1)
    rank = max(args.process_rank, 0)
    if n_proc > 1:
        records = shard_records(records, rank, n_proc)
        result_file = rank_journal(args.out_dir, rank)
        log_info(f"process {rank}/{n_proc}: {len(records)} records in stripe")
    log_info(f"Number of fitting samples: {len(records)}")
    if not records:
        log_error("No valid fitting samples, please check your input.")
        return

    if not os.path.exists(result_file) or args.overwrite:
        device = resolve_device(args.device)
        if devices is None and args.use_mesh and n_proc == 1 and device == torch.device("cuda"):
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if devices is not None and len(devices) > 1 and n_proc == 1:
            results = screen_on_devices(args, records, devices)
            _dump_json(results, result_file)
        else:
            results = screen(args, records, result_file, device)
        if n_proc > 1:
            # completion marker: rank 0 merges only finished journals
            with open(result_file + ".done", "w") as f:
                f.write("ok\n")
    else:
        with open(result_file) as f:
            results = json.load(f)
    # single-process runs never merge, so stale rank journals of an earlier
    # striped run cannot inject phantom entries
    if n_proc > 1 and rank != 0:
        log_info(f"rank {rank}: journal written; rank 0 merges and ranks")
        return
    if n_proc > 1:
        results = merge_rank_journals(args.out_dir, rank, results)
    if results and results.get("name"):
        analyze_results(args, results)


if __name__ == "__main__":
    main()
