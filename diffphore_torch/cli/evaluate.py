"""Test-set evaluation: sample poses for every test complex, compute the
metric battery, write ``performance_metrics.json`` and the numpy dumps.

The port of ``diffphore_tpu.cli.evaluate``, with its flags, artifacts
(``performance_metrics.json``, ``rmsds.npy``, ``fitscore.npy``,
``centroid_distances.npy``, ``min_ex_cross_distances.npy``,
``min_self_distances.npy``, ``run_times.npy``, ``confidence.npy`` with a
confidence head, ``names.json``) and metric keys (``train/metrics.py``).
The test records are featurized into a ``PhoreDataset`` cache (``eval_*``
under ``--cache_path``), each complex's poses are scored against its
batch's phore with anchor weights of 1, and runs on the GPU unless
``--device cpu`` is given.  ``run_time`` per complex is the wall time from
the previous complex's completion to this one's poses on the host.

    python -m diffphore_torch.cli.evaluate --test_csv runs/corpus2/test.csv \\
        --model_dir runs/corpus2/main --confidence_model_dir runs/corpus2/confidence \\
        --sample_per_complex 40 --bucket_a_min 48 --bucket_a_step 8 \\
        --bucket_p_min 160 --bucket_p_step 32 --bucket_t_min 16 --bucket_t_step 4 \\
        --out_dir results/eval1
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..chem.rmsd import plain_rmsd, symmetry_rmsd
from ..chem.sdf import read_molecule
from ..data.dataset import (DatasetSettings, PhoreDataset, records_from_csv,
                            records_from_pdbbind_split)
from ..device import resolve_device
from ..sampler.sampling import SamplerSettings
from ..train.metrics import evaluate_results, pose_validity
from ..utils import checkpoints
from ..utils.logging import log_info, log_warn
from .inference import load_confidence_model, load_model, str2bool
from .pipeline import FitEngine, job_from_cached


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--test_csv", type=str, default=None)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--split_test", type=str, default=None)
    p.add_argument("--test_no_overlap", type=str, default=None,
                   help="file listing complex names with no training overlap")
    p.add_argument("--cache_path", type=str, default="data/cache")
    p.add_argument("--out_dir", type=str, default="results/evaluation")
    p.add_argument("--model_dir", type=str, required=False, default=None)
    p.add_argument("--ckpt", type=str, default=checkpoints.BEST_EMA_MODEL)
    p.add_argument("--allow_random_init", type=str2bool, default=False)
    # a trained confidence head adds confidence.npy and the rankbyConfidence_* metrics
    p.add_argument("--confidence_model_dir", type=str, default=None)
    p.add_argument("--confidence_ckpt", type=str, default=checkpoints.BEST_EMA_MODEL)
    p.add_argument("--sample_per_complex", type=int, default=40)
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--min_phore_num", type=int, default=3)
    p.add_argument("--max_phore_num", type=int, default=15)
    p.add_argument("--num_workers", type=int, default=1,
                   help="featurization processes (spawn)")
    p.add_argument("--seed", type=int, default=0)
    # bucket floors and steps, as cli.train's
    p.add_argument("--bucket_a_min", type=int, default=16)
    p.add_argument("--bucket_p_min", type=int, default=16)
    p.add_argument("--bucket_t_min", type=int, default=4)
    p.add_argument("--bucket_a_step", type=int, default=8)
    p.add_argument("--bucket_p_step", type=int, default=16)
    p.add_argument("--bucket_t_step", type=int, default=4)
    p.add_argument("--use_symmetry_rmsd", type=lambda v: str(v).lower() in ("1", "true"),
                   default=False,
                   help="graph-automorphism RMSD for ligands read from files (slower); "
                        "default plain RMSD")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; required unless given) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    """Evaluate and write the artifacts; returns the metrics, the names and
    the host timings (featurization and the engine's phases)."""
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.test_csv:
        records = records_from_csv(args.test_csv)
    elif args.data_dir and args.split_test:
        records = records_from_pdbbind_split(args.split_test, args.data_dir)
    else:
        raise SystemExit("Provide --test_csv or (--data_dir, --split_test)")
    if args.limit_complexes:
        records = records[: args.limit_complexes]
    device = resolve_device(args.device)
    settings = DatasetSettings(
        min_phore_num=args.min_phore_num, max_phore_num=args.max_phore_num,
        matching=False, keep_original=True,
        a_min=args.bucket_a_min, p_min=args.bucket_p_min, t_min=args.bucket_t_min,
        a_step=args.bucket_a_step, p_step=args.bucket_p_step, t_step=args.bucket_t_step,
    )
    t0 = time.perf_counter()
    dataset = PhoreDataset(records, settings, args.cache_path, args.num_workers, name="eval")
    featurize_s = time.perf_counter() - t0
    log_info(f"Evaluating {len(dataset)} complexes, {args.sample_per_complex} poses each")

    cfg, model = load_model(args, device)
    engine = FitEngine(cfg, model, samples_per_complex=args.sample_per_complex,
                       settings=SamplerSettings(inference_steps=args.inference_steps),
                       seed=args.seed, device=str(device),
                       confidence=load_confidence_model(args, device))

    names: List[str] = []
    all_rmsd, all_fit, all_centroid, all_ex, all_self, run_times = [], [], [], [], [], []
    all_conf: List = []
    done = time.time()
    for i in range(len(dataset)):
        batch = dataset[i]
        meta = batch.meta[0]
        if "orig_pos" not in meta:
            log_warn(f"{batch.names[0]}: no ground-truth pose cached, skipped")
            continue
        if args.allow_random_init and i == 0:
            engine.calibrate_batch_stats(batch)
        with engine.timers.phase("sample"):
            (res,) = engine.run_complexes([job_from_cached(batch)], skip_failed=True)
        if "error" in res:
            continue
        poses, fits, conf = res["poses"], res["fitscore"], res.get("confidence")
        run_times.append(max(time.time() - done, 0.0))
        with engine.timers.phase("rmsd"):
            n_atoms = poses.shape[1]
            orig = np.asarray(meta["orig_pos"])[:n_atoms]
            mol = None
            if args.use_symmetry_rmsd and os.path.exists(meta.get("ligand_description", "")):
                mol = read_molecule(meta["ligand_description"], remove_hs=True)
            if mol is not None:
                rmsd = [symmetry_rmsd(mol, p, orig) for p in poses]
            else:
                rmsd = [plain_rmsd(p, orig) for p in poses]
        center = batch.orig_center[0].numpy()
        ex_mask = ((batch.phoretype[0, :, -1] == 1) & batch.phore_mask[0]).numpy()
        ex_coords = batch.phore_pos[0].numpy()[ex_mask] + center
        validity = pose_validity(poses, batch.bond_mask[0].numpy()[:n_atoms, :n_atoms],
                                 ex_coords, orig)
        names.append(batch.names[0])
        all_rmsd.append(rmsd)
        all_fit.append(fits)
        if conf is not None:
            all_conf.append(conf)
        all_centroid.append(validity["centroid"])
        all_ex.append(validity["min_ex"])
        all_self.append(validity["min_self"])
        log_info(f"[{len(names)}/{len(dataset)}] {batch.names[0]}: "
                 f"best rmsd {min(rmsd):.2f} A, best fitscore {max(fits):.3f}")
        done = time.time()

    if not names:
        raise SystemExit("No complexes evaluated")
    return write_results(args, names, all_rmsd, all_fit, all_centroid, all_ex, all_self,
                         run_times, all_conf if len(all_conf) == len(names) else None,
                         {"featurize_s": featurize_s, "featurized": dataset.featurized,
                          **engine.timers.totals})


def write_results(args, names: List[str], rmsds, fits, centroid, min_ex, min_self, run_times,
                  confidence: Optional[List], timings: Dict) -> Dict:
    """The artifacts and ``performance_metrics.json`` of an evaluation."""
    rmsds, fits = np.asarray(rmsds), np.asarray(fits)
    cent, exd, selfd = np.asarray(centroid), np.asarray(min_ex), np.asarray(min_self)
    conf_arr = None if confidence is None else np.asarray(confidence)
    for fname, arr in (
        ("rmsds.npy", rmsds), ("fitscore.npy", fits),
        ("centroid_distances.npy", cent), ("min_ex_cross_distances.npy", exd),
        ("min_self_distances.npy", selfd), ("run_times.npy", np.asarray(run_times)),
    ):
        np.save(os.path.join(args.out_dir, fname), arr)
    if conf_arr is not None:
        np.save(os.path.join(args.out_dir, "confidence.npy"), conf_arr)
    # the row order of every npy artifact
    with open(os.path.join(args.out_dir, "names.json"), "w") as f:
        json.dump(names, f)

    no_overlap_idx = None
    if args.test_no_overlap and os.path.exists(args.test_no_overlap):
        with open(args.test_no_overlap) as f:
            keep = {line.strip() for line in f if line.strip()}
        no_overlap_idx = np.asarray([i for i, n in enumerate(names) if any(k in n for k in keep)],
                                    int)
    metrics = evaluate_results(rmsds, fits, cent, exd, selfd, np.asarray(run_times),
                               no_overlap_idx, confidence=conf_arr)
    out_path = os.path.join(args.out_dir, "performance_metrics.json")
    with open(out_path, "w") as f:
        json.dump(metrics, f, indent=4)
    log_info(f"performance metrics -> {out_path}")
    for k in ("rankbyFitscore_top1_rmsds_below_2", "rmsds_below_2",
              "exclusion_clash_fraction", "mean_fitscore"):
        if k in metrics:
            log_info(f"  {k}: {metrics[k]}")
    log_info(f"host timings: {timings}")
    return {"metrics": metrics, "names": names, "timings": timings}


if __name__ == "__main__":
    main()
