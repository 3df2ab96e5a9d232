"""Baseline performance analysis: RMSD collection + success-rate tables.

The port's copy of ``diffphore_tpu.baselines.performance_analyze``: every
pose of a ranked SDF against its ground-truth structure by the
symmetry-corrected RMSD (``chem/rmsd.py``), then the top-k success rates.

Run:
  python -m diffphore_torch.baselines.performance_analyze \
      --poses_dir results/poses --truth_dir data/truth --out results/table.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

import numpy as np

from ..chem.rmsd import symmetry_rmsd
from ..chem.sdf import parse_sdf
from ..utils.logging import log_info, log_warn


def get_rmsds(pose_file: str, truth_file: str) -> List[float]:
    """All-pose symmetry-corrected RMSDs vs the ground-truth structure."""
    poses = parse_sdf(pose_file)
    truth = parse_sdf(truth_file)
    if not poses or not truth:
        return []
    ref = truth[0].remove_hs()
    out = []
    for p in poses:
        p = p.remove_hs()
        if p.num_atoms != ref.num_atoms:
            continue
        out.append(symmetry_rmsd(ref, ref.coords, p.coords))
    return out


def collect_all_records(poses_dir: str, truth_dir: str) -> Dict[str, List[float]]:
    records: Dict[str, List[float]] = {}
    for pose_file in sorted(glob.glob(os.path.join(poses_dir, "*.sdf"))):
        name = os.path.basename(pose_file).split(".")[0].replace("_ranked", "")
        truth = os.path.join(truth_dir, f"{name}.sdf")
        if not os.path.exists(truth):
            log_warn(f"no ground truth for {name}")
            continue
        rmsds = get_rmsds(pose_file, truth)
        if rmsds:
            records[name] = rmsds
    return records


def performance_table(records: Dict[str, List[float]], topk=(1, 5, 10)) -> Dict:
    """Success rates (% of complexes whose best of the top k poses lies
    below 1, 2 and 5 A) and the median best-of-k RMSD, for k in ``topk``."""
    table: Dict[str, float] = {"n_complexes": len(records)}
    if not records:
        return table
    for k in topk:
        best_k = np.asarray([min(r[:k]) for r in records.values()])
        for cut in (1.0, 2.0, 5.0):
            table[f"top{k}_rmsd_below_{cut:g}"] = round(
                100.0 * float((best_k < cut).mean()), 2)
        table[f"top{k}_median_rmsd"] = round(float(np.median(best_k)), 2)
    return table


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--poses_dir", required=True)
    p.add_argument("--truth_dir", required=True)
    p.add_argument("--out", default="performance_table.json")
    args = p.parse_args(argv)
    records = collect_all_records(args.poses_dir, args.truth_dir)
    table = performance_table(records)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=2)
    log_info(f"{table}")


if __name__ == "__main__":
    main()
