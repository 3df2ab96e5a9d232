"""Docking baselines: vina-family drivers (pose / virtual screen / fishing).

The port's copy of ``diffphore_tpu.baselines.run_docking``: configurable
command templates, per-task work dirs, score collection.  The docking
binaries (vina, smina, qvina...) are external; absent binaries skip
cleanly.

Run:
  python -m diffphore_torch.baselines.run_docking --task docking \
      --binary vina --dataset_csv tasks.csv --out_dir results/docking
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

from ..utils.logging import log_info, log_warn
from . import read_frame, sort_order, write_frame

VINA_TEMPLATE = (
    "{binary} --receptor {receptor} --ligand {ligand} "
    "--center_x {cx} --center_y {cy} --center_z {cz} "
    "--size_x {sx} --size_y {sy} --size_z {sz} "
    "--out {out} --num_modes {num_modes} --exhaustiveness {exhaustiveness}"
)


def run_docking(binary: str, receptor: str, ligand: str, out: str,
                center, size=(20, 20, 20), num_modes: int = 9,
                exhaustiveness: int = 8, timeout: float = 1200) -> Optional[str]:
    if shutil.which(binary) is None and not os.path.exists(binary):
        log_warn(f"[skip] docking binary `{binary}` not installed")
        return None
    cmd = VINA_TEMPLATE.format(
        binary=binary, receptor=receptor, ligand=ligand,
        cx=center[0], cy=center[1], cz=center[2],
        sx=size[0], sy=size[1], sz=size[2],
        out=out, num_modes=num_modes, exhaustiveness=exhaustiveness,
    )
    try:
        subprocess.run(cmd, shell=True, check=True, timeout=timeout, capture_output=True)
        return out
    except (subprocess.SubprocessError, OSError) as e:
        log_warn(f"docking failed for `{ligand}`: {e}")
        return None


def parse_vina_scores(out_file: str) -> List[float]:
    """Affinities from a vina output pdbqt (REMARK VINA RESULT lines)."""
    scores = []
    if not os.path.exists(out_file):
        return scores
    with open(out_file) as f:
        for line in f:
            if line.startswith("REMARK VINA RESULT"):
                try:
                    scores.append(float(line.split()[3]))
                except (IndexError, ValueError):
                    pass
    return scores


def _dump(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def docking_run(args) -> Dict:
    """Per-record docking: each row's receptor, ligand and box centre."""
    records = read_frame(args.dataset_csv)
    results = []
    for rec in records:
        name = str(rec.get("name") or os.path.basename(str(rec["ligand"])).split(".")[0])
        out = os.path.join(args.out_dir, f"{name}_out.pdbqt")
        t0 = time.time()
        center = (rec.get("cx", 0), rec.get("cy", 0), rec.get("cz", 0))
        if run_docking(args.binary, str(rec["receptor"]), str(rec["ligand"]), out, center,
                       num_modes=args.num_modes, exhaustiveness=args.exhaustiveness):
            scores = parse_vina_scores(out)
            results.append({"name": name, "scores": scores,
                            "best": min(scores) if scores else None,
                            "run_time": time.time() - t0})
            log_info(f"{name}: best {results[-1]['best']}")
    _dump(results, os.path.join(args.out_dir, "docking_results.json"))
    return {"results": results}


def virtual_screening_run(args) -> Dict:
    """Dock a ligand library against ONE receptor and rank by best (lowest)
    affinity.  CSV columns: ligand [, label]; receptor/center come from
    --receptor/--cx/--cy/--cz.  No docked ligand: an empty table, n = 0."""
    if not args.receptor or not os.path.exists(args.receptor):
        raise SystemExit("--task virtual_screening requires --receptor")
    records = read_frame(args.dataset_csv)
    rows = []
    for rec in records:
        name = str(rec.get("name") or os.path.basename(str(rec["ligand"])).split(".")[0])
        out = os.path.join(args.out_dir, "vs", f"{name}_out.pdbqt")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        t0 = time.time()
        if not run_docking(args.binary, args.receptor, str(rec["ligand"]), out,
                           (args.cx, args.cy, args.cz),
                           num_modes=args.num_modes,
                           exhaustiveness=args.exhaustiveness):
            continue
        scores = parse_vina_scores(out)
        if not scores:
            continue
        row = {"name": name, "best_affinity": min(scores),
               "run_time": time.time() - t0}
        if "label" in rec:
            row["label"] = int(rec["label"])
        rows.append(row)
        log_info(f"{name}: best {row['best_affinity']}")
    rows = [rows[i] for i in sort_order([r["best_affinity"] for r in rows])]  # lower = better
    out_path = os.path.join(args.out_dir, "vs_ranked.csv")
    write_frame(out_path, rows)
    summary = {"n": len(rows), "ranked_csv": out_path}
    if rows and "label" in rows[0]:
        from .run_phore import _enrichment_factor, _roc_auc

        labels = [r["label"] for r in rows]
        neg = [-r["best_affinity"] for r in rows]
        summary["roc_auc"] = _roc_auc(labels, neg)
        summary["ef1pct"] = _enrichment_factor(labels, neg)
        log_info(f"VS: AUC={summary['roc_auc']:.4f} EF1%={summary['ef1pct']:.2f}")
    _dump(summary, os.path.join(args.out_dir, "vs_summary.json"))
    log_info(f"{len(rows)} ligands ranked -> {out_path}")
    return summary


def target_fishing_run(args) -> Dict:
    """Dock ONE query ligand against a receptor library and rank targets by
    best affinity.  CSV columns: receptor, cx, cy, cz [, name].  No docked
    target: an empty table, n = 0."""
    if not args.ligand or not os.path.exists(args.ligand):
        raise SystemExit("--task target_fishing requires --ligand")
    records = read_frame(args.dataset_csv)
    rows = []
    for rec in records:
        name = str(rec.get("name") or os.path.basename(str(rec["receptor"])).split(".")[0])
        out = os.path.join(args.out_dir, "fishing", f"{name}_out.pdbqt")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        t0 = time.time()
        center = (rec.get("cx", 0), rec.get("cy", 0), rec.get("cz", 0))
        if not run_docking(args.binary, str(rec["receptor"]), args.ligand, out,
                           center, num_modes=args.num_modes,
                           exhaustiveness=args.exhaustiveness):
            continue
        scores = parse_vina_scores(out)
        if not scores:
            continue
        rows.append({"target": name, "best_affinity": min(scores),
                     "run_time": time.time() - t0})
        log_info(f"{name}: best {rows[-1]['best_affinity']}")
    rows = [rows[i] for i in sort_order([r["best_affinity"] for r in rows])]
    out_path = os.path.join(args.out_dir, "fishing_ranked.csv")
    write_frame(out_path, rows)
    log_info(f"{len(rows)} targets ranked -> {out_path}")
    return {"n": len(rows), "ranked_csv": out_path}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", choices=["docking", "virtual_screening", "target_fishing"],
                   default="docking")
    p.add_argument("--binary", type=str, default="vina")
    p.add_argument("--dataset_csv", type=str, required=True,
                   help="docking: receptor, ligand, cx, cy, cz columns; "
                        "virtual_screening: ligand [, label]; "
                        "target_fishing: receptor, cx, cy, cz [, name]")
    p.add_argument("--receptor", type=str, default=None,
                   help="virtual_screening: the one receptor pdbqt")
    p.add_argument("--ligand", type=str, default=None,
                   help="target_fishing: the one query ligand pdbqt")
    p.add_argument("--cx", type=float, default=0.0)
    p.add_argument("--cy", type=float, default=0.0)
    p.add_argument("--cz", type=float, default=0.0)
    p.add_argument("--out_dir", type=str, default="results/docking_baseline")
    p.add_argument("--num_modes", type=int, default=9)
    p.add_argument("--exhaustiveness", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.task == "virtual_screening":
        virtual_screening_run(args)
    elif args.task == "target_fishing":
        target_fishing_run(args)
    else:
        docking_run(args)


if __name__ == "__main__":
    main()
