"""Pharmacophore-alignment baselines: AncPhore / pharao / pharmer drivers.

The port's copy of ``diffphore_tpu.baselines.run_phore``: alignment of a
task CSV (``--task align``), virtual screening against one pharmacophore
(``screen``, ROC AUC and EF1% from a ``label`` column) and target fishing
over a directory of pharmacophores (``fishing``).  External aligners run
through configurable command templates; a missing binary is reported and
the task skipped.  Conformers and ligand-based random pharmacophores come
from the port's chem kernel; AncPhore scoring from the native CLI through
``utils/ancphore_bridge.py``.

Run:
  python -m diffphore_torch.baselines.run_phore --task align \
      --tool ancphore --dataset_csv pairs.csv --out_dir results/baseline
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

from ..chem.embed import embed_molecule
from ..chem.sdf import parse_sdf, read_molecule, write_sdf
from ..data.phore import write_phore
from ..data.phore_sampling import random_ligand_phore
from ..utils.ancphore_bridge import calc_phore_fitting
from ..utils.logging import log_info, log_warn
from . import read_frame, sort_order, write_frame

#: command templates per tool; {placeholders} are filled per task
CMD_TEMPLATES: Dict[str, str] = {
    "ancphore_align": "{binary} -d {db} --refphore {ref} --scores {scores} usedMultiConformerFile",
    "pharao_align": "{binary} -d {db} -r {ref} -s {scores} --refType PHAR",
    "pharmer_align": "{binary} dbsearch -dbdir {dbdir} -in {ref} -out {out}",
}


def tool_available(binary: str) -> bool:
    return shutil.which(binary) is not None or os.path.exists(binary)


def split_sdf_file(path: str, out_dir: str, chunk: int = 1) -> List[str]:
    """Split a multi-record SDF into per-molecule files."""
    os.makedirs(out_dir, exist_ok=True)
    mols = parse_sdf(path)
    out = []
    for i, m in enumerate(mols):
        p = os.path.join(out_dir, f"{m.name or i}.sdf")
        write_sdf(m, p)
        out.append(p)
    return out


def generate_conformation(ligand_description: str, out_file: str, seed: int = 0) -> Optional[str]:
    """A ligand file's heavy atoms as they stand, or a SMILES embedded in 3D,
    written to ``out_file``; None when the ligand cannot be read."""
    if os.path.exists(ligand_description):
        mol = read_molecule(ligand_description, remove_hs=True)
    else:
        from ..chem.smiles import mol_from_smiles

        try:
            mol = mol_from_smiles(ligand_description)
        except Exception as e:  # noqa: BLE001 - an unparsable SMILES is skipped
            log_warn(f"bad ligand {ligand_description}: {e}")
            return None
        embed_molecule(mol, seed=seed)
    if mol is None:
        return None
    write_sdf(mol, out_file)
    return out_file


def generate_random_phore(ligand_file: str, out_dir: str, seed: int = 0) -> Optional[str]:
    """A random sub-pharmacophore of the ligand's own features with
    exclusion spheres (``data/phore_sampling.random_ligand_phore``)."""
    mol = read_molecule(ligand_file, remove_hs=True)
    if mol is None:
        return None
    name = os.path.basename(ligand_file).split(".")[0]
    phore = random_ligand_phore(mol, name, seed=seed)
    if phore is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    return write_phore(phore, out_dir, name=name, overwrite=True)


def ancphore_align_once(db_file: str, ref_phore: str, out_dir: str, name: str) -> Optional[List[float]]:
    """Score a ligand SDF against a reference phore with the native CLI."""
    os.makedirs(out_dir, exist_ok=True)
    score_file = os.path.join(out_dir, f"{name}.score")
    return calc_phore_fitting(db_file, ref_phore, score_file, overwrite=True)


def external_align(tool: str, binary: str, db: str, ref: str, out_dir: str, name: str) -> Optional[str]:
    """Run an external aligner by template; returns its output path or None."""
    key = f"{tool}_align"
    if key not in CMD_TEMPLATES:
        log_warn(f"unknown tool `{tool}`")
        return None
    if not tool_available(binary):
        log_warn(f"[skip] `{binary}` not installed; task `{name}` skipped "
                 f"(external baseline binary required)")
        return None
    os.makedirs(out_dir, exist_ok=True)
    scores = os.path.join(out_dir, f"{name}.score")
    cmd = CMD_TEMPLATES[key].format(
        binary=binary, db=db, ref=ref, scores=scores,
        dbdir=out_dir, out=os.path.join(out_dir, f"{name}_out.sdf"),
    )
    try:
        subprocess.run(cmd, shell=True, check=True, timeout=600, capture_output=True)
        return scores
    except (subprocess.SubprocessError, OSError) as e:
        log_warn(f"{tool} failed on `{name}`: {e}")
        return None


def evaluate(args) -> Dict:
    """Align every (ligand, phore) record with the chosen tool and collect
    best scores; a record without a phore file gets a random one of its own
    features."""
    records = read_frame(args.dataset_csv)
    results = []
    for rec in records:
        name = os.path.basename(str(rec["ligand_description"])).split(".")[0]
        t0 = time.time()
        lig_sdf = os.path.join(args.out_dir, "conformers", f"{name}.sdf")
        os.makedirs(os.path.dirname(lig_sdf), exist_ok=True)
        if generate_conformation(str(rec["ligand_description"]), lig_sdf, args.seed) is None:
            continue
        phore = str(rec.get("phore", ""))
        if not phore or not os.path.exists(phore):
            phore = generate_random_phore(lig_sdf, os.path.join(args.out_dir, "sample_phores"), args.seed)
            if phore is None:
                continue
        if args.tool == "ancphore":
            scores = ancphore_align_once(lig_sdf, phore, os.path.join(args.out_dir, "scores"), name)
        else:
            out = external_align(args.tool, args.binary or args.tool, lig_sdf, phore,
                                 os.path.join(args.out_dir, "scores"), name)
            scores = None if out is None else [0.0]
        if scores:
            results.append({
                "name": name, "best_score": max(scores),
                "run_time": time.time() - t0,
            })
            log_info(f"{name}: best {max(scores):.4f}")
    out_path = os.path.join(args.out_dir, f"{args.tool}_results.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    log_info(f"{len(results)} results -> {out_path}")
    return {"results": results}


def _roc_auc(labels, scores) -> float:
    """Rank-based ROC AUC (Mann-Whitney), no sklearn needed."""
    import numpy as np

    labels = np.asarray(labels, bool)
    scores = np.asarray(scores, float)
    n_pos, n_neg = int(labels.sum()), int((~labels).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _enrichment_factor(labels, scores, frac: float = 0.01) -> float:
    import numpy as np

    labels = np.asarray(labels, bool)
    scores = np.asarray(scores, float)
    n = len(scores)
    top = max(1, int(round(frac * n)))
    sel = labels[np.argsort(scores)[::-1][:top]]
    base = labels.mean()
    return float(sel.mean() / base) if base > 0 else float("nan")


def _best_align_score(args, lig_sdf: str, phore: str, name: str,
                      fitness: int = 1) -> Optional[float]:
    score_dir = os.path.join(args.out_dir, "scores")
    os.makedirs(score_dir, exist_ok=True)
    if args.tool == "ancphore":
        scores = calc_phore_fitting(
            lig_sdf, phore, os.path.join(score_dir, f"{name}.score"),
            overwrite=True, fitness=fitness)
        return max(scores) if scores else None
    out = external_align(args.tool, args.binary or args.tool, lig_sdf, phore,
                         os.path.join(args.out_dir, "scores"), name)
    if out is None or not os.path.exists(out):
        return None
    try:  # pharao/pharmer tab files: last numeric column is the score
        with open(out) as f:
            vals = [float(line.split("\t")[-1]) for line in f if line.strip()]
        return max(vals) if vals else None
    except ValueError:
        return None


def _ranked(rows: List[Dict], key: str, ascending: bool) -> List[Dict]:
    return [rows[i] for i in sort_order([r[key] for r in rows], ascending)] if rows else rows


def screen_task(args) -> Dict:
    """Virtual screening: rank a ligand library against ONE reference
    pharmacophore by best alignment score; reports ROC AUC + EF1% when the
    CSV carries a 0/1 ``label`` column."""
    if not args.phore or not os.path.exists(args.phore):
        raise SystemExit("--task screen requires --phore <reference .phore>")
    records = read_frame(args.dataset_csv)
    rows = []
    for rec in records:
        name = os.path.basename(str(rec["ligand_description"])).split(".")[0]
        t0 = time.time()
        lig_sdf = os.path.join(args.out_dir, "conformers", f"{name}.sdf")
        os.makedirs(os.path.dirname(lig_sdf), exist_ok=True)
        if generate_conformation(str(rec["ligand_description"]), lig_sdf, args.seed) is None:
            continue
        best = _best_align_score(args, lig_sdf, args.phore, name)
        if best is None:
            continue
        row = {"name": name, "best_score": best, "run_time": time.time() - t0}
        if "label" in rec:
            row["label"] = int(rec["label"])
        rows.append(row)
        log_info(f"{name}: best {best:.4f}")
    rows = _ranked(rows, "best_score", ascending=False)
    out_path = os.path.join(args.out_dir, f"{args.tool}_screen_ranked.csv")
    write_frame(out_path, rows)
    summary = {"n": len(rows), "ranked_csv": out_path}
    if rows and "label" in rows[0]:
        labels = [r["label"] for r in rows]
        scores = [r["best_score"] for r in rows]
        summary["roc_auc"] = _roc_auc(labels, scores)
        summary["ef1pct"] = _enrichment_factor(labels, scores, 0.01)
        log_info(f"screen: AUC={summary['roc_auc']:.4f} EF1%={summary['ef1pct']:.2f}")
    with open(os.path.join(args.out_dir, f"{args.tool}_screen_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log_info(f"{len(rows)} ligands ranked -> {out_path}")
    return summary


def fishing_task(args) -> Dict:
    """Target fishing: rank a pharmacophore library against ONE query ligand
    by the target-fishing score (fitness index 5)."""
    import glob

    if not args.ligand:
        raise SystemExit("--task fishing requires --ligand <sdf|smiles>")
    if not args.phore_dir or not os.path.isdir(args.phore_dir):
        raise SystemExit("--task fishing requires --phore_dir <dir of .phore>")
    lig_sdf = os.path.join(args.out_dir, "conformers", "query.sdf")
    os.makedirs(os.path.dirname(lig_sdf), exist_ok=True)
    if generate_conformation(args.ligand, lig_sdf, args.seed) is None:
        raise SystemExit(f"could not prepare ligand {args.ligand}")
    rows = []
    for phore in sorted(glob.glob(os.path.join(args.phore_dir, "*.phore"))):
        target = os.path.basename(phore).rsplit(".", 1)[0]
        t0 = time.time()
        best = _best_align_score(args, lig_sdf, phore, target, fitness=5)
        if best is None:
            continue
        rows.append({"target": target, "best_score": best,
                     "run_time": time.time() - t0})
        log_info(f"{target}: {best:.4f}")
    rows = _ranked(rows, "best_score", ascending=False)
    out_path = os.path.join(args.out_dir, f"{args.tool}_fishing_ranked.csv")
    write_frame(out_path, rows)
    log_info(f"{len(rows)} targets ranked -> {out_path}")
    return {"n": len(rows), "ranked_csv": out_path}

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", choices=["align", "screen", "fishing"], default="align")
    p.add_argument("--tool", choices=["ancphore", "pharao", "pharmer"], default="ancphore")
    p.add_argument("--binary", type=str, default=None,
                   help="path to the external aligner binary (pharao/pharmer)")
    p.add_argument("--dataset_csv", type=str, default=None,
                   help="align/screen: CSV of ligand_description [, phore, label]")
    p.add_argument("--phore", type=str, default=None,
                   help="screen: the one reference .phore to screen against")
    p.add_argument("--ligand", type=str, default=None,
                   help="fishing: the query ligand (file or SMILES)")
    p.add_argument("--phore_dir", type=str, default=None,
                   help="fishing: directory of target .phore files")
    p.add_argument("--out_dir", type=str, default="results/phore_baseline")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.task == "screen":
        screen_task(args)
        return
    if args.task == "fishing":
        fishing_task(args)
        return
    if not args.dataset_csv:
        raise SystemExit("--task align requires --dataset_csv")
    evaluate(args)


if __name__ == "__main__":
    main()
