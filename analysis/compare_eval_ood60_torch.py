"""The PyTorch port's corpus2 test battery against the TPU battery, as
quality numbers with bootstrap intervals over complexes.

Reads ``runs/corpus2/main/eval_ood60`` (the TPU battery) and
``runs/corpus2/main/eval_ood60_torch`` (``diffphore_torch.cli.evaluate`` on
the same split) and writes ``eval_ood60_torch/compare_eval_ood60.json``.
For the delivered top-1 by fitness, by confidence and the oracle best of N
it gives each battery's value in percent with a 95% percentile bootstrap
interval over its complexes, and the difference (port minus TPU) over the
complexes both evaluated, resampled in pairs.  Each complex's hit is
``train/metrics.py::evaluate_results`` on that complex's row alone, so the
mean of the hits is the battery's ``performance_metrics.json`` value.

    python analysis/compare_eval_ood60_torch.py
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from diffphore_torch.train.metrics import evaluate_results  # noqa: E402

TPU = os.path.join(REPO, "runs", "corpus2", "main", "eval_ood60")
PORT = os.path.join(REPO, "runs", "corpus2", "main", "eval_ood60_torch")
OUT = os.path.join(PORT, "compare_eval_ood60.json")
METRICS = ("rankbyFitscore_top1_rmsds_below_2", "rankbyConfidence_top1_rmsds_below_2",
           "top1_rmsds_below_2")
DRAWS, SEED = 10000, 0


def load(path: str) -> Dict:
    """Names, each complex's hit (0 or 1) per metric, and the stored metrics."""
    with open(os.path.join(path, "names.json")) as f:
        names = json.load(f)
    with open(os.path.join(path, "performance_metrics.json")) as f:
        stored = json.load(f)
    arrays = [np.load(os.path.join(path, f + ".npy")) for f in
              ("rmsds", "fitscore", "centroid_distances", "min_ex_cross_distances",
               "min_self_distances")]
    conf_path = os.path.join(path, "confidence.npy")
    conf = np.load(conf_path) if os.path.exists(conf_path) else None
    rows = [evaluate_results(*(a[i:i + 1] for a in arrays),
                             confidence=None if conf is None else conf[i:i + 1])
            for i in range(len(names))]
    hits = {k: np.asarray([r[k] for r in rows]) / 100 for k in METRICS if k in rows[0]}
    return {"names": names, "hits": hits, "stored": stored}


def interval(samples: np.ndarray) -> list:
    return [float(np.percentile(samples, 2.5)), float(np.percentile(samples, 97.5))]


def compare(a: Dict, b: Dict, draws: int = DRAWS, seed: int = SEED) -> Dict:
    rng = np.random.default_rng(seed)
    common = [n for n in a["names"] if n in set(b["names"])]
    ia = np.asarray([a["names"].index(n) for n in common])
    ib = np.asarray([b["names"].index(n) for n in common])
    out = {"n_first": len(a["names"]), "n_second": len(b["names"]), "n_common": len(common),
           "only_first": [n for n in a["names"] if n not in set(b["names"])],
           "only_second": [n for n in b["names"] if n not in set(a["names"])],
           "bootstrap_draws": draws, "metrics": {}}
    for k in METRICS:
        if k not in a["hits"] or k not in b["hits"]:
            continue
        row = {}
        for tag, d in (("first", a), ("second", b)):
            h = d["hits"][k]
            boot = h[rng.integers(0, len(h), (draws, len(h)))].mean(1)
            row[tag] = 100 * float(h.mean())
            row[tag + "_ci95"] = [100 * x for x in interval(boot)]
        diff = b["hits"][k][ib] - a["hits"][k][ia]
        boot = diff[rng.integers(0, len(diff), (draws, len(diff)))].mean(1)
        row["difference_common"] = 100 * float(diff.mean())
        row["difference_common_ci95"] = [100 * x for x in interval(boot)]
        out["metrics"][k] = row
    return out


def main() -> Dict:
    out = compare(load(TPU), load(PORT))
    out["first"], out["second"] = os.path.relpath(TPU, REPO), os.path.relpath(PORT, REPO)
    text = json.dumps(out, indent=1)
    with open(OUT, "w") as f:
        f.write(text + "\n")
    print(text)
    return out


if __name__ == "__main__":
    main()
