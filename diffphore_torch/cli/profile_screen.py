"""Scale-out of the screening CLI on the card at a screen's size, each
process's start-up timed apart from its dispatches.

    python -m diffphore_torch.cli.profile_screen [--json out.json]

Every run is a ``python -m diffphore_torch.cli.inference`` process with
runs/corpus2/main at 40 poses x 20 steps on the card, against
examples/example.phore:

* stripes: the examples' three SDFs, 40 copies each (a few ms of
  featurization a complex: the host's dispatch sets the pace), through one
  process and through two striped processes at once on the one card
  (``--num_processes 2``), in turns one, two, two, one, with
  ``--prefetch_workers 0``;
* prefetch: the first 16 rows of runs/corpus2/test.csv (drug-size SMILES,
  embedded on the host) with ``--prefetch_workers`` 0, 2, 4, 4, 2, 0.

``--device cpu`` rehearses it on the CPU at 2 poses x 2 steps, 6 SDF
complexes, 3 SMILES and 0, 2, 2, 0 workers.

A run's start-up is from its launch to its first dispatch (imports, model,
tables, the first featurization); its dispatch window from the first
dispatch's start to the last one's end, as the CLI logs it (a striped
pair: the first start to the last end over both).  Prints one JSON line
per run and writes them all to ``--json``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

from diffphore_torch.utils.logging import log_info

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL_DIR = os.path.join(REPO, "runs", "corpus2", "main")
PHORE = os.path.join(REPO, "examples", "example.phore")
WINDOW = re.compile(r"Dispatch window: (\d+) complexes in [\d.]+ s, from ([\d.]+) to ([\d.]+)")


def dispatch_window(log: str) -> Tuple[int, float, float]:
    """(complexes, first dispatch's start, last dispatch's end) of a CLI log."""
    found = WINDOW.search(log)
    if found is None:
        raise AssertionError(f"no dispatch window in the CLI's log:\n{log[-3000:]}")
    return int(found.group(1)), float(found.group(2)), float(found.group(3))


def run_processes(argvs: Sequence[Sequence[str]], poses: int, timeout: float = 1800) -> Dict:
    """``cli.inference`` processes, all started at once; raises when one
    fails.  Returns the wall from the first launch to the last exit, each
    process's start-up, and the complexes and seconds of the dispatch window
    over them all."""
    launched, procs = [], []
    t0 = time.perf_counter()
    for argv in argvs:
        launched.append(time.time())
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "diffphore_torch.cli.inference", *argv], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"cli.inference exited {p.returncode}:\n{log[-3000:]}")
    windows = [dispatch_window(log) for log in logs]
    n = sum(w[0] for w in windows)
    window = max(w[2] for w in windows) - min(w[1] for w in windows)
    return {"wall_s": wall, "startup_s": [w[1] - t for w, t in zip(windows, launched)],
            "complexes": n, "window_s": window, "poses_per_s_wall": n * poses / wall,
            "poses_per_s_window": n * poses / window}


def write_task(path: str, rows: List[Dict]) -> str:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "ligand_description", "phore"])
        w.writeheader()
        w.writerows(rows)
    return path


def sdf_rows(tmp: str, copies: int) -> List[Dict]:
    """The examples' SDFs, each copy a file of its own (the CLI names a
    complex after its ligand file)."""
    rows = []
    for i in range(copies):
        for name in ("EX01", "EX02", "EX03"):
            path = os.path.join(tmp, f"{name}_{i}.sdf")
            shutil.copy(os.path.join(REPO, "examples", f"{name}.sdf"), path)
            rows.append({"name": f"{name}_{i}", "ligand_description": path, "phore": PHORE})
    return rows


def smiles_rows(n: int) -> List[Dict]:
    with open(os.path.join(REPO, "runs", "corpus2", "test.csv")) as f:
        return [{"name": r["name"], "ligand_description": r["ligand_description"],
                 "phore": PHORE} for r in list(csv.DictReader(f))[:n]]


#: (poses, steps, SDF copies, SMILES rows, worker counts) on the card, and
#: the CPU's rehearsal
SIZES = {"cuda": (40, 20, 40, 16, (0, 2, 4)), "cpu": (2, 2, 2, 3, (0, 2))}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=sorted(SIZES), default="cuda")
    p.add_argument("--json", type=str, default=None)
    args = p.parse_args(argv)
    poses, steps, copies, n_smiles, workers = SIZES[args.device]

    import torch

    from diffphore_torch.ops import build

    who = "cpu"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to rehearse on the CPU")
        build.build(["tp_fused"])      # once, before processes that would race to build it
        who = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True).stdout.strip().splitlines()[0]

    def cli_argv(task, out, k, *extra):
        return ["--phore_ligand_csv", task, "--model_dir", MODEL_DIR, "--out_dir", out,
                "--sample_per_complex", str(poses), "--inference_steps", str(steps),
                "--device", args.device, "--prefetch_workers", str(k), *extra]

    log_info(f"card: {who}")
    records = []

    def report(kind, **fields):
        records.append({"run": kind, **fields, "card": who})
        print(json.dumps(records[-1]), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        rows = sdf_rows(tmp, copies)
        task = write_task(os.path.join(tmp, "sdf.csv"), rows)
        for turn, count in enumerate((1, 2, 2, 1)):
            out = os.path.join(tmp, f"stripes{turn}")
            argvs = ([cli_argv(task, out, 0)] if count == 1 else
                     [cli_argv(task, out, 0, "--num_processes", str(count), "--process_rank",
                               str(r)) for r in range(count)])
            run = run_processes(argvs, poses)
            if run["complexes"] != len(rows):
                raise AssertionError(f"{count} process(es) sampled {run['complexes']} of "
                                     f"{len(rows)} complexes")
            report("stripes", processes=count, **run)
        task = write_task(os.path.join(tmp, "smiles.csv"), smiles_rows(n_smiles))
        sampled = set()
        for turn, k in enumerate(workers + workers[::-1]):
            out = os.path.join(tmp, f"prefetch{turn}")
            run = run_processes([cli_argv(task, out, k)], poses)
            sampled.add(run["complexes"])
            report("prefetch", prefetch_workers=k, **run)
        if len(sampled) != 1:
            raise AssertionError(f"the prefetch turns sampled {sorted(sampled)} complexes")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
