"""Target fishing with the IFPTarget external package.

The port's copy of ``diffphore_tpu.baselines.run_ifptarget``: shard a
ligand library, invoke the IFPTarget scoring pipeline per shard, list the
shards' target tables in ``summary.json``.  IFPTarget is an external
package; without it each shard is reported and skipped.

Run:
  python -m diffphore_torch.baselines.run_ifptarget --ligand_dir ligs \
      --out_dir results/ifptarget
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
from typing import List

from ..utils.logging import log_info, log_warn


def split_index(n: int, shards: int) -> List[range]:
    """Even index shards."""
    per = (n + shards - 1) // shards
    return [range(i * per, min((i + 1) * per, n)) for i in range(shards) if i * per < n]


def run_shard(binary: str, ligand_files: List[str], out_dir: str, shard_id: int):
    if shutil.which(binary) is None and not os.path.exists(binary):
        log_warn(f"[skip] IFPTarget binary `{binary}` not installed")
        return None
    os.makedirs(out_dir, exist_ok=True)
    list_file = os.path.join(out_dir, f"shard_{shard_id}.list")
    with open(list_file, "w") as f:
        f.write("\n".join(ligand_files))
    out_file = os.path.join(out_dir, f"shard_{shard_id}_targets.tsv")
    try:
        subprocess.run([binary, "-l", list_file, "-o", out_file],
                       check=True, timeout=3600, capture_output=True)
        return out_file
    except (subprocess.SubprocessError, OSError) as e:
        log_warn(f"IFPTarget shard {shard_id} failed: {e}")
        return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ligand_dir", required=True)
    p.add_argument("--binary", default="IFPTarget")
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--out_dir", default="results/ifptarget")
    args = p.parse_args(argv)
    ligands = sorted(
        os.path.join(args.ligand_dir, f) for f in os.listdir(args.ligand_dir)
        if f.endswith((".sdf", ".mol2"))
    )
    os.makedirs(args.out_dir, exist_ok=True)
    outputs = []
    for k, idx in enumerate(split_index(len(ligands), args.shards)):
        out = run_shard(args.binary, [ligands[i] for i in idx], args.out_dir, k)
        if out:
            outputs.append(out)
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump({"shards": outputs}, f)
    log_info(f"{len(outputs)}/{args.shards} shards completed")


if __name__ == "__main__":
    main()
