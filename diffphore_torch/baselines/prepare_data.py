"""Baseline dataset preparation: receptor/ligand format conversion helpers.

The port's copy of ``diffphore_tpu.baselines.prepare_data``: receptor pdb
-> pdbqt conversion is delegated to ADFR's ``prepare_receptor`` when it is
installed; the virtual-screening task CSV is assembled on the host.

Run:
  python -m diffphore_torch.baselines.prepare_data vs --ligand_dir ligs \
      --phore ref.phore --out_csv vs.csv
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import shutil
import subprocess
from typing import List, Optional

from ..utils.logging import log_info, log_warn


def process_pdb(pdb_file: str, out_pdbqt: str, prep_binary: str = "prepare_receptor") -> Optional[str]:
    """Receptor prep via ADFR's prepare_receptor (external)."""
    if shutil.which(prep_binary) is None:
        log_warn(f"[skip] `{prep_binary}` not installed; receptor prep needs ADFR")
        return None
    try:
        subprocess.run([prep_binary, "-r", pdb_file, "-o", out_pdbqt],
                       check=True, timeout=600, capture_output=True)
        return out_pdbqt
    except (subprocess.SubprocessError, OSError) as e:
        log_warn(f"receptor prep failed for {pdb_file}: {e}")
        return None


def prepare_vs_dataset(ligand_dir: str, phore_file: str, out_csv: str) -> str:
    """Assemble a virtual-screening task CSV (ligand_description, phore)."""
    ligands = sorted(
        glob.glob(os.path.join(ligand_dir, "*.sdf"))
        + glob.glob(os.path.join(ligand_dir, "*.mol2"))
        + glob.glob(os.path.join(ligand_dir, "*.smi"))
    )
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ligand_description", "phore"])
        for lig in ligands:
            w.writerow([lig, phore_file])
    log_info(f"{len(ligands)} screening tasks -> {out_csv}")
    return out_csv


def prepare_datasets(pdb_dir: str, out_dir: str) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for pdb in sorted(glob.glob(os.path.join(pdb_dir, "*.pdb"))):
        out = os.path.join(out_dir, os.path.basename(pdb).replace(".pdb", ".pdbqt"))
        if process_pdb(pdb, out):
            outs.append(out)
    return outs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    vs = sub.add_parser("vs", help="assemble a virtual-screening CSV")
    vs.add_argument("--ligand_dir", required=True)
    vs.add_argument("--phore", required=True)
    vs.add_argument("--out_csv", required=True)
    rec = sub.add_parser("receptors", help="prepare receptor pdbqt files")
    rec.add_argument("--pdb_dir", required=True)
    rec.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)
    if args.cmd == "vs":
        prepare_vs_dataset(args.ligand_dir, args.phore, args.out_csv)
    else:
        prepare_datasets(args.pdb_dir, args.out_dir)


if __name__ == "__main__":
    main()
