"""Datasets of featurized complexes: from raw files, or from cache directories.

The port's copy of ``diffphore_tpu.data.dataset``, in its structure and
names:

* records are ``{'name', 'ligand_description', optional 'phore',
  'pose_index', 'conf_seed', 'phore_seed', 'aug_num_ex'}`` dicts, read from
  a CSV (:func:`records_from_csv`, which restates the JAX package's pandas
  reading without pandas) or a PDBbind split (:func:`records_from_pdbbind_split`);
* :func:`featurize_record` turns one record into a B = 1 bucket-padded
  ``ComplexBatch`` of CPU tensors: a ligand file (or one pose of a
  multi-pose SDF) or a SMILES embedded on the host, an optional re-embedding
  (``conf_seed``) and torsion matching, the record's ``.phore`` file or a
  random sub-phore of the ligand (``phore_seed``, ``ligand_only``);
* :class:`PhoreDataset` caches each complex as one ``.npz`` under
  ``<cache_path>/<name>_<settings digest>/<record digest>.npz`` (a ``.skip``
  file for a record that fails), so the port and the JAX package read each
  other's caches; more than one worker featurizes in ``spawn`` processes,
  which never touch CUDA.

:class:`CachedDataset` reads directories of such ``.npz`` files without
their records.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import hashlib
import json
import multiprocessing
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..chem.sdf import parse_sdf, read_molecule
from ..chem.smiles import mol_from_smiles
from ..parallel.workers import worker_environment
from ..utils.logging import log_info, log_warn
from .featurize import round_up
from .graphs import ARRAY_FIELDS, ComplexBatch, build_complex, load_cached
from .phore import parse_phore


@dataclasses.dataclass
class DatasetSettings:
    remove_hs: bool = True
    matching: bool = False
    popsize: int = 20
    maxiter: int = 20
    consider_ex: bool = True
    neighbor_cutoff: float = 5.0
    ex_connected: bool = True
    keep_original: bool = True
    min_phore_num: int = 0
    max_phore_num: int = 0        # 0 = unlimited
    max_lig_size: int = 0         # 0 = unlimited
    a_step: int = 8
    p_step: int = 16
    t_step: int = 4
    # bucket floors: higher floors put a size-diverse library in fewer
    # (A, P, T) buckets at the cost of padding
    a_min: int = 16
    p_min: int = 16
    t_min: int = 4
    max_atoms: int = 96
    max_phore_points: int = 160
    max_torsions: int = 32
    ligand_only: bool = False     # synthesize random phores from ligands
    seed: int = 0

    def digest(self) -> str:
        """The cache directory's suffix.  ``consider_ex``, ``neighbor_cutoff``
        and ``ex_connected`` reach only this digest: as in the JAX package,
        :func:`featurize_record` builds every complex with the defaults."""
        return hashlib.md5(json.dumps(dataclasses.asdict(self), sort_keys=True).encode()).hexdigest()[:10]


def _record_key(record: Dict) -> str:
    return hashlib.md5(json.dumps(record, sort_keys=True).encode()).hexdigest()[:16]


def _int_field(record: Dict, key: str) -> Optional[int]:
    """An optional integer field: None when absent, NaN or unparsable."""
    v = record.get(key)
    try:
        return int(v) if v is not None and v == v else None
    except (TypeError, ValueError):
        return None


def featurize_record(record: Dict, s: DatasetSettings) -> Optional[ComplexBatch]:
    """Featurize one record -> B = 1 padded ComplexBatch, or None on failure."""
    name = record.get("name") or os.path.basename(
        str(record.get("ligand_description", "lig"))).split(".")[0]
    desc = record["ligand_description"]
    try:
        pose_idx = record.get("pose_index")
        if pose_idx is not None and isinstance(pose_idx, float) and np.isnan(pose_idx):
            pose_idx = None
        if os.path.exists(str(desc)) and pose_idx is not None:
            # one pose of a multi-pose SDF as the clean training conformation
            mol = parse_sdf(str(desc))[int(pose_idx)]
            if s.remove_hs:
                mol = mol.remove_hs()
        elif os.path.exists(str(desc)):
            mol = read_molecule(str(desc), remove_hs=s.remove_hs)
        else:
            from ..chem.embed import embed_molecule

            mol = mol_from_smiles(str(desc))
            embed_molecule(mol, seed=s.seed)
        if mol is None or mol.num_atoms < 2:
            return None
        if s.max_lig_size and mol.num_atoms > s.max_lig_size:
            log_warn(f"{name}: ligand too large ({mol.num_atoms} atoms), skipped")
            return None

        conf = _int_field(record, "conf_seed")
        if conf is not None:
            # conformer augmentation: a fresh conformer is the ground truth
            from ..chem.embed import embed_molecule

            embed_molecule(mol, seed=conf)

        orig_pos = mol.coords.copy()
        if s.matching:
            from ..chem.conformer_matching import optimize_rotatable_bonds
            from ..chem.embed import embed_molecule

            matched = mol.copy()
            embed_molecule(matched, seed=s.seed)
            rmsd = optimize_rotatable_bonds(matched, orig_pos, s.popsize, s.maxiter)
            mol = matched
        else:
            rmsd = 0.0

        aug = _int_field(record, "phore_seed")
        if s.ligand_only or not record.get("phore") or aug is not None or conf is not None:
            from .phore_sampling import random_ligand_phore

            base = s.seed + mol.num_atoms
            try:
                num_ex = int(record.get("aug_num_ex", 5))
            except (TypeError, ValueError):
                num_ex = 5
            if aug is None and conf is None:
                phore_seed = base
            else:
                phore_seed = base + 7919 * (aug or 0) + 104729 * (conf or 0)
            phore = random_ligand_phore(mol, name, num_ex=num_ex, seed=phore_seed)
            if phore is None:
                return None
        else:
            phore = parse_phore(str(record["phore"]))[0]

        n_feat = len(phore.features)
        if s.min_phore_num and n_feat < s.min_phore_num:
            return None
        if s.max_phore_num and n_feat > s.max_phore_num:
            return None
        from ..chem.topology import rotatable_bonds

        n_tor = len(rotatable_bonds(mol)[0])
        a_pad = round_up(mol.num_atoms, s.a_step, s.a_min)
        p_pad = round_up(len(phore.all_points), s.p_step, s.p_min)
        t_pad = round_up(max(n_tor, 1), s.t_step, s.t_min)
        if a_pad > s.max_atoms or p_pad > s.max_phore_points or t_pad > s.max_torsions:
            log_warn(f"{name}: exceeds bucket caps (A={a_pad}, P={p_pad}, T={t_pad}), skipped")
            return None
        return build_complex(
            name, mol, phore, a_pad=a_pad, p_pad=p_pad, t_pad=t_pad,
            orig_pos=orig_pos if s.keep_original else None,
            meta={"phore_file": str(record.get("phore", "")),
                  "ligand_description": str(desc), "rmsd_matching": rmsd},
        )
    except Exception as e:  # noqa: BLE001 - skip and log, as the JAX package does
        log_warn(f"Featurization failed for `{name}`: {e}")
        return None


def save_complex(batch: ComplexBatch, path: str) -> None:
    """One complex as the JAX package writes it: every array field (integer
    fields as int32), the true pose as ``__orig_pos`` and the name and
    scalar meta as JSON bytes; a temporary file renamed into place, so a
    torn file never shows under the final name."""
    arrays = {}
    for k in ARRAY_FIELDS:
        v = getattr(batch, k).cpu().numpy()
        arrays[k] = v.astype(np.int32) if v.dtype == np.int64 else v
    meta = dict(batch.meta[0])
    orig = meta.pop("orig_pos", None)
    if orig is not None:
        arrays["__orig_pos"] = np.asarray(orig)
    arrays["__meta"] = np.frombuffer(json.dumps(
        {"name": batch.names[0],
         **{k: v for k, v in meta.items() if isinstance(v, (str, int, float))}}
    ).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def _worker(args) -> Optional[str]:
    record, settings_dict, cache_file = args
    batch = featurize_record(record, DatasetSettings(**settings_dict))
    if batch is None:
        # negative cache: later constructions skip records that fail
        with open(cache_file + ".skip", "w") as f:
            f.write("")
        return None
    save_complex(batch, cache_file)
    return cache_file


def _pool_map(num_workers: int, todo: List) -> List[Optional[str]]:
    """``_worker`` over ``todo`` in ``num_workers`` spawn processes (not
    fork: the caller may hold a CUDA context, which a worker never touches),
    each started with one thread per numeric library.  Close and join rather
    than terminate, which would kill respawned workers mid-write.  A script
    that calls this needs the ``if __name__ == "__main__":`` guard, as every
    spawn pool does."""
    with worker_environment():
        pool = multiprocessing.get_context("spawn").Pool(num_workers, maxtasksperchild=32)
        try:
            return pool.map(_worker, todo)
        finally:
            pool.close()
            pool.join()


class Subset:
    """Index view of a dataset (the warm-up epochs train on fewer samples)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)
        self.files = [dataset.files[i] for i in self.indices]

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> ComplexBatch:
        return self.dataset[self.indices[idx]]


def warmup_subset(dataset, number: int, proportion: float, seed: int = 0):
    """Random warm-up subset: ``number`` samples when > 0, else
    ``proportion`` of the dataset."""
    n = min(number, len(dataset)) if number > 0 else max(1, int(proportion * len(dataset)))
    if n >= len(dataset):
        return dataset
    rng = np.random.default_rng(seed)
    return Subset(dataset, rng.permutation(len(dataset))[:n])


class _FileDataset:
    """Complexes of ``self.files``, loaded as B = 1 CPU batches, memoized
    when ``ram_cache``."""

    files: List[str]
    _ram: Optional[Dict[int, ComplexBatch]]

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> ComplexBatch:
        if self._ram is None:
            return load_cached(self.files[idx])
        hit = self._ram.get(idx)
        if hit is None:
            hit = self._ram[idx] = load_cached(self.files[idx])
        return hit


class PhoreDataset(_FileDataset):
    """The records' complexes, featurized once and cached one ``.npz`` per
    record.  ``featurized`` counts the records this construction featurized
    (0 when every record was a cache or ``.skip`` hit).  With ``featurize``
    False a record that is neither cached nor skipped raises ``SystemExit``."""

    def __init__(
        self,
        records: Sequence[Dict],
        settings: Optional[DatasetSettings] = None,
        cache_path: str = "data/cache",
        num_workers: int = 1,
        name: str = "dataset",
        ram_cache: bool = False,
        featurize: bool = True,
    ):
        self.settings = settings or DatasetSettings()
        self.records = list(records)
        self.cache_dir = os.path.join(cache_path, f"{name}_{self.settings.digest()}")
        os.makedirs(self.cache_dir, exist_ok=True)
        self.files: List[str] = []
        self._ram = {} if ram_cache else None
        self.featurized = 0
        self._preprocess(num_workers, featurize)

    def _preprocess(self, num_workers: int, featurize: bool) -> None:
        todo = []
        for r in self.records:
            f = os.path.join(self.cache_dir, _record_key(r) + ".npz")
            if os.path.exists(f):
                self.files.append(f)
            elif not os.path.exists(f + ".skip"):
                todo.append((r, dataclasses.asdict(self.settings), f))
        if todo and not featurize:
            raise SystemExit(f"{len(todo)} of {len(self.records)} complexes are not cached in "
                             f"{self.cache_dir}; featurize them first (--featurize_only, "
                             "one process)")
        if todo:
            log_info(f"Featurizing {len(todo)} complexes "
                     f"({len(self.records) - len(todo)} cached) -> {self.cache_dir}")
            workers = min(num_workers, len(todo))
            if workers > 1:
                results = _pool_map(workers, todo)
            else:
                results = [_worker(t) for t in todo]
            self.files.extend(f for f in results if f)
            self.featurized = len(todo)
        log_info(f"Dataset ready: {len(self.files)}/{len(self.records)} complexes")


class CachedDataset(_FileDataset):
    """The ``.npz`` complexes of one or more cache directories, in sorted
    order."""

    def __init__(self, directories: Sequence[str], limit: int = 0, ram_cache: bool = True):
        self.files = []
        for d in directories:
            if not os.path.isdir(d):
                raise FileNotFoundError(f"cache directory `{d}` not found")
            self.files.extend(sorted(glob.glob(os.path.join(d, "*.npz"))))
        if limit:
            self.files = self.files[:limit]
        self._ram = {} if ram_cache else None


def cache_directories(cache_path: str, name: str) -> List[str]:
    """The ``<cache_path>/<name>_*`` directories, sorted."""
    return sorted(d for d in glob.glob(os.path.join(cache_path, f"{name}_*")) if os.path.isdir(d))


# ---------------------------------------------------------------- records IO
#: the strings pandas' ``read_csv`` reads as missing by default
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_TRUE, _FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}
_INT = re.compile(r"^\s*[-+]?\d+\s*$")
_FLOAT = re.compile(r"^\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?\s*$")


def _column(raw: List[str]) -> List:
    """One column's values as pandas' type inference gives them: int when
    every present value is an integer and none is missing, float when every
    present value is a number (missing ones NaN), bool for True/False
    spellings, else the strings; a missing cell is None."""
    present = [v for v in raw if v not in NA_VALUES]
    missing = len(present) < len(raw)
    if present and all(_INT.match(v) for v in present):
        cast = float if missing else int
    elif present and all(_FLOAT.match(v) for v in present):
        cast = float
    elif present and all(v in _TRUE or v in _FALSE for v in present):
        cast = _TRUE.__contains__
    else:
        cast = str
    return [None if v in NA_VALUES else cast(v.strip() if cast is not str else v) for v in raw]


def records_from_csv(path: str, pandas_records: bool = False) -> List[Dict]:
    """The JAX package's ``pd.read_csv(path).drop_duplicates()`` records,
    without pandas: each column typed as pandas infers it (so a column of
    integers with an empty cell gives floats, ``3.0``, which the cache key
    hashes as such), duplicate rows dropped after typing with the first kept,
    and missing cells left out of each record, so a record hashes as one from
    a CSV without that column.  A first data row longer than the header
    gives up its leading fields as pandas' index.  ``pandas_records``: the
    rows as ``pd.read_csv(path).to_dict("records")`` gives them instead,
    every row, a missing cell NaN."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        return []
    header, body = rows[0], rows[1:]
    if body and len(body[0]) > len(header):
        # pandas takes the leading extra fields as the (dropped) index
        extra = len(body[0]) - len(header)
        body = [r[extra:] for r in body]
    body = [r + [""] * (len(header) - len(r)) for r in body]
    columns = [_column([r[c] for r in body]) for c in range(len(header))]
    records, seen = [], set()
    for i in range(len(body)):
        values = tuple(col[i] for col in columns)
        if pandas_records:
            records.append({k: float("nan") if v is None else v for k, v in zip(header, values)})
            continue
        if values in seen:
            continue
        seen.add(values)
        records.append({k: v for k, v in zip(header, values) if v is not None})
    return records


def records_from_pdbbind_split(split_file: str, data_dir: str, flag: str = "phore") -> List[Dict]:
    """PDBbind layout: ``{data_dir}/{flag}/{name}/{name}_complex.phore`` and
    ``{data_dir}/{name}/{name}_ligand.(sdf|mol2)`` or
    ``{data_dir}/ligands/{name}_ligand.sdf``."""
    with open(split_file) as f:
        names = [line.strip() for line in f if line.strip()]
    records = []
    for n in names:
        phore = os.path.join(data_dir, flag, n, f"{n}_complex.phore")
        lig = None
        for cand in (
            os.path.join(data_dir, n, f"{n}_ligand.sdf"),
            os.path.join(data_dir, n, f"{n}_ligand.mol2"),
            os.path.join(data_dir, "ligands", f"{n}_ligand.sdf"),
        ):
            if os.path.exists(cand):
                lig = cand
                break
        if lig and os.path.exists(phore):
            records.append({"name": n, "phore": phore, "ligand_description": lig})
    return records
