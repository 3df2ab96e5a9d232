"""The port's raw-file datasets (``diffphore_torch.data.dataset``) against
the JAX package's on the CPU: CSV records as pandas reads them, the settings
digest and record keys (so both packages name the same cache files), every
branch of ``featurize_record`` field for field, ``.npz`` files that each
package loads from the other, and ``PhoreDataset``'s cache, negative cache
and spawn workers."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from diffphore_torch.cli import train as tcli
from diffphore_torch.data import dataset as td
from diffphore_torch.data.graphs import ARRAY_FIELDS, load_cached
from diffphore_tpu.data import dataset as jd

from torch_port_helpers import REPO

torch.set_num_threads(2)

EXAMPLES = os.path.join(REPO, "examples")
PHORE = os.path.join(EXAMPLES, "example.phore")
SMALL_SMILES = "CC(=O)Nc1ccc(O)cc1"
CSVS = sorted(glob.glob(os.path.join(REPO, "runs", "**", "*.csv"), recursive=True)
              + glob.glob(os.path.join(EXAMPLES, "*.csv")))

#: crafted CSVs for pandas' type inference and drop_duplicates
CRAFTED = {
    "duplicates": "name,ligand_description,aug_num_ex\na,CCO,3\nb,CCN,3\na,CCO,3\na,CCO,4\n",
    "int_with_empty": "name,ligand_description,aug_num_ex,pose_index\na,CCO,3,\nb,CCN,,7\n",
    "bool_and_str": ("name,ligand_description,flag,flag2,tag,num\n"
                     "a,CCO,True,true,x,1\nb,CCN,false,,7,2.5\nc,CCC,TRUE,False,y,\n"),
    "all_empty_column": "name,ligand_description,phore,conf_seed\na,CCO,,\nb,CCN,,\n",
    "na_spellings_and_quotes": ('name,ligand_description,note,x\na,CCO,NA,1e2\n'
                                'b,"C,C",None,.5\nc,CCC,"q ""1""",-3\nb,"C,C",None,.5\n'),
    "duplicates_after_typing": "name,ligand_description,x\na,CCO,1\na,CCO,1.0\na,CCO,\n",
    "implicit_index": "only\nx,y,1\nz,w,2\n",
}


def _same_records(path):
    want, got = jd.records_from_csv(path), td.records_from_csv(path)
    assert json.dumps(got) == json.dumps(want)
    assert [type(v) for r in got for v in r.values()] == [type(v) for r in want for v in r.values()]
    assert [td._record_key(r) for r in got] == [jd._record_key(r) for r in want]


@pytest.mark.parametrize("path", CSVS, ids=lambda p: os.path.relpath(p, REPO))
def test_records_from_csv_matches_the_jax_package_on_the_repo_csvs(path):
    _same_records(path)


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_records_from_csv_matches_the_jax_package_on_crafted_csvs(name, tmp_path):
    path = tmp_path / f"{name}.csv"
    path.write_text(CRAFTED[name])
    _same_records(str(path))


def test_corpus2_sqc_rows_hash_floats():
    """The sQC rows' empty ``aug_num_ex`` cells make the column float, so
    every row carries ``3.0`` and ``pose_index`` ``7.0``-style floats."""
    recs = td.records_from_csv(os.path.join(REPO, "runs", "corpus2", "train.csv"))
    flex = next(r for r in recs if r["name"].startswith("flex_"))
    sqc = next(r for r in recs if r["name"].startswith("sQC_"))
    assert flex["aug_num_ex"] == 3.0 and isinstance(flex["aug_num_ex"], float)
    assert isinstance(sqc["pose_index"], float) and "aug_num_ex" not in sqc
    assert "phore" not in flex and "conf_seed" not in flex


@pytest.mark.parametrize("kw", [
    {}, {"matching": True, "popsize": 4}, {"a_min": 48, "p_min": 160, "p_step": 32, "t_min": 16},
    {"consider_ex": False}, {"neighbor_cutoff": 4.0}, {"ex_connected": False},
    {"min_phore_num": 3, "max_phore_num": 15}, {"ligand_only": True, "seed": 3},
])
def test_settings_digest_matches(kw):
    assert td.DatasetSettings(**kw).digest() == jd.DatasetSettings(**kw).digest()
    assert dataclasses.asdict(td.DatasetSettings(**kw)) == dataclasses.asdict(
        jd.DatasetSettings(**kw))


def test_default_digest_names_the_committed_cache():
    assert td.DatasetSettings().digest() == "bb5cb66619"
    assert os.path.isdir(os.path.join(REPO, "data", "cache", "train_bb5cb66619"))


def test_trainer_records_name_the_committed_corpus_cache():
    """runs/corpus/train365.csv with the corpus recipe's augmentation (3
    sub-phores, 3 conformers, 3 EX per feature) and bucket flags gives the
    settings digest and the 2,555 file names of data/cache/train_f1112e7d33."""
    args = tcli.parse_args(["--train_csv", "x", "--phore_augment", "3", "--conf_augment", "3",
                            "--phore_augment_ex", "3", "--bucket_a_min", "24",
                            "--bucket_p_min", "48", "--bucket_p_step", "32",
                            "--bucket_t_min", "8"])
    assert tcli.dataset_settings(args).digest() == "f1112e7d33"
    recs = tcli.augmented_records(
        td.records_from_csv(os.path.join(REPO, "runs", "corpus", "train365.csv")), args)
    have = {os.path.basename(f)[:-4]
            for f in glob.glob(os.path.join(REPO, "data", "cache", "train_f1112e7d33", "*.npz"))}
    assert len(recs) == 365 * 7 and {td._record_key(r) for r in recs} == have


def test_featurization_recreates_a_committed_cache_file():
    """A record of runs/corpus/val30.csv featurized by the port equals, bit
    for bit, the .npz the JAX package wrote for it (SMILES embedding, random
    phore, buckets)."""
    s = td.DatasetSettings(a_min=24, p_min=48, t_min=8, p_step=32)
    rec = td.records_from_csv(os.path.join(REPO, "runs", "corpus", "val30.csv"))[1]
    got = td.featurize_record(rec, s)
    want = load_cached(os.path.join(REPO, "data", "cache", f"val_{s.digest()}",
                                    td._record_key(rec) + ".npz"))
    _same_batch_torch(got, want)


# ------------------------------------------------------------------ branches
def _same_batch(j, t):
    """A JAX ComplexBatch against a port one: every field, the names, meta."""
    assert tuple(j.names) == tuple(t.names)
    for k in ARRAY_FIELDS:
        a, b = np.asarray(getattr(j, k)), getattr(t, k).numpy()
        assert a.shape == b.shape and np.array_equal(a, b.astype(a.dtype)), k
    mj, mt = dict(j.meta[0]), dict(t.meta[0])
    oj, ot = mj.pop("orig_pos", None), mt.pop("orig_pos", None)
    assert mj == mt
    assert (oj is None) == (ot is None)
    if oj is not None:
        assert np.array_equal(oj, ot)


def _same_batch_torch(a, b):
    assert tuple(a.names) == tuple(b.names)
    for k in ARRAY_FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    ma, mb = dict(a.meta[0]), dict(b.meta[0])
    oa, ob = ma.pop("orig_pos", None), mb.pop("orig_pos", None)
    assert ma == mb and np.array_equal(oa, ob)


@pytest.fixture(scope="module")
def multipose_sdf(tmp_path_factory):
    path = tmp_path_factory.mktemp("sdf") / "poses.sdf"
    path.write_text("".join(open(os.path.join(EXAMPLES, f"EX0{i}.sdf")).read()
                            for i in (1, 2, 3)))
    return str(path)


def _ex(i):
    return os.path.join(EXAMPLES, f"EX0{i}.sdf")


#: (id, record, settings) for each branch of featurize_record
BRANCHES = [
    ("file", {"name": "ex01", "ligand_description": _ex(1), "phore": PHORE}, {}),
    ("multipose", {"name": "mp", "ligand_description": "MULTI", "phore": PHORE,
                   "pose_index": 1.0}, {}),
    ("multipose_keep_hs", {"name": "mp", "ligand_description": "MULTI", "phore": PHORE,
                           "pose_index": 2}, {"remove_hs": False}),
    ("smiles", {"name": "smi", "ligand_description": SMALL_SMILES, "aug_num_ex": 3}, {}),
    ("smiles_seed", {"name": "smi", "ligand_description": SMALL_SMILES}, {"seed": 5}),
    ("conf_seed", {"name": "smi~conf2", "ligand_description": SMALL_SMILES, "aug_num_ex": 3,
                   "conf_seed": 2}, {}),
    ("conf_seed_on_file", {"name": "ex03~conf1", "ligand_description": _ex(3), "phore": PHORE,
                           "conf_seed": 1.0, "aug_num_ex": 3}, {}),
    ("matching", {"name": "ex02", "ligand_description": _ex(2), "phore": PHORE},
     {"matching": True, "popsize": 4, "maxiter": 3}),
    ("phore_seed", {"name": "ex01~aug2", "ligand_description": _ex(1), "phore": PHORE,
                    "phore_seed": 2, "aug_num_ex": 3.0}, {}),
    ("ligand_only", {"name": "ex01", "ligand_description": _ex(1), "phore": PHORE},
     {"ligand_only": True}),
    ("recipe_bucket", {"name": "ex02", "ligand_description": _ex(2), "phore": PHORE},
     {"a_min": 48, "p_min": 160, "p_step": 32, "t_min": 16}),
    ("keep_original_off", {"name": "ex01", "ligand_description": _ex(1), "phore": PHORE},
     {"keep_original": False}),
]
#: records each package must refuse (None): caps, an unreadable ligand
REFUSED = [
    ("max_phore_num", {"name": "ex01", "ligand_description": _ex(1), "phore": PHORE},
     {"max_phore_num": 2}),
    ("min_phore_num", {"name": "ex01", "ligand_description": _ex(1), "phore": PHORE},
     {"min_phore_num": 100}),
    ("max_lig_size", {"name": "ex01", "ligand_description": _ex(1), "phore": PHORE},
     {"max_lig_size": 5}),
    ("bucket_cap", {"name": "ex01", "ligand_description": _ex(1), "phore": PHORE},
     {"max_atoms": 8}),
    ("phore_points_cap", {"name": "ex01", "ligand_description": _ex(1), "phore": PHORE},
     {"max_phore_points": 32}),
    ("bad_smiles", {"name": "bad", "ligand_description": "C1CC(=O"}, {}),
    ("missing_phore_file", {"name": "ex01", "ligand_description": _ex(1),
                            "phore": "/nonexistent.phore"}, {}),
]


def _resolve(record, multipose_sdf):
    return {k: (multipose_sdf if v == "MULTI" else v) for k, v in record.items()}


@pytest.mark.parametrize("record,kw", [b[1:] for b in BRANCHES], ids=[b[0] for b in BRANCHES])
def test_featurize_record_matches_the_jax_package(record, kw, multipose_sdf):
    record = _resolve(record, multipose_sdf)
    want = jd.featurize_record(record, jd.DatasetSettings(**kw))
    got = td.featurize_record(record, td.DatasetSettings(**kw))
    assert want is not None and got is not None
    _same_batch(want, got)
    assert got.lig_pos.device.type == "cpu"


@pytest.mark.parametrize("record,kw", [b[1:] for b in REFUSED], ids=[b[0] for b in REFUSED])
def test_featurize_record_refuses_as_the_jax_package(record, kw):
    assert jd.featurize_record(record, jd.DatasetSettings(**kw)) is None
    assert td.featurize_record(record, td.DatasetSettings(**kw)) is None


def test_augmented_phore_seed_arithmetic():
    """phore_seed j and conf_seed k give the random phore of seed
    ``seed + atoms + 7919 j + 104729 k``."""
    from diffphore_torch.chem.sdf import read_molecule
    from diffphore_torch.data.phore_sampling import random_ligand_phore

    rec = {"name": "ex01~aug3", "ligand_description": _ex(1), "phore": PHORE,
           "phore_seed": 3, "aug_num_ex": 2}
    s = td.DatasetSettings(seed=4)
    got = td.featurize_record(rec, s)
    mol = read_molecule(_ex(1), remove_hs=True)
    phore = random_ligand_phore(mol, "ex01~aug3", num_ex=2, seed=4 + mol.num_atoms + 7919 * 3)
    assert int(got.phore_mask.sum()) == len(phore.all_points)


# ----------------------------------------------------------------- npz files
def test_each_package_loads_the_others_npz(tmp_path):
    rec = {"name": "ex01", "ligand_description": _ex(1), "phore": PHORE}
    t_batch = td.featurize_record(rec, td.DatasetSettings())
    j_batch = jd.featurize_record(rec, jd.DatasetSettings())
    td.save_complex(t_batch, str(tmp_path / "port.npz"))
    jd.save_complex(j_batch, str(tmp_path / "jax.npz"))
    _same_batch(jd.load_complex(str(tmp_path / "port.npz")), t_batch)
    _same_batch(j_batch, load_cached(str(tmp_path / "jax.npz")))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert not os.path.exists(tmp_path / "port.npz.tmp.npz")


# ---------------------------------------------------------------- the dataset
DATASET_RECORDS = [
    {"name": "ex01", "ligand_description": _ex(1), "phore": PHORE},
    {"name": "smi", "ligand_description": SMALL_SMILES, "aug_num_ex": 3},
    {"name": "bad", "ligand_description": "C1CC(=O"},
    {"name": "ex02~aug1", "ligand_description": _ex(2), "phore": PHORE, "phore_seed": 1,
     "aug_num_ex": 3},
]


def _tree(d):
    return sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, "**", "*"),
                                                           recursive=True))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    jds = jd.PhoreDataset(DATASET_RECORDS, jd.DatasetSettings(), str(root / "jax"), name="train")
    tds = td.PhoreDataset(DATASET_RECORDS, td.DatasetSettings(), str(root / "port"), name="train")
    return root, jds, tds


def test_phore_dataset_writes_the_jax_packages_files(datasets):
    root, jds, tds = datasets
    assert _tree(str(root / "jax")) == _tree(str(root / "port"))
    assert any(p.endswith(".skip") for p in _tree(str(root / "port")))
    assert os.path.basename(tds.cache_dir) == os.path.basename(jds.cache_dir) == "train_bb5cb66619"
    assert [os.path.basename(f) for f in tds.files] == [os.path.basename(f) for f in jds.files]
    assert len(tds) == 3 and tds.featurized == 4
    for i in range(len(tds)):
        _same_batch(jds[i], tds[i])


def test_phore_dataset_resumes_from_its_cache(datasets):
    root, jds, tds = datasets
    again = td.PhoreDataset(DATASET_RECORDS, td.DatasetSettings(), str(root / "port"),
                            name="train", ram_cache=True)
    assert again.featurized == 0 and again.files == tds.files
    assert again[0] is again[0]                      # ram cache
    # the port resumes from the JAX package's cache as well
    cross = td.PhoreDataset(DATASET_RECORDS, td.DatasetSettings(), str(root / "jax"),
                            name="train")
    assert cross.featurized == 0 and len(cross) == 3


def test_spawn_workers_write_the_same_files(datasets, tmp_path):
    root, _, tds = datasets
    pooled = td.PhoreDataset(DATASET_RECORDS, td.DatasetSettings(), str(tmp_path), name="train",
                             num_workers=2)
    assert _tree(str(tmp_path)) == _tree(str(root / "port"))
    assert pooled.featurized == 4
    for i in range(len(pooled)):
        _same_batch_torch(pooled[i], tds[i])


def test_records_from_pdbbind_split_matches(tmp_path):
    data = tmp_path / "pdbbind"
    for n in ("c1", "c2", "c3"):
        (data / "phore" / n).mkdir(parents=True)
        (data / "phore" / n / f"{n}_complex.phore").write_text("x")
    (data / "c1").mkdir()
    (data / "c1" / "c1_ligand.sdf").write_text("x")
    (data / "ligands").mkdir()
    (data / "ligands" / "c2_ligand.sdf").write_text("x")
    split = tmp_path / "split.txt"
    split.write_text("c1\nc2\n\nc3\n")
    got = td.records_from_pdbbind_split(str(split), str(data))
    assert got == jd.records_from_pdbbind_split(str(split), str(data))
    assert [r["name"] for r in got] == ["c1", "c2"]


def test_augmented_records_match_the_jax_trainer(monkeypatch):
    """The records and settings the trainer hands ``PhoreDataset``, record
    for record, as the JAX ``build_datasets`` hands them."""
    from diffphore_tpu.cli import train as jcli

    seen = {}

    def fake(tag):
        def make(records, settings, cache_path, num_workers, name, ram_cache, featurize=True):
            seen[(tag, name)] = (json.dumps(records), settings.digest(), cache_path, num_workers)
            return name
        return make

    monkeypatch.setattr(jcli, "PhoreDataset", fake("jax"))
    monkeypatch.setattr(tcli, "PhoreDataset", fake("port"))
    argv = ["--train_csv", os.path.join(REPO, "runs", "corpus2", "train.csv"),
            "--val_csv", os.path.join(REPO, "runs", "corpus2", "val.csv"),
            "--phore_augment", "2", "--conf_augment", "1", "--phore_augment_ex", "3",
            "--limit_complexes", "4", "--num_dataloader_workers", "3", "--seed", "2",
            "--bucket_a_min", "48", "--bucket_p_min", "160", "--bucket_p_step", "32",
            "--bucket_t_min", "16", "--cache_path", "somewhere"]
    assert jcli.build_datasets(jcli.parse_args(argv)) == tcli.build_datasets(
        tcli.parse_args(argv)) == ("train", "val")
    for name in ("train", "val"):
        assert seen[("port", name)] == seen[("jax", name)]
    assert len(json.loads(seen[("port", "train")][0])) == 4 * 4
