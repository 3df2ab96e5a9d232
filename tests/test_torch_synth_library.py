"""The port's synthetic ligand library (``diffphore_torch.data.synth_library``)
against the JAX package's: the same seed gives the same SMILES, string for
string, the same v2 molecules and their metadata, the same CSV bytes, and
a generated row featurizes through the port's ``--ligand_only`` dataset path
to the JAX package's arrays."""

import numpy as np
import pytest

from diffphore_torch.data import synth_library as tlib
from diffphore_tpu.data import synth_library as jlib

TABLES = ("SCAFFOLDS", "SUBSTITUENTS", "N_SUBSTITUENTS", "CORES_V2_TRAIN", "CORES_V2_HELDOUT",
          "CAPS_TRAIN", "CAPS_HELDOUT", "LINKERS")


@pytest.mark.parametrize("table", TABLES)
def test_tables_verbatim(table):
    assert getattr(tlib, table) == getattr(jlib, table)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_generate_library_matches_jax(seed):
    got = tlib.generate_library(12, seed)
    assert got == jlib.generate_library(12, seed)
    assert len(got) == 12 and len(set(got)) == 12


@pytest.mark.parametrize("heldout", [False, True], ids=["train_pool", "heldout_pool"])
@pytest.mark.parametrize("seed", [0, 5])
def test_generate_library_v2_matches_jax(seed, heldout):
    smiles, meta = tlib.generate_library_v2(8, seed, heldout)
    want_smiles, want_meta = jlib.generate_library_v2(8, seed, heldout)
    assert smiles == want_smiles and meta == want_meta
    assert len(smiles) == 8
    cores = tlib.CORES_V2_HELDOUT if heldout else tlib.CORES_V2_TRAIN
    assert all(m["core"] in cores for m in meta)


@pytest.mark.parametrize("seed", [1, 2])
def test_substitute_draws_match_jax(seed):
    """The v1 decoration alone, every scaffold, one generator each side."""
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    for scaffold in tlib.SCAFFOLDS:
        assert tlib._substitute(scaffold, rt) == jlib._substitute(scaffold, rj)
    assert rt.random() == rj.random()


def test_write_library_csv_same_bytes(tmp_path):
    lib = ["c1ccccc1O", "CC(=O)N,odd", 'C"C']   # a comma and a quote take quoting
    tlib.write_library_csv(str(tmp_path / "port.csv"), lib)
    jlib.write_library_csv(str(tmp_path / "jax.csv"), lib, name_prefix="synth")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_main_writes_the_same_csv(tmp_path, capsys):
    argv = ["--n", "3", "--seed", "4"]
    tlib.main(argv + ["--out", str(tmp_path / "port.csv")])
    jlib.main(argv + ["--out", str(tmp_path / "jax.csv")])
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert "wrote 3 ligands" in capsys.readouterr().out


def test_generated_row_featurizes_ligand_only(tmp_path):
    """A generated CSV row through ``records_from_csv`` and
    ``featurize_record`` with ``ligand_only``: the JAX package's arrays."""
    from diffphore_torch.data import dataset as tds
    from diffphore_torch.data.graphs import ARRAY_FIELDS
    from diffphore_tpu.data import dataset as jds

    lib = tlib.generate_library(2, seed=11)
    path = str(tmp_path / "lib.csv")
    tlib.write_library_csv(path, lib)
    records = tds.records_from_csv(path)
    assert records == jds.records_from_csv(path)
    assert len(records) == 2 and records[0]["name"] == "synth_00000"
    got = tds.featurize_record(records[0], tds.DatasetSettings(ligand_only=True))
    want = jds.featurize_record(records[0], jds.DatasetSettings(ligand_only=True))
    assert got is not None and want is not None
    assert np.isfinite(got.lig_pos.numpy()).all()
    assert int(got.phore_mask[0].sum()) >= 4
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
