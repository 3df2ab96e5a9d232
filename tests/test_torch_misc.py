"""The port's host utilities (``diffphore_torch.utils.misc``) against the JAX
package's ``utils/misc.py``: the YAML text of the CLIs' settings, the host
seeding, the time limit and the RMSD fallback, all exact."""

import os
import random
import time

import numpy as np
import pytest
import yaml

from diffphore_torch.chem.sdf import parse_sdf, write_sdf
from diffphore_torch.utils import flat_yaml
from diffphore_torch.utils import misc as tmisc
from diffphore_tpu.utils import misc as jmisc

from torch_port_helpers import REPO

EXAMPLES = os.path.join(REPO, "examples")


def _cli_namespaces():
    from diffphore_torch.cli import evaluate, inference, train

    return {
        "train": train.parse_args(["--train_csv", "a.csv", "--ligand_only"]),
        "inference": inference.parse_args(["--out_dir", "out", "--cutoff", "0.5"]),
        "evaluate": evaluate.parse_args(["--test_csv", "t.csv"]),
    }


@pytest.mark.parametrize("cli", ["train", "inference", "evaluate"])
def test_save_yaml_file_namespace_matches_pyyaml(cli, tmp_path):
    ns = _cli_namespaces()[cli]
    tmisc.save_yaml_file(str(tmp_path / "port.yml"), ns)
    jmisc.save_yaml_file(str(tmp_path / "jax.yml"), ns)
    text = (tmp_path / "port.yml").read_text()
    assert text == (tmp_path / "jax.yml").read_text()
    assert flat_yaml.loads(text) == yaml.safe_load(text) == vars(ns)


@pytest.mark.parametrize("content", [
    {"lr": 1e-3, "n": 3, "name": "run", "flag": True, "none": None, "empty": [],
     "sizes": [1, 2.5, "x"], "yes_string": "yes", "quoted": "a: b", "path": "runs/x.csv",
     "number_string": "1.5", "octal_like": "012", "blank": "", "tilde": "~"},
    ["a", 1, 2.5, None, True],
    {},
    [],
], ids=["dict", "list", "empty_dict", "empty_list"])
def test_save_yaml_file_dict_matches_pyyaml(content, tmp_path):
    tmisc.save_yaml_file(str(tmp_path / "port.yml"), content)
    jmisc.save_yaml_file(str(tmp_path / "jax.yml"), content)
    assert (tmp_path / "port.yml").read_text() == (tmp_path / "jax.yml").read_text()


def test_read_strings_from_txt(tmp_path):
    path = tmp_path / "names.txt"
    path.write_text("  a \n\n b\n\t\nc")
    assert tmisc.read_strings_from_txt(str(path)) == jmisc.read_strings_from_txt(str(path)) \
        == ["a", "b", "c"]


@pytest.mark.parametrize("seed", [0, 7])
def test_set_seed_gives_the_same_draws(seed):
    jmisc.set_seed(seed)
    want = (random.random(), random.randint(0, 10**9), np.random.rand(5).tolist(),
            np.random.randint(0, 100, 4).tolist())
    tmisc.set_seed(seed)
    got = (random.random(), random.randint(0, 10**9), np.random.rand(5).tolist(),
           np.random.randint(0, 100, 4).tolist())
    assert got == want


def test_time_limit_raises_and_restores():
    import signal

    before = signal.getsignal(signal.SIGALRM)
    with pytest.raises(TimeoutError):
        with tmisc.time_limit(0.05):
            time.sleep(2)
    assert signal.getsignal(signal.SIGALRM) is before
    with tmisc.time_limit(5):          # a block inside its limit runs through
        pass


def _pose_file(tmp_path, name):
    """An example ligand's heavy atoms at three coordinate sets: as given, moved, and
    with two atoms swapped (a symmetry RMSD sees through the swap only where
    the graph allows it)."""
    mol = parse_sdf(os.path.join(EXAMPLES, f"{name}.sdf"))[0].remove_hs()
    rng = np.random.default_rng(0)
    moved = mol.coords + rng.normal(scale=0.5, size=mol.coords.shape)
    swapped = mol.coords.copy()
    swapped[[0, 1]] = swapped[[1, 0]]
    path = str(tmp_path / f"{name}_poses.sdf")
    write_sdf(mol, path, multi_coords=[mol.coords, moved, swapped], name=name, marker="pose")
    return path


@pytest.mark.parametrize("name", ["EX01", "EX02"])
def test_get_obrmsd_fallback_matches_jax(name, tmp_path):
    ref = os.path.join(EXAMPLES, f"{name}.sdf")
    poses = _pose_file(tmp_path, name)
    missing = "obrms_not_installed"
    got = tmisc.get_obrmsd(ref, poses, obrms_binary=missing)
    want = jmisc.get_obrmsd(ref, poses, obrms_binary=missing)
    assert got == want and len(got) == 3 and got[0] == pytest.approx(0.0, abs=1e-6)
    empty = tmp_path / "empty.sdf"
    empty.write_text("")
    assert tmisc.get_obrmsd(str(empty), poses, missing) is None
    assert jmisc.get_obrmsd(str(empty), poses, missing) is None


def test_get_obrmsd_reads_obrms_output(tmp_path):
    """With an ``obrms`` on PATH the last field of each output line is the
    RMSD: a stub binary's lines, parsed alike."""
    stub = tmp_path / "obrms_stub"
    stub.write_text("#!/bin/sh\necho 'RMSD a:b 0.5'\necho 'RMSD a:c 1.25'\n")
    stub.chmod(0o755)
    got = tmisc.get_obrmsd("r.sdf", "p.sdf", obrms_binary=str(stub))
    assert got == jmisc.get_obrmsd("r.sdf", "p.sdf", obrms_binary=str(stub)) == [0.5, 1.25]
