"""The port's random pharmacophores (``diffphore_torch.data.phore_sampling``)
against the JAX package's on the CPU: the same seed gives the same phore,
feature for feature, over seeds, ligands and EX counts."""

import os

import numpy as np
import pytest

from diffphore_torch.chem.sdf import read_molecule as t_read
from diffphore_torch.data import phore_sampling as tps
from diffphore_tpu.chem.sdf import read_molecule as j_read
from diffphore_tpu.data import phore_sampling as jps

from torch_port_helpers import REPO

LIGANDS = [os.path.join(REPO, "examples", f"EX0{i}.sdf") for i in (1, 2, 3)]


def _same_phore(j, t):
    if j is None or t is None:
        assert j is None and t is None
        return
    assert t.id == j.id
    for fj, ft in zip(j.all_points, t.all_points):
        assert (ft.type, ft.has_norm, ft.label) == (fj.type, fj.has_norm, fj.label)
        assert (ft.alpha, ft.weight, ft.factor, ft.anchor_weight) == (
            fj.alpha, fj.weight, fj.factor, fj.anchor_weight)
        assert ft.coord == fj.coord and ft.norm == fj.norm
    assert (len(t.features), len(t.exclusion_volumes)) == (len(j.features),
                                                           len(j.exclusion_volumes))


@pytest.mark.parametrize("num_ex", [2, 3, 5])
@pytest.mark.parametrize("path", LIGANDS, ids=os.path.basename)
def test_random_ligand_phore_matches(path, num_ex):
    jm, tm = j_read(path, remove_hs=True), t_read(path, remove_hs=True)
    for seed in range(6):
        _same_phore(jps.random_ligand_phore(jm, "lig", num_ex=num_ex, seed=seed),
                    tps.random_ligand_phore(tm, "lig", num_ex=num_ex, seed=seed))


@pytest.mark.parametrize("path", LIGANDS, ids=os.path.basename)
def test_the_steps_match(path):
    jm, tm = j_read(path, remove_hs=True), t_read(path, remove_hs=True)
    jfull, tfull = jps.phore_from_ligand(jm, "full"), tps.phore_from_ligand(tm, "full")
    _same_phore(jfull, tfull)
    assert [[f.coord for f in c] for c in jps._clusters(jfull)] == [
        [f.coord for f in c] for c in tps._clusters(tfull)]
    jsubs = jps.extract_random_phore(jfull, sample_num=5, rng=np.random.default_rng(3))
    tsubs = tps.extract_random_phore(tfull, sample_num=5, rng=np.random.default_rng(3))
    assert len(jsubs) == len(tsubs) > 0
    for a, b in zip(jsubs, tsubs):
        _same_phore(a, b)
    for near in (True, False):
        _same_phore(
            jps.generate_random_exclusion_volumes(jsubs[0], jm, near_phore=near,
                                                  rng=np.random.default_rng(9)),
            tps.generate_random_exclusion_volumes(tsubs[0], tm, near_phore=near,
                                                  rng=np.random.default_rng(9)))
