"""The port's conformer matching (``diffphore_torch.chem.conformer_matching``)
against the JAX package's on the CPU: the dihedral helpers within 1e-10, and
the differential-evolution torsion fit, with one seed, to the same angles
and RMSD within 1e-8."""

import os

import numpy as np
import pytest

from diffphore_torch.chem import conformer_matching as tcm
from diffphore_torch.chem.embed import embed_molecule as t_embed
from diffphore_torch.chem.sdf import read_molecule as t_read
from diffphore_torch.chem.topology import rotatable_bonds, torsion_dihedral_atoms
from diffphore_tpu.chem import conformer_matching as jcm
from diffphore_tpu.chem.embed import embed_molecule as j_embed
from diffphore_tpu.chem.sdf import read_molecule as j_read

from torch_port_helpers import REPO

LIGANDS = [os.path.join(REPO, "examples", f"EX0{i}.sdf") for i in (1, 2, 3)]


@pytest.mark.parametrize("path", LIGANDS, ids=os.path.basename)
def test_dihedral_helpers_match(path):
    mol = t_read(path, remove_hs=True)
    quads = torsion_dihedral_atoms(mol)
    edges, masks = rotatable_bonds(mol)
    bond = {tuple(e): k for k, e in enumerate(edges.tolist())}
    rng = np.random.default_rng(0)
    for quad in quads:
        assert abs(tcm.get_dihedral(mol.coords, *quad) - jcm.get_dihedral(mol.coords, *quad)) \
            <= 1e-10
        mask = masks[bond.get((quad[1], quad[2]), bond.get((quad[2], quad[1])))]
        angle = float(rng.uniform(-np.pi, np.pi))
        got = tcm.set_dihedral(mol.coords, quad, mask, angle)
        assert np.abs(got - jcm.set_dihedral(mol.coords, quad, mask, angle)).max() <= 1e-10
        assert abs(np.angle(np.exp(1j * (tcm.get_dihedral(got, *quad) - angle)))) <= 1e-6
    b = mol.coords + rng.normal(size=mol.coords.shape)
    assert abs(tcm.aligned_rmsd(mol.coords, b) - jcm.aligned_rmsd(mol.coords, b)) <= 1e-10


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("path", LIGANDS, ids=os.path.basename)
def test_optimize_rotatable_bonds_matches(path, seed):
    jm, tm = j_read(path, remove_hs=True), t_read(path, remove_hs=True)
    truth = tm.coords.copy()
    j_embed(jm, seed=seed)
    t_embed(tm, seed=seed)
    assert np.array_equal(jm.coords, tm.coords)
    want = jcm.optimize_rotatable_bonds(jm, truth, popsize=5, maxiter=4, seed=seed)
    got = tcm.optimize_rotatable_bonds(tm, truth, popsize=5, maxiter=4, seed=seed)
    assert abs(got - want) <= 1e-8
    assert np.abs(tm.coords - jm.coords).max() <= 1e-8
    for quad in torsion_dihedral_atoms(tm):
        assert abs(tcm.get_dihedral(tm.coords, *quad) - jcm.get_dihedral(jm.coords, *quad)) <= 1e-8
