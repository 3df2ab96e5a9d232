"""The port's host chemistry (``diffphore_torch.chem``) against the JAX
package's (``diffphore_tpu.chem``) on the same inputs, on the CPU: molecules
from the example SDFs, from a MOL2 and a PDB block written here, and from a
panel of SMILES strings.  For each molecule the atoms, bonds, aromatic
flags, ring lists (in order), hybridization, implicit hydrogens, atom
features, pharmacophore features (to 1e-6), scoring fingerprints, lipophilic
flags, rotatable bonds and the written SDF text are equal; embedded
coordinates agree within 1e-6 A."""

import os

import numpy as np
import pytest

from diffphore_torch.chem import embed as tembed
from diffphore_torch.chem import features as tfeatures
from diffphore_torch.chem import lipo as tlipo
from diffphore_torch.chem import pharmacophore_rules as trules
from diffphore_torch.chem import sdf as tsdf
from diffphore_torch.chem import smiles as tsmiles
from diffphore_torch.chem import topology as ttopology
from diffphore_tpu.chem import embed as jembed
from diffphore_tpu.chem import features as jfeatures
from diffphore_tpu.chem import lipo as jlipo
from diffphore_tpu.chem import pharmacophore_rules as jrules
from diffphore_tpu.chem import sdf as jsdf
from diffphore_tpu.chem import smiles as jsmiles
from diffphore_tpu.chem import topology as jtopology

from torch_port_helpers import REPO

EXAMPLES = os.path.join(REPO, "examples")

#: fused aromatics, a steroid, a spiro ring, biaryls, acids and their anions,
#: ammoniums, halogens, a macrocycle, a salt of two components
SMILES_PANEL = [
    "c1ccc2ccccc2c1",                                   # naphthalene
    "c1ccc2[nH]ccc2c1",                                 # indole
    "c1ncc2[nH]cnc2n1",                                 # purine
    "c1ccc2c(c1)ccc1ccccc12",                           # phenanthrene
    "c1ccc2c(c1)[nH]c1ccccc12",                         # carbazole
    "CC12CCC3C(CCC4=CC(=O)CCC34C)C1CCC2O",              # testosterone
    "C1CCC2(CC1)CCNCC2",                                # 3-azaspiro[5.5]undecane
    "c1ccc(cc1)-c1ccccc1",                              # biphenyl
    "OC(=O)c1ccccc1C(=O)[O-]",                          # hydrogen phthalate
    "[NH3+]CC(=O)[O-]",                                 # glycine zwitterion
    "C[N+](C)(C)CCO",                                   # choline
    "Clc1ccc(Br)cc1I",                                  # halogens
    "FC(F)(F)c1ccc(F)cc1",
    "O=C1CCCCCCCCCCCCCCO1",                             # macrocyclic lactone
    "CC(=O)Nc1ccc(O)cc1",                               # paracetamol
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",                     # caffeine, Kekule
    "NS(=O)(=O)c1ccc(cc1)C(=O)O",                       # sulfonamide, acid
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",                       # ibuprofen
    "OP(=O)(O)OCC",                                     # phosphate
    "C=CC(=O)NCC#N",                                    # acrylamide, nitrile
    "CC(=O)[O-].[Na+]",                                 # two components
    "COc1cc2ncnc(Nc3ccc(F)c(Cl)c3)c2cc1OCCCN1CCOCC1",   # gefitinib
]

#: small molecules whose embedding both packages run (the drug-size ones take
#: seconds each)
EMBED_PANEL = ["CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "c1ccc2ccccc2c1",
               "C1CCC2(CC1)CCNCC2", "CC(=O)[O-].[Na+]"]


def write_mol2(mol, path):
    """A TRIPOS MOL2 file of a molecule (element atom types, "ar" bonds)."""
    from diffphore_tpu.chem.mol import AROMATIC_BOND

    lines = ["@<TRIPOS>MOLECULE", "lig", f"{mol.num_atoms} {len(mol.bonds)} 0 0 0", "SMALL",
             "NO_CHARGES", "", "@<TRIPOS>ATOM"]
    for i, (a, (x, y, z)) in enumerate(zip(mol.atoms, mol.coords)):
        lines.append(f"{i + 1} {a.symbol}{i + 1} {x:.4f} {y:.4f} {z:.4f} {a.symbol}.3 1 LIG 0.0")
    lines.append("@<TRIPOS>BOND")
    for k, (i, j, o) in enumerate(mol.bonds):
        lines.append(f"{k + 1} {i + 1} {j + 1} {'ar' if o == AROMATIC_BOND else o}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_pdb(mol, path):
    """HETATM records of a molecule (bonds left to the reader's distance
    rule)."""
    with open(path, "w") as f:
        for i, (a, (x, y, z)) in enumerate(zip(mol.atoms, mol.coords)):
            f.write(f"HETATM{i + 1:>5d} {a.symbol + str(i + 1):<4s} LIG A   1    "
                    f"{x:>8.3f}{y:>8.3f}{z:>8.3f}  1.00  0.00          {a.symbol:>2s}\n")
        f.write("END\n")


def _atoms(mol):
    return [(a.atomic_num, a.charge, a.is_aromatic, a.num_implicit_hs) for a in mol.atoms]


def assert_same_molecule(jm, tm, tmp_path, seed=0):
    """Every perception and feature of the two packages' molecules equal."""
    assert _atoms(tm) == _atoms(jm)
    assert tm.bonds == jm.bonds
    assert tm.name == jm.name and tm.props == jm.props
    np.testing.assert_array_equal(tm.coords, jm.coords)
    if not np.abs(jm.coords).any():
        # topology-only input: give both the same coordinates for the norms
        xyz = np.random.default_rng(seed).normal(size=(jm.num_atoms, 3)) * 2.0
        jm.coords, tm.coords = xyz.copy(), xyz.copy()
    assert tm.sssr == jm.sssr
    n = jm.num_atoms
    assert [tm.hybridization(i) for i in range(n)] == [jm.hybridization(i) for i in range(n)]
    assert [tm.implicit_h_count(i) for i in range(n)] == [jm.implicit_h_count(i) for i in range(n)]
    assert [tm.total_h_count(i) for i in range(n)] == [jm.total_h_count(i) for i in range(n)]
    np.testing.assert_array_equal(tfeatures.featurize_atoms(tm), jfeatures.featurize_atoms(jm))
    for follow in (False, True):
        tf = trules.ligand_phore_features(tm, follow_ancphore=follow)
        jf = jrules.ligand_phore_features(jm, follow_ancphore=follow)
        for a, b in zip(tf[:4], jf[:4]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert tf[4] == jf[4]
    np.testing.assert_array_equal(trules.scoring_phore_fp(tm), jrules.scoring_phore_fp(jm))
    np.testing.assert_array_equal(tlipo.label_lipo_atoms(tm), jlipo.label_lipo_atoms(jm))
    np.testing.assert_array_equal(tlipo.hy_check_ancphore(tm), jlipo.hy_check_ancphore(jm))
    (te, tmask), (je, jmask) = ttopology.rotatable_bonds(tm), jtopology.rotatable_bonds(jm)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tmask, jmask)
    assert ttopology.torsion_dihedral_atoms(tm) == jtopology.torsion_dihedral_atoms(jm)
    # the writers: one record, and several coordinate sets with properties
    rng = np.random.default_rng(seed + 1)
    poses = [jm.coords + rng.normal(size=jm.coords.shape) for _ in range(3)]
    props = {"fitscore": ["0.5", "0.25", "-0.125"], "confidence": ["3", "2", "1"]}
    for pkg, mol, tag in ((tsdf, tm, "t"), (jsdf, jm, "j")):
        pkg.write_sdf(mol, str(tmp_path / f"{tag}_one.sdf"))
        pkg.write_sdf(mol, str(tmp_path / f"{tag}_many.sdf"), multi_coords=poses, name="cx",
                      marker="rank", properties=props)
    for what in ("one", "many"):
        assert (tmp_path / f"t_{what}.sdf").read_bytes() == (tmp_path / f"j_{what}.sdf").read_bytes()


@pytest.mark.parametrize("smiles", SMILES_PANEL)
def test_smiles_molecules_match(smiles, tmp_path):
    jm, tm = jsmiles.mol_from_smiles(smiles), tsmiles.mol_from_smiles(smiles)
    assert_same_molecule(jm, tm, tmp_path, seed=len(smiles))


def test_bad_smiles_raise_alike():
    for bad in ("C1CC(=O", "C1CC", "CC)C", "[Xx]C", "C$C"):
        with pytest.raises(ValueError) as je:
            jsmiles.mol_from_smiles(bad)
        with pytest.raises(ValueError) as te:
            tsmiles.mol_from_smiles(bad)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", ["EX01", "EX02", "EX03"])
@pytest.mark.parametrize("remove_hs", [True, False])
def test_sdf_molecules_match(name, remove_hs, tmp_path):
    path = os.path.join(EXAMPLES, f"{name}.sdf")
    jm = jsdf.read_molecule(path, remove_hs=remove_hs)
    tm = tsdf.read_molecule(path, remove_hs=remove_hs)
    assert_same_molecule(jm, tm, tmp_path)


@pytest.mark.parametrize("fmt", ["mol2", "pdb"])
@pytest.mark.parametrize("name", ["EX01", "EX02"])
def test_mol2_and_pdb_molecules_match(fmt, name, tmp_path):
    src = jsdf.parse_sdf(os.path.join(EXAMPLES, f"{name}.sdf"))[0]
    path = str(tmp_path / f"{name}.{fmt}")
    (write_mol2 if fmt == "mol2" else write_pdb)(src, path)
    for remove_hs in (False, True):
        jm = jsdf.read_molecule(path, remove_hs=remove_hs)
        tm = tsdf.read_molecule(path, remove_hs=remove_hs)
        assert jm is not None and jm.num_atoms == src.num_atoms - (
            sum(a.atomic_num == 1 for a in src.atoms) if remove_hs else 0)
        assert_same_molecule(jm, tm, tmp_path)


def test_sdf_round_trip_through_the_port(tmp_path):
    """The port reads back what it writes: atoms, bonds and coordinates to
    the file's 4 decimals, SD properties per record."""
    mol = tsdf.read_molecule(os.path.join(EXAMPLES, "EX03.sdf"), remove_hs=True)
    poses = [mol.coords + k for k in range(3)]
    path = str(tmp_path / "poses.sdf")
    tsdf.write_sdf(mol, path, multi_coords=poses, name="EX03", marker="rank",
                   properties={"fitscore": ["0.9", "0.8", "0.7"]})
    back = tsdf.parse_sdf(path)
    assert [m.name for m in back] == [f"EX03_rank_{k}" for k in range(3)]
    assert [m.props["fitscore"] for m in back] == ["0.9", "0.8", "0.7"]
    for k, m in enumerate(back):
        assert [a.atomic_num for a in m.atoms] == [a.atomic_num for a in mol.atoms]
        assert m.bonds == mol.bonds
        np.testing.assert_allclose(m.coords, poses[k], atol=5e-5)


@pytest.mark.parametrize("smiles", EMBED_PANEL)
def test_embedding_matches(smiles):
    jm, tm = jsmiles.mol_from_smiles(smiles), tsmiles.mol_from_smiles(smiles)
    for seed in (0, 3):
        want = jembed.embed_molecule(jm, seed=seed)
        got = tembed.embed_molecule(tm, seed=seed)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
