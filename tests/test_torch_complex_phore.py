"""The port's complex-based phore generation
(``diffphore_torch.chem.complex_phore``) against the JAX package's on the
CPU: a pocket PDB synthesized around an example ligand (complementary
partners at interaction distance, ring, hydrophobic contact, wall atoms
and a water), the same protein atoms, ligand sites and ``.phore`` text,
through the functions and through each package's CLI."""

import os

import numpy as np
import pytest

from diffphore_torch.chem import complex_phore as tcp
from diffphore_torch.chem.sdf import read_molecule as t_read
from diffphore_tpu.chem import complex_phore as jcp
from diffphore_tpu.chem.sdf import read_molecule as j_read

from torch_port_helpers import REPO

LIGANDS = [os.path.join(REPO, "examples", f"EX0{i}.sdf") for i in (1, 2, 3)]


def _pdb_line(serial, name, resname, chain, resseq, xyz, element, record="ATOM  "):
    return (f"{record}{serial:5d} {name:<4s}{resname:>4s} {chain}{resseq:4d}    "
            f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00          "
            f"{element:>2s}")


def write_pocket(mol, path):
    """Partners for the ligand's first site of each kind that it has."""
    sites = jcp._ligand_sites(mol)
    center = mol.coords.mean(0)
    lines, serial, resseq = [], [0], [0]

    def away(pos, dist):
        v = np.asarray(pos) - center
        n = np.linalg.norm(v)
        return np.asarray(pos) + dist * (v / n if n > 1e-6 else np.array([1.0, 0, 0]))

    def add(name, resname, pos, element, record="ATOM  ", res=None):
        serial[0] += 1
        if res is None:
            resseq[0] += 1
        lines.append(_pdb_line(serial[0], name, resname, "A", res or resseq[0], pos, element,
                               record))

    for kind, (name, res, dist, el) in {"HD": ("O", "GLY", 2.9, "O"),
                                        "HA": ("OG", "SER", 2.9, "O"),
                                        "HY": ("CD1", "LEU", 4.0, "C"),
                                        "PO": ("CG", "ASP", 4.0, "C"),
                                        "NE": ("NZ", "LYS", 4.0, "N"),
                                        "XB": ("O", "ALA", 3.2, "O")}.items():
        for pos, _ in sites[kind][:2]:
            add(name, res, away(pos, dist), el)
    if sites["AR"]:
        ar = away(sites["AR"][0][0], 4.0)
        resseq[0] += 1
        for k, nm in enumerate(("CG", "CD1", "CD2", "CE1", "CE2", "CZ")):
            ang = 2 * np.pi * k / 6
            add(nm, "PHE", ar + 1.39 * np.array([np.cos(ang), np.sin(ang), 0.0]), "C",
                res=resseq[0])
    for k in range(6):
        add("CB", "ALA", away(mol.coords[k % mol.num_atoms], 3.6), "C")
    add("ZN", "ZN", away(mol.coords[0], 2.5), "ZN", record="HETATM")
    add("O", "HOH", center + 30.0, "O")
    add("H", "ALA", center + 2.0, "H")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nEND\n")


@pytest.fixture(scope="module", params=LIGANDS, ids=os.path.basename)
def pocket(request, tmp_path_factory):
    mol = j_read(request.param, remove_hs=True)
    path = str(tmp_path_factory.mktemp("pocket") / "pocket.pdb")
    write_pocket(mol, path)
    return path, request.param


def test_protein_atoms_and_sites_match(pocket):
    pdb, lig = pocket
    ja, ta = jcp.read_protein_atoms(pdb), tcp.read_protein_atoms(pdb)
    assert [(a.name, a.resname, a.reskey, a.element, a.hetatm) for a in ja] == [
        (a.name, a.resname, a.reskey, a.element, a.hetatm) for a in ta]
    assert all(np.array_equal(a.coord, b.coord) for a, b in zip(ja, ta))
    js, ts = jcp._ligand_sites(j_read(lig, remove_hs=True)), tcp._ligand_sites(
        t_read(lig, remove_hs=True))
    assert list(js) == list(ts)
    for k in js:
        assert [(p.tolist(), m) for p, m in js[k]] == [(p.tolist(), m) for p, m in ts[k]], k


def test_phore_text_is_identical(pocket, tmp_path):
    pdb, lig = pocket
    jp = jcp.generate_complex_phore(pdb, j_read(lig, remove_hs=True),
                                    out_file=str(tmp_path / "jax.phore"), name="lig_complex")
    tp = tcp.generate_complex_phore(pdb, t_read(lig, remove_hs=True),
                                    out_file=str(tmp_path / "port.phore"), name="lig_complex")
    assert (tmp_path / "port.phore").read_text() == (tmp_path / "jax.phore").read_text()
    assert len(tp.features) == len(jp.features) > 0
    assert len(tp.exclusion_volumes) == len(jp.exclusion_volumes) >= 6


def test_the_clis_write_the_same_file(pocket, tmp_path, capsys):
    pdb, lig = pocket
    for mod, out in ((jcp, "jax.phore"), (tcp, "port.phore")):
        mod.main([pdb, lig, str(tmp_path / out), "--pocket_cutoff", "7.0", "--ex_cutoff", "4.5"])
    assert (tmp_path / "port.phore").read_text() == (tmp_path / "jax.phore").read_text()
    assert "exclusion volumes" in capsys.readouterr().out
