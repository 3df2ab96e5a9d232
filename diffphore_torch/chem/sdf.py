"""SDF / MOL (V2000) reading & writing, plus minimal MOL2 and PDB readers.

Replaces the reference's RDKit-based molecular IO (process_mols.py:924-977
read_molecule, :861-921 SDF writers).  Only the fields the pipeline consumes
are modeled: coordinates, elements, charges, bond orders, SD properties.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .mol import AROMATIC_BOND, SYMBOL_TO_Z, Atom, Molecule
from .perception import perceive_aromaticity

_OLD_CHARGE = {1: 3, 2: 2, 3: 1, 5: -1, 6: -2, 7: -3}  # V2000 charge column code


def parse_mol_block(lines: List[str], name_hint: str = "") -> Molecule:
    """Parse one V2000 connection table (header + counts + atoms + bonds)."""
    name = lines[0].strip() or name_hint
    counts = lines[3]
    n_atoms = int(counts[0:3])
    n_bonds = int(counts[3:6])
    atoms: List[Atom] = []
    coords = np.zeros((n_atoms, 3))
    for i in range(n_atoms):
        ln = lines[4 + i]
        coords[i] = (float(ln[0:10]), float(ln[10:20]), float(ln[20:30]))
        sym = ln[31:34].strip()
        z = SYMBOL_TO_Z.get(sym, SYMBOL_TO_Z.get(sym.capitalize(), 0))
        if z == 0:
            raise ValueError(f"Unknown element symbol {sym!r} in mol block")
        chg_code = int(ln[36:39]) if len(ln) >= 39 and ln[36:39].strip() else 0
        atoms.append(Atom(z, _OLD_CHARGE.get(chg_code, 0)))
    bonds = []
    for b in range(n_bonds):
        ln = lines[4 + n_atoms + b]
        i, j, o = int(ln[0:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])
        if o == 4:
            o = AROMATIC_BOND
        bonds.append((i, j, o))
    # property block (M  CHG overrides old-style charges)
    for ln in lines[4 + n_atoms + n_bonds:]:
        if ln.startswith("M  CHG"):
            fields = ln.split()
            n = int(fields[2])
            for k in range(n):
                idx = int(fields[3 + 2 * k]) - 1
                atoms[idx].charge = int(fields[4 + 2 * k])
        elif ln.startswith("M  END"):
            break
    mol = Molecule(atoms, bonds, coords, name)
    # H-free files (e.g. pose SDFs written after RemoveAllHs) carry no
    # explicit hydrogens; fall back to valence-rule implicit counts so
    # donor/acceptor perception still works.
    if not any(a.atomic_num == 1 for a in atoms):
        for a in atoms:
            a.num_implicit_hs = None
    perceive_aromaticity(mol)
    return mol


def parse_sdf_text(text: str, name_hint: str = "") -> List[Molecule]:
    """Parse possibly-multi-record SDF text, attaching SD properties."""
    mols: List[Molecule] = []
    for record in text.split("$$$$"):
        lines = record.lstrip("\n").split("\n")
        if len(lines) < 4 or "V2000" not in (lines[3] if len(lines) > 3 else ""):
            continue
        try:
            end = next(i for i, ln in enumerate(lines) if ln.startswith("M  END"))
        except StopIteration:
            end = len(lines)
        mol = parse_mol_block(lines, name_hint)
        # SD data items:  > <key> \n value(s) \n blank
        props: Dict[str, str] = {}
        i = end + 1
        while i < len(lines):
            ln = lines[i]
            if ln.startswith(">"):
                key = ln[ln.find("<") + 1 : ln.rfind(">")]
                vals = []
                i += 1
                while i < len(lines) and lines[i].strip() != "":
                    vals.append(lines[i])
                    i += 1
                props[key] = "\n".join(vals)
            i += 1
        mol.props.update(props)
        mols.append(mol)
    return mols


def parse_sdf(path: str) -> List[Molecule]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:  # type: ignore[arg-type]
        return parse_sdf_text(f.read(), name_hint=os.path.basename(path).split(".")[0])


def _mol_block(mol: Molecule, coords: Optional[np.ndarray] = None, name: Optional[str] = None) -> str:
    coords = mol.coords if coords is None else coords
    # the JAX package's program line, so that both packages write the same bytes
    out = [name if name is not None else mol.name, "  diffphore_tpu 3D", ""]
    out.append(
        f"{mol.num_atoms:>3d}{len(mol.bonds):>3d}  0  0  0  0  0  0  0  0999 V2000"
    )
    for i, a in enumerate(mol.atoms):
        x, y, z = coords[i]
        out.append(
            f"{x:>10.4f}{y:>10.4f}{z:>10.4f} {a.symbol:<3s} 0  0  0  0  0  0  0  0  0  0  0  0"
        )
    for i, j, o in mol.bonds:
        order = 4 if o == AROMATIC_BOND else o
        out.append(f"{i + 1:>3d}{j + 1:>3d}{order:>3d}  0  0  0")
    charged = [(i, a.charge) for i, a in enumerate(mol.atoms) if a.charge]
    for k in range(0, len(charged), 8):
        chunk = charged[k : k + 8]
        out.append(
            "M  CHG" + f"{len(chunk):>3d}" + "".join(f"{i + 1:>4d}{c:>4d}" for i, c in chunk)
        )
    out.append("M  END")
    return "\n".join(out)


def write_sdf(
    mol: Molecule,
    path: str,
    multi_coords: Optional[Sequence[np.ndarray]] = None,
    name: Optional[str] = None,
    marker: str = "",
    properties: Optional[Dict[str, Sequence]] = None,
) -> None:
    """Write one molecule, optionally once per coordinate set.

    Mirrors write_mol_with_coords / write_mol_with_multi_coords semantics
    (record naming ``{name}_{marker}_{idx}``, per-record SD properties).
    """
    base = name if name is not None else mol.name
    records = []
    coord_sets = [mol.coords] if multi_coords is None else list(multi_coords)
    for idx, c in enumerate(coord_sets):
        rec_name = base if multi_coords is None else f"{base}_{marker}_{idx}"
        block = _mol_block(mol, np.asarray(c), rec_name)
        if properties:
            for key, vals in properties.items():
                block += f"\n> <{key}>\n{vals[idx]}\n"
        records.append(block + "\n\n$$$$\n")
    with open(path, "w") as f:
        f.write("".join(records))


def parse_mol2(path: str) -> Optional[Molecule]:
    """Minimal TRIPOS MOL2 reader (atoms + bonds + charges)."""
    atoms: List[Atom] = []
    coords: List[List[float]] = []
    bonds: List = []
    section = None
    name = os.path.basename(path).split(".")[0]
    with open(path) as f:
        for ln in f:
            s = ln.strip()
            if s.startswith("@<TRIPOS>"):
                section = s[9:]
                continue
            if not s or s.startswith("#"):
                continue
            if section == "MOLECULE" and not atoms and name == "":
                name = s
            elif section == "ATOM":
                parts = s.split()
                coords.append([float(parts[2]), float(parts[3]), float(parts[4])])
                sym = parts[5].split(".")[0]
                z = SYMBOL_TO_Z.get(sym, SYMBOL_TO_Z.get(sym.capitalize(), 0))
                if z == 0:
                    return None
                chg = int(round(float(parts[8]))) if len(parts) > 8 and parts[1][0].isalpha() is False else 0
                atoms.append(Atom(z, 0))
            elif section == "BOND":
                parts = s.split()
                o = parts[3]
                order = AROMATIC_BOND if o in ("ar", "am") else int(o) if o.isdigit() else 1
                bonds.append((int(parts[1]) - 1, int(parts[2]) - 1, order))
    if not atoms:
        return None
    mol = Molecule(atoms, bonds, np.asarray(coords), name)
    perceive_aromaticity(mol)
    return mol


def parse_pdb(path: str) -> Optional[Molecule]:
    """Minimal PDB HETATM/ATOM reader with distance-based bond perception."""
    atoms: List[Atom] = []
    coords: List[List[float]] = []
    with open(path) as f:
        for ln in f:
            if ln.startswith(("ATOM", "HETATM")):
                sym = ln[76:78].strip() or ln[12:16].strip()[0]
                sym = sym[0].upper() + sym[1:].lower() if len(sym) > 1 else sym.upper()
                z = SYMBOL_TO_Z.get(sym)
                if z is None:
                    continue
                atoms.append(Atom(z))
                coords.append([float(ln[30:38]), float(ln[38:46]), float(ln[46:54])])
    if not atoms:
        return None
    xyz = np.asarray(coords)
    # distance-based bond guess
    bonds = []
    n = len(atoms)
    d = np.linalg.norm(xyz[:, None] - xyz[None, :], axis=-1)
    for i in range(n):
        for j in range(i + 1, n):
            cutoff = 1.9 if 1 not in (atoms[i].atomic_num, atoms[j].atomic_num) else 1.3
            if d[i, j] < cutoff:
                bonds.append((i, j, 1))
    mol = Molecule(atoms, bonds, xyz, os.path.basename(path).split(".")[0])
    perceive_aromaticity(mol)
    return mol


def read_molecule(path: str, remove_hs: bool = False) -> Optional[Molecule]:
    """Dispatch on extension like the reference's read_molecule."""
    try:
        if path.endswith((".sdf", ".sdf.gz", ".mol")):
            mols = parse_sdf(path)
            mol = mols[0] if mols else None
        elif path.endswith(".mol2"):
            mol = parse_mol2(path)
        elif path.endswith((".pdb", ".pdbqt")):
            mol = parse_pdb(path)
        else:
            raise ValueError(f"Unsupported molecule format: {path}")
        if mol is not None and remove_hs:
            mol = mol.remove_hs()
        return mol
    except (OSError, ValueError, IndexError) as e:
        print(f"[E] Failed to read molecule `{path}`: {e}")
        return None
