"""A compact SMILES parser (no external chem toolkit).

Supports the organic subset + brackets (charge, explicit H count, isotope
ignored), branches, ring closures (incl. %nn), aromatic lower-case atoms and
bond symbols - = # : (stereo markers / @ are accepted and ignored).  Implicit
hydrogens follow standard valence rules via Molecule.implicit_h_count.

The reference gets this from RDKit MolFromSmiles (pdbbind_phore.py:772-793);
3D coordinates are produced separately by chem.embed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .mol import AROMATIC_BOND, Atom, Molecule, SYMBOL_TO_Z

_ORGANIC_2 = ("Cl", "Br")
_ORGANIC_1 = set("BCNOPSFI")
_AROMATIC_ORGANIC = set("bcnops")
_BOND_CHARS = {"-": 1, "=": 2, "#": 3, ":": AROMATIC_BOND, "/": 1, "\\": 1}


class SmilesError(ValueError):
    pass


def _parse_bracket(tok: str) -> Tuple[int, int, Optional[int], bool]:
    """Parse the inside of [...] -> (atomic_num, charge, n_h, aromatic)."""
    i = 0
    while i < len(tok) and tok[i].isdigit():  # isotope, ignored
        i += 1
    aromatic = False
    if i + 1 < len(tok) and tok[i : i + 2] in SYMBOL_TO_Z and tok[i].isupper():
        sym = tok[i : i + 2]
        i += 2
    elif tok[i].isupper():
        sym = tok[i]
        i += 1
    elif tok[i] in "bcnopsase"[:]:  # aromatic element, incl. 'se', 'as'
        if tok[i : i + 2] in ("se", "as"):
            sym = tok[i : i + 2].capitalize()
            i += 2
        else:
            sym = tok[i].upper()
            i += 1
        aromatic = True
    else:
        raise SmilesError(f"Bad bracket atom [{tok}]")
    if sym not in SYMBOL_TO_Z:
        raise SmilesError(f"Unknown element {sym!r}")
    n_h = 0
    charge = 0
    while i < len(tok):
        c = tok[i]
        if c == "@":
            i += 1  # chirality ignored
        elif c == "H":
            i += 1
            num = ""
            while i < len(tok) and tok[i].isdigit():
                num += tok[i]
                i += 1
            n_h = int(num) if num else 1
        elif c in "+-":
            sign = 1 if c == "+" else -1
            i += 1
            num = ""
            while i < len(tok) and tok[i].isdigit():
                num += tok[i]
                i += 1
            if num:
                charge += sign * int(num)
            else:
                charge += sign
                while i < len(tok) and tok[i] == c:  # ++ / --
                    charge += sign
                    i += 1
        else:
            raise SmilesError(f"Unsupported bracket token {c!r} in [{tok}]")
    return SYMBOL_TO_Z[sym], charge, n_h, aromatic


def mol_from_smiles(smiles: str, name: str = "") -> Molecule:
    atoms: List[Atom] = []
    bonds: List[Tuple[int, int, int]] = []
    stack: List[int] = []
    ring_open: Dict[str, Tuple[int, Optional[int]]] = {}
    prev: Optional[int] = None
    pending_bond: Optional[int] = None

    def add_atom(atom: Atom) -> None:
        nonlocal prev, pending_bond
        idx = len(atoms)
        atoms.append(atom)
        if prev is not None:
            order = pending_bond
            if order is None:
                order = (
                    AROMATIC_BOND
                    if atoms[prev].is_aromatic and atom.is_aromatic
                    else 1
                )
            bonds.append((prev, idx, order))
        prev = idx
        pending_bond = None

    i = 0
    n = len(smiles)
    while i < n:
        c = smiles[i]
        if c == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesError("Unclosed bracket")
            z, charge, n_h, aromatic = _parse_bracket(smiles[i + 1 : j])
            add_atom(Atom(z, charge, aromatic, num_implicit_hs=n_h))
            i = j + 1
        elif smiles[i : i + 2] in _ORGANIC_2:
            add_atom(Atom(SYMBOL_TO_Z[smiles[i : i + 2]], num_implicit_hs=None))
            i += 2
        elif c in _ORGANIC_1:
            add_atom(Atom(SYMBOL_TO_Z[c], num_implicit_hs=None))
            i += 1
        elif c in _AROMATIC_ORGANIC:
            add_atom(Atom(SYMBOL_TO_Z[c.upper()], is_aromatic=True, num_implicit_hs=None))
            i += 1
        elif c in _BOND_CHARS:
            pending_bond = _BOND_CHARS[c]
            i += 1
        elif c == "(":
            if prev is None:
                raise SmilesError("Branch with no root atom")
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError("Unbalanced parenthesis")
            prev = stack.pop()
            i += 1
        elif c.isdigit() or c == "%":
            if c == "%":
                label = smiles[i + 1 : i + 3]
                i += 3
            else:
                label = c
                i += 1
            if prev is None:
                raise SmilesError("Ring closure with no atom")
            if label in ring_open:
                other, order = ring_open.pop(label)
                o = pending_bond if pending_bond is not None else order
                if o is None:
                    o = (
                        AROMATIC_BOND
                        if atoms[prev].is_aromatic and atoms[other].is_aromatic
                        else 1
                    )
                bonds.append((other, prev, o))
                pending_bond = None
            else:
                ring_open[label] = (prev, pending_bond)
                pending_bond = None
        elif c == ".":
            prev = None
            pending_bond = None
            i += 1
        else:
            raise SmilesError(f"Unsupported SMILES character {c!r} at {i}")
    if ring_open:
        raise SmilesError(f"Unclosed ring bonds: {sorted(ring_open)}")
    mol = Molecule(atoms, bonds, None, name or smiles)

    # For organic-subset aromatic atoms the implicit-H rule must count the
    # aromatic system correctly; Molecule.implicit_h_count handles it via
    # ceil(bond order sum).  Freeze the computed counts so later explicit-H
    # manipulation doesn't shift them.
    for idx, a in enumerate(mol.atoms):
        if a.num_implicit_hs is None:
            a.num_implicit_hs = mol.implicit_h_count_from_valence(idx)
    return mol
