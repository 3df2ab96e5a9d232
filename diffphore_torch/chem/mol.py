"""Molecular graph model with the perception the featurizer needs.

The port's copy of ``diffphore_tpu.chem.mol``: element/charge/H-count
bookkeeping, SSSR ring info, aromaticity flags, hybridization estimates and
hydrogen removal, with coordinates as an (N, 3) float array.  Rings come
from :mod:`.graph`, which gives networkx's minimum cycle basis in
networkx's order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import graph

# fmt: off
PERIODIC_TABLE = [
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg", "Al",
    "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe",
    "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr",
    "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm",
    "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W",
    "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn",
    "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf",
    "Es", "Fm", "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]
# fmt: on
SYMBOL_TO_Z: Dict[str, int] = {s: i + 1 for i, s in enumerate(PERIODIC_TABLE)}

# Default valences for implicit-H completion (organic subset).
_DEFAULT_VALENCE = {5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 15: 3, 16: 2, 17: 1, 35: 1, 53: 1}
# Alternate allowed valences (hypervalent S/P) considered before adding Hs.
_EXTRA_VALENCES = {15: (5,), 16: (4, 6)}

AROMATIC_BOND = 4  # internal marker for an aromatic bond order


@dataclasses.dataclass
class Atom:
    atomic_num: int
    charge: int = 0
    is_aromatic: bool = False
    # Implicit H count; None = derive from valence rules (SMILES inputs).
    # File-based molecules carry explicit H atoms and use 0.
    num_implicit_hs: Optional[int] = 0

    @property
    def symbol(self) -> str:
        return PERIODIC_TABLE[self.atomic_num - 1]


class Molecule:
    """A molecular graph + conformer.

    Bonds are (i, j, order) with order in {1, 2, 3, AROMATIC_BOND}.  Ring and
    aromaticity perception are computed lazily and cached; any structural
    mutation must go through the provided methods so caches invalidate.
    """

    def __init__(
        self,
        atoms: List[Atom],
        bonds: List[Tuple[int, int, int]],
        coords: Optional[np.ndarray] = None,
        name: str = "",
        props: Optional[Dict[str, str]] = None,
    ):
        self.atoms = atoms
        self.bonds = [(min(i, j), max(i, j), o) for i, j, o in bonds]
        self.coords = (
            np.asarray(coords, dtype=np.float64)
            if coords is not None
            else np.zeros((len(atoms), 3))
        )
        self.name = name
        self.props: Dict[str, str] = props or {}
        self._cache: Dict[str, object] = {}

    # ---------------------------------------------------------------- basics
    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    def invalidate(self) -> None:
        self._cache.clear()

    @property
    def neighbors(self) -> List[List[int]]:
        if "neighbors" not in self._cache:
            nb: List[List[int]] = [[] for _ in self.atoms]
            for i, j, _ in self.bonds:
                nb[i].append(j)
                nb[j].append(i)
            self._cache["neighbors"] = nb
        return self._cache["neighbors"]  # type: ignore[return-value]

    @property
    def bond_lookup(self) -> Dict[Tuple[int, int], int]:
        """(i, j) -> bond order, both orientations."""
        if "bond_lookup" not in self._cache:
            lut = {}
            for i, j, o in self.bonds:
                lut[(i, j)] = o
                lut[(j, i)] = o
            self._cache["bond_lookup"] = lut
        return self._cache["bond_lookup"]  # type: ignore[return-value]

    def bond_order_sum(self, i: int) -> float:
        """Sum of bond orders at atom i (aromatic counts 1.5)."""
        s = 0.0
        for j in self.neighbors[i]:
            o = self.bond_lookup[(i, j)]
            s += 1.5 if o == AROMATIC_BOND else o
        return s

    # ------------------------------------------------------------- hydrogens
    def explicit_h_count(self, i: int) -> int:
        return sum(1 for j in self.neighbors[i] if self.atoms[j].atomic_num == 1)

    def implicit_h_count(self, i: int) -> int:
        a = self.atoms[i]
        if a.num_implicit_hs is not None:
            return a.num_implicit_hs
        return self.implicit_h_count_from_valence(i)

    def implicit_h_count_from_valence(self, i: int) -> int:
        """Valence-rule implicit H count (used for SMILES inputs)."""
        a = self.atoms[i]
        z = a.atomic_num
        if z not in _DEFAULT_VALENCE:
            return 0
        order = self.bond_order_sum(i)
        # Aromatic ring atom written with 2 aromatic bonds: round 3.0 up only
        # if a double bond is genuinely available (carbon), handled by ceil.
        order = int(np.ceil(order - 1e-9))
        dv = _DEFAULT_VALENCE[z]
        # charge adjustment: cations of N-group gain a slot, anions lose one
        if z in (7, 15):
            dv += a.charge
        elif z in (8, 16):
            dv += a.charge
        elif z == 6:
            dv -= abs(a.charge)
        elif z == 5:
            dv += -a.charge
        for v in (dv,) + tuple(_EXTRA_VALENCES.get(z, ())):
            if order <= v:
                return v - order
        return 0

    def total_h_count(self, i: int) -> int:
        return self.explicit_h_count(i) + self.implicit_h_count(i)

    def heavy_degree(self, i: int) -> int:
        return sum(1 for j in self.neighbors[i] if self.atoms[j].atomic_num != 1)

    def total_degree(self, i: int) -> int:
        """Explicit neighbors + implicit Hs (RDKit GetTotalDegree semantics)."""
        return len(self.neighbors[i]) + self.implicit_h_count(i)

    # ----------------------------------------------------------------- rings
    @property
    def sssr(self) -> List[List[int]]:
        """Smallest set of smallest rings (minimum cycle basis)."""
        if "sssr" not in self._cache:
            adj = graph.from_bonds(self.num_atoms, self.bonds)
            rings = graph.minimum_cycle_basis(adj)
            # minimum_cycle_basis returns node sets; rebuild ring order
            ordered = []
            for ring in rings:
                ring_set = set(ring)
                # walk the cycle
                start = next(iter(ring_set))
                path = [start]
                prev = None
                while len(path) < len(ring_set):
                    nxts = [n for n in graph.view_neighbors(adj, path[-1], ring_set)
                            if n != prev and n in ring_set]
                    nxts = [n for n in nxts if n not in path]
                    if not nxts:
                        break
                    prev = path[-1]
                    path.append(nxts[0])
                ordered.append(path)
            self._cache["sssr"] = ordered
        return self._cache["sssr"]  # type: ignore[return-value]

    def num_atom_rings(self, i: int) -> int:
        return sum(1 for ring in self.sssr if i in ring)

    def is_atom_in_ring_of_size(self, i: int, size: int) -> bool:
        return any(len(ring) == size and i in ring for ring in self.sssr)

    def in_ring(self, i: int) -> bool:
        return self.num_atom_rings(i) > 0

    def bond_in_ring(self, i: int, j: int) -> bool:
        return any(
            i in ring and j in ring
            and (abs(ring.index(i) - ring.index(j)) in (1, len(ring) - 1))
            for ring in self.sssr
        )

    # --------------------------------------------------------- hybridization
    def hybridization(self, i: int) -> str:
        """SP / SP2 / SP3 estimate (sufficient for the 6-way categorical)."""
        a = self.atoms[i]
        if a.atomic_num == 1:
            return "misc"
        if a.is_aromatic:
            return "SP2"
        n_triple = sum(1 for j in self.neighbors[i] if self.bond_lookup[(i, j)] == 3)
        n_double = sum(1 for j in self.neighbors[i] if self.bond_lookup[(i, j)] == 2)
        if n_triple or n_double >= 2:
            return "SP"
        if n_double == 1:
            return "SP2"
        return "SP3"

    # ------------------------------------------------------------- mutation
    def remove_hs(self) -> "Molecule":
        """New molecule without explicit hydrogens; implicit counts absorb them."""
        keep = [i for i, a in enumerate(self.atoms) if a.atomic_num != 1]
        remap = {old: new for new, old in enumerate(keep)}
        atoms = []
        for old in keep:
            a = self.atoms[old]
            extra_h = self.explicit_h_count(old)
            base = a.num_implicit_hs if a.num_implicit_hs is not None else self.implicit_h_count(old)
            atoms.append(
                Atom(a.atomic_num, a.charge, a.is_aromatic, num_implicit_hs=base + extra_h)
            )
        bonds = [
            (remap[i], remap[j], o)
            for i, j, o in self.bonds
            if i in remap and j in remap
        ]
        return Molecule(atoms, bonds, self.coords[keep], self.name, dict(self.props))

    def copy(self) -> "Molecule":
        return Molecule(
            [dataclasses.replace(a) for a in self.atoms],
            list(self.bonds),
            self.coords.copy(),
            self.name,
            dict(self.props),
        )

    def __repr__(self) -> str:
        return f"Molecule({self.name!r}, atoms={self.num_atoms}, bonds={len(self.bonds)})"
