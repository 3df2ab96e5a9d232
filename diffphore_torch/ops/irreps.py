"""Irreducible-representation bookkeeping for the SE(3)-equivariant convs.

Static metadata only (no tensors): irreps of l <= 2 parsed from e3nn-style
strings such as ``"20x0e + 10x1o + 10x1e + 20x0o"``.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import List, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class Irrep:
    """A single irreducible representation: degree l and parity p (+1/-1)."""

    l: int
    p: int

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __repr__(self) -> str:  # e.g. "1o"
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    def __mul__(self, other: "Irrep"):
        """Selection rule: all irreps in the tensor product self (x) other."""
        p = self.p * other.p
        return [Irrep(l, p) for l in range(abs(self.l - other.l), self.l + other.l + 1)]


_IRREP_RE = re.compile(r"^\s*(?:(\d+)\s*x\s*)?(\d+)([eo])\s*$")


@dataclasses.dataclass(frozen=True)
class Irreps:
    """An ordered direct sum of (multiplicity, Irrep) pairs."""

    items: Tuple[Tuple[int, Irrep], ...]

    @staticmethod
    def parse(spec) -> "Irreps":
        if isinstance(spec, Irreps):
            return spec
        items: List[Tuple[int, Irrep]] = []
        for term in str(spec).split("+"):
            m = _IRREP_RE.match(term)
            if not m:
                raise ValueError(f"Bad irreps term {term!r} in {spec!r}")
            mul = int(m.group(1) or 1)
            items.append((mul, Irrep(int(m.group(2)), +1 if m.group(3) == "e" else -1)))
        return Irreps(tuple(items))

    @property
    def dim(self) -> int:
        return sum(mul * ir.dim for mul, ir in self.items)

    @property
    def num_scalars(self) -> int:
        """Multiplicity of 0e scalars."""
        return sum(mul for mul, ir in self.items if ir.l == 0 and ir.p == 1)

    def slices(self) -> List[slice]:
        out, off = [], 0
        for mul, ir in self.items:
            out.append(slice(off, off + mul * ir.dim))
            off += mul * ir.dim
        return out

    def __repr__(self) -> str:
        return " + ".join(f"{mul}x{ir}" for mul, ir in self.items)

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)


@functools.lru_cache(maxsize=None)
def parse(spec: str) -> Irreps:
    return Irreps.parse(spec)
