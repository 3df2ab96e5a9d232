"""Pharmacophore model IO and graph features.

The port's copy of ``diffphore_tpu.data.phore``: the `.phore` file grammar,
feature typing and phore-graph topology of DiffPhore
(process_pharmacophore.py:22-152, 634-789) on plain numpy; the model
consumes the padded tensors that ``data.graphs.build_complex`` makes.

.phore grammar (tab separated, one record per model, $$$$ terminator):
  line 1: model id
  lines:  type alpha weight factor x y z has_norm nx ny nz label anchor_weight
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from ..constants import NUM_PHORETYPE, PHORETYPES


@dataclasses.dataclass(frozen=True)
class PhoreFeature:
    type: str
    alpha: float
    weight: float
    factor: float
    coord: Tuple[float, float, float]
    has_norm: bool
    norm: Tuple[float, float, float]
    label: str = "0"
    anchor_weight: float = 1.0


@dataclasses.dataclass
class Phore:
    id: str
    features: List[PhoreFeature]
    exclusion_volumes: List[PhoreFeature]

    @property
    def all_points(self) -> List[PhoreFeature]:
        return self.features + self.exclusion_volumes

    def coords(self) -> np.ndarray:
        return np.asarray([f.coord for f in self.all_points], dtype=np.float64)


def _parse_line(line: str, cut_type: bool = True) -> Optional[PhoreFeature]:
    if line == "$$$$":
        return None
    parts = line.split("\t")
    if len(parts) != 13:
        raise ValueError(f"Malformed phore line ({len(parts)} fields): {line!r}")
    (ptype, alpha, weight, factor, x, y, z, has_norm, nx, ny, nz, label, anchor) = parts
    return PhoreFeature(
        type=ptype[:2] if cut_type else ptype,
        alpha=float(alpha),
        weight=float(weight),
        factor=float(factor),
        coord=(float(x), float(y), float(z)),
        has_norm=bool(int(has_norm)),
        norm=(float(nx), float(ny), float(nz)),
        label=label,
        anchor_weight=float(anchor),
    )


def parse_phore(
    phore_file: str,
    skip_wrong_lines: bool = True,
    skip_ex: bool = False,
    cut_type: bool = True,
) -> List[Phore]:
    """Parse a (possibly multi-record) .phore file."""
    if not os.path.exists(phore_file):
        raise FileNotFoundError(f"Pharmacophore file not found: `{phore_file}`")
    phores: List[Phore] = []
    pid: Optional[str] = None
    feats: List[PhoreFeature] = []
    exs: List[PhoreFeature] = []
    with open(phore_file) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if pid is None:
                pid = line
                continue
            try:
                feat = _parse_line(line, cut_type)
            except ValueError as e:
                print(f"[E] {e}")
                if not skip_wrong_lines:
                    raise
                continue
            if feat is None:  # $$$$ terminator
                if feats:
                    phores.append(Phore(pid, feats, exs))
                pid, feats, exs = None, [], []
            elif feat.type == "EX":
                if not skip_ex:
                    exs.append(feat)
            else:
                feats.append(feat)
    if pid is not None and feats:  # tolerate missing trailing $$$$
        phores.append(Phore(pid, feats, exs))
    return phores


def write_phore(phore: Phore, path: str, name: Optional[str] = None, overwrite: bool = False) -> str:
    """Serialize a Phore back to the reference file format."""
    name = name if name is not None else phore.id
    filename = os.path.join(path, f"{name}.phore") if os.path.isdir(path) else path
    if os.path.exists(filename) and not overwrite:
        return filename
    def fmt(v):
        return f"{v:.3f}" if isinstance(v, float) else str(v)
    with open(filename, "w") as f:
        f.write(f"{name}\n")
        for feat in phore.all_points:
            row = [
                feat.type, feat.alpha, feat.weight, feat.factor,
                feat.coord[0], feat.coord[1], feat.coord[2],
                int(feat.has_norm), feat.norm[0], feat.norm[1], feat.norm[2],
                feat.label, feat.anchor_weight,
            ]
            f.write("\t".join(fmt(v) for v in row) + "\n")
        f.write("$$$$\n")
    return filename


def type_index(t: str) -> int:
    """A phore type's index in PHORETYPES; an unknown type maps to the last
    (the reference's safe_index)."""
    try:
        return PHORETYPES.index(t)
    except ValueError:
        return NUM_PHORETYPE - 1


@dataclasses.dataclass
class PhoreGraph:
    """Numpy phore graph, pre-padding.

    x columns: [type_idx, is_ex_idx, has_norm_idx, alpha, weight] where the
    boolean vocabularies are ordered [True, False] (reference
    allowable_features_phore, so True -> index 0).
    """

    x: np.ndarray          # (P, 5)
    pos: np.ndarray        # (P, 3)
    norm: np.ndarray       # (P, 3) unit direction or 0
    edge_index: np.ndarray  # (2, E) src, dst
    phoretype: np.ndarray  # (P, 11) one-hot
    num_features: int      # leading non-EX count


def build_phore_graph(
    phore: Phore,
    consider_ex: bool = True,
    neighbor_cutoff: Optional[float] = 5.0,
    ex_connected: bool = True,
) -> PhoreGraph:
    """Topology rules of the reference get_phore_graph
    (process_pharmacophore.py:634-714):

      * non-EX features connect to every other non-EX feature;
      * EX points connect to all points within `neighbor_cutoff` (only other
        EX points when not `ex_connected`);
      * a node that ends up isolated gets an edge to its nearest neighbor.
    """
    points = phore.features + (phore.exclusion_volumes if consider_ex else [])
    n_feat = len(phore.features)
    P = len(points)
    coords = np.asarray([p.coord for p in points], dtype=np.float64)
    norms = np.zeros((P, 3))
    for k, p in enumerate(points):
        if p.has_norm:
            v = np.asarray(p.norm) - np.asarray(p.coord)
            nv = np.linalg.norm(v)
            norms[k] = v / nv if nv > 0 else 0.0
    cutoff = float("inf") if neighbor_cutoff is None else neighbor_cutoff
    diff = coords[:, None, :] - coords[None, :, :]
    dist = np.linalg.norm(diff, axis=-1)
    src, dst = [], []
    for i in range(P):
        if i < n_feat:
            targets = [j for j in range(n_feat) if j != i]
        else:
            targets = [j for j in range(P) if j != i and dist[i, j] < cutoff]
            if not ex_connected:
                targets = [j for j in targets if j >= n_feat]
        if not targets:
            order = np.argsort(dist[i])
            targets = [int(order[1])]  # nearest non-self
        src.extend([i] * len(targets))
        dst.extend(targets)

    x = np.zeros((P, 5))
    phoretype = np.zeros((P, NUM_PHORETYPE))
    for k, p in enumerate(points):
        t = type_index(p.type)
        x[k] = [t, 0 if p.type == "EX" else 1, 0 if p.has_norm else 1, p.alpha, p.weight]
        phoretype[k, t] = 1.0
    return PhoreGraph(
        x=x,
        pos=coords,
        norm=norms,
        edge_index=np.asarray([src, dst], dtype=np.int64),
        phoretype=phoretype,
        num_features=n_feat,
    )
