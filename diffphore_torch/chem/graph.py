"""The graph algorithms the chemistry needs, restated from networkx 3.x so
that they give networkx's results in networkx's order.

A graph is an adjacency dict ``{node: {neighbour: edge data}}`` built as
networkx builds one (:func:`from_bonds`): nodes in insertion order, each
neighbour dict in the order its edges were added.  Order matters to the
callers: ``Molecule.sssr`` walks each ring of :func:`minimum_cycle_basis`
from whichever node its set yields first, and ring order decides which
ring's normal an atom in two aromatic rings gets; the components of
:func:`connected_components` come in discovery order, which breaks ties in
the torsion code.  So each function keeps the containers networkx uses
(dicts, sets built element by element in the same sequence) where their
iteration order reaches the result.

- :func:`connected_components`: breadth-first, nodes in graph order
  (``connected_components``, ``_plain_bfs``).
- :func:`minimum_cycle_basis`: de Pina's search per component
  (``minimum_cycle_basis``, ``_min_cycle_basis``, ``_min_cycle``): chords of
  a Kruskal spanning tree, a shortest odd path through the lifted graph by
  bidirectional Dijkstra, over the node and edge order of networkx's
  induced subgraph view.
- :func:`isomorphisms_iter`: VF2 (``GraphMatcher(G1, G2, node_match,
  edge_match).isomorphisms_iter()``): candidate pairs from the terminal
  sets in the order the search inserted them, each against the G2 node
  first in graph order; the same dicts and sets for the core and terminal
  vectors, so the mappings come in networkx's sequence.
- :func:`spring_layout`: Fruchterman-Reingold in ``dim`` dimensions from
  ``np.random.RandomState(seed).rand(n, dim)``, k = 1/sqrt(n), 50
  iterations, threshold 1e-4, rescaled to [-1, 1] (the dense "force"
  method, which networkx takes below 500 nodes).
"""

from __future__ import annotations

import heapq
import sys
from itertools import count
from typing import Callable, Dict, Hashable, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

Adjacency = Dict[Hashable, Dict[Hashable, dict]]


def add_edge(adj: Adjacency, u, v, **attr) -> None:
    """``Graph.add_edge``: new nodes are appended, an existing edge keeps
    its place in both neighbour dicts."""
    if u not in adj:
        adj[u] = {}
    if v not in adj:
        adj[v] = {}
    data = adj[u].get(v, {})
    data.update(attr)
    adj[u][v] = data
    adj[v][u] = data


def from_bonds(num_nodes: int, edges: Iterable[Sequence[int]]) -> Adjacency:
    """Nodes ``0..num_nodes-1``, then the edges ``(i, j, ...)`` in order."""
    adj: Adjacency = {i: {} for i in range(num_nodes)}
    for e in edges:
        add_edge(adj, e[0], e[1])
    return adj


# ------------------------------------------------------------- subgraph views
def view_nodes(adj: Adjacency, keep: Optional[Set] = None) -> List:
    """Node order of networkx's subgraph view induced by ``keep``: the set's
    own order when it holds fewer than half the graph's nodes, else the
    graph's order."""
    if keep is None:
        return list(adj)
    if 2 * len(keep) < len(adj):
        return [n for n in keep if n in adj]
    return [n for n in adj if n in keep]


def view_neighbors(adj: Adjacency, n, keep: Optional[Set] = None) -> List:
    """Neighbours of ``n`` in the view: the graph's order, filtered."""
    return [m for m in adj[n] if keep is None or m in keep]


def view_edges(adj: Adjacency, keep: Optional[Set] = None) -> List[Tuple]:
    """``G.edges`` of the view: each edge once, from the node seen first."""
    seen = {}
    out = []
    for n in view_nodes(adj, keep):
        for nbr in view_neighbors(adj, n, keep):
            if nbr not in seen:
                out.append((n, nbr))
        seen[n] = 1
    return out


def induced(nodes: Iterable, adj: Adjacency) -> Set:
    """The node set of ``G.subgraph(nodes)``, built element by element."""
    return set(n for n in nodes if n in adj)


# ------------------------------------------------------------------ components
def _plain_bfs(adj: Adjacency, n: int, source) -> Set:
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


def connected_components(adj: Adjacency) -> Iterator[Set]:
    """Node sets of the components, in the order networkx discovers them."""
    seen: Set = set()
    n = len(adj)
    for v in adj:
        if v not in seen:
            c = _plain_bfs(adj, n - len(seen), v)
            seen.update(c)
            yield c


def is_connected(adj: Adjacency) -> bool:
    if not adj:
        raise ValueError("connectivity is undefined for the null graph")
    return len(next(connected_components(adj))) == len(adj)


def without_edge(adj: Adjacency, u, v) -> Adjacency:
    """A copy of the graph with the edge ``(u, v)`` removed."""
    out = {n: dict(nbrs) for n, nbrs in adj.items()}
    del out[u][v]
    del out[v][u]
    return out


# --------------------------------------------------------- minimum cycle basis
def minimum_cycle_basis(adj: Adjacency) -> List[List]:
    """``nx.minimum_cycle_basis(G)``: one node list per cycle (nodes not in
    walk order), components in discovery order."""
    return sum((_min_cycle_basis(adj, induced(c, adj)) for c in connected_components(adj)),
               [])


def _spanning_tree_edges(edges: List[Tuple]) -> List[Tuple]:
    """Kruskal with unit weights: the edges, in order, that join two trees."""
    parent: Dict = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    tree = []
    for u, v in edges:
        ru, rv = find(u), find(v)
        if ru != rv:
            tree.append((u, v))
            parent[ru] = rv
    return tree


def _min_cycle_basis(adj: Adjacency, keep: Set) -> List[List]:
    cb = []
    edges = view_edges(adj, keep)
    tree_edges = _spanning_tree_edges(edges)
    # G.edges - tree_edges - {...}: set ops as EdgeView performs them
    tree_set = set(tree_edges)
    chords = set(e for e in edges if e not in tree_set) - {(v, u) for u, v in tree_edges}

    set_orth = [{edge} for edge in chords]
    while set_orth:
        base = set_orth.pop()
        cycle_edges = _min_cycle(adj, keep, edges, base)
        cb.append([v for u, v in cycle_edges])
        set_orth = [
            (
                {e for e in orth if e not in base if e[::-1] not in base}
                | {e for e in base if e not in orth if e[::-1] not in orth}
            )
            if sum((e in orth or e[::-1] in orth) for e in cycle_edges) % 2
            else orth
            for orth in set_orth
        ]
    return cb


def _bfs_length(adj: Adjacency, source, target) -> int:
    dist = {source: 0}
    frontier = [source]
    while frontier:
        nxt = []
        for v in frontier:
            for w in adj[v]:
                if w not in dist:
                    dist[w] = dist[v] + 1
                    if w == target:
                        return dist[w]
                    nxt.append(w)
        frontier = nxt
    raise ValueError(f"no path between {source} and {target}")


def _bidirectional_path(adj: Adjacency, source, target) -> List:
    """``nx.bidirectional_dijkstra`` with unit weights: the path it returns."""
    if source == target:
        return [source]
    dists: List[Dict] = [{}, {}]
    preds: List[Dict] = [{source: None}, {target: None}]

    def path(curr, direction):
        ret = []
        while curr is not None:
            ret.append(curr)
            curr = preds[direction][curr]
        return list(reversed(ret)) if direction == 0 else ret

    fringe: List[List] = [[], []]
    seen: List[Dict] = [{source: 0}, {target: 0}]
    c = count()
    heapq.heappush(fringe[0], (0, next(c), source))
    heapq.heappush(fringe[1], (0, next(c), target))
    finaldist = None
    meetnode = None
    direction = 1
    while fringe[0] and fringe[1]:
        direction = 1 - direction
        dist, _, v = heapq.heappop(fringe[direction])
        if v in dists[direction]:
            continue
        dists[direction][v] = dist
        if v in dists[1 - direction]:
            return path(meetnode, 0) + path(preds[1][meetnode], 1)
        for w in adj[v]:
            vw_length = dist + 1
            if w in dists[direction]:
                continue
            if w not in seen[direction] or vw_length < seen[direction][w]:
                seen[direction][w] = vw_length
                heapq.heappush(fringe[direction], (vw_length, next(c), w))
                preds[direction][w] = v
                if w in seen[1 - direction]:
                    finaldist_w = vw_length + seen[1 - direction][w]
                    if finaldist is None or finaldist > finaldist_w:
                        finaldist, meetnode = finaldist_w, w
    raise ValueError(f"no path between {source} and {target}")


def _min_cycle(adj: Adjacency, keep: Set, edges: List[Tuple], orth: Set) -> List[Tuple]:
    """The shortest cycle with an odd number of edges in ``orth``, as the
    edge list networkx's ``_min_cycle`` returns."""
    gi: Adjacency = {}
    for u, v in edges:
        if (u, v) in orth or (v, u) in orth:
            add_edge(gi, u, (v, 1), Gi_weight=1)
            add_edge(gi, (u, 1), v, Gi_weight=1)
        else:
            add_edge(gi, u, v, Gi_weight=1)
            add_edge(gi, (u, 1), (v, 1), Gi_weight=1)

    lift = {n: _bfs_length(gi, n, (n, 1)) for n in view_nodes(adj, keep)}
    start = min(lift, key=lift.get)
    min_path_i = _bidirectional_path(gi, start, (start, 1))
    min_path = [n if n in keep else n[0] for n in min_path_i]

    edgelist = list(zip(min_path, min_path[1:]))
    edgeset: Set = set()
    for e in edgelist:
        if e in edgeset:
            edgeset.remove(e)
        elif e[::-1] in edgeset:
            edgeset.remove(e[::-1])
        else:
            edgeset.add(e)

    min_edgelist = []
    for e in edgelist:
        if e in edgeset:
            min_edgelist.append(e)
            edgeset.remove(e)
        elif e[::-1] in edgeset:
            min_edgelist.append(e[::-1])
            edgeset.remove(e[::-1])
    return min_edgelist


# ---------------------------------------------------------------- spring layout
def spring_layout(adj: Adjacency, dim: int = 2, seed: int = 0, iterations: int = 50,
                  threshold: float = 1e-4) -> Dict:
    """``nx.spring_layout(G, dim=dim, seed=seed)``: node -> position."""
    nodes = list(adj)
    n = len(nodes)
    center = np.zeros(dim)
    if n == 0:
        return {}
    if n == 1:
        return {nodes[0]: center}
    if n >= 500:
        raise ValueError("spring_layout: graphs of 500 nodes or more take networkx's "
                         "sparse method, which is not restated here")
    index = {node: i for i, node in enumerate(nodes)}
    A = np.full((n, n), fill_value=0.0)
    for u, nbrs in adj.items():
        for v, d in nbrs.items():
            A[index[u], index[v]] = d.get("weight", 1)
    pos = _fruchterman_reingold(A, np.random.RandomState(seed), dim, iterations, threshold)
    pos = _rescale_layout(pos) + center
    return dict(zip(nodes, pos))


def _fruchterman_reingold(A: np.ndarray, rng: np.random.RandomState, dim: int,
                          iterations: int, threshold: float) -> np.ndarray:
    nnodes = A.shape[0]
    pos = np.asarray(rng.rand(nnodes, dim), dtype=A.dtype)
    k = np.sqrt(1.0 / nnodes)
    # initial temperature: a tenth of the domain's extent in its first two axes
    t = max(max(pos.T[0]) - min(pos.T[0]), max(pos.T[1]) - min(pos.T[1])) * 0.1
    dt = t / (iterations + 1)
    for _ in range(iterations):
        delta = pos[:, np.newaxis, :] - pos[np.newaxis, :, :]
        distance = np.linalg.norm(delta, axis=-1)
        np.clip(distance, 0.01, None, out=distance)
        displacement = np.einsum("ijk,ij->ik", delta, (k * k / distance**2 - A * distance / k))
        length = np.linalg.norm(displacement, axis=-1)
        length = np.clip(length, a_min=0.01, a_max=None)
        delta_pos = np.einsum("ij,i->ij", displacement, t / length)
        pos += delta_pos
        t -= dt
        if (np.linalg.norm(delta_pos) / nnodes) < threshold:
            break
    return pos


def _rescale_layout(pos: np.ndarray, scale: float = 1) -> np.ndarray:
    pos -= pos.mean(axis=0)
    lim = np.abs(pos).max()
    if lim > 0:
        pos *= scale / lim
    return pos


# ----------------------------------------------------------------- VF2 search
class _VF2:
    """networkx's ``GraphMatcher`` for simple undirected graphs, test
    "graph" (isomorphism), with its semantic checks.  ``core`` maps a
    node to its partner; ``inout`` maps a node of the mapping or of its
    terminal set to the depth at which it entered, in insertion order."""

    def __init__(self, adj1: Adjacency, adj2: Adjacency, nodes1: Dict, nodes2: Dict,
                 node_match: Optional[Callable], edge_match: Optional[Callable]):
        self.G1, self.G2 = adj1, adj2
        self.nodes1, self.nodes2 = nodes1, nodes2
        self.G2_nodes = set(adj2)
        self.G2_node_order = {n: i for i, n in enumerate(adj2)}
        self.node_match, self.edge_match = node_match, edge_match
        self.core_1: Dict = {}
        self.core_2: Dict = {}
        self.inout_1: Dict = {}
        self.inout_2: Dict = {}

    def candidate_pairs(self) -> Iterator[Tuple]:
        min_key = self.G2_node_order.__getitem__
        T1_inout = [node for node in self.inout_1 if node not in self.core_1]
        T2_inout = [node for node in self.inout_2 if node not in self.core_2]
        if T1_inout and T2_inout:
            node_2 = min(T2_inout, key=min_key)
            for node_1 in T1_inout:
                yield node_1, node_2
        else:
            other_node = min(self.G2_nodes - set(self.core_2), key=min_key)
            for node in self.G1:
                if node not in self.core_1:
                    yield node, other_node

    def syntactic(self, n1, n2) -> bool:
        G1, G2 = self.G1, self.G2
        if (n1 in G1[n1]) != (n2 in G2[n2]):          # R_self
            return False
        for nbr in G1[n1]:                              # R_neighbor
            if nbr in self.core_1 and self.core_1[nbr] not in G2[n2]:
                return False
        for nbr in G2[n2]:
            if nbr in self.core_2 and self.core_2[nbr] not in G1[n1]:
                return False
        num1 = sum(1 for nbr in G1[n1] if nbr in self.inout_1 and nbr not in self.core_1)
        num2 = sum(1 for nbr in G2[n2] if nbr in self.inout_2 and nbr not in self.core_2)
        if num1 != num2:                                # R_terminout
            return False
        num1 = sum(1 for nbr in G1[n1] if nbr not in self.inout_1)
        num2 = sum(1 for nbr in G2[n2] if nbr not in self.inout_2)
        return num1 == num2                             # R_new

    def semantic(self, n1, n2) -> bool:
        if self.node_match is not None and not self.node_match(self.nodes1[n1], self.nodes2[n2]):
            return False
        if self.edge_match is not None:
            nbrs1, nbrs2 = self.G1[n1], self.G2[n2]
            for nbr in nbrs1:
                if nbr == n1:
                    if n2 in nbrs2 and not self.edge_match(nbrs1[n1], nbrs2[n2]):
                        return False
                elif nbr in self.core_1:
                    m = self.core_1[nbr]
                    if m in nbrs2 and not self.edge_match(nbrs1[nbr], nbrs2[m]):
                        return False
        return True

    def push(self, n1, n2) -> int:
        """Add a pair (``GMState.__init__``); the depth to pop."""
        self.core_1[n1] = n2
        self.core_2[n2] = n1
        depth = len(self.core_1)
        if n1 not in self.inout_1:
            self.inout_1[n1] = depth
        if n2 not in self.inout_2:
            self.inout_2[n2] = depth
        for G, core, inout in ((self.G1, self.core_1, self.inout_1),
                               (self.G2, self.core_2, self.inout_2)):
            new_nodes = set()
            for node in core:
                new_nodes.update([nbr for nbr in G[node] if nbr not in core])
            for node in new_nodes:
                if node not in inout:
                    inout[node] = depth
        return depth

    def pop(self, n1, n2, depth: int) -> None:
        """``GMState.restore``."""
        del self.core_1[n1]
        del self.core_2[n2]
        for vector in (self.inout_1, self.inout_2):
            for node in list(vector.keys()):
                if vector[node] == depth:
                    del vector[node]

    def match(self) -> Iterator[Dict]:
        if len(self.core_1) == len(self.G2):
            yield self.core_1.copy()
            return
        for n1, n2 in self.candidate_pairs():
            if self.syntactic(n1, n2) and self.semantic(n1, n2):
                depth = self.push(n1, n2)
                yield from self.match()
                self.pop(n1, n2, depth)


def isomorphisms_iter(adj1: Adjacency, adj2: Adjacency, nodes1: Optional[Dict] = None,
                      nodes2: Optional[Dict] = None, node_match: Optional[Callable] = None,
                      edge_match: Optional[Callable] = None) -> Iterator[Dict]:
    """``GraphMatcher(G1, G2, node_match, edge_match).isomorphisms_iter()``
    for simple undirected graphs: every isomorphism G1 -> G2 as a dict, in
    networkx's sequence.  ``nodes1``/``nodes2`` hold each node's attribute
    dict (``G.nodes[n]``), which ``node_match(d1, d2)`` compares;
    ``edge_match(e1, e2)`` compares the edge data dicts of the adjacency."""
    nodes1 = nodes1 if nodes1 is not None else {n: {} for n in adj1}
    nodes2 = nodes2 if nodes2 is not None else {n: {} for n in adj2}
    limit = sys.getrecursionlimit()
    if limit < 1.5 * len(adj2):
        sys.setrecursionlimit(int(1.5 * len(adj2)))
    return _VF2(adj1, adj2, nodes1, nodes2, node_match, edge_match).match()
