"""The port's graph helpers (``diffphore_torch.chem.graph``) against
networkx itself: the minimum cycle basis as the same list of cycles in the
same order, connected components in the same discovery order, and the 3D
spring layout to 1e-9, on molecule graphs and on seeded random graphs with
several components and fused cycles."""

import random

import networkx as nx
import numpy as np
import pytest

from diffphore_torch.chem import graph
from diffphore_torch.chem.smiles import mol_from_smiles

from test_torch_chem import SMILES_PANEL


def _nx_graph(n, edges):
    G = nx.Graph()
    G.add_nodes_from(range(n))
    G.add_edges_from(edges)
    return G


def _random_graph(seed):
    """Several components, each a random tree plus extra edges (fused and
    bridged cycles), nodes and edges shuffled."""
    rng = random.Random(seed)
    n = rng.randrange(3, 48)
    nodes = list(range(n))
    rng.shuffle(nodes)
    cuts = sorted(rng.sample(range(1, n), min(rng.randrange(0, 4), n - 1)))
    parts = [nodes[a:b] for a, b in zip([0] + cuts, cuts + [n])]
    edges = []
    for p in parts:
        for i in range(1, len(p)):
            edges.append((p[i], p[rng.randrange(i)]))
        for _ in range(rng.randrange(0, 5)):
            if len(p) > 2:
                a, b = rng.sample(p, 2)
                if (a, b) not in edges and (b, a) not in edges:
                    edges.append((a, b))
    rng.shuffle(edges)
    return n, edges


def _check(n, edges, seed):
    G = _nx_graph(n, edges)
    adj = graph.from_bonds(n, edges)
    assert graph.minimum_cycle_basis(adj) == nx.minimum_cycle_basis(G)
    assert [list(c) for c in graph.connected_components(adj)] == \
        [list(c) for c in nx.connected_components(G)]
    assert graph.is_connected(adj) == nx.is_connected(G)
    want = nx.spring_layout(G, dim=3, seed=seed)
    got = graph.spring_layout(adj, dim=3, seed=seed)
    assert list(got) == list(want)
    np.testing.assert_allclose(np.stack([got[i] for i in range(n)]),
                               np.stack([want[i] for i in range(n)]), rtol=0, atol=1e-9)


@pytest.mark.parametrize("chunk", range(4))
def test_random_graphs_match_networkx(chunk):
    for seed in range(chunk * 50, (chunk + 1) * 50):
        n, edges = _random_graph(seed)
        _check(n, edges, seed)


@pytest.mark.parametrize("smiles", SMILES_PANEL)
def test_molecule_graphs_match_networkx(smiles):
    mol = mol_from_smiles(smiles)
    _check(mol.num_atoms, [(i, j) for i, j, _ in mol.bonds], seed=len(smiles))


def test_subgraph_views_follow_networkx_order():
    """Node and edge order of an induced subgraph, with the node set smaller
    and larger than half the graph (networkx iterates the set in the first
    case and the graph in the second)."""
    n, edges = _random_graph(7)
    G = _nx_graph(n, edges)
    adj = graph.from_bonds(n, edges)
    rng = random.Random(3)
    for size in (2, n // 3, n // 2, n - 1):
        keep = rng.sample(range(n), size)
        sub = G.subgraph(keep)
        kept = graph.induced(keep, adj)
        assert graph.view_nodes(adj, kept) == list(sub)
        assert graph.view_edges(adj, kept) == list(sub.edges)
        for v in kept:
            assert graph.view_neighbors(adj, v, kept) == list(sub.neighbors(v))


def test_cut_bridge_components_match_networkx():
    """The torsion code's question: the components left when one bond is
    cut, in networkx's order, for every bond of a molecule."""
    mol = mol_from_smiles("CC(C)(C)c1ccc(cc1)C(=O)NCCc1ccc2ccccc2c1")
    edges = [(i, j) for i, j, _ in mol.bonds]
    G = _nx_graph(mol.num_atoms, edges)
    adj = graph.from_bonds(mol.num_atoms, edges)
    for i, j in edges:
        G2 = G.copy()
        G2.remove_edge(i, j)
        cut = graph.without_edge(adj, i, j)
        assert graph.is_connected(cut) == nx.is_connected(G2)
        assert [set(c) for c in graph.connected_components(cut)] == \
            [set(c) for c in nx.connected_components(G2)]
