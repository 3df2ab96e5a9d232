"""The port's VF2 search (``chem.graph.isomorphisms_iter``) and
``chem.rmsd.symmetry_rmsd`` against networkx and the JAX package on the
CPU: the same *sequence* of mappings as ``GraphMatcher.isomorphisms_iter``
on seeded random coloured graphs, on SMILES panels and on a ligand with
more automorphisms than the 256 that ``symmetry_rmsd`` reads, and the same
RMSD with and without alignment."""

import itertools
import os

import networkx as nx
import numpy as np
import pytest
from networkx.algorithms.isomorphism import (GraphMatcher, categorical_edge_match,
                                             categorical_node_match)

from diffphore_torch.chem import graph as tgraph
from diffphore_torch.chem import rmsd as trmsd
from diffphore_torch.chem.sdf import read_molecule as t_read
from diffphore_torch.chem.smiles import mol_from_smiles as t_smiles
from diffphore_torch.data.dataset import records_from_csv
from diffphore_tpu.chem import rmsd as jrmsd
from diffphore_tpu.chem.sdf import read_molecule as j_read
from diffphore_tpu.chem.smiles import mol_from_smiles as j_smiles

from test_torch_chem import SMILES_PANEL
from torch_port_helpers import REPO

NODE, EDGE = categorical_node_match("z", 0), categorical_edge_match("o", 0)
#: three tert-butyls and two CF3 groups on a benzene: 6^5 = 7,776 automorphisms
SYMMETRIC = "CC(C)(C)c1c(C(F)(F)F)c(C(C)(C)C)cc(C(C)(C)C)c1C(F)(F)F"
CORPUS2_PANEL = [r["ligand_description"]
                 for r in records_from_csv(os.path.join(REPO, "runs", "corpus2", "test.csv"))[:8]]
#: mappings compared in full sequence (a symmetric ligand has thousands)
HEAD = 600


def _random_graph(seed):
    """A networkx graph and the port's adjacency with the same insertion
    order: 1-11 nodes of two colours, edges of two orders."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    p = rng.uniform(0.1, 0.7)
    G, adj, nodes = nx.Graph(), {}, {}
    for i in range(n):
        c = int(rng.integers(0, 2))
        G.add_node(i, z=c)
        nodes[i], adj[i] = {"z": c}, {}
    for i, j in itertools.combinations(range(n), 2):
        if rng.random() < p:
            o = int(rng.integers(1, 3))
            a, b = (i, j) if rng.random() < 0.5 else (j, i)
            G.add_edge(a, b, o=o)
            tgraph.add_edge(adj, a, b, o=o)
    return G, adj, nodes


def _sequence(it, n=HEAD):
    return [list(m.items()) for m in itertools.islice(it, n)]


def test_random_coloured_graphs_give_networkx_sequence():
    for seed in range(200):
        G, adj, nodes = _random_graph(seed)
        want = _sequence(GraphMatcher(G, G, node_match=NODE, edge_match=EDGE).isomorphisms_iter())
        got = _sequence(tgraph.isomorphisms_iter(adj, adj, nodes, nodes, NODE, EDGE))
        assert got == want, seed


def test_uncoloured_and_empty_graphs():
    for seed in range(20):
        G, adj, _ = _random_graph(1000 + seed)
        assert _sequence(tgraph.isomorphisms_iter(adj, adj)) == _sequence(
            GraphMatcher(G, G).isomorphisms_iter())
    assert list(tgraph.isomorphisms_iter({}, {})) == list(
        GraphMatcher(nx.Graph(), nx.Graph()).isomorphisms_iter())


@pytest.mark.parametrize("smiles", SMILES_PANEL + CORPUS2_PANEL + [SYMMETRIC])
def test_molecule_automorphisms_in_networkx_sequence(smiles):
    G = jrmsd._graph(j_smiles(smiles))
    adj, nodes = trmsd._graph(t_smiles(smiles))
    want = _sequence(GraphMatcher(G, G, node_match=NODE, edge_match=EDGE).isomorphisms_iter())
    got = _sequence(tgraph.isomorphisms_iter(adj, adj, nodes, nodes, trmsd._node_match,
                                             trmsd._edge_match))
    assert got == want


def test_symmetric_ligand_exceeds_the_cap():
    adj, nodes = trmsd._graph(t_smiles(SYMMETRIC))
    it = tgraph.isomorphisms_iter(adj, adj, nodes, nodes, trmsd._node_match, trmsd._edge_match)
    assert sum(1 for _ in itertools.islice(it, 1000)) == 1000


def _coords(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3)) * 3
    b = a[rng.permutation(n)] + rng.normal(size=(n, 3)) * 0.3
    return a, b


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("smiles", ["CC(C)(C)c1ccccc1", "OC(=O)c1ccccc1C(=O)[O-]", SYMMETRIC]
                         + CORPUS2_PANEL[:2])
def test_symmetry_rmsd_matches(smiles, align):
    jm, tm = j_smiles(smiles), t_smiles(smiles)
    for seed in range(3):
        a, b = _coords(jm.num_atoms, seed)
        want = jrmsd.symmetry_rmsd(jm, a, b, align=align)
        got = trmsd.symmetry_rmsd(tm, a, b, align=align)
        assert abs(got - want) <= 1e-12
        assert got <= trmsd.plain_rmsd(a, b) + 1e-12 or align


@pytest.mark.parametrize("max_mappings", [1, 7, 256])
def test_the_cap_takes_the_same_mappings(max_mappings):
    """On the symmetric ligand the cap decides the value: a pose permuted
    by a late automorphism scores above 0 under a small cap, alike."""
    jm, tm = j_smiles(SYMMETRIC), t_smiles(SYMMETRIC)
    adj, nodes = trmsd._graph(tm)
    maps = list(itertools.islice(tgraph.isomorphisms_iter(
        adj, adj, nodes, nodes, trmsd._node_match, trmsd._edge_match), 400))
    a, _ = _coords(tm.num_atoms, 7)
    late = maps[-1]
    b = a[[late[i] for i in range(tm.num_atoms)]]
    want = jrmsd.symmetry_rmsd(jm, a, b, max_mappings=max_mappings)
    got = trmsd.symmetry_rmsd(tm, a, b, max_mappings=max_mappings)
    assert abs(got - want) <= 1e-12


def test_symmetry_rmsd_on_an_example_file():
    path = os.path.join(REPO, "examples", "EX02.sdf")
    jm, tm = j_read(path, remove_hs=True), t_read(path, remove_hs=True)
    a, b = _coords(tm.num_atoms, 11)
    for align in (False, True):
        assert abs(trmsd.symmetry_rmsd(tm, a, b, align=align)
                   - jrmsd.symmetry_rmsd(jm, a, b, align=align)) <= 1e-12
