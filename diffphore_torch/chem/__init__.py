"""Host chemistry: molecular IO (SDF/MOL, MOL2, PDB, SMILES), ring and
aromaticity perception, pharmacophore typing, rotatable bonds and 3D
embedding, in plain numpy and scipy.

The port's copy of ``diffphore_tpu.chem`` (no RDKit, no networkx): the
graph algorithms it took from networkx are restated in :mod:`.graph` with
networkx's output order.
"""
