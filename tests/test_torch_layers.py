"""The port's layers against the JAX package's with the same weights: a flax
init (plus random batch-norm running statistics) converted by
``convert_variables``.  Both sides compute the convs in f32; tolerances are
f32 ones relative to the output scale."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.models import layers as tl
from diffphore_torch.utils.checkpoints import convert_variables
from diffphore_tpu.models import layers as jl

from torch_port_helpers import assert_close, randomize_stats

torch.set_num_threads(1)

RTOL = 2e-5
T = lambda x: torch.from_numpy(np.asarray(x).copy())


def _load(module, variables):
    module.load_state_dict(convert_variables(jax.tree_util.tree_map(np.asarray, dict(variables))),
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("irreps_in,irreps_out,n_chan", [
    ("8x0e", "8x0e + 4x1o", 2),
    ("8x0e + 4x1o", "8x0e + 4x1o + 4x1e", 1),
    ("8x0e + 4x1o + 4x1e + 8x0o", "2x1o + 2x1e", 1),
])
def test_dense_tp_conv_matches_jax(irreps_in, irreps_out, n_chan):
    rng = np.random.default_rng(0)
    B, N, M, E = 2, 7, 9, 12
    jin = jl.parse(irreps_in)
    x = rng.normal(size=(B, M, jin.dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, 9)).astype(np.float32)
    attrs = [rng.normal(size=(B, N, M, E)).astype(np.float32) for _ in range(n_chan)]
    masks = [rng.random((B, N, M)) > 0.4 for _ in range(n_chan)]
    jconv = jl.DenseTPConv(in_irreps=irreps_in, out_irreps=irreps_out, n_edge_features=E,
                           hidden_features=16, tp_mode="channelwise", compute_dtype="float32")
    jargs = (jnp.asarray(x), [jnp.asarray(a) for a in attrs], jnp.asarray(sh),
             [jnp.asarray(m) for m in masks])
    variables = randomize_stats(jconv.init(jax.random.PRNGKey(1), *jargs))
    ref = jconv.apply(variables, *jargs)
    tconv = _load(tl.DenseTPConv(irreps_in, irreps_out, n_edge_features=E, hidden_features=16),
                  variables)
    with torch.no_grad():
        got = tconv(T(x), [T(a) for a in attrs], T(sh), [T(m) for m in masks])
    assert_close(got, ref, RTOL, f"{irreps_in} -> {irreps_out}")


def test_equivariant_batch_norm_matches_jax():
    irreps = "6x0e + 3x1o + 2x1e + 4x0o"
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, jl.parse(irreps).dim)).astype(np.float32) * 3
    mask = np.ones((3, 5), bool)
    jbn = jl.EquivariantBatchNorm(irreps)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    variables = randomize_stats(variables, seed=3)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(0, 0.3, p.shape), jnp.float32), variables["params"])
    variables = {**variables, "params": params}
    ref = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    tbn = _load(tl.EquivariantBatchNorm(irreps), variables)
    with torch.no_grad():
        assert_close(tbn(T(x)), ref, RTOL, "batch norm")


def test_small_layers_match_jax():
    rng = np.random.default_rng(4)
    d = rng.uniform(0, 6, size=(4, 5)).astype(np.float32)
    assert_close(tl.GaussianSmearing(0.0, 5.0, 20)(T(d)),
                 jl.GaussianSmearing(0.0, 5.0, 20).apply({}, jnp.asarray(d)), RTOL, "smearing")

    h = rng.normal(size=(4, 6)).astype(np.float32)
    jmlp = jl.MLP(hidden=7, out=3)
    v = jmlp.init(jax.random.PRNGKey(0), jnp.asarray(h))
    with torch.no_grad():
        assert_close(_load(tl.MLP(6, 7, 3), v)(T(h)), jmlp.apply(v, jnp.asarray(h)), RTOL, "mlp")

    cat = rng.integers(0, 3, size=(4, 5, 3)).astype(np.int32)
    sc = rng.normal(size=(4, 5, 2)).astype(np.float32)
    jenc = jl.CategoricalEncoder(emb_dim=6, feature_dims=[3, 4, 5], num_scalars=2)
    v = jenc.init(jax.random.PRNGKey(1), jnp.asarray(cat), jnp.asarray(sc))
    tenc = _load(tl.CategoricalEncoder(6, [3, 4, 5], num_scalars=2), v)
    with torch.no_grad():
        assert_close(tenc(T(cat).long(), T(sc)), jenc.apply(v, jnp.asarray(cat), jnp.asarray(sc)),
                     RTOL, "categorical encoder")
