"""The port's Trioformer modules (``diffphore_torch.models.trioformer``)
against the JAX package's on the same inputs, drawn from a seed with numpy,
with flax-initialised weights carried across by ``convert_variables``:
each module at a small width with padded rows (f32, within 1e-5 of the
output's scale), and the flax LayerNorm parameters in both directions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.models import trioformer as tt
from diffphore_torch.utils.checkpoints import convert_variables, variables_from_tensors
from diffphore_tpu.models import trioformer as jt

from torch_port_helpers import assert_close, cached_files, load_pair

torch.set_num_threads(2)
RTOL = 1e-5
D = 8           # node and pair width (ns)
B, A, P = 2, 7, 5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    lig_mask = np.ones((B, A), bool)
    lig_mask[1, 5:] = False                  # padded rows
    phore_mask = np.ones((B, P), bool)
    phore_mask[0, 4:] = False
    return dict(h_l=f(B, A, D), h_p=f(B, P, D), z=f(B, A, P, D), lig_pos=3 * f(B, A, 3),
                phore_pos=3 * f(B, P, 3), lig_mask=lig_mask, phore_mask=phore_mask)


def _port(jmodule, variables, tmodule):
    tmodule.load_state_dict(convert_variables(jax.tree_util.tree_map(np.asarray,
                                                                     dict(variables)), tmodule),
                            strict=True)
    return tmodule.eval()


def _both(jmodule, tmodule, args, seed=0):
    """(JAX output, port output) of a module at flax-init weights."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    variables = jax.jit(jmodule.init)(jax.random.PRNGKey(seed), *jargs)
    ref = jax.jit(jmodule.apply)(variables, *jargs)
    with torch.no_grad():
        got = _port(jmodule, variables, tmodule)(*(None if a is None else torch.from_numpy(
            np.asarray(a)) for a in args))
    return ref, got


def _check(ref, got, what):
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    for i, (r, g) in enumerate(zip(refs, gots)):
        assert_close(g, r, RTOL, f"{what}[{i}]")


@pytest.mark.parametrize("masked", [False, True])
def test_mha_with_pair_bias(masked):
    x = _inputs()
    mask = (x["lig_mask"][:, :, None] & x["phore_mask"][:, None, :]) if masked else None
    args = [x["h_l"], x["h_p"], x["h_p"], mask, x["z"]]
    ref, got = _both(jt.MHAWithPairBias(D, 6, 3), tt.MHAWithPairBias(D, 6, 3), args)
    _check(ref, got, "mha")


def test_outer_product_module():
    x = _inputs(1)
    ref, got = _both(jt.OuterProductModule(4, 6), tt.OuterProductModule(D, 4, 6),
                     [x["h_l"], x["h_p"]])
    _check(ref, got, "opm")


def test_geometry_constraint_update():
    x = _inputs(2)
    d = np.linalg.norm(x["phore_pos"][:, :, None] - x["phore_pos"][:, None], axis=-1)[..., None]
    mask = x["lig_mask"][:, :, None] & x["phore_mask"][:, None, :]
    ref, got = _both(jt.GeometryConstraintUpdate(D, 5, 4),
                     tt.GeometryConstraintUpdate(D, 5, 4), [x["z"], d, mask])
    _check(ref, got, "gapu")


def test_trioformer_block_with_padded_rows():
    x = _inputs(3)
    d_ik = np.asarray(tt.masked_distances(torch.from_numpy(x["lig_pos"]),
                                          torch.from_numpy(x["lig_mask"])))
    d_jk = np.asarray(tt.masked_distances(torch.from_numpy(x["phore_pos"]),
                                          torch.from_numpy(x["phore_mask"])))
    args = [x["h_l"], x["h_p"], x["z"], d_ik, d_jk, x["lig_mask"], x["phore_mask"]]
    ref, got = _both(jt.Trioformer(D, 2 * D, 4, True, D // 2, 8),
                     tt.Trioformer(D, 2 * D, 4, True, D // 2, 8), args)
    _check(ref, got, "trioformer")


@pytest.mark.parametrize("layers", [1, 2])
def test_geometric_attention(layers):
    x = _inputs(4)
    args = [x["h_l"], x["h_p"], x["lig_pos"], x["phore_pos"], x["lig_mask"], x["phore_mask"]]
    ref, got = _both(jt.GeometricAttention(D, layers), tt.GeometricAttention(D, layers), args)
    _check(ref, got, "geometric attention")


@pytest.mark.parametrize("blocks", [1, 2])
def test_tank_phore_and_e3phore_on_a_cached_complex(blocks):
    jb, tb = load_pair(cached_files(n=1)[0], rows=2)
    jmodel = jt.TankPhore(8, blocks)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(5), jb)
    ref = jax.jit(jmodel.apply)(variables, jb)
    model = _port(jmodel, variables, tt.TankPhore(8, blocks))
    with torch.no_grad():
        got = model(tb)
        trunk = model.trunk(tb)
    _check(ref, got, "tank")
    jtrunk = jax.jit(lambda v, b: jt.E3Phore(8, blocks).apply({"params": v}, b))(
        variables["params"]["trunk"], jb)
    _check(jtrunk, trunk, "e3phore")


def test_layer_norm_parameters_map_both_ways():
    x = _inputs(5)
    jmodule = jt.GeometricAttention(D, 1)
    args = [jnp.asarray(x[k]) for k in ("h_l", "h_p", "lig_pos", "phore_pos", "lig_mask",
                                        "phore_mask")]
    variables = jax.jit(jmodule.init)(jax.random.PRNGKey(0), *args)
    # non-trivial LayerNorm parameters, so a wrong mapping shows
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda v: np.asarray(v) + rng.normal(size=v.shape).astype(
        np.float32) * 0.1, variables["params"])
    model = _port(jmodule, {"params": params}, tt.GeometricAttention(D, 1))
    norms = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert norms and all(m.eps == tt.LN_EPS for m in norms)
    back = variables_from_tensors(model, dict(model.named_parameters()))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    ref = jax.jit(jmodule.apply)({"params": params}, *args)
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.array(a)) for a in args))
    _check(ref, got, "geometric attention, perturbed norms")
