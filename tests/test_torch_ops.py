"""The port's static algebra, geometry and tables against the JAX package:
constants, cached-complex loading, irreps and path tables, Wigner-3j,
spherical harmonics, diffusion schedule and embedding, SO(3)/torus score
norms, rotations and Kabsch, torsion updates and modify_conformer.
Inputs are numpy draws from fixed seeds; tolerances are f32 ones."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch import constants as tconst
from diffphore_torch.data import graphs as tgraphs
from diffphore_torch.ops import diffusion as tdiff
from diffphore_torch.ops import geometry as tgeo
from diffphore_torch.ops import irreps as tirreps
from diffphore_torch.ops import sh as tsh
from diffphore_torch.ops import so3 as tso3
from diffphore_torch.ops import tensor_product as ttp
from diffphore_torch.ops import torus as ttorus
from diffphore_torch.ops import wigner as twig
from diffphore_torch.ops.rigid import modify_conformer
from diffphore_torch.ops.torsion import apply_torsion_updates
from diffphore_tpu.ops import diffusion as jdiff
from diffphore_tpu.ops import geometry as jgeo
from diffphore_tpu.ops import irreps as jirreps
from diffphore_tpu.ops import sh as jsh
from diffphore_tpu.ops import so3 as jso3
from diffphore_tpu.ops import tensor_product as jtp
from diffphore_tpu.ops import torus as jtorus
from diffphore_tpu.ops import wigner as jwig
from diffphore_tpu.ops.rigid import PoseState
from diffphore_tpu.ops.rigid import modify_conformer as j_modify_conformer
from diffphore_tpu.ops.torsion import apply_torsion_updates as j_apply_torsion_updates

from torch_port_helpers import assert_close, cached_files, load_pair

torch.set_num_threads(1)

RTOL = 1e-5  # f32 elementwise, relative to max(|ref|, 1)
T = lambda x: torch.from_numpy(np.asarray(x).copy())


def test_constants_equal_jax_values():
    from diffphore_tpu.chem.features import LIG_FEATURE_DIMS
    from diffphore_tpu.chem.mol import vdw_radius
    from diffphore_tpu.cli.pipeline import VDW_TABLE
    from diffphore_tpu.data import phore

    assert tconst.LIG_FEATURE_DIMS == LIG_FEATURE_DIMS
    assert tconst.PHORETYPES == phore.PHORETYPES
    assert tconst.NUM_PHORETYPE == phore.NUM_PHORETYPE
    assert tconst.PHORE_WEIGHT == phore.PHORE_WEIGHT
    assert tconst.PHORE_ALPHA == phore.PHORE_ALPHA
    assert tconst.PHORE_FEATURE_DIMS == phore.PHORE_FEATURE_DIMS
    assert all(tconst.vdw_radius(z) == vdw_radius(z) for z in range(0, 130))
    np.testing.assert_array_equal(tconst.VDW_TABLE, VDW_TABLE)


def test_cached_complex_fields_equal_npz():
    path = cached_files(n=1)[0]
    b = tgraphs.load_cached(path)
    with np.load(path) as z:
        for name in tgraphs.ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(b, name).numpy(), z[name], err_msg=name)
    assert b.batch_size == 1 and (b.num_atoms, b.num_phore, b.num_torsions) == (24, 96, 8)
    assert b.names and isinstance(b.meta[0], dict)


def test_repeat_and_concat_batches_match_jax():
    from diffphore_tpu.data.graphs import concat_batches, repeat_batch

    f1, f2 = cached_files(n=2)
    j1, t1 = load_pair(f1)
    j2, t2 = load_pair(f2)
    jb = concat_batches([repeat_batch(jax.tree_util.tree_map(np.asarray, j1), 3),
                         jax.tree_util.tree_map(np.asarray, j2)])
    tb = tgraphs.concat_batches([tgraphs.repeat_batch(t1, 3), t2])
    assert tb.batch_size == 4
    for name in tgraphs.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    moved = tb.to("cpu")
    assert moved.lig_pos.device.type == "cpu" and moved.names == tb.names


@pytest.mark.parametrize("spec", ["20x0e", "20x0e + 10x1o + 10x1e + 20x0o", "1x0e + 1x1o + 1x2e",
                                  "3x2o + 1x1e"])
def test_irreps_parse(spec):
    a, b = tirreps.parse(spec), jirreps.parse(spec)
    assert repr(a) == repr(b) and a.dim == b.dim and a.num_scalars == b.num_scalars
    assert a.slices() == b.slices()
    assert [(m, ir.l, ir.p) for m, ir in a] == [(m, ir.l, ir.p) for m, ir in b]


def test_wigner_3j_equal():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(3):
                np.testing.assert_array_equal(twig.wigner_3j(l1, l2, l3), jwig.wigner_3j(l1, l2, l3))


@pytest.mark.parametrize("irr_in,irr_sh,irr_out", [
    ("20x0e", "1x0e + 1x1o + 1x2e", "20x0e + 10x1o"),
    ("20x0e + 10x1o + 10x1e + 20x0o", "1x0e + 1x1o + 1x2e", "2x1o + 2x1e"),
    ("20x0e + 10x1o + 10x1e + 20x0o", "1x1o + 1x0e + 1x1e", "20x0o + 20x0e"),
])
def test_channelwise_path_tables_equal(irr_in, irr_sh, irr_out):
    a, b = ttp.channelwise_tp(irr_in, irr_sh, irr_out), jtp.channelwise_tp(irr_in, irr_sh, irr_out)
    assert a.weight_numel == b.weight_numel and a.mix_specs == b.mix_specs
    assert [dataclasses.astuple(p) for p in a.paths] == [dataclasses.astuple(p) for p in b.paths]


def test_full_tensor_product_equal():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 9)).astype(np.float32)
    y = rng.normal(size=(5, 5)).astype(np.float32)
    args = ("1x0e+1x1o+1x2e", "1x2e", ("0e", "1o", "1e"))
    got, irr = ttp.full_tensor_product(T(x), T(y), *args)
    ref, jirr = jtp.full_tensor_product(jnp.asarray(x), jnp.asarray(y), *args)
    assert repr(irr) == repr(jirr)
    assert_close(got, ref, RTOL, "full_tensor_product")


def test_spherical_harmonics_equal():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[0] = 0.0  # the zero-safe branch
    for zero_safe in (False, True):
        assert_close(tsh.spherical_harmonics_lmax2(T(v), zero_safe=zero_safe),
                     jsh.spherical_harmonics_lmax2(jnp.asarray(v), zero_safe=zero_safe), RTOL,
                     f"sh zero_safe={zero_safe}")
    assert float(tsh.spherical_harmonics_lmax2(T(v), zero_safe=True)[0].abs().max()) == 0.0
    u = tsh.normalize_vec(T(v))
    assert_close(tsh.sh_l2(u), jsh.sh_l2(jsh.normalize_vec(jnp.asarray(v))), RTOL, "sh_l2")
    # (y, z, x) basis -> Cartesian (x, y, z)
    assert torch.equal(tsh.irrep1_to_cartesian(T(v)), T(v)[:, [2, 0, 1]])
    assert_close(tsh.irrep1_to_cartesian(T(v)), jsh.irrep1_to_cartesian(jnp.asarray(v)), 0, "cart")


def test_diffusion_schedule_and_embedding():
    t = np.linspace(0.0, 1.0, 21).astype(np.float32)
    js, ts = jdiff.SigmaSchedule(), tdiff.SigmaSchedule()
    for a, b in zip(ts(T(t)), js(jnp.asarray(t))):
        assert_close(a, b, RTOL, "sigma")
    for g in ("g_tr", "g_rot", "g_tor"):
        assert_close(getattr(ts, g)(T(t)), getattr(js, g)(jnp.asarray(t)), RTOL, g)
    np.testing.assert_array_equal(tdiff.t_schedule(20), jdiff.t_schedule(20))
    emb_t = tdiff.timestep_embedding("sinusoidal", 20, 10000)(T(t))
    emb_j = jdiff.timestep_embedding("sinusoidal", 20, 10000)(jnp.asarray(t))
    assert_close(emb_t, emb_j, 1e-4, "sinusoidal embedding")
    # the Fourier embedding reads the JAX package's frozen projection from
    # the port's table; at the default scale its arguments reach 1e5
    for scale in (1.0, 10000.0):
        emb_t = tdiff.timestep_embedding("fourier", 20, scale)(T(t))
        emb_j = jdiff.timestep_embedding("fourier", 20, scale)(jnp.asarray(t))
        assert_close(emb_t, emb_j, 1e-5, f"fourier embedding, scale {scale}")


@pytest.mark.parametrize("half", [4, 10, 16, 32, 64])
def test_embedding_frequencies_are_rounded_once(half):
    """The sinusoidal embedding's frequencies: exp of the f32 exponents taken
    in f64 and rounded to f32 once, on any device; at the shipped width
    (sigma_embed_dim 20) the JAX package's table bit for bit."""
    exponent = np.arange(half, dtype=np.float32) * np.float32(-math.log(10000) / (half - 1))
    want = np.exp(exponent.astype(np.float64)).astype(np.float32)
    got = tdiff.embedding_frequencies(half, 10000, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if half == 10:
        jax_freq = jnp.exp(jnp.arange(half, dtype=jnp.float32) * (-math.log(10000) / (half - 1)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_freq))


def test_score_norm_tables_equal():
    """The tables are built by the port's own numpy code (no JAX cache)."""
    eps = np.geomspace(0.05, 1.6, 200).astype(np.float32)
    assert_close(tso3.score_norm(T(eps)), jso3.score_norm(jnp.asarray(eps)), RTOL, "so3")
    sig = np.geomspace(0.02, 3.2, 200).astype(np.float32)
    assert_close(ttorus.score_norm(T(sig)), jtorus.score_norm(jnp.asarray(sig)), RTOL, "torus")


def test_rotations_equal():
    rng = np.random.default_rng(2)
    aa = rng.normal(size=(50, 3)).astype(np.float32) * 2.0
    aa[:3] *= 1e-8  # small-angle series
    R_t = tgeo.axis_angle_to_matrix(T(aa))
    assert_close(R_t, jgeo.axis_angle_to_matrix(jnp.asarray(aa)), RTOL, "axis_angle_to_matrix")
    q = rng.normal(size=(50, 4)).astype(np.float32)
    assert_close(tgeo.quaternion_to_matrix(T(q)), jgeo.quaternion_to_matrix(jnp.asarray(q)),
                 RTOL, "quaternion_to_matrix")
    R = np.asarray(jgeo.axis_angle_to_matrix(jnp.asarray(aa)))
    assert_close(tgeo.matrix_to_quaternion(T(R)), jgeo.matrix_to_quaternion(jnp.asarray(R)),
                 1e-4, "matrix_to_quaternion")
    assert_close(tgeo.matrix_to_axis_angle(T(R)), jgeo.matrix_to_axis_angle(jnp.asarray(R)),
                 1e-4, "matrix_to_axis_angle")
    a, b = rng.normal(size=(50, 3)).astype(np.float32), rng.normal(size=(50, 3)).astype(np.float32)
    assert_close(tgeo.angle_between(T(a), T(b)), jgeo.angle_between(jnp.asarray(a), jnp.asarray(b)),
                 RTOL, "angle_between")


def test_kabsch_equal_and_recovers_rotation():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(4, 12, 3)).astype(np.float32) * 3
    R = np.asarray(jgeo.axis_angle_to_matrix(jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)))
    B = np.einsum("bni,bji->bnj", A, R) + rng.normal(size=(4, 1, 3)).astype(np.float32)
    mask = np.ones((4, 12), bool)
    mask[:, 9:] = False
    B[:, 9:] += 50.0  # padded rows must not matter
    Rt, tt = tgeo.kabsch(T(A), T(B), T(mask))
    Rj, tj = jgeo.kabsch(jnp.asarray(A), jnp.asarray(B), jnp.asarray(mask))
    assert_close(Rt, Rj, 1e-4, "kabsch R")
    assert_close(tt, tj, 1e-4, "kabsch t")
    assert_close(Rt, R, 1e-4, "kabsch recovers R")
    aligned = torch.einsum("bni,bji->bnj", T(A), Rt) + tt[:, None]
    assert_close(aligned[:, :9], B[:, :9], 1e-4, "aligned points")


def _pose_inputs(rows=3, seed=4):
    path = cached_files(n=1)[0]
    jb, tb = load_pair(path, rows)
    rng = np.random.default_rng(seed)
    Tn = tb.num_torsions
    tr = rng.normal(size=(rows, 3)).astype(np.float32)
    rot = rng.normal(size=(rows, 3)).astype(np.float32)
    tor = rng.uniform(-np.pi, np.pi, size=(rows, Tn)).astype(np.float32)
    return jb, tb, tr, rot, tor


def test_torsion_updates_equal():
    jb, tb, _, _, tor = _pose_inputs()
    aux = tb.lig_norm + tb.lig_pos[:, None]
    pos_t, aux_t = apply_torsion_updates(tb.lig_pos, tb.tor_edges, tb.mask_rotate, T(tor),
                                         tb.tor_mask, aux_points=aux)
    pos_j, aux_j = jax.vmap(j_apply_torsion_updates)(
        jb.lig_pos, jb.tor_edges, jb.mask_rotate, jnp.asarray(tor), jb.tor_mask,
        jnp.asarray(aux.numpy()))
    assert_close(pos_t, pos_j, RTOL, "torsion pos")
    assert_close(aux_t, aux_j, RTOL, "torsion aux")


def test_modify_conformer_equal_and_keeps_bonds():
    jb, tb, tr, rot, tor = _pose_inputs()

    def one(pos, norm, mask, edges, mrot, tmask, a, b, c):
        st = j_modify_conformer(PoseState(pos, norm), mask, edges, mrot, tmask, a, b, c)
        return st.pos, st.norm

    pos_j, norm_j = jax.vmap(one)(jb.lig_pos, jb.lig_norm, jb.lig_mask, jb.tor_edges,
                                  jb.mask_rotate, jb.tor_mask, jnp.asarray(tr), jnp.asarray(rot),
                                  jnp.asarray(tor))
    pos_t, norm_t = modify_conformer(tb.lig_pos, tb.lig_norm, tb.lig_mask, tb.tor_edges,
                                     tb.mask_rotate, tb.tor_mask, T(tr), T(rot), T(tor))
    assert_close(pos_t, pos_j, 1e-5, "modify_conformer pos")
    assert_close(norm_t, norm_j, 1e-5, "modify_conformer norm")

    # bond lengths survive the rigid move, the torsions and the re-alignment
    bonds = tb.bond_mask[0].numpy()
    i, j = np.nonzero(np.triu(bonds))
    before = np.linalg.norm(tb.lig_pos[0, i].numpy() - tb.lig_pos[0, j].numpy(), axis=-1)
    for r in range(pos_t.shape[0]):
        after = np.linalg.norm(pos_t[r, i].numpy() - pos_t[r, j].numpy(), axis=-1)
        np.testing.assert_allclose(after, before, atol=1e-4)
