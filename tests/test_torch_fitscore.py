"""The port's on-device fitness scorer against the JAX package's, on cached
complexes with their own poses and perturbed ones (f32 on both sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.constants import VDW_TABLE
from diffphore_torch.ops import fitscore as tfs
from diffphore_torch.ops.geometry import axis_angle_to_matrix
from diffphore_tpu.ops import fitscore as jfs
from diffphore_tpu.train.confidence import batch_phore_arrays as j_batch_phore_arrays

from torch_port_helpers import assert_close, cached_files, load_pair

torch.set_num_threads(1)

RTOL = 2e-5


def _posed(path, rows=6, seed=0):
    """The cached pose (row 0) and rigidly perturbed copies."""
    jb, tb = load_pair(path, rows)
    rng = np.random.default_rng(seed)
    scale = np.linspace(0.0, 1.0, rows, dtype=np.float32)[:, None]
    aa = torch.from_numpy(rng.normal(size=(rows, 3)).astype(np.float32) * scale)
    tr = torch.from_numpy(rng.normal(size=(rows, 3)).astype(np.float32) * 2 * scale)
    R = axis_angle_to_matrix(aa)
    c = tb.lig_pos.mean(1, keepdim=True)
    pos = torch.einsum("bai,bji->baj", tb.lig_pos - c, R) + c + tr[:, None]
    tb = tb.replace(lig_pos=pos)
    return jb.replace(lig_pos=jnp.asarray(pos.numpy())), tb


@pytest.mark.parametrize("which", [0, 1])
def test_fitscore_matches_jax(which):
    path = cached_files(n=2)[which]
    jb, tb = _posed(path, seed=which)
    jref = j_batch_phore_arrays(jb)
    tref = tfs.batch_phore_arrays(tb)
    for f in ("coord", "type_onehot", "alpha", "weight", "anchor", "is_ex", "mask"):
        np.testing.assert_array_equal(getattr(tref, f).numpy(), np.asarray(getattr(jref, f)))
    vdw_j = jnp.asarray(VDW_TABLE)[jb.lig_feat[..., 0]]
    ref = jax.vmap(lambda p, m, fp, v, r, cfp: jfs.fitscore(p, m, fp, v, r, count_fp=cfp))(
        jb.lig_pos, jb.lig_mask, jb.lig_scorer_fp, vdw_j, jref, jb.lig_phorefp)
    vdw_t = torch.from_numpy(VDW_TABLE)[tb.lig_feat[..., 0]]
    got = tfs.fitscore(tb.lig_pos, tb.lig_mask, tb.lig_scorer_fp, vdw_t, tref,
                       count_fp=tb.lig_phorefp)
    assert set(got) == set(ref)
    for k in ref:
        assert_close(got[k].to(torch.float32), np.asarray(ref[k], np.float32), RTOL, k)
    # the cached pose fits its own phore better than the moved ones
    fit = tfs.fitness_by_index(got, 1)
    assert float(fit[0]) >= float(fit[1:].max())
    for idx in range(1, 7):
        assert_close(tfs.fitness_by_index(got, idx), np.asarray(jfs.fitness_by_index(ref, idx)),
                     RTOL, f"fitness index {idx}")


def test_calibration_and_interp():
    raw = np.concatenate([np.linspace(-0.6, 1.2, 301),
                          np.asarray(jfs.PHSCORE1_CAL_KNOTS[0])]).astype(np.float32)
    assert_close(tfs.calibrate_phscore1(torch.from_numpy(raw)),
                 jfs.calibrate_phscore1(jnp.asarray(raw)), 1e-6, "calibrate_phscore1")
    xp = np.asarray([0.0, 1.0, 1.0, 3.0], np.float32)
    fp = np.asarray([1.0, 2.0, 5.0, -1.0], np.float32)
    x = np.linspace(-1, 4, 41).astype(np.float32)
    assert_close(tfs.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)),
                 jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)), 1e-6, "interp")


#: the custom-coefficient fitness (score column -6): (overlap, percent, anchor)
COEFFS = [(0.5, 0.5, -1.0), (1.0 / 3, 1.0 / 3, 1.0 / 3), (0.0, 0.25, 0.75)]
CUSTOM_RTOL = 1e-6


def _both(path, seed, **kw):
    """(port scores, JAX scores) of one cached complex's posed rows under
    the same keyword arguments."""
    jb, tb = _posed(path, seed=seed)
    jref, tref = j_batch_phore_arrays(jb), tfs.batch_phore_arrays(tb)
    vdw_j = jnp.asarray(VDW_TABLE)[jb.lig_feat[..., 0]]
    ref = jax.vmap(lambda p, m, fp, v, r, cfp: jfs.fitscore(p, m, fp, v, r, count_fp=cfp, **kw))(
        jb.lig_pos, jb.lig_mask, jb.lig_scorer_fp, vdw_j, jref, jb.lig_phorefp)
    vdw_t = torch.from_numpy(VDW_TABLE)[tb.lig_feat[..., 0]]
    got = tfs.fitscore(tb.lig_pos, tb.lig_mask, tb.lig_scorer_fp, vdw_t, tref,
                       count_fp=tb.lig_phorefp, **kw)
    return got, ref


@pytest.mark.parametrize("coeffs", COEFFS, ids=["ov_pct", "thirds", "pct_anchor"])
@pytest.mark.parametrize("which", [0, 1])
def test_custom_coefficient_fitness_matches_jax(which, coeffs):
    path = cached_files(n=2)[which]
    kw = dict(zip(("overlap_coeff", "percent_coeff", "anchor_coeff"), coeffs))
    got, ref = _both(path, which, **kw)
    want = np.asarray(ref["fitness"], np.float32)
    assert_close(got["fitness"], want, CUSTOM_RTOL, "custom fitness")
    assert_close(tfs.fitness_by_index(got, 6), np.asarray(jfs.fitness_by_index(ref, 6)),
                 CUSTOM_RTOL, "fitness index 6")
    # the coefficients move only the custom column
    plain, _ = _both(path, which)
    for k in plain:
        if k != "fitness":
            assert torch.equal(got[k], plain[k]), k
    assert not torch.equal(got["fitness"], plain["fitness"])


@pytest.mark.parametrize("which", [0, 1])
def test_combine_sum_matches_jax(which):
    got, ref = _both(cached_files(n=2)[which], which, combine="sum",
                     overlap_coeff=0.5, percent_coeff=0.5, anchor_coeff=0.0)
    assert set(got) == set(ref)
    for k in ref:
        assert_close(got[k].to(torch.float32), np.asarray(ref[k], np.float32), CUSTOM_RTOL, k)
    plain, _ = _both(cached_files(n=2)[which], which)
    assert (got["V_overlap"] >= plain["V_overlap"]).all()


@pytest.mark.parametrize("which", [0, 1])
def test_default_call_unchanged(which):
    """The default call, which every shipped path makes: "max" combination
    and the raw PhScore1 as the custom column, bit for bit as spelled out."""
    path = cached_files(n=2)[which]
    default, _ = _both(path, which)
    explicit, _ = _both(path, which, overlap_coeff=-1.0, percent_coeff=0.5, anchor_coeff=0.5,
                        combine="max")
    for k in default:
        assert torch.equal(default[k], explicit[k]), k
    assert torch.equal(default["fitness"], default["phscore1_raw"])
