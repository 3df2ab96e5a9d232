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
