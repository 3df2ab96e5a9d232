"""The noise transform of the training step against the JAX package's:
``so3.sample`` / ``sample_vec`` / ``score_vec``, ``torus.wrap`` / ``score`` /
``p`` / ``sample`` and ``data.transforms.apply_noise`` with and without the
rejection curriculum.  The JAX side draws from a key; the port gets the
same numbers handed in (``torch_port_helpers.noise_draws``).  Tables are
the same f32 arrays on both sides, so table lookups agree to interpolation
rounding (2e-5 relative)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.data import transforms as ttransforms
from diffphore_torch.ops import so3 as tso3
from diffphore_torch.ops import torus as ttorus
from diffphore_torch.ops.diffusion import SigmaSchedule as TSchedule
from diffphore_tpu.data import transforms as jtransforms
from diffphore_tpu.ops import so3 as jso3
from diffphore_tpu.ops import torus as jtorus
from diffphore_tpu.ops.diffusion import SigmaSchedule as JSchedule

from torch_port_helpers import assert_close, cached_files, load_pair_batch, noise_draws

torch.set_num_threads(1)
T = lambda x: torch.from_numpy(np.asarray(x).copy())
RTOL = 2e-5


def test_so3_tables_equal_the_jax_tables():
    jt, tt = jso3._tables(), tso3._tables()
    assert set(tt) == set(jt)
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k])
    jt, tt = jtorus._tables(), ttorus._tables()
    assert set(tt) == set(jt)
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k])


def test_so3_sample_and_score_vec_match_jax():
    key = jax.random.PRNGKey(0)
    eps = np.exp(np.random.default_rng(0).uniform(np.log(0.02), np.log(1.8), (4, 6)))
    eps = eps.astype(np.float32)
    ref = jso3.sample(key, jnp.asarray(eps))
    u = jax.random.uniform(key, eps.shape)
    assert_close(tso3.sample(T(eps), u=T(u)), ref, RTOL, "sample")

    k1, k2 = jax.random.split(key)
    ref_vec = jso3.sample_vec(key, jnp.asarray(eps))
    got_vec = tso3.sample_vec(T(eps), axis=T(jax.random.normal(k1, eps.shape + (3,))),
                              u=T(jax.random.uniform(k2, eps.shape)))
    assert_close(got_vec, ref_vec, RTOL, "sample_vec")
    assert_close(tso3.score_vec(T(eps), got_vec), jso3.score_vec(jnp.asarray(eps), ref_vec),
                 RTOL, "score_vec")


def test_so3_sample_from_a_generator():
    """Draws from a generator: reproducible, in (0, pi], and wider for a
    larger epsilon."""
    eps = torch.full((2000,), 0.1)
    a = tso3.sample(eps, torch.Generator().manual_seed(1))
    b = tso3.sample(eps, torch.Generator().manual_seed(1))
    wide = tso3.sample(torch.full((2000,), 1.0), torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert float(a.min()) > 0 and float(wide.max()) <= np.pi + 1e-6
    assert float(wide.mean()) > 3 * float(a.mean())
    vec = tso3.sample_vec(eps, torch.Generator().manual_seed(2))
    assert vec.shape == (2000, 3) and bool(torch.isfinite(vec).all())


def test_torus_functions_match_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-7, 7, (5, 8)).astype(np.float32)
    sigma = np.exp(rng.uniform(np.log(0.02), np.log(4.0), (5, 1))).astype(np.float32)
    assert_close(ttorus.wrap(T(x)), jtorus.wrap(jnp.asarray(x)), RTOL, "wrap")
    assert_close(ttorus.score(T(x), T(sigma)), jtorus.score(jnp.asarray(x), jnp.asarray(sigma)),
                 RTOL, "score")
    assert_close(ttorus.p(T(x), T(sigma)), jtorus.p(jnp.asarray(x), jnp.asarray(sigma)),
                 RTOL, "p")
    key = jax.random.PRNGKey(3)
    s = np.broadcast_to(sigma, x.shape).copy()
    z = jax.random.normal(key, x.shape)
    assert_close(ttorus.sample(T(s), z=T(z)), jtorus.sample(key, jnp.asarray(s)), RTOL, "sample")


@pytest.mark.parametrize("reject_prob", [0.0, 0.6])
def test_apply_noise_matches_jax(reject_prob):
    """Noised positions and norms (1e-4 A: a chain of rotations), t, and all
    four score targets; with rejection the same draw index is picked."""
    jb, tb = load_pair_batch(cached_files(n=3))
    B, Tn = tb.batch_size, tb.num_torsions
    key = jax.random.PRNGKey(5)
    jn, jt = jtransforms.apply_noise(jb, key, JSchedule(), reject_prob=reject_prob)
    draws = noise_draws(key, B, Tn, reject=reject_prob > 0)
    tn, tt = ttransforms.apply_noise(tb, TSchedule(), draws=draws, reject_prob=reject_prob)
    assert_close(tn.t, jn.t, 1e-6, "t")
    assert_close(tn.lig_pos, jn.lig_pos, 1e-4, "lig_pos")
    assert_close(tn.lig_norm, jn.lig_norm, 1e-4, "lig_norm")
    for name in ("tr_score", "rot_score", "tor_score", "tor_sigma"):
        assert_close(getattr(tt, name), getattr(jt, name), 1e-4, name)
    if reject_prob:
        # some row took a later draw than the first, so the branch was exercised
        first_tr = draws.z_tr[0] * TSchedule()(draws.t)[0][:, None]
        moved = (-tt.tr_score * TSchedule()(draws.t)[0][:, None] ** 2 - first_tr).abs().amax(-1)
        assert int((moved > 1e-6).sum()) >= 1


def test_apply_noise_from_a_generator():
    """Generator draws: reproducible by seed, torsion noise only on real
    torsions, no_torsion zeroes it, and rejection needs its uniforms."""
    _, tb = load_pair_batch(cached_files(n=2))
    sched = TSchedule()
    a, ta = ttransforms.apply_noise(tb, sched, torch.Generator().manual_seed(0))
    b, _ = ttransforms.apply_noise(tb, sched, torch.Generator().manual_seed(0))
    c, _ = ttransforms.apply_noise(tb, sched, torch.Generator().manual_seed(1))
    assert torch.equal(a.lig_pos, b.lig_pos) and not torch.equal(a.lig_pos, c.lig_pos)
    assert float(ta.tor_score[~tb.tor_mask].abs().max()) == 0.0
    _, tn = ttransforms.apply_noise(tb, sched, torch.Generator().manual_seed(0), no_torsion=True)
    assert float(tn.tor_score.abs().max()) == 0.0
    r, _ = ttransforms.apply_noise(tb, sched, torch.Generator().manual_seed(0), reject_prob=0.5)
    assert bool(torch.isfinite(r.lig_pos).all())
    plain = ttransforms.draw_noise(tb.batch_size, tb.num_torsions, torch.Generator(), "cpu")
    with pytest.raises(ValueError):
        ttransforms.apply_noise(tb, sched, draws=plain, reject_prob=0.5)
