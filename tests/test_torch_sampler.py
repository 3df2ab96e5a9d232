"""The port's sampler against the JAX package's with the same noise: the
prior draw, single reverse-SDE steps with the JAX state fed in (so the
step functions of the cross graph - direction flips, the norm-angle branch
- are held step by step, not only after a chain), and a chained 3-step run.
Model: the corpus2 checkpoint at f32 on both sides.  The JAX draws come from
a key exactly as the JAX sampler makes them and are injected into the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.ops.diffusion import t_schedule
from diffphore_torch.sampler import sampling as ts
from diffphore_tpu.models.score_model import ScoreModel as JScoreModel
from diffphore_tpu.sampler import sampling as js

from torch_port_helpers import (assert_close, cached_files, corpus2, load_pair, prior_noise,
                                step_noise, to_port)

torch.set_num_threads(2)

B = 3


@pytest.fixture(scope="module")
def setup():
    jcfg, variables, tcfg, model = corpus2()
    jb, tb = load_pair(cached_files(n=1)[0], rows=B)
    return jcfg, variables, tcfg, model, jb, tb


@pytest.fixture(scope="module")
def jax_step(setup):
    """One JAX reverse step (sample_step at the schedule's sigmas), jitted
    once with t and dt as arguments."""
    jcfg = setup[0]
    sched = jcfg.sigma_schedule

    @jax.jit
    def step(v, b, k, t, dt):
        b = b.replace(t=jnp.full((B,), t, jnp.float32))
        score_fn = lambda x: JScoreModel(jcfg).apply(v, x)
        return js.sample_step(score_fn, b, k, sched, *sched(t), delta_t=dt)

    return step


def _score_fn(model):
    return lambda b: model(b)


def test_randomize_position_matches_jax(setup):
    jcfg, _, tcfg, _, jb, tb = setup
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda b, k: js.randomize_position(b, k, tr_sigma_max=jcfg.tr_sigma_max))(jb, key)
    got = ts.randomize_position(tb, prior_noise(key, B, tb.num_torsions),
                                tr_sigma_max=tcfg.tr_sigma_max)
    assert_close(got.lig_pos, ref.lig_pos, 1e-5, "prior pos")
    assert_close(got.lig_norm, ref.lig_norm, 1e-5, "prior norm")


@pytest.mark.parametrize("step", [0, 9, 19])
def test_single_reverse_step_matches_jax(setup, jax_step, step):
    jcfg, variables, tcfg, model, jb, tb = setup
    # a common start: the JAX prior pose, fed to both sides
    start = jax.jit(lambda b, k: js.randomize_position(b, k))(jb, jax.random.PRNGKey(3))
    ts_ = t_schedule(20)
    t = np.float32(ts_[step])
    dt = np.float32(ts_[step] - (ts_[step + 1] if step + 1 < 20 else 0.0))
    key = jax.random.PRNGKey(100 + step)
    jb2, jtr, jrot, jtor = jax_step(variables, start, key, t, dt)
    k_tr, k_rot, k_tor = jax.random.split(key, 3)
    z = [torch.from_numpy(np.array(jax.random.normal(k, shape)))
         for k, shape in ((k_tr, (B, 3)), (k_rot, (B, 3)), (k_tor, (B, tb.num_torsions)))]
    with torch.no_grad():
        tb2, ttr, trot, ttor = ts.reverse_step(_score_fn(model), to_port(start), float(t),
                                               float(dt), *z, tcfg.sigma_schedule)
    assert_close(ttr, jtr, 1e-4, "tr update")
    assert_close(trot, jrot, 1e-4, "rot update")
    assert_close(ttor, jtor, 1e-4, "tor update")
    assert_close(tb2.lig_pos, jb2.lig_pos, 1e-4, "positions")
    assert_close(tb2.lig_norm, jb2.lig_norm, 1e-4, "norms")


def test_three_chained_steps_match_jax(setup):
    jcfg, variables, tcfg, model, jb, tb = setup
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    settings = js.SamplerSettings(inference_steps=3, no_final_step_noise=True)

    @jax.jit
    def jrun(v, b, k1, k2):
        b = js.randomize_position(b, k1)
        return js.reverse_diffusion(lambda x: JScoreModel(jcfg).apply(v, x), b, k2,
                                    jcfg.sigma_schedule, settings)

    ref = jrun(variables, jb, k1, k2)
    T = tb.num_torsions
    with torch.no_grad():
        b = ts.randomize_position(tb, prior_noise(k1, B, T))
        got = ts.reverse_diffusion(
            _score_fn(model), b, tcfg.sigma_schedule,
            ts.SamplerSettings(inference_steps=3, no_final_step_noise=True),
            step_noise(k2, 3, B, T))
    assert_close(got.lig_pos, ref.lig_pos, 1e-3, "positions after 3 steps")
    assert_close(got.lig_norm, ref.lig_norm, 1e-3, "norms after 3 steps")


@pytest.mark.parametrize("no_random,ode", [(False, False), (True, False), (False, True)])
def test_sample_step_at_per_graph_sigmas_matches_jax(setup, no_random, ode):
    """``sample_step`` as the calibrated sampler calls it: every graph at its
    own t and sigmas, a fixed delta_t, with and without noise and as the ODE
    update (1e-4 of scale, as the single reverse steps above)."""
    from torch_port_helpers import sample_step_noise

    jcfg, variables, tcfg, model, jb, tb = setup
    start = jax.jit(lambda b, k: js.randomize_position(b, k))(jb, jax.random.PRNGKey(5))
    t = np.array([0.08, 0.45, 0.93], np.float32)
    key = jax.random.PRNGKey(31)

    @jax.jit
    def jrun(v, b, k):
        b = b.replace(t=jnp.asarray(t))
        sched = jcfg.sigma_schedule
        return js.sample_step(lambda x: JScoreModel(jcfg).apply(v, x), b, k, sched,
                              *sched(jnp.asarray(t)), delta_t=0.05, no_random=no_random, ode=ode)

    jb2, jtr, jrot, jtor = jrun(variables, start, key)
    tstart = to_port(start).replace(t=torch.from_numpy(t.copy()))
    sched = tcfg.sigma_schedule
    with torch.no_grad():
        tb2, ttr, trot, ttor = ts.sample_step(
            _score_fn(model), tstart, sched, *sched(tstart.t), delta_t=0.05,
            no_random=no_random, ode=ode, noise=sample_step_noise(key, B, tb.num_torsions))
    assert torch.equal(tb2.t, tstart.t)                  # the step leaves t alone
    assert_close(ttr, jtr, 1e-4, "tr update")
    assert_close(trot, jrot, 1e-4, "rot update")
    assert_close(ttor, jtor, 1e-4, "tor update")
    assert_close(tb2.lig_pos, jb2.lig_pos, 1e-4, "positions")
    assert_close(tb2.lig_norm, jb2.lig_norm, 1e-4, "norms")
    if no_random or ode:                                 # no noise enters: any draws do
        with torch.no_grad():
            again = ts.sample_step(_score_fn(model), tstart, sched, *sched(tstart.t),
                                   no_random=no_random, ode=ode,
                                   generator=torch.Generator().manual_seed(1))
        assert torch.equal(again[0].lig_pos, tb2.lig_pos)


def _fitness_toward_origin(b):
    """A fitness both frameworks compute alike: minus the mean squared
    distance of the ligand's atoms from the origin (the phore's center)."""
    return -((b.lig_pos ** 2).sum(-1) * b.lig_mask).sum(-1) / b.lig_mask.sum(-1)


@pytest.mark.parametrize("mode", ["ode", "candidates", "no_random_no_torsion"])
def test_sampler_modes_match_jax(setup, mode):
    """The remaining modes over 3 chained steps with trajectories: the ODE;
    ``random_samples = 3`` with a fitness function (every candidate draw
    applied, the best row kept) on the first 3 of 4 scheduled steps; and
    ``no_random`` with ``no_torsion``.  1e-3 of scale, as the chained SDE
    run above."""
    jcfg, variables, tcfg, model, jb, tb = setup
    kw = {"ode": dict(inference_steps=3, ode=True),
          "candidates": dict(inference_steps=4, actual_steps=3, random_samples=3),
          "no_random_no_torsion": dict(inference_steps=3, no_random=True, no_torsion=True)}[mode]
    fit = _fitness_toward_origin if mode == "candidates" else None
    k1, k2 = jax.random.split(jax.random.PRNGKey(13))
    jsettings, tsettings = js.SamplerSettings(**kw), ts.SamplerSettings(**kw)

    @jax.jit
    def jrun(v, b, k1, k2):
        b = js.randomize_position(b, k1, no_torsion=jsettings.no_torsion)
        return js.reverse_diffusion(lambda x: JScoreModel(jcfg).apply(v, x), b, k2,
                                    jcfg.sigma_schedule, jsettings, return_trajectory=True,
                                    fitness_fn=fit)

    ref, ref_traj = jrun(variables, jb, k1, k2)
    T = tb.num_torsions
    assert tsettings.steps == 3 and tsettings.candidates == (3 if mode == "candidates" else 1)
    with torch.no_grad():
        b = ts.randomize_position(tb, prior_noise(k1, B, T), no_torsion=tsettings.no_torsion)
        got, traj = ts.reverse_diffusion(
            _score_fn(model), b, tcfg.sigma_schedule, tsettings,
            step_noise(k2, 3, B, T, S=tsettings.candidates), fitness_fn=fit,
            return_trajectory=True)
    assert traj.shape == (3, B) + tuple(tb.lig_pos.shape[1:])
    assert torch.equal(traj[-1], got.lig_pos)
    assert_close(traj, ref_traj, 1e-3, "trajectory")
    assert_close(got.lig_pos, ref.lig_pos, 1e-3, "positions after 3 steps")
    assert_close(got.lig_norm, ref.lig_norm, 1e-3, "norms after 3 steps")
    if mode == "candidates":
        # the selection matters: the first candidate alone ends elsewhere
        with torch.no_grad():
            first = ts.reverse_diffusion(_score_fn(model), b, tcfg.sigma_schedule, tsettings,
                                         step_noise(k2, 3, B, T, S=3))
        assert float((first.lig_pos - got.lig_pos).abs().max()) > 1e-2
        assert bool((_fitness_toward_origin(got) >= _fitness_toward_origin(first) - 1e-4).any())


def test_default_sde_path_reads_the_candidate_axis_it_was_given():
    """Noise without the (steps, S, B, .) layout, or with too few steps or
    candidates, is refused rather than broadcast."""
    settings = ts.SamplerSettings(inference_steps=2, random_samples=2)
    z = ts.draw_steps(2, 3, 4, torch.Generator().manual_seed(0), "cpu", candidates=1)
    with pytest.raises(ValueError, match="candidates"):
        ts.reverse_diffusion(lambda b: None, None, None, settings, z)
    a = ts.draw_steps(2, 3, 4, torch.Generator().manual_seed(0), "cpu")
    assert a.z_tr.shape == (2, 1, 3, 3) and a.z_tor.shape == (2, 1, 3, 4)
    flat = torch.randn((2, 3, 3), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.z_tr[:, 0], flat)               # the numbers of the 3-d layout
