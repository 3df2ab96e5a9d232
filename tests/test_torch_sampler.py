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
