"""The port's train and validation steps against the JAX package's
(``diffphore_tpu.train.state``) on the same batch, weights and noise: a
small model (ns=8, nv=4, 2 conv layers, f32 convs) at dropout 0, because
dropout masks cannot be replayed from JAX's PRNG; the noise of each step is
derived from the step's key as the JAX code derives it and handed to the
port.  Tolerances, all f32:

* loss and metrics: 1e-4 relative;
* first-step gradients, every leaf: |port - jax| <= 1e-4 * max|jax leaf|
  + 5e-6 * max|jax gradient over all leaves| (measured 2e-5 of the leaf's
  scale).  The floor is for the two transition MLPs that only scale the
  cross-graph edge vector: the harmonics normalize that vector, so their
  true gradient is zero and both sides hold rounding noise there (1e-7
  against gradients of order 1 elsewhere);
* batch statistics after a step: 1e-4;
* parameters after 3 Adam steps: early Adam updates are about
  lr * sign(g), so an element whose gradient is rounding noise can differ by
  up to 2 * lr per step between the two sides.  Held: elements whose
  first-step |g| is at least 1e-2 of their leaf's largest and 1e-4 of the
  largest over all leaves (well above noise) must agree within 0.2 * lr;
  every element within 2 * lr * steps.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.data.transforms import apply_noise as t_apply_noise
from diffphore_torch.train import state as tstate
from diffphore_torch.train.losses import score_matching_loss as t_loss
from diffphore_tpu.data.transforms import apply_noise as j_apply_noise
from diffphore_tpu.models import ScoreModel as JScoreModel
from diffphore_tpu.train import state as jstate
from diffphore_tpu.train.losses import score_matching_loss as j_loss

from torch_port_helpers import (SMALL, assert_close, cached_files, configs, load_pair_batch,
                                noise_draws, port_leaves, port_train_state, train_step_draws)

torch.set_num_threads(2)
LR = 1e-3
STEPS = 3
METRICS = ("loss", "tr_loss", "rot_loss", "tor_loss", "tr_base_loss", "rot_base_loss",
           "tor_base_loss")


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(**SMALL)
    jb, tb = load_pair_batch(cached_files(n=3))
    valid = np.array([True, True, False])               # the last row is repeat padding
    jb, tb = jb.replace(valid=jnp.asarray(valid)), tb.replace(valid=torch.from_numpy(valid))
    js, tx = jstate.create_train_state(jcfg, jb, seed=0, lr=LR)
    return jcfg, tcfg, jb, tb, js, tx


def test_first_step_loss_gradients_and_batch_stats(setup):
    jcfg, tcfg, jb, tb, js, _ = setup
    key = jax.random.PRNGKey(1)
    k_noise, k_drop = jax.random.split(key)
    schedule = jcfg.sigma_schedule
    jmodel = JScoreModel(jcfg)

    @jax.jit
    def jax_side(params, batch_stats):
        noised, targets = j_apply_noise(jb, k_noise, schedule)

        def loss_fn(p):
            preds, new = jmodel.apply({"params": p, "batch_stats": batch_stats}, noised,
                                      deterministic=False, use_running_average=False,
                                      mutable=["batch_stats"], rngs={"dropout": k_drop})
            m = j_loss(preds, targets, noised.t, jb.tor_mask, schedule, valid=jb.valid)
            return m["loss"], (m, new["batch_stats"])

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, (jm, jstats)), jgrads = jax_side(js.params, js.batch_stats)

    state = port_train_state(js, tcfg, LR)
    model = state.model.train()
    noised, targets = t_apply_noise(tb, tcfg.sigma_schedule,
                                    draws=train_step_draws(key, tb.batch_size, tb.num_torsions))
    m = t_loss(model(noised), targets, noised.t, tb.tor_mask, tcfg.sigma_schedule,
               valid=tb.valid)
    m["loss"].backward()
    for k in METRICS:
        assert_close(m[k], jm[k], 1e-4, k)

    want = port_leaves(jgrads)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    worst = 0.0
    floor = 5e-6 * max(float(v.abs().max()) for v in want.values() if v.numel())
    for name, p in params.items():
        ref = want[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        scale = float(np.abs(ref).max()) if ref.size else 0.0
        err = float(np.abs(got - ref).max()) if ref.size else 0.0
        assert err <= 1e-4 * scale + floor, f"grad {name}: {err:.3e} vs scale {scale:.3e}"
        worst = max(worst, err / max(scale, 1e-30))
    assert worst > 0          # the two sides are not the same numbers by construction

    from diffphore_torch.utils.checkpoints import convert_variables

    stats = convert_variables({"batch_stats": jax.tree_util.tree_map(np.asarray, dict(jstats))})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers)
    for name, b in buffers.items():
        assert_close(b, stats[name], 1e-4, name)


def test_three_steps_follow_jax(setup):
    jcfg, tcfg, jb, tb, js, tx = setup
    jstep = jax.jit(jstate.make_train_step(jcfg, tx))
    tstep = tstate.make_train_step(tcfg)
    state = port_train_state(js, tcfg, LR)
    start = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    first_grad = None
    key = jax.random.PRNGKey(7)
    for i in range(STEPS):
        key, sub = jax.random.split(key)
        js, jm = jstep(js, jb, sub)
        state, m = tstep(state, tb, draws=train_step_draws(sub, tb.batch_size, tb.num_torsions))
        if first_grad is None:
            first_grad = {k: p.grad.clone() for k, p in state.model.named_parameters()}
        for k in METRICS:
            assert_close(m[k], jm[k], 1e-4, f"step {i} {k}")
        assert float(m["grad_finite"]) == float(jm["grad_finite"]) == 1.0
    assert state.step == int(js.step) == STEPS

    jparams, jema = port_leaves(js.params), port_leaves(js.ema_params)
    global_max = max(float(g.abs().max()) for g in first_grad.values() if g.numel())
    for name, p in state.model.named_parameters():
        if not p.numel():                  # the empty bias of a batch norm without scalars
            continue
        diff = (p.detach() - jparams[name]).abs()
        assert float(diff.max()) <= 2 * LR * STEPS, name
        g = first_grad[name].abs()
        if g.numel() and float(g.max()) > 0:
            clear = g >= max(1e-2 * float(g.max()), 1e-4 * global_max)
            if not bool(clear.any()):
                continue
            assert float(diff[clear].max()) <= 0.2 * LR, (name, float(diff[clear].max()))
            moved = (p.detach() - start[name]).abs()[clear]
            assert float(moved.max()) > 0.5 * LR        # Adam did move the leaf
        assert float((state.ema_params[name] - jema[name]).abs().max()) <= 2 * LR * STEPS * 1e-3 \
            + 1e-7, name


def test_ema_blend_and_learning_rate(setup):
    _, tcfg, _, tb, js, _ = setup
    state = port_train_state(js, tcfg, LR)
    before = {k: v.clone() for k, v in state.ema_params.items()}
    tstep = tstate.make_train_step(tcfg, ema_decay=0.9)
    state, _ = tstep(state, tb, torch.Generator().manual_seed(0))
    for name, p in state.model.named_parameters():
        want = 0.9 * before[name] + 0.1 * p.detach()
        assert torch.allclose(state.ema_params[name], want, atol=1e-7), name
    assert any(not torch.equal(state.ema_params[k], before[k]) for k in before)
    assert state.learning_rate == LR
    tstate.set_learning_rate(state, 5e-4)
    assert state.learning_rate == 5e-4
    assert isinstance(tstate.make_optimizer(state.model.parameters(), 1e-3, 0.01),
                      torch.optim.AdamW)


def test_nan_guard_zeroes_the_update(setup):
    """A non-finite loss: grad_finite 0, gradients zeroed, parameters
    unchanged on a fresh optimizer, step count still advanced."""
    _, tcfg, _, tb, js, _ = setup
    state = port_train_state(js, tcfg, LR)
    before = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    bad = tb.replace(phore_pos=tb.phore_pos.clone())
    bad.phore_pos[0, 0, 0] = float("nan")
    state, m = tstate.make_train_step(tcfg)(state, bad, torch.Generator().manual_seed(0))
    assert float(m["grad_finite"]) == 0.0 and not np.isfinite(float(m["loss"]))
    assert state.step == 1
    for name, p in state.model.named_parameters():
        assert not bool(p.grad.any()), name
        assert torch.equal(p.detach(), before[name]), name


def test_eval_step_per_graph_values_match_jax(setup):
    """Eval mode (running statistics, no dropout), per-graph values and t."""
    jcfg, tcfg, jb, tb, js, _ = setup
    key = jax.random.PRNGKey(11)
    jm = jax.jit(jstate.make_eval_step(jcfg))(js.variables, jb, key)
    state = port_train_state(js, tcfg, LR)
    stats_before = {k: v.clone() for k, v in state.model.named_buffers()}
    m = tstate.make_eval_step(tcfg)(state.model, tb,
                                    draws=noise_draws(key, tb.batch_size, tb.num_torsions))
    assert not state.model.training
    for k in METRICS + ("t",):
        assert m[k].shape == (tb.batch_size,)
        assert_close(m[k], jm[k], 1e-4, k)
    assert not m["loss"].requires_grad
    for k, v in state.model.named_buffers():
        assert torch.equal(v, stats_before[k])          # eval mode leaves them alone


def test_train_step_with_dropout_and_rejection_runs(setup):
    """Dropout 0.1 and the rejection curriculum together: the step is
    reproducible from the generator's seed and the loss is finite."""
    _, _, _, tb, _, _ = setup
    _, tcfg = configs(**{**SMALL, "dropout": 0.1})
    losses = []
    for seed in (0, 0, 1):
        state = tstate.create_train_state(tcfg, seed=0, lr=LR, device="cpu")
        step = tstate.make_train_step(tcfg, reject=True)
        state, m = step(state, tb, torch.Generator().manual_seed(seed), reject_prob=0.5)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] and losses[0] != losses[2]
