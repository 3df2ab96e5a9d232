"""The port's calibrated conformation sampler against the JAX package's
(``diffphore_tpu.train.ccsampler``) on the same batch, weights and draws: a
small model (ns=8, nv=4, 2 conv layers, f32 convs, dropout 0) whose
batch-norm running statistics are randomized (the reverse step inside the
sampler is an eval-mode forward).  The draws are derived from the key as the
JAX code derives them (``cc_draws``) and handed to the port.  Tolerances,
all f32, relative to max(|reference|, 1):

* ``dynamic_schedule``: 1e-12 (float64 arithmetic on both sides);
* noised positions, norms, t and the three targets: 1e-4 (measured 1.3e-5
  at worst, on the rotation target; the Kabsch eigenvectors and the axis-angle of a small rotation
  amplify f32 rounding, and the scores divide by sigma squared);
* one train step: loss 1e-3, every gradient leaf 1e-3 of its scale plus
  5e-6 of the largest gradient (the floor of tests/test_torch_train_state.py).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.data.transforms import apply_noise as t_apply_noise
from diffphore_torch.train import ccsampler as t_cc
from diffphore_tpu.models import ScoreModel as JScoreModel
from diffphore_tpu.train import ccsampler as j_cc
from diffphore_tpu.train import state as jstate

from torch_port_helpers import (SMALL, assert_close, cached_files, cc_draws, cc_train_step_draws,
                                configs, load_pair_batch, port_leaves, port_model,
                                port_train_state, randomize_stats)

torch.set_num_threads(2)
DELTA_T = 0.05
RTOL = 1e-4
B = 6


@pytest.mark.parametrize("epoch", [0, 1, 50, 299, 300, 301, 800])
@pytest.mark.parametrize("rate,u,c", [(0.6, 300, 6.0), (0.4, 400, 10), (0.6, 0, 6.0)])
def test_dynamic_schedule_matches_jax(epoch, rate, u, c):
    want = j_cc.dynamic_schedule(epoch, rate, u, c)
    got = t_cc.dynamic_schedule(epoch, rate, u, c)
    assert abs(got - want) <= 1e-12 and 0.0 <= got <= rate


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(**SMALL)
    jb, tb = load_pair_batch(cached_files(n=B))
    js, _ = jstate.create_train_state(jcfg, jb, seed=0, lr=1e-3)
    stats = randomize_stats({"batch_stats": js.batch_stats}, seed=1)["batch_stats"]
    js = js.replace(batch_stats=stats)
    return jcfg, tcfg, jb, tb, js


@pytest.fixture(scope="module")
def jax_apply(setup):
    jcfg, _, jb, _, js = setup
    variables = {"params": js.params, "batch_stats": js.batch_stats}

    @jax.jit
    def run(key, p):
        score_fn = lambda b: JScoreModel(jcfg).apply(variables, b)
        return j_cc.ccsampler_apply_noise(jb, key, jcfg.sigma_schedule, score_fn, p, DELTA_T)

    return run


def _port_apply(setup, p, draws):
    _, tcfg, _, tb, js = setup
    model = port_model(tcfg, {"params": js.params, "batch_stats": js.batch_stats})
    with torch.no_grad():
        return t_cc.ccsampler_apply_noise(tb, tcfg.sigma_schedule, model, p, DELTA_T,
                                          draws=draws)


@pytest.mark.parametrize("seed,p", [(3, 0.6), (4, 0.6), (5, 1.0)])
def test_apply_noise_matches_jax(setup, jax_apply, seed, p):
    _, _, jb, tb, _ = setup
    key = jax.random.PRNGKey(seed)
    ref, ref_targets = jax_apply(key, np.float32(p))
    draws = cc_draws(key, B, tb.num_torsions)
    out, targets, use_cc = _port_apply(setup, p, draws)
    # the JAX function does not return its selection: a graph took the
    # calibrated branch exactly when its t moved
    ref_use = np.asarray(ref.t) != draws.noise.t.numpy()
    assert np.array_equal(use_cc.numpy(), ref_use)
    if p == 0.6:
        assert ref_use.any() and not ref_use.all()       # both branches are held
    assert_close(out.t, ref.t, 1e-6, "t")
    assert_close(out.lig_pos, ref.lig_pos, RTOL, "positions")
    assert_close(out.lig_norm, ref.lig_norm, RTOL, "norms")
    assert_close(targets.tr_score, ref_targets.tr_score, RTOL, "tr target")
    assert_close(targets.rot_score, ref_targets.rot_score, RTOL, "rot target")
    assert_close(targets.tor_score, ref_targets.tor_score, RTOL, "tor target")
    assert_close(targets.tor_sigma, ref_targets.tor_sigma, 1e-6, "tor sigma")


def test_probability_zero_is_the_plain_branch(setup):
    """p = 0: no graph takes the calibrated branch and the result is
    ``apply_noise`` on the same forward draws, bit for bit."""
    _, tcfg, _, tb, _ = setup
    draws = cc_draws(jax.random.PRNGKey(8), B, tb.num_torsions)
    out, targets, use_cc = _port_apply(setup, 0.0, draws)
    plain, plain_targets = t_apply_noise(tb, tcfg.sigma_schedule, draws=draws.noise)
    assert not bool(use_cc.any())
    for name in ("lig_pos", "lig_norm", "t"):
        assert torch.equal(getattr(out, name), getattr(plain, name)), name
    for name in ("tr_score", "rot_score", "tor_score", "tor_sigma"):
        assert torch.equal(getattr(targets, name), getattr(plain_targets, name)), name


def test_probability_one_takes_every_graph_above_delta_t(setup):
    """p = 1: exactly the graphs with t > delta_t take the calibrated
    branch; their t drops by delta_t (not below 1e-3), the others keep the
    plain sample."""
    _, tcfg, _, tb, _ = setup
    draws = cc_draws(jax.random.PRNGKey(9), B, tb.num_torsions)
    draws.noise.t = torch.tensor([0.02, 0.05, 0.0505, 0.3, 0.7, 0.99])
    out, targets, use_cc = _port_apply(setup, 1.0, draws)
    assert use_cc.tolist() == [False, False, True, True, True, True]
    want_t = torch.where(use_cc, torch.clamp(draws.noise.t - DELTA_T, min=1e-3), draws.noise.t)
    assert torch.equal(out.t, want_t)
    plain, plain_targets = t_apply_noise(tb, tcfg.sigma_schedule, draws=draws.noise)
    assert torch.equal(out.lig_pos[~use_cc], plain.lig_pos[~use_cc])
    assert torch.equal(targets.rot_score[~use_cc], plain_targets.rot_score[~use_cc])
    assert not torch.equal(out.lig_pos[use_cc], plain.lig_pos[use_cc])
    for v in (out.lig_pos, targets.tr_score, targets.rot_score, targets.tor_score):
        assert bool(torch.isfinite(v).all())


def test_rebuilt_pose_is_the_stepped_pose(setup):
    """The cumulative transform recovered by Kabsch reproduces the pose the
    model's step reached (the sampler's premise): rebuilt from the clean
    pose it lies within 1e-3 A RMSD of the stepped one."""
    from diffphore_torch.sampler.sampling import apply_pose_update

    _, _, _, tb, _ = setup
    rng = np.random.default_rng(0)
    tr = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    rot = torch.from_numpy((rng.normal(size=(B, 3)) * 0.5).astype(np.float32))
    rot[0] = 1e-7                                     # next to the identity
    tor = torch.from_numpy(rng.normal(size=(B, tb.num_torsions)).astype(np.float32)) * tb.tor_mask
    moved = apply_pose_update(tb, tr, rot, tor)
    tr_cum, rot_cum = t_cc.cumulative_rigid_transform(tb, tor, moved.lig_pos)
    rebuilt = apply_pose_update(tb, tr_cum, rot_cum, tor)
    m = tb.lig_mask[..., None]
    rmsd = (((rebuilt.lig_pos - moved.lig_pos) ** 2 * m).sum((1, 2)) / m.sum((1, 2))).sqrt()
    assert bool(torch.isfinite(rot_cum).all()) and float(rmsd.max()) < 1e-3, rmsd


def test_train_step_matches_jax(setup):
    """One step of ``make_ccsampler_train_step`` on both sides at p = 0.6.
    The JAX step runs with plain SGD at rate 1, so its gradients are the
    parameters' change; the port's stay on the parameters after its step."""
    jcfg, tcfg, jb, tb, js = setup
    valid = np.array([True] * (B - 1) + [False])            # the last row is repeat padding
    jb, tb = jb.replace(valid=jnp.asarray(valid)), tb.replace(valid=torch.from_numpy(valid))
    tx = optax.sgd(1.0)
    js = js.replace(opt_state=tx.init(js.params))
    key = jax.random.PRNGKey(21)
    jstep = jax.jit(j_cc.make_ccsampler_train_step(jcfg, tx, delta_t=DELTA_T))
    js2, jm = jstep(js, jb, key, np.float32(0.6))
    jgrads = jax.tree_util.tree_map(lambda a, b: a - b, js.params, js2.params)

    state = port_train_state(js, tcfg)
    stats_before = {k: v.clone() for k, v in state.model.named_buffers()}
    tstep = t_cc.make_ccsampler_train_step(tcfg, delta_t=DELTA_T)
    state, m = tstep(state, tb, p_from_infer=0.6,
                     draws=cc_train_step_draws(key, B, tb.num_torsions))
    assert state.model.training and state.step == 1
    assert float(m["grad_finite"]) == float(jm["grad_finite"]) == 1.0
    assert 0.0 < float(m["cc_share"]) < 1.0
    for k in ("loss", "tr_loss", "rot_loss", "tor_loss"):
        assert_close(m[k], jm[k], 1e-3, k)

    want = port_leaves(jgrads)
    floor = 5e-6 * max(float(v.abs().max()) for v in want.values() if v.numel())
    worst = 0.0
    for name, p in state.model.named_parameters():
        ref = want[name].numpy()
        if not ref.size:
            continue
        scale, err = float(np.abs(ref).max()), float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-3 * scale + floor, f"grad {name}: {err:.3e} vs scale {scale:.3e}"
        worst = max(worst, err / max(scale, 1e-30))
    assert worst > 0
    # the frozen forward read the running statistics and left them alone;
    # only the training forward moved them
    stats = port_leaves_stats(js2.batch_stats)
    for name, b in state.model.named_buffers():
        assert not torch.equal(b, stats_before[name]) or not b.numel()
        assert_close(b, stats[name], 1e-3, name)


def port_leaves_stats(batch_stats):
    from diffphore_torch.utils.checkpoints import convert_variables

    return convert_variables({"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                    dict(batch_stats))})


def test_step_is_reproducible_from_its_generator(setup):
    """Draws from a generator: the same seed repeats the step, another seed
    changes it; dropout on."""
    _, _, _, tb, _ = setup
    _, tcfg = configs(**{**SMALL, "dropout": 0.1})
    from diffphore_torch.train.state import create_train_state

    losses = []
    for seed in (0, 0, 1):
        state = create_train_state(tcfg, seed=0, device="cpu")
        step = t_cc.make_ccsampler_train_step(tcfg)
        state, m = step(state, tb, torch.Generator().manual_seed(seed), p_from_infer=1.0)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] and losses[0] != losses[2]
