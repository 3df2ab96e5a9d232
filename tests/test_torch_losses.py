"""``diffphore_torch.train.losses.score_matching_loss`` against the JAX
package's on the same predictions and targets: scalars with and without a
``valid`` mask, per-graph values (``apply_mean=False``), and ``no_torsion``.
f32 on both sides, 1e-5 relative (element-wise arithmetic and short sums)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffphore_torch.ops.diffusion import SigmaSchedule as TSchedule
from diffphore_torch.train import losses as tlosses
from diffphore_tpu.ops.diffusion import SigmaSchedule as JSchedule
from diffphore_tpu.train import losses as jlosses

from torch_port_helpers import assert_close

T = lambda x: torch.from_numpy(np.asarray(x).copy())
KEYS = ("loss", "tr_loss", "rot_loss", "tor_loss", "tr_base_loss", "rot_base_loss",
        "tor_base_loss")


def _case(seed=0, B=5, Tn=6):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    preds = (f(B, 3), f(B, 3), f(B, Tn))
    t = rng.random(B).astype(np.float32)
    tor_sigma = np.asarray(JSchedule()(jnp.asarray(t))[2])
    targets = dict(tr_score=f(B, 3), rot_score=f(B, 3), tor_score=f(B, Tn), tor_sigma=tor_sigma)
    tor_mask = rng.random((B, Tn)) > 0.3
    tor_mask[1] = False                                   # a graph without torsions
    valid = np.array([True, True, True, False, False])
    return preds, targets, t, tor_mask, valid


@pytest.mark.parametrize("apply_mean", [True, False])
@pytest.mark.parametrize("use_valid", [False, True])
@pytest.mark.parametrize("no_torsion", [False, True])
def test_score_matching_loss_matches_jax(apply_mean, use_valid, no_torsion):
    preds, targets, t, tor_mask, valid = _case()
    ref = jlosses.score_matching_loss(
        tuple(jnp.asarray(p) for p in preds),
        jlosses.ScoreTargets(**{k: jnp.asarray(v) for k, v in targets.items()}),
        jnp.asarray(t), jnp.asarray(tor_mask), JSchedule(), 0.4, 0.35, 0.25, no_torsion,
        apply_mean=apply_mean, valid=jnp.asarray(valid) if use_valid else None)
    got = tlosses.score_matching_loss(
        tuple(T(p) for p in preds),
        tlosses.ScoreTargets(**{k: T(v) for k, v in targets.items()}),
        T(t), T(tor_mask), TSchedule(), 0.4, 0.35, 0.25, no_torsion,
        apply_mean=apply_mean, valid=T(valid) if use_valid else None)
    assert set(got) == set(ref) == set(KEYS)
    for k in KEYS:
        assert_close(got[k], ref[k], 1e-5, k)


def test_loss_gradient_reaches_every_prediction():
    preds, targets, t, tor_mask, valid = _case(seed=1)
    leaves = tuple(T(p).requires_grad_(True) for p in preds)
    out = tlosses.score_matching_loss(
        leaves, tlosses.ScoreTargets(**{k: T(v) for k, v in targets.items()}),
        T(t), T(tor_mask), TSchedule(), valid=T(valid))
    out["loss"].backward()
    for leaf in leaves:
        assert float(leaf.grad[:3].abs().max()) > 0        # valid rows
        assert float(leaf.grad[3:].abs().max()) == 0.0     # repeat-padded rows
