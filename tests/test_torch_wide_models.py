"""The port's score model at two wide configurations against the JAX
package on the CPU, forward and gradients at f32: ns / nv = 48 / 10 at
l <= 1 (E = H = 144, F up to 272: the widths past the kernels' old limits
that tests/test_torch_widths.py checks) and 32 / 16 at l = 2 (F up to
576)."""

import numpy as np
import pytest
import torch

import jax

from diffphore_torch.data.transforms import apply_noise as t_apply_noise
from diffphore_torch.train.losses import score_matching_loss as t_loss
from diffphore_tpu.data.transforms import apply_noise as j_apply_noise
from diffphore_tpu.models.score_model import ScoreModel as JScoreModel
from diffphore_tpu.train.losses import score_matching_loss as j_loss

from torch_port_helpers import (SMALL, assert_close, cached_files, configs, load_pair,
                                port_leaves, port_model, randomize_stats, train_step_draws)

torch.set_num_threads(2)

WIDE = [dict(ns=48, nv=10), dict(ns=32, nv=16, use_second_order_repr=True)]


@pytest.mark.parametrize("widths", WIDE, ids=["48-10-l1", "32-16-l2"])
def test_wide_model_matches_jax(widths):
    """The port's model at a wide configuration (2 conv layers, f32,
    flax-init weights with random running statistics) against the JAX
    model on two rows of a cached complex: one training forward and
    backward at dropout 0, batch statistics and the same noise; the
    outputs and the loss to 1e-4 of max(|ref|, 1), every gradient leaf to
    1e-4 of its scale plus 2e-5 of the largest, and the whole gradient as
    one vector to 1e-4 (L2).  The floor is tests/test_torch_train_state.py's
    5e-6 (two transition MLPs whose true gradient is zero, and mixing
    weights whose gradient is rounding noise beside the largest), scaled
    for f32 sums over two to four times the small model's channels: at 32
    / 16 tor_bond_conv.mix_1 stands 6.9e-6 off at 5.8e-3 of scale, with
    the largest leaf 1.06."""
    jcfg, tcfg = configs(**{**SMALL, **widths})
    jmodel = JScoreModel(jcfg)
    jb, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.7, 0.3])
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb), seed=0)
    key = jax.random.PRNGKey(1)
    k_noise, k_drop = jax.random.split(key)
    schedule = jcfg.sigma_schedule

    @jax.jit
    def jax_side(params, batch_stats):
        noised, targets = j_apply_noise(jb, k_noise, schedule)

        def loss_fn(p):
            preds, _ = jmodel.apply({"params": p, "batch_stats": batch_stats}, noised,
                                    deterministic=False, use_running_average=False,
                                    mutable=["batch_stats"], rngs={"dropout": k_drop})
            m = j_loss(preds, targets, noised.t, jb.tor_mask, schedule, valid=jb.valid)
            return m["loss"], preds

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (jloss, jpreds), jgrads = jax_side(variables["params"], variables["batch_stats"])
    model = port_model(tcfg, variables).train()
    noised, targets = t_apply_noise(tb, tcfg.sigma_schedule,
                                    draws=train_step_draws(key, tb.batch_size, tb.num_torsions))
    preds = model(noised)
    for name, g, r in zip(("tr", "rot", "tor"), preds, jpreds):
        assert_close(g, r, 1e-4, name)
    m = t_loss(preds, targets, noised.t, tb.tor_mask, tcfg.sigma_schedule, valid=tb.valid)
    m["loss"].backward()
    assert_close(m["loss"], jloss, 1e-4, "loss")
    want = port_leaves(jgrads)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    floor = 2e-5 * max(float(v.abs().max()) for v in want.values() if v.numel())
    gots, refs = [], []
    for name, p in params.items():
        ref = want[name].numpy()
        if not ref.size:
            continue
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        err = float(np.abs(got - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()) + floor, name
        gots.append(got.ravel())
        refs.append(ref.ravel())
    gots, refs = np.concatenate(gots), np.concatenate(refs)
    assert np.linalg.norm(gots - refs) <= 1e-4 * np.linalg.norm(refs)
