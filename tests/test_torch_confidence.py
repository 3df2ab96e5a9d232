"""The port's confidence head (``models/confidence.py``, ``train/confidence.py``
and the confidence row of ``FitEngine``) against the JAX package's on the
same cached complexes, weights and noise, on the CPU.

Tolerances: the shipped heads' outputs at f32 to 1e-5 of their scale (the
two sides differ by f32 summation order); at the shipped bf16 to a quarter
of the JAX package's own f32-vs-bf16 difference, the criterion of
``tests/test_torch_bf16.py``; labels to 1e-5, losses and step metrics to
1e-4 relative; parameters after one Adam step as in
``tests/test_torch_train_state.py`` (elements with a clear gradient within
0.2 x lr, all within 2 x lr: an early Adam update is about lr x sign(g)).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.cli.pipeline import FitEngine, job_from_cached
from diffphore_torch.data import graphs as tgraphs
from diffphore_torch.data.transforms import apply_noise as t_apply_noise
from diffphore_torch.models.confidence import ConfidenceModel as TConfidenceModel
from diffphore_torch.models.layers import batch_statistics
from diffphore_torch.ops.fitscore import batch_phore_arrays
from diffphore_torch.sampler.sampling import SamplerSettings
from diffphore_torch.train import confidence as tconf
from diffphore_torch.train.state import create_train_state
from diffphore_torch.utils import checkpoints
from diffphore_tpu.cli.pipeline import VDW_TABLE
from diffphore_tpu.data.dataset import load_complex
from diffphore_tpu.data.graphs import repeat_batch as j_repeat_batch
from diffphore_tpu.models.confidence import ConfidenceModel as JConfidenceModel
from diffphore_tpu.train import confidence as jconf

from torch_port_helpers import (REPO, SMALL, assert_close, assert_within_gap, cached_files,
                                configs, confidence_pair, corpus2, load_pair_batch,
                                noise_draws, noised_pair, port_leaves, port_model,
                                train_step_draws)

torch.set_num_threads(2)

HEADS = {"corpus2": os.path.join(REPO, "runs", "corpus2", "confidence"),
         "corpus_rmsd": os.path.join(REPO, "runs", "corpus", "confidence_rmsd")}
KEYS = ("loss", "loss_ph", "loss_ex", "loss_total")
#: (label_mode, by_total): the three label modes
MODES = [("rmsd_lt2", False), ("fitness", False), ("fitness", True)]
LR = 1e-3


def _jax_head(jcfg, variables, jb, **kw):
    return [np.asarray(o) for o in
            jax.jit(lambda v, b: JConfidenceModel(jcfg).apply(v, b, **kw))(variables, jb)]


@pytest.mark.parametrize("head", list(HEADS))
def test_shipped_head_loads_strictly(head):
    """250 parameter and 42 batch-statistics leaves map 1:1 onto the port's
    names (``load_state_dict(strict=True)``); the run directory's training
    keys (mode, confidence_label, ...) are ignored."""
    cfg, model = checkpoints.load_confidence_dir(HEADS[head], device="cpu")
    assert isinstance(model, TConfidenceModel) and not model.training
    assert len(dict(model.named_parameters())) == 250
    assert len(dict(model.named_buffers())) == 42
    assert cfg.compute_dtype == "bfloat16" and (cfg.ns, cfg.nv, cfg.num_conv_layers) == (20, 10, 4)
    _, last = checkpoints.load_confidence_dir(HEADS[head], device="cpu",
                                              checkpoint=checkpoints.LAST_MODEL, use_ema=True)
    assert set(last.state_dict()) == set(model.state_dict())


@pytest.mark.parametrize("head", list(HEADS))
def test_shipped_head_matches_jax_at_f32(head):
    jcfg, variables, _, model = confidence_pair(HEADS[head])
    jb, tb = noised_pair([0.6, 0.0], seed=3)
    ref = _jax_head(jcfg, variables, jb)
    with torch.no_grad():
        got = model(tb)
    for name, g, r in zip(("fit", "ph", "ex"), got, ref):
        assert_close(g, r, 1e-5, f"{head} {name}")


@pytest.mark.parametrize("head", list(HEADS))
def test_shipped_head_matches_jax_at_bf16(head):
    """The shipped compute_dtype: each output within a quarter of the JAX
    package's own f32-vs-bf16 difference."""
    jcfg, variables, _, model = confidence_pair(HEADS[head], "bfloat16")
    jb, tb = noised_pair([0.7, 0.1], seed=4)
    ref = _jax_head(jcfg, variables, jb)
    ref32 = _jax_head(dataclasses.replace(jcfg, compute_dtype="float32"), variables, jb)
    with torch.no_grad():
        got = model(tb)
    gap = max(assert_within_gap({n: g}, {n: r}, {n: r32}, 0.25, f"{head} {n}")
              for n, g, r, r32 in zip(("fit", "ph", "ex"), got, ref, ref32))
    assert gap >= 1e-4, gap


@pytest.mark.parametrize("label_mode,by_total", MODES)
def test_eval_step_matches_jax_and_keeps_running_statistics(label_mode, by_total):
    """The validation step normalizes by the batch's statistics (JAX:
    deterministic=True, use_running_average=False, new statistics thrown
    away): its losses match JAX's, the running buffers stay bit-equal, and
    the forward differs from one on the running statistics."""
    jcfg, variables, tcfg, model = confidence_pair(HEADS["corpus2"])
    jb, tb = load_pair_batch(cached_files(n=3))
    key = jax.random.PRNGKey(5)
    want = jax.jit(jconf.make_confidence_eval_step(JConfidenceModel(jcfg), VDW_TABLE, by_total,
                                                   label_mode))(variables, jb, key)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    draws = noise_draws(key, tb.batch_size, tb.num_torsions)
    got = tconf.make_confidence_eval_step(tcfg, by_total, label_mode)(model, tb, draws=draws)
    for k in KEYS:
        assert_close(got[k], want[k], 1e-4, k)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not model.training
    with torch.no_grad():
        noised, _ = t_apply_noise(tb, tcfg.sigma_schedule, draws=draws)
        running = model(noised)[1]
        with batch_statistics(model):
            batch = model(noised)[1]
    assert float((running - batch).abs().max()) > 1e-3


def test_labels_rmsd_and_losses_match_jax():
    jb, tb = noised_pair([0.6, 0.2], seed=6)
    clean_j, clean_t = load_pair_batch(cached_files(n=2))
    for name, g, r in zip(("phscore1", "ov_pct", "ex_pct"), tconf.confidence_labels(tb),
                          jconf.confidence_labels(jb, VDW_TABLE)):
        assert_close(g, r, 1e-5, name)
    rmsd = tconf.pose_rmsd_to_clean(tb.lig_pos, clean_t.lig_pos, clean_t.lig_mask)
    assert_close(rmsd, jconf.pose_rmsd_to_clean(jb.lig_pos, clean_j.lig_pos, clean_j.lig_mask),
                 1e-5, "rmsd")
    assert float(rmsd.min()) > 0
    rng = np.random.default_rng(0)
    preds = [rng.normal(size=5).astype(np.float32) * 3 for _ in range(3)]
    labels = [(rng.random(5) < 0.5).astype(np.float32)] + [rng.random(5).astype(np.float32)
                                                           for _ in range(2)]
    T = lambda xs: [torch.from_numpy(x) for x in xs]
    for label_mode, by_total in MODES:
        got = tconf.confidence_loss(T(preds), T(labels), by_total, label_mode)
        want = jconf.confidence_loss([jnp.asarray(p) for p in preds],
                                     [jnp.asarray(x) for x in labels], by_total, label_mode)
        for k in KEYS:
            assert_close(got[k], want[k], 1e-6, f"{label_mode} {by_total} {k}")
    with pytest.raises(ValueError):
        tconf.make_confidence_eval_step(configs(**SMALL)[1], label_mode="rmsd")(
            TConfidenceModel(configs(**SMALL)[1]), tb)


@pytest.mark.parametrize("label_mode,by_total", MODES)
def test_train_step_matches_jax(label_mode, by_total):
    """One head train step at the SMALL width, dropout 0, same weights and
    noise: the losses, every updated parameter leaf, the batch statistics
    and the EMA shadow."""
    jcfg, tcfg = configs(**SMALL)
    jb, tb = load_pair_batch(cached_files(n=3))
    jmodel = JConfidenceModel(jcfg)
    js, tx = jconf.create_confidence_train_state(jmodel, jb, seed=0, lr=LR)
    key = jax.random.PRNGKey(1)
    js2, jm = jax.jit(jconf.make_confidence_train_step(jmodel, tx, VDW_TABLE, 0.999, by_total,
                                                       label_mode))(js, jb, key)
    model = port_model(tcfg, {"params": js.params, "batch_stats": js.batch_stats},
                       TConfidenceModel)
    state = create_train_state(tcfg, lr=LR, device="cpu", model=model)
    step = tconf.make_confidence_train_step(tcfg, 0.999, by_total, label_mode)
    state, tm = step(state, tb, draws=train_step_draws(key, tb.batch_size, tb.num_torsions))
    assert state.step == 1 and float(tm["grad_finite"]) == 1.0
    for k in KEYS:
        assert_close(tm[k], jm[k], 1e-4, k)

    want, ema = port_leaves(js2.params), port_leaves(js2.ema_params)
    grads = {n: p.grad.abs() for n, p in model.named_parameters()}
    gmax = max(float(g.max()) for g in grads.values() if g.numel())
    for name, p in model.named_parameters():
        diff = (p.detach() - want[name]).abs()
        assert float(diff.max()) <= 2 * LR, name
        g = grads[name]
        clear = (g >= 1e-2 * g.max()) & (g >= 1e-4 * gmax)
        assert not clear.any() or float(diff[clear].max()) <= 0.2 * LR, name
        assert float((state.ema_params[name] - ema[name]).abs().max()) <= 2 * LR * 1e-3 + 1e-7
    assert float((want["confidence_head.Dense_1.weight"]
                  - port_leaves(js.params)["confidence_head.Dense_1.weight"]).abs().max()) > 0
    stats = checkpoints.convert_variables(
        {"batch_stats": jax.tree_util.tree_map(np.asarray, dict(js2.batch_stats))})
    for name, buf in model.named_buffers():
        assert_close(buf, stats[name], 1e-4, name)


def test_fit_engine_confidence_row_matches_jax_head_and_ranks_by_it():
    """Five reverse steps of 4 poses with the corpus2 score model, then the
    corpus2 head at t = 0 on the final poses (f32 on both sides): the row
    equals the JAX head's on the same poses (JAX runs it without pose
    groups, the port with ``pose_group = n``), and ``rank`` orders the
    poses by it, best first."""
    _, _, tcfg, score_model = corpus2()
    jcfg_c, cvars, _, head = confidence_pair(HEADS["corpus2"])
    n = 4
    engine = FitEngine(tcfg, score_model, samples_per_complex=n,
                       settings=SamplerSettings(inference_steps=5), seed=0, device="cpu",
                       confidence=head)
    path = cached_files(n=1)[0]
    one = tgraphs.load_cached(path)
    rows = tgraphs.repeat_batch(one, n).replace(names=(), meta=())
    seen = []
    hook = head.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    pos, scores, _ = engine.run_batch(rows, batch_phore_arrays(rows), n)
    hook.remove()
    (final,) = seen                      # the final poses (positions and ligand norms), t = 0
    assert torch.equal(final.lig_pos, pos) and float(final.t.abs().max()) == 0.0
    jb = j_repeat_batch(load_complex(path), n).replace(
        names=(), meta=(), **{f: jnp.asarray(getattr(final, f).numpy())
                              for f in tgraphs.ARRAY_FIELDS})
    ref = _jax_head(jcfg_c, cvars, jb)[0]
    assert_close(scores["confidence"], ref, 1e-5, "confidence row")

    (res,) = engine.run_complexes([job_from_cached(one)])
    conf = np.asarray(res["confidence"])
    assert conf.shape == (n,) and np.isfinite(conf).all()
    assert list(res["rank"]) == list(np.argsort(conf)[::-1])
    assert np.array_equal(res["scores"]["confidence"], conf.astype(np.float32))


def test_fresh_head_weights_and_dropout_generator():
    """``create_confidence_train_state`` draws the head from its seed
    (``init_parameters`` covers the head's MLP: LeCun-normal weights, zero
    biases) and ``set_dropout_generator`` reaches its dropout."""
    from diffphore_torch.models.score_model import set_dropout_generator

    _, tcfg = configs(**SMALL)
    a = tconf.create_confidence_train_state(tcfg, 0.2, seed=3, device="cpu").model
    b = tconf.create_confidence_train_state(tcfg, 0.2, seed=3, device="cpu").model
    c = tconf.create_confidence_train_state(tcfg, 0.2, seed=4, device="cpu").model
    w = "confidence_head.Dense_0.weight"
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    assert float(a.state_dict()["confidence_head.Dense_1.bias"].abs().max()) == 0.0
    std = float(a.state_dict()[w].std())
    assert 0.5 / tcfg.ns ** 0.5 < std < 2.0 / tcfg.ns ** 0.5
    gen = torch.Generator()
    set_dropout_generator(a, gen)
    assert a.confidence_head.drop.generator is gen and a.confidence_head.drop.rate == 0.2
