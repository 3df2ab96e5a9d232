"""The tank mode of the port (``models/trioformer.py::TankPhore``,
``ops/coord_recovery.py``, ``train/tank.py``, ``cli.train --model_type
tank``) against the JAX package on the CPU, at tank hidden 8 with 2 blocks:
the distance loss and its gradient, coordinate recovery from the same
initializations, the LAS matrices, the loss in its four modes, one train
step from the same weights, the pose metrics, and the trainer's run
directory, which the JAX package restores strictly.

Tolerances (f32): losses and gradients within 1e-5 of their scale (1e-4
for the model's gradients); a first Adam step moves each parameter by about
lr * sign(g), so parameters whose JAX gradient stands clear of rounding
noise must agree within 1e-6 after it; recovered coordinates after 100
Adam steps within 1e-3 A."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from diffphore_torch.chem.sdf import read_molecule as t_read_molecule
from diffphore_torch.cli import train as tcli
from diffphore_torch.data import graphs as tgraphs
from diffphore_torch.data import phore as tphore
from diffphore_torch.models.trioformer import TankPhore
from diffphore_torch.ops import coord_recovery as tcr
from diffphore_torch.ops import tp_aggregate, tp_fused, tp_scalar
from diffphore_torch.train import tank as ttank
from diffphore_torch.utils import checkpoints, flax_msgpack
from diffphore_tpu.chem.sdf import read_molecule as j_read_molecule
from diffphore_tpu.cli import train as jcli
from diffphore_tpu.data import graphs as jgraphs
from diffphore_tpu.data import phore as jphore
from diffphore_tpu.models import trioformer as jt
from diffphore_tpu.ops import coord_recovery as jcr
from diffphore_tpu.train import tank as jtank

from torch_port_helpers import (REPO, assert_close, cached_files, load_pair, load_pair_batch,
                                port_leaves)

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))
HIDDEN, BLOCKS = 8, 2
EXAMPLES = os.path.join(REPO, "examples")
TANK_FLAGS = ["--model_type", "tank", "--tank_hidden_dim", str(HIDDEN), "--tank_blocks",
              str(BLOCKS), "--batch_size", "2", "--device", "cpu"]


def _recovery_inputs(seed=0, A=9, P=6):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(A, 3)).astype(np.float32) * 2
    phore = rng.normal(size=(P, 3)).astype(np.float32) * 3
    pred = (np.linalg.norm(true[:, None] - phore[None], axis=-1)
            + rng.normal(size=(A, P)) * 0.2).astype(np.float32)
    pred[0, 0] = 12.0                                  # beyond the cutoff
    cross = np.ones((A, P), bool)
    cross[-1] = False                                  # a padded atom
    holo = np.linalg.norm(true[:, None] - true[None], axis=-1).astype(np.float32)
    intra = rng.random((A, A)) > 0.5
    intra = (intra | intra.T) & ~np.eye(A, dtype=bool)
    intra[-1], intra[:, -1] = False, False
    return phore, pred, cross, holo, intra


def test_distance_loss_and_gradient_match_jax():
    phore, pred, cross, holo, intra = _recovery_inputs()
    coords = np.random.default_rng(1).normal(size=(pred.shape[0], 3)).astype(np.float32)
    args = (phore, pred, cross, holo, intra)
    jl, jg = jax.value_and_grad(jcr.distance_loss)(jnp.asarray(coords),
                                                    *(jnp.asarray(a) for a in args))
    c = T(coords).requires_grad_(True)
    tl = tcr.distance_loss(c, *(T(a) for a in args))
    tl.backward()
    assert_close(tl, jl, 1e-5, "distance loss")
    assert_close(c.grad, jg, 1e-5, "its gradient")
    # a leading axis of initializations: one loss each
    both = tcr.distance_loss(torch.stack([T(coords), T(coords) + 1]), *(T(a) for a in args))
    assert both.shape == (2,) and float(both[0]) == float(tl.detach())


def test_recover_coords_from_injected_initializations():
    phore, pred, cross, holo, intra = _recovery_inputs(2)
    key = jax.random.PRNGKey(3)
    n_init, steps, A = 3, 100, pred.shape[0]
    jc, jloss = jcr.recover_coords(key, *(jnp.asarray(a) for a in (phore, pred, cross, holo,
                                                                   intra)),
                                   n_init=n_init, steps=steps)
    init = phore.mean(0) + 4.0 * np.asarray(jax.random.normal(key, (n_init, A, 3)))
    tc, tloss = tcr.recover_coords(*(T(a) for a in (phore, pred, cross, holo, intra)),
                                   n_init=n_init, steps=steps, init=T(init.astype(np.float32)))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3)
    assert_close(tloss, jloss, 1e-4, "final loss")
    gen = torch.Generator().manual_seed(0)
    drawn, _ = tcr.recover_coords(*(T(a) for a in (phore, pred, cross, holo, intra)),
                                  n_init=2, steps=5, generator=gen)
    assert drawn.shape == (A, 3) and torch.isfinite(drawn).all()


def _molecules():
    path = os.path.join(EXAMPLES, "EX01.sdf")
    return (j_read_molecule(path, remove_hs=True), t_read_molecule(path, remove_hs=True))


def test_las_distance_matrix_matches_jax():
    jm, tm = _molecules()
    jh, jmask = jcr.las_distance_matrix(jm)
    th, tmask = tcr.las_distance_matrix(tm)
    np.testing.assert_array_equal(tmask, np.asarray(jmask))
    np.testing.assert_allclose(th, np.asarray(jh), atol=1e-6)
    assert tmask.any() and not tmask.all()


@pytest.mark.parametrize("pred_dis", [True, False])
@pytest.mark.parametrize("consider_affinity", [True, False])
def test_tank_loss_in_all_modes(pred_dis, consider_affinity):
    rng = np.random.default_rng(4)
    B, A, P = 3, 5, 4
    y = rng.normal(size=(B, A, P)).astype(np.float32) * 3
    aff_pred, aff = rng.normal(size=B).astype(np.float32), rng.normal(size=B).astype(np.float32)
    d = rng.uniform(0, 14, size=(B, A, P)).astype(np.float32)
    dis_map, contact = np.minimum(d, 10.0), (d < 10.0).astype(np.float32)
    mask = (rng.random((B, A, P)) > 0.3).astype(np.float32)
    kw = dict(consider_affinity=consider_affinity, pred_dis=pred_dis, contact_weight=1.5,
              affinity_weight=0.2, pose_weight=5.0)
    args = (y, aff_pred, dis_map, contact, mask, aff)
    ref = jtank.tank_loss(*(jnp.asarray(a) for a in args), **kw)
    got = ttank.tank_loss(*(T(a) for a in args), **kw)
    for k in ("loss", "contact_loss", "affinity_loss"):
        assert_close(got[k], ref[k], 1e-5, k)


def test_dis_map_targets_match_jax():
    jb, tb = load_pair(cached_files(n=1)[0], rows=2)
    for g, r in zip(ttank.dis_map_targets(tb), jtank.dis_map_targets(jb)):
        assert_close(g, r, 1e-6, "targets")


def test_one_train_step_matches_make_tank_train_step():
    """One step from the same parameters: the loss, the gradients (the port's
    backward against jax.grad), the updated parameters and the EMA."""
    lr = 1e-3
    jb, tb = load_pair_batch(cached_files(n=2))
    jmodel = jt.TankPhore(HIDDEN, BLOCKS)
    jstate, tx = jtank.create_tank_train_state(jmodel, jb, seed=0, lr=lr)
    affinity = np.asarray([0.5, -1.0], np.float32)
    kw = dict(consider_affinity=True, pred_dis=True)
    step = jax.jit(jtank.make_tank_train_step(jmodel, tx, 0.999, **kw))
    new_jstate, jm = step(jstate, jb, jax.random.PRNGKey(0), jnp.asarray(affinity))

    def jloss(params):
        dis_map, contact, mask = jtank.dis_map_targets(jb)
        y, a = jmodel.apply({"params": params}, jb, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return jtank.tank_loss(y, a, dis_map, contact, mask, jnp.asarray(affinity), **kw)["loss"]

    jgrads = jax.grad(jloss)(jstate.params)
    model = TankPhore(HIDDEN, BLOCKS)
    model.load_state_dict(checkpoints.convert_variables(
        {"params": jax.tree_util.tree_map(np.asarray, dict(jstate.params))}, model), strict=True)
    # the gradients first, on a copy of the same weights
    probe = TankPhore(HIDDEN, BLOCKS)
    probe.load_state_dict(model.state_dict())
    dis_map, contact, mask = ttank.dis_map_targets(tb)
    y, a = probe.train()(tb)
    ttank.tank_loss(y, a, dis_map, contact, mask, T(affinity), **kw)["loss"].backward()
    want = port_leaves(jgrads, probe)
    floor = 1e-6 * max(float(v.abs().max()) for v in want.values())
    for name, p in probe.named_parameters():
        scale = float(want[name].abs().max())
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-4 * scale + floor, f"grad {name}: {err:.3e} of {scale:.3e}"

    state = ttank.create_tank_train_state(model=model, lr=lr, device="cpu")
    state, m = ttank.make_tank_train_step(0.999, **kw)(state, tb, T(affinity))
    assert_close(m["loss"], jm["loss"], 1e-5, "loss")
    assert float(m["grad_finite"]) == 1.0 and state.step == 1
    new_params = port_leaves(new_jstate.params, model)
    new_ema = port_leaves(new_jstate.ema_params, model)
    for name, p in model.named_parameters():
        clear = (want[name].abs() > 1e-3 * float(want[name].abs().max()) + floor)
        assert torch.allclose(p.detach()[clear], new_params[name][clear], rtol=0, atol=1e-6), name
        assert float((p.detach() - new_params[name]).abs().max()) <= 2 * lr, name
        assert float((state.ema_params[name] - new_ema[name]).abs().max()) <= 2e-3 * lr, name


def test_non_finite_loss_zeroes_the_update():
    _, tb = load_pair_batch(cached_files(n=2))
    state = ttank.create_tank_train_state(HIDDEN, BLOCKS, seed=1, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, m = ttank.make_tank_train_step()(state, tb, torch.tensor([float("nan"), 0.0]))
    assert float(m["grad_finite"]) == 0.0 and state.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_eval_step_matches_jax():
    jb, tb = load_pair_batch(cached_files(n=2))
    jmodel = jt.TankPhore(HIDDEN, BLOCKS)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jb)
    affinity = np.asarray([1.0, 2.0], np.float32)
    for kw in (dict(pred_dis=True), dict(pred_dis=False, consider_affinity=False)):
        ref = jtank.make_tank_eval_step(jmodel, **kw)(variables, jb, jnp.asarray(affinity))
        model = TankPhore(HIDDEN, BLOCKS)
        model.load_state_dict(checkpoints.convert_variables(
            jax.tree_util.tree_map(np.asarray, dict(variables)), model), strict=True)
        got = ttank.make_tank_eval_step(**kw)(model, tb, T(affinity))
        for k in ("loss", "contact_loss", "affinity_loss"):
            assert_close(got[k], ref[k], 1e-5, k)


def test_tank_pose_metrics_with_injected_initializations():
    """Two rows featurized from files (EX01 and the phore perceived from it),
    the same initializations the JAX metrics draw from their key."""
    jm, tm = _molecules()
    path = os.path.join(EXAMPLES, "example.phore")
    jp, tp = jphore.parse_phore(path)[0], tphore.parse_phore(path)[0]
    jb = jgraphs.concat_batches([jgraphs.build_complex("ex", jm, jp)] * 2).replace(
        names=(), meta=())
    jb = jax.tree_util.tree_map(jnp.asarray, jb)
    tb = tgraphs.concat_batches([tgraphs.build_complex("ex", tm, tp)] * 2)
    jmodel = jt.TankPhore(HIDDEN, BLOCKS)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jb)
    key, n_init, steps = jax.random.PRNGKey(4), 2, 120
    real_recover = jcr.recover_coords
    jcr.recover_coords = lambda *a, **k: real_recover(*a, **{**k, "steps": steps})
    try:
        ref = jtank.tank_pose_metrics(jmodel, variables, jb, [jm, jm], key, n_init=n_init)
    finally:
        jcr.recover_coords = real_recover
    inits, k = [], key
    A = jb.lig_pos.shape[1]
    for g in range(2):
        k, sub = jax.random.split(k)
        center = np.asarray(jb.phore_pos[g]).mean(0)
        inits.append(T((center + 4.0 * np.asarray(jax.random.normal(sub, (n_init, A, 3))))
                       .astype(np.float32)))
    model = TankPhore(HIDDEN, BLOCKS)
    model.load_state_dict(checkpoints.convert_variables(
        jax.tree_util.tree_map(np.asarray, dict(variables)), model), strict=True)
    got = ttank.tank_pose_metrics(model, tb, [tm, tm], n_init=n_init, steps=steps, inits=inits)
    np.testing.assert_allclose(got["rmsds"], ref["rmsds"], atol=1e-3)
    assert got["rmsds_lt2"] == ref["rmsds_lt2"] and got["rmsds_lt5"] == ref["rmsds_lt5"]


@pytest.fixture(scope="module")
def tank_run(tmp_path_factory):
    """One epoch of the tank trainer over 4 cached training complexes and 2
    validation ones."""
    root = tmp_path_factory.mktemp("tank")
    files = cached_files(n=6)
    for sub, chunk in (("train_t", files[:4]), ("val_t", files[4:])):
        os.makedirs(root / sub)
        for f in chunk:
            shutil.copy(f, root / sub)
    out = str(root / "run")
    counts = (tp_fused.KERNEL.launches, tp_aggregate.FWD.launches, tp_scalar.FWD.launches)
    tcli.main(["--cache_path", str(root), "--run_dir", out, "--n_epochs", "1", *TANK_FLAGS])
    assert (tp_fused.KERNEL.launches, tp_aggregate.FWD.launches,
            tp_scalar.FWD.launches) == counts
    return out


def test_tank_trainer_writes_records_and_checkpoints_jax_restores_strictly(tank_run):
    import json

    with open(os.path.join(tank_run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["mode"] for r in recs] == ["tank", "tank_val"]
    assert recs[0]["steps"] == 2 and np.isfinite(recs[0]["loss"]) and recs[0]["grad_finite"] == 1
    assert np.isfinite(recs[1]["loss"]) and "contact_loss" in recs[1]
    settings, model = checkpoints.load_tank_dir(tank_run, device="cpu")
    assert (settings["tank_hidden_dim"], settings["tank_blocks"]) == (HIDDEN, BLOCKS)
    _, last = checkpoints.load_tank_dir(tank_run, device="cpu", checkpoint=checkpoints.LAST_MODEL,
                                        use_ema=True)
    for (k, a), b in zip(model.state_dict().items(), last.state_dict().values()):
        assert torch.equal(a, b), k

    jb, tb = load_pair_batch(cached_files(n=2))
    jmodel = jt.TankPhore(HIDDEN, BLOCKS)
    template = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb)
    template = {"params": template["params"], "batch_stats": {}}
    with open(os.path.join(tank_run, checkpoints.BEST_EMA_MODEL), "rb") as f:
        raw = f.read()
    shapes = lambda tree: {p: np.shape(v) for p, v in flax_msgpack.flatten(tree)}
    assert shapes(serialization.msgpack_restore(raw)) == shapes(
        jax.tree_util.tree_map(np.asarray, template))
    variables = serialization.from_bytes(template, raw)
    ref = jax.jit(jmodel.apply)(variables, jb)
    with torch.no_grad():
        got = model(tb)
    for g, r in zip(got, ref):
        assert_close(g, r, 1e-5, "reloaded tank model")


def test_tank_restart_and_flags(tank_run, tmp_path):
    args = tcli.parse_args(TANK_FLAGS + ["--no_affinity", "--contact_as_class"])
    assert (args.no_affinity, args.contact_as_class) == (True, True)
    with pytest.raises(SystemExit, match="diff-model"):
        tcli.main(TANK_FLAGS + ["--confidence_mode", "--run_dir", str(tmp_path / "r")])


def test_trainers_parse_the_same_defaults():
    """Every flag both trainers define parses to the same default, the tank
    flags included; the port adds --device."""
    j, t = vars(jcli.parse_args([])), vars(tcli.parse_args([]))
    assert set(t) - set(j) == {"device"} and set(j) <= set(t)
    tank = ("model_type", "tank_hidden_dim", "tank_blocks", "no_affinity", "contact_as_class",
            "contact_weight", "affinity_weight", "pose_weight")
    assert all(k in t for k in tank)
    differ = {k for k in j if j[k] != t[k]}
    assert differ == {"run_dir"}, differ          # each package's own default run directory
