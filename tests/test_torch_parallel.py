"""The port's data parallelism (``diffphore_torch.parallel.mesh`` and the
steps built with a ``DataShard``) against the JAX package's sharded step on
a 2-device virtual mesh, and against itself in one process.

Two gloo ranks on the CPU (spawned processes, a free port) run the plain,
the rejection and the calibrated-sampler train step three times each on a
global batch of 4 cached complexes (24 x 96 x 8) whose last row is repeat
padding, with the draws of each step derived from a key as the JAX code
derives them; the JAX package runs ``shard_train_step`` on
``make_mesh(jax.devices()[:2])`` with the same weights and keys.  A small
model (ns=4, nv=2, 2 conv layers, dropout 0, f32 convs) with randomized
batch-norm running statistics (the calibrated step's reverse step reads
them).  Tolerances, all f32, |port - JAX| <= RTOL * max(|JAX|, 1):

* metrics after steps 1 and 3, the running statistics and the EMA shadow
  after steps 1 and 3: 1e-5;
* the first step's gradients, every leaf: 1e-5 of the gradient's largest
  element over all leaves (the JAX gradient is its first Adam moment over
  1 - beta1).  Per leaf the two frameworks differ by up to 2e-5 of a small
  leaf's own scale (tests/test_torch_train_state.py), rounding noise far
  below the gradient's scale;
* the per-graph values of the sharded eval step, in row order: 1e-5.

Port against port: with two ranks the metrics, gradients and running
statistics of every step equal one process's on the whole batch to 1e-5 as
above (summation order only; measured 1.1e-6 of the largest gradient); the
replicas hold the same parameters, bit for bit; one rank in a group of its
own gives one process's results bit for bit; a non-finite row on one rank
makes every rank skip the step.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.models.score_model import ScoreModel, init_parameters
from diffphore_torch.parallel import mesh as tmesh
from diffphore_torch.utils.checkpoints import variables_from_tensors
from diffphore_tpu.parallel import mesh as jmesh
from diffphore_tpu.train import ccsampler as jcc
from diffphore_tpu.train import state as jstate

import torch_parallel_ranks as ranks
from torch_port_helpers import (REPO, cached_files, cc_train_step_draws, configs,
                                load_pair_batch, noise_draws, port_leaves, train_step_draws)

torch.set_num_threads(2)
SMALL = dict(ns=4, nv=2, num_conv_layers=2, dropout=0.0, compute_dtype="float32")
WORLD = 2
RTOL = 1e-5
KEYS = [jax.random.PRNGKey(40 + i) for i in range(ranks.STEPS)]
EVAL_KEY = jax.random.PRNGKey(77)


def _global_batch():
    """(JAX batch, port batch) of 4 cached complexes; the last row repeats
    the first and is padding."""
    files = cached_files(n=3)
    jb, tb = load_pair_batch(files + files[:1])
    valid = np.array([True, True, True, False])
    return jb.replace(valid=jnp.asarray(valid)), tb.replace(valid=torch.from_numpy(valid))


def _model(tcfg):
    model = init_parameters(ScoreModel(tcfg), 0)
    rng = np.random.default_rng(1)
    with torch.no_grad():       # well-scaled running statistics for the eval-mode forward
        for name, b in model.named_buffers():
            if name.endswith(".mean"):
                b.copy_(torch.from_numpy(rng.normal(0.0, 0.3, b.shape).astype(np.float32)))
            else:
                b.copy_(torch.from_numpy(rng.uniform(0.5, 4.0, b.shape).astype(np.float32)))
    return model


def _jax_state(model, tx):
    params = jax.tree_util.tree_map(
        jnp.asarray, variables_from_tensors(model, dict(model.named_parameters())))
    stats = jax.tree_util.tree_map(
        jnp.asarray, variables_from_tensors(model, dict(model.named_buffers())))
    return jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                             opt_state=tx.init(params), ema_params=params)


def _first_moment(opt_state):
    """Adam's first moment from an optax state."""
    found = []

    def visit(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node.mu)
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)

    visit(opt_state)
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, the ranks' outputs, one process's outputs, the JAX outputs)."""
    tmp = tmp_path_factory.mktemp("dp")
    jcfg, tcfg = configs(**SMALL)
    model = _model(tcfg)
    jb, tb = _global_batch()
    B, T = tb.batch_size, tb.num_torsions
    nan_batch = tb.replace(phore_pos=tb.phore_pos.clone())
    nan_batch.phore_pos[B - 2, 0, 0] = float("nan")        # a row of the last rank
    inputs = {
        "cfg": tcfg, "model_state": model.state_dict(), "batch": tb, "nan_batch": nan_batch,
        "draws": {"plain": [train_step_draws(k, B, T) for k in KEYS],
                  "reject": [train_step_draws(k, B, T, reject=True) for k in KEYS],
                  "cc": [cc_train_step_draws(k, B, T) for k in KEYS]},
        "eval_draws": noise_draws(EVAL_KEY, B, T),
    }
    in_path = str(tmp / "inputs.pt")
    torch.save(inputs, in_path)
    ctx = torch.multiprocessing.get_context("spawn")
    port = tmesh.free_port()
    procs = [ctx.Process(target=ranks.rank_main, args=(r, WORLD, port, in_path, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # meanwhile: one process on the whole batch, and the JAX package
        single = {kind: ranks.run_steps(inputs, kind, prob, None) for kind, prob in ranks.KINDS}
        single["nan"] = ranks.run_steps(inputs, "plain", 0.0, None, nan_batch)[:1]
        single["eval"] = ranks.tstate.make_eval_step(tcfg)(
            ranks.fresh_state(tcfg, inputs["model_state"]).model, tb, None,
            inputs["eval_draws"])

        tx = jstate.make_optimizer(ranks.LR)
        mesh = jmesh.make_mesh(jax.devices()[:WORLD])
        jbs = jmesh.shard_batch(jb, mesh)
        steps = {"plain": jstate.make_train_step(jcfg, tx),
                 "reject": jstate.make_train_step(jcfg, tx, reject=True),
                 "cc": jcc.make_ccsampler_train_step(jcfg, tx)}
        start = jax.device_put(_jax_state(model, tx), jmesh.replicated(mesh))
        lowered = {kind: jmesh.shard_train_step(steps[kind], mesh, n_extra=1).lower(
            start, jbs, KEYS[0], np.float32(prob)) for kind, prob in ranks.KINDS}
        lowered["eval"] = jmesh.shard_eval_step(jstate.make_eval_step(jcfg), mesh).lower(
            start.variables, jbs, EVAL_KEY)
        # XLA compiles outside the GIL: the four compiles overlap
        with ThreadPoolExecutor(len(lowered)) as pool:
            compiled = dict(zip(lowered, pool.map(lambda low: low.compile(), lowered.values())))
        jax_out = {}
        for kind, prob in ranks.KINDS:
            js, seen = start, []
            for key in KEYS:
                js, jm = compiled[kind](js, jbs, key, np.float32(prob))
                seen.append({"metrics": jax.device_get(jm), "stats": port_leaves_stats(js),
                             "ema": port_leaves(jax.device_get(js.ema_params)),
                             "mu": port_leaves(jax.device_get(_first_moment(js.opt_state)))})
            jax_out[kind] = seen
        jax_out["eval"] = jax.device_get(compiled["eval"](start.variables, jbs, EVAL_KEY))
    finally:
        for p in procs:
            p.join(timeout=300)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    outs = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return inputs, outs, single, jax_out


def port_leaves_stats(js):
    from diffphore_torch.utils.checkpoints import convert_variables

    return convert_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, dict(jax.device_get(js.batch_stats)))})


def _close(got, want, rtol, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} * {scale:.3e}"


@pytest.mark.parametrize("kind", [k for k, _ in ranks.KINDS])
def test_two_ranks_match_the_jax_sharded_step(run, kind):
    """Loss and metrics, running statistics and EMA after steps 1 and 3,
    and the first step's gradients, on both ranks."""
    _, outs, _, jax_out = run
    beta1 = 0.9
    for out in outs:
        for i in (0, ranks.STEPS - 1):
            got, want = out[kind][i], jax_out[kind][i]
            for k in ("loss", "tr_loss", "rot_loss", "tor_loss", "tr_base_loss",
                      "rot_base_loss", "tor_base_loss", "grad_finite"):
                _close(got["metrics"][k], want["metrics"][k], RTOL, f"{kind} step {i} {k}")
            if kind == "cc":
                # the JAX step does not report the share of calibrated graphs
                assert 0.0 <= float(got["metrics"]["cc_share"]) <= 1.0
            assert set(got["stats"]) == set(want["stats"])
            for name, v in want["stats"].items():
                _close(got["stats"][name], v, RTOL, f"{kind} step {i} stats {name}")
            for name, v in want["ema"].items():
                _close(got["ema"][name], v, RTOL, f"{kind} step {i} ema {name}")
        grads = {k: v / (1 - beta1) for k, v in jax_out[kind][0]["mu"].items()}
        top = max(float(g.abs().max()) for g in grads.values() if g.numel())
        for name, g in grads.items():
            err = float((out[kind][0]["grads"][name] - g).abs().max()) if g.numel() else 0.0
            assert err <= RTOL * top, f"{kind} grad {name}: {err:.3e} > {RTOL} * {top:.3e}"


@pytest.mark.parametrize("kind", [k for k, _ in ranks.KINDS])
def test_two_ranks_equal_one_process(run, kind):
    """Every step's metrics and summed gradients equal one process's on the
    whole (padded) batch; the two replicas stay identical to the bit."""
    _, outs, single, _ = run
    for i in range(ranks.STEPS):
        want = single[kind][i]
        for out in outs:
            got = out[kind][i]
            for k, v in want["metrics"].items():
                _close(got["metrics"][k], v, RTOL, f"{kind} step {i} {k}")
            top = max(float(g.abs().max()) for g in want["grads"].values() if g.numel())
            for name, g in want["grads"].items():
                err = float((got["grads"][name] - g).abs().max()) if g.numel() else 0.0
                assert err <= RTOL * top, f"{kind} step {i} grad {name}: {err:.3e}"
            for name, v in want["stats"].items():
                _close(got["stats"][name], v, RTOL, f"{kind} step {i} stats {name}")
        a, b = outs[0][kind][i], outs[1][kind][i]
        for part in ("params", "ema", "stats", "grads"):
            for name in a[part]:
                assert torch.equal(a[part][name], b[part][name]), (kind, i, part, name)


def test_the_sharded_eval_step_matches_jax_in_row_order(run):
    _, outs, single, jax_out = run
    for out in outs:
        for k, v in jax_out["eval"].items():
            assert out["eval"][k].shape == (4,)
            _close(out["eval"][k], v, RTOL, f"eval {k}")
            _close(out["eval"][k], single["eval"][k], RTOL, f"eval {k}, one process")


def test_one_rank_alone_gives_one_process_bit_for_bit(run):
    """Rank 0 in a group of its own against the steps built without a shard,
    in the same process."""
    _, outs, _, _ = run
    solo, alone = outs[0]["solo"], outs[0]["alone"]
    for kind, _ in ranks.KINDS:
        for i in range(ranks.STEPS):
            for part in ("metrics", "grads", "stats", "ema", "params"):
                for name, v in alone[kind][i][part].items():
                    assert torch.equal(solo[kind][i][part][name], v), (kind, i, part, name)
    for k, v in outs[0]["alone_eval"].items():
        assert torch.equal(outs[0]["solo_eval"][k], v), k


def test_a_non_finite_row_on_one_rank_stops_every_rank(run):
    """The NaN sits in the last rank's rows; the global loss is not finite,
    so both ranks zero the update (parameters unchanged on a fresh Adam) and
    report it, as one process does."""
    inputs, outs, single, _ = run
    start = {k: v for k, v in inputs["model_state"].items()}
    assert float(single["nan"][0]["metrics"]["grad_finite"]) == 0.0
    for out in outs:
        got = out["nan"][0]
        assert float(got["metrics"]["grad_finite"]) == 0.0
        assert not np.isfinite(float(got["metrics"]["loss"]))
        for name, p in got["params"].items():
            assert torch.equal(p, start[name]), name
            assert not bool(got["grads"][name].any()), name


def test_rows_and_records_are_striped_as_the_jax_package_stripes_them():
    records = [{"i": i} for i in range(11)]
    for count in (1, 2, 3, 4):
        for r in range(count):
            assert tmesh.shard_records(records, r, count) == jmesh.shard_records(records, r, count)
    assert tmesh.shard_records(records) == records          # one process: everything
    _, tb = _global_batch()
    parts = [tmesh.shard_rows(tb, r, 2) for r in range(2)]
    for name, v in tb.tensors().items():
        assert torch.equal(torch.cat([getattr(p, name) for p in parts]), v), name
    assert [p.batch_size for p in parts] == [2, 2]
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_rows(tb, 0, 3)
    assert tmesh.world() == 1 and tmesh.rank() == 0 and tmesh.is_main()


@pytest.fixture(scope="module")
def small_cache(tmp_path_factory):
    """5 training and 2 validation complexes of one bucket."""
    import shutil

    root = tmp_path_factory.mktemp("cache")
    files = cached_files(n=7)
    for sub, chunk in (("train_small", files[:5]), ("val_small", files[5:])):
        os.makedirs(root / sub)
        for f in chunk:
            shutil.copy(f, root / sub)
    return str(root)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_the_trainer_over_two_ranks_follows_one_process(small_cache, tmp_path):
    """``cli.train.main`` as two gloo ranks against one process, from the
    same seed, dropout on: the same batches, noise and dropout masks, so
    the same losses up to summation order carried through Adam (1e-4);
    rank 0 alone writes the run directory and validates by inference; a
    batch that does not split over the ranks stops the run."""
    from diffphore_torch.cli import train as tcli

    argv = ["--cache_path", small_cache, "--n_epochs", "2", "--ns", "4", "--nv", "2",
            "--num_conv_layers", "2", "--batch_size", "2", "--device", "cpu",
            "--val_inference_freq", "2", "--num_inference_complexes", "1",
            "--inference_steps", "2", "--inference_samples", "2", "--compute_dtype", "float32"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    tcli.main(argv + ["--run_dir", one])
    tmesh.launch(tcli.main, WORLD, argv + ["--run_dir", two])
    got, want = _records(two), _records(one)
    assert [r.get("mode") for r in got] == [r.get("mode") for r in want] == [
        None, "val", None, "val", None]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k in ("epoch_time",):
                continue
            if isinstance(v, float) and k != "lr":
                assert abs(g[k] - v) <= 1e-4 * max(abs(v), 1.0), (g.get("mode"), k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    with pytest.raises(SystemExit, match="batch_size must divide the device count"):
        tcli.train(tcli.parse_args(argv + ["--batch_size", "3"]), torch.device("cpu"),
                   tmesh.DataShard(0, WORLD))


def test_a_rank_that_fails_fails_the_launch():
    """No fallback: a rank that exits non-zero makes ``launch`` raise."""
    import sys

    with pytest.raises(torch.multiprocessing.ProcessExitedException, match="exit code 3"):
        tmesh.launch(sys.exit, WORLD, 3)


def test_ranks_read_caches_and_featurize_nothing(tmp_path):
    """A rank of a data-parallel run featurizes no raw record (it would wait
    in no collective for one that does): uncached records stop it before
    any collective, and after ``--featurize_only`` it reads the caches."""
    from diffphore_torch.cli import train as tcli

    examples = os.path.join(REPO, "examples")
    (tmp_path / "train.csv").write_text(
        "name,ligand_description,phore\n"
        + "".join(f"{n},{examples}/{n}.sdf,{examples}/example.phore\n" for n in ("EX01", "EX02")))
    (tmp_path / "val.csv").write_text(
        f"name,ligand_description,phore\nEX03,{examples}/EX03.sdf,{examples}/example.phore\n")
    argv = ["--train_csv", str(tmp_path / "train.csv"), "--val_csv", str(tmp_path / "val.csv"),
            "--cache_path", str(tmp_path / "cache"), "--run_dir", str(tmp_path / "run"),
            "--ns", "4", "--nv", "2", "--num_conv_layers", "2", "--batch_size", "2",
            "--device", "cpu", "--val_inference_freq", "0"]
    with pytest.raises(SystemExit, match="featurize them first"):
        tcli.train(tcli.parse_args(argv), torch.device("cpu"), tmesh.DataShard(1, WORLD))
    assert not [f for _, _, fs in os.walk(tmp_path / "cache") for f in fs]
    tcli.main(argv + ["--featurize_only"])
    train_ds, val_ds = tcli.build_datasets(tcli.parse_args(argv), featurize=False)
    assert (len(train_ds), len(val_ds), train_ds.featurized, val_ds.featurized) == (2, 1, 0, 0)
