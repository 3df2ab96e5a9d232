"""Shared fixtures-in-functions for the tests that hold the PyTorch port
(``diffphore_torch``) against the JAX package on the same inputs.

Inputs pass between the two as numpy arrays.  The port cannot replay
``jax.random``, so the helpers here draw the JAX sampler's noise from a key
exactly as the JAX code does and hand the same numbers to the port.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from diffphore_torch.data import graphs as tgraphs
from diffphore_torch.models.score_model import ScoreModel as TScoreModel
from diffphore_torch.models.score_model import ScoreModelConfig as TConfig
from diffphore_torch.sampler.sampling import PriorNoise, StepNoise
from diffphore_torch.utils.checkpoints import convert_variables
from diffphore_tpu.data.dataset import load_complex
from diffphore_tpu.models.score_model import ScoreModelConfig as JConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, "data", "cache", "val_f1112e7d33")
CORPUS2 = os.path.join(REPO, "runs", "corpus2", "main")

#: a small model: 2 conv layers, narrow widths, f32 convs
SMALL = dict(ns=8, nv=4, num_conv_layers=2, dropout=0.0, compute_dtype="float32")
#: the same with bf16 convs, as every shipped config computes them
SMALL_BF16 = dict(SMALL, compute_dtype="bfloat16")


def cached_files(bucket: Tuple[int, int, int] = (24, 96, 8), n: int = 2) -> List[str]:
    """The first n cached complexes of one (A, P, T) bucket."""
    out = []
    for f in sorted(glob.glob(os.path.join(CACHE, "*.npz"))):
        with np.load(f) as z:
            shape = (z["lig_pos"].shape[1], z["phore_pos"].shape[1], z["tor_edges"].shape[1])
        if shape == bucket:
            out.append(f)
        if len(out) == n:
            break
    return out


def load_pair(path: str, rows: int = 1, t=None):
    """(JAX batch, port batch) of one cached complex repeated over rows."""
    from diffphore_tpu.data.graphs import repeat_batch

    jb = repeat_batch(load_complex(path), rows).replace(names=(), meta=())
    tb = tgraphs.repeat_batch(tgraphs.load_cached(path), rows)
    if t is not None:
        t = np.asarray(t, np.float32)
        jb = jb.replace(t=t)
        tb = tb.replace(t=torch.from_numpy(t.copy()))
    return jax.tree_util.tree_map(jnp.asarray, jb), tb


def to_port(jb):
    """A JAX ComplexBatch (any array type) as a port batch."""
    return tgraphs.from_numpy({f: np.asarray(getattr(jb, f)) for f in tgraphs.ARRAY_FIELDS})


def configs(**overrides):
    """(JAX config, port config) with the same fields."""
    jcfg = JConfig(**overrides)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def corpus2(compute_dtype: str = "float32"):
    """(JAX config, JAX variables, port config, port model) of the shipped
    corpus2 checkpoint, both configs at ``compute_dtype`` (the checkpoint's
    own is bfloat16)."""
    from diffphore_tpu.utils.checkpoints import load_config_yaml

    jcfg = dataclasses.replace(load_config_yaml(CORPUS2), compute_dtype=compute_dtype)
    with open(os.path.join(CORPUS2, "best_ema_inference_epoch_model.msgpack"), "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    return jcfg, variables, tcfg, port_model(tcfg, variables)


def confidence_pair(run_dir: str, compute_dtype: str = "float32"):
    """(JAX config, JAX variables, port config, port ConfidenceModel) of a
    shipped confidence head (``runs/corpus2/confidence``,
    ``runs/corpus/confidence_rmsd``), both configs at ``compute_dtype``."""
    from diffphore_torch.models.confidence import ConfidenceModel
    from diffphore_tpu.utils.checkpoints import load_config_yaml

    jcfg = dataclasses.replace(load_config_yaml(run_dir), compute_dtype=compute_dtype)
    with open(os.path.join(run_dir, "best_ema_inference_epoch_model.msgpack"), "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    return jcfg, variables, tcfg, port_model(tcfg, variables, ConfidenceModel)


def port_model(tcfg, variables, kind=TScoreModel):
    model = kind(tcfg)
    model.load_state_dict(convert_variables(jax.tree_util.tree_map(np.asarray, dict(variables)),
                                            model), strict=True)
    return model.eval()


def randomize_stats(variables, seed: int = 0):
    """Replace identity batch-norm running stats with random, well-scaled
    ones (an untrained model's identity stats let activations compound)."""
    rng = np.random.default_rng(seed)

    def one(path, x):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.normal(0.0, 0.3, x.shape), jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 4.0, x.shape), jnp.float32)

    stats = jax.tree_util.tree_map_with_path(one, variables["batch_stats"])
    return {**variables, "batch_stats": stats}


def prior_noise(key, B: int, T: int) -> PriorNoise:
    """The draws of diffphore_tpu.sampler.randomize_position(batch, key)."""
    k_tor, k_rot, k_tr = jax.random.split(key, 3)
    tor = jax.random.uniform(k_tor, (B, T), minval=-jnp.pi, maxval=jnp.pi)
    quat = jax.random.normal(k_rot, (B, 4))
    tr = jax.random.normal(k_tr, (B, 3))
    t = lambda x: torch.from_numpy(np.asarray(x).copy())
    return PriorNoise(tor=t(tor), quat=t(quat), tr=t(tr))


def step_noise(key, steps: int, B: int, T: int, S: int = 1) -> StepNoise:
    """The per-step draws of diffphore_tpu reverse_diffusion(..., key, ...)
    with ``random_samples`` = S, as (steps, S, B, .)."""
    zs = {"tr": [], "rot": [], "tor": []}
    for k in jax.random.split(key, steps):
        k_tr, k_rot, k_tor = jax.random.split(k, 3)
        zs["tr"].append(np.asarray(jax.random.normal(k_tr, (S, B, 3))))
        zs["rot"].append(np.asarray(jax.random.normal(k_rot, (S, B, 3))))
        zs["tor"].append(np.asarray(jax.random.normal(k_tor, (S, B, T))))
    t = lambda v: torch.from_numpy(np.stack(v))
    return StepNoise(z_tr=t(zs["tr"]), z_rot=t(zs["rot"]), z_tor=t(zs["tor"]))


def sample_step_noise(key, B: int, T: int) -> StepNoise:
    """The draws of diffphore_tpu.sampler.sample_step(..., key, ...): one
    step, one candidate."""
    k_tr, k_rot, k_tor = jax.random.split(key, 3)
    t = lambda k, n: torch.from_numpy(np.asarray(jax.random.normal(k, (B, n))).copy())[None, None]
    return StepNoise(z_tr=t(k_tr, 3), z_rot=t(k_rot, 3), z_tor=t(k_tor, T))


def assert_close(port, ref, rtol: float, what: str = ""):
    """|port - ref| <= rtol * max(|ref|, 1) elementwise-max."""
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= rtol * scale, f"{what}: max |port - ref| {err:.3e} > {rtol} * {scale:.3e}"


def assert_within_gap(port: dict, ref: dict, ref32: dict, frac: float, what: str = "",
                      norm: str = "max"):
    """The port's arrays against the JAX package's at bf16 (``ref``), as a
    fraction ``frac`` of the difference between the JAX package at f32
    (``ref32``) and at bf16 on the same inputs.

    ``norm="max"``: the largest elementwise difference, each array relative
    to its own scale (with a floor of 1e-3 of the largest scale, for arrays
    that hold only rounding noise).  ``norm="l2"``: the arrays as one
    vector (a gradient of one loss over all parameter leaves), the L2 norm
    of the difference.  Returns the f32-vs-bf16 difference."""
    arr = lambda v: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                               np.float64)
    ref = {k: arr(v) for k, v in ref.items() if np.size(v)}
    if norm == "l2":
        flat = lambda d: np.concatenate([arr(d[k]).ravel() for k in ref])
        p, r, r32 = flat(port), flat(ref), flat(ref32)
        err, gap = np.linalg.norm(p - r), np.linalg.norm(r32 - r)
        assert err <= frac * gap, (f"{what}: |port - JAX bf16| {err:.3e} > {frac} x "
                                   f"|JAX f32 - JAX bf16| {gap:.3e} (L2, |JAX bf16| "
                                   f"{np.linalg.norm(r):.3e})")
        return gap / np.linalg.norm(r)
    top = max(float(np.abs(r).max()) for r in ref.values())
    err = gap = 0.0
    worst = ""
    for name, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-3 * top, 1e-30)
        p = arr(port[name])
        assert p.shape == r.shape, (what, name, p.shape, r.shape)
        e = float(np.abs(p - r).max()) / scale
        gap = max(gap, float(np.abs(arr(ref32[name]) - r).max()) / scale)
        if e > err:
            err, worst = e, name
    assert err <= frac * gap, (f"{what}: port vs JAX bf16 {err:.3e} ({worst}) > {frac} x "
                               f"JAX f32 vs bf16 {gap:.3e}")
    return gap


def noise_draws(key, B: int, T: int, reject: bool = False):
    """The draws of diffphore_tpu.data.transforms.apply_noise(batch, key, ...),
    raw (before the sigmas scale them), as the port's NoiseDraws."""
    from diffphore_torch.data.transforms import MAX_REJECT_TRIES, NoiseDraws

    K = MAX_REJECT_TRIES if reject else 1
    k_t, k_tr, k_rot, k_tor, k_rej = jax.random.split(key, 5)
    k_axis, k_angle = jax.random.split(k_rot)          # so3.sample_vec's split
    t = lambda x: torch.from_numpy(np.asarray(x).copy())
    return NoiseDraws(
        t=t(jax.random.uniform(k_t, (B,))),
        z_tr=t(jax.random.normal(k_tr, (K, B, 3))),
        rot_axis=t(jax.random.normal(k_axis, (K, B, 3))),
        rot_u=t(jax.random.uniform(k_angle, (K, B))),
        z_tor=t(jax.random.normal(k_tor, (K, B, T))),
        reject_u=t(jax.random.uniform(k_rej, (2, K, B))) if reject else None)


def cc_draws(key, B: int, T: int):
    """The draws of diffphore_tpu.train.ccsampler.ccsampler_apply_noise(batch,
    key, ...), raw, as the port's CCDraws."""
    from diffphore_torch.data.transforms import NoiseDraws
    from diffphore_torch.train.ccsampler import CCDraws

    k_t, k_tr, k_rot, k_tor, k_step, k_sel = jax.random.split(key, 6)
    k_axis, k_angle = jax.random.split(k_rot)          # so3.sample_vec's split
    t = lambda x: torch.from_numpy(np.asarray(x).copy())
    noise = NoiseDraws(
        t=t(jax.random.uniform(k_t, (B,))),
        z_tr=t(jax.random.normal(k_tr, (B, 3)))[None],
        rot_axis=t(jax.random.normal(k_axis, (B, 3)))[None],
        rot_u=t(jax.random.uniform(k_angle, (B,)))[None],
        z_tor=t(jax.random.normal(k_tor, (B, T)))[None])
    return CCDraws(noise=noise, step=sample_step_noise(k_step, B, T),
                   select_u=t(jax.random.uniform(k_sel, (B,))))


def cc_train_step_draws(key, B: int, T: int):
    """The draws of one diffphore_tpu.train.ccsampler train step called with
    ``key`` (it splits off the dropout key first)."""
    k_noise, _ = jax.random.split(key)
    return cc_draws(k_noise, B, T)


def train_step_draws(key, B: int, T: int, reject: bool = False):
    """The noise of one diffphore_tpu.train.state train step called with
    ``key`` (it splits off the dropout key first)."""
    k_noise, _ = jax.random.split(key)
    return noise_draws(k_noise, B, T, reject)


def port_leaves(tree, model=None) -> dict:
    """A flax params (or gradient, or EMA) tree as {port parameter name:
    tensor}, in the port's orientation; pass the port ``model`` for a tree
    of fully connected convs (see ``convert_variables``)."""
    return convert_variables({"params": jax.tree_util.tree_map(np.asarray, dict(tree))}, model)


def port_train_state(jstate, tcfg, lr: float = 1e-3, weight_decay: float = 0.0):
    """A JAX TrainState's params and batch stats as a port TrainState (CPU)."""
    from diffphore_torch.train.state import create_train_state

    model = port_model(tcfg, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    return create_train_state(tcfg, lr=lr, weight_decay=weight_decay, device="cpu", model=model)


def load_pair_batch(paths):
    """(JAX batch, port batch) of several cached complexes of one bucket."""
    from diffphore_tpu.data.graphs import concat_batches

    jb = concat_batches([load_complex(p) for p in paths]).replace(names=(), meta=())
    tb = tgraphs.concat_batches([tgraphs.load_cached(p) for p in paths])
    return jax.tree_util.tree_map(jnp.asarray, jb), tb.replace(names=(), meta=())


def noised_pair(t, seed: int, n: int = 2):
    """(JAX batch, port batch) of the first n cached complexes of bucket
    24 x 96 x 8 at noise levels ``t``, noised by the port with injected
    draws: the cached pose makes ligand and phore norms parallel, and the
    norm channel's rotation axis, their cross product, is rounding noise
    there."""
    from diffphore_torch.data.transforms import apply_noise
    from diffphore_torch.ops.diffusion import SigmaSchedule

    jb, tb = load_pair_batch(cached_files(n=n))
    draws = noise_draws(jax.random.PRNGKey(seed), tb.batch_size, tb.num_torsions)
    draws.t = torch.tensor(t, dtype=torch.float32)
    tb, _ = apply_noise(tb, SigmaSchedule(), draws=draws)
    jb = jb.replace(**{f: jnp.asarray(getattr(tb, f).numpy()) for f in tgraphs.ARRAY_FIELDS})
    return jb, tb
