"""The port's score model against the JAX package on cached complexes:
a small config with converted flax-init weights, the full-width corpus2
checkpoint (both at compute_dtype float32 on the JAX side; the port's convs
are always f32), the exact pose-group factoring, and the port's own SE(3)
equivariance."""

import numpy as np
import torch
from scipy.spatial.transform import Rotation

import jax

from diffphore_tpu.models.score_model import ScoreModel as JScoreModel

from torch_port_helpers import (SMALL, assert_close, cached_files, configs, corpus2, load_pair,
                                port_model, randomize_stats)

torch.set_num_threads(2)

# f32 on both sides, summation orders differ; relative to max(|ref|, 1)
RTOL = 1e-4


def _small(seed, jb, **overrides):
    """(JAX model, variables with random running stats, port model) of the
    small config; the flax init is jitted (eager init takes a minute)."""
    jcfg, tcfg = configs(**{**SMALL, **overrides})
    jmodel = JScoreModel(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jb)
    variables = randomize_stats(variables, seed=seed)
    return jmodel, variables, port_model(tcfg, variables)


def test_small_config_matches_jax():
    jb, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.7, 0.3])
    jmodel, variables, model = _small(0, jb)
    ref = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, jb)
    with torch.no_grad():
        got = model(tb)
    for name, g, r in zip(("tr", "rot", "tor"), got, ref):
        assert_close(g, r, RTOL, name)


def test_pose_group_factoring_matches_jax_and_is_exact():
    jb, tb = load_pair(cached_files(n=1)[0], rows=3, t=[0.4, 0.4, 0.4])
    # poses differ: move each row's ligand
    shift = np.asarray([[0, 0, 0], [0.5, -0.2, 0.1], [-1.0, 0.3, 0.4]], np.float32)[:, None]
    jb = jb.replace(lig_pos=jb.lig_pos + shift)
    tb = tb.replace(lig_pos=tb.lig_pos + torch.from_numpy(shift))
    jmodel, variables, model = _small(1, jb)
    ref = jax.jit(lambda v, b: jmodel.apply(v, b, pose_group=3))(variables, jb)
    with torch.no_grad():
        grouped = model(tb, pose_group=3)
        plain = model(tb, pose_group=1)
    for name, g, p, r in zip(("tr", "rot", "tor"), grouped, plain, ref):
        assert_close(g, r, RTOL, name)
        assert_close(g, p.numpy(), 1e-6, f"{name} factoring")


def test_corpus2_full_width_matches_jax():
    """The shipped checkpoint (ns=20, nv=10, 4 layers), one forward, B=2."""
    jcfg, variables, tcfg, model = corpus2()
    jb, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.7, 0.3])
    ref = jax.jit(lambda v, b: JScoreModel(jcfg).apply(v, b))(variables, jb)
    with torch.no_grad():
        got = model(tb)
    for name, g, r in zip(("tr", "rot", "tor"), got, ref):
        assert_close(g, r, RTOL, name)
    assert float(got[2].abs().max()) > 0  # torsion scores are live


def test_port_se3_equivariance():
    """Rotating and translating the complex co-rotates tr/rot and leaves the
    torsion scores unchanged (port only, corpus2 weights).

    The ligand is first moved off its cached pose: these synthetic
    complexes take their phore from the ligand's own pose, so at that pose
    ligand and phore norms are parallel, their cross product (the norm
    channel's rotation axis) is rounding noise, and no model co-rotates it.
    The JAX package behaves the same."""
    _, _, _, model = corpus2()
    _, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.6, 0.2])
    rot = lambda seed: torch.from_numpy(
        Rotation.random(random_state=seed).as_matrix().astype(np.float32))
    Q, R = rot(5), rot(11)
    tb = tb.replace(lig_pos=tb.lig_pos @ Q.T + torch.tensor([0.3, -0.4, 0.2]),
                    lig_norm=tb.lig_norm @ Q.T)
    shift = torch.tensor([1.5, -2.0, 0.7])
    moved = tb.replace(lig_pos=tb.lig_pos @ R.T + shift, phore_pos=tb.phore_pos @ R.T + shift,
                       phore_norm=tb.phore_norm @ R.T, lig_norm=tb.lig_norm @ R.T)
    with torch.no_grad():
        tr, rot_s, tor = model(tb)
        tr2, rot2, tor2 = model(moved)
    assert float(tr.abs().max()) > 0 and float(tor.abs().max()) > 0
    assert_close(tr2, (tr @ R.T).numpy(), 1e-4, "tr co-rotates")
    assert_close(rot2, (rot_s @ R.T).numpy(), 1e-4, "rot co-rotates")
    assert_close(tor2, tor.numpy(), 1e-4, "tor invariant")
