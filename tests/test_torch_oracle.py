"""The oracle score function of the port (``sampler/oracle.py``) against the
JAX package's, and the port's reverse chain driven by it, on a complex
featurized from the repository's examples (EX01 at the phore perceived from
it, 8 poses).  As ``tests/test_oracle_sampler.py`` holds the JAX chain:
fed the analytic scores, the probability-flow ODE recovers a rigid pose
under 1 A and the SDE (torsions on, no final-step noise) puts at least 6 of
8 poses under 2 A.  Scores against JAX on the same pose within 1e-4 of
their scale; the same chain on both sides with the same noise within
1e-3 A."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.chem.sdf import read_molecule as t_read_molecule
from diffphore_torch.data import graphs as tgraphs
from diffphore_torch.data import phore as tphore
from diffphore_torch.data.transforms import apply_noise as t_apply_noise
from diffphore_torch.ops.diffusion import SigmaSchedule
from diffphore_torch.ops.torsion import apply_torsion_updates
from diffphore_torch.sampler import oracle as toracle
from diffphore_torch.sampler.sampling import (SamplerSettings, draw_prior, draw_steps,
                                              randomize_position, reverse_diffusion)
from diffphore_tpu.chem.sdf import read_molecule as j_read_molecule
from diffphore_tpu.data import graphs as jgraphs
from diffphore_tpu.data import phore as jphore
from diffphore_tpu.ops.diffusion import SigmaSchedule as JSigmaSchedule
from diffphore_tpu.sampler import randomize_position as j_randomize_position
from diffphore_tpu.sampler import reverse_diffusion as j_reverse_diffusion
from diffphore_tpu.sampler import oracle as joracle
from diffphore_tpu.sampler.sampling import SamplerSettings as JSamplerSettings

from torch_port_helpers import REPO, assert_close, noise_draws, prior_noise, step_noise

torch.set_num_threads(2)
EXAMPLES = os.path.join(REPO, "examples")
N_POSES = 8
SCHED, JSCHED = SigmaSchedule(), JSigmaSchedule()


def _pair(ligand="EX01.sdf"):
    """(JAX batch, port batch) of N_POSES rows of a ligand at the phore."""
    path = os.path.join(EXAMPLES, ligand)
    phore = os.path.join(EXAMPLES, "example.phore")
    jb = jgraphs.build_complex("x", j_read_molecule(path, remove_hs=True),
                               jphore.parse_phore(phore)[0])
    tb = tgraphs.build_complex("x", t_read_molecule(path, remove_hs=True),
                               tphore.parse_phore(phore)[0])
    jb = jgraphs.repeat_batch(jb, N_POSES).replace(names=(), meta=())
    return jax.tree_util.tree_map(jnp.asarray, jb), tgraphs.repeat_batch(tb, N_POSES)


def _rmsd(pos, true, mask):
    d2 = ((np.asarray(pos, np.float64) - np.asarray(true, np.float64)) ** 2).sum(-1)
    m = np.asarray(mask, np.float64)
    return np.sqrt((d2 * m).sum(-1) / m.sum(-1))


def test_dihedral_sign_convention():
    """A torsion update of +theta raises the measured dihedral by +theta."""
    _, tb = _pair()
    tm = tb.tor_mask[0].numpy()
    assert tm.sum() >= 3
    ra = torch.from_numpy(toracle.dihedral_reference_atoms(
        tb.bond_mask[0].numpy(), tb.tor_edges[0].numpy(), tm, tb.mask_rotate[0].numpy()))
    d0 = toracle.measure_dihedrals(tb.lig_pos[:1], tb.tor_edges[:1], ra[None])[0]
    upd = torch.where(tb.tor_mask[0], 0.3 + 0.1 * torch.arange(len(tm)), torch.zeros(len(tm)))
    p1, _ = apply_torsion_updates(tb.lig_pos[:1], tb.tor_edges[:1], tb.mask_rotate[:1],
                                  upd[None], tb.tor_mask[:1])
    d1 = toracle.measure_dihedrals(p1, tb.tor_edges[:1], ra[None])[0]
    delta = (d1 - d0 + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(delta.numpy()[tm], upd.numpy()[tm], atol=1e-4)


def test_reference_atoms_and_scores_match_jax_on_the_same_pose():
    jb, tb = _pair()
    ra_t = toracle.dihedral_reference_atoms(tb.bond_mask[0].numpy(), tb.tor_edges[0].numpy(),
                                            tb.tor_mask[0].numpy(), tb.mask_rotate[0].numpy())
    ra_j = joracle.dihedral_reference_atoms(np.asarray(jb.bond_mask[0]),
                                            np.asarray(jb.tor_edges[0]),
                                            np.asarray(jb.tor_mask[0]),
                                            np.asarray(jb.mask_rotate[0]))
    np.testing.assert_array_equal(ra_t, ra_j)
    # a noised pose at several noise levels, the same numbers on both sides
    draws = noise_draws(jax.random.PRNGKey(5), N_POSES, tb.num_torsions)
    draws.t = torch.linspace(0.1, 0.9, N_POSES)
    noised, _ = t_apply_noise(tb, SCHED, draws=draws)
    jnoised = jb.replace(lig_pos=jnp.asarray(noised.lig_pos.numpy()),
                         lig_norm=jnp.asarray(noised.lig_norm.numpy()),
                         t=jnp.asarray(noised.t.numpy()))
    ref = joracle.make_oracle_score_fn(jb, JSCHED)(jnoised)
    got = toracle.make_oracle_score_fn(tb, SCHED)(noised)
    for name, g, r in zip(("tr", "rot", "tor"), got, ref):
        assert_close(g, r, 1e-4, name)


def test_oracle_scores_match_training_targets():
    """Noising a clean batch and measuring it back through the oracle gives
    the training targets: translation exactly, torsion through the same
    tables, rotation in direction (second order in the torsion offsets)."""
    _, tb = _pair()
    draws = noise_draws(jax.random.PRNGKey(3), N_POSES, tb.num_torsions)
    draws.t = torch.full((N_POSES,), 0.6)
    noised, targets = t_apply_noise(tb, SCHED, draws=draws)
    tr, rot, tor = toracle.make_oracle_score_fn(tb, SCHED)(noised)
    np.testing.assert_allclose(tr.numpy(), targets.tr_score.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tor.numpy(), targets.tor_score.numpy(), rtol=2e-2, atol=2e-2)
    a, b = rot.numpy(), targets.rot_score.numpy()
    cos = (a * b).sum(-1) / np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1),
                                       1e-9)
    assert (cos > 0.95).all(), cos


def _port_chain(tb, settings, seed):
    gen = torch.Generator().manual_seed(seed)
    prior = draw_prior(N_POSES, tb.num_torsions, gen, "cpu")
    steps = draw_steps(settings.steps, N_POSES, tb.num_torsions, gen, "cpu")
    b = randomize_position(tb, prior, SCHED.tr_sigma_max, no_torsion=settings.no_torsion)
    return reverse_diffusion(toracle.make_oracle_score_fn(tb, SCHED), b, SCHED, settings, steps,
                             return_trajectory=True)


def test_port_chain_recovers_a_rigid_pose_by_the_ode():
    _, tb = _pair()
    final, _ = _port_chain(tb, SamplerSettings(inference_steps=20, ode=True, no_torsion=True), 0)
    r = _rmsd(final.lig_pos, tb.lig_pos, tb.lig_mask)
    assert (r < 1.0).all(), r
    assert r.min() < 0.3, r


@pytest.mark.parametrize("ligand", ["EX01.sdf", "EX02.sdf"])
def test_port_chain_recovers_the_pose_by_the_sde(ligand):
    _, tb = _pair(ligand)
    final, traj = _port_chain(tb, SamplerSettings(inference_steps=20, no_final_step_noise=True),
                              1)
    r = _rmsd(final.lig_pos, tb.lig_pos, tb.lig_mask)
    assert (r < 2.0).sum() >= 6, r
    assert r.min() < 1.0, r
    m = tb.lig_mask[0].double().numpy()
    cent = (traj.double().numpy() * m[None, None, :, None]).sum(2) / m.sum()
    assert np.linalg.norm(np.diff(cent, axis=0), axis=-1).max() < 50.0


def test_port_chain_matches_the_jax_chain_with_the_same_noise():
    jb, tb = _pair()
    settings = dict(inference_steps=20, no_final_step_noise=True)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    score_fn = joracle.make_oracle_score_fn(jb, JSCHED)

    @jax.jit
    def go(b):
        b = j_randomize_position(b, k1, tr_sigma_max=JSCHED.tr_sigma_max)
        return j_reverse_diffusion(score_fn, b, k2, JSCHED, JSamplerSettings(**settings))

    ref = go(jb)
    b = randomize_position(tb, prior_noise(k1, N_POSES, tb.num_torsions), SCHED.tr_sigma_max)
    got = reverse_diffusion(toracle.make_oracle_score_fn(tb, SCHED), b, SCHED,
                            SamplerSettings(**settings),
                            step_noise(k2, 20, N_POSES, tb.num_torsions))
    np.testing.assert_allclose(got.lig_pos.numpy(), np.asarray(ref.lig_pos), atol=1e-3)
