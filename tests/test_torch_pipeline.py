"""The port's FitEngine against the JAX engine: 2 cached complexes x 4 poses
x 3 reverse steps with the corpus2 checkpoint (f32 on both sides) and the
same noise.  The JAX side is driven through ``FitEngine.compile_bucket``
with the row-batched reference built from the batch, as
``cli/train.py::_dispatch_batch_inference`` does (a cache holds no
Molecule, which ``run_complexes`` needs)."""

import numpy as np
import pytest
import torch

import jax

from diffphore_torch.cli.pipeline import FitEngine, job_from_cached
from diffphore_torch.data.graphs import load_cached
from diffphore_torch.ops import tp_fused
from diffphore_torch.sampler.sampling import SamplerSettings
from diffphore_tpu.cli.pipeline import FitEngine as JFitEngine
from diffphore_tpu.data.dataset import load_complex
from diffphore_tpu.data.graphs import repeat_batch
from diffphore_tpu.ops.fitscore import PhoreArrays
from diffphore_tpu.sampler.sampling import SamplerSettings as JSamplerSettings

from torch_port_helpers import cached_files, corpus2, prior_noise, step_noise

torch.set_num_threads(2)

N_POSES, STEPS = 4, 3


def _jax_run(engine, batch, key):
    """One complex through the JAX engine's compiled sampler."""
    b = repeat_batch(batch.replace(meta=()), N_POSES).replace(names=(), meta=())
    ref = PhoreArrays(
        coord=np.asarray(batch.phore_pos[0]),
        type_onehot=np.asarray(batch.phoretype[0]),
        alpha=np.asarray(batch.phore_x[0, :, 3]),
        weight=np.asarray(batch.phore_x[0, :, 4]),
        anchor=np.ones(batch.num_phore, np.float32),
        is_ex=np.asarray(batch.phoretype[0, :, -1] == 1),
        mask=np.asarray(batch.phore_mask[0]),
    )
    ref = jax.tree_util.tree_map(lambda x: np.repeat(np.asarray(x)[None], N_POSES, axis=0), ref)
    run = engine.compile_bucket((b.num_atoms, b.num_phore, b.num_torsions), N_POSES)
    pos, scores, _ = run(engine.variables, b, ref, key)
    return np.asarray(pos), {k: np.asarray(v) for k, v in scores.items()}


def test_fit_engine_matches_jax_engine():
    jcfg, variables, tcfg, model = corpus2()
    files = cached_files(n=2)
    keys = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]

    jengine = JFitEngine(jcfg, variables, samples_per_complex=N_POSES,
                         settings=JSamplerSettings(inference_steps=STEPS))
    engine = FitEngine(tcfg, model, samples_per_complex=N_POSES,
                       settings=SamplerSettings(inference_steps=STEPS), device="cpu")
    jobs = [job_from_cached(load_cached(f)) for f in files]
    noises = []
    for job, key in zip(jobs, keys):
        k1, k2 = jax.random.split(key)
        T = job.batch.num_torsions
        noises.append((prior_noise(k1, N_POSES, T), step_noise(k2, STEPS, N_POSES, T)))
    before = tp_fused.KERNEL.launches
    results = engine.run_complexes(jobs, noises)
    assert tp_fused.KERNEL.launches == before  # CPU: plain convs

    for f, key, job, res in zip(files, keys, jobs, results):
        batch = load_complex(f)
        pos, scores = _jax_run(jengine, batch, key)
        n_atoms = int(np.asarray(batch.lig_mask[0]).sum())
        assert job.n_atoms == n_atoms and res["name"] == batch.names[0]
        poses = pos[:, :n_atoms] + np.asarray(batch.orig_center[0])
        assert res["poses"].shape == poses.shape
        np.testing.assert_allclose(res["poses"], poses, atol=2e-3)
        np.testing.assert_allclose(res["fitscore"], scores["phscore1"], atol=1e-4)
        np.testing.assert_allclose(res["scores"]["phscore2"], scores["phscore2"], atol=1e-4)
        # Gaussian overlap volumes move by ~2*alpha*r*dr relative to the
        # pose difference dr allowed above (alpha ~ 1, r ~ 2 A)
        for k in ("V_overlap", "V_exOverlap"):
            np.testing.assert_allclose(res["scores"][k], scores[k], rtol=1e-2, atol=1e-4)
        # the JAX package's order of the delivered poses (cli/inference.py)
        np.testing.assert_array_equal(res["rank"], np.argsort(scores["phscore1"])[::-1])
        assert np.isfinite(res["poses"]).all()


def test_fit_engine_random_samples_match_jax_engine():
    """``random_samples = 2``: both engines pick, per step and row, the
    candidate draw of the higher PhScore1 (``fitness_by_index`` with the
    engine's fitness index on the port's side).  One complex; tolerances as
    above."""
    jcfg, variables, tcfg, model = corpus2()
    f = cached_files(n=1)[0]
    key = jax.random.PRNGKey(23)
    kw = dict(inference_steps=STEPS, random_samples=2)
    jengine = JFitEngine(jcfg, variables, samples_per_complex=N_POSES,
                         settings=JSamplerSettings(**kw))
    engine = FitEngine(tcfg, model, samples_per_complex=N_POSES, settings=SamplerSettings(**kw),
                       device="cpu")
    job = job_from_cached(load_cached(f))
    k1, k2 = jax.random.split(key)
    T = job.batch.num_torsions
    noise = (prior_noise(k1, N_POSES, T), step_noise(k2, STEPS, N_POSES, T, S=2))
    (res,) = engine.run_complexes([job], [noise])
    batch = load_complex(f)
    pos, scores = _jax_run(jengine, batch, key)
    poses = pos[:, :job.n_atoms] + np.asarray(batch.orig_center[0])
    np.testing.assert_allclose(res["poses"], poses, atol=2e-3)
    np.testing.assert_allclose(res["fitscore"], scores["phscore1"], atol=1e-4)
    # the engine draws noise with the candidate axis its settings ask for
    prior, steps = engine.draw_noise(N_POSES, T)
    assert steps.z_tr.shape == (STEPS, 2, N_POSES, 3) and prior.tor.shape == (N_POSES, T)
    # and the first candidate alone gives other poses: the selection took part
    single = FitEngine(tcfg, model, samples_per_complex=N_POSES,
                       settings=SamplerSettings(inference_steps=STEPS), device="cpu")
    (alone,) = single.run_complexes([job], [noise])
    assert float(np.abs(alone["poses"] - res["poses"]).max()) > 1e-2


@pytest.mark.parametrize("with_confidence", [False, True])
def test_rank_orders_tied_scores_as_the_jax_package(monkeypatch, with_confidence):
    """``rank`` is ``np.argsort(key)[::-1]``, the JAX package's expression,
    with the confidence row as the key when the engine has a head and the
    fitness otherwise: on tied keys the later pose comes first (a stable
    sort of the negated key would put the earlier one first)."""
    from diffphore_torch.models.score_model import ScoreModel

    from torch_port_helpers import SMALL, configs

    _, tcfg = configs(**SMALL)
    engine = FitEngine(tcfg, ScoreModel(tcfg), samples_per_complex=4, device="cpu")
    fit = torch.tensor([0.5, 0.7, 0.5, 0.7])
    conf = torch.tensor([2.0, -1.0, 3.0, 2.0])

    def run_batch(batch, ref, pose_group=1, noise=None, return_trajectory=False):
        scores = {"phscore1": fit.clone()}
        if with_confidence:
            scores["confidence"] = conf.clone()
        return batch.lig_pos, scores, None

    monkeypatch.setattr(engine, "run_batch", run_batch)
    (res,) = engine.run_complexes([job_from_cached(load_cached(cached_files(n=1)[0]))])
    if with_confidence:
        assert list(res["rank"]) == [2, 3, 0, 1] and res["confidence"] == conf.tolist()
    else:
        assert list(res["rank"]) == [3, 1, 2, 0] and "confidence" not in res
    key = conf if with_confidence else fit
    assert list(res["rank"]) == list(np.argsort(key.numpy())[::-1])
