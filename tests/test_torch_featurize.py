"""Host featurization and the engine from files, the port against the JAX
package on the CPU: ``.phore`` parsing and phore graphs, ``make_phore_arrays``
(anchor weights from the file), ``build_complex`` and ``pad_to_bucket`` field
for field, ``FitEngine.prepare`` + ``run_complexes`` against the JAX engine
on the same prepared job with injected noise (corpus2 weights at f32 and at
the shipped bf16), and one ``calibrate_batch_stats`` step."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from diffphore_torch.chem.sdf import read_molecule as t_read_molecule
from diffphore_torch.chem.smiles import mol_from_smiles as t_mol_from_smiles
from diffphore_torch.cli.pipeline import FitEngine
from diffphore_torch.data import graphs as tgraphs
from diffphore_torch.data import phore as tphore
from diffphore_torch.ops.fitscore import make_phore_arrays
from diffphore_torch.sampler.sampling import SamplerSettings
from diffphore_torch.utils.checkpoints import convert_variables
from diffphore_tpu.chem.sdf import read_molecule as j_read_molecule
from diffphore_tpu.chem.smiles import mol_from_smiles as j_mol_from_smiles
from diffphore_tpu.cli.pipeline import FitEngine as JFitEngine
from diffphore_tpu.data import graphs as jgraphs
from diffphore_tpu.data import phore as jphore
from diffphore_tpu.data.graphs import repeat_batch as j_repeat_batch
from diffphore_tpu.cli.pipeline import VDW_TABLE
from diffphore_tpu.ops.fitscore import fitscore as j_fitscore
from diffphore_tpu.ops.fitscore import make_phore_arrays as j_make_phore_arrays
from diffphore_tpu.sampler.sampling import SamplerSettings as JSamplerSettings

from torch_port_helpers import (REPO, SMALL, assert_close, assert_within_gap, configs, corpus2,
                                prior_noise, step_noise)

torch.set_num_threads(2)

EXAMPLES = os.path.join(REPO, "examples")
EXAMPLE_PHORE = os.path.join(EXAMPLES, "example.phore")
N_POSES, STEPS = 4, 3
#: poses of the bf16 route against JAX's at bf16, as a share of JAX's own
#: f32-vs-bf16 difference after the same steps: the two bf16 routes round at
#: the same points but sum in other orders, and three chained steps compound
#: that as they compound f32-vs-bf16 (0.40 measured on this job; a route
#: computing in f32 would stand at 1)
GAP = 0.5


def write_anchor_phore(path):
    """Two records from example.phore: the first with anchor weights 0.5-2.0
    on its features and a shifted copy of its points as a second record."""
    with open(EXAMPLE_PHORE) as f:
        lines = [line.rstrip("\n") for line in f if line.strip()]
    body = [ln for ln in lines[1:] if ln != "$$$$"]
    out = ["anchored_0"]
    for k, ln in enumerate(body):
        parts = ln.split("\t")
        if parts[0] != "EX":
            parts[-1] = f"{0.5 + 0.25 * (k % 7):.3f}"
        out.append("\t".join(parts))
    out += ["$$$$", "anchored_1"]
    for ln in body[:10]:
        parts = ln.split("\t")
        parts[4] = f"{float(parts[4]) + 1.0:.3f}"
        out.append("\t".join(parts))
    out.append("$$$$")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path


@pytest.fixture
def anchor_phore(tmp_path):
    return write_anchor_phore(str(tmp_path / "anchored.phore"))


def _phore_files(anchor_phore):
    return [EXAMPLE_PHORE, anchor_phore]


def test_parse_phore_and_graphs_match(anchor_phore, tmp_path):
    for path in _phore_files(anchor_phore):
        jp, tp = jphore.parse_phore(path), tphore.parse_phore(path)
        assert [dataclasses.astuple(f) for p in tp for f in p.all_points] == \
            [dataclasses.astuple(f) for p in jp for f in p.all_points]
        assert [p.id for p in tp] == [p.id for p in jp]
        for j, t in zip(jp, tp):
            for kw in ({}, {"consider_ex": False}, {"neighbor_cutoff": 3.0, "ex_connected": False}):
                jg, tg = jphore.build_phore_graph(j, **kw), tphore.build_phore_graph(t, **kw)
                for field in ("x", "pos", "norm", "edge_index", "phoretype"):
                    np.testing.assert_array_equal(getattr(tg, field), getattr(jg, field))
                assert tg.num_features == jg.num_features
            jphore.write_phore(j, str(tmp_path / f"j_{j.id}.phore"))
            tphore.write_phore(t, str(tmp_path / f"t_{t.id}.phore"))
            assert (tmp_path / f"t_{t.id}.phore").read_bytes() == \
                (tmp_path / f"j_{j.id}.phore").read_bytes()
    anchored = tphore.parse_phore(anchor_phore)
    assert len(anchored) == 2
    assert sorted({f.anchor_weight for f in anchored[0].features}) != [1.0]


def test_make_phore_arrays_match(anchor_phore):
    for path in _phore_files(anchor_phore):
        for j, t in zip(jphore.parse_phore(path), tphore.parse_phore(path)):
            for pad in (None, 96):
                want = j_make_phore_arrays(j, pad=pad)
                got = make_phore_arrays(t, pad=pad)
                for field, value in got.tensors().items():
                    assert value.shape[0] == 1
                    np.testing.assert_array_equal(value[0].numpy(), np.asarray(getattr(want, field)))
    anchor = make_phore_arrays(tphore.parse_phore(anchor_phore)[0]).anchor[0].numpy()
    assert len(set(anchor.tolist())) > 2


def _ligands():
    """(JAX molecule, port molecule, label): the example SDFs without
    hydrogens and an embedded SMILES."""
    out = []
    for name in ("EX01", "EX02", "EX03"):
        path = os.path.join(EXAMPLES, f"{name}.sdf")
        out.append((j_read_molecule(path, remove_hs=True), t_read_molecule(path, remove_hs=True),
                    name))
    from diffphore_torch.chem.embed import embed_molecule as t_embed
    from diffphore_tpu.chem.embed import embed_molecule as j_embed

    smi = "CC(=O)Nc1ccc(OCC[NH3+])cc1"
    jm, tm = j_mol_from_smiles(smi), t_mol_from_smiles(smi)
    j_embed(jm)
    t_embed(tm)
    out.append((jm, tm, "smiles"))
    return out


def assert_same_batch(tb, jb, what=""):
    for field in tgraphs.ARRAY_FIELDS:
        got, want = getattr(tb, field).numpy(), np.asarray(getattr(jb, field))
        assert got.shape == want.shape, (what, field, got.shape, want.shape)
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {field}")
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"{what} {field}")
    assert tuple(tb.names) == tuple(jb.names)


def test_build_complex_and_pad_to_bucket_match(anchor_phore):
    for path in _phore_files(anchor_phore):
        jp, tp = jphore.parse_phore(path)[0], tphore.parse_phore(path)[0]
        for jm, tm, label in _ligands():
            for pads in ({}, {"a_pad": 40, "p_pad": 96, "t_pad": 12}):
                jb = jgraphs.build_complex(label, jm, jp, **pads)
                tb = tgraphs.build_complex(label, tm, tp, **pads)
                assert_same_batch(tb, jb, f"{label} {pads}")
                for k in ("n_atoms", "n_phore", "n_tor"):
                    assert tb.meta[0][k] == jb.meta[0][k]
            jb = jgraphs.build_complex(label, jm, jp, move_to_center=False, consider_ex=False)
            tb = tgraphs.build_complex(label, tm, tp, move_to_center=False, consider_ex=False)
            assert_same_batch(tb, jb, f"{label} uncentered, no EX")
            (jpad,) = jgraphs.pad_to_bucket([jb], 48, 112, 16)
            (tpad,) = tgraphs.pad_to_bucket([tb], 48, 112, 16)
            assert_same_batch(tpad, jpad, f"{label} re-padded")
    with pytest.raises(ValueError, match="exceed pads"):
        tgraphs.build_complex("x", _ligands()[0][1], tphore.parse_phore(EXAMPLE_PHORE)[0],
                              a_pad=8)


def _jax_run(jengine, job, key):
    """The JAX engine's compiled sampler on one prepared job."""
    b = j_repeat_batch(job.batch, N_POSES).replace(names=(), meta=())
    ref = JFitEngine._row_refs([job], N_POSES)
    run = jengine.compile_bucket((b.num_atoms, b.num_phore, b.num_torsions), N_POSES)
    pos, scores, _ = run(jengine.variables, b, ref, key)
    n = job.mol.num_atoms
    poses = np.asarray(pos)[:, :n] + np.asarray(job.batch.orig_center[0])
    return poses, {k: np.asarray(v) for k, v in scores.items()}


def _engines(compute_dtype):
    jcfg, variables, tcfg, model = corpus2(compute_dtype)
    settings = dict(inference_steps=STEPS)
    jengine = JFitEngine(jcfg, variables, samples_per_complex=N_POSES,
                         settings=JSamplerSettings(**settings))
    engine = FitEngine(tcfg, model, samples_per_complex=N_POSES,
                       settings=SamplerSettings(**settings), device="cpu")
    return jengine, engine


def test_prepared_jobs_sample_as_the_jax_engine(anchor_phore):
    """EX01 against the phore file with anchor weights != 1: the prepared
    jobs (batch, reference and molecule) are equal, and the same injected
    noise gives the same poses, scores and ranking, at f32 within the
    tolerances of tests/test_torch_pipeline.py and at the shipped bf16 within
    GAP (0.5) of JAX's own f32-vs-bf16 difference."""
    lig = os.path.join(EXAMPLES, "EX01.sdf")
    key = jax.random.PRNGKey(31)
    k1, k2 = jax.random.split(key)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        jengine, engine = _engines(dtype)
        jjob = jengine.prepare("cx", lig, anchor_phore)
        job = engine.prepare("cx", lig, anchor_phore)
        assert_same_batch(job.batch, jjob.batch, "prepared batch")
        for field, value in job.ref.tensors().items():
            np.testing.assert_allclose(value[0].numpy(), np.asarray(getattr(jjob.ref, field)),
                                       rtol=0, atol=1e-6, err_msg=field)
        assert job.n_atoms == jjob.mol.num_atoms and job.mol.bonds == jjob.mol.bonds
        T = job.batch.num_torsions
        noise = (prior_noise(k1, N_POSES, T), step_noise(k2, STEPS, N_POSES, T))
        (res,) = engine.run_complexes([job], [noise])
        runs[dtype] = (res, *_jax_run(jengine, jjob, key))
    res, poses, scores = runs["float32"]
    np.testing.assert_allclose(res["poses"], poses, atol=2e-3)
    np.testing.assert_allclose(res["fitscore"], scores["phscore1"], atol=1e-4)
    for k in ("anchor_pct", "phscore3", "phscore4"):
        np.testing.assert_allclose(res["scores"][k], scores[k], atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(res["rank"], np.argsort(scores["phscore1"])[::-1])
    # the file's anchors reach the score: with anchor 1 everywhere it differs
    assert float(np.abs(scores["anchor_pct"]).max()) > 0

    # bf16: the poses within GAP of JAX's f32-vs-bf16 difference, closer to
    # JAX at bf16 than to JAX at f32; the fitness of the port's own poses as
    # the JAX scorer gives it against the file's reference, and the ranking
    res16, poses16, scores16 = runs["bfloat16"]
    assert_within_gap({"poses": res16["poses"]}, {"poses": poses16}, {"poses": poses}, GAP,
                      "bf16 engine poses")
    assert np.abs(res16["poses"] - poses16).max() < np.abs(res16["poses"] - poses).max()
    jengine, _ = _engines("bfloat16")
    jjob = jengine.prepare("cx", lig, anchor_phore)
    n = jjob.mol.num_atoms
    b = jjob.batch
    rescored = j_fitscore(res16["poses"] - np.asarray(b.orig_center[0]), np.ones(n, bool),
                          np.asarray(b.lig_scorer_fp[0, :n]),
                          VDW_TABLE[np.asarray(b.lig_feat[0, :n, 0])],
                          jax.tree_util.tree_map(np.asarray, jjob.ref),
                          count_fp=np.asarray(b.lig_phorefp[0, :n]))
    for k in ("phscore1", "anchor_pct", "phscore3"):
        np.testing.assert_allclose(res16["scores"][k], rescored[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(res16["rank"], np.argsort(res16["fitscore"])[::-1])
    np.testing.assert_array_equal(res16["rank"], np.argsort(scores16["phscore1"])[::-1])


def test_calibrate_batch_stats_step_matches_jax():
    """One calibration forward from the same injected prior and times:
    batch norms normalize by the batch and move their running statistics by
    the JAX package's momentum; the convs stay in eval mode."""
    jengine, engine = _engines("float32")
    lig = os.path.join(EXAMPLES, "EX02.sdf")
    jjob = jengine.prepare("cx", lig, EXAMPLE_PHORE)
    job = engine.prepare("cx", lig, EXAMPLE_PHORE)
    rows = min(N_POSES, 8)
    # the key of the JAX engine's one iteration and its draws
    _, sub = jax.random.split(jengine.key)
    k1, k2, _ = jax.random.split(sub, 3)
    prior = prior_noise(k1, rows, job.batch.num_torsions)
    t = torch.from_numpy(np.asarray(jax.random.uniform(k2, (rows,))).copy())
    before = {k: v.clone() for k, v in engine.model.named_buffers()}
    jengine.calibrate_batch_stats(jjob, iters=1)
    engine.calibrate_batch_stats(job, draws=[(prior, t)])
    stats = convert_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, dict(jengine.variables["batch_stats"]))})
    moved = 0
    for name, buf in engine.model.named_buffers():
        assert_close(buf, stats[name], 1e-5, name)
        moved += int(not torch.equal(buf, before[name]))
    assert moved > 0 and not engine.model.training
    assert all(not m.use_batch_stats for m in engine.model.modules()
               if hasattr(m, "use_batch_stats"))


def test_prepare_skips_what_it_cannot_read(tmp_path, capsys):
    from diffphore_torch.models.score_model import ScoreModel

    _, tcfg = configs(**SMALL)
    engine = FitEngine(tcfg, ScoreModel(tcfg), samples_per_complex=2, device="cpu")
    assert engine.prepare("bad", "C1CC(=O", EXAMPLE_PHORE) is None
    assert "Failed to parse ligand description" in capsys.readouterr().out
    assert engine.prepare("one atom", "C", EXAMPLE_PHORE) is None
    empty = tmp_path / "empty.phore"
    empty.write_text("nothing\n$$$$\n")
    assert engine.prepare("no phore", os.path.join(EXAMPLES, "EX01.sdf"), str(empty)) is None
    job = engine.prepare("ok", "CC(=O)Nc1ccc(O)cc1", EXAMPLE_PHORE)
    assert job.batch.num_atoms == 16 and job.batch.num_phore == 96
    assert job.batch.num_torsions == 4 and job.n_atoms == job.mol.num_atoms == 11
    assert engine.timers.counts["featurize"] == 4


def test_phase_timers_keep_every_update_across_threads():
    """Threads that share an engine's PhaseTimers (as FitEngine.prepare on
    several threads does): with more threads than cores and a short switch
    interval, no count is lost."""
    import sys
    import threading

    from diffphore_torch.utils.logging import PhaseTimers

    timers = PhaseTimers()
    n_threads, n_phases = 4 * (os.cpu_count() or 2), 500

    def work():
        for _ in range(n_phases):
            with timers.phase("featurize"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert timers.counts["featurize"] == n_threads * n_phases
    assert timers.totals["featurize"] >= 0.0
    assert timers.report().startswith("featurize=")
