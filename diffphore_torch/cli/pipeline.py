"""The fitting engine: featurize -> sample -> score.

For each complex, all ``samples_per_complex`` poses are rows of one batch;
the prior draw, the reverse diffusion and the fitness scoring run on the
device, and one complex goes per dispatch (``pose_group = n``).  With a
trained confidence head the final poses are also scored by it, at t = 0 with
its running batch statistics, and ranked by that score.

Complexes enter from files (:meth:`FitEngine.prepare`: a ``.phore`` file and
a ligand as an SDF/MOL/MOL2/PDB path or a SMILES string, featurized on the
host in numpy into CPU tensors, bucket-padded) or featurized, as cached
``ComplexBatch``es (:func:`job_from_cached`).  A job from files is scored
against the phore file's own points (``make_phore_arrays``, with its anchor
weights); a cached one against the batch's phore (anchor 1), as the JAX
package's cached path does.  On the GPU the kernels are built when the
engine is made, so no dispatch pays for nvcc.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chem.mol import Molecule
from ..constants import VDW_TABLE
from ..data.featurize import featurize
from ..data.graphs import ComplexBatch, from_numpy, repeat_batch
from ..device import resolve_device
from ..models.confidence import ConfidenceModel
from ..models.layers import batch_statistics
from ..models.score_model import ScoreModel, ScoreModelConfig
from ..ops import build
from ..ops.fitscore import PhoreArrays, batch_phore_arrays, fitness_by_index, fitscore
from ..sampler.sampling import (PriorNoise, SamplerSettings, StepNoise, draw_prior, draw_steps,
                                randomize_position, reverse_diffusion)
from ..utils.logging import PhaseTimers, log_info


@dataclasses.dataclass
class ComplexJob:
    name: str
    batch: ComplexBatch  # B = 1, bucket-padded, phore-centered
    n_atoms: int         # real (unpadded) ligand atoms
    #: B = 1, phore-centered: the phore file's points (None: the batch's)
    ref: Optional[PhoreArrays] = None
    #: the H-free ligand (topology and input coordinates), for the writers
    mol: Optional[Molecule] = None


def prepare_job(name: str, ligand_description: str, phore_path: str,
                keep_local_structures: bool = True) -> Optional[ComplexJob]:
    """Featurize one (ligand, first phore of the file) pair into a job of CPU
    tensors (:func:`data.featurize.featurize`: padded to buckets of 8 atoms,
    at least 16, 16 phore points and 4 torsion slots); None when the ligand
    or the phore cannot be read."""
    arrays = featurize(name, ligand_description, phore_path, keep_local_structures)
    return None if arrays is None else job_from_arrays(arrays)


def job_from_arrays(d: Dict) -> ComplexJob:
    """The job of :func:`data.featurize.featurize`'s arrays, here or from a
    featurization process."""
    tensors = lambda arrays: {k: torch.from_numpy(v) for k, v in arrays.items()}  # noqa: E731
    batch = from_numpy(d["batch"], names=(d["name"],), meta=(d["meta"],))
    return ComplexJob(d["name"], batch, d["mol"].num_atoms, PhoreArrays(**tensors(d["ref"])),
                      d["mol"])


def job_from_cached(batch: ComplexBatch) -> ComplexJob:
    """A job from a cached complex; the atom count comes from ``lig_mask``."""
    name = batch.names[0] if batch.names else ""
    return ComplexJob(name, batch, int(batch.lig_mask[0].sum()))


class FitEngine:
    def __init__(
        self,
        cfg: ScoreModelConfig,
        model: ScoreModel,
        samples_per_complex: int = 40,
        settings: Optional[SamplerSettings] = None,
        fitness: int = 1,
        seed: int = 0,
        device: Optional[str] = None,
        confidence: Optional[ConfidenceModel] = None,
        save_trajectory: bool = False,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            build.load("tp_fused")     # nvcc once, before the first dispatch
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.confidence = None if confidence is None else confidence.to(self.device).eval()
        self.n = samples_per_complex
        self.settings = settings or SamplerSettings()
        self.fitness = fitness
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        #: results also hold the (steps, n, atoms, 3) positions after each step
        self.save_trajectory = save_trajectory
        self.timers = PhaseTimers()

    # ------------------------------------------------------------ featurize
    def prepare(self, name: str, ligand_description: str, phore_path: str,
                keep_local_structures: bool = True) -> Optional[ComplexJob]:
        """:func:`prepare_job`, timed as the ``featurize`` phase."""
        with self.timers.phase("featurize"):
            return prepare_job(name, ligand_description, phore_path, keep_local_structures)

    # -------------------------------------------------------------- sampling
    @torch.no_grad()
    def calibrate_batch_stats(self, job, iters: int = 80,
                              draws: Optional[Sequence[Tuple[PriorNoise, torch.Tensor]]] = None
                              ) -> None:
        """Move the batch norms' running statistics toward those of
        randomized poses at random diffusion times, ``iters`` forwards of
        ``min(n, 8)`` rows: eval-mode convs (K1), dropout off, batch norms
        normalizing by the batch and updating their running statistics.
        Only for random weights (``--allow_random_init``), whose identity
        statistics let eval-mode activations overflow through the conv
        stack.  ``draws`` replays (prior noise, t) per forward; ``job`` may
        be a bare ``ComplexBatch``."""
        base = getattr(job, "batch", job)
        rows = min(self.n, 8)
        batch = repeat_batch(base.to(self.device), rows).replace(names=(), meta=())
        T = batch.num_torsions
        if draws is None:
            draws = [(draw_prior(rows, T, self.generator, self.device),
                      torch.rand(rows, generator=self.generator, device=self.device))
                     for _ in range(iters)]
        with batch_statistics(self.model, update=True):
            for prior, t in draws:
                b = randomize_position(batch, prior, tr_sigma_max=self.cfg.tr_sigma_max)
                self.model(b.replace(t=t.to(self.device)))
        log_info("Batch-stats calibration done (random-init mode)")

    def draw_noise(self, B: int, T: int) -> Tuple[PriorNoise, StepNoise]:
        return (draw_prior(B, T, self.generator, self.device),
                draw_steps(self.settings.steps, B, T, self.generator, self.device,
                           self.settings.candidates))

    @torch.inference_mode()
    def run_batch(self, batch: ComplexBatch, ref: PhoreArrays, pose_group: int = 1,
                  noise: Optional[Tuple[PriorNoise, StepNoise]] = None,
                  return_trajectory: bool = False):
        """Sample and score one device batch of pose rows; returns the final
        positions (B, A, 3), phore-centered, the per-row score dict (with
        the head's ``confidence`` row when the engine has a head), and the
        (steps, B, A, 3) positions after each step with
        ``return_trajectory``, else None.  ``ref`` is row-batched; ``noise``
        replays given draws."""
        cfg, settings = self.cfg, self.settings
        prior, steps = noise or self.draw_noise(batch.batch_size, batch.num_torsions)
        vdw = torch.as_tensor(VDW_TABLE, device=batch.device)[batch.lig_feat[..., 0]]

        def score(b):
            return fitscore(b.lig_pos, b.lig_mask, batch.lig_scorer_fp, vdw, ref,
                            count_fp=batch.lig_phorefp)

        # random_samples > 1: per-step candidate selection by the fitness
        fitness_fn = ((lambda b: fitness_by_index(score(b), self.fitness))
                      if settings.random_samples > 1 else None)
        b = randomize_position(batch, prior, cfg.tr_sigma_max, settings.no_torsion)
        b = reverse_diffusion(lambda x: self.model(x, pose_group=pose_group), b,
                              cfg.sigma_schedule, settings, steps, fitness_fn=fitness_fn,
                              return_trajectory=return_trajectory)
        b, traj = b if return_trajectory else (b, None)
        scores = score(b)
        if self.confidence is not None:
            scores["confidence"] = self.confidence(b.replace(t=torch.zeros_like(b.t)),
                                                   pose_group=pose_group)[0]
        return b.lig_pos, scores, traj

    def run_complexes(self, jobs: Sequence[ComplexJob],
                      noises: Optional[Sequence[Tuple[PriorNoise, StepNoise]]] = None,
                      skip_failed: bool = False) -> List[Dict]:
        """Sample and score each complex; one result per job, in order:
        poses (n, n_atoms, 3) in the input frame, their fitness, the score
        dict, the head's ``confidence`` (with a head), ``rank`` (pose
        indices, best first by the confidence when present, else by the
        fitness) and with ``save_trajectory`` the ``trajectory`` (steps, n,
        n_atoms, 3), input frame.  A job's ``ref`` is its reference when set,
        else the batch's phore.  Up to 16 dispatches (4 when trajectories are
        kept) are in flight before the first result is read back.  With
        ``skip_failed`` a complex whose sampling or read back raises is
        logged and its result is ``{"name", "error"}``; else the exception
        propagates."""
        window = 4 if self.save_trajectory else 16
        results: List[Optional[Dict]] = [None] * len(jobs)
        in_flight: List = []

        def failed(i, e):
            if not skip_failed:
                raise e
            log_info(f"sampling {jobs[i].name or i} failed: {e!r}")
            results[i] = {"name": jobs[i].name, "error": repr(e)}

        def pull(i, out):
            try:
                with self.timers.phase("denoise"):
                    collect(i, *out)
            except Exception as e:  # noqa: BLE001
                failed(i, e)

        def collect(i, pos, scores, traj):
            job = jobs[i]
            pos = pos.cpu().numpy()
            sc = {k: v.cpu().numpy() for k, v in scores.items()}
            fit = np.asarray(fitness_by_index(sc, self.fitness))
            center = job.batch.orig_center[0].cpu().numpy()
            result = {
                "name": job.name,
                "poses": pos[:, :job.n_atoms, :] + center,
                "fitscore": [float(x) for x in fit],
                "scores": sc,
            }
            if "confidence" in sc:
                result["confidence"] = [float(x) for x in sc["confidence"]]
            if traj is not None:
                result["trajectory"] = traj.cpu().numpy()[:, :, :job.n_atoms, :] + center
            key = np.asarray(result.get("confidence", result["fitscore"]))
            result["rank"] = np.argsort(key)[::-1]
            results[i] = result

        for i, job in enumerate(jobs):
            noise = noises[i] if noises is not None else None
            try:
                with self.timers.phase("dispatch"):
                    batch = repeat_batch(job.batch.to(self.device), self.n).replace(
                        names=(), meta=())
                    ref = (batch_phore_arrays(batch) if job.ref is None
                           else job.ref.to(self.device).repeat(self.n))
                    out = self.run_batch(batch, ref, self.n, noise,
                                         return_trajectory=self.save_trajectory)
            except Exception as e:  # noqa: BLE001
                failed(i, e)
                continue
            in_flight.append((i, out))
            if len(in_flight) >= window:
                pull(*in_flight.pop(0))
        for entry in in_flight:
            pull(*entry)
        return results
