"""The fitting engine: sample and score poses of featurized complexes.

For each complex, all ``samples_per_complex`` poses are rows of one batch;
the prior draw, the reverse diffusion and the fitness scoring run on the
device, and one complex goes per dispatch (``pose_group = n``).  With a
trained confidence head the final poses are also scored by it, at t = 0 with
its running batch statistics, and ranked by that score.  Complexes
enter featurized, as cached ``ComplexBatch``es (``data.graphs.load_cached``);
host featurization of SDF/SMILES and .phore files is not part of the port
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import VDW_TABLE
from ..data.graphs import ComplexBatch, repeat_batch
from ..device import resolve_device
from ..models.confidence import ConfidenceModel
from ..models.score_model import ScoreModel, ScoreModelConfig
from ..ops.fitscore import PhoreArrays, batch_phore_arrays, fitness_by_index, fitscore
from ..sampler.sampling import (PriorNoise, SamplerSettings, StepNoise, draw_prior, draw_steps,
                                randomize_position, reverse_diffusion)
from ..utils.logging import log_info


@dataclasses.dataclass
class ComplexJob:
    name: str
    batch: ComplexBatch  # B = 1, bucket-padded, phore-centered
    n_atoms: int         # real (unpadded) ligand atoms


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
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.confidence = None if confidence is None else confidence.to(self.device).eval()
        self.n = samples_per_complex
        self.settings = settings or SamplerSettings()
        self.fitness = fitness
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def draw_noise(self, B: int, T: int) -> Tuple[PriorNoise, StepNoise]:
        return (draw_prior(B, T, self.generator, self.device),
                draw_steps(self.settings.steps, B, T, self.generator, self.device,
                           self.settings.candidates))

    @torch.inference_mode()
    def run_batch(self, batch: ComplexBatch, ref: PhoreArrays, pose_group: int = 1,
                  noise: Optional[Tuple[PriorNoise, StepNoise]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Sample and score one device batch of pose rows; returns the final
        positions (B, A, 3), phore-centered, and the per-row score dict (with
        the head's ``confidence`` row when the engine has a head).  ``ref``
        is row-batched; ``noise`` replays given draws."""
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
                              cfg.sigma_schedule, settings, steps, fitness_fn=fitness_fn)
        scores = score(b)
        if self.confidence is not None:
            scores["confidence"] = self.confidence(b.replace(t=torch.zeros_like(b.t)),
                                                   pose_group=pose_group)[0]
        return b.lig_pos, scores

    def run_complexes(self, jobs: Sequence[ComplexJob],
                      noises: Optional[Sequence[Tuple[PriorNoise, StepNoise]]] = None,
                      skip_failed: bool = False) -> List[Dict]:
        """Sample and score each complex; one result per job, in order:
        poses (n, n_atoms, 3) in the input frame, their fitness, the score
        dict, the head's ``confidence`` (with a head) and ``rank`` (pose
        indices, best first by the confidence when present, else by the
        fitness).  Up to 16 dispatches are in flight before the first result
        is read back.  With ``skip_failed`` a complex whose sampling or read
        back raises is logged and its result is ``{"name", "error"}``; else
        the exception propagates."""
        window = 16
        results: List[Optional[Dict]] = [None] * len(jobs)
        in_flight: List = []

        def failed(i, e):
            if not skip_failed:
                raise e
            log_info(f"sampling {jobs[i].name or i} failed: {e!r}")
            results[i] = {"name": jobs[i].name, "error": repr(e)}

        def pull(i, pos, scores):
            try:
                collect(i, pos, scores)
            except Exception as e:  # noqa: BLE001
                failed(i, e)

        def collect(i, pos, scores):
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
            key = np.asarray(result.get("confidence", result["fitscore"]))
            result["rank"] = np.argsort(key)[::-1]
            results[i] = result

        for i, job in enumerate(jobs):
            batch = repeat_batch(job.batch.to(self.device), self.n).replace(names=(), meta=())
            noise = noises[i] if noises is not None else None
            try:
                pos, scores = self.run_batch(batch, batch_phore_arrays(batch), self.n, noise)
            except Exception as e:  # noqa: BLE001
                failed(i, e)
                continue
            in_flight.append((i, pos, scores))
            if len(in_flight) >= window:
                pull(*in_flight.pop(0))
        for entry in in_flight:
            pull(*entry)
        return results
