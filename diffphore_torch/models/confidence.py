"""Confidence head: predict a pose's quality from the encoder's embedding.

The score model's encoder trunk (``encoder``), a masked mean over the ligand
scalar channels, and a small MLP (``confidence_head``) that emits three
numbers per pose: the fitness (or, for heads trained with the ``rmsd_lt2``
label, the logit of RMSD < 2 A), the pharmacophore overlap and the
exclusion overlap.  The head computes in f32 whatever the convolutions'
``compute_dtype``.  Module names mirror the JAX package's flax scopes, so a
shipped head (``runs/corpus2/confidence``) converts leaf for leaf.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.diffusion import timestep_embedding
from .encoder import LigPhoreEncoder
from .layers import MLP


class ConfidenceModel(nn.Module):
    def __init__(self, cfg, confidence_dropout: float = 0.0, num_confidence_outputs: int = 3):
        super().__init__()
        self.cfg = cfg
        self.encoder = LigPhoreEncoder(cfg)
        self.confidence_head = MLP(cfg.ns, 2 * cfg.ns, num_confidence_outputs,
                                   dropout=confidence_dropout)

    def forward(self, batch, pose_group: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """ComplexBatch -> (fit, ph, ex), each (B,).  ``pose_group`` as in
        ``ScoreModel.forward``."""
        cfg = self.cfg
        sigma_emb = timestep_embedding(cfg.embedding_type, cfg.sigma_embed_dim,
                                       cfg.embedding_scale)(batch.t)
        lig_attr, _ = self.encoder(batch, sigma_emb, pose_group=pose_group)
        m = batch.lig_mask.to(torch.float32)
        pooled = ((lig_attr[..., :cfg.ns] * m[..., None]).sum(1)
                  / torch.clamp(m.sum(1), min=1.0)[:, None])
        out = self.confidence_head(pooled)
        return out[:, 0], out[:, 1], out[:, 2]
