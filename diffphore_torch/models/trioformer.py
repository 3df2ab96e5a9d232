"""Trioformer: pair-biased cross attention between the ligand and
pharmacophore node sets, with a pair embedding updated by outer products and
by geometry-aware row attention over intra-set distance matrices.

The encoder runs :class:`GeometricAttention` when ``use_att`` is set;
:class:`TankPhore` (``cli.train --model_type tank``) is a Trioformer trunk
with distance-map and affinity heads.  Sets are dense padded tensors with
masks.  Logits are scaled by ``num_heads ** -0.5`` and masked with -1e9 (a
fully padded row softmaxes to uniform weights), as in the JAX package;
every LayerNorm takes flax's epsilon, 1e-6.  Module names mirror the JAX
package's flax scopes, so a checkpoint converts leaf for leaf.  Plain
einsums and softmax: the JAX package runs no kernel here either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..constants import LIG_FEATURE_DIMS, PHORE_FEATURE_DIMS
from .layers import CategoricalEncoder, Dropout

LN_EPS = 1e-6   # flax nn.LayerNorm's epsilon
NEG = -1e9      # masked logit


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _masked(logits: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return logits
    return torch.where(mask, logits, torch.full_like(logits, NEG))


class MHAWithPairBias(nn.Module):
    """Cross attention q <- set 1, k/v <- set 2 with a per-head pair bias."""

    def __init__(self, inp_dim: int = 16, c: int = 32, num_heads: int = 4, bias: bool = True):
        super().__init__()
        self.c, self.num_heads, self.bias = c, num_heads, bias
        hc = num_heads * c
        self.linear_q = nn.Linear(inp_dim, hc, bias=False)
        self.linear_k = nn.Linear(inp_dim, hc, bias=False)
        self.linear_v = nn.Linear(inp_dim, hc, bias=False)
        if bias:
            self.linear_b = nn.Linear(inp_dim, num_heads, bias=False)
        self.final_linear = nn.Linear(hc, inp_dim)
        self.layernorm = layer_norm(inp_dim)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q (B, Q, D), k and v (B, K, D), mask (B, Q, K) bool, bias (B, Q, K, D)."""
        H, C = self.num_heads, self.c
        B, Q = q.shape[:2]
        qh = self.linear_q(q).reshape(B, Q, H, C)
        kh = self.linear_k(k).reshape(B, -1, H, C)
        vh = self.linear_v(v).reshape(B, -1, H, C)
        logits = torch.einsum("bqhc,bkhc->bhqk", qh, kh) * (H ** -0.5)
        logits = _masked(logits, None if mask is None else mask[:, None])
        if bias is not None and self.bias:
            logits = logits + self.linear_b(bias).permute(0, 3, 1, 2)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhc->bqhc", w, vh).reshape(B, Q, H * C)
        return self.layernorm(self.final_linear(out))


class OuterProductModule(nn.Module):
    """Pair embedding from the mean over channels of node outer products."""

    def __init__(self, in_dim: int, c: int = 16, out_dim: int = 32, bias: bool = False):
        super().__init__()
        self.layernorm_l = layer_norm(in_dim)
        self.layernorm_p = layer_norm(in_dim)
        self.linear_l = nn.Linear(in_dim, c, bias=bias)
        self.linear_p = nn.Linear(in_dim, c, bias=bias)
        self.linear_final = nn.Linear(1, out_dim)

    def forward(self, h_l: torch.Tensor, h_p: torch.Tensor) -> torch.Tensor:
        """h_l (B, A, D), h_p (B, P, D) -> (B, A, P, out_dim)."""
        a = self.linear_l(self.layernorm_l(h_l))
        b = self.linear_p(self.layernorm_p(h_p))
        z = torch.einsum("bic,bjc->bij", a, b)[..., None] / a.shape[-1]
        return self.linear_final(z)


class GeometryConstraintUpdate(nn.Module):
    """Row attention over the pair embedding with a distance bias."""

    def __init__(self, inp_dim: int, c: int = 32, num_heads: int = 8):
        super().__init__()
        self.c, self.num_heads = c, num_heads
        hc = num_heads * c
        self.layernorm = layer_norm(inp_dim)
        self.linear_q = nn.Linear(inp_dim, hc, bias=False)
        self.linear_k = nn.Linear(inp_dim, hc, bias=False)
        self.linear_v = nn.Linear(inp_dim, hc, bias=False)
        self.linear_b = nn.Linear(inp_dim, num_heads, bias=False)
        self.linear_d = nn.Linear(1, num_heads, bias=False)
        self.g = nn.Linear(inp_dim, hc)
        self.final_linear = nn.Linear(hc, inp_dim)

    def forward(self, z_ij: torch.Tensor, d_jk: torch.Tensor,
                mask_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z_ij (B, I, J, D), d_jk (B, J, J, 1), mask_z (B, I, J) bool."""
        H, C = self.num_heads, self.c
        B, I, J, _ = z_ij.shape
        z = self.layernorm(z_ij)
        q = self.linear_q(z).reshape(B, I, J, H, C) * (H ** -0.5)
        k = self.linear_k(z).reshape(B, I, J, H, C)
        v = self.linear_v(z).reshape(B, I, J, H, C)
        b = self.linear_b(z).permute(0, 1, 3, 2)[..., None]          # (B, I, H, J, 1)
        d = self.linear_d(d_jk).permute(0, 3, 1, 2)[:, None]         # (B, 1, H, J, J)
        logits = torch.einsum("biqhc,bikhc->bihqk", q, k) + b + d
        logits = _masked(logits, None if mask_z is None else mask_z[:, :, None, None, :])
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bihqk,bikhc->biqhc", w, v)
        g = torch.sigmoid(self.g(z).reshape(B, I, J, H, C))
        out = self.final_linear((g * out).reshape(B, I, J, H * C))
        if mask_z is not None:
            out = out * mask_z[..., None]
        return out


class Trioformer(nn.Module):
    """One block: node cross attention both ways, transitions, the outer
    product update of the pair embedding and the geometry updates."""

    def __init__(self, inp_dim: int = 16, c: int = 32, num_heads: int = 4, bias: bool = True,
                 c_opm: int = 8, gatt_head: int = 8, dropout: float = 0.0):
        super().__init__()
        self.mha_l = MHAWithPairBias(inp_dim, c, num_heads, bias)
        self.mha_p = MHAWithPairBias(inp_dim, c, num_heads, bias)
        for name in ("transition_l", "transition_p"):
            setattr(self, f"{name}_1", nn.Linear(inp_dim, 2 * inp_dim, bias=False))
            setattr(self, f"{name}_2", nn.Linear(2 * inp_dim, inp_dim, bias=False))
        self.drop = Dropout(dropout)
        self.opm = OuterProductModule(inp_dim, c_opm, inp_dim)
        self.gapu_l = GeometryConstraintUpdate(inp_dim, c, gatt_head)
        self.gapu_p = GeometryConstraintUpdate(inp_dim, c, gatt_head)

    def _transition(self, name: str, x: torch.Tensor) -> torch.Tensor:
        h = self.drop(torch.relu(getattr(self, f"{name}_1")(x)))
        return getattr(self, f"{name}_2")(h)

    def forward(self, h_l, h_p, z_ij, d_ik, d_jk, mask_l=None, mask_p=None):
        mask_z = None
        if mask_l is not None and mask_p is not None:
            mask_z = mask_l[:, :, None] & mask_p[:, None, :]
        mask_zT = None if mask_z is None else mask_z.transpose(1, 2)
        h_l = h_l + self.mha_l(h_l, h_p, h_p, mask_z, z_ij)
        h_p = h_p + self.mha_p(h_p, h_l, h_l, mask_zT, z_ij.transpose(1, 2))
        h_l = h_l + self._transition("transition_l", h_l)
        h_p = h_p + self._transition("transition_p", h_p)
        z_ij = z_ij + self.opm(h_l, h_p)
        upd_l = self.gapu_l(z_ij.transpose(1, 2), d_ik[..., None], mask_zT)
        upd_p = self.gapu_p(z_ij, d_jk[..., None], mask_z)
        return h_l, h_p, z_ij + upd_l.transpose(1, 2) + upd_p


def masked_distances(pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, N) -> (B, N, N) distances, zero where either end is
    padding."""
    d = torch.linalg.norm(pos[:, :, None, :] - pos[:, None, :, :], dim=-1)
    return d * (mask[:, :, None] & mask[:, None, :])


class GeometricAttention(nn.Module):
    """The encoder's ``use_att`` branch: project the node features, run
    ``trioformer_layers`` Trioformer blocks (channels ``2 ns``, 4 heads,
    outer-product width ``ns // 2``, 8 geometry heads, no dropout) over the
    distances of the current pose, return the updated node features and the
    pair embedding z_ij that conditions the cross edges."""

    def __init__(self, ns: int, trioformer_layers: int = 1):
        super().__init__()
        self.trioformer_layers = trioformer_layers
        self.linear_att_l = nn.Linear(ns, ns, bias=False)
        self.linear_att_p = nn.Linear(ns, ns, bias=False)
        self.OPM = OuterProductModule(ns, ns // 2, ns)
        for i in range(trioformer_layers):
            setattr(self, f"trioformer_{i}", Trioformer(ns, 2 * ns, 4, True, ns // 2, 8))

    def forward(self, lig_feat, phore_feat, lig_pos, phore_pos, lig_mask, phore_mask
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h_l = self.linear_att_l(lig_feat)
        h_p = self.linear_att_p(phore_feat)
        d_ik = masked_distances(lig_pos, lig_mask)
        d_jk = masked_distances(phore_pos, phore_mask)
        z_ij = self.OPM(h_l, h_p)
        for i in range(self.trioformer_layers):
            h_l, h_p, z_ij = getattr(self, f"trioformer_{i}")(
                h_l, h_p, z_ij, d_ik, d_jk, lig_mask, phore_mask)
        return h_l, h_p, z_ij


class E3Phore(nn.Module):
    """Standalone Trioformer trunk: node embeddings, then geometric
    attention; its coordinate refinement is the identity, as in the JAX
    package."""

    def __init__(self, hidden_dim: int = 16, n_blocks: int = 8):
        super().__init__()
        self.lig_node_embedding = CategoricalEncoder(hidden_dim, LIG_FEATURE_DIMS)
        self.phore_node_embedding = CategoricalEncoder(hidden_dim, PHORE_FEATURE_DIMS[0],
                                                       num_scalars=PHORE_FEATURE_DIMS[1])
        self.att = GeometricAttention(hidden_dim, n_blocks)

    def forward(self, batch):
        h_l = self.lig_node_embedding(batch.lig_feat)
        h_p = self.phore_node_embedding(batch.phore_x[..., :3].long(), batch.phore_x[..., 3:])
        return self.att(h_l, h_p, batch.lig_pos, batch.phore_pos, batch.lig_mask,
                        batch.phore_mask)


class TankPhore(nn.Module):
    """TANKBind-style model of ``model_type='tank'``: a Trioformer trunk, a
    per-pair head (cross distances under the MSE loss, contact logits under
    the BCE loss) and a per-graph affinity from the masked mean of the pair
    embedding.  ``batch -> (y_pred (B, A, P), affinity_pred (B,))``."""

    def __init__(self, hidden_dim: int = 16, n_blocks: int = 8):
        super().__init__()
        self.trunk = E3Phore(hidden_dim, n_blocks)
        self.dis_head_1 = nn.Linear(hidden_dim, hidden_dim)
        self.dis_head_2 = nn.Linear(hidden_dim, 1)
        self.aff_head_1 = nn.Linear(hidden_dim, hidden_dim)
        self.aff_head_2 = nn.Linear(hidden_dim, 1)

    def forward(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        _, _, z_ij = self.trunk(batch)
        pair_mask = (batch.lig_mask[:, :, None] & batch.phore_mask[:, None, :]).to(z_ij.dtype)
        y_pred = self.dis_head_2(torch.relu(self.dis_head_1(z_ij)))[..., 0]
        pooled = ((z_ij * pair_mask[..., None]).sum((1, 2))
                  / torch.clamp(pair_mask.sum((1, 2)), min=1.0)[:, None])
        affinity_pred = self.aff_head_2(torch.relu(self.aff_head_1(pooled)))[..., 0]
        return y_pred, affinity_pred
