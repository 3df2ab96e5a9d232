"""The DiffPhore score network: encoder + (translation, rotation, torsion)
score heads over dense masked grids.  Outputs are padded: tr/rot (B, 3),
torsion scores (B, T) with ``tor_mask`` marking real bonds."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as Fn
from torch import nn

from ..ops import so3, torus
from ..ops.diffusion import SigmaSchedule, timestep_embedding
from ..ops.sh import irrep1_to_cartesian, normalize_vec, sh_l2, spherical_harmonics_lmax2
from ..ops.tensor_product import _full_tp_paths, full_tensor_product
from .encoder import LigPhoreEncoder
from .layers import MLP, DenseTPConv, Dropout, EquivariantBatchNorm, GaussianSmearing


@dataclasses.dataclass(frozen=True)
class ScoreModelConfig:
    """Model hyperparameters; field names follow the ``model_parameters.yml``
    keys, so a shipped config maps one-to-one."""

    ns: int = 20
    nv: int = 10
    num_conv_layers: int = 4
    sigma_embed_dim: int = 20
    distance_embed_dim: int = 20
    cross_distance_embed_dim: int = 20
    max_radius: float = 5.0
    cross_max_distance: float = 25.0
    center_max_distance: float = 30.0
    dropout: float = 0.1
    no_batch_norm: bool = False
    use_second_order_repr: bool = False
    scale_by_sigma: bool = True
    no_torsion: bool = False
    embedding_type: str = "sinusoidal"
    embedding_scale: float = 10000
    # knowledge guidance
    consider_norm: bool = True
    angle_match: bool = True
    phoretype_match: bool = True
    use_phore_match_feat: bool = True
    cross_distance_transition: bool = True
    phore_direction_transition: bool = True
    phoretype_match_transition: bool = True
    atom_weight: str = "phore"
    scaler: float = 100.0
    multiple: bool = True
    boarder: bool = True
    clash_cutoff: Tuple[float, ...] = (1.0, 2.0, 3.0, 4.0, 5.0)
    by_radius: bool = False
    clash_tolerance: float = 0.4
    auto_phorefp: bool = False
    use_att: bool = False
    trioformer_layer: int = 1
    # tr/rot magnitude head: "norm_gated" (vec/|vec| * MLP) or "linear"
    # (vec * (1 + softplus(MLP)))
    magnitude_head: str = "norm_gated"
    # the convs' edge MLP and aggregate operands: "bfloat16" (every shipped
    # config) or "float32"
    compute_dtype: str = "bfloat16"
    # "channelwise" (every shipped config: uvu weights per edge, a static
    # mix, the kernels) or "fully_connected" (uvw weights per edge, plain
    # PyTorch)
    tp_mode: str = "channelwise"
    use_pallas_fused: bool = False
    phore_knn: int = 0
    # diffusion schedule
    tr_sigma_min: float = 0.1
    tr_sigma_max: float = 5.0
    rot_sigma_min: float = 0.1
    rot_sigma_max: float = 1.5
    tor_sigma_min: float = 0.0314
    tor_sigma_max: float = 3.14

    @property
    def sigma_schedule(self) -> SigmaSchedule:
        return SigmaSchedule(
            self.tr_sigma_min, self.tr_sigma_max,
            self.rot_sigma_min, self.rot_sigma_max,
            self.tor_sigma_min, self.tor_sigma_max,
        )

    @classmethod
    def from_reference_yaml(cls, d: dict) -> "ScoreModelConfig":
        """Build from a ``model_parameters.yml`` dict, ignoring keys that
        belong to training or dataset layers."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if "clash_cutoff" in kw and isinstance(kw["clash_cutoff"], list):
            kw["clash_cutoff"] = tuple(kw["clash_cutoff"])
        return cls(**kw)


#: the torsion head's SH (x) bond-SH product keeps only l <= 1 outputs
_TOR_SH_ARGS = ("1x0e+1x1o+1x2e", "1x2e", ("0e", "1o", "1e"))


class ScoreModel(nn.Module):
    def __init__(self, cfg: ScoreModelConfig):
        super().__init__()
        self.cfg = cfg
        ns, sd, dd = cfg.ns, cfg.sigma_embed_dim, cfg.distance_embed_dim
        bn = not cfg.no_batch_norm
        self.encoder = LigPhoreEncoder(cfg)
        lig_irreps = self.encoder.out_irreps
        self.center_distance_expansion = GaussianSmearing(0.0, cfg.center_max_distance, dd)
        self.center_edge_embedding = MLP(dd + sd, ns, ns, dropout=cfg.dropout)
        self.final_conv = DenseTPConv(lig_irreps, "2x1o + 2x1e", n_edge_features=2 * ns,
                                      batch_norm=bn, dropout=cfg.dropout,
                                      compute_dtype=cfg.compute_dtype, tp_mode=cfg.tp_mode)
        self.head_drop = Dropout(cfg.dropout)
        for name in ("tr_final_layer", "rot_final_layer"):
            setattr(self, f"{name}_dense1", nn.Linear(1 + sd, ns))
            setattr(self, f"{name}_dense2", nn.Linear(ns, 1))
        if not cfg.no_torsion:
            self.tor_distance_expansion = GaussianSmearing(0.0, cfg.max_radius, dd)
            self.final_edge_embedding = MLP(dd, ns, ns, dropout=cfg.dropout)
            tor_sh_irreps = _full_tp_paths(*_TOR_SH_ARGS)[2]
            self.tor_bond_conv = DenseTPConv(lig_irreps, f"{ns}x0o + {ns}x0e",
                                             sh_irreps=repr(tor_sh_irreps),
                                             n_edge_features=3 * ns, batch_norm=bn,
                                             dropout=cfg.dropout,
                                             compute_dtype=cfg.compute_dtype,
                                             tp_mode=cfg.tp_mode)
            self.tor_final_dense1 = nn.Linear(2 * ns, ns, bias=False)
            self.tor_final_dense2 = nn.Linear(ns, 1, bias=False)

    def forward(self, batch, pose_group: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """ComplexBatch -> (tr_pred (B,3), rot_pred (B,3), tor_pred (B,T)).

        ``pose_group``: rows are pose_group poses per complex
        (complex-major), which lets the encoder factor the pose-invariant
        phore tensors exactly."""
        cfg = self.cfg
        ns = cfg.ns
        B, A = batch.lig_pos.shape[:2]
        T = batch.tor_edges.shape[1]
        t = batch.t
        tr_sigma, rot_sigma, tor_sigma = cfg.sigma_schedule(t)
        sigma_emb = timestep_embedding(cfg.embedding_type, cfg.sigma_embed_dim,
                                       cfg.embedding_scale)(t)

        lig_attr, _ = self.encoder(batch, sigma_emb, pose_group=pose_group)

        # ------------------------------------------------ tr/rot star conv
        m = batch.lig_mask.to(torch.float32)
        center = (batch.lig_pos * m[..., None]).sum(1) / torch.clamp(m.sum(1), min=1.0)[:, None]
        center_vec = batch.lig_pos - center[:, None, :]   # receiver = graph, sender = atom
        center_d = torch.linalg.norm(center_vec, dim=-1)
        center_attr = torch.cat(
            [self.center_distance_expansion(center_d),
             sigma_emb[:, None, :].expand(B, A, cfg.sigma_embed_dim)], -1)
        center_attr = self.center_edge_embedding(center_attr)
        center_attr = torch.cat([center_attr, lig_attr[..., :ns]], -1)
        center_sh = spherical_harmonics_lmax2(center_vec)
        global_pred = self.final_conv(
            lig_attr, center_attr[:, None], center_sh[:, None], batch.lig_mask[:, None, :],
            torch.ones((B, 1), dtype=torch.bool, device=lig_attr.device))[:, 0]

        # 1o/1e blocks live in the real-SH basis (y, z, x)
        tr_pred = irrep1_to_cartesian(global_pred[:, 0:3] + global_pred[:, 6:9])
        rot_pred = irrep1_to_cartesian(global_pred[:, 3:6] + global_pred[:, 9:12])

        def magnitude_head(vec, name):
            norm = torch.linalg.norm(vec, dim=-1, keepdim=True)
            h = getattr(self, f"{name}_dense1")(torch.cat([norm, sigma_emb], -1))
            h = torch.relu(self.head_drop(h))
            mag = getattr(self, f"{name}_dense2")(h)
            if cfg.magnitude_head == "linear":
                return vec * (1.0 + Fn.softplus(mag))
            return vec / torch.clamp(norm, min=1e-12) * mag

        tr_pred = magnitude_head(tr_pred, "tr_final_layer")
        rot_pred = magnitude_head(rot_pred, "rot_final_layer")
        if cfg.scale_by_sigma:
            tr_pred = tr_pred / tr_sigma[:, None]
            rot_pred = rot_pred * so3.score_norm(rot_sigma)[:, None]

        if cfg.no_torsion:
            return tr_pred, rot_pred, torch.zeros((B, T), device=tr_pred.device)

        # ------------------------------------------------ torsion head
        tor_edges = batch.tor_edges
        rows = torch.arange(B, device=tor_edges.device)[:, None]
        u, v = tor_edges[..., 0], tor_edges[..., 1]
        pos_u, pos_v = batch.lig_pos[rows, u], batch.lig_pos[rows, v]    # (B, T, 3)
        bond_pos = 0.5 * (pos_u + pos_v)
        bond_vec = pos_v - pos_u
        tor_attr_nodes = lig_attr[rows, u] + lig_attr[rows, v]          # (B, T, D)

        tvec = batch.lig_pos[:, None, :, :] - bond_pos[:, :, None, :]    # (B, T, A, 3)
        td = torch.linalg.norm(tvec, dim=-1)
        tmask = batch.tor_mask[:, :, None] & batch.lig_mask[:, None, :] & (td < cfg.max_radius)
        t_attr = self.final_edge_embedding(self.tor_distance_expansion(td))
        t_attr = torch.cat(
            [t_attr,
             lig_attr[:, None, :, :ns].expand(B, T, A, ns),
             tor_attr_nodes[:, :, None, :ns].expand(B, T, A, ns)], -1)

        edge_sh = spherical_harmonics_lmax2(tvec)              # (B, T, A, 9)
        bond_sh = sh_l2(normalize_vec(bond_vec))               # (B, T, 5)
        tor_sh, _ = full_tensor_product(
            edge_sh, bond_sh[:, :, None, :].expand(B, T, A, 5), *_TOR_SH_ARGS)
        tor_pred = self.tor_bond_conv(lig_attr, t_attr, tor_sh, tmask,
                                      batch.tor_mask)                     # (B, T, 2ns)
        h = self.head_drop(torch.tanh(self.tor_final_dense1(tor_pred)))
        tor_pred = self.tor_final_dense2(h)[..., 0]

        if cfg.scale_by_sigma:
            tor_pred = tor_pred * torch.sqrt(torus.score_norm(tor_sigma))[:, None]
        return tr_pred, rot_pred, tor_pred * batch.tor_mask


# ---------------------------------------------------------------- fresh weights
_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """Truncated normal on [-2, 2] std, variance 1 / fan_in, by inverse CDF."""
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    z = math.sqrt(2.0) * torch.erfinv(2 * u - 1)
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(torch.float32)


def _glorot_uniform(shape, gen: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return ((torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1) * limit).to(
        torch.float32)


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fresh weights with the JAX package's distributions, from a seed: LeCun
    normal for Linear weights and the convs' edge MLPs (``fc_w*``), Glorot
    uniform for embeddings and the convs' mixes (``mix_k``), zero biases,
    identity batch norms.  Drawn on the CPU in module order, so a seed gives
    the same model on any device."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.copy_(_lecun_normal(mod.weight.shape, mod.in_features, gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(_glorot_uniform(mod.weight.shape, gen))
        elif isinstance(mod, DenseTPConv):
            for name, p in mod.named_parameters(recurse=False):
                if name in ("fc_w1", "fc_w2"):
                    p.copy_(_lecun_normal(p.shape, p.shape[0], gen))
                elif name.startswith("mix_"):
                    p.copy_(_glorot_uniform(p.shape, gen))
                else:
                    p.zero_()
        elif isinstance(mod, EquivariantBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)
    return model


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Make every dropout of ``model`` draw its masks from ``generator``."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
