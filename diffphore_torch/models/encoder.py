"""Knowledge-guided ligand-pharmacophore encoder over dense masked grids:
ligand graph (bond + radius channels on (A, A)), phore graph ((P, P)), and
the knowledge-guided bipartite cross graph on (A, P) with phore-type
agreement weights, learned direction flips, per-atom softmax weights and the
norm-angle alignment channel.

With ``use_att`` a geometric attention block (Trioformer,
``models/trioformer.py``) replaces the node features after the phore graph
is built, and its pair embedding conditions the cross edges: it joins their
attributes and scales their vectors.  With ``0 < phore_knn < P`` the phore
grid is compacted to each receiver's ``phore_knn`` nearest masked senders
(the JAX package's ``jax.lax.top_k`` selection, ties to the lower index):
the phore edge MLP, harmonics and mask run on (P, K) and the phore convs
take the sender index (the kernels' sender-index mode).  The result equals
the dense grid's when K is at least the largest in-degree; below that the
farthest neighbours drop first.  The features go up to l = 1, or to l = 2
with ``use_second_order_repr`` (the 8-lane kernels).  In training mode the
MLPs and convs apply dropout, the convs' batch norms take masked batch
statistics, and the pose-group factoring is off; it is off with ``use_att``
too, whose node features depend on the pose, and with ``phore_knn``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as Fn
from torch import nn

from ..constants import LIG_FEATURE_DIMS, NUM_PHORETYPE, PHORE_FEATURE_DIMS, VDW_TABLE
from ..ops.geometry import angle_between
from ..ops.sh import spherical_harmonics_lmax2
from ..ops.tensor_product import gather_senders
from .layers import MLP, CategoricalEncoder, DenseTPConv, GaussianSmearing, leaky_relu
from .trioformer import GeometricAttention


def irrep_seq(ns: int, nv: int, second_order: bool = False):
    if second_order:
        return [
            f"{ns}x0e",
            f"{ns}x0e + {nv}x1o + {nv}x2e",
            f"{ns}x0e + {nv}x1o + {nv}x2e + {nv}x1e + {nv}x2o",
            f"{ns}x0e + {nv}x1o + {nv}x2e + {nv}x1e + {nv}x2o + {ns}x0o",
        ]
    return [
        f"{ns}x0e",
        f"{ns}x0e + {nv}x1o",
        f"{ns}x0e + {nv}x1o + {nv}x1e",
        f"{ns}x0e + {nv}x1o + {nv}x1e + {ns}x0o",
    ]


def _pair_attr(edge: torch.Tensor, recv: torch.Tensor, send: torch.Tensor) -> torch.Tensor:
    """concat([edge (B,N,M,e), recv (B,N,r) over senders, send (B,M,s) over
    receivers, or (B,N,M,s) already per receiver (a sender-index grid)])
    -> (B, N, M, e+r+s)."""
    B, N, M = edge.shape[:3]
    # the receiver's view is made first: autograd adds a node tensor's
    # gradients in an order set by when its uses were made, so this order is
    # part of the gradients' bits
    recv = recv[:, :, None, :].expand(B, N, M, recv.shape[-1])
    if send.dim() == 3:
        send = send[:, None, :, :].expand(B, N, M, send.shape[-1])
    return torch.cat([edge, recv, send], dim=-1)


def knn_senders(sel: torch.Tensor, k: int) -> torch.Tensor:
    """Each receiver's ``k`` smallest keys of ``sel`` (B, N, M) -> their
    indices (B, N, k) int64, in ascending order with ties to the lower
    index: ``jax.lax.top_k(-sel, k)``'s indices, bit for bit (a stable
    sort; ``torch.topk`` promises no order among ties)."""
    return torch.sort(sel, dim=-1, stable=True).indices[..., :k]


class LigPhoreEncoder(nn.Module):
    """Produces per-atom and per-phore-point equivariant features."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.phore_knn < 0:
            raise ValueError(f"phore_knn {cfg.phore_knn}: 0 (the dense grid) or a count")
        if cfg.tp_mode not in ("channelwise", "fully_connected"):
            raise ValueError(f"tp_mode {cfg.tp_mode!r}: channelwise or fully_connected")
        self.cfg = cfg
        ns, sd = cfg.ns, cfg.sigma_embed_dim
        self.ns = ns
        self.num_conv_layers = cfg.num_conv_layers
        self.lig_distance_expansion = GaussianSmearing(0.0, cfg.max_radius, cfg.distance_embed_dim)
        self.phore_distance_expansion = GaussianSmearing(0.0, cfg.max_radius, cfg.distance_embed_dim)
        self.cross_distance_expansion = GaussianSmearing(
            0.0, cfg.cross_max_distance, cfg.cross_distance_embed_dim)

        self.lig_node_embedding = CategoricalEncoder(ns, LIG_FEATURE_DIMS, num_scalars=sd)
        if cfg.boarder:
            n_flags = 1 if cfg.by_radius else len(cfg.clash_cutoff)
            self.boarder_embedding = CategoricalEncoder(ns, [2] * n_flags, num_scalars=1)
        self.lig_edge_embedding = MLP(4 + sd + cfg.distance_embed_dim, ns, ns, dropout=cfg.dropout)
        self.phore_node_embedding = CategoricalEncoder(
            ns, PHORE_FEATURE_DIMS[0], num_scalars=PHORE_FEATURE_DIMS[1] + sd)
        self.phore_edge_embedding = MLP(sd + cfg.distance_embed_dim, ns, ns, dropout=cfg.dropout)

        cross_in = sd + cfg.cross_distance_embed_dim
        if cfg.phoretype_match or cfg.angle_match:
            if cfg.phoretype_match:
                if cfg.cross_distance_transition:
                    self.cross_distance_transition = MLP(
                        cfg.cross_distance_embed_dim, cfg.cross_distance_embed_dim // 2, 1,
                        dropout=cfg.dropout)
                if cfg.phoretype_match_transition:
                    self.phoretype_match_transition = MLP(
                        3 * NUM_PHORETYPE, NUM_PHORETYPE, 1, dropout=cfg.dropout)
                if cfg.phore_direction_transition:
                    self.phore_direction_transition = MLP(
                        1, NUM_PHORETYPE, 1, activation=leaky_relu, dropout=cfg.dropout)
                if cfg.use_phore_match_feat:
                    cross_in += 3 * NUM_PHORETYPE
            if cfg.use_att:
                cross_in += ns
                self.mlp_att = MLP(ns, 2 * ns, 1, activation=leaky_relu, dropout=cfg.dropout)
        if cfg.use_att:
            self.geometric_attention = GeometricAttention(ns, cfg.trioformer_layer)
        self.cross_edge_embedding = MLP(cross_in, ns, ns, dropout=cfg.dropout)

        seq = irrep_seq(ns, cfg.nv, cfg.use_second_order_repr)
        self.out_irreps = seq[min(cfg.num_conv_layers, len(seq) - 1)]

        def conv(i):
            return DenseTPConv(seq[min(i, len(seq) - 1)], seq[min(i + 1, len(seq) - 1)],
                               n_edge_features=3 * ns, hidden_features=3 * ns,
                               batch_norm=not cfg.no_batch_norm, dropout=cfg.dropout,
                               compute_dtype=cfg.compute_dtype, tp_mode=cfg.tp_mode)

        for l in range(cfg.num_conv_layers):
            setattr(self, f"lig_conv_{l}", conv(l))
            setattr(self, f"phore_to_lig_conv_{l}", conv(l))
            if cfg.consider_norm:
                setattr(self, f"phore_to_lig_norm_conv_{l}", conv(l))
            if l != cfg.num_conv_layers - 1:
                setattr(self, f"phore_conv_{l}", conv(l))
                setattr(self, f"lig_to_phore_conv_{l}", conv(l))
                if cfg.consider_norm:
                    setattr(self, f"lig_to_phore_norm_conv_{l}", conv(l))

    def forward(self, batch, sigma_emb: torch.Tensor,
                pose_group: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Args:
          batch: ComplexBatch.
          sigma_emb: (B, sigma_embed_dim) diffusion-time embedding.
          pose_group: rows are ``pose_group`` poses of each complex,
            complex-major.  The phore-side tensors and the whole layer-0
            phore conv depend only on (phore, sigma), so they are computed
            on one representative row per complex and repeated: exact, not
            an approximation.  Ignored (1) when B is not divisible, in
            training mode (dropout and batch statistics differ per row),
            with ``use_att`` (the attention mixes the pose into the phore
            features) and with ``phore_knn``, as in the JAX package.
        Returns:
          (lig_node_attr (B, A, D_out), phore_node_attr (B, P, D_phore)).
        """
        cfg, ns = self.cfg, self.ns
        B, A = batch.lig_pos.shape[:2]
        P = batch.phore_pos.shape[1]
        lig_mask, phore_mask = batch.lig_mask, batch.phore_mask
        pg = int(pose_group) if pose_group else 1
        if pg > 1 and (B % pg or self.training or cfg.use_att or cfg.phore_knn):
            pg = 1

        def rep_b(x):
            return torch.repeat_interleave(x, pg, dim=0) if pg > 1 else x

        sd = sigma_emb.shape[-1]
        node_sigma = sigma_emb[:, None, :].expand(B, A, sd)
        phore_sigma = sigma_emb[:, None, :].expand(B, P, sd)

        # ---------------- ligand nodes (+ exclusion-volume clashes)
        lig_node_attr = self.lig_node_embedding(batch.lig_feat, node_sigma)
        if cfg.boarder:
            lig_node_attr = lig_node_attr + self._boarder_embedding(batch)

        # ---------------- ligand intra graph: bond + radius channels on (A, A)
        lig_vec = batch.lig_pos[:, None, :, :] - batch.lig_pos[:, :, None, :]  # recv a, send a'
        lig_d = torch.linalg.norm(lig_vec, dim=-1)
        eye = torch.eye(A, dtype=torch.bool, device=lig_d.device)
        pair_valid = lig_mask[:, :, None] & lig_mask[:, None, :] & ~eye
        radius_mask = pair_valid & (lig_d < cfg.max_radius)
        bond_mask = batch.bond_mask & pair_valid
        d_emb = self.lig_distance_expansion(lig_d)
        sig_e = node_sigma[:, :, None, :].expand(B, A, A, sd)
        attr_bond = torch.cat([batch.bond_attr, sig_e, d_emb], -1)
        attr_rad = torch.cat([torch.zeros_like(batch.bond_attr), sig_e, d_emb], -1)
        lig_edge_attr = [self.lig_edge_embedding(attr_bond), self.lig_edge_embedding(attr_rad)]
        lig_edge_sh = spherical_harmonics_lmax2(lig_vec)

        # ---------------- phore graph on the C = B / pg representative rows
        C = B // pg
        phore_cat = batch.phore_x[::pg, :, :3].long()
        phore_sigma_c = phore_sigma[::pg]
        phore_mask_c = phore_mask[::pg]
        phore_node_attr_c = self.phore_node_embedding(
            phore_cat, torch.cat([batch.phore_x[::pg, :, 3:], phore_sigma_c], -1))
        phore_pos_c = batch.phore_pos[::pg]
        p_vec = phore_pos_c[:, None, :, :] - phore_pos_c[:, :, None, :]
        p_d = torch.linalg.norm(p_vec, dim=-1)
        p_pair_mask_c = (batch.phore_edge_mask[::pg]
                         & phore_mask_c[:, :, None] & phore_mask_c[:, None, :])
        # the KNN grid: each receiver's K nearest masked senders; every
        # phore-phore edge tensor on (P, K).  A row with fewer than K live
        # senders keeps masked slots (distance inf), dead everywhere below.
        phore_nbr = None
        if 0 < cfg.phore_knn < P:
            sel = torch.where(p_pair_mask_c, p_d, torch.full_like(p_d, float("inf")))
            nbr = knn_senders(sel, cfg.phore_knn)                    # (B, P, K)
            p_pair_mask_c = torch.gather(p_pair_mask_c, 2, nbr)
            p_vec = gather_senders(phore_pos_c, nbr) - phore_pos_c[:, :, None, :]
            p_d = torch.gather(p_d, 2, nbr)
            phore_nbr = nbr.to(torch.int32).contiguous()
        M_p = p_d.shape[-1]                                          # P, or K
        p_attr = torch.cat([phore_sigma_c[:, :, None, :].expand(C, P, M_p, sd),
                            self.phore_distance_expansion(p_d)], -1)
        phore_edge_attr_c = self.phore_edge_embedding(p_attr)
        phore_edge_sh_c = spherical_harmonics_lmax2(p_vec)
        phore_node_attr = rep_b(phore_node_attr_c)
        phore_edge_attr = rep_b(phore_edge_attr_c)
        phore_edge_sh = rep_b(phore_edge_sh_c)
        p_pair_mask = rep_b(p_pair_mask_c)

        # ---------------- geometric attention: Trioformer-updated node
        # features and the pair embedding of the cross edges
        z_ij = None
        if cfg.use_att:
            lig_node_attr, phore_node_attr, z_ij = self.geometric_attention(
                lig_node_attr, phore_node_attr, batch.lig_pos, batch.phore_pos,
                lig_mask, phore_mask)

        # ---------------- knowledge-guided cross graph on (A, P)
        cross_attr, cross_sh, cross_norm_sh, cross_mask = self._cross_graph(
            batch, node_sigma, z_ij)
        cross_sh_T = cross_sh.transpose(1, 2).contiguous()
        cross_norm_sh_T = cross_norm_sh.transpose(1, 2).contiguous()
        cross_mask_T = cross_mask.transpose(1, 2).contiguous()
        cross_attr_T_edge = cross_attr.transpose(1, 2)

        # ---------------- message passing
        for l in range(self.num_conv_layers):
            last = l == self.num_conv_layers - 1
            lig_sc = lig_node_attr[..., :ns]
            phore_sc = phore_node_attr[..., :ns]

            # ligand <- ligand (bond and radius channels)
            lig_intra = getattr(self, f"lig_conv_{l}")(
                lig_node_attr, [_pair_attr(e, lig_sc, lig_sc) for e in lig_edge_attr],
                lig_edge_sh, [bond_mask, radius_mask], lig_mask)

            # ligand <- phore (and the norm channel)
            cross_attr_l = _pair_attr(cross_attr, lig_sc, phore_sc)
            lig_inter = getattr(self, f"phore_to_lig_conv_{l}")(
                phore_node_attr, cross_attr_l, cross_sh, cross_mask, lig_mask)
            lig_inter_norm = 0.0
            if cfg.consider_norm:
                lig_inter_norm = getattr(self, f"phore_to_lig_norm_conv_{l}")(
                    phore_node_attr, cross_attr_l, cross_norm_sh, cross_mask, lig_mask)

            if not last:
                phore_conv = getattr(self, f"phore_conv_{l}")
                if l == 0 and pg > 1:
                    # the layer-0 phore conv sees no cross message yet: one
                    # run per complex, repeated over its poses
                    phore_sc_c = phore_node_attr_c[..., :ns]
                    phore_intra = rep_b(phore_conv(
                        phore_node_attr_c, _pair_attr(phore_edge_attr_c, phore_sc_c, phore_sc_c),
                        phore_edge_sh_c, p_pair_mask_c, phore_mask_c))
                else:
                    send_sc = (phore_sc if phore_nbr is None
                               else gather_senders(phore_sc, phore_nbr))   # (B, P, K, ns)
                    phore_intra = phore_conv(
                        phore_node_attr, _pair_attr(phore_edge_attr, phore_sc, send_sc),
                        phore_edge_sh, p_pair_mask, phore_mask, sender_index=phore_nbr)
                # phore <- ligand: the transposed cross grid, with the
                # receiver (phore) and sender (ligand) scalars in the
                # reference's part order [edge, lig_sc, phore_sc]
                cross_attr_T = torch.cat(
                    [cross_attr_T_edge,
                     lig_sc[:, None, :, :].expand(B, P, A, ns),
                     phore_sc[:, :, None, :].expand(B, P, A, ns)], dim=-1)
                phore_inter = getattr(self, f"lig_to_phore_conv_{l}")(
                    lig_node_attr, cross_attr_T, cross_sh_T, cross_mask_T, phore_mask)
                phore_inter_norm = 0.0
                if cfg.consider_norm:
                    phore_inter_norm = getattr(self, f"lig_to_phore_norm_conv_{l}")(
                        lig_node_attr, cross_attr_T, cross_norm_sh_T, cross_mask_T, phore_mask)

            pad = lig_intra.shape[-1] - lig_node_attr.shape[-1]
            lig_node_attr = Fn.pad(lig_node_attr, (0, pad))
            lig_node_attr = lig_node_attr + lig_intra + lig_inter + lig_inter_norm
            if not last:
                pad = phore_intra.shape[-1] - phore_node_attr.shape[-1]
                phore_node_attr = Fn.pad(phore_node_attr, (0, pad))
                phore_node_attr = phore_node_attr + phore_intra + phore_inter + phore_inter_norm

        return lig_node_attr, phore_node_attr

    # ------------------------------------------------------------------ parts
    def _boarder_embedding(self, batch) -> torch.Tensor:
        """Exclusion-volume clash features: min distance from each atom to any
        EX sphere -> one-hot clash flags at the cutoffs + the distance."""
        cfg = self.cfg
        ex_mask = (batch.phoretype[..., -1] == 1) & batch.phore_mask  # (B, P)
        d = torch.linalg.norm(batch.lig_pos[:, :, None, :] - batch.phore_pos[:, None, :, :], dim=-1)
        d = torch.where(ex_mask[:, None, :], d, torch.full_like(d, 1e9))
        dis_min = torch.clamp(d.min(dim=-1).values, max=1e2)  # (B, A)
        if cfg.by_radius:
            radii = torch.as_tensor(VDW_TABLE, device=dis_min.device)
            r_atom = radii[batch.lig_feat[..., 0]]
            r_ex = (2.41798725037 / 0.837) ** 0.5
            clashed = (dis_min - r_atom - r_ex <= cfg.clash_tolerance)[..., None]
        else:
            cut = torch.as_tensor(cfg.clash_cutoff, dtype=torch.float32, device=dis_min.device)
            clashed = dis_min[..., None] <= cut  # (B, A, K)
        return self.boarder_embedding(clashed.long(), dis_min[..., None])

    def _cross_graph(self, batch, node_sigma: torch.Tensor, z_ij=None):
        """The knowledge-guided (A, P) bipartite grid: edge attrs, edge
        harmonics, norm-alignment harmonics and the mask.  ``z_ij`` (B, A, P,
        ns), the geometric attention's pair embedding, joins the attributes
        and scales the edge vectors."""
        cfg = self.cfg
        B, A = batch.lig_pos.shape[:2]
        P = batch.phore_pos.shape[1]
        lig_fp = batch.lig_phorefp
        cross_mask = batch.lig_mask[:, :, None] & batch.phore_mask[:, None, :]

        edge_vec = batch.phore_pos[:, None, :, :] - batch.lig_pos[:, :, None, :]
        edge_len = torch.linalg.norm(edge_vec, dim=-1)
        len_emb = self.cross_distance_expansion(edge_len)
        sig_e = node_sigma[:, :, None, :].expand(B, A, P, node_sigma.shape[-1])
        edge_attr = torch.cat([sig_e, len_emb], -1)

        rotate_norm = torch.zeros_like(edge_vec)
        if cfg.phoretype_match or cfg.angle_match:
            # type agreement: phoretype[p] * phorefp[a]
            aggreement = batch.phoretype[:, None, :, :] * lig_fp[:, :, None, :]
            phoretype_attr = torch.cat(
                [aggreement,
                 batch.phoretype[:, None, :, :].expand(B, A, P, NUM_PHORETYPE),
                 lig_fp[:, :, None, :].expand(B, A, P, NUM_PHORETYPE)], -1)

            if cfg.phoretype_match:
                total_weight = torch.ones((B, A, P, 1), device=edge_vec.device)
                if cfg.cross_distance_transition:
                    total_weight = total_weight * Fn.softplus(
                        self.cross_distance_transition(len_emb))
                if cfg.phoretype_match_transition:
                    total_weight = total_weight * Fn.softplus(
                        self.phoretype_match_transition(phoretype_attr))
                total_weight = total_weight * cfg.scaler
                if cfg.phore_direction_transition:
                    dir_logit = leaky_relu(self.phore_direction_transition(total_weight))
                    direction = torch.where(dir_logit < 0, -1.0, 1.0)
                    edge_vec = edge_vec * direction

                # masked softmax with a finite floor: fully padded rows get
                # harmless uniform weights instead of NaN
                neg = torch.tensor(-1e9, device=edge_vec.device)
                if cfg.atom_weight in ("softmax", "atomwise"):
                    logits = torch.where(cross_mask[..., None], total_weight, neg)
                    aw = torch.softmax(logits.reshape(B, A * P), dim=-1).reshape(B, A, P, 1)
                elif cfg.atom_weight == "sigmoid":
                    aw = torch.sigmoid(total_weight)
                elif cfg.atom_weight == "phore":
                    logits = torch.where(cross_mask[..., None], total_weight, neg)
                    aw = torch.softmax(logits, dim=2)
                else:
                    aw = 1.0
                total_weight = total_weight * aw + 1e-12 if cfg.multiple else aw
                edge_vec = edge_vec * total_weight

                if cfg.use_phore_match_feat:
                    edge_attr = torch.cat([edge_attr, phoretype_attr], -1)

            if z_ij is not None:
                edge_attr = torch.cat([edge_attr, z_ij], -1)
                edge_vec = edge_vec * leaky_relu(self.mlp_att(z_ij))

            if cfg.angle_match:
                # ligand norm selected by type agreement (B, A, P, 3)
                lig_norm_sel = torch.einsum("bapk,bkac->bapc", aggreement, batch.lig_norm)
                pnorm = batch.phore_norm[:, None, :, :].expand(lig_norm_sel.shape)
                cross_np = torch.linalg.cross(lig_norm_sel, pnorm, dim=-1)
                agg_sum = aggreement.sum(-1, keepdim=True)
                rot = cross_np * agg_sum
                rot = rot / torch.clamp(torch.linalg.norm(rot, dim=-1, keepdim=True), min=1e-12)
                curr_angle = angle_between(lig_norm_sel, pnorm)[..., None]
                a1 = torch.einsum("bapk,bak->bap", aggreement, batch.lig_norm_angle1)[..., None]
                a2 = torch.einsum("bapk,bak->bap", aggreement, batch.lig_norm_angle2)[..., None]
                d1, d2 = curr_angle - a1, curr_angle - a2
                norm_real = torch.where(torch.abs(d1) <= torch.abs(d2), d1, d2)
                rotate_norm = rot * norm_real

        edge_sh = spherical_harmonics_lmax2(edge_vec)
        edge_norm_sh = spherical_harmonics_lmax2(rotate_norm, zero_safe=True)
        edge_attr = self.cross_edge_embedding(edge_attr)
        return edge_attr, edge_sh, edge_norm_sh, cross_mask
