"""Pharmacophore fitness scoring by Gaussian volume overlap, batched over
poses, on the device.

Same scores as ``diffphore_tpu.ops.fitscore`` (an AncPhore-compatible
PhScore family): every pose row carries its own reference pharmacophore,
so a batch may mix complexes.

  self_volume(f)   = w_f * 8 * (pi / (2 alpha_f))**1.5
  ov_pct           = V_overlap / V_ref
  ex_pct           = V_exOverlap / exvolume_cutoff
  PhScore_k        = w_o*(ov_pct - ex_pct) + w_p*match_pct + w_a*anchor_pct
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..constants import PHORE_ALPHA, PHORE_WEIGHT
from ..data.featurize import phore_arrays

#: alpha = K / r^2 relating Gaussian sharpness to sphere radius
K_ALPHA = 2.41798725037

#: PhScore (overlap, percent, anchor) coefficients by fitness index
PHSCORE_COEFFS = {
    1: (1.0, 0.0, 0.0),
    2: (0.5, 0.5, 0.0),
    3: (0.5, 0.0, 0.5),
    4: (1.0 / 3, 1.0 / 3, 1.0 / 3),
}

#: knots of the monotone map from the raw phscore1 to AncPhore's scale
PHSCORE1_CAL_KNOTS = (
    (-0.113051, 0.132975, 0.181158, 0.216646, 0.245116, 0.270835, 0.291010,
     0.309699, 0.330984, 0.347223, 0.370010, 0.397535, 0.425741, 0.462761,
     0.512456, 0.671428),
    (-0.676896, 0.090175, 0.140867, 0.161575, 0.188217, 0.192337, 0.203436,
     0.207176, 0.207176, 0.262673, 0.269165, 0.289286, 0.306142, 0.306142,
     0.371636, 0.511553),
)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation with numpy's edge clamping
    (``np.interp`` / ``jnp.interp``); xp increasing."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.numel() - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    f = torch.where(dx == 0, f0, f0 + (x - x0) / torch.where(dx == 0, 1.0, dx) * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def calibrate_phscore1(raw: torch.Tensor) -> torch.Tensor:
    """Strictly increasing raw -> AncPhore-scale map: interpolation between
    the knots, slope extrapolation above the last one, + 1e-3 * raw."""
    kx, ky = PHSCORE1_CAL_KNOTS
    kxa = torch.tensor(kx, dtype=raw.dtype, device=raw.device)
    kya = torch.tensor(ky, dtype=raw.dtype, device=raw.device)
    base = interp(raw, kxa, kya)
    hi_slope = (ky[-1] - ky[-2]) / (kx[-1] - kx[-2])
    base = torch.where(raw > kx[-1], ky[-1] + (raw - kx[-1]) * hi_slope, base)
    return base + 1e-3 * raw


@dataclasses.dataclass
class PhoreArrays:
    """Padded reference-pharmacophore arrays, one row per pose: (B, P, ...)."""

    coord: torch.Tensor        # (B, P, 3)
    type_onehot: torch.Tensor  # (B, P, 11)
    alpha: torch.Tensor        # (B, P)
    weight: torch.Tensor       # (B, P)
    anchor: torch.Tensor       # (B, P)
    is_ex: torch.Tensor        # (B, P) bool
    mask: torch.Tensor         # (B, P) bool

    def replace(self, **changes) -> "PhoreArrays":
        return dataclasses.replace(self, **changes)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def to(self, device) -> "PhoreArrays":
        return self.replace(**{k: v.to(device) for k, v in self.tensors().items()})

    def repeat(self, n: int) -> "PhoreArrays":
        """Each row repeated ``n`` times (B = 1: one complex's pose rows)."""
        return self.replace(**{k: torch.repeat_interleave(v, n, dim=0)
                               for k, v in self.tensors().items()})


def make_phore_arrays(phore, pad: Optional[int] = None) -> PhoreArrays:
    """A phore file's points as one row (B = 1) of CPU tensors, in the
    file's frame, padded to ``pad`` points: the anchor weight is the file's
    last column, where ``batch_phore_arrays`` sets 1."""
    return PhoreArrays(**{k: torch.from_numpy(v) for k, v in phore_arrays(phore, pad).items()})


def batch_phore_arrays(batch) -> PhoreArrays:
    """Per-row reference arrays straight from batch fields (phore-centered
    frame)."""
    return PhoreArrays(
        coord=batch.phore_pos,
        type_onehot=batch.phoretype,
        alpha=batch.phore_x[..., 3],
        weight=batch.phore_x[..., 4],
        anchor=batch.phore_mask.to(torch.float32),
        is_ex=batch.phoretype[..., -1] == 1,
        mask=batch.phore_mask,
    )


def _self_volume(weight, alpha):
    return weight * 8.0 * (torch.pi / (2.0 * alpha)) ** 1.5


def _pair_volume(w1, w2, a1, a2, r2):
    return (torch.sqrt(w1 * w2) * 8.0 * (torch.pi / (a1 + a2)) ** 1.5
            * torch.exp(-a1 * a2 * r2 / (a1 + a2)))


def fitscore(
    lig_coords: torch.Tensor,   # (B, A, 3) poses in the phore's frame
    lig_mask: torch.Tensor,     # (B, A)
    lig_phorefp: torch.Tensor,  # (B, A, 11)
    lig_vdw: torch.Tensor,      # (B, A) van-der-Waals radii
    ref: PhoreArrays,
    exvolume_cutoff: float = 500.0,
    overlap_coeff: float = -1.0,
    percent_coeff: float = -1.0,
    anchor_coeff: float = -1.0,
    combine: str = "max",
    count_fp: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Score each pose row against its reference pharmacophore.
    Returns per-pose (B,) tensors: V_db, V_ref, V_overlap, match_pct,
    V_exOverlap, anchor_pct, ov_pct, ex_pct, fitness, fishing, n_matched,
    n_ref, phscore1..4, phscore1_raw (phscore1 is calibrated).

    ``fitness`` is the custom-coefficient PhScore (score column -6)
    ``overlap_coeff * (ov_pct - ex_pct) + percent_coeff * match_pct +
    anchor_coeff * anchor_pct`` when ``overlap_coeff >= 0``, else the raw
    PhScore1.  ``combine``: how a reference feature's overlap aggregates
    over the ligand's same-type features, "max" (the best-matching one,
    AncPhore's 1:1 feature mapping) or "sum" (every pair volume).
    ``count_fp``: fingerprint for the fishing score's feature count
    (defaults to ``lig_phorefp``)."""
    dev = lig_coords.device
    lm = lig_mask.to(torch.float32)
    feat_mask = ref.mask & ~ref.is_ex                              # (B, P)
    ex_mask = ref.mask & ref.is_ex
    fw = torch.where(feat_mask, ref.weight, 0.0)
    alpha = torch.where(ref.mask, ref.alpha, 1.0)  # padded rows: no inf * 0

    V_ref = _self_volume(fw, alpha).sum(-1)                       # (B,)

    type_w = torch.tensor(PHORE_WEIGHT, dtype=torch.float32, device=dev)
    type_a = torch.tensor(PHORE_ALPHA, dtype=torch.float32, device=dev)
    db_w = lig_phorefp * type_w
    db_active = lig_phorefp * lm[..., None]
    V_db = (_self_volume(db_w, type_a) * db_active).sum(dim=(-2, -1))

    d2 = torch.sum((lig_coords[:, :, None, :] - ref.coord[:, None, :, :]) ** 2, dim=-1)  # (B, A, P)
    ref_t_alpha = (ref.type_onehot * type_a).sum(-1)              # (B, P)
    ref_t_weight_db = (ref.type_onehot * type_w).sum(-1)
    same_type = torch.einsum("bak,bpk->bap", lig_phorefp, ref.type_onehot)
    pair_mask = same_type * lm[..., None] * feat_mask[:, None, :].to(torch.float32)
    vol = _pair_volume(ref.weight[:, None], ref_t_weight_db[:, None], alpha[:, None],
                       ref_t_alpha[:, None], d2) * pair_mask      # (B, A, P)
    per_ref_overlap = vol.sum(-2) if combine == "sum" else vol.max(dim=-2).values  # (B, P)
    V_overlap = per_ref_overlap.sum(-1)

    r_match = torch.sqrt(K_ALPHA / alpha)
    within = (torch.sqrt(torch.clamp(d2, min=0.0)) <= r_match[:, None]) & (pair_mask > 0)
    matched = within.any(dim=-2) & feat_mask                      # (B, P)
    n_ref = torch.clamp(feat_mask.sum(-1), min=1)
    n_matched = matched.sum(-1)
    match_pct = n_matched / n_ref

    anchor_w = torch.where(feat_mask, ref.anchor, 0.0)
    V_anchor = (_self_volume(fw, alpha) * anchor_w).sum(-1)
    anchor_pct = (per_ref_overlap * anchor_w).sum(-1) / torch.clamp(V_anchor, min=1e-9)

    atom_alpha = K_ALPHA / torch.clamp(lig_vdw, min=1e-3) ** 2    # (B, A)
    ex_vol = _pair_volume(ref.weight[:, None], 1.0, alpha[:, None], atom_alpha[..., None], d2)
    ex_vol = ex_vol * (lm[..., None] * ex_mask[:, None, :].to(torch.float32))
    V_ex = ex_vol.sum(dim=(-2, -1))

    ov_pct = V_overlap / torch.clamp(V_ref, min=1e-9)
    ex_pct = V_ex / exvolume_cutoff

    def phscore(w_o, w_p, w_a):
        return w_o * (ov_pct - ex_pct) + w_p * match_pct + w_a * anchor_pct

    n_count_fp = lig_phorefp if count_fp is None else count_fp
    n_db = (n_count_fp * lm[..., None]).sum(dim=(-2, -1))
    phscore1_raw = phscore(*PHSCORE_COEFFS[1])
    phscore1_cal = calibrate_phscore1(phscore1_raw)
    fishing = phscore1_cal * n_matched / torch.clamp(n_db + n_ref - n_matched, min=1.0)
    custom = (phscore(overlap_coeff, percent_coeff, anchor_coeff) if overlap_coeff >= 0
              else phscore1_raw)
    out = {
        "V_db": V_db, "V_ref": V_ref, "V_overlap": V_overlap, "match_pct": match_pct,
        "V_exOverlap": V_ex, "anchor_pct": anchor_pct, "ov_pct": ov_pct, "ex_pct": ex_pct,
        "fitness": custom, "fishing": fishing, "n_matched": n_matched, "n_ref": n_ref,
    }
    for k, coeffs in PHSCORE_COEFFS.items():
        out[f"phscore{k}"] = phscore(*coeffs)
    out["phscore1_raw"] = phscore1_raw
    out["phscore1"] = phscore1_cal
    return out


def fitness_by_index(scores: Dict[str, torch.Tensor], fitness: int = 1) -> torch.Tensor:
    """The score a ``--fitness`` index names: 1-4 = PhScore1-4, 5 = the
    target-fishing score, 6 = the custom-coefficient fitness."""
    table = {1: "phscore1", 2: "phscore2", 3: "phscore3", 4: "phscore4",
             5: "fishing", 6: "fitness"}
    return scores[table.get(fitness, "phscore1")]
