"""Evaluation metrics: pose validity and the RMSD / fitness battery.

Shapes: M complexes x N poses each.  Key names are those of the DiffPhore
evaluation harness, so results compare across the two packages.  The
running-mean meter is ``utils.logging.AverageMeter``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.logging import AverageMeter  # noqa: F401  (the one meter of the package)


def pose_validity(
    poses: np.ndarray,          # (N, A, 3) original frame
    bond_mask: np.ndarray,      # (A, A) covalent adjacency
    ex_coords: np.ndarray,      # (E, 3) exclusion sphere centers
    orig_pos: np.ndarray,       # (A, 3) ground-truth pose
) -> Dict[str, np.ndarray]:
    """Per pose: the centroid's distance to the true pose's, the least
    distance to an exclusion sphere's center, and the least distance between
    two atoms that share no bond."""
    N, A, _ = poses.shape
    centroid = np.linalg.norm(poses.mean(1) - orig_pos.mean(0), axis=-1)
    if len(ex_coords):
        d_ex = np.linalg.norm(poses[:, :, None, :] - ex_coords[None, None], axis=-1)
        min_ex = d_ex.min(axis=(1, 2))
    else:
        min_ex = np.full(N, np.inf)
    d_self = np.linalg.norm(poses[:, :, None, :] - poses[:, None, :, :], axis=-1)
    nonbond = ~bond_mask & ~np.eye(A, dtype=bool)
    d_self = np.where(nonbond[None], d_self, np.inf)
    min_self = d_self.min(axis=(1, 2))
    return {"centroid": centroid, "min_ex": min_ex, "min_self": min_self}


def evaluate_results(
    rmsds: np.ndarray,            # (M, N)
    fitscore: np.ndarray,         # (M, N)
    centroid: np.ndarray,         # (M, N)
    min_ex: np.ndarray,           # (M, N)
    min_self: np.ndarray,         # (M, N)
    run_times: Optional[np.ndarray] = None,
    no_overlap_idx: Optional[np.ndarray] = None,
    topk: Sequence[int] = (1, 5, 10),
    confidence: Optional[np.ndarray] = None,  # (M, N) trained-head scores
) -> Dict[str, float]:
    """The full metric battery: over all poses, then the top-k poses as the
    RMSD (oracle, top 1), the fitness (``rankbyFitscore_``) and, when given,
    the confidence head (``rankbyConfidence_``) rank them; each again over
    the complexes of ``no_overlap_idx`` (``no_overlap_`` prefix)."""
    M, N = rmsds.shape
    topk = [k for k in topk if k <= N]
    out: Dict[str, float] = {}
    perm_by_rmsd = np.argsort(rmsds, axis=1)
    perm_by_fit = np.argsort(fitscore, axis=1)[:, ::-1]
    perm_by_conf = (np.argsort(confidence, axis=1)[:, ::-1]
                    if confidence is not None else None)

    slices = {"": np.arange(M)}
    if no_overlap_idx is not None and len(no_overlap_idx):
        slices["no_overlap_"] = np.asarray(no_overlap_idx)

    for prefix, idx in slices.items():
        r, f = rmsds[idx], fitscore[idx]
        c, me, ms = centroid[idx], min_ex[idx], min_self[idx]
        n_cplx = max(len(r), 1)
        if run_times is not None:
            out[f"{prefix}run_times_std"] = round(float(run_times[idx].std()), 2)
            out[f"{prefix}run_times_mean"] = round(float(run_times[idx].mean()), 2)
        out.update({
            f"{prefix}exclusion_clash_fraction": round(100 * (me < 1.0).sum() / n_cplx / N, 2),
            f"{prefix}self_intersect_fraction": round(100 * (ms < 0.4).sum() / n_cplx / N, 2),
            f"{prefix}mean_rmsd": float(r.mean()),
            f"{prefix}rmsds_below_1": 100 * (r < 1).sum() / n_cplx / N,
            f"{prefix}rmsds_below_2": 100 * (r < 2).sum() / n_cplx / N,
            f"{prefix}rmsds_below_5": 100 * (r < 5).sum() / n_cplx / N,
            f"{prefix}mean_centroid": round(float(c.mean()), 2),
            f"{prefix}centroid_below_2": round(100 * (c < 2).sum() / n_cplx / N, 2),
            f"{prefix}centroid_below_5": round(100 * (c < 5).sum() / n_cplx / N, 2),
            f"{prefix}mean_fitscore": round(float(f.mean()), 2),
            f"{prefix}fitscore_above_0.7": round(100 * (f > 0.7).sum() / n_cplx / N, 2),
            f"{prefix}fitscore_above_0.4": round(100 * (f > 0.4).sum() / n_cplx / N, 2),
        })
        for q in (25, 50, 75):
            out[f"{prefix}rmsds_percentile_{q}"] = round(float(np.percentile(r, q)), 2)
            out[f"{prefix}centroid_percentile_{q}"] = round(float(np.percentile(c, q)), 2)
            out[f"{prefix}fitscore_percentile_{q}"] = round(float(np.percentile(f, q)), 2)

        rankers = [("rmsd", perm_by_rmsd), ("fitscore", perm_by_fit)]
        if perm_by_conf is not None:
            rankers.append(("confidence", perm_by_conf))
        for rankby, perm_all in rankers:
            p = perm_all[idx]
            rr = np.take_along_axis(r, p, axis=1)
            ff = np.take_along_axis(f, p, axis=1)
            cc = np.take_along_axis(c, p, axis=1)
            mss = np.take_along_axis(ms, p, axis=1)
            mee = np.take_along_axis(me, p, axis=1)
            ks = [1] if rankby == "rmsd" else topk
            tag = {"rmsd": "", "fitscore": "rankbyFitscore_",
                   "confidence": "rankbyConfidence_"}[rankby]
            for k in ks:
                rk = rr[:, :k].min(axis=1)
                fk = ff[:, :k].mean(axis=1)
                ck = cc[:, :k].min(axis=1)
                sk = mss[:, :k].min(axis=1)
                ek = mee[:, :k].min(axis=1)
                out.update({
                    f"{prefix}{tag}top{k}_exclusion_clash_fraction": round(100 * (ek < 1.0).mean(), 2),
                    f"{prefix}{tag}top{k}_self_intersect_fraction": round(100 * (sk < 0.4).mean(), 2),
                    f"{prefix}{tag}top{k}_rmsds_below_1": round(100 * (rk < 1).mean(), 2),
                    f"{prefix}{tag}top{k}_rmsds_below_2": round(100 * (rk < 2).mean(), 2),
                    f"{prefix}{tag}top{k}_rmsds_below_5": round(100 * (rk < 5).mean(), 2),
                    f"{prefix}{tag}top{k}_centroid_below_2": round(100 * (ck < 2).mean(), 2),
                    f"{prefix}{tag}top{k}_centroid_below_5": round(100 * (ck < 5).mean(), 2),
                    f"{prefix}{tag}top{k}_fitscore_above_0.7": round(100 * (fk > 0.7).mean(), 2),
                    f"{prefix}{tag}top{k}_fitscore_above_0.4": round(100 * (fk > 0.4).mean(), 2),
                })
                for q in (25, 50, 75):
                    out[f"{prefix}{tag}top{k}_rmsds_percentile_{q}"] = round(float(np.percentile(rk, q)), 2)
                    out[f"{prefix}{tag}top{k}_centroid_percentile_{q}"] = round(float(np.percentile(ck, q)), 2)
                    out[f"{prefix}{tag}top{k}_fitscore_percentile_{q}"] = round(float(np.percentile(fk, q)), 2)
    return out
