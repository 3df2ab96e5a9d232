"""The port's evaluation metrics (``train/metrics.py``, ``chem/rmsd.py``)
against the JAX package's on the same numpy inputs: the same dicts, key for
key and value for value (both are numpy code, so the values are equal, not
close)."""

import numpy as np
import pytest

from diffphore_torch.chem.rmsd import plain_rmsd as t_plain_rmsd
from diffphore_torch.train import metrics as tm
from diffphore_torch.utils.logging import AverageMeter
from diffphore_tpu.chem.rmsd import plain_rmsd as j_plain_rmsd
from diffphore_tpu.train import metrics as jm


def _battery_inputs(M=7, N=10, seed=0):
    rng = np.random.default_rng(seed)
    return dict(rmsds=rng.gamma(2.0, 1.5, (M, N)), fitscore=rng.uniform(-0.3, 1.0, (M, N)),
                centroid=rng.gamma(2.0, 1.2, (M, N)), min_ex=rng.uniform(0.2, 4.0, (M, N)),
                min_self=rng.uniform(0.1, 2.0, (M, N)))


def test_plain_rmsd_matches_jax():
    rng = np.random.default_rng(1)
    for n in (1, 5, 24):
        a, b = rng.normal(size=(n, 3)) * 3, rng.normal(size=(n, 3)) * 3
        assert t_plain_rmsd(a, b) == j_plain_rmsd(a, b)
    assert t_plain_rmsd(a, a) == 0.0


@pytest.mark.parametrize("n_ex", [0, 3])
def test_pose_validity_matches_jax(n_ex):
    rng = np.random.default_rng(2)
    N, A = 6, 9
    poses = rng.normal(size=(N, A, 3)) * 2
    bond = np.zeros((A, A), bool)
    for i in range(A - 1):
        bond[i, i + 1] = bond[i + 1, i] = True
    ex = rng.normal(size=(n_ex, 3)) * 2
    orig = rng.normal(size=(A, 3))
    got, want = tm.pose_validity(poses, bond, ex, orig), jm.pose_validity(poses, bond, ex, orig)
    assert set(got) == set(want) == {"centroid", "min_ex", "min_self"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("extras", ["none", "confidence", "run_times_no_overlap", "topk_past_n"])
def test_evaluate_results_matches_jax(extras):
    """The whole battery: the rankbyFitscore_ and rankbyConfidence_ top-k
    rows, the no_overlap_ slice and the run-time keys."""
    x = _battery_inputs()
    rng = np.random.default_rng(3)
    kw = {}
    if extras == "confidence":
        kw["confidence"] = rng.normal(size=x["rmsds"].shape)
    elif extras == "run_times_no_overlap":
        kw["run_times"] = rng.uniform(1, 9, x["rmsds"].shape[0])
        kw["no_overlap_idx"] = np.array([0, 2, 5])
    elif extras == "topk_past_n":
        kw["topk"] = (1, 3, 50)
    got = tm.evaluate_results(**x, **kw)
    want = jm.evaluate_results(**x, **kw)
    assert got == want
    assert ("rankbyConfidence_top1_rmsds_below_2" in got) == (extras == "confidence")
    assert ("no_overlap_mean_rmsd" in got) == (extras == "run_times_no_overlap")


def test_average_meter_is_one_class_and_matches_jax():
    """The port keeps one meter (``utils.logging``), and it averages as the
    JAX package's does, per key and per sigma interval."""
    assert tm.AverageMeter is AverageMeter
    ours, theirs = AverageMeter(["loss"]), jm.AverageMeter(["loss"])
    for i, v in enumerate((1.0, 2.5, -0.5, 4.0)):
        for meter in (ours, theirs):
            meter.add({"loss": v, "tr": 2 * v})
            meter.add({"loss": v}, interval_idx=i % 2)
    assert ours.summary() == theirs.summary()
