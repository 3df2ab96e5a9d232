"""Device time of the port's redesigned kernels, one kernel at a time.

    python -m diffphore_torch.cli.profile_kernels

Runs K1 (``ops.tp_fused``) and K2 (``ops.tp_aggregate``: its forward, its
edge backward and its dx) on synthetic inputs at the shapes of the main
paths (serving: 40 poses of a 24 x 96 x 8 complex; training: batch 24 of
that bucket; corpus2 widths) under ``torch.profiler`` and prints one JSON
object per case: the device time of each CUDA kernel of the call, in
microseconds per call.  A call of a wrapper may launch two kernels, which
the per-call times of ``chip_smoke.py`` do not tell apart.  Padded graphs
keep their live atoms and phore points first, so the masks (and K2's
pre-masked edge weights) here are live on the first ``live_n`` receivers
and ``live_m`` senders.  It is the quick way to compare two versions of a
kernel: run it on both trees in one call on one card (the K2 forward and
dx cases call only ``launch_forward`` and ``launch_backward_x``, which
every version of the port has; the K3 cases call K3's forward and dx per
convolution where the tree has that interface, else per path, as the
first K3 did).  It needs a GPU and fails without one.

    python -m diffphore_torch.cli.profile_kernels [--k2_only | --k3_only | --k1_l2 | --k3_index |
                                                   --k2_l2 | --k2_edge_l2 | --k2_index | --k3_l2 |
                                                   --k1_wide]

``--k3_only`` times K3's forward, edge backward (``launch_backward_edge``
as the train step calls it: dsh on the two convs whose harmonics carry a
gradient) and dx of the six layer-0 training convs (f32, and bf16 where the
tree takes it): the profiler's device time of each kernel, and
``graph_us``, the time per conv of a CUDA graph of its calls replayed,
launch gaps included.  Every tree since K3's forward became one launch per
convolution has ``launch_backward_edge`` with this signature, so the edge
backward compares across them.  Beside each edge backward, ``fill_us`` is
the graph-replay time of ``fill_(0)`` on a tensor of dw's size: writing dw
alone.

``--k1_l2`` times the 8-lane K1 (``tp_fused_l2_kernel``, f32 and bf16) on
the 23 conv signatures of one forward of a second-order model at corpus2's
widths (F up to 360, 30 paths, D = 200, E = H = 60), at the serving shapes
(40 poses of a 24 x 96 x 8 complex) and the step's (24 rows of that bucket),
then in the sender-index mode on the 3 phore convs at K = 24; a summary line
per (mode, rows, dtype) sums the 23 (or 3) calls.  ``--k3_index`` times K3's
sender-index forward, dw and dx at 4 and 8 lanes on the layer-0 phore conv
of a 24-row step at K = 24, on an index of nearest live phore points (uneven
loads: some points are among the nearest of most receivers, padded ones of
none), the forward and dw beside their byte bound and the gathered einsum.  Both
print ``graph_us`` beside the profiler's per-kernel times.  ``--k1_l2`` runs
unchanged in a tree from before the 8-lane K1's redesign; in a tree from
before the sender-index dx's, ``--k3_index`` needs ``lists`` to be that
tree's ``tp_fused.sender_lists(idx, P)``.

``--k2_l2`` times the dense 8-lane K2 forward and dx (f32 and bf16; dx on
the live bits of w made beforehand, as the train step's forward makes them,
where the tree's dx takes them): on the
17 training convs of a second-order model at corpus2's widths (batch 24 of a
24 x 96 x 8 bucket, live-first edge weights as in ``K2_CASES``), with a
summary line per (kernel, dtype) that sums the 17; then on each of the six
widths of that model (F = 60, 80, 140, 180, 300, 360) at 24 x 24 x 96, 24 x
96 x 24 and 24 x 24 x 24 (B x N x M).  Both print ``graph_us`` beside the
profiler's per-kernel times.  It calls only ``launch_forward`` and
``launch_backward_x``, so it runs unchanged in a tree from before the
kernels' redesign.

``--k2_edge_l2`` times the 8-lane K2 edge backward on those 17 convs as the
train step runs it (dsh on the five cross convs, dw alone on the others;
on w's live bits where the tree's edge backward takes them), f32 and bf16,
with summary lines over the 17, the five and the twelve.  ``--k2_index``
times K2's sender-index forward, dw and dx at 4 and 8 lanes on the KNN
step's two K2 calls (24 rows, 96 phore points, K = 24, a nearest-live-point
index): the forward as the step calls it (with the live pass over w where
the tree's forward makes it), dx on the lists (and live bits) made
beforehand, as the autograd forward makes them, ``live_us`` the live pass
alone; a summary per (kernel, lanes, dtype), and a ``step`` line per
(lanes, dtype) that sums the forward, dx and, where the tree's forward does
not run it, the live pass.  ``--k3_l2`` times K3's 8-lane forward, dx and
edge backward (dsh where the step asks for it) on the six layer-0 convs of a
second-order training step (``K3_CASES`` shapes, 20x0e -> SEQ2[1], g (B, N,
F, 8)), f32 and bf16, with a summary line per (kernel, dtype); the forward's
and the edge backward's lines carry their blocks an SM and the forward's
grid (``k3_l2_plan``).  Both call
only ``launch_forward``, ``launch_backward_edge`` and ``launch_backward_x``,
so they run unchanged in a tree from before these kernels' redesign.

``--k1_wide`` times K1's wide forms on the 23 conv calls of one 40-pose
forward of a fresh model wider than corpus2 (a 24 x 96 x 8 complex; the
shapes of ``chip_smoke.py`` phase 19), f32 and bf16, by graph replay
(``graph_us``), and the plain version on the same inputs (``event_us``):
the 4-lane form at ns / nv = 32 / 16 (l <= 1; its
final_conv, E = 64, takes the narrow kernel), dense and in the
sender-index mode on the 3 phore convs at K = 24, and the 8-lane form at
48 / 10, l = 2.  Each conv's line carries its plan (form, staged, senders a
block, splits, channel tiles); a summary line per (form, mode, dtype) sums
the calls, all and wide only.  It calls only ``tp_aggregate_fused``, its
plain version and ``plan``, so it runs unchanged in a tree from before the wide forms'
redesign (A B B A against ``git archive`` of the parent).
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..ops import tp_aggregate, tp_fused, tp_scalar
from ..ops.tensor_product import channelwise_tp

SEQ = ["20x0e", "20x0e + 10x1o", "20x0e + 10x1o + 10x1e", "20x0e + 10x1o + 10x1e + 20x0o"]
SH = "1x0e + 1x1o + 1x2e"
E = 60
CALLS = 10
#: (conv layer, B, N, M, live_n, live_m) of K1 at the serving shapes
K1_CASES = [(0, 40, 24, 96, 20, 32), (3, 40, 24, 96, 20, 32), (2, 40, 96, 24, 32, 20),
            (2, 40, 96, 96, 32, 32), (3, 40, 24, 24, 20, 20)]
#: (conv layer, B, N, M) of the edge backward with dsh at the training shapes
EDGE_CASES = [(1, 24, 24, 96), (2, 24, 96, 24), (3, 24, 24, 96)]
#: (conv name, in irreps, sh irreps, out irreps, B, N, M, live_n, live_m) of
#: K2's forward and dx at the distinct shapes of the 17 training convs (batch
#: 24, corpus2 widths); live_n x live_m / (N x M) is near the share of live
#: edges those convs have (11-48%)
K2_CASES = [
    ("lig_conv_1", SEQ[1], SH, SEQ[2], 24, 24, 24, 10, 9),
    ("lig_conv_2", SEQ[2], SH, SEQ[3], 24, 24, 24, 10, 9),
    ("lig_conv_3", SEQ[3], SH, SEQ[3], 24, 24, 24, 10, 9),
    ("phore_to_lig_conv_1", SEQ[1], SH, SEQ[2], 24, 24, 96, 20, 42),
    ("phore_to_lig_conv_2", SEQ[2], SH, SEQ[3], 24, 24, 96, 20, 42),
    ("phore_to_lig_conv_3", SEQ[3], SH, SEQ[3], 24, 24, 96, 20, 42),
    ("phore_conv_1", SEQ[1], SH, SEQ[2], 24, 96, 96, 32, 32),
    ("phore_conv_2", SEQ[2], SH, SEQ[3], 24, 96, 96, 32, 32),
    ("lig_to_phore_conv_1", SEQ[1], SH, SEQ[2], 24, 96, 24, 42, 20),
    ("lig_to_phore_conv_2", SEQ[2], SH, SEQ[3], 24, 96, 24, 42, 20),
    ("final_conv", SEQ[3], SH, "2x1o + 2x1e", 24, 1, 24, 1, 12),
    ("tor_bond_conv", SEQ[3], "1x1o + 1x0e + 1x1e", "20x0o + 20x0e", 24, 8, 24, 4, 7),
]


#: (conv name, B, N, M, live_n, live_m, dsh) of K3 at the six layer-0
#: training convs; dsh: the harmonics carry a gradient
SEQ2 = ["20x0e", "20x0e + 10x1o + 10x2e", "20x0e + 10x1o + 10x2e + 10x1e + 10x2o",
        "20x0e + 10x1o + 10x2e + 10x1e + 10x2o + 20x0o"]
#: (conv, in irreps, sh irreps, out irreps, E, N, M, channels, live_n, live_m)
#: of the 23 conv calls of one second-order forward (a 24 x 96 x 8 complex:
#: 24 ligand atoms, 96 phore points); phore_conv_0 runs once per complex
#: (pose-group factoring), so its rows are 1
K1_L2_CASES = (
    [(f"lig_conv_{i}", SEQ2[i], SH, SEQ2[min(i + 1, 3)], 60, 24, 24, 2, 20, 20) for i in range(4)]
    + [(f"phore_to_lig{t}_conv_{i}", SEQ2[i], SH, SEQ2[min(i + 1, 3)], 60, 24, 96, 1, 20, 32)
       for i in range(4) for t in ("", "_norm")]
    + [(f"phore_conv_{i}", SEQ2[i], SH, SEQ2[i + 1], 60, 96, 96, 1, 32, 32) for i in range(3)]
    + [(f"lig_to_phore{t}_conv_{i}", SEQ2[i], SH, SEQ2[i + 1], 60, 96, 24, 1, 32, 20)
       for i in range(3) for t in ("", "_norm")]
    + [("final_conv", SEQ2[3], SH, "2x1o + 2x1e", 40, 1, 24, 1, 1, 20),
       ("tor_bond_conv", SEQ2[3], "1x1o + 1x0e + 1x1e", "20x0o + 20x0e", 60, 8, 24, 1, 4, 20)])
KNN_K = 24
#: (conv, in irreps, sh irreps, out irreps, N, M, live_n, live_m) of the 17
#: convs of a second-order training forward that K2 takes (every conv but the
#: six layer-0 ones, which K3 takes), at batch 24 of a 24 x 96 x 8 bucket
K2_L2_CASES = (
    [(f"lig_conv_{i}", SEQ2[i], SH, SEQ2[min(i + 1, 3)], 24, 24, 10, 9) for i in (1, 2, 3)]
    + [(f"phore_to_lig{t}_conv_{i}", SEQ2[i], SH, SEQ2[min(i + 1, 3)], 24, 96, 20, 42)
       for i in (1, 2, 3) for t in ("", "_norm")]
    + [(f"phore_conv_{i}", SEQ2[i], SH, SEQ2[i + 1], 96, 96, 32, 32) for i in (1, 2)]
    + [(f"lig_to_phore{t}_conv_{i}", SEQ2[i], SH, SEQ2[i + 1], 96, 24, 42, 20)
       for i in (1, 2) for t in ("", "_norm")]
    + [("final_conv", SEQ2[3], SH, "2x1o + 2x1e", 1, 24, 1, 12),
       ("tor_bond_conv", SEQ2[3], "1x1o + 1x0e + 1x1e", "20x0o + 20x0e", 8, 24, 4, 7)])
#: (F, in irreps, sh irreps, out irreps) of the six widths of that model
K2_L2_WIDTHS = [(60, SEQ2[0], SH, SEQ2[1]),
                (80, SEQ2[3], "1x1o + 1x0e + 1x1e", "20x0o + 20x0e"),
                (140, SEQ2[3], SH, "2x1o + 2x1e"), (180, SEQ2[1], SH, SEQ2[2]),
                (300, SEQ2[2], SH, SEQ2[3]), (360, SEQ2[3], SH, SEQ2[3])]
#: (B, N, M, live_n, live_m) of the width sweep
K2_L2_SHAPES = [(24, 24, 96, 20, 42), (24, 96, 24, 42, 20), (24, 24, 24, 10, 9)]

K3_CASES = [
    ("lig_conv_0", 24, 24, 24, 10, 9, False),
    ("phore_to_lig_conv_0", 24, 24, 96, 20, 42, True),
    ("phore_to_lig_norm_conv_0", 24, 24, 96, 20, 42, False),
    ("phore_conv_0", 24, 96, 96, 32, 32, False),
    ("lig_to_phore_conv_0", 24, 96, 24, 42, 20, True),
    ("lig_to_phore_norm_conv_0", 24, 96, 24, 42, 20, False),
]


def graph_us(fn, iters: int = 20, replays: int = 3) -> float:
    """us per call of ``fn`` on the card: its calls captured into a CUDA
    graph and the graph replayed (launch gaps included, the host's time to
    make a call not)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (iters * replays)


def event_us(fn, iters: int = 3) -> float:
    """us per call of ``fn`` between two CUDA events, after one call (for
    code a graph may not capture: the plain versions)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def k3_calls(tp, x, sh, w, g):
    """(forward, dx) of one convolution through this tree's K3: one call for
    the convolution, or, in a tree whose K3 takes one path per call, one
    call per path on the convolution's views."""
    if "tp" in inspect.signature(tp_scalar.launch_forward).parameters:
        return (lambda: tp_scalar.launch_forward(tp, x, sh, w),
                lambda: tp_scalar.launch_backward_x(tp, x, sh, w, g))
    B, N = sh.shape[:2]
    out = torch.zeros((B, N, tp.weight_numel, 4), device="cuda")
    dx = torch.zeros_like(x)
    views = tp_scalar.path_views(tp, x, sh, w)

    def forward():
        for p, (xv, shv, wv) in zip(tp.paths, views):
            tp_scalar.launch_forward(xv, shv, wv,
                                     out[:, :, p.w_slice[0]:p.w_slice[1], :shv.shape[-1]])

    def backward_x():
        for i, (p, (xv, shv, wv)) in enumerate(zip(tp.paths, views)):
            gv = g[:, :, p.w_slice[0]:p.w_slice[1], :shv.shape[-1]]
            tp_scalar.launch_backward_x(shv, wv, gv, dx, accumulate=i > 0)
    return forward, backward_x


def _device_us(event) -> float:
    # the attribute was renamed from *cuda* to *device* in torch 2.4
    return float(getattr(event, "device_time_total", getattr(event, "cuda_time_total", 0.0)))


def kernel_times(fn) -> dict:
    """{kernel name: device us per call} of the port's kernels that ``fn`` launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(anonymous namespace)::")[-1].split("(")[0]: _device_us(e) / CALLS
            for e in prof.key_averages() if "tp_" in e.key and _device_us(e) > 0}


def knn_index(B: int, P: int, K: int, gen: torch.Generator):
    """(index (B, P, K) int32, receiver mask (B, P)): each row's phore points
    at random positions, the first 30-60 live; every receiver takes its K
    nearest live points (a padded receiver too: its slots are masked)."""
    pos = torch.rand((B, P, 3), device="cuda", generator=gen) * 20.0
    live_n = torch.randint(30, 61, (B,), device="cuda", generator=gen)
    live = torch.arange(P, device="cuda")[None, :] < live_n[:, None]
    d = torch.cdist(pos, pos).masked_fill(~live[:, None, :], float("inf"))
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :K].to(torch.int32).contiguous()
    return idx, live


def k1_l2_cases(randn, gen, card) -> list:
    """The 8-lane K1 on K1_L2_CASES at 40 and 24 rows, dense, then the
    sender-index mode on the phore convs; f32 and bf16."""
    results = []
    for rows in (40, 24):
        for indexed in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                total = {"kernel": "tp_fused_l2" + ("_idx" if indexed else ""), "rows": rows,
                         "dtype": str(dtype), "calls": 0, "us_total": 0.0, "graph_us": 0.0,
                         "card": card}
                for name, irr_in, irr_sh, irr_out, E, N, M, C, live_n, live_m in K1_L2_CASES:
                    if indexed and not name.startswith("phore_conv"):
                        continue
                    tp = channelwise_tp(irr_in, irr_sh, irr_out)
                    F = tp.weight_numel
                    B = 1 if name == "phore_conv_0" and not indexed else rows
                    kw, m_x = {}, M
                    if indexed:
                        idx, live = knn_index(B, M, KNN_K, gen)
                        kw, M = {"sender_index": idx}, KNN_K
                        masks = [(live[:, :, None] & torch.ones(B, N, M, dtype=torch.bool,
                                                                device="cuda")).contiguous()]
                    else:
                        masks = []
                        for c in range(C):
                            m = torch.zeros(B, N, M, dtype=torch.bool, device="cuda")
                            m[:, :live_n, :live_m - 4 * c] = True
                            masks.append(m)
                    x = randn(B, m_x, tp.irreps_in.dim).to(dtype)
                    sh = randn(B, N, M, tp.irreps_sh.dim).to(dtype)
                    attrs = [randn(B, N, M, E).to(dtype) for _ in range(C)]
                    params = (randn(E, E) * 0.1, randn(E) * 0.1, randn(E, F) * 0.1,
                              randn(F) * 0.1)
                    call = lambda: tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params,
                                                               **kw)
                    with torch.no_grad():
                        times = kernel_times(call)
                        g_us = graph_us(call)
                    results.append({"kernel": total["kernel"], "conv": name, "dtype": str(dtype),
                                    "B": B, "N": N, "M": M, "F": F, "C": C,
                                    "live_edges": int(masks[0].sum()), "us": times,
                                    "us_total": sum(times.values()), "graph_us": g_us,
                                    "card": card})
                    print(json.dumps(results[-1]), flush=True)
                    total["calls"] += 1
                    total["us_total"] += results[-1]["us_total"]
                    total["graph_us"] += g_us
                results.append(total)
                print(json.dumps(total), flush=True)
    return results


#: (N, M, edge channels, live_n, live_m) of a conv of one 40-pose forward
#: (24 ligand atoms, 96 phore points), by the conv's name
K1_WIDE_SHAPES = {"lig_conv": (24, 24, 2, 20, 20), "phore_to_lig": (24, 96, 1, 20, 32),
                  "phore_conv": (96, 96, 1, 32, 32), "lig_to_phore": (96, 24, 1, 32, 20),
                  "final_conv": (1, 24, 1, 1, 20), "tor_bond_conv": (8, 24, 1, 4, 20)}
#: (tag, ns, nv, l = 2, sender-index) of the wide forms' cases
K1_WIDE_MODELS = (("4-lane 32-16", 32, 16, False, False), ("4-lane 32-16", 32, 16, False, True),
                  ("8-lane 48-10 l2", 48, 10, True, False))


def k1_wide_inputs(randn, gen):
    """(tag, conv name, dtype, tp, x, sh, attrs, masks, params, kwargs) of
    each call of K1_WIDE_MODELS' forwards, f32 then bf16 by model: the
    inputs of ``--k1_wide`` (and of ``analysis/k1_wide_variants.py``)."""
    from ..models.layers import DenseTPConv
    from ..models.score_model import ScoreModel, ScoreModelConfig

    for tag, ns, nv, l2, indexed in K1_WIDE_MODELS:
        model = ScoreModel(ScoreModelConfig(ns=ns, nv=nv, use_second_order_repr=l2))
        convs = [(n.split(".")[-1], m) for n, m in model.named_modules()
                 if isinstance(m, DenseTPConv) and m.channelwise]
        assert len(convs) == 23, len(convs)
        for dtype in (torch.float32, torch.bfloat16):
            for name, conv in convs:
                if indexed and not name.startswith("phore_conv"):
                    continue
                N, M, C, live_n, live_m = next(v for k, v in K1_WIDE_SHAPES.items()
                                               if name.startswith(k))
                tp = conv.tp
                E, H = conv.fc_w1.shape
                F = tp.weight_numel
                B = 1 if name == "phore_conv_0" and not indexed else 40
                kw, m_x = {}, M
                if indexed:
                    idx, live = knn_index(B, M, KNN_K, gen)
                    kw, M = {"sender_index": idx}, KNN_K
                    masks = [(live[:, :, None] & torch.ones(B, N, M, dtype=torch.bool,
                                                            device="cuda")).contiguous()]
                else:
                    masks = []
                    for c in range(C):
                        m = torch.zeros(B, N, M, dtype=torch.bool, device="cuda")
                        m[:, :live_n, :live_m - 4 * c] = True
                        masks.append(m)
                x = randn(B, m_x, tp.irreps_in.dim).to(dtype)
                sh = randn(B, N, M, tp.irreps_sh.dim).to(dtype)
                attrs = [randn(B, N, M, E).to(dtype) for _ in range(len(masks))]
                params = (randn(E, H) / E ** 0.5, randn(H) * 0.1, randn(H, F) / H ** 0.5,
                          randn(F) * 0.1)
                yield (tag, indexed), name, dtype, tp, x, sh, attrs, masks, params, kw


def k1_wide_cases(randn, gen, card) -> list:
    """K1's wide forms on the 23 conv calls of one forward of the fresh
    models of K1_WIDE_MODELS (the sender-index mode on the phore convs),
    f32 and bf16, by graph replay; the plain version
    (``tp_aggregate_fused_plain``) on the same inputs between CUDA
    events."""
    results, totals = [], {}
    for (tag, indexed), name, dtype, tp, x, sh, attrs, masks, params, kw in k1_wide_inputs(
            randn, gen):
        B, N, M, _ = sh.shape
        E, H = params[0].shape
        pl = tp_fused.plan(tp, B, N, M, len(masks), E, H, x.element_size(), indexed)
        call = lambda: tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params, **kw)
        with torch.no_grad():
            g_us = graph_us(call)
            plain_us = event_us(lambda: tp_fused.tp_aggregate_fused_plain(
                tp, x, sh, attrs, masks, *params, **kw))
        results.append({"form": tag, "conv": name, "indexed": indexed, "dtype": str(dtype),
                        "B": B, "N": N, "M": M, "C": len(masks), "E": E,
                        "F": tp.weight_numel, "wide": pl.wide,
                        "staged": getattr(pl, "staged", None), "per_block": pl.per_block,
                        "splits": pl.splits, "tiles": len(pl.tiles), "smem": pl.smem,
                        "live_edges": int(masks[0].sum()), "graph_us": g_us,
                        "plain_us": plain_us, "card": card})
        print(json.dumps(results[-1]), flush=True)
        total = totals.setdefault((tag, indexed, str(dtype)), {
            "form": tag, "indexed": indexed, "dtype": str(dtype), "calls": 0, "graph_us": 0.0,
            "wide_calls": 0, "wide_graph_us": 0.0, "plain_us": 0.0, "card": card})
        total["calls"] += 1
        total["graph_us"] += g_us
        total["plain_us"] += plain_us
        if pl.wide:
            total["wide_calls"] += 1
            total["wide_graph_us"] += g_us
    for total in totals.values():
        results.append(total)
        print(json.dumps(total), flush=True)
    return results


def k3_index_cases(randn, gen, card) -> list:
    """K3's sender-index forward, edge backward (dw) and dx on the layer-0
    phore conv of a 24-row step at K = 24, at 4 and 8 lanes, f32 and bf16:
    per-kernel device time and graph_us, dx with the index's lists built
    beforehand (as the autograd forward builds them); beside the forward
    and dw their byte bound (each operand read once, each result written
    once, at 3.35 TB/s) and ``library_us``, the graph-replay time of the
    gather of the senders and the gathered per-path torch.einsum of the
    same function.  It calls only ``launch_forward``,
    ``launch_backward_edge`` and ``launch_backward_x``, so it runs unchanged
    in a tree from before the sender-index forward's and dw's redesign."""
    results = []
    B, P = 24, 96
    idx, live = knn_index(B, P, KNN_K, gen)
    count = torch.bincount((idx.long() + P * torch.arange(B, device="cuda")[:, None, None])
                           .flatten(), minlength=B * P)
    rows = (idx.long() + P * torch.arange(B, device="cuda")[:, None, None]).reshape(B, P * KNN_K)
    for lanes_, seq in ((4, SEQ), (8, SEQ2)):
        tp = channelwise_tp(seq[0], SH, seq[1])
        F, D = tp.weight_numel, tp.irreps_in.dim
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(B, P, D).to(dtype)
            sh = randn(B, P, KNN_K, 9).to(dtype)
            w = (randn(B, P, KNN_K, F) * live[:, :, None, None]).to(dtype).contiguous()
            g = randn(B, P, F, lanes_)
            lists = tp_scalar.dx_lists(tp, idx, P, dtype)
            es = x.element_size()
            io = {"x": B * P * D * es, "sh": B * P * KNN_K * 9 * es, "w": B * P * KNN_K * F * es,
                  "idx": B * P * KNN_K * 4, "g": B * P * F * lanes_ * 4}

            def gathered():                   # the senders' rows by slot, then the einsums
                xg = x.reshape(B * P, D)[rows.reshape(-1)].reshape(B, P, KNN_K, D)
                return [torch.einsum("bnku,bnkj,bnku->bnuj", xv, shv, wv)
                        for xv, shv, wv in tp_scalar.path_views(tp, xg, sh, w)]

            def gathered_dw():
                xg = x.reshape(B * P, D)[rows.reshape(-1)].reshape(B, P, KNN_K, D)
                gv = g.to(dtype)
                return [torch.einsum("bnku,bnkj,bnuj->bnku", xv, shv,
                                     gv[:, :, p.w_slice[0]:p.w_slice[1], :shv.shape[-1]])
                        for p, (xv, shv, _) in zip(tp.paths,
                                                   tp_scalar.path_views(tp, xg, sh, w))]

            for kernel, call, nbytes, library in (
                    ("tp_scalar_fwd_idx", lambda: tp_scalar.launch_forward(
                        tp, x, sh, w, sender_index=idx),
                     io["x"] + io["sh"] + io["w"] + io["idx"] + B * P * F * lanes_ * 4,
                     gathered),
                    ("tp_scalar_bwd_edge_idx", lambda: tp_scalar.launch_backward_edge(
                        tp, x, sh, w, g, False, sender_index=idx),
                     io["x"] + io["sh"] + io["idx"] + io["g"] + io["w"], gathered_dw),
                    ("tp_scalar_bwd_x_idx", lambda: tp_scalar.launch_backward_x(
                        tp, x, sh, w, g, sender_index=idx, lists=lists), None, None)):
                times = kernel_times(call)
                results.append({"kernel": kernel, "lanes": lanes_, "dtype": str(dtype), "B": B,
                                "N": P, "K": KNN_K, "M_x": P, "F": F,
                                "slots_per_sender_max": int(count.max()),
                                "slots_per_sender_mean": float(count.float().mean()),
                                "senders_read": int((count > 0).sum()), "us": times,
                                "us_total": sum(times.values()), "graph_us": graph_us(call),
                                "card": card})
                if nbytes is not None:
                    results[-1]["bound_us"] = nbytes / 3.35e12 * 1e6
                    results[-1]["library_us"] = graph_us(library)
                print(json.dumps(results[-1]), flush=True)
    return results


def k2_l2_cases(randn, card) -> list:
    """The dense 8-lane K2 forward and dx on K2_L2_CASES (with one summary
    per (kernel, dtype)) and on K2_L2_WIDTHS x K2_L2_SHAPES, f32 and bf16."""
    results = []

    def one(tp, B, N, M, live_n, live_m, dtype, tag):
        F = tp.weight_numel
        x = randn(B, M, tp.irreps_in.dim).to(dtype)
        sh = randn(B, N, M, tp.irreps_sh.dim).to(dtype)
        w = torch.zeros(B, N, M, F, device="cuda")
        w[:, :live_n, :live_m] = randn(B, live_n, live_m, F)
        w = w.to(dtype)
        g = randn(B, N, F, 8)
        # dx as the train step runs it: on the live bits the forward made,
        # in a tree whose dx takes them
        kw = ({"live": tp_aggregate.live_rows_l2(w)}
              if "live" in inspect.signature(tp_aggregate.launch_backward_x).parameters else {})
        out = []
        for kernel, call in (
                ("tp_aggregate_fwd_l2", lambda: tp_aggregate.launch_forward(tp, x, sh, w)),
                ("tp_aggregate_bwd_x_l2",
                 lambda: tp_aggregate.launch_backward_x(tp, x, sh, w, g, **kw))):
            times = kernel_times(call)
            out.append({"kernel": kernel, "case": tag, "dtype": str(dtype), "B": B, "N": N,
                        "M": M, "F": F, "live_edges": B * live_n * live_m, "edges": B * N * M,
                        "us": times, "us_total": sum(times.values()), "graph_us": graph_us(call),
                        "card": card})
            print(json.dumps(out[-1]), flush=True)
        return out

    for dtype in (torch.float32, torch.bfloat16):
        sums = {k: {"kernel": k, "case": "the 17 training convs", "dtype": str(dtype), "calls": 0,
                    "us_total": 0.0, "graph_us": 0.0, "card": card}
                for k in ("tp_aggregate_fwd_l2", "tp_aggregate_bwd_x_l2")}
        for name, irr_in, irr_sh, irr_out, N, M, live_n, live_m in K2_L2_CASES:
            for r in one(channelwise_tp(irr_in, irr_sh, irr_out), 24, N, M, live_n, live_m,
                         dtype, name):
                total = sums[r["kernel"]]
                total["calls"] += 1
                total["us_total"] += r["us_total"]
                total["graph_us"] += r["graph_us"]
                results.append(r)
        for total in sums.values():
            results.append(total)
            print(json.dumps(total), flush=True)
    for F, irr_in, irr_sh, irr_out in K2_L2_WIDTHS:
        tp = channelwise_tp(irr_in, irr_sh, irr_out)
        assert tp.weight_numel == F
        for B, N, M, live_n, live_m in K2_L2_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                results += one(tp, B, N, M, live_n, live_m, dtype, f"F={F}")
    return results


#: the 17 convs' edge backward as the step runs it: dsh on the cross convs
#: (their harmonics carry a gradient), dw alone on the others
def _step_dsh(name: str) -> bool:
    return name.startswith(("phore_to_lig_conv", "lig_to_phore_conv"))


def k2_edge_l2_cases(randn, card) -> list:
    """The 8-lane K2 edge backward on K2_L2_CASES (f32 and bf16), with dsh
    where the step asks for it, on the live bits of w made beforehand where
    the tree's edge backward takes them (the train step's forward makes
    them); a summary line per (kernel, dtype) sums the 17, and one each the
    convs with dsh and without."""
    results = []
    takes_live = "live" in inspect.signature(tp_aggregate.launch_backward_edge).parameters
    for dtype in (torch.float32, torch.bfloat16):
        sums = {k: {"kernel": "tp_aggregate_bwd_edge_l2", "case": k, "dtype": str(dtype),
                    "calls": 0, "us_total": 0.0, "graph_us": 0.0, "card": card}
                for k in ("the 17 training convs", "with dsh", "dw only")}
        for name, irr_in, irr_sh, irr_out, N, M, live_n, live_m in K2_L2_CASES:
            tp = channelwise_tp(irr_in, irr_sh, irr_out)
            F, B, dsh = tp.weight_numel, 24, _step_dsh(name)
            x = randn(B, M, tp.irreps_in.dim).to(dtype)
            sh = randn(B, N, M, tp.irreps_sh.dim).to(dtype)
            w = torch.zeros(B, N, M, F, device="cuda")
            w[:, :live_n, :live_m] = randn(B, live_n, live_m, F)
            w = w.to(dtype)
            g = randn(B, N, F, 8)
            kw = {"live": tp_aggregate.live_rows_l2(w)} if takes_live and dsh else {}
            call = lambda: tp_aggregate.launch_backward_edge(tp, x, sh, w, g, dsh, **kw)
            times = kernel_times(call)
            r = {"kernel": "tp_aggregate_bwd_edge_l2", "conv": name, "dtype": str(dtype), "B": B,
                 "N": N, "M": M, "F": F, "dsh": dsh, "live_edges": B * live_n * live_m,
                 "edges": B * N * M, "us": times, "us_total": sum(times.values()),
                 "graph_us": graph_us(call), "card": card}
            results.append(r)
            print(json.dumps(r), flush=True)
            for k in ("the 17 training convs", "with dsh" if dsh else "dw only"):
                sums[k]["calls"] += 1
                sums[k]["us_total"] += r["us_total"]
                sums[k]["graph_us"] += r["graph_us"]
        for total in sums.values():
            results.append(total)
            print(json.dumps(total), flush=True)
    return results


#: (conv, layer) of the KNN step's K2 calls: the phore convs past layer 0
K2_INDEX_CONVS = [("phore_conv_1", 1), ("phore_conv_2", 2)]


def k2_index_cases(randn, gen, card) -> list:
    """K2's sender-index forward, dw and dx at 4 and 8 lanes (f32 and bf16)
    on the KNN step's two K2 calls (24 rows, 96 phore points, K = 24, a
    nearest-live-point index, dead receivers' rows of w zero): the forward
    as the step calls it, dx with the index's lists and (where the tree's dx
    takes them) w's live bits made beforehand, as the autograd forward makes
    them; ``live_us`` is that live pass's graph-replay time.  A summary line
    per (kernel, lanes, dtype) sums the two calls, and a ``step`` line the
    forward and dx with the live pass once (in the forward where the tree's
    forward makes it)."""
    results = []
    B, P, K = 24, 96, KNN_K
    idx, live = knn_index(B, P, K, gen)
    dx_params = inspect.signature(tp_aggregate.launch_backward_x).parameters
    new_lists = hasattr(tp_aggregate, "idx_dx_lists")
    fwd_live = hasattr(tp_aggregate, "forward_idx")      # the forward runs the live pass
    for lanes_, seq in ((4, SEQ), (8, SEQ2)):
        for dtype in (torch.float32, torch.bfloat16):
            sums = {k: {"kernel": k, "lanes": lanes_, "case": "the KNN step's 2 calls",
                        "dtype": str(dtype), "calls": 0, "us_total": 0.0, "graph_us": 0.0,
                        "card": card}
                    for k in ("tp_aggregate_fwd_idx", "tp_aggregate_bwd_edge_idx",
                              "tp_aggregate_bwd_x_idx")}
            live_sum = 0.0
            for name, layer in K2_INDEX_CONVS:
                tp = channelwise_tp(seq[layer], SH, seq[layer + 1])
                F = tp.weight_numel
                x = randn(B, P, tp.irreps_in.dim).to(dtype)
                sh = randn(B, P, K, 9).to(dtype)
                w = (randn(B, P, K, F) * live[:, :, None, None]).to(dtype).contiguous()
                g = randn(B, P, F, lanes_)
                kw = ({"lists": tp_aggregate.idx_dx_lists(idx, P)} if new_lists
                      else {"lists": tp_fused.sender_lists(idx, P)})
                if "live" in dx_params:
                    kw["live"] = tp_aggregate.live_rows_l2(w)
                for kernel, call in (
                        ("tp_aggregate_fwd_idx", lambda: tp_aggregate.launch_forward(
                            tp, x, sh, w, sender_index=idx)),
                        ("tp_aggregate_bwd_edge_idx", lambda: tp_aggregate.launch_backward_edge(
                            tp, x, sh, w, g, False, sender_index=idx)),
                        ("tp_aggregate_bwd_x_idx", lambda: tp_aggregate.launch_backward_x(
                            tp, x, sh, w, g, sender_index=idx, **kw))):
                    times = kernel_times(call)
                    r = {"kernel": kernel, "conv": name, "lanes": lanes_, "dtype": str(dtype),
                         "B": B, "N": P, "K": K, "F": F, "us": times,
                         "us_total": sum(times.values()), "graph_us": graph_us(call),
                         "card": card}
                    if kernel == "tp_aggregate_bwd_x_idx":
                        r["live_us"] = graph_us(lambda: tp_aggregate.live_rows_l2(w))
                        live_sum += r["live_us"]
                    results.append(r)
                    print(json.dumps(r), flush=True)
                    sums[kernel]["calls"] += 1
                    sums[kernel]["us_total"] += r["us_total"]
                    sums[kernel]["graph_us"] += r["graph_us"]
            for total in sums.values():
                results.append(total)
                print(json.dumps(total), flush=True)
            step = {"kernel": "step: tp_aggregate_fwd_idx + tp_aggregate_bwd_x_idx + live pass",
                    "lanes": lanes_, "case": "the KNN step's 2 calls", "dtype": str(dtype),
                    "live_in_forward": fwd_live, "live_us": live_sum,
                    "graph_us": sums["tp_aggregate_fwd_idx"]["graph_us"]
                    + sums["tp_aggregate_bwd_x_idx"]["graph_us"] + (0.0 if fwd_live else live_sum),
                    "card": card}
            results.append(step)
            print(json.dumps(step), flush=True)
    return results


def k3_l2_plan(tp, B, N, M, dtype, dsh) -> dict:
    """The blocks an SM of this tree's 8-lane K3 forward and edge backward
    (from their occupancy queries) and the forward's grid: its
    (receivers, slices, staged senders) a block where the tree has the
    whole-receiver forward, else its sender splits."""
    device, bf16 = "cuda:0", dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    F, S, D = tp.weight_numel, tp.irreps_sh.dim, tp.irreps_in.dim
    if hasattr(tp_scalar, "launch_plan_fwd_l2"):
        t = tp_scalar.units_l2(tp, dtype)
        n_items = int(t.comp_ptr[-1])
        return {"fwd_blocks_per_sm": tp_scalar._resident_blocks_f2(
                    F, len(t.units), S, D, t.vec, bf16, device) // sms,
                "fwd_plan": list(tp_scalar.launch_plan_fwd_l2(tp, B, N, M, device, dtype)),
                "edge_blocks_per_sm": tp_scalar._edge_blocks_l2(
                    dsh, t.vec, S, n_items, *(len(t.units),) * hasattr(tp_scalar, "E2_UNITS"),
                    bf16, device) // sms}
    n_items = len(tp_scalar._conv_tables(tp, dtype)[3])
    return {"fwd_blocks_per_sm": tp_scalar._resident_blocks(0, F, D, n_items, bf16, device,
                                                           True) // sms,
            "fwd_splits": tp_scalar.launch_chunk(tp, B, N, M, False, device, dtype)[1],
            "edge_blocks_per_sm": tp_scalar._edge_blocks(dsh, bf16, device, True) // sms}


def k3_l2_cases(randn, card) -> list:
    """K3's 8-lane forward, dx and edge backward (dsh where the step asks
    for it) on the six layer-0 convs of a second-order training step
    (``K3_CASES`` shapes, 20x0e -> SEQ2[1], F = 60, g (B, N, F, 8)), f32 and
    bf16: per-kernel device time and graph_us per conv (the forward's and
    the edge backward's lines with :func:`k3_l2_plan`), and a summary line
    per (kernel, dtype) over the six."""
    results = []
    tp = channelwise_tp(SEQ2[0], SH, SEQ2[1])
    F = tp.weight_numel
    for dtype in (torch.float32, torch.bfloat16):
        sums = {k: {"kernel": k, "case": "the 6 layer-0 convs", "dtype": str(dtype), "calls": 0,
                    "us_total": 0.0, "graph_us": 0.0, "card": card}
                for k in ("tp_scalar_fwd_l2", "tp_scalar_bwd_x_l2", "tp_scalar_bwd_edge_l2")}
        for name, B, N, M, live_n, live_m, dsh in K3_CASES:
            x, sh = randn(B, M, tp.irreps_in.dim), randn(B, N, M, 9)
            w = torch.zeros(B, N, M, F, device="cuda")
            w[:, :live_n, :live_m] = randn(B, live_n, live_m, F)
            x, sh, w = x.to(dtype), sh.to(dtype), w.to(dtype)
            g = randn(B, N, F, 8)
            plan = k3_l2_plan(tp, B, N, M, dtype, dsh)
            for kernel, call in (
                    ("tp_scalar_fwd_l2", lambda: tp_scalar.launch_forward(tp, x, sh, w)),
                    ("tp_scalar_bwd_x_l2", lambda: tp_scalar.launch_backward_x(tp, x, sh, w, g)),
                    ("tp_scalar_bwd_edge_l2",
                     lambda: tp_scalar.launch_backward_edge(tp, x, sh, w, g, dsh))):
                times = kernel_times(call)
                r = {"kernel": kernel, "conv": name, "dtype": str(dtype), "B": B, "N": N, "M": M,
                     "F": F, "dsh": dsh, "us": times, "us_total": sum(times.values()),
                     "graph_us": graph_us(call), "card": card}
                if kernel != "tp_scalar_bwd_x_l2":
                    part = "fwd" if kernel == "tp_scalar_fwd_l2" else "edge"
                    r.update({k: v for k, v in plan.items() if k.startswith(part)})
                results.append(r)
                print(json.dumps(r), flush=True)
                sums[kernel]["calls"] += 1
                sums[kernel]["us_total"] += r["us_total"]
                sums[kernel]["graph_us"] += r["graph_us"]
        for total in sums.values():
            results.append(total)
            print(json.dumps(total), flush=True)
    return results


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k2_only", action="store_true",
                        help="only K2's forward and dx cases (to compare two trees)")
    parser.add_argument("--k3_only", action="store_true",
                        help="only K3's forward and dx cases (to compare two trees)")
    parser.add_argument("--k1_l2", action="store_true",
                        help="only the 8-lane K1, dense and sender-index (to compare two trees)")
    parser.add_argument("--k3_index", action="store_true",
                        help="only K3's sender-index forward, dw and dx at 4 and 8 lanes (to "
                             "compare two trees)")
    parser.add_argument("--k2_l2", action="store_true",
                        help="only the dense 8-lane K2 forward and dx (to compare two trees)")
    parser.add_argument("--k2_edge_l2", action="store_true",
                        help="only the 8-lane K2 edge backward (to compare two trees)")
    parser.add_argument("--k2_index", action="store_true",
                        help="only K2's sender-index forward, dw and dx at 4 and 8 lanes (to "
                             "compare two trees)")
    parser.add_argument("--k3_l2", action="store_true",
                        help="only K3's 8-lane forward, dx and edge backward on the layer-0 "
                             "convs (to compare two trees)")
    parser.add_argument("--k1_wide", action="store_true",
                        help="only K1's wide forms on the convs of 32 / 16 and 48 / 10 models (to "
                             "compare two trees)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    if args.k1_l2:
        return k1_l2_cases(randn, gen, card)
    if args.k1_wide:
        return k1_wide_cases(randn, gen, card)
    if args.k3_index:
        return k3_index_cases(randn, gen, card)
    if args.k2_l2:
        return k2_l2_cases(randn, card)
    if args.k2_edge_l2:
        return k2_edge_l2_cases(randn, card)
    if args.k2_index:
        return k2_index_cases(randn, gen, card)
    if args.k3_l2:
        return k3_l2_cases(randn, card)
    results = []
    if args.k3_only:
        tp = channelwise_tp(SEQ[0], SH, SEQ[1])
        F = tp.weight_numel
        bf16 = hasattr(tp_scalar, "path_scale")          # a tree whose K3 takes bf16
        for dtype in (torch.float32, torch.bfloat16) if bf16 else (torch.float32,):
            for name, B, N, M, live_n, live_m, dsh in K3_CASES:
                x, sh = randn(B, M, tp.irreps_in.dim), randn(B, N, M, 9)
                w = torch.zeros(B, N, M, F, device="cuda")
                w[:, :live_n, :live_m] = randn(B, live_n, live_m, F)
                x, sh, w = x.to(dtype), sh.to(dtype), w.to(dtype)
                g = randn(B, N, F, 4)
                calls = k3_calls(tp, x, sh, w, g) + (
                    lambda: tp_scalar.launch_backward_edge(tp, x, sh, w, g, dsh),)
                for kernel, call in zip(("tp_scalar_fwd", "tp_scalar_bwd_x",
                                         "tp_scalar_bwd_edge"), calls):
                    times = kernel_times(call)
                    results.append({"kernel": kernel, "conv": name, "dtype": str(dtype),
                                    "B": B, "N": N, "M": M, "F": F, "dsh": dsh, "us": times,
                                    "us_total": sum(times.values()), "graph_us": graph_us(call),
                                    "card": card})
                    if kernel == "tp_scalar_bwd_edge":
                        dw = torch.empty_like(w)
                        results[-1]["fill_us"] = graph_us(lambda: dw.fill_(0))
                    print(json.dumps(results[-1]), flush=True)
        return results
    for name, irr_in, irr_sh, irr_out, B, N, M, live_n, live_m in K2_CASES:
        tp = channelwise_tp(irr_in, irr_sh, irr_out)
        F = tp.weight_numel
        x, sh = randn(B, M, tp.irreps_in.dim), randn(B, N, M, tp.irreps_sh.dim)
        w = torch.zeros(B, N, M, F, device="cuda")
        w[:, :live_n, :live_m] = randn(B, live_n, live_m, F)
        g = randn(B, N, F, 4)
        for kernel, call in (("tp_aggregate_fwd", lambda: tp_aggregate.launch_forward(tp, x, sh, w)),
                             ("tp_aggregate_bwd_x",
                              lambda: tp_aggregate.launch_backward_x(tp, x, sh, w, g))):
            times = kernel_times(call)
            results.append({"kernel": kernel, "conv": name, "B": B, "N": N, "M": M, "F": F,
                            "live_edges": B * live_n * live_m, "edges": B * N * M,
                            "us": times, "us_total": sum(times.values()), "card": card})
            print(json.dumps(results[-1]), flush=True)
    if args.k2_only:
        return results
    for layer, B, N, M, live_n, live_m in K1_CASES:
        tp = channelwise_tp(SEQ[layer], SH, SEQ[min(layer + 1, 3)])
        F = tp.weight_numel
        x, sh, attr = randn(B, M, tp.irreps_in.dim), randn(B, N, M, 9), randn(B, N, M, E)
        mask = torch.zeros(B, N, M, dtype=torch.bool, device="cuda")
        mask[:, :live_n, :live_m] = True
        params = (randn(E, E) * 0.1, torch.zeros(E, device="cuda"), randn(E, F) * 0.1,
                  torch.zeros(F, device="cuda"))
        with torch.no_grad():
            times = kernel_times(
                lambda: tp_fused.tp_aggregate_fused(tp, x, sh, [attr], [mask], *params))
        results.append({"kernel": "tp_fused", "B": B, "N": N, "M": M, "F": F,
                        "live_edges": int(mask.sum()), "edges": mask.numel(), "us": times,
                        "card": card})
    for layer, B, N, M in EDGE_CASES:
        tp = channelwise_tp(SEQ[layer], SH, SEQ[min(layer + 1, 3)])
        F = tp.weight_numel
        x, sh, w = randn(B, M, tp.irreps_in.dim), randn(B, N, M, 9), randn(B, N, M, F)
        g = randn(B, N, F, 4)
        times = kernel_times(lambda: tp_aggregate.launch_backward_edge(tp, x, sh, w, g, True))
        results.append({"kernel": "tp_aggregate_bwd_edge with dsh", "B": B, "N": N, "M": M, "F": F,
                        "us": times, "card": card})
    for r in results:
        if r["kernel"] not in ("tp_aggregate_fwd", "tp_aggregate_bwd_x"):
            print(json.dumps(r))
    return results


if __name__ == "__main__":
    main()
