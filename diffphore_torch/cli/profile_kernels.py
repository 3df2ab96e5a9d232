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
                                                   --k2_l2]

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
sender-index dx at 4 and 8 lanes on the layer-0 phore conv of a 24-row step
at K = 24, on an index of nearest live phore points (uneven loads: some
points are among the nearest of most receivers, padded ones of none).  Both
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


def k3_index_cases(randn, gen, card) -> list:
    """K3's sender-index dx on the layer-0 phore conv of a 24-row step at
    K = 24, at 4 and 8 lanes, f32 and bf16: per-kernel device time and
    graph_us, with the index's lists built beforehand (as the autograd
    forward builds them)."""
    results = []
    B, P = 24, 96
    idx, live = knn_index(B, P, KNN_K, gen)
    count = torch.bincount((idx.long() + P * torch.arange(B, device="cuda")[:, None, None])
                           .flatten(), minlength=B * P)
    for lanes_, seq in ((4, SEQ), (8, SEQ2)):
        tp = channelwise_tp(seq[0], SH, seq[1])
        F = tp.weight_numel
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(B, P, tp.irreps_in.dim).to(dtype)
            sh = randn(B, P, KNN_K, 9).to(dtype)
            w = (randn(B, P, KNN_K, F) * live[:, :, None, None]).to(dtype).contiguous()
            g = randn(B, P, F, lanes_)
            lists = tp_scalar.dx_lists(tp, idx, P, dtype)
            call = lambda: tp_scalar.launch_backward_x(tp, x, sh, w, g, sender_index=idx,
                                                       lists=lists)
            times = kernel_times(call)
            results.append({"kernel": "tp_scalar_bwd_x_idx", "lanes": lanes_,
                            "dtype": str(dtype), "B": B, "N": P, "K": KNN_K, "M_x": P, "F": F,
                            "slots_per_sender_max": int(count.max()),
                            "slots_per_sender_mean": float(count.float().mean()),
                            "senders_read": int((count > 0).sum()), "us": times,
                            "us_total": sum(times.values()), "graph_us": graph_us(call),
                            "card": card})
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


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k2_only", action="store_true",
                        help="only K2's forward and dx cases (to compare two trees)")
    parser.add_argument("--k3_only", action="store_true",
                        help="only K3's forward and dx cases (to compare two trees)")
    parser.add_argument("--k1_l2", action="store_true",
                        help="only the 8-lane K1, dense and sender-index (to compare two trees)")
    parser.add_argument("--k3_index", action="store_true",
                        help="only K3's sender-index dx at 4 and 8 lanes (to compare two trees)")
    parser.add_argument("--k2_l2", action="store_true",
                        help="only the dense 8-lane K2 forward and dx (to compare two trees)")
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
    if args.k3_index:
        return k3_index_cases(randn, gen, card)
    if args.k2_l2:
        return k2_l2_cases(randn, card)
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
