"""Where the 8-lane K2 edge backward's and the sender-index dx's time goes:
each kernel timed whole and with phases cut out of a copy of its source, on
the card.

As ``analysis/k2_l2_phases.py`` does for the dense forward and dx: each
variant is ``csrc/tp_aggregate.cu`` with textual edits (``VARIANTS``),
compiled with nvcc into ``build/k2_edge_phases/`` and loaded in the place of
the port's library; a variant with a phase cut out gives wrong results and
is timed only.  The edge backward runs on the 17 training convs of
``cli.profile_kernels --k2_edge_l2`` as the step runs it (dsh on the five
cross convs, on w's live bits), the sender-index dx (its lists and live
bits made beforehand) and dw on the KNN step's two K2 calls at 4 and 8
lanes (``--k2_index``'s inputs); f32 and bf16.  Each variant prints one JSON line per
(kernel, dtype) with the sum of the graph-replay time per call, and the
variants run twice, in turns (A B ... B A).

    python analysis/k2_edge_phases.py [--variants whole "no P" ...] [--json PATH]

Needs a GPU and nvcc.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from analysis.k2_l2_phases import compile_variant  # noqa: E402

P_LOOP = "  for (int e = threadIdx.x; e < PT; e += blockDim.x) {"
X_ROWS = "  for (int ml = warp; ml < count; ml += EB_WARPS) {\n    const T* xs = x + ((size_t)b * M"
P_ROW = "    for (int i = tid; i < PT / 4; i += EB_THREADS) cp_async16"
SH_ROWS = "    for (int i = tid; i < count * EB_SHP; i += EB_THREADS) {"
W_ROWS = "      for (int ml = warp; ml < count; ml += EB_WARPS) {\n        const size_t e = row0 + ml;"
PATHS = "      for (int k = 0; k < plan_w; ++k) {   // warp = path, lane = sender"
STORE = "    for (int ml = warp; ml < count; ml += EB_WARPS) {\n      T* dst = dw + (row0 + ml) * F;"
T_PASS = "      for (int it = tid; it < n * n_pi; it += nt) {"
WALK = "      if (!active) continue;\n      const T* wc"


def _cut(text: str, bound: str) -> tuple:
    """The edit that gives a loop no trip: its bound replaced by 0."""
    return text, text.replace(bound, "0", 1)


#: name -> [(text of the source, its replacement)]
VARIANTS = {
    "whole": [],
    "no P kernel": [_cut(P_LOOP, "PT")],
    "no staging": [_cut(X_ROWS, "count"), _cut(P_ROW, "PT / 4"), _cut(SH_ROWS, "count * EB_SHP"),
                   _cut(W_ROWS, "count")],
    "no x staging": [_cut(X_ROWS, "count")],
    "no paths": [_cut(PATHS, "plan_w")],
    "no dw stores": [_cut(STORE, "count")],
    "stores alone": [_cut(P_LOOP, "PT"), _cut(X_ROWS, "count"), _cut(P_ROW, "PT / 4"),
                     _cut(SH_ROWS, "count * EB_SHP"), _cut(W_ROWS, "count"),
                     _cut(PATHS, "plan_w")],
    "idx dw: 8 slots a block": [("constexpr int IDX_EDGE_SLOTS = 32;",
                                 "constexpr int IDX_EDGE_SLOTS = 8;")],
    "dx: no t": [_cut(T_PASS, "n * n_pi")],
    "dx: no walk": [(WALK, "      if (!active || t >= 0) continue;\n      const T* wc")],
}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k2_edge_phases needs a GPU")
    from diffphore_torch.cli.profile_kernels import (K2_INDEX_CONVS, K2_L2_CASES, KNN_K, SEQ,
                                                     SEQ2, SH, _step_dsh, graph_us, knn_index)
    from diffphore_torch.ops import build, tp_aggregate
    from diffphore_torch.ops.tensor_product import channelwise_tp
    import chip_smoke as cs

    card = cs.card_line()
    out_dir = os.path.join(HERE, "build", "k2_edge_phases")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(args.variants)) as pool:
        libs = dict(zip(args.variants, pool.map(
            lambda n: compile_variant(n, VARIANTS[n], out_dir), args.variants)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    edge_cases = []
    for name, irr_in, irr_sh, irr_out, N, M, live_n, live_m in K2_L2_CASES:
        tp = channelwise_tp(irr_in, irr_sh, irr_out)
        w = torch.zeros(24, N, M, tp.weight_numel, device="cuda")
        w[:, :live_n, :live_m] = randn(24, live_n, live_m, tp.weight_numel)
        edge_cases.append((tp, randn(24, M, tp.irreps_in.dim), randn(24, N, M, tp.irreps_sh.dim),
                           w, randn(24, N, tp.weight_numel, 8), _step_dsh(name)))
    B, P = 24, 96
    idx, live = knn_index(B, P, KNN_K, gen)
    lists = tp_aggregate.idx_dx_lists(idx, P)
    dx_cases = []
    for lanes, seq in ((4, SEQ), (8, SEQ2)):
        for _, layer in K2_INDEX_CONVS:
            tp = channelwise_tp(seq[layer], SH, seq[layer + 1])
            F = tp.weight_numel
            dx_cases.append((lanes, tp, randn(B, P, tp.irreps_in.dim), randn(B, P, KNN_K, 9),
                             (randn(B, P, KNN_K, F) * live[:, :, None, None]).contiguous(),
                             randn(B, P, F, lanes)))
    original = build.load
    results = []
    for name in args.variants + args.variants[::-1]:
        build.load = lambda _n, path=libs[name]: ctypes.CDLL(path)
        tp_aggregate._library.cache_clear()
        for dtype in (torch.float32, torch.bfloat16):
            sums = {"edge, 17 convs": 0.0, "idx dx, 4 lanes": 0.0, "idx dx, 8 lanes": 0.0,
                    "idx dw, 4 lanes": 0.0, "idx dw, 8 lanes": 0.0}
            for tp, x, sh, w, g, dsh in edge_cases:
                xd, shd, wd = x.to(dtype), sh.to(dtype), w.to(dtype)
                bits = tp_aggregate.live_rows_l2(wd)
                sums["edge, 17 convs"] += graph_us(lambda: tp_aggregate.launch_backward_edge(
                    tp, xd, shd, wd, g, dsh, live=bits))
            for lanes, tp, x, sh, w, g in dx_cases:
                xd, shd, wd = x.to(dtype), sh.to(dtype), w.to(dtype)
                bits = tp_aggregate.live_rows_l2(wd)
                sums[f"idx dx, {lanes} lanes"] += graph_us(lambda: tp_aggregate.launch_backward_x(
                    tp, xd, shd, wd, g, sender_index=idx, lists=lists, live=bits))
                sums[f"idx dw, {lanes} lanes"] += graph_us(lambda: tp_aggregate.launch_backward_edge(
                    tp, xd, shd, wd, g, False, sender_index=idx))
            for k, us in sums.items():
                results.append({"variant": name, "kernel": k, "dtype": str(dtype), "us": us,
                                "card": card})
                print(json.dumps(results[-1]), flush=True)
    build.load = original
    tp_aggregate._library.cache_clear()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
