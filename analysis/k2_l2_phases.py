"""Where the dense 8-lane K2 forward's and dx's time goes: each kernel timed
whole and with phases cut out of a copy of its source, on the card.

Each variant is ``csrc/tp_aggregate.cu`` with textual edits (listed in
``VARIANTS``), compiled with nvcc into ``build/k2_l2_phases/`` and loaded in
the place of the port's library; the variants whose results are wrong on
purpose (a phase cut out) are timed only.  The cases are the 17 training
convs of ``cli.profile_kernels --k2_l2`` (f32 and bf16; dx on live bits made
beforehand, as the train step runs it); each variant prints
one JSON line per (kernel, dtype) with the sum over the 17 of the graph-
replay time per call, and the variants run twice, in turns (A B ... B A).

    python analysis/k2_l2_phases.py [--variants whole "no t" ...] [--json PATH]

Needs a GPU and nvcc.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

T_STEP = ("      if (F32) t_item(d_sh * 8 + d_out, tq, G, srow + pt[0]);\n"
          "      else t_item(d_sh * 8 + d_out, tq, G, svb + pt[0]);\n")
WALK = "    if (!walker) continue;\n"
NO_WALK = "    if (!walker || i >= 0) continue;\n"
FWD_SHW = "  const int shw = sizeof(T) == 2 && aligned(sh, 4);\n"
DX_SHW = "sizeof(T) == 2 && aligned(sh, 4));"
#: name -> [(text of the source, its replacement)]
VARIANTS = {
    "whole": [],
    "no t": [(T_STEP, "")],
    "no walk": [(WALK, NO_WALK)],
    "live tiles' loads and barriers": [(T_STEP, ""), (WALK, NO_WALK)],
    "bf16 harmonics by plain loads": [(FWD_SHW, "  const int shw = 0;\n"), (DX_SHW, "0);")],
    "three stages": [("constexpr int T2_STAGES = 2;", "constexpr int T2_STAGES = 3;")],
    "two blocks an SM": [("__launch_bounds__(T2_THREADS, 3)", "__launch_bounds__(T2_THREADS, 2)")],
    "live pass, eight rows a warp": [("constexpr int LIVE_ROWS = 4;",
                                      "constexpr int LIVE_ROWS = 8;")],
    "live pass, one piece at once": [("constexpr int LIVE_UNROLL = 3;",
                                      "constexpr int LIVE_UNROLL = 1;")],
}


def compile_variant(name: str, edits, out_dir: str) -> str:
    from diffphore_torch.ops import build

    with open(os.path.join(build.CSRC, "tp_aggregate.cu")) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant {name!r}: {old!r} is not in the source")
        src = src.replace(old, new)
    slug = "".join(c if c.isalnum() else "_" for c in name)
    cu, so = os.path.join(out_dir, slug + ".cu"), os.path.join(out_dir, slug + ".so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, cu], check=True, capture_output=True)
    return so


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k2_l2_phases needs a GPU")
    from diffphore_torch.cli.profile_kernels import K2_L2_CASES, graph_us
    from diffphore_torch.ops import build, tp_aggregate
    from diffphore_torch.ops.tensor_product import channelwise_tp
    import chip_smoke as cs

    card = cs.card_line()
    out_dir = os.path.join(HERE, "build", "k2_l2_phases")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(args.variants)) as pool:
        libs = dict(zip(args.variants, pool.map(
            lambda n: compile_variant(n, VARIANTS[n], out_dir), args.variants)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for name, irr_in, irr_sh, irr_out, N, M, live_n, live_m in K2_L2_CASES:
        tp = channelwise_tp(irr_in, irr_sh, irr_out)
        F = tp.weight_numel
        randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
        x, sh = randn(24, M, tp.irreps_in.dim), randn(24, N, M, tp.irreps_sh.dim)
        w = torch.zeros(24, N, M, F, device="cuda")
        w[:, :live_n, :live_m] = randn(24, live_n, live_m, F)
        cases.append((tp, x, sh, w, randn(24, N, F, 8)))
    original = build.load
    results = []
    for name in args.variants + args.variants[::-1]:
        build.load = lambda _n, path=libs[name]: ctypes.CDLL(path)
        tp_aggregate._library.cache_clear()
        tp_aggregate._resident_blocks_l2.cache_clear()
        for dtype in (torch.float32, torch.bfloat16):
            sums = {"fwd": 0.0, "bwd_x": 0.0}
            for tp, x, sh, w, g in cases:
                xd, shd, wd = x.to(dtype), sh.to(dtype), w.to(dtype)
                live = tp_aggregate.live_rows_l2(wd)     # dx as the train step runs it
                sums["fwd"] += graph_us(lambda: tp_aggregate.launch_forward(tp, xd, shd, wd))
                sums["bwd_x"] += graph_us(
                    lambda: tp_aggregate.launch_backward_x(tp, xd, shd, wd, g, live=live))
            for k, us in sums.items():
                results.append({"variant": name, "kernel": k, "dtype": str(dtype),
                                "us_17_convs": us, "card": card})
                print(json.dumps(results[-1]), flush=True)
    build.load = original
    tp_aggregate._library.cache_clear()
    tp_aggregate._resident_blocks_l2.cache_clear()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
