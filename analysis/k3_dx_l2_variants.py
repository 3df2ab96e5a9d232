"""The 8-lane K3 dx (``tp_scalar_bwd_x_l2_kernel``) in variants, on the card:
each variant is ``csrc/tp_scalar.cu`` with textual edits (``VARIANTS``),
compiled with nvcc into ``build/k3_dx_l2_variants/`` and loaded in the place
of the port's library, with the grid's waves (``tp_scalar.X2_WAVES``) set as
the variant says (and the senders a thread, ``tp_scalar.X2_Q``, as its
source's; the fewest receivers a split, ``tp_scalar.X2_MIN_CHUNK``).  The cases are the six layer-0 convs of a second-order
training step (``cli.profile_kernels --k3_l2``: ``K3_CASES`` shapes, F = 60,
g (B, N, F, 8)), f32 and bf16; each variant prints one JSON line per dtype
with the sum over the six of the graph-replay time per call (and each conv's), and checks its
dx against the plain version's gradient (f32 within 1e-4 of scale, bf16
within one rounding step plus 1e-6 of scale).  The variants run twice, in
turns (A B ... B A).

    python analysis/k3_dx_l2_variants.py [--variants whole "one wave" ...] [--json PATH]

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

Q4 = "constexpr int X2_Q = 4;"
BOUNDS = "__launch_bounds__(X2_THREADS) tp_scalar_bwd_x_l2_kernel("
UNROLL = "#pragma unroll 1\n    for (int n = n0; n < n1; ++n) {"
#: name -> ([(text of the source, its replacement)], waves of the grid, senders a thread,
#: fewest receivers a split)
W_LDG = "ld(wp + n * wstep + q * F)"
W_LDCS = "to_f(__ldcs(wp + n * wstep + q * F))"
VARIANTS = {
    "whole": ([], 4, 4, 4),
    "w streamed (ldcs)": ([(W_LDG, W_LDCS)], 4, 4, 4),
    "w streamed, unroll 2": ([(W_LDG, W_LDCS), (UNROLL, UNROLL.replace("unroll 1", "unroll 2"))],
                             4, 4, 4),
    "w streamed, eight senders a thread": ([(W_LDG, W_LDCS), (Q4, "constexpr int X2_Q = 8;")],
                                           4, 8, 4),
    "w streamed, two senders a thread": ([(W_LDG, W_LDCS), (Q4, "constexpr int X2_Q = 2;")],
                                         4, 2, 4),
    "two waves": ([], 2, 4, 4),
    "eight receivers a split": ([], 4, 4, 8),
    "three blocks an SM (bounds)": ([(BOUNDS, BOUNDS.replace("X2_THREADS)", "X2_THREADS, 3)"))],
                                    4, 4, 4),
    "two senders a thread": ([(Q4, "constexpr int X2_Q = 2;")], 4, 2, 4),
    "eight senders a thread": ([(Q4, "constexpr int X2_Q = 8;")], 4, 8, 4),
    "unroll 2": ([(UNROLL, UNROLL.replace("unroll 1", "unroll 2"))], 4, 4, 4),
}


def compile_variant(name: str, edits, out_dir: str) -> str:
    from diffphore_torch.ops import build

    with open(os.path.join(build.CSRC, "tp_scalar.cu")) as f:
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
        raise SystemExit("k3_dx_l2_variants needs a GPU")
    from diffphore_torch.cli.profile_kernels import K3_CASES, SEQ2, SH, graph_us
    from diffphore_torch.ops import build, tp_scalar
    from diffphore_torch.ops.tensor_product import channelwise_tp
    import chip_smoke as cs

    card = cs.card_line()
    out_dir = os.path.join(HERE, "build", "k3_dx_l2_variants")
    os.makedirs(out_dir, exist_ok=True)
    sources = {tuple(VARIANTS[n][0]) for n in args.variants}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(
            lambda e: compile_variant(str(len(e)) + "_" + str(abs(hash(e))), list(e), out_dir),
            sources)))
    tp = channelwise_tp(SEQ2[0], SH, SEQ2[1])
    F = tp.weight_numel
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    cases = []
    for _, B, N, M, live_n, live_m, _ in K3_CASES:
        x, sh = randn(B, M, tp.irreps_in.dim), randn(B, N, M, 9)
        w = torch.zeros(B, N, M, F, device="cuda")
        w[:, :live_n, :live_m] = randn(B, live_n, live_m, F)
        cases.append((x, sh, w, randn(B, N, F, 8)))
    lanes = torch.zeros(F, 8, device="cuda")
    for p in tp.paths:
        lanes[p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    original, plan = build.load, (tp_scalar.X2_WAVES, tp_scalar.X2_Q, tp_scalar.X2_MIN_CHUNK)
    results = []
    for name in args.variants + args.variants[::-1]:
        edits, tp_scalar.X2_WAVES, tp_scalar.X2_Q, tp_scalar.X2_MIN_CHUNK = VARIANTS[name]
        build.load = lambda _n, path=built[tuple(edits)]: ctypes.CDLL(path)
        for cached in (tp_scalar._library, tp_scalar._resident_blocks_x2,
                       tp_scalar.plan_run_l2, tp_scalar.plan_chunk_l2):
            cached.cache_clear()
        for dtype in (torch.float32, torch.bfloat16):
            total, worst, per_conv = 0.0, 0.0, []
            for x, sh, w, g in cases:
                xd, shd, wd = x.to(dtype), sh.to(dtype), w.to(dtype)
                xl = xd.float().requires_grad_(True)
                ref = tp_scalar.scalar_paths_aggregate_plain(tp, xl.to(dtype), shd, wd)
                (want,) = torch.autograd.grad(ref, [xl], g * lanes)
                got = tp_scalar.launch_backward_x(tp, xd, shd, wd, g).float()
                scale = float(want.abs().max())
                excess = (got - want).abs() - (0.0 if dtype == torch.float32
                                               else want.abs() * 2.0 ** -7)
                worst = max(worst, float(excess.max()) / scale)
                per_conv.append(graph_us(lambda: tp_scalar.launch_backward_x(tp, xd, shd, wd, g)))
                total += per_conv[-1]
            ok = worst <= (1e-4 if dtype == torch.float32 else 1e-6)
            results.append({"variant": name, "kernel": "tp_scalar_bwd_x_l2", "dtype": str(dtype),
                            "us_6_convs": total, "us_per_conv": per_conv,
                            "worst_err_of_scale": worst, "ok": ok,
                            "card": card})
            print(json.dumps(results[-1]), flush=True)
    build.load = original
    tp_scalar.X2_WAVES, tp_scalar.X2_Q, tp_scalar.X2_MIN_CHUNK = plan
    for cached in (tp_scalar._library, tp_scalar._resident_blocks_x2, tp_scalar.plan_run_l2,
                   tp_scalar.plan_chunk_l2):
        cached.cache_clear()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
