"""The 8-lane K3 forward and edge backward in variants, on the card.

Two kinds of variant.  ``parent`` and ``parent, one split`` are the parent
tree's kernels (``tp_scalar_fwd_kernel<T, 2>`` and
``tp_scalar_bwd_edge_kernel<T, DSH, VEC, 2>``), compiled from the parent's
``csrc/tp_scalar.cu`` (``--parent``: the root of an unpacked parent tree)
and called through that library's own entry points: the forward on the
sender splits its occupancy query gives (``tp_scalar.plan_chunk``), or on
one split (no partial sums, no ``tp_scalar_sum_splits``); the edge backward
on the blocks its occupancy query gives.  Each prints the forward's blocks
an SM and splits per conv.  Every other variant is this tree's
``csrc/tp_scalar.cu`` with textual edits and module settings (``VARIANTS``),
compiled with nvcc into ``build/k3_l2_fwd_edge_variants/`` and loaded in the
place of the port's library, called through ``tp_scalar.launch_forward`` and
``launch_backward_edge``.  Variants named "cut" leave a phase out (their
results are wrong: timing only).

The cases are the six layer-0 convs of a second-order training step
(``cli.profile_kernels --k3_l2``: ``K3_CASES`` shapes, F = 60, g (B, N, F,
8)), the edge backward with dsh where the step asks for it, f32 and bf16.
Each variant prints one JSON line per (kernel, dtype) with the sum over the
six of the graph-replay time per call (and each conv's), and checks its
results against the plain versions (f32 within 1e-4 of scale; bf16 the
output within 1e-5 of scale and gradients within one rounding step plus
1e-6 of scale).  A ``floor`` line per dtype times ``fill_(0)`` of each
conv's dw: writing dw alone.  The compiler's register and spill lines of each library's
8-lane forward and edge-backward kernels are printed once.  The variants
run twice, in turns (A B ... B A).

    python analysis/k3_l2_fwd_edge_variants.py [--parent build/parent] [--variants whole ...]
                                               [--json PATH]

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

PARENT = ("parent", "parent, one split")
F2_U = "constexpr int F2_U = 4;"
E2_EB = "constexpr int E2_EB = 2;"
F2_BOUNDS = "__launch_bounds__(F2_THREADS) tp_scalar_fwd_l2_kernel("
E2_BLOCKS = "constexpr int E2_MIN_BLOCKS = 3;"
W_LOAD = "wv[i].load(wr + (size_t)(c0 + m + i * SL) * F, u.cnt);"
SH_STAGE = "s_sh[rr * MC * S + i - rr * per] = ld(shb + (size_t)rr * M * S + i - rr * per);"
X_STAGE = "s_x[i] = ld(xb + i);"
CP_SH = "cp_async4(s_sh + rr * MC * S + i - rr * per, shb + (size_t)rr * M * S + i - rr * per);"
CP_X = "cp_async4(s_x + i, xb + i);"
CP_F32 = "if constexpr (sizeof(T) == 4) {"
SH_LOAD = "sv[i][k] = ld(sh + (size_t)edge * S + u.off + k);"
DW_STORE = "            st4(dst, o);"


def _plan(R: int, SL: int):
    """A forward plan of (R receivers, SL slices) a block on every conv."""
    return lambda B, N, M, G, target: (min(R, N), min(SL, M))


#: name -> ([(text of the source, its replacement)], {tp_scalar setting: value})
VARIANTS = {
    "parent": None,
    "parent, one split": None,
    "whole": ([], {}),
    "forward: two senders in flight": ([(F2_U, F2_U.replace("= 4", "= 2"))], {"F2_U": 2}),
    "forward: eight senders in flight": ([(F2_U, F2_U.replace("= 4", "= 8"))], {"F2_U": 8}),
    "forward: block cost 1": ([], {"F2_FIXED": 1}),
    "forward: block cost 4": ([], {"F2_FIXED": 4}),
    "forward: 1 x 16": ([], {"plan_fwd_l2": _plan(1, 16)}),
    "forward: 2 x 8": ([], {"plan_fwd_l2": _plan(2, 8)}),
    "forward: 5 x 3": ([], {"plan_fwd_l2": _plan(5, 3)}),
    "forward: 8 x 2": ([], {"plan_fwd_l2": _plan(8, 2)}),
    "forward: three blocks an SM": ([(F2_BOUNDS, F2_BOUNDS.replace("F2_THREADS)",
                                                                   "F2_THREADS, 3)"))], {}),
    "forward: four blocks an SM": ([(F2_BOUNDS, F2_BOUNDS.replace("F2_THREADS)",
                                                                  "F2_THREADS, 4)"))], {}),
    "edge: one step in flight": ([(E2_EB, E2_EB.replace("= 2", "= 1"))], {}),
    "edge: four steps in flight": ([(E2_EB, E2_EB.replace("= 2", "= 4"))], {}),
    "edge: registers uncapped": ([(E2_BLOCKS, E2_BLOCKS.replace("= 3", "= 1"))], {}),
    "edge: four blocks an SM": ([(E2_BLOCKS, E2_BLOCKS.replace("= 3", "= 4"))], {}),
    "edge: one step, four blocks an SM": ([(E2_EB, E2_EB.replace("= 2", "= 1")),
                                          (E2_BLOCKS, E2_BLOCKS.replace("= 3", "= 4"))], {}),
    "edge: one step, five blocks an SM": ([(E2_EB, E2_EB.replace("= 2", "= 1")),
                                          (E2_BLOCKS, E2_BLOCKS.replace("= 3", "= 5"))], {}),
    # phases cut out, timing only (their results are wrong)
    "forward, cut: w read from two rows": ([(W_LOAD, W_LOAD.replace(
        "(c0 + m + i * SL)", "(i & 1)"))], {}),
    "forward, cut: nothing staged": ([(SH_STAGE, SH_STAGE.split(" = ")[0] + " = 1.f;"),
                                     (X_STAGE, X_STAGE.split(" = ")[0] + " = 1.f;"),
                                     (CP_SH, ";"), (CP_X, ";")], {}),
    "forward: f32 staged through registers": ([(CP_F32, CP_F32.replace("4", "0"))], {}),
    "edge, cut: no harmonic loads": ([(SH_LOAD, SH_LOAD.replace(
        "ld(sh + (size_t)edge * S + u.off + k)", "(float)(edge + k)"))], {}),
    "edge, cut: no dw stores": ([(DW_STORE, DW_STORE.replace(
        "st4(dst, o);", "if (o[0] == 1.2345e-30f) st4(dst, o);"))], {}),
}


def compile_source(src_path: str, edits, out_dir: str, slug: str):
    """(library path, compiler log) of ``src_path`` with ``edits`` applied."""
    from diffphore_torch.ops import build

    with open(src_path) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{slug}: {old!r} is not in the source")
        src = src.replace(old, new)
    cu, so = os.path.join(out_dir, slug + ".cu"), os.path.join(out_dir, slug + ".so")
    with open(cu, "w") as f:
        f.write(src)
    done = subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, cu], check=True,
                          capture_output=True, text=True)
    return so, done.stdout + done.stderr


def register_lines(log: str) -> list:
    """The compiler's 'Used N registers' line of each 8-lane forward or
    edge-backward kernel (dense: its sender-index flag false) in a log."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Function properties for" not in line:
            continue
        name = line.split("Function properties for")[-1].strip()
        if not any(k in name for k in ("fwd_kernel", "fwd_l2", "bwd_edge_kernel",
                                       "bwd_edge_l2", "sum_splits")):
            continue
        used = next((l[l.index("Used"):].strip() for l in lines[i + 1:i + 4] if "Used" in l),
                    "")
        spill = next((l.strip() for l in lines[i + 1:i + 3] if "spill" in l), "")
        out.append(f"{name[:90]} :: {used} {spill}")
    return out


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default=os.path.join(HERE, "build", "parent"))
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3_l2_fwd_edge_variants needs a GPU")
    from diffphore_torch.cli.profile_kernels import K3_CASES, SEQ2, SH, graph_us
    from diffphore_torch.ops import build, tp_scalar
    from diffphore_torch.ops.tensor_product import channelwise_tp
    import chip_smoke as cs

    card = cs.card_line()
    out_dir = os.path.join(HERE, "build", "k3_l2_fwd_edge_variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    if any(n in PARENT for n in args.variants):
        jobs["parent"] = (os.path.join(args.parent, "diffphore_torch", "csrc", "tp_scalar.cu"), ())
    for n in args.variants:
        if n not in PARENT:
            jobs[n] = (os.path.join(build.CSRC, "tp_scalar.cu"), tuple(VARIANTS[n][0]))
    slugs = {n: "".join(c if c.isalnum() else "_" for c in n) for n in jobs}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda n: compile_source(jobs[n][0], jobs[n][1], out_dir, slugs[n]), jobs)))
    for n, (_, log) in built.items():
        for line in register_lines(log):
            print(f"ptxas [{n}]: {line}", flush=True)

    tp = channelwise_tp(SEQ2[0], SH, SEQ2[1])
    F, D = tp.weight_numel, tp.irreps_in.dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    cases = []
    for name, B, N, M, live_n, live_m, dsh in K3_CASES:
        x, sh = randn(B, M, D), randn(B, N, M, 9)
        w = torch.zeros(B, N, M, F, device="cuda")
        w[:, :live_n, :live_m] = randn(B, live_n, live_m, F)
        cases.append((name, x, sh, w, randn(B, N, F, 8), dsh))
    lanes = torch.zeros(F, 8, device="cuda")
    for p in tp.paths:
        lanes[p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream

    parent_lib = None
    if "parent" in built:
        parent_lib = ctypes.CDLL(built["parent"][0])
        p_, i_ = ctypes.c_void_p, ctypes.c_int
        parent_lib.dp_tp_scalar_fwd_l2.argtypes = [p_] * 8 + [i_] * 11 + [p_]
        parent_lib.dp_tp_scalar_bwd_edge_l2.argtypes = [p_] * 9 + [i_] * 11 + [p_]
        parent_lib.dp_tp_scalar_blocks_per_sm_l2.argtypes = [i_] * 5
        parent_lib.dp_tp_scalar_bwd_edge_blocks_per_sm_l2.argtypes = [i_] * 2

    def parent_calls(variant, x, sh, w, g, dsh, dtype):
        """(forward, edge backward, diagnostics) through the parent's library."""
        B, N, M, S = sh.shape
        bf16 = int(dtype == torch.bfloat16)
        chan, scale, _, d_item = tp_scalar._device_conv_tables(tp, "cuda", dtype)
        per_sm = parent_lib.dp_tp_scalar_blocks_per_sm_l2(0, F, D, len(d_item), bf16)
        if variant == "parent":
            target = max(tp_scalar.TARGET_BLOCKS, per_sm * sms)
            keep = tp_scalar.keep_of(F)
            tiles = B * -(-N // keep)
            splits = max(1, min(-(-target // tiles), M // tp_scalar.MIN_CHUNK))
            chunk = -(-M // splits)
            splits = -(-M // chunk)
        else:
            chunk, splits = M, 1
        out = torch.empty((B, N, F, 8), device="cuda")
        part = torch.empty((splits, B, N, F, 8), device="cuda") if splits > 1 else None

        def fwd():
            rc = parent_lib.dp_tp_scalar_fwd_l2(
                x.data_ptr(), sh.data_ptr(), w.data_ptr(), None, chan.data_ptr(),
                scale.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(), B,
                N, M, M, D, S, F, tp_scalar.keep_of(F), chunk, splits, bf16, stream())
            assert rc == 0, rc
            return out

        edge_sm = parent_lib.dp_tp_scalar_bwd_edge_blocks_per_sm_l2(int(dsh), bf16)
        dw, dsh_t = torch.empty_like(w), (torch.empty_like(sh) if dsh else None)

        def edge():
            rc = parent_lib.dp_tp_scalar_bwd_edge_l2(
                x.data_ptr(), sh.data_ptr(), w.data_ptr(), None, g.data_ptr(), chan.data_ptr(),
                scale.data_ptr(), dw.data_ptr(), None if dsh_t is None else dsh_t.data_ptr(), B,
                N, M, M, D, S, F, tp_scalar.sh_reach(tp), int(tp_scalar.x_quads(tp)),
                edge_sm * sms, bf16, stream())
            assert rc == 0, rc
            return dw, dsh_t

        return fwd, edge, {"fwd_blocks_per_sm": per_sm, "fwd_splits": splits,
                           "edge_blocks_per_sm": edge_sm}

    results = []
    for dtype in (torch.float32, torch.bfloat16):   # writing dw alone: the edge's write floor
        fills = []
        for _, _, _, w, _, _ in cases:
            dw = torch.empty_like(w, dtype=dtype)
            fills.append(graph_us(lambda: dw.fill_(0)))
        results.append({"variant": "floor", "kernel": "fill_(0) of dw", "dtype": str(dtype),
                        "us_6_convs": sum(fills), "us_per_conv": fills,
                        "worst_err_of_scale": 0.0, "ok": True, "card": card})
        print(json.dumps(results[-1]), flush=True)
    original, saved = build.load, {}
    for name in args.variants + args.variants[::-1]:
        if name not in PARENT:
            edits, settings = VARIANTS[name]
            for key, value in settings.items():
                saved.setdefault(key, getattr(tp_scalar, key))
                setattr(tp_scalar, key, value)
            build.load = lambda _n, path=built[name][0]: ctypes.CDLL(path)
            for fn in vars(tp_scalar).values():
                if hasattr(fn, "cache_clear"):
                    fn.cache_clear()
        for dtype in (torch.float32, torch.bfloat16):
            rows = {k: {"variant": name, "kernel": k, "dtype": str(dtype), "us_6_convs": 0.0,
                        "us_per_conv": [], "worst_err_of_scale": 0.0, "card": card}
                    for k in ("tp_scalar_fwd_l2", "tp_scalar_bwd_edge_l2")}
            diag = []
            for conv, x, sh, w, g, dsh in cases:
                xd, shd, wd = x.to(dtype), sh.to(dtype), w.to(dtype)
                if name in PARENT:
                    fwd, edge, info = parent_calls(name, xd, shd, wd, g, dsh, dtype)
                    diag.append({"conv": conv, **info})
                else:
                    fwd = lambda: tp_scalar.launch_forward(tp, xd, shd, wd)
                    edge = lambda: tp_scalar.launch_backward_edge(tp, xd, shd, wd, g, dsh)
                leaves = [v.float().requires_grad_(True) for v in (xd, shd, wd)]
                ref = tp_scalar.scalar_paths_aggregate_plain(tp, *[v.to(dtype) for v in leaves])
                _, ref_dsh, ref_dw = torch.autograd.grad(ref, leaves, g * lanes)
                got = fwd().clone()
                dw, dsh_got = [None if t is None else t.clone() for t in edge()]
                checks = [("tp_scalar_fwd_l2", got, ref.detach(), 1e-5),
                          ("tp_scalar_bwd_edge_l2", dw, ref_dw, None)]
                if dsh:
                    checks.append(("tp_scalar_bwd_edge_l2", dsh_got, ref_dsh, None))
                for kernel, have, want, tol in checks:
                    scale = max(float(want.abs().max()), 1e-30)
                    err = (have.float() - want).abs()
                    if dtype == torch.bfloat16 and tol is None:
                        err = err - want.abs() * 2.0 ** -7
                    rows[kernel]["worst_err_of_scale"] = max(
                        rows[kernel]["worst_err_of_scale"], float(err.max()) / scale)
                for kernel, call in (("tp_scalar_fwd_l2", fwd), ("tp_scalar_bwd_edge_l2", edge)):
                    us = graph_us(call)
                    rows[kernel]["us_per_conv"].append(us)
                    rows[kernel]["us_6_convs"] += us
            for kernel, row in rows.items():
                limit = 1e-4 if dtype == torch.float32 else (
                    1e-5 if kernel == "tp_scalar_fwd_l2" else 1e-6)
                row["ok"] = row["worst_err_of_scale"] <= limit
                if diag:
                    row["plan"] = diag
                results.append(row)
                print(json.dumps(row), flush=True)
        build.load = original
        for key, value in saved.items():
            setattr(tp_scalar, key, value)
    for fn in vars(tp_scalar).values():
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
