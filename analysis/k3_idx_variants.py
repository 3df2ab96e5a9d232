"""The sender-index K3 forward and dw (``tp_scalar_idx_kernel``) in
variants, on the card.

Each variant is this tree's ``csrc/tp_scalar.cu`` with textual edits and
module settings (``VARIANTS``), compiled with nvcc into
``build/k3_idx_variants/`` and loaded in the place of the port's library,
called through ``tp_scalar.launch_forward`` and ``launch_backward_edge``
with a sender index.  The cases are ``cli.profile_kernels --k3_index``'s:
the layer-0 phore conv of a 24-row KNN step at K = 24 on an index of
nearest live phore points, at 4 lanes (20x0e -> 20x0e + 10x1o, F = 40) and
at 8 (-> + 10x2e, F = 60), f32 and bf16.  Each variant prints one JSON line
per (kernel, lanes, dtype) with the graph-replay time per call and its
error against the plain version (f32 within 1e-4 of scale; bf16 the forward
within 1e-5 of scale and dw within one rounding step plus 1e-6 of scale).
The variants run twice, in turns (A B ... B A); ``parent`` is a parent
tree's library (``--parent``, the root of an unpacked tree) through its own
``launch_forward`` and ``launch_backward_edge``.

    python analysis/k3_idx_variants.py [--parent build/parent] [--variants whole ...]

Needs a GPU and nvcc.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SH_STAGE = "for (int i = tid; i < rows * perq; i += nt) {"
SH_READ = "for (int k = 0; k < KM; ++k) sv[k] = k < u.K ? sr[mm * S + k] : 0.f;\n    };"
SH_READ_GLOBAL = ("for (int k = 0; k < KM; ++k)\n        sv[k] = k < u.K ? "
                  "ld(sh + (row0 + c0 + mm) * S + u.off + k) : 0.f;\n    };")
SH_UNSTAGED = [(SH_STAGE, SH_STAGE.replace("i < rows", "i < 0 * rows")),
               (SH_READ, SH_READ_GLOBAL)]


def _plan(slots_a_thread: int):
    """A plan whose threads take at most ``slots_a_thread`` slots each
    (forward and dw)."""
    def plan(tp, B, N, K, dw=False):
        from diffphore_torch.ops import tp_scalar
        G, S = len(tp_scalar.units_l2(tp).units), tp.irreps_sh.dim
        SL = max(1, min(K, -(-K // slots_a_thread), tp_scalar.F2_THREADS // G))
        R = max(1, min(N, tp_scalar.F2_THREADS // (SL * G)))
        return R, SL, tp_scalar.chunk_idx(R, SL, K, S)
    return plan


#: name -> ([(text of the source, its replacement)], {tp_scalar setting: value})
VARIANTS = {
    "parent": None,
    "whole": ([], {}),
    "harmonics unstaged": (SH_UNSTAGED, {}),
    "four slots a thread": ([], {"plan_idx": _plan(4)}),
    "eight slots a thread": ([], {"plan_idx": _plan(8)}),
    "sixteen slots a thread": ([], {"plan_idx": _plan(16)}),
}


def compile_source(src_path: str, edits, out_dir: str, slug: str) -> str:
    """The library of ``src_path`` with ``edits`` applied."""
    from diffphore_torch.ops import build

    with open(src_path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{slug}: {old!r} is not once in the source")
        src = src.replace(old, new)
    cu, so = os.path.join(out_dir, slug + ".cu"), os.path.join(out_dir, slug + ".so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, cu], check=True, capture_output=True,
                   text=True)
    return so


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default=os.path.join(HERE, "build", "parent"))
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3_idx_variants needs a GPU")
    from diffphore_torch.cli.profile_kernels import KNN_K, SEQ, SEQ2, SH, graph_us, knn_index
    from diffphore_torch.ops import build, tp_scalar
    from diffphore_torch.ops.tensor_product import channelwise_tp
    import chip_smoke as cs

    card = cs.card_line()
    out_dir = os.path.join(HERE, "build", "k3_idx_variants")
    os.makedirs(out_dir, exist_ok=True)
    names = [n for n in args.variants if n != "parent"]
    slugs = {n: "".join(c if c.isalnum() else "_" for c in n) for n in names}
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        built = dict(zip(names, pool.map(lambda n: compile_source(
            os.path.join(build.CSRC, "tp_scalar.cu"), VARIANTS[n][0], out_dir, slugs[n]),
            names)))
    parent = None
    if "parent" in args.variants:      # the parent tree's modules, under their own names
        saved = {k: v for k, v in sys.modules.items() if k.startswith("diffphore_torch")}
        for k in saved:
            del sys.modules[k]
        sys.path.insert(0, args.parent)
        parent = importlib.import_module("diffphore_torch.ops.tp_scalar")
        sys.path.remove(args.parent)
        for k in [k for k in sys.modules if k.startswith("diffphore_torch")]:
            del sys.modules[k]
        sys.modules.update(saved)

    B, P = 24, 96
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    idx, live = knn_index(B, P, KNN_K, gen)
    cases = []
    for lanes_, seq in ((4, SEQ), (8, SEQ2)):
        tp = channelwise_tp(seq[0], SH, seq[1])
        F = tp.weight_numel
        x, sh = randn(B, P, tp.irreps_in.dim), randn(B, P, KNN_K, 9)
        w = (randn(B, P, KNN_K, F) * live[:, :, None, None]).contiguous()
        cases.append((lanes_, tp, x, sh, w, randn(B, P, F, lanes_)))

    results = []
    original = build.load
    for name in args.variants + args.variants[::-1]:
        mod = tp_scalar
        saved = {}
        if name == "parent":
            mod = parent
        else:
            for key, value in VARIANTS[name][1].items():
                saved[key] = getattr(tp_scalar, key)
                setattr(tp_scalar, key, value)
            build.load = lambda _n, path=built[name]: ctypes.CDLL(path)
            tp_scalar._library.cache_clear()
        for lanes_, tp, x, sh, w, g in cases:
            mask = torch.zeros_like(g)
            for p in tp.paths:
                mask[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
            for dtype in (torch.float32, torch.bfloat16):
                xd, shd, wd = x.to(dtype), sh.to(dtype), w.to(dtype)
                leaves = [v.float().requires_grad_(True) for v in (xd, wd)]
                ref = tp_scalar.scalar_paths_aggregate_plain(tp, leaves[0].to(dtype), shd,
                                                             leaves[1].to(dtype), sender_index=idx)
                (ref_dw,) = torch.autograd.grad(ref, [leaves[1]], g * mask)
                for kernel, call, want in (
                        ("tp_scalar_fwd_idx",
                         lambda: mod.launch_forward(tp, xd, shd, wd, sender_index=idx),
                         ref.detach()),
                        ("tp_scalar_bwd_edge_idx",
                         lambda: mod.launch_backward_edge(tp, xd, shd, wd, g, False,
                                                          sender_index=idx)[0], ref_dw)):
                    got = call().float()
                    scale = max(float(want.abs().max()), 1e-30)
                    err = (got - want).abs()
                    if dtype == torch.bfloat16 and kernel.endswith("edge_idx"):
                        err = err - want.abs() * 2.0 ** -7
                        limit = 1e-6
                    else:
                        limit = 1e-4 if dtype == torch.float32 else 1e-5
                    worst = float(err.max()) / scale
                    results.append({"variant": name, "kernel": kernel, "lanes": lanes_,
                                    "dtype": str(dtype), "graph_us": graph_us(call),
                                    "worst_err_of_scale": worst, "ok": worst <= limit,
                                    "card": card})
                    print(json.dumps(results[-1]), flush=True)
        build.load = original
        for key, value in saved.items():
            setattr(tp_scalar, key, value)
        tp_scalar._library.cache_clear()
    return results


if __name__ == "__main__":
    main()
