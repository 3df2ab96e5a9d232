"""K1's wide forms (``tp_fused_kernel<T, NC, IDX, true>`` and
``tp_fused_l2_kernel<T, NCH, true>``) in variants, on the card.

Each variant is this tree's ``csrc/tp_fused.cu`` with textual edits
(``VARIANTS``), compiled into ``build/k1_wide_variants/`` and
loaded in the place of the port's library, called through
``tp_fused.tp_aggregate_fused`` on the inputs of ``cli.profile_kernels
--k1_wide`` (phase 19's 23 conv calls of a 40-pose forward: the 4-lane form
at ns / nv = 32 / 16, dense and sender-index, the 8-lane form at 48 / 10, l
= 2; f32 and bf16).  Each variant prints one JSON line per (form, mode,
dtype): the graph-replay time summed over the calls, and the worst error of
a call against the plain version (f32 within 1e-4 of scale, bf16 within
3e-2: the JAX package's bf16 conv).  The variants run twice, in turns (A B
... B A).

    python analysis/k1_wide_variants.py [--variants whole ...] [--source NAME=PATH ...]

Variants: ``whole`` (this tree); ``bf16 hidden on FMA`` (the bf16 first
product per warp on FMA, W1 kept bf16 in its own layout [k][unit], the
second product on the tensor cores as in ``whole``); ``8-lane bf16 16-row
tiles`` (the 8-lane bf16 wide kernel on 16-row tiles instead of 32); ``bf16
resident in 64-unit chunks`` (resident bf16 weights walked in chunks as
staged ones are, not the whole hidden layer in one pass); ``one block an
SM`` (every wide instantiation's launch bounds ask for one block an SM,
not only the 4-lane f32 ones': more registers); and phases cut to see
where the time goes (their outputs are wrong, their errors are
printed): ``no resident weight load``, ``no walk``, ``no edge MLP``.  ``--source`` adds another copy of
the source with this tree's C interface (an earlier state of it, say).
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

# the bf16 first product per warp on FMA: W1 stored [k][unit] (bf16)
W1_STORE = '''#pragma unroll 2
    for (int i = tid; i < urows * k8; i += WIDE_NT) {
      const int u = i % urows, k = 8 * (i / urows);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = u < u_end && k + j < E ? w1[(size_t)(k + j) * H + hc + u] : 0.f;
      put8(W1 + u * q1 + k, v);
    }'''
W1_STORE_KU = '''for (int i = tid; i < 8 * k8 * (urows / 2); i += WIDE_NT) {
      const int k = i / (urows / 2), u = 2 * (i - k * (urows / 2));
      const float a = k < E && u < u_end ? w1[(size_t)k * H + hc + u] : 0.f;
      const float b = k < E && u + 1 < u_end ? w1[(size_t)k * H + hc + u + 1] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(W1 + k * urows + u) = __floats2bfloat162_rn(a, b);
    }'''
VIEW_END = "    v.q2 = hcw + 8;\n  }\n  return v;\n}"
VIEW_END_KU = ("    v.q2 = hcw + 8;\n  }\n  v.w1t += hcw == 0 ? hc - hc * v.q1 : 0;\n"
               "  v.q1 = hcw ? hcw : pad_to(H, 8);\n  return v;\n}")
HIDDEN_FROM = "  const int ks1 = (E + 15) / 16;\n  for (int c = 0; c < C; ++c) {"
HIDDEN_TO = "  __syncthreads();\n  const int ks2 = (kn + 15) / 16;"
HIDDEN_FMA = '''  constexpr int RTB = R / 8;                     // rows a warp
  const int r0 = warp * RTB, u0 = 2 * lane;
  const int E16 = (E + 15) / 16 * 16;
  for (int c = 0; c < C; ++c) {
    float pre[RTB][2];
#pragma unroll
    for (int i = 0; i < RTB; ++i) pre[i][0] = pre[i][1] = 0.f;
    const __nv_bfloat16* A = a + ((size_t)c * R + r0) * AP;
#pragma unroll 2
    for (int k = 0; k < E16; k += 4) {
      float4 av[RTB];
#pragma unroll
      for (int i = 0; i < RTB; ++i) av[i] = ld4s(A + i * AP + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 wv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(w.w1t + (k + kk) * w.q1 + u0));
#pragma unroll
        for (int i = 0; i < RTB; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
          pre[i][0] = fmaf(x, wv.x, pre[i][0]);
          pre[i][1] = fmaf(x, wv.y, pre[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RTB; ++i) {
      const int r = r0 + i;
      const bool ok = r < rows;
      const float h0 = ok && u0 < kn
                           ? fmaxf(bf16_round(bf16_round(pre[i][0]) + s_b1[hc + u0]), 0.f) : 0.f;
      const float h1 = ok && u0 + 1 < kn
                           ? fmaxf(bf16_round(bf16_round(pre[i][1]) + s_b1[hc + u0 + 1]), 0.f)
                           : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(s_hidb + (c * R + r) * hp + u0) =
          __floats2bfloat162_rn(h0, h1);
    }
  }
'''
# resident bf16 weights in chunks of 64 units (as staged ones), not one pass
CHUNKS_64 = [("hcw ? hcw : ROUND ? H : WHC", "hcw ? hcw : WHC"),
             ("  return hcw ? WKB : pad_to(H, 16) + 8;", "  return WKB;")]

# phases cut, to see where the time goes (the outputs are then wrong)
NO_RESIDENT_LOAD = [("  const int u_end = hcw ? min(hcw, H - hc) : H;   // units of this load",
                     "  if (hcw == 0) return;\n  const int u_end = hcw ? min(hcw, H - hc) : H;")]
NO_WALK = [("re = min(rows, rb + ROWS / parts);", "re = rb;"),
           ("re = min(rows, rb + RWS / parts);", "re = rb;")]
NO_MLP = [("        const int kn = min(hstep, H - hc);", "        const int kn = 0 * min(hstep, H - hc);"),
          ("          if (r0 < rows)\n            wide_chunk_f32",
           "          if (r0 < 0 * rows)\n            wide_chunk_f32")]
ONE_BLOCK = [("__launch_bounds__(THREADS, WIDE && sizeof(T) == 4 ? 1 : 2) tp_fused_kernel(",
              "__launch_bounds__(THREADS, WIDE ? 1 : 2) tp_fused_kernel("),
             ("__launch_bounds__(L2_THREADS, 2) tp_fused_l2_kernel(",
              "__launch_bounds__(L2_THREADS, WIDE ? 1 : 2) tp_fused_l2_kernel(")]

# the 8-lane bf16 wide kernel on tiles of 16 live edges (the host's
# layout_bytes_l2 then overstates its shared memory, which is harmless)
ROWS_16 = [("constexpr int L2_WIDE_ROWS_BF16 = 32;", "constexpr int L2_WIDE_ROWS_BF16 = 16;")]

#: name -> [(text of the source, its replacement: every place it stands)],
#: or a callable of the source giving them
VARIANTS = {
    "whole": [],
    "bf16 hidden on FMA": lambda src: CHUNKS_64 + [
        (W1_STORE, W1_STORE_KU), (VIEW_END, VIEW_END_KU),
        (src[src.index(HIDDEN_FROM):src.index(HIDDEN_TO)], HIDDEN_FMA)],
    "bf16 resident in 64-unit chunks": CHUNKS_64,
    "8-lane bf16 16-row tiles": ROWS_16,
    "one block an SM": ONE_BLOCK,
    "no resident weight load": NO_RESIDENT_LOAD,
    "no walk": NO_WALK,
    "no edge MLP": NO_MLP,
}


def compile_source(src_path: str, edits, out_dir: str, slug: str) -> str:
    """The library of ``src_path`` with ``edits`` applied."""
    from diffphore_torch.ops import build

    with open(src_path) as f:
        src = f.read()
    if callable(edits):
        edits = edits(src)
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{slug}: {old[:60]!r} is not in the source")
        src = src.replace(old, new)
    cu, so = os.path.join(out_dir, slug + ".cu"), os.path.join(out_dir, slug + ".so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, cu], check=True,
                   capture_output=True, text=True)
    return so


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--source", nargs="*", default=[], metavar="NAME=PATH",
                        help="another tp_fused.cu with this tree's C interface (a parent "
                             "tree's, say), timed as variant NAME")
    args = parser.parse_args(argv)
    sources = dict(spec.split("=", 1) for spec in args.source)
    for name in sources:
        VARIANTS[name] = []
        args.variants.append(name)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_wide_variants needs a GPU")
    from diffphore_torch.cli.profile_kernels import graph_us, k1_wide_inputs
    from diffphore_torch.ops import build, tp_fused
    import chip_smoke as cs

    card = cs.card_line()
    out_dir = os.path.join(HERE, "build", "k1_wide_variants")
    os.makedirs(out_dir, exist_ok=True)
    slugs = {n: "".join(c if c.isalnum() else "_" for c in n) for n in args.variants}
    with ThreadPoolExecutor(max(1, len(args.variants))) as pool:
        built = dict(zip(args.variants, pool.map(lambda n: compile_source(
            sources.get(n, os.path.join(build.CSRC, "tp_fused.cu")), VARIANTS[n], out_dir,
            slugs[n]), args.variants)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = list(k1_wide_inputs(lambda *shape: torch.randn(*shape, device="cuda",
                                                           generator=gen), gen))
    refs = []
    with torch.no_grad():
        for _, _, _, tp, x, sh, attrs, masks, params, kw in cases:
            refs.append(tp_fused.tp_aggregate_fused_plain(tp, x, sh, attrs, masks, *params,
                                                          **kw))
    results = []
    original = build.load
    for name in args.variants + args.variants[::-1]:
        build.load = lambda _n, path=built[name]: ctypes.CDLL(path)
        tp_fused._library.cache_clear()
        sums = {}
        for ((tag, indexed), conv, dtype, tp, x, sh, attrs, masks, params, kw), ref in zip(
                cases, refs):
            call = lambda: tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params, **kw)
            with torch.no_grad():
                got = call()
                us = graph_us(call)
            err = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
            limit = 1e-4 if dtype == torch.float32 else 3e-2
            s = sums.setdefault((tag, indexed, str(dtype)), {
                "variant": name, "form": tag, "indexed": indexed, "dtype": str(dtype),
                "calls": 0, "graph_us": 0.0, "worst_err_of_scale": 0.0, "ok": True,
                "card": card})
            s["calls"] += 1
            s["graph_us"] += us
            s["worst_err_of_scale"] = max(s["worst_err_of_scale"], err)
            s["ok"] = s["ok"] and err <= limit
        for s in sums.values():
            results.append(s)
            print(json.dumps(s), flush=True)
        build.load = original
        tp_fused._library.cache_clear()
    return results


if __name__ == "__main__":
    main()
