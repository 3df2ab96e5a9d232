"""Locate where the second-order probe's f32 forward on a CUDA card departs
from the same forward on the CPU.

``chip_smoke.py`` phase 16 holds the probe (``runs/second_order_probe``) on
the card against its JAX reference.  On the CPU the port stands within a few
1e-7 of that reference.  This script prints, on the reference rows:

  * frequencies: the sinusoidal time embedding's table as the device's own
    f32 ``exp`` gives it, against the table the port uses
    (``ops.diffusion.embedding_frequencies``: exp in f64, rounded once), in
    ulps;
  * whole forward: the device's outputs (kernel convs, then plain convs), with
    the port's table and with the device's f32 ``exp`` table, each against the
    CPU's and against ``reference.npz``, relative to max|y|;
  * replay: the CPU forward runs once under a ``TorchFunctionMode`` that
    records every torch call whose result is a floating tensor (inputs and
    result, copied); each call is then replayed alone on the device on the
    CPU's inputs, and its distance from the CPU's result is that call's own
    error, free of what earlier calls carried in (the conv kernels are not
    torch calls: on the CPU their wrappers run the plain versions, whose
    calls the replay takes);
  * sensitivity, on the CPU: how far one ulp in each frequency moves the
    outputs, and the sines between the ligand and phore norms of the
    type-matched pairs (the norm channel's rotation axis is their normalized
    cross product).

    python analysis/probe_card_gap.py [--top 25] [--device cuda]
        [--json build/probe_gap.json]

``--device cpu`` runs every part on the CPU alone (the device sections then
read 0).  Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (constants and the cached complexes, no torch at import)

NAMES = ("tr", "rot", "tor")


def probe_rows(device):
    """The two reference rows of ``reference.npz`` on ``device``."""
    import torch

    from diffphore_torch.data.graphs import repeat_batch

    first = chip_smoke.bucket_complexes(chip_smoke.CACHE_DIR, 1)[0][1]
    rows = repeat_batch(first, len(chip_smoke.PROBE_T)).to(device)
    shift = torch.tensor(chip_smoke.PROBE_SHIFT, dtype=torch.float32, device=device)[:, None]
    return rows.replace(t=torch.tensor(chip_smoke.PROBE_T, dtype=torch.float32, device=device),
                        lig_pos=rows.lig_pos + shift)


def device_exp_frequencies(half, max_positions, device):
    """The frequency table as the device's own f32 exp gives it."""
    import torch

    return torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                     * (-math.log(max_positions) / (half - 1)))


def ulps(a, b):
    """Signed distance in f32 ulps of each element of ``a`` from ``b`` (both
    positive)."""
    import numpy as np

    return (np.asarray(a, np.float32).view(np.int32).astype(np.int64)
            - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def where():
    """file:line of the innermost frame in the port's package."""
    f = sys._getframe(2)
    while f is not None:
        if os.sep + "diffphore_torch" + os.sep in f.f_code.co_filename:
            return f"{os.path.relpath(f.f_code.co_filename, REPO)}:{f.f_lineno}"
        f = f.f_back
    return "?"


def tree_map(fn, x):
    if type(x) in (list, tuple):
        return type(x)(tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def floats(x):
    import torch

    out = []
    tree_map(lambda v: out.append(v) if isinstance(v, torch.Tensor)
             and v.is_floating_point() else None, x)
    return out


def record_cpu(model, rows):
    """[(func, args, kwargs, result, where)] of the CPU forward, and its outputs."""
    import torch
    from torch.overrides import TorchFunctionMode

    copy = lambda v: v.detach().clone() if isinstance(v, torch.Tensor) else v
    calls = []

    class Recorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = (tree_map(copy, args), tree_map(copy, kwargs))
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor) and out.is_floating_point() and out.numel() \
                    and floats(args) + floats(kwargs):
                calls.append((func, ins[0], ins[1], out.detach().clone(), where()))
            return out

    with torch.no_grad(), Recorder():
        outs = model(rows)
    return calls, [o.detach().clone() for o in outs]


def rel(got, want):
    scale = float(want.abs().max())
    return float((got.float().cpu() - want.float().cpu()).abs().max()) / max(scale, 1e-30)


def forward(model, rows, table=None):
    """The model's outputs, with the embedding's frequencies from ``table``
    (a function like ``embedding_frequencies``) where given."""
    import torch

    from diffphore_torch.ops import diffusion

    port_table = diffusion.embedding_frequencies
    diffusion.embedding_frequencies = table or port_table
    try:
        with torch.no_grad():
            return [o.detach().clone() for o in model(rows)]
    finally:
        diffusion.embedding_frequencies = port_table


def replay(calls, dev, top):
    """Each recorded call alone on ``dev``: the worst calls and sites."""
    import torch

    to_dev = lambda v: v.to(dev) if isinstance(v, torch.Tensor) else v
    local, skipped = [], []
    for i, (func, a, kw, out, at) in enumerate(calls):
        name = getattr(func, "__name__", str(func))
        try:
            with torch.no_grad():
                got = func(*tree_map(to_dev, a), **tree_map(to_dev, kw))
        except Exception as exc:      # a call that only the CPU takes
            skipped.append(f"{name} at {at} ({repr(exc)[:80]})")
            continue
        if isinstance(got, torch.Tensor) and got.shape == out.shape:
            local.append((i, name, at, rel(got, out), f"{tuple(out.shape)} {out.dtype}"))
    worst = sorted(local, key=lambda r: -r[3])
    by_site = collections.defaultdict(lambda: [0, 0.0, ""])
    for i, name, at, err, what in worst:
        s = by_site[(name, at)]
        s[0] += 1
        if err > s[1]:
            s[1], s[2] = err, what
    sites = sorted(by_site.items(), key=lambda kv: -kv[1][1])
    print(f"replay: {len(calls)} torch calls recorded on the CPU, {len(worst)} replayed alone on "
          f"{dev}; the {top} worst, max |device - CPU| / max|CPU| of the call's own result:")
    for i, name, at, err, what in worst[:top]:
        print(f"  #{i:5d} {err:.2e} {name:24s} {at:45s} {what}")
    print("replay by site (function, line: calls, worst):")
    for (name, at), (n, err, what) in sites[:top]:
        print(f"  {err:.2e} {name:24s} {at:45s} x{n} {what}")
    if skipped:
        print(f"{len(skipped)} calls not replayed: " + "; ".join(skipped[:5]))
    return ([{"call": i, "func": n, "at": at, "rel_err": e, "result": w}
             for i, n, at, e, w in worst[:200]],
            [{"func": n, "at": at, "calls": c, "rel_err": e, "result": w}
             for (n, at), (c, e, w) in sites])


def sensitivity(model, rows, cpu_out, half):
    """CPU: the outputs' change for one ulp up and down in each frequency,
    and the sines of the type-matched norm pairs."""
    import numpy as np
    import torch

    from diffphore_torch.ops import diffusion

    port_table = diffusion.embedding_frequencies
    out = {"frequency_ulp": []}
    print("sensitivity (CPU): one ulp in one frequency moves the outputs by, of max|output| "
          "(tr rot tor):")
    for k in range(half):
        for step in (1, -1):
            def table(h, m, device, k=k, step=step):
                f = port_table(h, m, device).clone()
                f[k] = torch.nextafter(f[k], torch.tensor(step * math.inf, device=device))
                return f
            moved = [rel(o, c) for o, c in zip(forward(model, rows, table), cpu_out)]
            out["frequency_ulp"].append({"k": k, "ulp": step, "rel": moved})
            print(f"  freq[{k}] {step:+d} ulp: " + " ".join(f"{e:.2e}" for e in moved))
    agg = rows.phoretype[:, None, :, :] * rows.lig_phorefp[:, :, None, :]
    sel = torch.einsum("bapk,bkac->bapc", agg, rows.lig_norm)
    pn = rows.phore_norm[:, None, :, :].expand(sel.shape)
    matched = (rows.lig_mask[:, :, None] & rows.phore_mask[:, None, :]) & (agg.sum(-1) > 0)
    sines = (torch.linalg.cross(sel, pn, dim=-1).norm(dim=-1)
             / (sel.norm(dim=-1) * pn.norm(dim=-1)).clamp(min=1e-30))[matched]
    sines = np.sort(sines.numpy())
    out["norm_sines"] = sines.tolist()
    print(f"sensitivity (CPU): {len(sines)} type-matched ligand-phore norm pairs over the rows; "
          f"{int((sines < 1e-6).sum())} with sine < 1e-6 (parallel to rounding: their rotation "
          f"axis is noise), {int((sines < 1e-3).sum())} < 1e-3; the smallest "
          + " ".join(f"{s:.1e}" for s in sines[:8]))
    return out


def main() -> int:
    import numpy as np
    import torch

    from diffphore_torch.models.layers import DenseTPConv, set_compute_dtype
    from diffphore_torch.ops import diffusion
    from diffphore_torch.utils import checkpoints

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--json", default=os.path.join(REPO, "build", "probe_gap.json"))
    args = parser.parse_args()
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = np.load(os.path.join(chip_smoke.PROBE_DIR, "reference.npz"))
    cfg, cpu_model = checkpoints.load_model_dir(chip_smoke.PROBE_DIR, device="cpu")
    set_compute_dtype(cpu_model, "float32")
    half, max_positions = cfg.sigma_embed_dim // 2, 10000
    report = {}

    # ---- frequencies
    port = diffusion.embedding_frequencies(half, max_positions, dev).cpu().numpy()
    own = device_exp_frequencies(half, max_positions, dev).cpu().numpy()
    cpu_own = device_exp_frequencies(half, max_positions, "cpu").numpy()
    report["frequencies"] = {"port": port.tolist(),
                             "device_f32_exp_ulps": ulps(own, port).tolist(),
                             "cpu_f32_exp_ulps": ulps(cpu_own, port).tolist()}
    print(f"frequencies ({half}): the f32 exp's table against the port's (exp in f64, rounded "
          f"once), in ulps: on {dev} {ulps(own, port).tolist()}, on the CPU "
          f"{ulps(cpu_own, port).tolist()}")

    # ---- whole forward
    rows_cpu = probe_rows("cpu")
    calls, cpu_out = record_cpu(cpu_model, rows_cpu)
    _, dev_model = checkpoints.load_model_dir(chip_smoke.PROBE_DIR, device=dev)
    set_compute_dtype(dev_model, "float32")
    rows = probe_rows(dev)
    whole = {}
    for table_name, table in (("port's table", None),
                              (f"{dev} f32 exp table", device_exp_frequencies)):
        for use_kernel in (True, False):
            for m in dev_model.modules():
                if isinstance(m, DenseTPConv):
                    m.use_kernel = use_kernel
            outs = forward(dev_model, rows, table)
            tag = f"{'kernel' if use_kernel else 'plain'} convs, {table_name}"
            for n, o, c in zip(NAMES, outs, cpu_out):
                whole[f"{n}, {tag}"] = {"vs_cpu": rel(o, c),
                                        "vs_reference": rel(o, torch.as_tensor(ref[n]))}
    for n, c in zip(NAMES, cpu_out):
        whole[f"{n}, CPU"] = {"vs_reference": rel(c, torch.as_tensor(ref[n]))}
    report["whole"] = whole
    print(f"whole forward on {dev}, max |x - y| / max|y|:")
    for k, v in whole.items():
        print(f"  {k:42s} " + "  ".join(f"{a} {b:.2e}" for a, b in v.items()))

    # ---- replay
    report["worst"], report["sites"] = replay(calls, dev, args.top)
    del calls

    # ---- sensitivity
    report["sensitivity"] = sensitivity(cpu_model, rows_cpu, cpu_out, half)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
