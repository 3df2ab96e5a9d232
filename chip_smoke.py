#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``diffphore_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: require CUDA; print the card's name and power limit; full-f32
     matmuls and convolutions (no TF32).
  2. build: compile every CUDA kernel of the port from ``diffphore_torch/csrc``
     with nvcc for sm_90a (one nvcc per source, all at once).
  3. kernel check: capture the inputs of all 23 tensor-product convs of one
     forward of the main path (corpus2 model, 40 poses of a 24x96x8
     complex), hold K1 (``tp_fused``) against its plain PyTorch version on
     them, in f32 and with bf16 inputs, and time both with CUDA events.
  4. main path: ``FitEngine`` samples 8 cached complexes x 40 poses x 20
     reverse-diffusion steps with the corpus2 checkpoint and ranks them by
     fitness; K1 must launch exactly 23 x 20 times per dispatch; poses and
     scores must be finite; one complex is sampled again with the plain
     convs and the same noise, and one forward is compared.
  5. report: the kernels' JSON line, the card line, and the result line.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(HERE, "runs", "corpus2", "main")
CACHE_DIR = os.path.join(HERE, "data", "cache", "val_f1112e7d33")
BUCKET = (24, 96, 8)        # (A, P, T) of the complexes driven
N_COMPLEXES = 8
POSES = 40
STEPS = 20
CONVS_PER_FORWARD = 23
SEED = 0

# K1 against its plain version: |kernel - plain| <= TOL * max|plain|.
# f32 inputs: both compute in f32 and differ only in summation order.
TOL_F32 = 1e-4
# bf16 inputs: the kernel reads x, sh and attrs rounded to bf16 (8-bit
# mantissa) and is compared with the plain version on the f32 originals.
TOL_BF16 = 3e-2
# One forward of the score model, kernel convs against plain convs.
TOL_FORWARD = 1e-3
# 20 chained steps, kernel convs against plain convs, same noise: median
# pose RMSD (A).  Rounding differences may flip a step function of the cross
# graph for a pose, so the median, not the max, is held.
TOL_RERUN_RMSD = 0.1

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and f32 (non
# tensor-core) operations/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_work(tp, x, sh, attrs, masks, w1, w2):
    """(bytes, f32 operations) the fused function needs on these inputs:
    each input read once and the output written once; the edge MLP and the
    tensor product counted on edges with a mask set."""
    import numpy as np

    B, N, M, S = sh.shape
    E, H = w1.shape
    F = tp.weight_numel
    nbytes = (x.numel() * x.element_size() + sh.numel() * sh.element_size()
              + sum(a.numel() * a.element_size() for a in attrs)
              + sum(m.numel() * m.element_size() for m in masks)
              + 4 * (E * H + H + H * F + F) + 4 * B * N * F * 4)
    live_c = sum(int((m != 0).sum()) for m in masks)
    any_mask = masks[0] != 0
    for m in masks[1:]:
        any_mask = any_mask | (m != 0)
    live = int(any_mask.sum())
    tp_ops = 0
    node_ops = 0
    for p in tp.paths:
        d1, d2, d3 = 2 * p.l_in + 1, 2 * p.l_sh + 1, 2 * p.l_out + 1
        tp_ops += p.mul_in * 2 * (d2 * d3 + d3)
        node_ops += p.mul_in * 2 * d1 * d2 * d3
    ops = (live_c * (2 * E * H + 3 * H) + live * (2 * H * F + 2 * F + tp_ops)
           + B * M * node_ops)
    return nbytes, float(np.float64(ops))


def phase_kernel_check(model, batch, tp_fused):
    """Capture every conv call of one forward and hold K1 against its plain
    version on those inputs."""
    import torch

    from diffphore_torch.models.layers import DenseTPConv

    calls = []
    hooks = []
    for name, mod in model.named_modules():
        if isinstance(mod, DenseTPConv):
            hooks.append(mod.register_forward_hook(
                lambda m, args, out, name=name: calls.append((name, m, args))))
    with torch.inference_mode():
        model(batch, pose_group=POSES)
    for h in hooks:
        h.remove()
    if len(calls) != CONVS_PER_FORWARD:
        raise RuntimeError(f"captured {len(calls)} conv calls, expected {CONVS_PER_FORWARD}")

    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for name, mod, (sender, edge_attr, edge_sh, edge_mask) in calls:
        attrs = edge_attr if isinstance(edge_attr, (list, tuple)) else [edge_attr]
        masks = edge_mask if isinstance(edge_mask, (list, tuple)) else [edge_mask]
        x = sender.to(f32).contiguous()
        sh = edge_sh.to(f32).contiguous()
        attrs = [a.to(f32).contiguous() for a in attrs]
        masks = [m.contiguous() for m in masks]
        params = (mod.fc_w1.detach(), mod.fc_b1.detach(), mod.fc_w2.detach(), mod.fc_b2.detach())
        tp = mod.tp
        with torch.inference_mode():
            ref = tp_fused.tp_aggregate_fused_plain(tp, x, sh, attrs, masks, *params)
            got = tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params)
            got_bf = tp_fused.tp_aggregate_fused(
                tp, x.to(bf16), sh.to(bf16), [a.to(bf16) for a in attrs], masks, *params)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            err_bf = float((got_bf - ref).abs().max())
            if not (err <= TOL_F32 * max(scale, 1e-30)):
                raise AssertionError(f"{name}: f32 |kernel - plain| {err} > {TOL_F32} * {scale}")
            if not (err_bf <= TOL_BF16 * max(scale, 1e-30)):
                raise AssertionError(f"{name}: bf16 |kernel - plain| {err_bf} > {TOL_BF16} * {scale}")
            ms = cuda_ms(lambda: tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params), 20)
            plain_ms = cuda_ms(
                lambda: tp_fused.tp_aggregate_fused_plain(tp, x, sh, attrs, masks, *params), 5)
        nbytes, ops = k1_work(tp, x, sh, attrs, masks, params[0], params[2])
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        B, N, M, _ = sh.shape
        cases.append({
            "conv": name, "B": B, "N": N, "M": M, "C": len(attrs), "E": params[0].shape[0],
            "H": params[0].shape[1], "F": tp.weight_numel, "max_abs_err": err,
            "max_abs_err_bf16": err_bf, "max_abs_ref": scale, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "f32_ops": ops,
        })
        print(f"  {name:28s} B={B:2d} N={N:3d} M={M:3d} C={len(attrs)} F={tp.weight_numel:3d} "
              f"err={err:.2e} bf16_err={err_bf:.2e} (max|ref| {scale:.2e}) "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {max(t_bytes, t_ops):.4f} ms",
              flush=True)
    return cases


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "diffphore_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke test needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from diffphore_torch.cli.pipeline import FitEngine, job_from_cached
    from diffphore_torch.data.graphs import load_cached, repeat_batch
    from diffphore_torch.models.layers import DenseTPConv
    from diffphore_torch.ops import build, tp_fused
    from diffphore_torch.ops.fitscore import batch_phore_arrays
    from diffphore_torch.sampler.sampling import SamplerSettings, draw_prior, randomize_position
    from diffphore_torch.utils.checkpoints import load_model_dir

    # ---- 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 2. build
    t0 = time.perf_counter()
    built = build.build(["tp_fused"])
    build_s = time.perf_counter() - t0
    for name, (path, log) in built.items():
        print(f"build: {name} -> {os.path.relpath(path, HERE)} in {build_s:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel check on the main path's conv inputs
    cfg, model = load_model_dir(MODEL_DIR, device="cuda")
    files = sorted(glob.glob(os.path.join(CACHE_DIR, "*.npz")))
    complexes = [b for b in (load_cached(f) for f in files)
                 if (b.num_atoms, b.num_phore, b.num_torsions) == BUCKET][:N_COMPLEXES]
    if len(complexes) != N_COMPLEXES:
        raise RuntimeError(f"found {len(complexes)} cached complexes in bucket {BUCKET}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    batch = repeat_batch(complexes[0].to("cuda"), POSES)
    batch = randomize_position(batch, draw_prior(POSES, BUCKET[2], gen, "cuda"),
                               tr_sigma_max=cfg.tr_sigma_max)
    batch = batch.replace(t=torch.full((POSES,), 0.5, device="cuda"))
    print("kernel check: tp_fused on the 23 conv calls of one forward", flush=True)
    cases = phase_kernel_check(model, batch, tp_fused)

    # one forward, kernel convs against plain convs
    convs = [m for m in model.modules() if isinstance(m, DenseTPConv)]
    with torch.inference_mode():
        fwd_k = model(batch, pose_group=POSES)
        for m in convs:
            m.use_kernel = False
        fwd_p = model(batch, pose_group=POSES)
        for m in convs:
            m.use_kernel = True
    for label, a, b in zip(("tr", "rot", "tor"), fwd_k, fwd_p):
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        print(f"forward {label}: max |kernel - plain| / max|plain| = {rel:.2e}")
        if not rel <= TOL_FORWARD:
            raise AssertionError(f"forward {label} differs: {rel} > {TOL_FORWARD}")

    # ---- 4. main path
    engine = FitEngine(cfg, model, samples_per_complex=POSES,
                       settings=SamplerSettings(inference_steps=STEPS), seed=SEED, device="cuda")
    jobs = [job_from_cached(c) for c in complexes]
    engine.run_complexes(jobs[:1])  # warm-up: cuBLAS/cuSOLVER handles, tables
    torch.cuda.synchronize()
    tp_fused.KERNEL.launches = 0
    t0 = time.perf_counter()
    results = engine.run_complexes(jobs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = tp_fused.KERNEL.launches
    expected = N_COMPLEXES * CONVS_PER_FORWARD * STEPS
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, expected {expected}")
    import numpy as np

    for job, r in zip(jobs, results):
        if r["poses"].shape != (POSES, job.n_atoms, 3) or not np.isfinite(r["poses"]).all():
            raise AssertionError(f"{r['name']}: poses not finite or misshapen")
        if not np.isfinite(r["fitscore"]).all():
            raise AssertionError(f"{r['name']}: fitscores not finite")
    poses_per_s = N_COMPLEXES * POSES / elapsed
    best = [max(r["fitscore"]) for r in results]
    print(f"main path: {N_COMPLEXES} complexes x {POSES} poses x {STEPS} steps in "
          f"{elapsed:.3f} s = {poses_per_s:.1f} poses/s ({card}); K1 launches {launches} "
          f"({launches // N_COMPLEXES} per dispatch); best fitscore per complex "
          + " ".join(f"{b:.3f}" for b in best), flush=True)

    # the same complex, same noise, kernel convs against plain convs
    job = jobs[0]
    noise = engine.draw_noise(POSES, BUCKET[2])
    rows = repeat_batch(job.batch.to("cuda"), POSES)
    ref = batch_phore_arrays(rows)
    pos_k, sc_k = engine.run_batch(rows, ref, POSES, noise)
    for m in convs:
        m.use_kernel = False
    pos_p, sc_p = engine.run_batch(rows, ref, POSES, noise)
    for m in convs:
        m.use_kernel = True
    n_at = job.n_atoms
    rmsd = ((pos_k[:, :n_at] - pos_p[:, :n_at]) ** 2).sum(-1).mean(-1).sqrt().cpu().numpy()
    dfit = (sc_k["phscore1"] - sc_p["phscore1"]).abs().max().item()
    print(f"kernel vs plain convs, {job.name}, same noise, {STEPS} steps: pose RMSD median "
          f"{np.median(rmsd):.2e} max {rmsd.max():.2e} A; max |d phscore1| {dfit:.2e}")
    if not np.median(rmsd) <= TOL_RERUN_RMSD:
        raise AssertionError(f"kernel and plain runs diverge: median RMSD {np.median(rmsd)} A")

    # ---- 5. report
    kernel = {
        "name": "tp_fused",
        "route": "cuda",
        "source": "diffphore_torch/csrc/tp_fused.cu",
        "replaces": "diffphore_tpu/ops/pallas/tp_fused.py:113",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_abs_err_bf16": max(c["max_abs_err_bf16"] for c in cases),
        "ms": sum(c["ms"] for c in cases),
        "kernel_ms": sum(c["ms"] for c in cases),
        "plain_ms": sum(c["plain_ms"] for c in cases),
        "bound_ms": sum(c["bound_ms"] for c in cases),
        "bound_by": ("operations" if sum(c["bound_ms"] for c in cases if c["bound_by"] == "operations")
                     >= sum(c["bound_ms"] for c in cases if c["bound_by"] == "bytes") else "bytes"),
        "library_ms": None,
        "unit": "one forward: the 23 conv calls, each timed alone",
    }
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
