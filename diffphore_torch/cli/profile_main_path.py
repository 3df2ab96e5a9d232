"""Where the time of one main-path dispatch goes on the GPU.

    python -m diffphore_torch.cli.profile_main_path [--confidence_model_dir runs/corpus2/confidence]

Samples one cached complex (the corpus2 model, 40 poses x 20 reverse
steps, one dispatch as ``FitEngine`` makes it, at the checkpoint's
``compute_dtype``, bfloat16) after a warm-up dispatch, once timed by the host clock around a synchronized run
and once under ``torch.profiler``.  Prints one JSON object: wall time,
device-busy time and share (sum of kernel times over wall time), K1's time
and launches, the number of kernel launches, and the top kernels and host
ops.  With ``--confidence_model_dir`` the engine also scores the final poses
with that confidence head, and the object adds the head's forward alone on
the dispatch's final poses: its device time and kernel launches (profiler,
mean of 5) and its wall time per call (host clock, synchronized).  It needs
a GPU and fails without one.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import time

import torch

from ..data.graphs import load_cached
from ..ops import tp_fused
from ..sampler.sampling import SamplerSettings
from ..utils.checkpoints import load_confidence_dir, load_model_dir
from .pipeline import FitEngine, job_from_cached

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL_DIR = os.path.join(_ROOT, "runs", "corpus2", "main")
CACHE_DIR = os.path.join(_ROOT, "data", "cache", "val_f1112e7d33")
POSES, STEPS = 40, 20


def _device_us(event) -> float:
    # the attribute was renamed from *cuda* to *device* in torch 2.4
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def _kernels(prof):
    return [e for e in prof.key_averages()
            if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--confidence_model_dir", default=None,
                   help="rank by this confidence head (a --confidence_mode run directory)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]

    cfg, model = load_model_dir(MODEL_DIR, device="cuda")
    batch = load_cached(sorted(glob.glob(os.path.join(CACHE_DIR, "*.npz")))[0])
    head, seen = None, []
    if args.confidence_model_dir:
        _, head = load_confidence_dir(args.confidence_model_dir, device="cuda")
        head.register_forward_pre_hook(lambda mod, a: seen.append(a[0]))
    engine = FitEngine(cfg, model, samples_per_complex=POSES,
                       settings=SamplerSettings(inference_steps=STEPS), device="cuda",
                       confidence=head)
    job = job_from_cached(batch)
    engine.run_complexes([job])  # warm-up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    engine.run_complexes([job])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    launches0 = tp_fused.KERNEL.launches
    with torch.profiler.profile(activities=acts) as prof:
        engine.run_complexes([job])
        torch.cuda.synchronize()
    k1_launches = tp_fused.KERNEL.launches - launches0
    events = prof.key_averages()
    kernels = _kernels(prof)
    busy_us = sum(_device_us(e) for e in kernels)
    k1_us = sum(_device_us(e) for e in kernels if "tp_fused_kernel" in e.key)
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    out = {
        "card": card,
        "compute_dtype": cfg.compute_dtype,
        "poses": POSES, "steps": STEPS, "atoms_phore_torsions":
            [batch.num_atoms, batch.num_phore, batch.num_torsions],
        "wall_ms": wall_ms,
        "poses_per_s": POSES / wall_ms * 1e3,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "device_busy_share": busy_us / 1e3 / wall_ms if busy_us else None,
        "k1_ms": k1_us / 1e3 if busy_us else None,
        "k1_launches": k1_launches,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [[e.key[:80], _device_us(e) / 1e3, e.count]
                        for e in sorted(kernels, key=_device_us, reverse=True)[:12]],
        "top_host_ops": [[e.key, e.self_cpu_time_total / 1e3, e.count] for e in host[:12]],
    }
    if head is not None:
        final = seen[-1]
        with torch.inference_mode():
            head(final, pose_group=POSES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                head(final, pose_group=POSES)
            torch.cuda.synchronize()
            head_wall = (time.perf_counter() - t0) * 1e3 / 5
            with torch.profiler.profile(activities=acts) as hprof:
                for _ in range(5):
                    head(final, pose_group=POSES)
                torch.cuda.synchronize()
        hk = _kernels(hprof)
        out.update({
            "confidence_model_dir": args.confidence_model_dir,
            "head_wall_ms": head_wall,
            "head_device_ms": sum(_device_us(e) for e in hk) / 1e3 / 5,
            "head_k1_ms": sum(_device_us(e) for e in hk if "tp_fused_kernel" in e.key) / 1e3 / 5,
            "head_kernel_launches": sum(e.count for e in hk) / 5,
        })
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
