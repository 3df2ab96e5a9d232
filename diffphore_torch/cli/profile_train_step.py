"""Where the time of one training step goes on the GPU.

    python -m diffphore_torch.cli.profile_train_step [--rate_from_infer 0.6 | --confidence_mode]
        [--compute_dtype float32] [--cache_dir DIR --bucket 48 160 16]

Runs the train step (fresh corpus2-width model, dropout on, batch 24 of
the 24 x 96 x 8 bucket of the training cache, or of ``--bucket`` in
``--cache_dir``, such as a ``train_*`` directory that ``cli.train
--featurize_only`` wrote in the corpus2 recipe's buckets; fewer complexes
than 24 are repeated to fill the batch) on one fixed batch after
warm-up steps, once timed by the host clock around a synchronized window
and once under ``torch.profiler``.  With ``--rate_from_infer`` > 0 it is the
calibrated-conformation-sampler step at that branch probability, from the
shipped corpus2 weights (the frozen reverse step needs a trained model to
be a fair load).  With ``--confidence_mode`` it is the confidence head's train
step (fresh weights, the config of ``runs/corpus2/confidence``, its
``rmsd_lt2`` labels).  The convs compute in the shipped config's
``compute_dtype`` (bfloat16) unless ``--compute_dtype`` says otherwise.
Prints one JSON object: wall time per step, device-busy
time and share (sum of kernel times over wall time), the time and launches
of K1, of K2's three kernels and of K3's three, the number of kernel launches
per step, peak memory, and the top kernels and host ops.  It needs a GPU
and fails without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import time

import torch

from ..data.graphs import concat_batches, load_cached
from ..models.layers import set_compute_dtype
from ..ops import tp_aggregate, tp_fused, tp_scalar
from ..train.ccsampler import make_ccsampler_train_step
from ..train.confidence import create_confidence_train_state, make_confidence_train_step
from ..train.state import create_train_state, make_train_step
from ..utils.checkpoints import load_config_yaml, load_model_dir
from .profile_main_path import MODEL_DIR, _ROOT, _device_us

CACHE_DIR = os.path.join(_ROOT, "data", "cache", "train_f1112e7d33")
CONFIDENCE_DIR = os.path.join(_ROOT, "runs", "corpus2", "confidence")
BUCKET = (24, 96, 8)
BATCH, WARMUP, TIMED, PROFILED = 24, 3, 10, 5
#: device kernel name -> the wrapper's launch counter
KERNELS = {
    "tp_fused_kernel": tp_fused.KERNEL,
    "tp_aggregate_fwd_kernel": tp_aggregate.FWD,
    "tp_aggregate_bwd_edge_kernel": tp_aggregate.BWD_EDGE,
    "tp_aggregate_bwd_x_kernel": tp_aggregate.BWD_X,
    "tp_scalar_fwd_kernel": tp_scalar.FWD,
    "tp_scalar_bwd_edge_kernel": tp_scalar.BWD_EDGE,
    "tp_scalar_bwd_x_kernel": tp_scalar.BWD_X,
}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rate_from_infer", type=float, default=0.0,
                        help="> 0: profile the calibrated-sampler step at this probability")
    parser.add_argument("--confidence_mode", action="store_true",
                        help="profile the confidence head's train step")
    parser.add_argument("--compute_dtype", choices=["bfloat16", "float32"], default=None,
                        help="the convs' compute dtype (default: the shipped config's)")
    parser.add_argument("--cache_dir", default=CACHE_DIR,
                        help="a directory of featurized .npz complexes")
    parser.add_argument("--bucket", type=int, nargs=3, default=list(BUCKET),
                        metavar=("A", "P", "T"), help="the (atoms, phore points, torsions) pads")
    args = parser.parse_args(argv)
    rate = args.rate_from_infer
    if rate > 0 and args.confidence_mode:
        parser.error("--rate_from_infer and --confidence_mode name two different steps")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]

    cfg = load_config_yaml(CONFIDENCE_DIR if args.confidence_mode else MODEL_DIR)
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    bucket = tuple(args.bucket)
    rows = []
    for f in sorted(glob.glob(os.path.join(args.cache_dir, "*.npz"))):
        b = load_cached(f)
        if (b.num_atoms, b.num_phore, b.num_torsions) == bucket:
            rows.append(b)
        if len(rows) == BATCH:
            break
    if not rows:
        raise SystemExit(f"no complex of bucket {bucket} in {args.cache_dir}")
    rows = [rows[i % len(rows)] for i in range(BATCH)]
    batch = concat_batches(rows).replace(names=(), meta=()).to("cuda")
    if args.confidence_mode:
        state = create_confidence_train_state(cfg, seed=0, device="cuda")
        step = make_confidence_train_step(cfg, label_mode="rmsd_lt2")
    elif rate > 0:
        _, model = load_model_dir(MODEL_DIR, device="cuda")
        set_compute_dtype(model, cfg.compute_dtype)
        state = create_train_state(cfg, device="cuda", model=model)
        cc_step = make_ccsampler_train_step(cfg)

        def step(state, batch, gen):
            return cc_step(state, batch, gen, p_from_infer=rate)
    else:
        state = create_train_state(cfg, seed=0, device="cuda")
        step = make_train_step(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for _ in range(WARMUP):
        step(state, batch, gen)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        step(state, batch, gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    before = {name: k.launches for name, k in KERNELS.items()}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED):
            step(state, batch, gen)
        torch.cuda.synchronize()
    profiled_wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED
    events = prof.key_averages()
    # the optimizer's annotation range carries its kernels' device time a second time
    kernels = [e for e in events
               if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Optimizer.")]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / PROFILED
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    out = {
        "card": card,
        "step": ("confidence head" if args.confidence_mode else
                 f"calibrated sampler, rate_from_infer {rate}" if rate > 0 else "plain diffusion"),
        "batch": BATCH, "atoms_phore_torsions": list(bucket), "dropout": cfg.dropout,
        "compute_dtype": cfg.compute_dtype,
        "wall_ms_per_step": wall_ms,
        "steps_per_s": 1e3 / wall_ms,
        "complexes_per_s": BATCH * 1e3 / wall_ms,
        "peak_memory_gib": peak_gib,
        "profiled_wall_ms_per_step": profiled_wall_ms,
        "device_busy_ms_per_step": busy_ms or None,
        "device_busy_share": busy_ms / wall_ms if busy_ms else None,
        "port_kernels_ms_per_step": {name: sum(_device_us(e) for e in kernels if name in e.key)
                                     / 1e3 / PROFILED for name in KERNELS},
        "port_kernels_launches_per_step": {name: (k.launches - before[name]) / PROFILED
                                           for name, k in KERNELS.items()},
        "kernel_launches_per_step": sum(e.count for e in kernels) / PROFILED,
        "top_kernels": [[e.key[:80], _device_us(e) / 1e3 / PROFILED, e.count / PROFILED]
                        for e in sorted(kernels, key=_device_us, reverse=True)[:12]],
        "top_host_ops": [[e.key, e.self_cpu_time_total / 1e3 / PROFILED, e.count / PROFILED]
                         for e in host[:12]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
