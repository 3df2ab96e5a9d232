"""Why the bf16 ``use_att`` forward check of ``chip_smoke.py`` (phase 15)
reads differently from run to run.

Phase 15 trains a ``use_att`` model through ``cli.train.main`` (corpus2's
config, two epochs of one step on 24 cached complexes, bf16) and then holds
one forward of it, kernel convs against plain convs, with ``check_forward``:
at bf16 within ``TOL_BF16_GAP`` of the plain route's own f32-vs-bf16
difference.  This script repeats that on the card and prints:

  * training: the same training run twice in one process, from the same
    seed and files; each parameter of the two last models compared bit for
    bit (how many differ, the largest difference); then again after each of
    the process's global generators (torch's CPU and CUDA ones, numpy's,
    Python's) is moved, as earlier phases of ``chip_smoke.py`` move them;
  * with ``--deterministic``: training under
    ``torch.use_deterministic_algorithms(True)`` (and cuBLAS's
    deterministic workspace, set for the whole process): the first operation
    that PyTorch refuses there (it names it), or, where none is refused, its
    weights against the first run's; and the plain bf16 forward so;
  * the forward: the plain and the kernel routes at bf16 run twice each on
    one model (bit-equal or not); the largest |output| of each module in
    the plain bf16 forward;
  * ``check_forward``'s three numbers for tr, rot and tor on each trained
    model.

``--perturb`` trains again beside a stream that keeps the card busy and after
the caching allocator has moved, each against the first run, and lists the
training's CUDA kernels that add with atomics or by index.

``--moved_stats N`` holds ``check_forward``'s numbers, each against its
bound, on N states of the trained model whose batch norms' running
statistics one training-mode forward has moved (as any training step moves
them), with dropout drawn after ``torch.manual_seed(seed)`` for seed 0 ..
N - 1, each from the trained state, and on one state that all N forwards
moved in turn.

``--save PATH`` keeps the first model's weights and forward outputs, and
``--compare A B`` prints how far two such files (from two processes, or two
machines) lie apart.

    python analysis/use_att_repro.py [--deterministic] [--perturb] [--moved_stats N]
                                     [--save PATH] [--json PATH]
    python analysis/use_att_repro.py --compare A B

Needs a GPU (not ``--compare``).  Imports no JAX.
"""

from __future__ import annotations

import os
import sys

if "--deterministic" in sys.argv:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")   # deterministic cuBLAS

import argparse
import json
import random
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


#: substrings of the names of CUDA kernels that add with atomics or by index
#: (whose order of addition the hardware's timing may decide)
ATOMIC_KERNELS = ("atomic", "index_put", "indexing_backward", "scatter", "index_add",
                  "indexFunc", "embedding_backward", "put_kernel", "histogram", "bincount")


def perturb(result, train, compare, model_a):
    """Training under three disturbances, each against the first run: a
    side stream that keeps the card busy with matrix products the whole
    time (other blocks resident beside the training's: the order in which
    atomics land changes); the caching allocator moved by held tensors of
    odd sizes (other addresses); and the CUDA kernels of a training run by
    the profiler, those named in ATOMIC_KERNELS listed."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    stop = threading.Event()

    def busy():
        side = torch.cuda.Stream()
        a = torch.randn(4096, 4096, device="cuda")
        with torch.cuda.stream(side):
            while not stop.is_set():
                for _ in range(8):
                    a = torch.tanh(a @ a * 1e-3)
                side.synchronize()

    worker = threading.Thread(target=busy)
    worker.start()
    try:
        (_, busy_model), _ = train("busy")
    finally:
        stop.set()
        worker.join()
    result["training beside a busy stream"] = compare(model_a, busy_model)
    print(f"training beside a busy stream: {json.dumps(result['training beside a busy stream'])}",
          flush=True)
    held = [torch.empty(n * 4099 + 17, device="cuda") for n in range(1, 200)]
    (_, moved_model), _ = train("allocator moved")
    del held
    result["training after the allocator moved"] = compare(model_a, moved_model)
    print("training after the allocator moved: "
          f"{json.dumps(result['training after the allocator moved'])}", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train("profiled")
    names = sorted({e.key for e in prof.key_averages()
                    if any(k in e.key for k in ATOMIC_KERNELS)})
    result["kernels that add by index or with atomics"] = names
    print(f"training's kernels that add by index or with atomics: {json.dumps(names)}",
          flush=True)


def moved_statistics(result, model, cfg, numbers, n):
    """check_forward's numbers (``numbers(model)``) on states of ``model``
    whose batch norms' running statistics one training-mode forward of
    chip_smoke.py's training batch moved, dropout drawn after
    ``torch.manual_seed(seed)``: for each seed from the trained state, then
    with all n forwards in turn.  The model's buffers are put back after."""
    import torch

    import chip_smoke as cs
    from diffphore_torch.data.transforms import apply_noise

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    train_batch, draws = cs.recipe_batch(gen)
    with torch.no_grad():
        noised, _ = apply_noise(train_batch, cfg.sigma_schedule, draws=draws)
    kept = [(buf, buf.detach().clone()) for buf in model.buffers()]

    def restore():
        with torch.no_grad():
            for buf, was in kept:
                buf.copy_(was)

    def move(seed):
        torch.manual_seed(seed)
        model.train()
        with torch.no_grad():
            model(noised)
        model.eval()

    states = {}
    for seed in range(n):
        move(seed)
        states[f"seed {seed}"] = numbers(model)
        restore()
    for seed in range(n):
        move(seed)
    states[f"seeds 0-{n - 1} in turn"] = numbers(model)
    restore()
    for label, rows in states.items():
        print(f"check_forward's numbers, statistics moved ({label}): {json.dumps(rows)}",
              flush=True)
    result["check_forward, statistics moved"] = states
    readings = [r for rows in states.values() for r in rows.values()]
    worst = max(r["bf16 kernel-plain"] / max(r["plain f32-bf16"], 1e-30) for r in readings)
    print(f"statistics moved: all within the bounds {all(r['within'] for r in readings)}; "
          f"largest bf16 kernel-plain / f32-bf16 gap {worst:.3f} (bound {cs.TOL_BF16_GAP})",
          flush=True)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", default=None, help="write the results here too")
    parser.add_argument("--deterministic", action="store_true",
                        help="also train and run the forward under deterministic algorithms")
    parser.add_argument("--save", default=None, help="keep weights and outputs here (torch.save)")
    parser.add_argument("--compare", nargs=2, default=None, help="two --save files to compare")
    parser.add_argument("--perturb", action="store_true",
                        help="also train while another stream keeps the card busy and after "
                             "the caching allocator has moved, and list the training's CUDA "
                             "kernels that add with atomics or by index")
    parser.add_argument("--moved_stats", type=int, default=0,
                        help="also hold the forward check on this many states whose running "
                             "statistics a training-mode forward has moved")
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    if args.compare:
        a, b = (torch.load(p, map_location="cpu") for p in args.compare)
        diff = {k: float((a[k].float() - b[k].float()).abs().max())
                for k in a if not torch.equal(a[k], b[k])}
        print(json.dumps({"tensors": len(a), "differ": len(diff),
                          "largest": sorted(diff.items(), key=lambda kv: -kv[1])[:12]}))
        return diff
    if not torch.cuda.is_available():
        raise SystemExit("use_att_repro needs a GPU")
    import chip_smoke as cs
    from diffphore_torch.cli import train as train_cli
    from diffphore_torch.cli.pipeline import job_from_cached
    from diffphore_torch.models.layers import set_compute_dtype
    from diffphore_torch.ops import build
    from diffphore_torch.utils import checkpoints, flat_yaml

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    build.build(["tp_fused", "tp_aggregate", "tp_scalar"])
    shipped, _ = checkpoints.load_model_dir(cs.MODEL_DIR, device="cuda")
    result = {"card": card}

    with tempfile.TemporaryDirectory() as tmp:
        cs.copy_bucket(cs.TRAIN_CACHE_DIR, os.path.join(tmp, "train_variants"), cs.TRAIN_BATCH)
        cs.copy_bucket(cs.CACHE_DIR, os.path.join(tmp, "val_variants"), cs.VAL_COMPLEXES)
        config = flat_yaml.load(os.path.join(cs.MODEL_DIR, "model_parameters.yml"))
        config.update(n_epochs=cs.VARIANT_EPOCHS, use_att=True, trioformer_layer=1,
                      ns=shipped.ns, nv=shipped.nv, num_conv_layers=shipped.num_conv_layers,
                      batch_size=cs.TRAIN_BATCH)
        yml = os.path.join(tmp, "use_att.yml")
        with open(yml, "w") as f:
            f.write(flat_yaml.dumps(config))

        def train(name, deterministic=False):
            run = os.path.join(tmp, name)
            torch.use_deterministic_algorithms(deterministic)
            try:
                train_cli.main(["--config", yml, "--cache_path", tmp, "--run_dir", run,
                                "--val_inference_freq", "0", "--seed", str(cs.SEED),
                                "--device", "cuda"])
                torch.cuda.synchronize()
            except RuntimeError as e:
                return None, str(e).splitlines()[0]
            finally:
                torch.use_deterministic_algorithms(False)
            return checkpoints.load_model_dir(run, device="cuda",
                                              checkpoint=checkpoints.LAST_MODEL), None

        def compare(m1, m2):
            s1, s2 = m1.state_dict(), m2.state_dict()
            differ = {k: float((s1[k].float() - s2[k].float()).abs().max())
                      for k in s1 if not torch.equal(s1[k], s2[k])}
            top = sorted(differ.items(), key=lambda kv: -kv[1])[:8]
            return {"tensors": len(s1), "differ": len(differ), "largest": top}

        (cfg_a, model_a), _ = train("a")
        (_, model_b), _ = train("b")
        result["training twice"] = compare(model_a, model_b)
        print(f"training twice, same seed: {json.dumps(result['training twice'])}", flush=True)
        moves = {"torch CPU": lambda: torch.rand(1000),
                 "torch CUDA": lambda: torch.rand(1000, device="cuda"),
                 "numpy": lambda: np.random.rand(1000), "python": lambda: random.random()}
        for label, move in moves.items():
            move()
            (_, moved), _ = train("moved " + label)
            result[f"training after moving the {label} generator"] = compare(model_a, moved)
            print(f"training after moving the {label} generator: "
                  f"{json.dumps(result[f'training after moving the {label} generator'])}",
                  flush=True)
        if args.perturb:
            perturb(result, train, compare, model_a)
        if args.deterministic:
            trained_det, refused = train("c", deterministic=True)
            result["training, deterministic algorithms"] = (
                {"refused": refused} if refused else compare(model_a, trained_det[1]))
            print(f"training under use_deterministic_algorithms(True): "
                  f"{json.dumps(result['training, deterministic algorithms'])}", flush=True)

    job = job_from_cached(cs.bucket_complexes(cs.CACHE_DIR, 1)[0][1])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    posed = cs.posed_rows(job.batch.to("cuda"), cs.POSES, cfg_a, gen)
    result["digests"] = {"weights": cs.digest(model_a.state_dict().values()),
                         "rows": cs.digest([posed.lig_pos, posed.t])}
    print(f"use_att forward check: weights {result['digests']['weights']}, "
          f"rows {result['digests']['rows']} (chip_smoke.py phase 15 prints the same)", flush=True)

    def forward(model, dtype, kernel):
        set_compute_dtype(model, dtype)
        cs.set_use_kernel(model, kernel)
        with torch.inference_mode():
            out = model(posed, pose_group=cs.POSES)
        cs.set_use_kernel(model, True)
        set_compute_dtype(model, cfg_a.compute_dtype)
        return [o.clone() for o in out[:3]]

    same = {}
    for kernel in (False, True):
        one, two = forward(model_a, "bfloat16", kernel), forward(model_a, "bfloat16", kernel)
        same["kernel" if kernel else "plain"] = [bool(torch.equal(a, b)) for a, b in zip(one, two)]
    result["bf16 forward twice, bit-equal (tr, rot, tor)"] = same
    print(f"bf16 forward of one model twice, bit-equal (tr, rot, tor): {same}", flush=True)

    if args.deterministic:
        torch.use_deterministic_algorithms(True)
        try:
            det = forward(model_a, "bfloat16", False)
            result["plain bf16 forward, deterministic algorithms"] = {
                "refused": None,
                "bit-equal to the default": [bool(torch.equal(a, b)) for a, b in
                                             zip(det, forward(model_a, "bfloat16", False))]}
        except RuntimeError as e:
            result["plain bf16 forward, deterministic algorithms"] = {
                "refused": str(e).splitlines()[0]}
        finally:
            torch.use_deterministic_algorithms(False)
        print("plain bf16 forward under use_deterministic_algorithms(True): "
              f"{json.dumps(result['plain bf16 forward, deterministic algorithms'])}",
              flush=True)
    if args.save:
        kept = {"weight " + k: v.detach().cpu() for k, v in model_a.state_dict().items()}
        for d in ("float32", "bfloat16"):
            for kernel in (False, True):
                for label, out in zip(("tr", "rot", "tor"), forward(model_a, d, kernel)):
                    kept[f"{label} {d} {'kernel' if kernel else 'plain'}"] = out.cpu()
        torch.save(kept, args.save)

    largest = {}

    def hook(name):
        def record(_module, _inputs, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            vals = [float(o.detach().float().abs().max()) for o in outs
                    if torch.is_tensor(o) and o.is_floating_point() and o.numel()]
            if vals:
                largest[name] = max(largest.get(name, 0.0), max(vals))
        return record

    hooks = [m.register_forward_hook(hook(n)) for n, m in model_a.named_modules() if n]
    forward(model_a, "bfloat16", False)
    for h in hooks:
        h.remove()
    result["largest |output| by module, plain bf16"] = sorted(
        largest.items(), key=lambda kv: -kv[1])[:12]
    print("largest |output| by module (plain bf16): "
          + json.dumps(result["largest |output| by module, plain bf16"]), flush=True)

    def numbers(model):
        """check_forward's numbers for tr, rot and tor, and whether each
        lies within its bound."""
        fwd = {(d, k): forward(model, d, k) for d in ("float32", "bfloat16") for k in (True, False)}
        rows = {}
        for i, label in enumerate(("tr", "rot", "tor")):
            b32, b16 = fwd["float32", False][i], fwd["bfloat16", False][i]
            scale = float(b32.abs().max().clamp_min(1e-30))
            rows[label] = {
                "f32 kernel-plain": float((fwd["float32", True][i] - b32).abs().max()) / scale,
                "bf16 kernel-plain": float((fwd["bfloat16", True][i] - b16).abs().max()) / scale,
                "plain f32-bf16": float((b32 - b16).abs().max()) / scale, "max|plain f32|": scale}
            r = rows[label]
            r["within"] = (r["f32 kernel-plain"] <= cs.TOL_FORWARD and r["bf16 kernel-plain"]
                           <= cs.TOL_BF16_GAP * r["plain f32-bf16"])
        return rows

    for name, model in (("a", model_a), ("b", model_b)):
        rows = numbers(model)
        result[f"check_forward, model {name}"] = rows
        print(f"check_forward's numbers, model {name}: {json.dumps(rows)}", flush=True)
    if args.moved_stats:
        moved_statistics(result, model_a, cfg_a, numbers, args.moved_stats)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
