"""Training loop of the diffusion score model, over cached complexes.

Reads the featurized ``.npz`` complexes under ``--cache_path``
(``train_*`` directories, and ``val_*`` for the validation loss), noises
each batch inside the train step, and runs on the GPU unless ``--device
cpu`` is given.  Per epoch it appends to ``<run_dir>/metrics.jsonl``, runs
the validation-loss epoch, steers the learning rate on plateaus and saves
``last_model.msgpack`` beside ``model_parameters.yml``; the run directory
loads with ``utils.checkpoints.load_model_dir``.  Flag names are the JAX
package's.

    python -m diffphore_torch.cli.train --cache_path data/cache \\
        --run_dir runs/try1 --n_epochs 5 --batch_size 24 --val_inference_freq 0

With ``--rate_from_infer`` > 0 the epochs whose calibrated-branch
probability stands clear of its floor run the calibrated-conformation-sampler
step (``train.ccsampler``): a fine-tune from shipped weights that engages it
from the first epoch is

    python -m diffphore_torch.cli.train --cache_path data/cache \\
        --run_dir runs/cc1 --n_epochs 5 --batch_size 24 --val_inference_freq 0 \\
        --pretrain_model_pt runs/corpus2/main/best_ema_inference_epoch_model.msgpack \\
        --rate_from_infer 0.6 --epoch_from_infer 0 --dynamic_coeff 0

Not part of the port yet, and refused with a message that says so: datasets
from raw files, validation by inference, the tank baseline and the
confidence head.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.dataset import CachedDataset, cache_directories, warmup_subset
from ..data.loaders import BucketLoader
from ..device import resolve_device
from ..models.score_model import ScoreModelConfig
from ..train.ccsampler import dynamic_schedule, make_ccsampler_train_step
from ..train.state import create_train_state, make_eval_step, make_train_step, set_learning_rate
from ..utils import checkpoints, flat_yaml
from ..utils.logging import AverageMeter, MetricsWriter, log_info

TRAIN_KEYS = ("loss", "tr_loss", "rot_loss", "tor_loss")
VAL_KEYS = TRAIN_KEYS + ("tr_base_loss", "rot_base_loss", "tor_base_loss")

#: flags of parts that are not ported: (flag, its off value, the slice that brings it)
_FEATURIZATION = "the host featurization slice (chem/, data/dataset.py from raw files)"
NOT_PORTED = (
    ("train_csv", None, _FEATURIZATION), ("val_csv", None, _FEATURIZATION),
    ("data_dir", None, _FEATURIZATION), ("split_train", None, _FEATURIZATION),
    ("split_val", None, _FEATURIZATION), ("featurize_only", False, _FEATURIZATION),
    ("matching", False, _FEATURIZATION), ("ligand_only", False, _FEATURIZATION),
    ("phore_augment", 0, _FEATURIZATION), ("conf_augment", 0, _FEATURIZATION),
    ("model_type", "diff", "the variants slice (train/tank.py)"),
    ("confidence_mode", False, "the confidence-head slice (models/confidence.py)"),
)


def _str2bool(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # data
    p.add_argument("--config", type=str, default=None, help="flat YAML overriding any flag")
    p.add_argument("--cache_path", type=str, default="data/cache",
                   help="holds train_*/ and val_*/ directories of featurized .npz complexes")
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--ram_cache", default=True, action=argparse.BooleanOptionalAction,
                   help="keep loaded complexes resident in RAM")
    for flag in ("train_csv", "val_csv", "data_dir", "split_train", "split_val"):
        p.add_argument(f"--{flag}", type=str, default=None, help="not ported yet")
    p.add_argument("--featurize_only", action="store_true", help="not ported yet")
    p.add_argument("--matching", action="store_true", help="not ported yet")
    p.add_argument("--ligand_only", action="store_true", help="not ported yet")
    p.add_argument("--phore_augment", type=int, default=0, help="not ported yet")
    p.add_argument("--conf_augment", type=int, default=0, help="not ported yet")
    # optimization
    p.add_argument("--n_epochs", type=int, default=800)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--w_decay", type=float, default=0.0)
    p.add_argument("--scheduler_patience", type=int, default=40)
    p.add_argument("--lr_decay_factor", type=float, default=0.9)
    p.add_argument("--ema_rate", type=float, default=0.999)
    p.add_argument("--tr_weight", type=float, default=0.33)
    p.add_argument("--rot_weight", type=float, default=0.33)
    p.add_argument("--tor_weight", type=float, default=0.33)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup_epochs", type=int, default=0,
                   help="epochs to warm up training with fewer samples")
    p.add_argument("--warmup_propotion", type=float, default=0.03)
    p.add_argument("--warmup_number", type=int, default=20000)
    # validation
    p.add_argument("--val_inference_freq", type=int, default=5,
                   help="validation by inference is not ported yet: pass 0 with a val set")
    p.add_argument("--test_sigma_intervals", type=int, default=0,
                   help="val loss bucketed into this many t intervals (0 = off)")
    p.add_argument("--val_loss_freq", type=int, default=1,
                   help="run the val-loss epoch every N epochs")
    # noise curriculum
    p.add_argument("--reject", action="store_true",
                   help="curriculum rejection sampling of noise draws")
    p.add_argument("--reject_rate", type=float, default=0.3,
                   help="the reject probability grows to this over training")
    # calibrated conformation sampler
    p.add_argument("--rate_from_infer", type=float, default=0.0,
                   help="(plateau) probability of the calibrated branch per graph; 0 = off")
    p.add_argument("--epoch_from_infer", type=int, default=300,
                   help="first epoch of the calibrated branch (the schedule's u with "
                        "--dynamic_coeff)")
    p.add_argument("--dynamic_coeff", type=float, default=0.0,
                   help="> 0: the probability follows the sigmoid dynamic schedule")
    p.add_argument("--delta_t", type=float, default=0.05,
                   help="the time the model's reverse step covers")
    # io / restart
    p.add_argument("--run_dir", type=str, default="runs/diffphore_torch")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; required unless given) or cpu")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the first training epoch")
    p.add_argument("--restart_dir", type=str, default=None)
    p.add_argument("--pretrain_model_pt", type=str, default=None,
                   help="msgpack checkpoint (the port's or the JAX package's) to initialize "
                        "params/EMA/batch stats from, with a fresh optimizer and epoch counter")
    p.add_argument("--restart_lr", type=float, default=0.0,
                   help="override the learning rate after a restart (0 = keep)")
    p.add_argument("--model_ckpt", type=str, default=checkpoints.LAST_MODEL)
    p.add_argument("--ckpt_freq", type=int, default=1,
                   help="save last_model every N epochs; the final epoch always saves")
    # model (ScoreModelConfig fields override defaults)
    p.add_argument("--ns", type=int, default=20)
    p.add_argument("--nv", type=int, default=10)
    p.add_argument("--num_conv_layers", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--no_torsion", action="store_true")
    p.add_argument("--no_batch_norm", action="store_true")
    p.add_argument("--sigma_embed_dim", type=int, default=20)
    p.add_argument("--distance_embed_dim", type=int, default=20)
    p.add_argument("--cross_distance_embed_dim", type=int, default=20)
    p.add_argument("--tr_sigma_min", type=float, default=0.1)
    p.add_argument("--tr_sigma_max", type=float, default=5.0)
    p.add_argument("--rot_sigma_min", type=float, default=0.1)
    p.add_argument("--rot_sigma_max", type=float, default=1.5)
    p.add_argument("--tor_sigma_min", type=float, default=0.0314)
    p.add_argument("--tor_sigma_max", type=float, default=3.14)
    p.add_argument("--embedding_type", type=str, default="sinusoidal",
                   choices=["sinusoidal", "fourier"])
    p.add_argument("--embedding_scale", type=float, default=10000)
    p.add_argument("--consider_norm", type=_str2bool, default=True)
    p.add_argument("--angle_match", type=_str2bool, default=True)
    p.add_argument("--phoretype_match", type=_str2bool, default=True)
    p.add_argument("--use_phore_match_feat", type=_str2bool, default=True)
    p.add_argument("--cross_distance_transition", type=_str2bool, default=True)
    p.add_argument("--phore_direction_transition", type=_str2bool, default=True)
    p.add_argument("--phoretype_match_transition", type=_str2bool, default=True)
    p.add_argument("--atom_weight", type=str, default="phore",
                   choices=["phore", "atomwise", "sigmoid", "softmax"])
    p.add_argument("--scaler", type=float, default=100.0)
    p.add_argument("--multiple", type=_str2bool, default=True)
    p.add_argument("--boarder", type=_str2bool, default=True)
    p.add_argument("--by_radius", type=_str2bool, default=False)
    p.add_argument("--clash_tolerance", type=float, default=0.4)
    p.add_argument("--auto_phorefp", type=_str2bool, default=False)
    p.add_argument("--use_att", type=_str2bool, default=False)
    p.add_argument("--trioformer_layer", type=int, default=1)
    p.add_argument("--use_second_order_repr", type=_str2bool, default=False)
    p.add_argument("--scale_by_sigma", type=_str2bool, default=True)
    p.add_argument("--max_radius", type=float, default=5.0)
    p.add_argument("--cross_max_distance", type=float, default=25.0)
    p.add_argument("--center_max_distance", type=float, default=30.0)
    p.add_argument("--tp_mode", type=str, default="channelwise",
                   choices=["channelwise", "fully_connected"])
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="the convs' edge MLP and aggregate operands (bf16 as the JAX "
                        "package computes them, or float32)")
    p.add_argument("--model_type", type=str, default="diff", choices=["diff", "tank"])
    p.add_argument("--confidence_mode", action="store_true", help="not ported yet")
    args = p.parse_args(argv)
    if args.config:
        for k, v in flat_yaml.load(args.config).items():
            if hasattr(args, k):
                setattr(args, k, v)
    return args


def model_config_from_args(args) -> ScoreModelConfig:
    names = {f.name for f in dataclasses.fields(ScoreModelConfig)}
    kw = {k: v for k, v in vars(args).items() if k in names}
    if isinstance(kw.get("clash_cutoff"), list):
        kw["clash_cutoff"] = tuple(kw["clash_cutoff"])
    return ScoreModelConfig(**kw)


def refuse_unported(args) -> None:
    for flag, off, brings in NOT_PORTED:
        if getattr(args, flag) != off:
            raise NotImplementedError(
                f"--{flag} is not part of the PyTorch port yet; it comes with {brings}")


def cc_probability(args, epoch: int) -> float:
    """The calibrated branch's probability per graph at ``epoch``: the
    sigmoid schedule with --dynamic_coeff > 0, else --rate_from_infer from
    --epoch_from_infer on."""
    if args.rate_from_infer <= 0:
        return 0.0
    if args.dynamic_coeff > 0:
        return dynamic_schedule(epoch, args.rate_from_infer, args.epoch_from_infer,
                                args.dynamic_coeff)
    return args.rate_from_infer if epoch >= args.epoch_from_infer else 0.0


def build_datasets(args):
    """(train, val or None) over the cache directories under --cache_path."""
    train_dirs = cache_directories(args.cache_path, "train")
    if not train_dirs:
        raise SystemExit(f"no train_*/ directory of cached complexes under `{args.cache_path}`; "
                         "featurizing raw files is not part of the port yet")
    train = CachedDataset(train_dirs, args.limit_complexes, args.ram_cache)
    val_dirs = cache_directories(args.cache_path, "val")
    val = CachedDataset(val_dirs, args.limit_complexes, args.ram_cache) if val_dirs else None
    return train, val


def val_loss_epoch(eval_step, model, val_loader, generator, device, n_intervals: int):
    """Per-graph validation losses averaged over the real (not repeat-padded)
    rows, overall and per sigma interval."""
    meter = AverageMeter(list(VAL_KEYS))
    for vb in val_loader:
        valid = vb.valid.numpy()
        vm = eval_step(model, vb.replace(names=(), meta=()).to(device), generator)
        table = torch.stack([vm[k] for k in VAL_KEYS] + [vm["t"]]).cpu().numpy()  # one transfer
        for g in np.nonzero(valid)[0]:
            vals = dict(zip(VAL_KEYS, table[:-1, g]))
            meter.add(vals)
            if n_intervals > 1:
                meter.add(vals, interval_idx=int(round(float(table[-1, g]) * (n_intervals - 1))))
    return meter.summary()


def main(argv=None) -> None:
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    os.makedirs(args.run_dir, exist_ok=True)

    cfg = model_config_from_args(args)
    train_ds, val_ds = build_datasets(args)
    if len(train_ds) == 0:
        raise SystemExit("Empty training dataset")
    has_val = val_ds is not None and len(val_ds) > 0
    if has_val and args.val_inference_freq:
        raise NotImplementedError(
            "--val_inference_freq > 0 with a validation set is not part of the PyTorch port yet "
            "(it comes with the evaluation slice: train/metrics.py, RMSD); pass "
            "--val_inference_freq 0")
    loader = BucketLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed)
    warm_loader = None
    if args.warmup_epochs > 0:
        warm = warmup_subset(train_ds, args.warmup_number, args.warmup_propotion, args.seed)
        if warm is not train_ds:
            warm_loader = BucketLoader(warm, args.batch_size, shuffle=True, seed=args.seed)
            log_info(f"Warmup: first {args.warmup_epochs} epochs on "
                     f"{len(warm)}/{len(train_ds)} samples")

    state = create_train_state(cfg, seed=args.seed, lr=args.lr, weight_decay=args.w_decay,
                               device=str(device))
    step_fn = make_train_step(cfg, args.ema_rate, args.tr_weight, args.rot_weight,
                              args.tor_weight, reject=args.reject)
    cc_step_fn = None
    if args.rate_from_infer > 0:
        cc_step_fn = make_ccsampler_train_step(cfg, args.ema_rate, args.tr_weight,
                                               args.rot_weight, args.tor_weight, args.delta_t)
    # The sigmoid schedule is positive from epoch 0, but the calibrated step
    # runs a second forward for every row: it engages only above a floor,
    # relative to the configured rate so that a small rate still engages once
    # the schedule reaches half its plateau.
    cc_floor = min(0.01, args.rate_from_infer / 2.0)
    log_info(f"Training on {device}: {len(train_ds)} complexes in {len(loader)} batches of "
             f"{args.batch_size}; convs compute in {cfg.compute_dtype}")

    if args.pretrain_model_pt:
        if not os.path.exists(args.pretrain_model_pt):
            raise SystemExit(f"--pretrain_model_pt `{args.pretrain_model_pt}` not found")
        checkpoints.load_train_state(state, args.pretrain_model_pt, weights_only=True)
        log_info(f"Initialized from pretrained `{args.pretrain_model_pt}` "
                 f"(fresh optimizer, epoch 0)")

    start_epoch = 0
    if args.restart_dir:
        ckpt = os.path.join(args.restart_dir, args.model_ckpt)
        if os.path.exists(ckpt):
            checkpoints.load_train_state(state, ckpt)
            start_epoch = state.step // max(len(loader), 1)
            log_info(f"Restarted from `{ckpt}` at epoch {start_epoch}")
            if args.restart_lr > 0:
                set_learning_rate(state, args.restart_lr)

    checkpoints.save_config_yaml(cfg, args.run_dir, extra={
        "n_epochs": args.n_epochs, "batch_size": args.batch_size, "lr": args.lr,
        "ema_rate": args.ema_rate, "rate_from_infer": args.rate_from_infer,
        "epoch_from_infer": args.epoch_from_infer, "dynamic_coeff": args.dynamic_coeff,
    })
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed + start_epoch)
    best_val_loss = np.inf
    plateau = 0
    lr = state.learning_rate if args.restart_dir else args.lr
    eval_step = val_loader = None
    last_model = os.path.join(args.run_dir, checkpoints.LAST_MODEL)

    with MetricsWriter(os.path.join(args.run_dir, "metrics.jsonl")) as metrics_out:
        for epoch in range(start_epoch, args.n_epochs):
            profiler: Optional[torch.profiler.profile] = None
            if args.profile_dir and epoch == start_epoch:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
            p_cc = cc_probability(args, epoch)
            use_cc = cc_step_fn is not None and p_cc > cc_floor
            keys = TRAIN_KEYS + (("grad_finite", "cc_share") if use_cc else ("grad_finite",))
            meter = AverageMeter(list(keys))
            t0 = time.time()
            # noise-rejection curriculum: the probability grows linearly over training
            rp = args.reject_rate * epoch / max(args.n_epochs, 1) if args.reject else 0.0
            epoch_loader = (warm_loader if warm_loader is not None and epoch < args.warmup_epochs
                            else loader)
            steps = 0
            with profiler if profiler is not None else contextlib.nullcontext():
                for batch in epoch_loader:
                    clean = batch.replace(names=(), meta=()).to(device)
                    if use_cc:
                        state, m = cc_step_fn(state, clean, generator, p_cc)
                    else:
                        state, m = step_fn(state, clean, generator, rp)
                    row = torch.stack([m[k] for k in keys]).cpu().numpy()  # one transfer
                    meter.add(dict(zip(keys, row)))
                    steps += 1
            if profiler is not None:
                os.makedirs(args.profile_dir, exist_ok=True)
                trace = os.path.join(args.profile_dir, "train_epoch_trace.json")
                profiler.export_chrome_trace(trace)
                log_info(f"torch.profiler trace written to {trace}")
            summary = meter.summary()
            summary.update({"epoch": epoch, "lr": lr, "epoch_time": time.time() - t0,
                            "steps": steps, "p_from_infer": p_cc if use_cc else 0.0})
            log_info(f"epoch {epoch}: loss={summary.get('loss', float('nan')):.4f} "
                     f"tr={summary.get('tr_loss', 0):.3f} rot={summary.get('rot_loss', 0):.3f} "
                     f"tor={summary.get('tor_loss', 0):.3f} ({summary['epoch_time']:.1f}s)")
            metrics_out.write(summary)

            val_summary = None
            if has_val and (epoch + 1) % max(args.val_loss_freq, 1) == 0:
                if eval_step is None:
                    eval_step = make_eval_step(cfg, args.tr_weight, args.rot_weight,
                                               args.tor_weight)
                    val_loader = BucketLoader(val_ds, args.batch_size, shuffle=False)
                val_summary = val_loss_epoch(eval_step, state.model, val_loader, generator,
                                             device, max(args.test_sigma_intervals, 0))
                val_summary.update({"epoch": epoch, "mode": "val"})
                metrics_out.write(val_summary)
                log_info(f"val loss: {val_summary.get('loss', float('nan')):.4f}")

            # plateau LR control on the val loss (the train loss without a val set)
            cur = (val_summary or summary).get("loss", np.inf)
            if cur < best_val_loss - 1e-6:
                best_val_loss = cur
                plateau = 0
            else:
                plateau += 1
                if plateau > args.scheduler_patience:
                    lr *= args.lr_decay_factor
                    set_learning_rate(state, lr)
                    plateau = 0
                    log_info(f"plateau: lr -> {lr:.2e}")

            if (epoch + 1) % max(args.ckpt_freq, 1) == 0 or epoch == args.n_epochs - 1:
                checkpoints.save_train_state(state, last_model)
    log_info("Training finished.")


if __name__ == "__main__":
    main()
