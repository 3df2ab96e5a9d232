"""Training loop of the diffusion score model, from raw files or cached complexes.

With ``--train_csv`` (and ``--val_csv``), or ``--data_dir`` with
``--split_train`` (and ``--split_val``), it featurizes the records into
``PhoreDataset`` caches under ``--cache_path`` (``--num_dataloader_workers``
spawn processes; ``--phore_augment`` and ``--conf_augment`` add records with
random sub-phores and fresh conformers; ``--featurize_only`` fills the
caches and exits, on the host alone).  Without them it reads the featurized
``.npz`` complexes already under ``--cache_path`` (``train_*``
directories, and ``val_*`` for the validation loss).  It noises each batch
inside the train step, and runs on the GPU unless ``--device
cpu`` is given.  Per epoch it appends to ``<run_dir>/metrics.jsonl``, runs
the validation-loss epoch, steers the learning rate on plateaus and saves
``last_model.msgpack`` beside ``model_parameters.yml``; the run directory
loads with ``utils.checkpoints.load_model_dir``.  Every
``--val_inference_freq`` epochs it samples poses of the first
``--num_inference_complexes`` validation complexes with the EMA weights
(validation by inference), writes the ``valinf_*`` record and keeps the best
EMA weights by ``--inference_earlystop_metric`` in
``best_ema_inference_epoch_model.msgpack``.  Flag names are the JAX
package's.

    python -m diffphore_torch.cli.train --cache_path data/cache \\
        --run_dir runs/try1 --n_epochs 5 --batch_size 24 --val_inference_freq 1 \\
        --num_inference_complexes 20

The shipped corpus2 recipe from its SMILES CSVs, in its one (48, 160, 16)
bucket:

    python -m diffphore_torch.cli.train --config runs/corpus2/main/model_parameters.yml \\
        --train_csv runs/corpus2/train.csv --val_csv runs/corpus2/val.csv \\
        --bucket_a_min 48 --bucket_a_step 8 --bucket_p_min 160 --bucket_p_step 32 \\
        --bucket_t_min 16 --bucket_t_step 4 --run_dir runs/c2

With ``--rate_from_infer`` > 0 the epochs whose calibrated-branch
probability stands clear of its floor run the calibrated-conformation-sampler
step (``train.ccsampler``): a fine-tune from shipped weights that engages it
from the first epoch is

    python -m diffphore_torch.cli.train --cache_path data/cache \\
        --run_dir runs/cc1 --n_epochs 5 --batch_size 24 --val_inference_freq 0 \\
        --pretrain_model_pt runs/corpus2/main/best_ema_inference_epoch_model.msgpack \\
        --rate_from_infer 0.6 --epoch_from_infer 0 --dynamic_coeff 0

``--confidence_mode`` trains a confidence head instead (``train.confidence``):
per epoch a ``confidence`` record and, with a validation set, a
``confidence_val`` record; ``best_ema_inference_epoch_model.msgpack`` holds
the EMA weights of the best validation loss, and the run directory loads
with ``utils.checkpoints.load_confidence_dir``:

    python -m diffphore_torch.cli.train --confidence_mode --cache_path data/cache \\
        --run_dir runs/conf1 --n_epochs 5 --batch_size 24

With more than one visible card the score model trains data-parallel over
all of them, as the JAX trainer shards each batch over ``jax.devices()``:
one spawned process per card (``parallel.mesh.launch``), or the processes
``torchrun`` starts (``torchrun --nproc_per_node N -m
diffphore_torch.cli.train ...``; with ``--device cpu`` over gloo).  Every
rank loads the same global batch and trains on its rows of it
(the world size must divide ``--batch_size``); rank 0 alone writes the
run directory and validates by inference.  Ranks read the caches and
featurize nothing: the spawning process featurizes raw files before it
starts them; under ``torchrun`` run ``--featurize_only`` first.  A
confidence head trains on one device.

With ``--model_type tank`` it trains the TANKBind-style model instead
(``models/trioformer.py::TankPhore``, ``--tank_hidden_dim``,
``--tank_blocks``): distance-map regression (or contact classification with
``--contact_as_class``) plus affinity, on one device, with the same plateau
learning rate, EMA, ``last_model.msgpack`` and best-EMA checkpoint by the
validation loss; the run directory loads with
``utils.checkpoints.load_tank_dir``.

``--use_second_order_repr true`` trains the l = 2 model (the 8-lane
instantiations of the kernels); its ``model_parameters.yml`` carries the
flag, so ``FitEngine``, ``cli.inference`` and ``cli.evaluate`` serve it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import (CachedDataset, DatasetSettings, PhoreDataset, cache_directories,
                            records_from_csv, records_from_pdbbind_split, warmup_subset)
from ..data.loaders import BucketLoader
from ..device import resolve_device
from ..chem.rmsd import plain_rmsd
from ..models.score_model import ScoreModelConfig
from ..parallel import mesh
from ..sampler.sampling import SamplerSettings
from ..train.ccsampler import dynamic_schedule, make_ccsampler_train_step
from ..train.confidence import (LABEL_MODES, create_confidence_train_state,
                                make_confidence_eval_step, make_confidence_train_step)
from ..train.state import (create_train_state, ema_model, make_eval_step, make_train_step,
                           set_learning_rate)
from ..train.tank import create_tank_train_state, make_tank_eval_step, make_tank_train_step
from ..utils import checkpoints, flat_yaml
from ..utils.logging import AverageMeter, MetricsWriter, log_info
from .pipeline import FitEngine, job_from_cached

TRAIN_KEYS = ("loss", "tr_loss", "rot_loss", "tor_loss")
VAL_KEYS = TRAIN_KEYS + ("tr_base_loss", "rot_base_loss", "tor_base_loss")
CONFIDENCE_KEYS = ("loss", "loss_ph", "loss_ex", "loss_total")
TANK_KEYS = ("loss", "contact_loss", "affinity_loss")


def _str2bool(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # data
    p.add_argument("--config", type=str, default=None, help="flat YAML overriding any flag")
    p.add_argument("--train_csv", type=str, default=None)
    p.add_argument("--val_csv", type=str, default=None)
    p.add_argument("--data_dir", type=str, default=None, help="PDBbind-layout root")
    p.add_argument("--split_train", type=str, default=None)
    p.add_argument("--split_val", type=str, default=None)
    p.add_argument("--cache_path", type=str, default="data/cache",
                   help="holds the train_*/ and val_*/ directories of featurized .npz complexes")
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--num_dataloader_workers", type=int, default=1,
                   help="featurization processes (spawn); 1 featurizes in this process")
    p.add_argument("--featurize_only", action="store_true",
                   help="featurize and cache the datasets, then exit (needs no GPU)")
    p.add_argument("--ram_cache", default=True, action=argparse.BooleanOptionalAction,
                   help="keep loaded complexes resident in RAM")
    p.add_argument("--matching", action="store_true",
                   help="fit an embedded conformer's torsions to each true pose")
    p.add_argument("--ligand_only", action="store_true",
                   help="synthesize random phores from the ligands")
    p.add_argument("--phore_augment", type=int, default=0,
                   help="add K copies of each training record with a random ligand sub-phore")
    p.add_argument("--phore_augment_ex", type=int, default=2,
                   help="EX volumes per perceived feature of the augmented records' sub-phores")
    p.add_argument("--conf_augment", type=int, default=0,
                   help="add M copies of each training record whose true pose is a freshly "
                        "embedded conformer (with a ligand sub-phore)")
    p.add_argument("--max_lig_size", type=int, default=0)
    p.add_argument("--bucket_a_min", type=int, default=16, help="atom-count bucket floor")
    p.add_argument("--bucket_p_min", type=int, default=16, help="phore-point bucket floor")
    p.add_argument("--bucket_t_min", type=int, default=4, help="torsion bucket floor")
    p.add_argument("--bucket_a_step", type=int, default=8)
    p.add_argument("--bucket_p_step", type=int, default=16)
    p.add_argument("--bucket_t_step", type=int, default=4)
    p.add_argument("--min_phore_num", type=int, default=0)
    p.add_argument("--max_phore_num", type=int, default=0)
    p.add_argument("--matching_popsize", type=int, default=20)
    p.add_argument("--matching_maxiter", type=int, default=20)
    p.add_argument("--consider_ex", type=_str2bool, default=True)
    p.add_argument("--ex_connected", type=_str2bool, default=True)
    p.add_argument("--neighbor_cutoff", type=float, default=5.0)
    p.add_argument("--remove_hs", type=_str2bool, default=True)
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
    p.add_argument("--valid_warmup_propotion", type=float, default=0.03)
    p.add_argument("--valid_warmup_number", type=int, default=1000,
                   help="validation complexes sampled in warm-up epochs (0: the proportion)")
    # validation
    p.add_argument("--val_inference_freq", type=int, default=5,
                   help="validate by inference every N epochs (0 = off)")
    p.add_argument("--num_inference_complexes", type=int, default=100)
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--inference_samples", type=int, default=4)
    p.add_argument("--inference_earlystop_metric", type=str, default="valinf_rmsds_lt2")
    p.add_argument("--inference_earlystop_goal", type=str, default="max", choices=["max", "min"])
    p.add_argument("--early_stop_patience", type=int, default=0, help="0 = off")
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
    p.add_argument("--tank_hidden_dim", type=int, default=16)
    p.add_argument("--tank_blocks", type=int, default=8)
    p.add_argument("--no_affinity", action="store_true",
                   help="tank: drop the affinity MSE term")
    p.add_argument("--contact_as_class", action="store_true",
                   help="tank: BCE contact classification instead of distance regression")
    p.add_argument("--contact_weight", type=float, default=1.0)
    p.add_argument("--affinity_weight", type=float, default=0.01)
    p.add_argument("--pose_weight", type=float, default=5.0)
    # confidence head
    p.add_argument("--confidence_mode", action="store_true",
                   help="train a confidence head instead of the score model")
    p.add_argument("--confidence_dropout", type=float, default=0.0)
    p.add_argument("--confidence_no_batchnorm", action="store_true",
                   help="accepted for the JAX package's flag set; unused")
    p.add_argument("--confidence_label", type=str, default="rmsd_lt2", choices=LABEL_MODES,
                   help="rmsd_lt2: the logit of RMSD < 2 A of the noised pose; fitness: "
                        "regress the analytic fitness")
    p.add_argument("--by_total", action="store_true",
                   help="fitness labels: regress the total fitness instead of the ph/ex pair")
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


def dataset_settings(args) -> DatasetSettings:
    """The featurization settings of the data flags (their digest names the
    cache directories)."""
    return DatasetSettings(
        matching=args.matching, ligand_only=args.ligand_only,
        max_lig_size=args.max_lig_size, min_phore_num=args.min_phore_num,
        max_phore_num=args.max_phore_num, seed=args.seed,
        popsize=args.matching_popsize, maxiter=args.matching_maxiter,
        consider_ex=args.consider_ex, ex_connected=args.ex_connected,
        neighbor_cutoff=args.neighbor_cutoff, remove_hs=args.remove_hs,
        a_min=args.bucket_a_min, p_min=args.bucket_p_min, t_min=args.bucket_t_min,
        a_step=args.bucket_a_step, p_step=args.bucket_p_step, t_step=args.bucket_t_step,
    )


def augmented_records(records, args):
    """The records, then ``--phore_augment`` copies of each with a random
    sub-phore (``phore_seed`` j), then ``--conf_augment`` copies with a
    fresh conformer (``conf_seed`` j)."""
    out = list(records)
    for key, tag, n in (("phore_seed", "aug", args.phore_augment),
                        ("conf_seed", "conf", args.conf_augment)):
        out += [{**r, "name": f"{r['name']}~{tag}{j}", key: j,
                 "aug_num_ex": args.phore_augment_ex}
                for r in records for j in range(1, n + 1)]
    return out


def build_datasets(args, featurize: bool = True):
    """(train, val or None): ``PhoreDataset``s of --train_csv/--val_csv or
    of the --data_dir splits, else the cache directories under --cache_path.
    Without ``featurize`` (a rank of a data-parallel run) the records must
    be cached already: a rank waits for no featurization in a collective."""
    if args.train_csv or args.data_dir:
        if args.train_csv:
            train_records = records_from_csv(args.train_csv)
            val_records = records_from_csv(args.val_csv) if args.val_csv else []
        elif args.split_train:
            train_records = records_from_pdbbind_split(args.split_train, args.data_dir)
            val_records = (records_from_pdbbind_split(args.split_val, args.data_dir)
                           if args.split_val else [])
        else:
            raise SystemExit("Provide --train_csv or (--data_dir, --split_train)")
        if args.limit_complexes:
            train_records = train_records[: args.limit_complexes]
            val_records = val_records[: args.limit_complexes]
        settings = dataset_settings(args)
        train = PhoreDataset(augmented_records(train_records, args), settings, args.cache_path,
                             args.num_dataloader_workers, name="train", ram_cache=args.ram_cache,
                             featurize=featurize)
        val = (PhoreDataset(val_records, settings, args.cache_path, args.num_dataloader_workers,
                            name="val", ram_cache=args.ram_cache, featurize=featurize)
               if val_records else None)
        return train, val
    train_dirs = cache_directories(args.cache_path, "train")
    if not train_dirs:
        raise SystemExit(f"no train_*/ directory of cached complexes under `{args.cache_path}`; "
                         "give --train_csv or --data_dir to featurize raw files")
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


def val_inference(cfg, model, val_dataset, args, device,
                  max_complexes: Optional[int] = None) -> Dict[str, float]:
    """Sample ``--inference_samples`` poses of each of the first
    ``--num_inference_complexes`` (or ``max_complexes``) validation
    complexes with ``model`` in ``--inference_steps`` reverse steps, and
    score the top pose by fitness (PhScore1): the share of complexes whose
    top pose lies within 2 A (and 5 A) of the true pose (plain RMSD), the
    mean RMSD and fitness, and the share whose top pose puts an atom within
    1 A of an exclusion sphere's center.  Complexes without a true pose, and
    complexes whose sampling raises (logged), are left out."""
    engine = FitEngine(cfg, model, samples_per_complex=args.inference_samples,
                       settings=SamplerSettings(inference_steps=args.inference_steps),
                       seed=args.seed, device=str(device))
    n = min(len(val_dataset), max_complexes if max_complexes else args.num_inference_complexes)
    batches = [b for b in (val_dataset[i] for i in range(n)) if "orig_pos" in b.meta[0]]
    results = engine.run_complexes([job_from_cached(b) for b in batches], skip_failed=True)
    rmsds, fits, clashes = [], [], []
    for batch, res in zip(batches, results):
        if "error" in res:
            continue
        poses, fit = res["poses"], res["fitscore"]
        n_atoms = poses.shape[1]
        orig = np.asarray(batch.meta[0]["orig_pos"])[:n_atoms]
        best = int(np.argmax(fit))
        rmsds.append(plain_rmsd(poses[best], orig))
        fits.append(max(fit))
        ex_mask = ((batch.phoretype[0, :, -1] == 1) & batch.phore_mask[0]).numpy()
        if ex_mask.any():
            ex = batch.phore_pos[0].numpy()[ex_mask] + batch.orig_center[0].numpy()
            d = np.linalg.norm(poses[best][:, None, :] - ex[None, :, :], axis=-1)
            clashes.append(float(d.min() < 1.0))
    rmsds = np.asarray(rmsds) if rmsds else np.asarray([np.inf])
    return {
        "valinf_rmsds_lt2": float((rmsds < 2).mean()),
        "valinf_rmsds_lt5": float((rmsds < 5).mean()),
        "valinf_mean_rmsd": float(np.mean(rmsds)),
        "valinf_mean_fitscore": float(np.mean(fits)) if fits else -2.0,
        "valinf_clash_fraction": float(np.mean(clashes)) if clashes else 0.0,
        "valinf_n": len(rmsds),
    }


def val_inference_count(args, epoch: int, n_val: int) -> Optional[int]:
    """Validation complexes to sample at ``epoch``: fewer in warm-up epochs
    (``--valid_warmup_number``, or the ``--valid_warmup_propotion`` of the
    set when that is 0), else ``--num_inference_complexes`` (None)."""
    if epoch >= args.warmup_epochs:
        return None
    if args.valid_warmup_number > 0:
        return args.valid_warmup_number
    return max(1, int(args.valid_warmup_propotion * n_val))


def restart(args, state) -> bool:
    """Load ``--restart_dir``/``--model_ckpt`` into ``state`` when it exists,
    then set ``--restart_lr`` when it is positive; whether it loaded."""
    if not args.restart_dir:
        return False
    ckpt = os.path.join(args.restart_dir, args.model_ckpt)
    if not os.path.exists(ckpt):
        return False
    checkpoints.load_train_state(state, ckpt)
    log_info(f"Restarted from `{ckpt}`")
    if args.restart_lr > 0:
        set_learning_rate(state, args.restart_lr)
    return True


def save_last(args, state, epoch: int) -> None:
    """``last_model.msgpack`` every ``--ckpt_freq`` epochs and at the end."""
    if (epoch + 1) % max(args.ckpt_freq, 1) == 0 or epoch == args.n_epochs - 1:
        checkpoints.save_train_state(state, os.path.join(args.run_dir, checkpoints.LAST_MODEL))


class Plateau:
    """The best loss so far and the plateau decay of the learning rate: more
    than ``--scheduler_patience`` epochs without a new best multiply it by
    ``--lr_decay_factor``."""

    def __init__(self, args, state):
        self.patience, self.factor = args.scheduler_patience, args.lr_decay_factor
        self.lr = state.learning_rate
        self.best = np.inf
        self.rounds = 0

    def update(self, state, loss: float) -> bool:
        """Record an epoch's loss; whether it is a new best."""
        if loss < self.best - 1e-6:
            self.best, self.rounds = loss, 0
            return True
        self.rounds += 1
        if self.rounds > self.patience:
            self.lr *= self.factor
            set_learning_rate(state, self.lr)
            self.rounds = 0
            log_info(f"plateau: lr -> {self.lr:.2e}")
        return False


def train_confidence(args, device) -> None:
    """The ``--confidence_mode`` loop: noise each batch, label the noised
    poses by the analytic fitness (or RMSD < 2 A), regress them; validate on
    the EMA weights with the batch-statistics eval step, keep the best EMA
    weights, and steer the learning rate on plateaus."""
    cfg = model_config_from_args(args)
    train_ds, val_ds = build_datasets(args)
    if len(train_ds) == 0:
        raise SystemExit("Empty training dataset")
    loader = BucketLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed)
    state = create_confidence_train_state(cfg, args.confidence_dropout, seed=args.seed,
                                          lr=args.lr, weight_decay=args.w_decay,
                                          device=str(device))
    step_fn = make_confidence_train_step(cfg, args.ema_rate, args.by_total, args.confidence_label)
    eval_fn = make_confidence_eval_step(cfg, args.by_total, args.confidence_label)
    restart(args, state)
    checkpoints.save_config_yaml(cfg, args.run_dir, extra={
        "mode": "confidence", "n_epochs": args.n_epochs, "batch_size": args.batch_size,
        "lr": args.lr, "ema_rate": args.ema_rate, "by_total": args.by_total,
        "confidence_dropout": args.confidence_dropout,
        "confidence_label": args.confidence_label,
    })
    log_info(f"Training a confidence head on {device}: {len(train_ds)} complexes in "
             f"{len(loader)} batches of {args.batch_size}, labels {args.confidence_label}")
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    plateau = Plateau(args, state)
    val_loader = (BucketLoader(val_ds, args.batch_size, shuffle=False)
                  if val_ds is not None and len(val_ds) else None)
    keys = CONFIDENCE_KEYS

    with MetricsWriter(os.path.join(args.run_dir, "metrics.jsonl")) as metrics_out:
        for epoch in range(args.n_epochs):
            meter = AverageMeter(list(keys))
            t0 = time.time()
            steps = 0
            for batch in loader:
                state, m = step_fn(state, batch.replace(names=(), meta=()).to(device), generator)
                row = torch.stack([m[k] for k in keys]).cpu().numpy()  # one transfer
                meter.add(dict(zip(keys, row)))
                steps += 1
            summary = meter.summary()
            summary.update({"epoch": epoch, "lr": plateau.lr, "epoch_time": time.time() - t0,
                            "steps": steps, "mode": "confidence"})
            log_info(f"confidence epoch {epoch}: loss={summary.get('loss', float('nan')):.4f} "
                     f"ph={summary.get('loss_ph', 0):.4f} ex={summary.get('loss_ex', 0):.4f} "
                     f"({summary['epoch_time']:.1f}s)")
            metrics_out.write(summary)
            save_last(args, state, epoch)

            # the best and the plateau compare like with like: the train loss
            # without a validation set, the val loss on epochs where it ran
            val_loss = None if val_loader is not None else summary.get("loss", np.inf)
            if val_loader is not None and ((epoch + 1) % max(args.val_loss_freq, 1) == 0
                                           or epoch == args.n_epochs - 1):
                ema = ema_model(state)
                vmeter = AverageMeter(list(keys))
                for vb in val_loader:
                    vm = eval_fn(ema, vb.replace(names=(), meta=()).to(device), generator)
                    vmeter.add(dict(zip(keys, torch.stack([vm[k] for k in keys]).cpu().numpy())))
                vs = vmeter.summary()
                vs.update({"epoch": epoch, "mode": "confidence_val"})
                metrics_out.write(vs)
                val_loss = vs.get("loss", np.inf)
                log_info(f"confidence val: loss={val_loss:.4f}")
            if val_loss is not None and plateau.update(state, val_loss):
                checkpoints.save_ema_variables(
                    state, os.path.join(args.run_dir, checkpoints.BEST_EMA_MODEL))
    log_info("Confidence training finished.")


def batch_affinity(batch) -> torch.Tensor:
    """Per-graph affinity labels from the batch's metadata (0 where a record
    has none, as in every cache here)."""
    return torch.tensor([float(m.get("affinity", 0.0) or 0.0) for m in batch.meta],
                        dtype=torch.float32)


def train_tank(args, device) -> None:
    """The ``--model_type tank`` loop: distance-map (or contact) and
    affinity training; validation loss on the EMA weights, the best EMA
    weights kept, the learning rate steered on plateaus."""
    train_ds, val_ds = build_datasets(args)
    if len(train_ds) == 0:
        raise SystemExit("Empty training dataset")
    loader = BucketLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed)
    state = create_tank_train_state(args.tank_hidden_dim, args.tank_blocks, seed=args.seed,
                                    lr=args.lr, weight_decay=args.w_decay, device=str(device))
    terms = dict(consider_affinity=not args.no_affinity, pred_dis=not args.contact_as_class,
                 contact_weight=args.contact_weight, affinity_weight=args.affinity_weight,
                 pose_weight=args.pose_weight)
    step_fn = make_tank_train_step(args.ema_rate, **terms)
    eval_fn = make_tank_eval_step(**terms)
    restart(args, state)
    os.makedirs(args.run_dir, exist_ok=True)
    settings = {k: getattr(args, k) for k in (
        "model_type", "tank_hidden_dim", "tank_blocks", "no_affinity", "contact_as_class",
        "contact_weight", "affinity_weight", "pose_weight", "n_epochs", "batch_size", "lr",
        "ema_rate", "seed")}
    with open(os.path.join(args.run_dir, checkpoints.MODEL_PARAMS_YAML), "w") as f:
        f.write(flat_yaml.dumps(settings))
    log_info(f"Training the tank model on {device}: {len(train_ds)} complexes in "
             f"{len(loader)} batches of {args.batch_size}")
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    plateau = Plateau(args, state)
    val_loader = (BucketLoader(val_ds, args.batch_size, shuffle=False)
                  if val_ds is not None and len(val_ds) else None)

    with MetricsWriter(os.path.join(args.run_dir, "metrics.jsonl")) as metrics_out:
        for epoch in range(args.n_epochs):
            meter = AverageMeter(["loss", "grad_finite"])
            t0 = time.time()
            steps = 0
            for batch in loader:
                aff = batch_affinity(batch).to(device)
                state, m = step_fn(state, batch.replace(names=(), meta=()).to(device), aff,
                                   generator)
                row = torch.stack([m["loss"], m["grad_finite"]]).cpu().numpy()  # one transfer
                meter.add({"loss": row[0], "grad_finite": row[1]})
                steps += 1
            summary = meter.summary()
            summary.update({"epoch": epoch, "lr": plateau.lr, "epoch_time": time.time() - t0,
                            "steps": steps, "mode": "tank"})
            log_info(f"tank epoch {epoch}: loss={summary.get('loss', float('nan')):.4f} "
                     f"({summary['epoch_time']:.1f}s)")
            metrics_out.write(summary)
            save_last(args, state, epoch)

            val_loss = None if val_loader is not None else summary.get("loss", np.inf)
            if val_loader is not None and ((epoch + 1) % max(args.val_loss_freq, 1) == 0
                                           or epoch == args.n_epochs - 1):
                ema = ema_model(state)
                vmeter = AverageMeter(list(TANK_KEYS))
                for vb in val_loader:
                    vm = eval_fn(ema, vb.replace(names=(), meta=()).to(device),
                                 batch_affinity(vb).to(device))
                    vmeter.add(dict(zip(TANK_KEYS,
                                        torch.stack([vm[k] for k in TANK_KEYS]).cpu().numpy())))
                vs = vmeter.summary()
                vs.update({"epoch": epoch, "mode": "tank_val"})
                metrics_out.write(vs)
                val_loss = vs.get("loss", np.inf)
                log_info(f"tank val: loss={val_loss:.4f}")
            if val_loss is not None and plateau.update(state, val_loss):
                checkpoints.save_ema_variables(
                    state, os.path.join(args.run_dir, checkpoints.BEST_EMA_MODEL))
    log_info("Tank training finished.")


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.model_type == "tank" and args.confidence_mode:
        raise SystemExit("--confidence_mode is a diff-model training mode; "
                         "it cannot be combined with --model_type tank")
    os.makedirs(args.run_dir, exist_ok=True)
    rank, world = mesh.launched()
    if args.featurize_only:
        if rank == 0:                  # one process featurizes, on the host alone
            train_ds, val_ds = build_datasets(args)
            log_info(f"Featurize-only: train={len(train_ds)} "
                     f"val={len(val_ds) if val_ds else 0} complexes cached")
        return
    device = resolve_device(args.device)
    if args.model_type == "tank":
        # one device, as the JAX trainer leaves the tank step unsharded
        if rank == 0:
            train_tank(args, device)
        return
    if args.confidence_mode:
        # the head trains on one device, as the JAX trainer leaves it unsharded
        if rank == 0:
            train_confidence(args, device)
        return
    if world == 1:
        cards = torch.cuda.device_count() if device == torch.device("cuda") else 1
        if cards > 1:
            build_datasets(args)       # featurize here, before the ranks: they read the caches
            log_info(f"Training data-parallel over {cards} cards, one process each")
            mesh.launch(main, cards, sys.argv[1:] if argv is None else list(argv))
        else:
            train(args, device)
        return
    shard, device = mesh.init_process_group(device.type)
    try:
        train(args, device, shard)
    finally:
        mesh.destroy_process_group()


def train(args, device, shard: Optional[mesh.DataShard] = None) -> None:
    """The score model's training loop on ``device``; with a ``shard`` as
    one rank of a data-parallel run (rank 0 writes the run directory)."""
    main_rank = shard is None or shard.rank == 0
    if shard is not None and args.batch_size % shard.world:
        raise SystemExit("batch_size must divide the device count")
    cfg = model_config_from_args(args)
    train_ds, val_ds = build_datasets(args, featurize=shard is None)
    if len(train_ds) == 0:
        raise SystemExit("Empty training dataset")
    has_val = val_ds is not None and len(val_ds) > 0
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
                              args.tor_weight, reject=args.reject, shard=shard)
    cc_step_fn = None
    if args.rate_from_infer > 0:
        cc_step_fn = make_ccsampler_train_step(cfg, args.ema_rate, args.tr_weight,
                                               args.rot_weight, args.tor_weight, args.delta_t,
                                               shard=shard)
    # The sigmoid schedule is positive from epoch 0, but the calibrated step
    # runs a second forward for every row: it engages only above a floor,
    # relative to the configured rate so that a small rate still engages once
    # the schedule reaches half its plateau.
    cc_floor = min(0.01, args.rate_from_infer / 2.0)
    log_info(f"Training on {device}: {len(train_ds)} complexes in {len(loader)} batches of "
             f"{args.batch_size}; convs compute in {cfg.compute_dtype}"
             + ("" if shard is None else f"; rank {shard.rank} of {shard.world}"))

    if args.pretrain_model_pt:
        if not os.path.exists(args.pretrain_model_pt):
            raise SystemExit(f"--pretrain_model_pt `{args.pretrain_model_pt}` not found")
        checkpoints.load_train_state(state, args.pretrain_model_pt, weights_only=True)
        log_info(f"Initialized from pretrained `{args.pretrain_model_pt}` "
                 f"(fresh optimizer, epoch 0)")

    start_epoch = state.step // max(len(loader), 1) if restart(args, state) else 0

    if main_rank:
        checkpoints.save_config_yaml(cfg, args.run_dir, extra={
            "n_epochs": args.n_epochs, "batch_size": args.batch_size, "lr": args.lr,
            "ema_rate": args.ema_rate, "inference_steps": args.inference_steps,
            "rate_from_infer": args.rate_from_infer, "epoch_from_infer": args.epoch_from_infer,
            "dynamic_coeff": args.dynamic_coeff, "phore_augment": args.phore_augment,
            "phore_augment_ex": args.phore_augment_ex, "conf_augment": args.conf_augment,
        })
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed + start_epoch)
    plateau = Plateau(args, state)
    best_metric = -np.inf if args.inference_earlystop_goal == "max" else np.inf
    best_rmsd = np.inf
    es_rounds = 0          # val-inference rounds without improvement of the metric
    eval_step = val_loader = None

    with MetricsWriter(os.path.join(args.run_dir, "metrics.jsonl") if main_rank
                       else None) as metrics_out:
        for epoch in range(start_epoch, args.n_epochs):
            profiler: Optional[torch.profiler.profile] = None
            if args.profile_dir and epoch == start_epoch and main_rank:
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
            summary.update({"epoch": epoch, "lr": plateau.lr, "epoch_time": time.time() - t0,
                            "steps": steps, "p_from_infer": p_cc if use_cc else 0.0})
            log_info(f"epoch {epoch}: loss={summary.get('loss', float('nan')):.4f} "
                     f"tr={summary.get('tr_loss', 0):.3f} rot={summary.get('rot_loss', 0):.3f} "
                     f"tor={summary.get('tor_loss', 0):.3f} ({summary['epoch_time']:.1f}s)")
            metrics_out.write(summary)

            val_summary = None
            if has_val and (epoch + 1) % max(args.val_loss_freq, 1) == 0:
                if eval_step is None:
                    eval_step = make_eval_step(cfg, args.tr_weight, args.rot_weight,
                                               args.tor_weight, shard=shard)
                    val_loader = BucketLoader(val_ds, args.batch_size, shuffle=False)
                val_summary = val_loss_epoch(eval_step, state.model, val_loader, generator,
                                             device, max(args.test_sigma_intervals, 0))
                val_summary.update({"epoch": epoch, "mode": "val"})
                metrics_out.write(val_summary)
                log_info(f"val loss: {val_summary.get('loss', float('nan')):.4f}")

            # plateau LR control on the val loss (the train loss without a val set)
            plateau.update(state, (val_summary or summary).get("loss", np.inf))
            if main_rank:
                save_last(args, state, epoch)

            if has_val and args.val_inference_freq and (epoch + 1) % args.val_inference_freq == 0:
                vm = None
                if main_rank:      # the other ranks wait for its metrics
                    vm = val_inference(cfg, ema_model(state), val_ds, args, device,
                                       val_inference_count(args, epoch, len(val_ds)))
                vm = mesh.broadcast_object(vm)
                vm["epoch"] = epoch
                metrics_out.write(vm)
                log_info(f"val inference: {vm}")
                metric = vm.get(args.inference_earlystop_metric, 0.0)
                better = (metric > best_metric if args.inference_earlystop_goal == "max"
                          else metric < best_metric)
                # with few val complexes the share metrics tie often: a tie
                # goes to the lower mean RMSD, else the best would freeze at
                # the first tying epoch
                mean_rmsd = vm.get("valinf_mean_rmsd", np.inf)
                if metric == best_metric and mean_rmsd < best_rmsd:
                    better = True
                if better:
                    best_metric, best_rmsd, es_rounds = metric, mean_rmsd, 0
                    if main_rank:
                        checkpoints.save_ema_variables(
                            state, os.path.join(args.run_dir, checkpoints.BEST_EMA_MODEL))
                    log_info(f"new best {args.inference_earlystop_metric}={metric:.4f}; "
                             f"saved {checkpoints.BEST_EMA_MODEL}")
                else:
                    es_rounds += 1
                    if args.early_stop_patience and es_rounds >= args.early_stop_patience:
                        log_info(f"early stop: {args.inference_earlystop_metric} did not "
                                 f"improve for {es_rounds} val-inference rounds")
                        break
    log_info("Training finished.")


if __name__ == "__main__":
    main()
