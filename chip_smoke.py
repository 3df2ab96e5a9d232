#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``diffphore_torch``) on one GPU.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --second_order_only   # phases 1, 2 and 16 (~2 min)
    python3 chip_smoke.py --knn_only            # phases 1, 2 and 17
    python3 chip_smoke.py --host_modules_only   # phases 1, 2 and 18
    python3 chip_smoke.py --widths_only         # phases 1, 2 and 19

Phases, each fatal on failure:
  1. card: require CUDA; print the card's name and power limit; full-f32
     matmuls and convolutions (no TF32).
  2. build: compile every CUDA kernel of the port from ``diffphore_torch/csrc``
     with nvcc for sm_90a (one nvcc per source, all at once).
  3. kernel check: capture the inputs of all 23 tensor-product convs of one
     forward of the main path (corpus2 model, 40 poses of a 24x96x8
     complex), hold K1 (``tp_fused``) against its plain PyTorch version on
     them, in f32 and in bf16 (the JAX package's bf16 convolution, which the
     shipped config's ``compute_dtype`` asks for: the kernel against the
     plain version on the same bf16 inputs), require two runs to agree to the bit,
     print each conv's grid and what bounds it, and time the kernel (on the
     card, by replaying a CUDA graph of its calls, and per call from Python)
     and the plain version.  A grid of fewer blocks than the card has SMs
     fails unless the conv runs within twice the launch floor.  One forward
     of the model, kernel convs against plain convs, at f32 and at bf16.
  4. main path, at the shipped bf16: ``FitEngine`` samples 8 cached complexes x 40 poses x 20
     reverse-diffusion steps with the corpus2 checkpoint and ranks them by
     fitness; K1 must launch exactly 23 x 20 times per dispatch; poses and
     scores must be finite; one complex is sampled again with the plain
     convs and the same noise, and one forward is compared.
     Then the other sampler modes on one complex: the ODE, and
     ``random_samples = 4`` with the fitness as selector.
  5. K2 and K3 check: capture the aggregate calls of the 23 convs of one
     training-mode forward at the shipped bf16 (corpus2 weights, 24
     complexes of the 24x96x8 bucket, noised): 17 convs on K2
     (``tp_aggregate``), the 6 layer-0 convs on K3 (``tp_scalar``), two paths
     each.  Hold every forward and backward kernel (K2: dw + dsh per edge, dx
     per sender; K3: forward, edge backward (dw + dsh) and dx per conv)
     against the plain versions and autograd through them, on the captured
     operands in f32 and in bf16, require two runs to agree to the bit (dw is
     held from both edge backwards, with and without dsh), time kernels
     (graph replay) in both types, plain, and the per-path einsum calls that
     compute the same functions (graph replay), print the grid
     and the split of the summed axis of K2's and K3's forward and dx for
     each conv, and each edge backward with dsh beside its norm twin's (dw
     only, same shapes).
  6. training path: (c) one train step with the kernels against the same
     step with the plain convs, same noise and dropout masks: at f32 the loss
     and every parameter gradient, at the shipped bf16 the loss and the
     gradient as one vector against the plain route's own f32-vs-bf16
     difference; (b) 30 steps at bf16 on one fixed batch with fixed noise and
     dropout on: the loss falls; per step K2 launches 17 forward + 17 + 17
     backward, K3 6 forward + 6 edge backward + 6 dx, and K1 none; (a)
     ``diffphore_torch.cli.train.main``: fresh corpus2-width model, batch 24,
     one epoch over 240 cached complexes (10 steps), one validation-loss
     epoch over 20 (K1, 23 launches), finite metrics, a checkpoint that
     reloads.
  7. calibrated-sampler path: (c) one step of the calibrated-conformation
     sampler's train step with the kernels against the same step with the
     plain convs, same draws: from fresh weights the loss and every gradient
     leaf (f32) and the gradient as one vector (bf16, as in 6), from the
     shipped weights the frozen stage and the loss (f32); (a) a bf16
     fine-tune through
     ``cli.train.main`` with ``--rate_from_infer 0.6 --epoch_from_infer 0``:
     one epoch over the same 240 complexes; per step K1 launches 23 times
     (the frozen reverse step), K2 and K3 as in 6; finite losses, the share
     of graphs on the calibrated branch near 0.6 P(t > 0.05).
  8. serving with the shipped confidence head (``runs/corpus2/confidence``,
     bf16): the 8 complexes of phase 4 through ``FitEngine`` without and with
     the head (poses/s of each); K1 exactly 23 x 20 + 21 times per dispatch
     with it; a finite confidence row that ``rank`` follows; the head on the
     final poses of one complex, kernel convs against plain convs (f32, and
     bf16 against the plain route's own f32-vs-bf16 difference).
  9. the head's training path: K2 and K3 held as in 5 on the 15 + 6 conv
     calls of one training-mode forward of the shipped head; (c) one head
     train step from fresh weights with the kernels against the plain convs,
     as in 6; (b) 30 fixed-batch steps, the loss falls, K2 15 + 15 + 15 and K3
     6 + 6 + 6 per step; (a) one epoch of ``cli.train.main --confidence_mode``
     over the 240 complexes plus a validation batch (K1 21 launches, batch
     statistics), a best-EMA checkpoint that reloads.
  10. validation by inference: one epoch of ``cli.train.main
     --val_inference_freq 1`` (one train step, then 4 validation complexes x 8
     poses x 20 steps on the EMA weights): K1 exactly 4 x 23 x 20 launches, a
     finite ``valinf_*`` record, the validation's wall time.
  11. the screening CLI from files: ``diffphore_torch.cli.inference.main``
     with the corpus2 checkpoint (bf16) on six rows (examples/task.csv's
     three SDFs, a drug-size SMILES embedded on the host, a MOL2 written here,
     an unparsable SMILES; featurized inline, ``--prefetch_workers 0``):
     five complexes x 40 poses x 20 steps, the sixth
     logged and skipped; K1 exactly 5 x 23 x 20 launches and no K2 or K3; the
     artifact set (ranked_results.csv, inference_results.json, 40 ranked poses
     and a 40 x 19 .score file per complex); each ranked pose re-scored on the
     card against the phore file within 1e-3 of its .score fitness, bond
     lengths kept within 1e-3 A; the six rows through the CLI's engine with
     featurization inline (as the CLI does it) and on two threads ahead of
     the dispatches, in turns, each timed end to end; K1 against its plain version on the 23 conv inputs of one
     forward of the SMILES job (32 atoms) and of an SDF job (16 atoms), conv
     by conv and the whole forward, at f32 and bf16, as in phase 3; a
     resumed run samples nothing and leaves the table byte for byte; with
     the confidence head K1 5 x (23 x 20 + 21) launches and a descending
     confidence property.  Prints featurization ms per complex and its share
     of run_time, dispatch ms, poses/s, the walls inline and with threads
     and the engine's phase timers.
  12. training and evaluation from raw files, in the shipped recipe's
     (48, 160, 16) bucket: ``cli.train.main`` with the corpus2 config on
     the first two flexible rows of runs/corpus2/train.csv and one of
     val.csv, ``--phore_augment 1 --conf_augment 1``, the recipe's bucket
     flags and 4 featurization processes, two epochs of one step: the
     featurized count, K2 17 x 3 and K3 6 x 3 per step and K1 23 per
     validation batch, exactly; K2 and K3 held as in 5 on one training-mode
     forward of a recipe batch (24 rows, repeat-padded); three timed steps
     at the bucket (peak memory); the trainer again on the same CSVs
     featurizes nothing; the same train records into a fresh cache by one
     process, the files the 4 processes wrote; one record of each kind (SDF, SMILES, sub-phore, conformer)
     featurized serially; ``cli.evaluate.main`` on three rows of
     test.csv and EX01.sdf with the corpus2 model and head, 40 poses x 20
     steps, ``--use_symmetry_rmsd true``: K1 exactly 481 launches per
     evaluated complex, the artifact set, finite metrics; K1 against its
     plain version on the 23 conv inputs of one forward at the bucket, as
     in 11.  Prints featurization ms per complex (serial and with the
     workers, and the one process's wall), dispatch and RMSD ms per complex.
  13. scale-out on the one card: a bf16 train step of phase 5's batch over
     NCCL at world size 1, bit-equal to the step without a process group;
     the same step over two gloo ranks sharing the card (12 rows each,
     spawned), against one process from the same seed within TOL_BF16_GAP,
     replicas equal, K2 17 x 3 and K3 6 x 3 launches on each rank (phase 12
     runs it at the recipe's bucket too, and times K1 over one evaluation
     forward there); 12 SDF complexes through one ``cli.inference`` process
     and through two striped ones at once, then rank 0's merge; phase 11's
     six rows through ``main()`` with 0, then 2 featurization processes,
     the artifact sets equal but for ``run_time``, K1 exact.  Prints the
     walls, each process's start-up (launch to first dispatch) and poses/s
     over the wall and over the dispatch window the CLI logs.
  15. the model-family variants (run before the report): ``cli.train.main``
     with the corpus2 config and ``--use_att true --trioformer_layer 1``
     (bf16, corpus2 width) for two epochs of one step over 24 cached
     complexes, with a validation batch: K2 17 x 3 and K3 6 x 3 a step and
     K1 23 a validation batch, exactly; K2 and K3 held as in 5 on one
     use_att training-mode forward; a step's wall, busy time and peak memory.
     That run directory served by ``FitEngine`` (phase 4's 8 complexes x 40
     poses x 20 steps, K1 exactly 460 a dispatch, a re-sample with the plain
     convs), K1 held as in 3 on one use_att forward's 23 conv calls and the
     forward against the plain convs, one complex through
     ``cli.inference.main`` (the artifact set). ``cli.train.main --model_type
     tank`` (hidden 16, 8 blocks) for two epochs on the same caches: finite
     losses, ``last_model.msgpack``'s EMA reloaded to the trainer's
     validation loss, poses recovered from its distance maps for EX01 and
     EX02 at example.phore. A fresh fully connected model: one dispatch of
     one complex x 40 x 20 and one train step of 24. A fresh Fourier model's
     forward on the card against the CPU (f32, batch statistics). The oracle
     score driving the reverse SDE on the card for 4 complexes x 8 poses:
     the poses recovered, and the same chain on the CPU. The tank, fully
     connected and oracle paths launch no kernel.
  16. l = 2 features (``use_second_order_repr``, run before the report):
     ``runs/second_order_probe`` (corpus2's width, written by the JAX package
     with analysis/write_second_order_probe.py) through ``load_model_dir``,
     its kernel-path f32 forward held against its JAX reference at TOL_F32 of
     max|JAX| (and of max(max|JAX|, 1), the reference tests' scale) and
     against the plain convs on the card at TOL_F32 of scale;
     K1's 8-lane kernel held as in 3 on the 23 conv calls of one 40-pose
     forward, and K2's and K3's as in 5 on the 17 + 6 training convs; a
     train step, kernels against plain convs from fresh weights (the loss,
     and the gradient as one vector: at bf16 as in 6, at f32 within
     TOL_STEP_GRAD of its norm), its wall, busy time and peak memory; ``FitEngine``
     serving the probe on phase 4's 8 complexes x 40 x 20 (K1 exactly 460
     a dispatch, poses/s); ``cli.train.main --use_second_order_repr true``
     (bf16, corpus2 width) for two steps of 24 and a validation batch (K2
     17 x 3 and K3 6 x 3 a step, K1 23, exactly; the checkpoint reloads).
     The 4-lane kernels launch no time there.
  17. the KNN phore grid (``phore_knn``, run before the report) on the
     kernels' sender-index mode: (a) K1's sender-index mode held against its
     plain version (f32 and bf16, reruns bit-equal) on the 3 phore conv calls
     of one 40-pose forward of corpus2 at K = 24, on a complex whose phore
     graph K = 24 compacts, and K2's (forward, dw, dx) and K3's on the phore
     conv calls of one training-mode forward of the 24-complex batch, each
     timed (graph replay) beside its plain version, the gathered per-path
     einsums and its bound; the same at 8 lanes on the second-order probe's
     weights at K = 24; (b) serving at bf16 from a model directory with
     phore_knn: 24: the probe's f32 forward within TOL_F32 of max|JAX| of
     runs/knn_probe/reference.npz, K = 40 within TOL_F32 of the dense model,
     ``cli.inference.main`` on one SDF row of examples/task.csv and
     ``FitEngine`` on phase 4's 8 complexes x 40 x 20 in turns with the
     dense model, each turn half the complexes (K1 exactly 400 dense + 60 sender-index launches a KNN
     dispatch; poses/s of each beside phase 4's); (c) a
     train step at K = 24, kernels against plain convs (f32 leaf by leaf,
     bf16 as one vector), K2 15 + 2 and K3 5 + 1 launches of each kernel, its
     wall, busy time and peak memory; the 8-lane model's dispatch (K1 400 +
     60) and train step (K2 15 + 2, K3 5 + 1 at 8 lanes).  Every earlier
     phase holds the sender-index counts at 0.
  18. the host-only modules (run before the report): (a) ``python -m
     diffphore_torch.data.synth_library --n 24``: 24 distinct rows, each
     parsed and embedded to finite coordinates, host ms per ligand; (b) the
     corpus2 recipe's phase A on it (``cli.train.main --ligand_only``, the
     recipe's bucket flags, batch 24, one epoch, 4 featurization processes,
     runs/corpus2/val6.csv, corpus2 width at bf16): every row featurized (the
     few past the bucket caps skipped, as the recipe skips them), K2 17 x 3
     and K3 6 x 3 a step and K1 23 a validation batch, exactly, finite
     losses, a checkpoint that reloads, a step's wall, busy time and peak
     memory; (c) the AncPhore CLI compiled by ``utils/ancphore_bridge`` into
     build/ancphore (timed; native/ byte for byte unchanged), the three SDF
     rows of examples/task.csv through ``cli.inference.main`` (K1 exactly 3 x
     460), each complex's 40 ranked poses scored by the CLI
     (``calc_phore_fitting``, return_all, fitness 1-6, custom coefficients)
     and by ``ops.fitscore`` on the card, written as a .score file: V_ref,
     V_overlap, match %, V_exOverlap, anchor %, ov_pct, ex_pct and PhScore1-4
     (raw and calibrated) within one unit of the sixth significant digit
     where the two perceive the same ligand features (equal V_db: EX01 and
     EX02), column -6 under custom coefficients against the repaired
     ``fitscore``; V_db and the fishing score, and EX03 (the CLI perceives
     its features otherwise), reported; (d) the baseline drivers on the same
     files (run_phore align, screen with EX01 labelled 1, fishing over two
     copies of example.phore; performance_analyze over (c)'s ranked poses;
     run_docking without vina and run_ifptarget without IFPTarget skipped
     cleanly), each driver's wall.
  19. model widths past corpus2's (run before the report), from fresh
     weights at bf16, 4 conv layers, at ns / nv = 32 / 16 (l <= 1: the
     4-lane K1's wide kernel) and 48 / 10 (l = 2: the 8-lane wide K1, K2
     past 384 channels, K3's edge backward at 36 units): K1 held against
     its plain version on the 23 conv calls of one 40-pose forward (f32 and
     bf16, reruns bit-equal, each timed once) and the forward against the
     plain convs; K2 and K3 held on the 17 + 6 conv calls of one
     training-mode forward (phase 5's check); one train step of 24 (K2 17 x
     3, K3 6 x 3 exactly), its wall and busy time; one dispatch of one
     complex x 40 poses x 20 steps (K1 exactly 460), its poses/s, and a
     dispatch of 2 steps traced (busy time on the card, K1's part); a
     ``widths`` summary line.
  14. report: the kernels' JSON line (each kernel's launches per path, phase
     18's as ``launches_synthetic_pretrain`` and ``launches_host_modules_screen``, and
     its errors and times at the recipe's bucket; the 8-lane kernels' as
     ``*_l2`` entries, the sender-index mode's as ``*_idx`` and
     ``*_idx_l2``), the card line, and the result line.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
TRAIN_CACHE_DIR = os.path.join(HERE, "data", "cache", "train_f1112e7d33")
TRAIN_BATCH = 24            # corpus2's batch size
TRAIN_COMPLEXES = 240       # one epoch of the CLI run: 10 steps
VAL_COMPLEXES = 20          # one validation batch (repeat-padded to 24)
FIXED_BATCH_STEPS = 30

# K1 against its plain version: |kernel - plain| <= TOL * max|plain|.
# f32 inputs: both compute in f32 and differ only in summation order.
TOL_F32 = 1e-4
# bf16 inputs: kernel and plain version both compute the JAX package's bf16
# convolution (8-bit mantissas) and differ where an f32 sum taken in another
# order flips a bf16 rounding of the edge MLP.
TOL_BF16 = 3e-2
# One forward of the score model, kernel convs against plain convs.
TOL_FORWARD = 1e-3
# 20 chained steps, kernel convs against plain convs, same noise: median
# pose RMSD (A).  Rounding differences may flip a step function of the cross
# graph for a pose, so the median, not the max, is held.
TOL_RERUN_RMSD = 0.1

# K2's kernels against the plain version and autograd through it, f32 on both
# sides: |kernel - plain| <= TOL * max|plain| for the output and each gradient.
TOL_K2 = 1e-4
# One train step, kernels against plain convs, same draws: per parameter leaf
# |grad - plain grad| <= TOL_STEP_GRAD * max|plain grad of the leaf|
# + TOL_STEP_FLOOR * max|plain grad over all leaves|.  The floor is for the
# two transition MLPs that only rescale the cross-graph edge vector, which
# the harmonics normalize away: their true gradient is zero and both sides
# hold rounding noise there.
TOL_STEP_GRAD = 1e-3
TOL_STEP_FLOOR = 5e-6
# K3's kernels against the einsum and autograd through it, f32 on both sides,
# as K2: they differ by summation order only.
TOL_K3 = 1e-4
# K2 and K3 on bf16 operands against the plain version on the same bf16
# operands: the outputs (f32) differ by f32 summation order only; a gradient,
# stored in bf16, may sit one bf16 rounding step away where the two f32 sums
# fall on two sides of a rounding boundary: |kernel - plain| <= BF16_STEP *
# |plain| + TOL_BF16_FLOOR * max|plain|, element by element.
TOL_BF16_OUT = 1e-5
BF16_STEP = 2.0 ** -7
TOL_BF16_FLOOR = 1e-6
# A forward or a train step at bf16, kernel convs against plain convs, same
# draws: at most this share of the plain route's own f32-vs-bf16 difference
# (the forward's outputs elementwise, a step's gradient as one vector).  At
# these sizes the kernels' f32 sums, taken in another order than cuBLAS's,
# flip some of the millions of bf16 roundings of each conv's edge MLP (up to
# 7e-4 of a conv's scale on an H100, the kernel check above), and 23 convs
# carry that to the outputs (0.16-0.43 of the difference there).  A kernel
# that skipped the bf16 roundings would stand at the whole difference.
TOL_BF16_GAP = 0.5

# Per train step: 17 convs run K2 (forward, edge backward, sender backward),
# the 6 layer-0 convs run K3: a forward, an edge backward and a dx per conv,
# the edge backward with dsh on the 2 cross-graph convs whose edge vectors
# carry learned weights (phore_to_lig_conv_0, lig_to_phore_conv_0).
K2_CONVS = 17
K3_CONVS = 6
K3_DSH_CONVS = 2
# The KNN phore grid (phore_knn): the 3 phore convs (phore_conv_0, 1, 2) run
# the kernels' sender-index mode, K3's for the layer-0 one and K2's for the
# other two in training; the other 20 convs stay dense.
KNN_CONVS = 3
# The confidence head (runs/corpus2/confidence): the score model's encoder, so
# 21 convs a forward (12 ligand-receiver + 9 phore-receiver), of which K2
# takes 15 in training and K3 the same 6 layer-0 convs; trained here with the
# shipped head's label.
CONFIDENCE_DIR = os.path.join(HERE, "runs", "corpus2", "confidence")
HEAD_CONVS = 21
HEAD_K2_CONVS = 15
HEAD_LABEL = "rmsd_lt2"
# Validation by inference in the training CLI: a few complexes, a few poses.
VALINF_COMPLEXES = 4
VALINF_POSES = 8
CC_RATE = 0.6               # --rate_from_infer of the shipped recipe
CC_DELTA_T = 0.05
# The frozen stage of a calibrated step from the shipped weights, K1 against
# the plain convs: the stepped and rebuilt poses (A) and the targets (relative
# to their scale) differ by f32 rounding carried through one pose update and
# two Kabsch alignments.
TOL_CC_POS = 1e-4
TOL_CC_TARGET = 1e-4
# Share of graphs on the calibrated branch over one epoch of 240: binomial
# around CC_RATE * P(t > delta_t) = 0.57 with sigma 0.032; four sigma.
CC_SHARE_BAND = 0.13
# random_samples = 4 against 1 on 40 poses of one complex: the median fitness
# of 40 poses spreads by a few hundredths between noise draws.
TOL_CANDIDATE_MEDIAN = 0.1

# H100 SXM peaks (NVIDIA data sheet, 700 W, dense): HBM bytes/s, f32 (non
# tensor-core) operations/s and bf16 tensor-core operations/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
SMS = 132                   # streaming multiprocessors of an H100


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """ms per call of ``fn``, launched from Python one call after the other:
    the larger of the card's time and the host's time to make a call."""
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


def device_ms(fn, iters: int, replays: int = 3) -> float:
    """ms of the card's own time per call of ``fn`` (a kernel wrapper): the
    calls are captured once into a CUDA graph and the graph is replayed, so
    the host's time to make a call (tens of microseconds through Python and
    ctypes, more than many of these kernels run) is not in the reading."""
    import torch

    fn()                                    # builds, sets attributes, fills caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def out_lanes(tp):
    """Floats of one receiver's result that the function defines: each
    path's 2 l_out + 1 components for each of its channels (the kernels'
    padding lanes not counted)."""
    return sum(p.mul_in * (2 * p.l_out + 1) for p in tp.paths)


def k1_work(tp, x, sh, attrs, masks, w1, w2, idx=None):
    """(bytes, matrix-product operations, other operations) the fused
    function needs on these inputs: each input read once and the output's
    defined lanes written once; the edge MLP's two products (bf16 tensor-core
    work where the operands are bf16), then its bias, relu and mask terms and
    the tensor product (vector work), counted on edges with a mask set.  A
    sender index ``idx`` (the sender-index mode) is read once too, and the
    node-level products count per row of x."""
    import numpy as np

    B, N, M, S = sh.shape
    E, H = w1.shape
    F = tp.weight_numel
    nbytes = (x.numel() * x.element_size() + sh.numel() * sh.element_size()
              + (0 if idx is None else idx.numel() * idx.element_size())
              + sum(a.numel() * a.element_size() for a in attrs)
              + sum(m.numel() * m.element_size() for m in masks)
              + 4 * (E * H + H + H * F + F) + 4 * B * N * out_lanes(tp))
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
    mm_ops = live_c * 2 * E * H + live * 2 * H * F
    vec_ops = live_c * 3 * H + live * (2 * F + tp_ops) + B * x.shape[1] * node_ops
    return nbytes, float(np.float64(mm_ops)), float(np.float64(vec_ops))


def posed_rows(one, n, cfg, gen):
    """A B = 1 complex as n rows at prior poses and t = 0.5."""
    import torch

    from diffphore_torch.data.graphs import repeat_batch
    from diffphore_torch.sampler.sampling import draw_prior, randomize_position

    batch = repeat_batch(one, n)
    batch = randomize_position(batch, draw_prior(n, batch.num_torsions, gen, one.device),
                               tr_sigma_max=cfg.tr_sigma_max)
    return batch.replace(t=torch.full((n,), 0.5, device=one.device))


def digest(tensors) -> str:
    """The first 16 hex digits of a SHA-256 over the bytes of ``tensors`` (a
    model's state, or a batch's tensors), in order: equal digests, equal
    bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def check_forward(model, batch, compute_dtype, poses=POSES, what="forward"):
    """One forward, kernel convs against plain convs: at f32 within
    TOL_FORWARD of the plain output's scale, at bf16 within TOL_BF16_GAP of
    the plain route's own f32-vs-bf16 difference."""
    import torch

    from diffphore_torch.models.layers import DenseTPConv, set_compute_dtype

    convs = [m for m in model.modules() if isinstance(m, DenseTPConv)]
    fwd = {}
    with torch.inference_mode():
        for dtype in ("float32", "bfloat16"):
            set_compute_dtype(model, dtype)
            for use_kernel in (True, False):
                for m in convs:
                    m.use_kernel = use_kernel
                fwd[dtype, use_kernel] = model(batch, pose_group=poses)
    for m in convs:
        m.use_kernel = True
    set_compute_dtype(model, compute_dtype)
    faults = []
    for i, label in enumerate(("tr", "rot", "tor")):
        b32, b16 = fwd["float32", False][i], fwd["bfloat16", False][i]
        scale = float(b32.abs().max().clamp_min(1e-30))
        rel = float((fwd["float32", True][i] - b32).abs().max()) / scale
        rel_bf = float((fwd["bfloat16", True][i] - b16).abs().max()) / scale
        gap = float((b32 - b16).abs().max()) / scale
        print(f"{what} {label}: max |kernel - plain| / max|plain| = {rel:.2e} (f32), "
              f"{rel_bf:.2e} (bf16; the plain route's f32-vs-bf16 difference {gap:.2e})",
              flush=True)
        if not rel <= TOL_FORWARD:
            faults.append(f"{what} {label} differs: {rel} > {TOL_FORWARD}")
        if not rel_bf <= TOL_BF16_GAP * gap:
            faults.append(f"bf16 {what} {label} differs: {rel_bf} > {TOL_BF16_GAP} * {gap}")
    if faults:
        raise AssertionError("; ".join(faults))


def capture_conv_calls(model, batch, poses=POSES):
    """(name, module, args) of every conv call of one eval forward."""
    import torch

    from diffphore_torch.models.layers import DenseTPConv

    calls = []
    hooks = []
    for name, mod in model.named_modules():
        if isinstance(mod, DenseTPConv):
            hooks.append(mod.register_forward_hook(
                lambda m, args, out, name=name: calls.append((name, m, args))))
    with torch.inference_mode():
        model(batch, pose_group=poses)
    for h in hooks:
        h.remove()
    if len(calls) != CONVS_PER_FORWARD:
        raise RuntimeError(f"captured {len(calls)} conv calls, expected {CONVS_PER_FORWARD}")
    return calls


def check_k1_call(tp_fused, name, mod, args):
    """K1 against its plain version on one conv call's inputs, at f32 and
    at bf16: two runs bit-equal, each within TOL_F32 / TOL_BF16 of the plain
    output's largest element.  Returns the f32 operands, the bf16 ones and
    the outputs and errors."""
    import torch

    sender, edge_attr, edge_sh, edge_mask, *_ = args
    f32, bf16 = torch.float32, torch.bfloat16
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
        again = tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params)
        low = (x.to(bf16), sh.to(bf16), [a.to(bf16) for a in attrs])
        ref_bf = tp_fused.tp_aggregate_fused_plain(tp, *low, masks, *params)
        got_bf = tp_fused.tp_aggregate_fused(tp, *low, masks, *params)
        again_bf = tp_fused.tp_aggregate_fused(tp, *low, masks, *params)
        torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(got_bf, again_bf)):
        raise AssertionError(f"{name}: two runs of tp_fused on the same inputs differ")
    scale, scale_bf = float(ref.abs().max()), float(ref_bf.abs().max())
    err = float((got - ref).abs().max())
    err_bf = float((got_bf - ref_bf).abs().max())
    if not (err <= TOL_F32 * max(scale, 1e-30)):
        raise AssertionError(f"{name}: f32 |kernel - plain| {err} > {TOL_F32} * {scale}")
    if not (err_bf <= TOL_BF16 * max(scale_bf, 1e-30)):
        raise AssertionError(f"{name}: bf16 |kernel - plain| {err_bf} > {TOL_BF16} * "
                             f"{scale_bf}")
    return {"tp": tp, "x": x, "sh": sh, "attrs": attrs, "masks": masks, "params": params,
            "low": low, "got_bf": got_bf, "ref_bf": ref_bf, "err": err, "scale": scale,
            "err_bf": err_bf, "scale_bf": scale_bf}


def phase_kernel_check(model, batch, tp_fused):
    """Capture every conv call of one forward and hold K1 against its plain
    version on those inputs; time each call."""
    import torch

    calls = capture_conv_calls(model, batch)
    (floor_one, call_one), (floor_ms, call_two) = k1_launch_floor(tp_fused, model)
    print(f"  launch floor of a tp_fused call with nothing to do: on the card {floor_one:.4f} ms "
          f"with one kernel, {floor_ms:.4f} ms with the sender split's second kernel; per call "
          f"from Python {call_one:.4f} and {call_two:.4f} ms", flush=True)
    cases = []
    for name, mod, args in calls:
        c = check_k1_call(tp_fused, name, mod, args)
        tp, x, sh, attrs, masks, params, low = (c[k] for k in (
            "tp", "x", "sh", "attrs", "masks", "params", "low"))
        err, err_bf, scale, scale_bf = c["err"], c["err_bf"], c["scale"], c["scale_bf"]
        got_bf, ref_bf = c["got_bf"], c["ref_bf"]
        with torch.inference_mode():
            call = lambda: tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params)
            ms = device_ms(call, 20)
            ms_bf = device_ms(lambda: tp_fused.tp_aggregate_fused(tp, *low, masks, *params), 20)
            # the plain version on the CPU, whose f32 sums are exact to f32
            # rounding: how far the kernel and cuBLAS's bf16 products each
            # stand from it (reported, not held)
            cpu = tp_fused.tp_aggregate_fused_plain(
                tp, low[0].cpu(), low[1].cpu(), [a.cpu() for a in low[2]],
                [m.cpu() for m in masks], *(t.cpu() for t in params))
            err_cpu = float((got_bf.cpu() - cpu).abs().max()) / max(scale_bf, 1e-30)
            err_plain_cpu = float((ref_bf.cpu() - cpu).abs().max()) / max(scale_bf, 1e-30)
            call_ms = cuda_ms(call, 20)
            plain_ms = cuda_ms(
                lambda: tp_fused.tp_aggregate_fused_plain(tp, x, sh, attrs, masks, *params), 5)
        nbytes, mm_ops, vec_ops = k1_work(tp, x, sh, attrs, masks, params[0], params[2])
        ops = mm_ops + vec_ops
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        # bf16: the edge MLP's products at the tensor cores' rate, the rest at
        # the vector rate, the two units working at once
        nbytes_bf, _, _ = k1_work(tp, low[0], low[1], low[2], masks, params[0], params[2])
        t_ops_bf = max(mm_ops / PEAK_BF16, vec_ops / PEAK_F32) * 1e3
        bound_bf = max(nbytes_bf / PEAK_BYTES * 1e3, t_ops_bf)
        B, N, M, _ = sh.shape
        l2 = tp_fused.lanes(tp) == tp_fused.K_PAD_L2
        if l2:
            per_block, splits, channel_tiles, blocks = tp_fused.grid_l2(tp, B, N, M)
        else:
            per_block, splits = tp_fused.plan_senders(B, N, M)
            channel_tiles, blocks = 1, B * -(-N // tp_fused.TILE_N) * splits
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        if blocks < SMS and not ms <= 2 * floor_ms:
            raise AssertionError(f"{name}: grid of {blocks} blocks on {SMS} SMs and {ms} ms, over "
                                 f"twice the launch floor {floor_ms} ms")
        cases.append({
            "conv": name, "B": B, "N": N, "M": M, "C": len(attrs), "E": params[0].shape[0],
            "blocks": blocks, "senders_per_block": per_block, "splits": splits,
            "channel_tiles": channel_tiles,
            "H": params[0].shape[1], "F": tp.weight_numel, "max_abs_err": err,
            "max_abs_err_bf16": err_bf, "max_rel_err_bf16": err_bf / max(scale_bf, 1e-30),
            "rel_err_bf16_vs_cpu": err_cpu, "plain_rel_err_bf16_vs_cpu": err_plain_cpu,
            "max_abs_ref": scale, "ms": ms, "ms_bf16": ms_bf, "bound_ms_bf16": bound_bf,
            "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": bound_by,
            "bytes": nbytes, "f32_ops": ops, "mlp_product_ops": mm_ops,
        })
        print(f"  {name:28s} B={B:2d} N={N:3d} M={M:3d} C={len(attrs)} F={tp.weight_numel:3d} "
              f"grid {blocks:4d} blocks ({splits} x {per_block} senders, {channel_tiles} "
              f"channel tile{'s' if channel_tiles > 1 else ''}) "
              f"err={err:.2e} bf16_err={err_bf:.2e} (max|ref| {scale:.2e}; against the plain "
              f"version on the CPU, of scale: kernel {err_cpu:.1e}, plain {err_plain_cpu:.1e}) "
              f"reruns bit-equal  "
              f"kernel {ms:.4f} ms on the card (bf16 {ms_bf:.4f}, bound {bound_bf:.4f}), "
              f"{call_ms:.4f} ms per call from Python  "
              f"plain {plain_ms:.4f} ms  bound {max(t_bytes, t_ops):.4f} ms "
              f"({bound_by}: bytes {t_bytes:.4f}, operations {t_ops:.4f})", flush=True)
    return cases


def k1_launch_floor(tp_fused, model):
    """ms of a K1 call that has next to nothing to do (one batch row, one
    receiver, four senders, every edge dead): what a call costs before any
    work, its two launches included when the senders are split."""
    import torch

    from diffphore_torch.models.layers import DenseTPConv

    mod = next(m for m in model.modules() if isinstance(m, DenseTPConv))
    tp, E = mod.tp, mod.fc_w1.shape[0]
    params = (mod.fc_w1.detach(), mod.fc_b1.detach(), mod.fc_w2.detach(), mod.fc_b2.detach())
    floors = []
    for M in (4, 24):                   # one split, and six splits + the second kernel
        x = torch.zeros((1, M, tp.irreps_in.dim), device="cuda")
        sh = torch.zeros((1, 1, M, tp.irreps_sh.dim), device="cuda")
        attr = torch.zeros((1, 1, M, E), device="cuda")
        mask = torch.zeros((1, 1, M), dtype=torch.bool, device="cuda")
        with torch.inference_mode():
            call = lambda: tp_fused.tp_aggregate_fused(tp, x, sh, [attr], [mask], *params)
            floors.append((device_ms(call, 50), cuda_ms(call, 50)))
    return floors


def bucket_complexes(cache_dir, n):
    """The first n cached complexes of BUCKET in a cache directory."""
    from diffphore_torch.data.graphs import load_cached

    out = []
    for f in sorted(glob.glob(os.path.join(cache_dir, "*.npz"))):
        b = load_cached(f)
        if (b.num_atoms, b.num_phore, b.num_torsions) == BUCKET:
            out.append((f, b))
        if len(out) == n:
            return out
    raise RuntimeError(f"found {len(out)} of {n} complexes of bucket {BUCKET} in {cache_dir}")


def k2_work(tp, x, sh, w, with_dsh, idx=None):
    """{kernel: (bytes, f32 operations)} that K2's three kernels need on
    these inputs: each operand read once, each result written once (x, sh,
    w and their gradients at their element size, the output and the
    upstream gradient f32, at their defined lanes: ``out_lanes``); products
    with an edge weight counted on edges whose weights are not all zero, dw
    on every edge (it is defined where w is masked too).  A sender index
    ``idx`` is read once by each kernel; edges are its (receiver, slot)
    pairs, and node-level products count per row of x (M_x of them)."""
    B, N, M, S = sh.shape                            # M senders, or slots with an index
    M_x = x.shape[1]                                 # rows of x: node-level work
    idx_b = 0 if idx is None else idx.numel() * idx.element_size()
    edges = B * N * M
    live = int((w != 0).any(-1).sum())
    node = contract = dw_ops = dsh_ops = dx_ops = 0
    for p in tp.paths:
        d1, d2, d3 = 2 * p.l_in + 1, 2 * p.l_sh + 1, 2 * p.l_out + 1
        node += p.mul_in * 2 * d1 * d2 * d3          # cg with x (or with g), per node
        contract += p.mul_in * 2 * (d2 * d3 + d3)    # forward, per edge
        dw_ops += p.mul_in * 2 * (d2 * d3 + d2)
        dsh_ops += p.mul_in * 2 * d2
        dx_ops += p.mul_in * 2 * (d1 * d2 + d1)
    out_b = g_b = 4 * B * N * out_lanes(tp)
    x_b, sh_b, w_b = (t.numel() * t.element_size() for t in (x, sh, w))
    dx_b, dsh_b, dw_b = x_b, sh_b, w_b               # gradients, written once
    return {
        "fwd": (x_b + sh_b + w_b + out_b + idx_b, live * contract + B * M_x * node),
        "bwd_edge": (x_b + sh_b + g_b + dw_b + idx_b + (w_b + dsh_b if with_dsh else 0),
                     edges * dw_ops + B * M_x * node + (live * dsh_ops if with_dsh else 0)),
        "bwd_x": (sh_b + w_b + g_b + dx_b + idx_b, live * dx_ops + B * N * node),
    }


def capture_training_convs(model, batch, k2_convs=K2_CONVS):
    """The aggregate calls of one training-mode forward of ``model`` (the
    score model, whose convs K2 takes K2_CONVS of, or the confidence head,
    HEAD_K2_CONVS): (name, tp, x, sh, w, sh needs grad, sender index or
    None) of every K2 call and of every K3 (conv-level) call.  The model's
    buffers (running statistics) are left as they were."""
    import torch

    from diffphore_torch.models.layers import DenseTPConv
    from diffphore_torch.ops import tp_aggregate, tp_scalar

    names, k2_calls, k3_calls = [], [], []
    hooks = [mod.register_forward_pre_hook(lambda m, args, name=name: names.append(name))
             for name, mod in model.named_modules() if isinstance(mod, DenseTPConv)]
    originals = (tp_aggregate.tp_aggregate, tp_scalar.scalar_paths_aggregate)

    def recorder(calls, original):
        def record(tp, x, sh, w, sender_index=None):
            calls.append((names[-1], tp, x.detach(), sh.detach(), w.detach(), sh.requires_grad,
                          sender_index))
            return original(tp, x, sh, w, sender_index=sender_index)
        return record

    tp_aggregate.tp_aggregate = recorder(k2_calls, originals[0])
    tp_scalar.scalar_paths_aggregate = recorder(k3_calls, originals[1])
    # a training-mode forward moves the batch norms' running statistics, with
    # dropout masks from the process's global generator (whatever earlier
    # phases drew): the model's buffers are put back as they were
    kept = [(buf, buf.detach().clone()) for buf in model.buffers()]
    try:
        model.train()
        out = model(batch)
    finally:
        tp_aggregate.tp_aggregate, tp_scalar.scalar_paths_aggregate = originals
        for h in hooks:
            h.remove()
        model.eval()
        with torch.no_grad():
            for buf, was in kept:
                buf.copy_(was)
    if not all(bool(torch.isfinite(o).all()) for o in out):
        raise AssertionError("training-mode forward is not finite")
    if (len(k2_calls), len(k3_calls)) != (k2_convs, K3_CONVS) or len(names) != k2_convs + K3_CONVS:
        raise RuntimeError(f"captured {len(k2_calls)} K2 calls and {len(k3_calls)} K3 calls of "
                           f"{len(names)} convs, expected {k2_convs} and {K3_CONVS}")
    if sum(1 for c in k3_calls if c[5]) != K3_DSH_CONVS:
        raise RuntimeError("the layer-0 convs whose harmonics need a gradient are not the "
                           f"{K3_DSH_CONVS} expected")
    return k2_calls, k3_calls


def bounds(work):
    """{kernel: (bound ms, "bytes" or "operations")} of a work count."""
    out = {}
    for k, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        out[k] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def check_result(what, got, want, dtype, tol_f32):
    """(max |kernel - plain|, max |plain|) of a kernel's result: f32 within
    ``tol_f32`` of the scale; bf16 operands: an f32 output within
    TOL_BF16_OUT of the scale, a bf16 gradient within one bf16 rounding step
    of each element plus TOL_BF16_FLOOR of the scale."""
    import torch

    want = want.detach()
    scale = float(want.abs().max())
    diff = (got.float() - want).abs()
    err = float(diff.max())
    if dtype == torch.float32 or got.dtype == torch.float32:
        tol = tol_f32 if dtype == torch.float32 else TOL_BF16_OUT
        if not err <= tol * max(scale, 1e-30):
            raise AssertionError(f"{what}: |kernel - plain| {err} > {tol} * {scale}")
    else:
        excess = float((diff - BF16_STEP * want.abs()).max())
        if not excess <= TOL_BF16_FLOOR * max(scale, 1e-30):
            raise AssertionError(f"{what}: bf16 |kernel - plain| exceeds one rounding step by "
                                 f"{excess} (> {TOL_BF16_FLOOR} * {scale})")
    return err, scale


def phase_k2_check(calls, timed=True):
    """Hold K2's kernels against the plain version on the captured inputs,
    in f32 and in bf16.  A call with a sender index runs the sender-index
    mode: dw without dsh (the phore convs' harmonics carry no gradient), dx
    by the index's inverse lists (built beforehand, as the autograd forward
    builds them), and the gathered einsums as the library time.  ``timed``
    False: the checks alone, no times."""
    import torch

    from diffphore_torch.ops import tp_aggregate as k2
    from diffphore_torch.ops.tp_fused import K_PAD_L2, lanes

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = []
    for name, tp, x_cap, sh_cap, w_cap, sh_grad, idx in calls:
        B, N, M, _ = sh_cap.shape
        M_x, F = x_cap.shape[1], tp.weight_numel
        l2 = lanes(tp) == K_PAD_L2
        g = torch.randn((B, N, F, lanes(tp)), generator=gen, device="cuda")
        case = {"conv": name, "B": B, "N": N, "M": M, "M_x": M_x, "F": F, "dsh": sh_grad,
                "indexed": idx is not None}
        kw, dx_kw, edge_kw = {}, {}, {}
        if idx is not None:
            if sh_grad:
                raise AssertionError(f"{name}: a phore conv's harmonics carry a gradient")
            kw = {"sender_index": idx}
        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            x, sh, w = (t.to(dtype) for t in (x_cap, sh_cap, w_cap))
            # dx (and at 8 lanes, dense, the edge backward's dsh) read the
            # live bits and the index's lists the autograd forward made, as
            # in the step
            if idx is not None:
                dx_kw = dict(kw, lists=k2.idx_dx_lists(idx, M_x), live=k2.live_rows_l2(w))
            elif l2:
                dx_kw = edge_kw = {"live": k2.live_rows_l2(w)}
            leaves = [t.detach().float().clone().requires_grad_(True) for t in (x, sh, w)]
            ref = k2.tp_aggregate_plain(tp, *(leaf.to(dtype) for leaf in leaves), **kw)
            ref_dx, ref_dsh, ref_dw = torch.autograd.grad(ref, leaves, g, retain_graph=True)
            runs = []
            for _ in range(2):
                out = k2.launch_forward(tp, x, sh, w, **kw)
                dw, dsh = k2.launch_backward_edge(tp, x, sh, w, g, idx is None, **kw, **edge_kw)
                dx = k2.launch_backward_x(tp, x, sh, w, g, **dx_kw)
                runs.append((out, dx, dsh, dw))
            if idx is None:
                dw_only, _ = k2.launch_backward_edge(tp, x, sh, w, g, False)
                torch.cuda.synchronize()
                check_result(f"{name} {dtype}: dw of the kernel without dsh", dw_only, ref_dw,
                             dtype, TOL_K2)
                if l2 and not torch.equal(dw_only, runs[0][3]):   # one arithmetic, with dsh or not
                    raise AssertionError(f"{name} {dtype}: dw with dsh and without differ")
            torch.cuda.synchronize()
            errs = {}
            for label, got, again, want in zip(("out", "dx", "dsh", "dw"), runs[0], runs[1],
                                               (ref, ref_dx, ref_dsh, ref_dw)):
                if got is None:         # dsh: the sender-index mode computes none
                    continue
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} {dtype}: two runs of {label} differ")
                errs[label] = check_result(f"{name} {dtype}: {label}", got, want, dtype, TOL_K2)

            # times: the backward in the form the train step runs it (dsh only
            # where the harmonics carry gradient)
            case["errs" + tag] = errs
            if not timed:
                del ref, leaves, runs
                continue
            dx_call = lambda: k2.launch_backward_x(tp, x, sh, w, g, **dx_kw)
            if idx is not None:   # the forward's live pass (timed in the forward), alone
                case["live_ms" + tag] = device_ms(lambda: k2.live_rows_l2(w), 10)
            case["ms" + tag] = {
                "fwd": device_ms(lambda: k2.launch_forward(tp, x, sh, w, **kw), 10),
                "bwd_edge": device_ms(
                    lambda: k2.launch_backward_edge(tp, x, sh, w, g, sh_grad, **kw, **edge_kw), 10),
                "bwd_x": device_ms(dx_call, 10),
            }
            case["bound" + tag] = bounds(k2_work(tp, x, sh, w, sh_grad, idx))
            case["library_ms" + tag] = (k2_library_ms(tp, x, sh, w, g, sh_grad) if idx is None
                                        else index_library_ms(tp, x, sh, w, g, idx))
            case["grid" + tag] = {}
            if l2 or idx is not None:       # a block per (32 senders, receivers, batch row)
                case["grid" + tag]["bwd_edge"] = k2.edge_grid_l2(B, N, M, idx is not None)
            for k, kept in (("fwd", N), ("bwd_x", M_x)):
                if idx is not None:         # forward: by channel tile; dx: a block per chunk
                    case["grid" + tag][k] = (k2.grid_idx(tp, B, N, M, x.device, dtype)
                                             if k == "fwd" else
                                             (int(dx_kw["lists"].row_ptr[-1]), dx_kw["lists"].Q))
                    continue
                if l2:                      # by channel tile
                    case["grid" + tag][k] = k2.grid_l2(tp, B, N, M, k == "bwd_x", x.device,
                                                       dtype)
                    continue
                splits = k2.launch_splits(tp, B, N, M, k == "bwd_x", x.device, dtype)
                case["grid" + tag][k] = (B * -(-kept // k2.KEEP) * splits, splits)
            if dtype == torch.float32:
                # the plain backward is autograd through the plain version
                case["call_ms_bwd_edge"] = cuda_ms(
                    lambda: k2.launch_backward_edge(tp, x, sh, w, g, sh_grad, **kw, **edge_kw), 10)
                edge_leaves = [leaves[2], leaves[1]] if sh_grad else [leaves[2]]
                with torch.no_grad():
                    plain_fwd = cuda_ms(lambda: k2.tp_aggregate_plain(tp, x, sh, w, **kw), 3)
                case["plain_ms"] = {
                    "fwd": plain_fwd,
                    "bwd_edge": cuda_ms(lambda: torch.autograd.grad(ref, edge_leaves, g,
                                                                    retain_graph=True), 3),
                    "bwd_x": cuda_ms(lambda: torch.autograd.grad(ref, [leaves[0]], g,
                                                                 retain_graph=True), 3),
                }
            del ref, leaves, runs
        cases.append(case)
        if not timed:
            print(f"  {name:28s} B={B:2d} N={N:3d} M={M:3d} F={F:3d} dsh={int(sh_grad)} "
                  f"{errors_text(case)} (reruns bit-equal)", flush=True)
            continue
        ms, ms_bf, plain, bound = case["ms"], case["ms_bf16"], case["plain_ms"], case["bound"]
        grid = case["grid"]
        print(f"  {name:28s} B={B:2d} N={N:3d} M={M:3d} "
              + (f"(slots of M_x={M_x} senders) " if idx is not None else "")
              + f"F={F:3d} dsh={int(sh_grad)} "
              f"fwd grid {grid['fwd'][0]} blocks ({grid['fwd'][1]} "
              + ("slot" if idx is not None else "sender") + " splits; bf16 "
              f"{case['grid_bf16']['fwd'][1]}), dx grid {grid['bwd_x'][0]} blocks "
              + (f"(chunks of at most {grid['bwd_x'][1]} slots) " if idx is not None else
                 f"({grid['bwd_x'][1]} receiver splits; bf16 {case['grid_bf16']['bwd_x'][1]}) ")
              + (f"edge grid {grid['bwd_edge'][0]} blocks ({grid['bwd_edge'][1]} receivers a "
                 "block) " if "bwd_edge" in grid else "")
              + f"{errors_text(case)} "
              f"| ms kernel/plain/einsum/bound f32, kernel/einsum/bound bf16: "
              + " ".join(f"{k} {ms[k]:.4f}/{plain[k]:.4f}/{case['library_ms'][k]:.4f}/"
                         f"{bound[k][0]:.4f}({bound[k][1][0]}), {ms_bf[k]:.4f}/"
                         f"{case['library_ms_bf16'][k]:.4f}/{case['bound_bf16'][k][0]:.4f}"
                         for k in ("fwd", "bwd_edge", "bwd_x"))
              + (f" (fwd with the live pass, alone {case['live_ms']:.4f} / "
                 f"{case['live_ms_bf16']:.4f})" if idx is not None else "")
              + f" | bwd_edge per call from Python {case['call_ms_bwd_edge']:.4f}", flush=True)
    by_name = {c["conv"]: c for c in cases}
    for c in cases if timed else ():
        twin = by_name.get(c["conv"].replace("_conv_", "_norm_conv_"))
        if c["dsh"] and twin is not None and twin is not c:
            a, b = c["ms"]["bwd_edge"], twin["ms"]["bwd_edge"]
            print(f"  edge backward with dsh, {c['conv']}: {a:.4f} ms, its norm twin (dw only, same "
                  f"shapes) {b:.4f} ms, ratio {a / b:.2f}", flush=True)
    return cases


def errors_text(case):
    """A K2 or K3 case's errors against the plain version, f32 then bf16,
    with the plain results' scales."""
    errs, errs_bf = case["errs"], case["errs_bf16"]
    return ("err " + " ".join(f"{k} {v[0]:.1e}" for k, v in errs.items())
            + " (max|ref| " + " ".join(f"{v[1]:.1e}" for v in errs.values()) + "); bf16 err "
            + " ".join(f"{k} {v[0]:.1e}" for k, v in errs_bf.items()))


# The CUDA kernels behind each K2 wrapper: the first always runs; the second
# adds the splits of the summed axis (forward, dx) or replaces the first
# where the harmonics need a gradient (edge backward).
K2_DEVICE_KERNELS = {
    "fwd": ["tp_aggregate_fwd_kernel", "tp_aggregate_sum_splits"],
    "bwd_edge": ["tp_aggregate_bwd_edge_kernel", "tp_aggregate_bwd_edge_kernel_dsh"],
    "bwd_x": ["tp_aggregate_bwd_x_kernel", "tp_aggregate_sum_splits"],
}


# The 8-lane kernels (l = 2): the forward is the live pass over w and the
# tiled kernel on the live tiles, with a third kernel that adds the senders'
# splits where they split; dx the tiled kernel on the same live bits (the
# train step's forward makes them) and a second kernel that adds the
# splits' and channel tiles' partial sums where there is more than one; the
# edge backward each receiver's P once, then the edge kernel.
K2_DEVICE_KERNELS_L2 = {
    "fwd": ["tp_aggregate_l2_live_kernel", "tp_aggregate_fwd_l2_tiled_kernel",
            "tp_aggregate_sum_splits"],
    "bwd_edge": ["tp_aggregate_l2_p_kernel", "tp_aggregate_bwd_edge_l2_kernel"],
    "bwd_x": ["tp_aggregate_bwd_x_l2_tiled_kernel", "tp_aggregate_l2_dx_sum"],
}


def k2_kernel_entries(cases, launches, l2=False):
    """The report entries of K2's three kernels, summed over one step's convs
    (``l2``: the 8-lane kernels, names ending in ``_l2``)."""
    labels = {"fwd": ("out",), "bwd_edge": ("dw", "dsh"), "bwd_x": ("dx",)}
    entries = []
    for k, outputs in labels.items():
        by = {"bytes": 0.0, "operations": 0.0}
        for c in cases:
            by[c["bound"][k][1]] += c["bound"][k][0]
        entries.append({
            "name": f"tp_aggregate_{k}" + ("_l2" if l2 else ""),
            "device_kernels": (K2_DEVICE_KERNELS_L2 if l2 else K2_DEVICE_KERNELS)[k],
            "route": "cuda",
            "source": "diffphore_torch/csrc/tp_aggregate.cu",
            "replaces": "diffphore_tpu/ops/pallas/tp_aggregate.py:88",
            "launches": launches[k + ("_l2" if l2 else "")],
            "max_abs_err": max(c["errs"][o][0] for c in cases for o in outputs),
            "max_rel_err": max(c["errs"][o][0] / max(c["errs"][o][1], 1e-30)
                               for c in cases for o in outputs),
            "ms": sum(c["ms"][k] for c in cases),
            "plain_ms": sum(c["plain_ms"][k] for c in cases),
            "bound_ms": sum(c["bound"][k][0] for c in cases),
            "bound_by": "operations" if by["operations"] >= by["bytes"] else "bytes",
            "library_ms": sum(c["library_ms"][k] for c in cases),
            "ms_bf16": sum(c["ms_bf16"][k] for c in cases),
            "bound_ms_bf16": sum(c["bound_bf16"][k][0] for c in cases),
            "library_ms_bf16": sum(c["library_ms_bf16"][k] for c in cases),
            "max_abs_err_bf16": max(c["errs_bf16"][o][0] for c in cases for o in outputs),
            "unit": "one train step: the 17 conv calls, each timed alone on the card (graph replay), "
                    "f32 operands (ms) and bf16 ones (ms_bf16); a call runs device_kernels as "
                    "noted where they are listed; library_ms is "
                    "torch.einsum of " + " and ".join(f"'{eq}'" for eq, _ in K2_EINSUM[k])
                    + " on each path's operands"
                    + (" (dsh's where the conv needs it)" if k == "bwd_edge" else "")
                    + ", by graph replay",
        })
        if k != "bwd_edge":
            entries[-1]["splits"] = [c["grid"][k][1] for c in cases]
    return entries


def einsum_ms(per_path, eqs):
    """ms on the card (graph replay) of the einsums ``eqs`` ((equation,
    operand names)) on every path's operands: the PyTorch calls that compute
    a kernel's function, timed beside it and used nowhere in the port."""
    import torch

    def run():
        for ops in per_path:
            for eq, names in eqs:
                torch.einsum(eq, *(ops[n] for n in names.split()))
    with torch.no_grad():
        return device_ms(run, 5)


# Per path, the einsums of K2's three functions on the path's operands x
# (B, M, mul, 2 l_in + 1), sh, the coupling tensor c (alpha * cg), w and g;
# the edge backward's second einsum (dsh) only where the harmonics need it.
K2_EINSUM = {"fwd": [("bmui,bnmj,ijk,bnmu->bnuk", "x sh c w")],
             "bwd_edge": [("bmui,bnmj,ijk,bnuk->bnmu", "x sh c g"),
                          ("bmui,ijk,bnmu,bnuk->bnmj", "x c w g")],
             "bwd_x": [("bnmj,ijk,bnmu,bnuk->bmui", "sh c w g")]}


def k2_library_ms(tp, x, sh, w, g, with_dsh):
    """{kernel: ms} of K2's per-path einsums on one conv, in the operands'
    type (g cast to it)."""
    import torch

    from diffphore_torch.ops.tp_fused import coupling

    in_slices, sh_slices = tp.irreps_in.slices(), tp.irreps_sh.slices()
    per_path = []
    for p in tp.paths:
        xb = x[..., in_slices[p.i_in]]
        per_path.append({
            "x": xb.reshape(xb.shape[:-1] + (p.mul_in, 2 * p.l_in + 1)),
            "sh": sh[..., sh_slices[p.i_sh]],
            "c": torch.as_tensor(coupling(p, x.dtype), device=x.device).to(x.dtype),
            "w": w[..., p.w_slice[0]:p.w_slice[1]],
            "g": g[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1].to(x.dtype)})
    return {k: einsum_ms(per_path, eqs if k != "bwd_edge" or with_dsh else eqs[:1])
            for k, eqs in K2_EINSUM.items()}


K3_KERNELS = ("fwd", "bwd_edge", "bwd_x")
# Per path, the einsums of K3's three functions on the path's views (x, sh,
# w and g); the edge backward's second einsum (dsh) only where the harmonics
# need it.
K3_EINSUM = {"fwd": [("bmu,bnmk,bnmu->bnuk", "x sh w")],
             "bwd_edge": [("bmu,bnmk,bnuk->bnmu", "x sh g"), ("bmu,bnmu,bnuk->bnmk", "x w g")],
             "bwd_x": [("bnmk,bnmu,bnuk->bmu", "sh w g")]}


def k3_library_ms(tp, x, sh, w, g, with_dsh):
    """{kernel: ms} of K3's per-path einsums on one conv, in the operands'
    type (g cast to it)."""
    from diffphore_torch.ops import tp_scalar as k3

    per_path = [{"x": xv, "sh": shv, "w": wv,
                 "g": g[:, :, p.w_slice[0]:p.w_slice[1], :shv.shape[-1]].to(x.dtype)}
                for p, (xv, shv, wv) in zip(tp.paths, k3.path_views(tp, x, sh, w))]
    return {k: einsum_ms(per_path, eqs if k != "bwd_edge" or with_dsh else eqs[:1])
            for k, eqs in K3_EINSUM.items()}


def k3_work(tp, x, sh, w, with_dsh, idx=None):
    """{kernel: (bytes, f32 operations)} that K3's three kernels need on one
    convolution: each operand read once (x once for all paths, the harmonic
    components the paths read, the weights, the upstream gradient's lanes
    the paths read), each result written once (dsh its full row), at their
    element sizes (the output and the upstream gradient f32); products with
    an edge weight counted on edges whose weights are not all zero, dw on
    every edge (it is defined where w is masked too).  The edge backward
    reads w and writes dsh only ``with_dsh``.  A sender index ``idx`` is
    read once by each kernel."""
    B, N, M, S = sh.shape
    edges = B * N * M
    live = int((w != 0).any(-1).sum())
    es = x.element_size()
    sh_k = sum(k for _, k in {(p.i_sh, 2 * p.l_sh + 1) for p in tp.paths})
    x_b = es * x.numel() + (0 if idx is None else idx.numel() * idx.element_size())
    sh_b, w_b = es * edges * sh_k, es * edges * tp.weight_numel
    gk = sum(p.mul_in * (2 * p.l_sh + 1) for p in tp.paths)
    out_b = g_b = 4 * B * N * gk     # the f32 output's and g's lanes that the paths define
    per_edge = sum(p.mul_in * (2 * (2 * p.l_sh + 1) + 1) for p in tp.paths)
    dsh_ops = sum(p.mul_in * 2 * (2 * p.l_sh + 1) for p in tp.paths)
    return {
        "fwd": (x_b + sh_b + w_b + out_b, live * per_edge),
        "bwd_edge": (x_b + sh_b + g_b + w_b + (w_b + es * edges * S if with_dsh else 0),
                     edges * per_edge + (live * dsh_ops if with_dsh else 0)),
        "bwd_x": (sh_b + w_b + g_b + x_b, live * (per_edge + tp.weight_numel)),
    }


def phase_k3_check(calls, timed=True):
    """Hold K3's kernels against the plain versions on each captured
    layer-0 conv, in f32 and in bf16: the forward and dx against autograd
    through ``scalar_paths_aggregate_plain``, the edge backward (dw and dsh
    in one launch) against ``scalar_paths_backward_edge_plain``.  A call
    with a sender index runs the sender-index mode as phase_k2_check does:
    dw without dsh, dx by the index's inverse lists, the gathered einsums
    as the library time.  ``timed`` False: the checks alone, no times."""
    import torch

    from diffphore_torch.ops import tp_scalar as k3
    from diffphore_torch.ops.tp_fused import lanes as n_lanes

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    cases = []
    for name, tp, x_cap, sh_cap, w_cap, sh_grad, idx in calls:
        B, N, M, _ = sh_cap.shape
        M_x, F = x_cap.shape[1], tp.weight_numel
        g = torch.randn((B, N, F, n_lanes(tp)), generator=gen, device="cuda")   # pad lanes: noise
        lanes = torch.zeros_like(g)
        for p in tp.paths:
            lanes[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
        case = {"conv": name, "B": B, "N": N, "M": M, "M_x": M_x, "F": F, "dsh": sh_grad,
                "paths": len(tp.paths), "indexed": idx is not None}
        kw, dx_kw = {}, {}
        if idx is not None:
            if sh_grad:
                raise AssertionError(f"{name}: a phore conv's harmonics carry a gradient")
            kw = {"sender_index": idx}
            count = torch.bincount((idx.long() + M_x * torch.arange(B, device=idx.device)[
                :, None, None]).flatten(), minlength=B * M_x).float()
            case["slots_per_sender"] = {"max": int(count.max()), "mean": float(count.mean()),
                                        "mean_read": float(count[count > 0].mean()),
                                        "unread": int((count == 0).sum())}
        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            x, sh, w = (t.to(dtype) for t in (x_cap, sh_cap, w_cap))
            if idx is not None:
                # the index's inverse lists and slot chunks, built beforehand
                # as the autograd forward builds them
                dx_kw = dict(kw, lists=k3.dx_lists(tp, idx, M_x, dtype))
            leaves = [t.detach().float().clone().requires_grad_(True) for t in (x, sh, w)]
            ref = k3.scalar_paths_aggregate_plain(tp, *(leaf.to(dtype) for leaf in leaves), **kw)
            (ref_dx,) = torch.autograd.grad(ref, [leaves[0]], g * lanes, retain_graph=True)
            ref_dw, ref_dsh = k3.scalar_paths_backward_edge_plain(tp, x, sh, w, g, idx is None,
                                                                  **kw)
            runs = []
            for _ in range(2):
                out = k3.launch_forward(tp, x, sh, w, **kw)
                dw, dsh = k3.launch_backward_edge(tp, x, sh, w, g, idx is None, **kw)
                dx = k3.launch_backward_x(tp, x, sh, w, g, **dx_kw)
                runs.append((out, dx, dsh, dw))
            if idx is None:
                dw_only, _ = k3.launch_backward_edge(tp, x, sh, w, g, False)
                _, dsh_only = k3.launch_backward_edge(tp, x, sh, w, g, True, False)
                torch.cuda.synchronize()
                if not (torch.equal(dw_only, runs[0][3]) and torch.equal(dsh_only, runs[0][2])):
                    raise AssertionError(f"{name} {dtype}: the edge backward's dw without dsh, "
                                         "or its dsh without dw, differs from the launch of both")
                unread = runs[0][2][..., k3.sh_reach(tp):]
                if unread.numel() and float(unread.abs().max()) != 0.0:
                    raise AssertionError(f"{name} {dtype}: dsh is not zero where no path reads")
            torch.cuda.synchronize()
            errs = {}
            for label, got, again, want in zip(("out", "dx", "dsh", "dw"), runs[0], runs[1],
                                               (ref, ref_dx, ref_dsh, ref_dw)):
                if got is None:         # dsh: the sender-index mode computes none
                    continue
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} {dtype}: two runs of {label} differ")
                errs[label] = check_result(f"{name} {dtype}: {label}", got, want.float(), dtype,
                                           TOL_K3)
            case["errs" + tag] = errs
            if not timed:
                del ref, leaves, runs
                continue
            # times: the edge backward in the form the train step runs it (dsh
            # only where the harmonics carry gradient)
            case["ms" + tag] = {
                "fwd": device_ms(lambda: k3.launch_forward(tp, x, sh, w, **kw), 20),
                "bwd_edge": device_ms(
                    lambda: k3.launch_backward_edge(tp, x, sh, w, g, sh_grad, **kw), 20),
                "bwd_x": device_ms(lambda: k3.launch_backward_x(tp, x, sh, w, g, **dx_kw), 20),
            }
            case["bound" + tag] = bounds(k3_work(tp, x, sh, w, sh_grad, idx))
            if idx is None and n_lanes(tp) == 8:   # runs of senders x receiver splits
                run, _, splits = k3.launch_plan_l2(tp, B, N, M, x.device, dtype)
                dx_grid = f"{splits} (runs of {run} senders)"
            elif idx is None:
                dx_grid = k3.launch_chunk(tp, B, N, M, True, x.device, dtype)[1]
            else:
                lists = dx_kw["lists"]
                dx_grid = f"Q={lists.Q} x {int(lists.row_ptr[-1])} chunks, {lists.blocks} blocks"
            if idx is not None:                     # whole receivers a block, all slots
                R, SL, MC = k3.plan_idx(tp, B, N, M)
                fwd_grid = f"1 ({R} receivers x {SL} slices a block, {MC} slots staged)"
            elif n_lanes(tp) == 8:                  # whole receivers a block, no splits
                R, SL, MC = k3.launch_plan_fwd_l2(tp, B, N, M, x.device, dtype)
                fwd_grid = f"1 ({R} receivers x {SL} slices a block, {MC} senders staged)"
            else:
                fwd_grid = k3.launch_chunk(tp, B, N, M, False, x.device, dtype)[1]
            case["grid" + tag] = {"fwd": fwd_grid, "bwd_x": dx_grid}
            case["library_ms" + tag] = (k3_library_ms(tp, x, sh, w, g, sh_grad) if idx is None
                                        else index_library_ms(tp, x, sh, w, g, idx))
            if dtype == torch.float32:
                with torch.no_grad():
                    plain = {
                        "fwd": cuda_ms(lambda: k3.scalar_paths_aggregate_plain(tp, x, sh, w,
                                                                               **kw), 5),
                        "bwd_edge": cuda_ms(lambda: k3.scalar_paths_backward_edge_plain(
                            tp, x, sh, w, g, sh_grad, **kw), 5)}
                plain["bwd_x"] = cuda_ms(lambda: torch.autograd.grad(
                    ref, [leaves[0]], g * lanes, retain_graph=True), 5)
                case["plain_ms"] = plain
            del ref, leaves, runs
        cases.append(case)
        if not timed:
            print(f"  {name:28s} B={B:2d} N={N:3d} M={M:3d} F={F} dsh={int(sh_grad)} "
                  f"{errors_text(case)} (reruns bit-equal)", flush=True)
            continue
        ms, ms_bf, bound, lib = case["ms"], case["ms_bf16"], case["bound"], case["library_ms"]
        print(f"  {name:28s} B={B:2d} N={N:3d} M={M:3d} "
              + (f"(slots of M_x={M_x} senders; slots a sender: max "
                 f"{case['slots_per_sender']['max']}, mean {case['slots_per_sender']['mean']:.2f}, "
                 f"{case['slots_per_sender']['mean_read']:.2f} over the "
                 f"{B * M_x - case['slots_per_sender']['unread']} read) " if idx is not None
                 else "")
              + f"F={F} dsh={int(sh_grad)} "
              f"splits fwd {case['grid']['fwd']} dx {case['grid']['bwd_x']} (bf16 "
              f"{case['grid_bf16']['fwd']}, {case['grid_bf16']['bwd_x']}) "
              f"{errors_text(case)} "
              f"| ms kernel/plain/einsum/bound f32, kernel/einsum/bound bf16: "
              + " ".join(f"{k} {ms[k]:.4f}/{case['plain_ms'][k]:.4f}/{lib[k]:.4f}/"
                         f"{bound[k][0]:.4f}({bound[k][1][0]}), {ms_bf[k]:.4f}/"
                         f"{case['library_ms_bf16'][k]:.4f}/{case['bound_bf16'][k][0]:.4f}"
                         for k in K3_KERNELS), flush=True)
    return cases


def k3_kernel_entries(cases, launches, launches_training, l2=False):
    """The report entries of K3's three kernels, summed over the calls one
    train step makes (the edge backward with dsh on the convs whose
    harmonics need a gradient); ``l2``: the 8-lane kernels, names
    ending in ``_l2``."""
    labels = {"fwd": ("out",), "bwd_edge": ("dw", "dsh"), "bwd_x": ("dx",)}
    suffix = "_l2" if l2 else ""
    entries = []
    for k, outputs in labels.items():
        by = {"bytes": 0.0, "operations": 0.0}
        for c in cases:
            by[c["bound"][k][1]] += c["bound"][k][0]
        entries.append({
            "name": f"tp_scalar_{k}{suffix}",
            "route": "cuda",
            "source": "diffphore_torch/csrc/tp_scalar.cu",
            "replaces": "diffphore_tpu/ops/pallas/tp_scalar.py:43",
            "launches": launches[f"k3_{k}{suffix}"],
            "launches_training_path": launches_training[f"k3_{k}{suffix}"],
            "max_abs_err": max(c["errs"][o][0] for c in cases for o in outputs),
            "max_rel_err": max(c["errs"][o][0] / max(c["errs"][o][1], 1e-30)
                               for c in cases for o in outputs),
            "ms": sum(c["ms"][k] for c in cases),
            "plain_ms": sum(c["plain_ms"][k] for c in cases),
            "bound_ms": sum(c["bound"][k][0] for c in cases),
            "bound_by": "operations" if by["operations"] >= by["bytes"] else "bytes",
            "library_ms": sum(c["library_ms"][k] for c in cases),
            "ms_bf16": sum(c["ms_bf16"][k] for c in cases),
            "bound_ms_bf16": sum(c["bound_bf16"][k][0] for c in cases),
            "library_ms_bf16": sum(c["library_ms_bf16"][k] for c in cases),
            "max_abs_err_bf16": max(c["errs_bf16"][o][0] for c in cases for o in outputs),
            "unit": "one train step: the 6 conv calls of the layer-0 convs, each timed alone on "
                    "the card (graph replay), f32 operands (ms) and bf16 ones (ms_bf16); "
                    "library_ms is torch.einsum of "
                    + " and ".join(f"'{eq}'" for eq, _ in K3_EINSUM[k])
                    + " on each path's views"
                    + (" (dsh's where the conv needs it)" if k == "bwd_edge" else "")
                    + ", by graph replay",
        })
        if l2:   # kernels of their own at 8 lanes
            entries[-1]["device_kernels"] = {
                "fwd": ["tp_scalar_fwd_l2_kernel"],
                "bwd_edge": ["tp_scalar_bwd_edge_l2_kernel"],
                "bwd_x": ["tp_scalar_bwd_x_l2_kernel", "tp_scalar_sum_splits"]}[k]
    return entries


def _counters():
    """Every kernel's launch counter: the 4-lane kernels, under the same
    names ending in ``_l2`` the 8-lane ones (l = 2), and ending in ``_idx``
    (``_idx_l2``) the sender-index mode of the KNN phore grid."""
    from diffphore_torch.ops import tp_aggregate, tp_fused, tp_scalar

    return {"k1": tp_fused.KERNEL, "fwd": tp_aggregate.FWD, "bwd_edge": tp_aggregate.BWD_EDGE,
            "bwd_x": tp_aggregate.BWD_X, "k3_fwd": tp_scalar.FWD,
            "k3_bwd_edge": tp_scalar.BWD_EDGE, "k3_bwd_x": tp_scalar.BWD_X,
            "k1_l2": tp_fused.KERNEL_L2, "fwd_l2": tp_aggregate.FWD_L2,
            "bwd_edge_l2": tp_aggregate.BWD_EDGE_L2, "bwd_x_l2": tp_aggregate.BWD_X_L2,
            "k3_fwd_l2": tp_scalar.FWD_L2, "k3_bwd_edge_l2": tp_scalar.BWD_EDGE_L2,
            "k3_bwd_x_l2": tp_scalar.BWD_X_L2,
            "k1_idx": tp_fused.KERNEL_IDX, "fwd_idx": tp_aggregate.FWD_IDX,
            "bwd_edge_idx": tp_aggregate.BWD_EDGE_IDX, "bwd_x_idx": tp_aggregate.BWD_X_IDX,
            "k3_fwd_idx": tp_scalar.FWD_IDX, "k3_bwd_edge_idx": tp_scalar.BWD_EDGE_IDX,
            "k3_bwd_x_idx": tp_scalar.BWD_X_IDX,
            "k1_idx_l2": tp_fused.KERNEL_IDX_L2, "fwd_idx_l2": tp_aggregate.FWD_IDX_L2,
            "bwd_edge_idx_l2": tp_aggregate.BWD_EDGE_IDX_L2,
            "bwd_x_idx_l2": tp_aggregate.BWD_X_IDX_L2, "k3_fwd_idx_l2": tp_scalar.FWD_IDX_L2,
            "k3_bwd_edge_idx_l2": tp_scalar.BWD_EDGE_IDX_L2,
            "k3_bwd_x_idx_l2": tp_scalar.BWD_X_IDX_L2}


def kernel_counts():
    return {name: k.launches for name, k in _counters().items()}


def reset_kernel_counts():
    for k in _counters().values():
        k.launches = 0


def want_counts(steps=0, eval_batches=0, k2_convs=K2_CONVS, k1=None, l2=False, knn=False,
                k1_idx=None):
    """The launches of ``steps`` training forwards and backwards of a model
    whose convs K2 takes ``k2_convs`` of, ``eval_batches`` eval-mode forwards
    of the score model (validation batches, or the frozen forward of a
    calibrated step), or ``k1`` K1 launches in all: on the 8-lane kernels
    (``l2``) or the 4-lane ones, the other layout's at 0.  ``knn``: the
    model's phore grid is KNN-compacted, so its KNN_CONVS phore convs (K3
    the layer-0 one, K2 the others) run the sender-index mode (``k1_idx``
    K1 launches in all with ``k1``); else every sender-index count is 0."""
    phore = KNN_CONVS if knn else 0
    if k1 is None:
        k1, k1_idx = (CONVS_PER_FORWARD - phore) * eval_batches, phore * eval_batches
    per = {"k1": k1, "fwd": k2_convs * steps, "bwd_edge": k2_convs * steps,
           "bwd_x": k2_convs * steps, "k3_fwd": K3_CONVS * steps,
           "k3_bwd_edge": K3_CONVS * steps, "k3_bwd_x": K3_CONVS * steps}
    idx = {k: 0 for k in per}
    if knn:
        idx = {"k1": k1_idx or 0, "fwd": (phore - 1) * steps, "bwd_edge": (phore - 1) * steps,
               "bwd_x": (phore - 1) * steps, "k3_fwd": steps, "k3_bwd_edge": steps,
               "k3_bwd_x": steps}
        per = {k: n - (idx[k] if k != "k1" else 0) for k, n in per.items()}
    out = {}
    for suffix in ("", "_l2"):
        on = (suffix == "_l2") == l2
        for k, n in per.items():
            out[k + suffix] = n if on else 0
        for k, n in idx.items():
            out[k + "_idx" + suffix] = n if on else 0
    return out


def expect_counts(what, **kw):
    """The launches since the counts were set to 0, held exactly against
    :func:`want_counts` (``kw``)."""
    got, want = kernel_counts(), want_counts(**kw)
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
    return got


def compare_step_gradients(what, results):
    """(loss, gradients by name) of a step with the kernels against the same
    step with the plain convs."""
    (loss_k, grads_k), (loss_p, grads_p) = results
    floor = TOL_STEP_FLOOR * max(float(g.abs().max()) for g in grads_p.values() if g.numel())
    worst = 0.0          # over the leaves whose gradient stands clear of the floor
    for name, gp in grads_p.items():
        if not gp.numel():
            continue
        scale, err = float(gp.abs().max()), float((grads_k[name] - gp).abs().max())
        if not err <= TOL_STEP_GRAD * scale + floor:
            raise AssertionError(f"{what}: gradient of {name}: |kernel - plain| {err} > "
                                 f"{TOL_STEP_GRAD} * {scale} + {floor}")
        if scale >= 100 * floor:
            worst = max(worst, err / scale)
    if not abs(loss_k - loss_p) <= TOL_STEP_GRAD * abs(loss_p):
        raise AssertionError(f"{what}: loss: kernel {loss_k} vs plain {loss_p}")
    print(f"{what}, kernels vs plain convs, same draws: loss {loss_k:.6f} vs {loss_p:.6f}; "
          f"{len(grads_p)} gradient leaves within {TOL_STEP_GRAD} of their scale "
          f"(worst |kernel - plain| / max|plain| of a leaf clear of the noise floor: "
          f"{worst:.2e})", flush=True)


def compare_bf16_step(what, results):
    """A bf16 step with the kernels against the same step with the plain
    convs ({(dtype, use_kernel): (loss, gradients by name)}): the loss within
    TOL_STEP_GRAD of its size, as at f32 (a scalar whose f32-vs-bf16
    difference may be near 0 by chance), and the gradient over all leaves as
    one vector within TOL_BF16_GAP of the plain route's own f32-vs-bf16
    difference."""
    import torch

    (loss_k, gk), (loss_p, gp) = results["bfloat16", True], results["bfloat16", False]
    loss_32, g32 = results["float32", False]
    names = [k for k, v in gp.items() if v.numel()]
    flat = lambda d: torch.cat([d[k].flatten() for k in names])
    err = float((flat(gk) - flat(gp)).norm())
    gap = float((flat(g32) - flat(gp)).norm())
    norm = float(flat(gp).norm())
    if not err <= TOL_BF16_GAP * gap:
        raise AssertionError(f"{what}: |kernel - plain| of the gradient {err} > {TOL_BF16_GAP} * "
                             f"the plain route's f32-vs-bf16 difference {gap}")
    if not abs(loss_k - loss_p) <= TOL_STEP_GRAD * abs(loss_p):
        raise AssertionError(f"{what}: loss: kernel {loss_k} vs plain {loss_p} (f32 plain "
                             f"{loss_32})")
    print(f"{what}, kernels vs plain convs, same draws: loss {loss_k:.6f} vs {loss_p:.6f} (f32 "
          f"plain {loss_32:.6f}); gradient over {len(names)} leaves, L2 |kernel - plain| / "
          f"|plain| {err / norm:.2e} against the plain route's f32-vs-bf16 {gap / norm:.2e}",
          flush=True)


def set_use_kernel(model, use_kernel):
    from diffphore_torch.models.layers import DenseTPConv

    for m in model.modules():
        if isinstance(m, DenseTPConv):
            m.use_kernel = use_kernel


def phase_training(cfg, train_batch, card):
    """(c), (b) and (a) of the training path; returns the launch counts of
    the CLI run (K2 and K3 of its steps, K1 of its validation batch)."""
    import numpy as np
    import torch

    from diffphore_torch.cli import train as train_cli
    from diffphore_torch.data.transforms import draw_noise
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.utils import checkpoints

    B, T = train_batch.batch_size, train_batch.num_torsions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    draws = draw_noise(B, T, gen, "cuda")
    step = make_train_step(cfg)

    # ---- (c) one step, kernels against plain convs, same noise and dropout
    # masks, at f32 and at the shipped bf16
    results = {}
    for dtype in ("float32", "bfloat16"):
        cfg_d = dataclasses.replace(cfg, compute_dtype=dtype)
        step_d = make_train_step(cfg_d)
        for use_kernel in (True, False):
            state = create_train_state(cfg_d, seed=SEED, device="cuda")
            set_use_kernel(state.model, use_kernel)
            drop = torch.Generator(device="cuda")
            drop.manual_seed(SEED + 1)
            reset_kernel_counts()
            state, metrics = step_d(state, train_batch, drop, draws=draws)
            torch.cuda.synchronize()
            expect_counts(f"{dtype} step with use_kernel={use_kernel}",
                          steps=1 if use_kernel else 0)
            results[dtype, use_kernel] = (float(metrics["loss"]),
                                          {k: p.grad.clone()
                                           for k, p in state.model.named_parameters()})
            del state
    compare_step_gradients("train step (f32)",
                           [results["float32", True], results["float32", False]])
    compare_bf16_step("train step (bf16)", results)

    # ---- (b) one fixed batch, fixed noise, dropout on
    state = create_train_state(cfg, seed=SEED, device="cuda")
    drop = torch.Generator(device="cuda")
    drop.manual_seed(SEED + 2)
    state, _ = step(state, train_batch, drop, draws=draws)          # warm-up
    torch.cuda.synchronize()
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, finite = [], []
    t0 = time.perf_counter()
    for _ in range(FIXED_BATCH_STEPS):
        state, metrics = step(state, train_batch, drop, draws=draws)
        losses.append(metrics["loss"])
        finite.append(metrics["grad_finite"])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    expect_counts("fixed-batch steps", steps=FIXED_BATCH_STEPS)
    losses = torch.stack(losses).cpu().numpy()
    if not (np.isfinite(losses).all() and float(torch.stack(finite).min()) == 1.0):
        raise AssertionError(f"fixed-batch losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"fixed-batch loss did not fall: {losses[0]} -> {losses[-1]}")
    peak_fixed = torch.cuda.max_memory_allocated() / 2**30
    print(f"fixed batch of {B}, fixed noise, dropout {cfg.dropout}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {FIXED_BATCH_STEPS} steps; {FIXED_BATCH_STEPS / elapsed:.2f} "
          f"steps/s, {B * FIXED_BATCH_STEPS / elapsed:.1f} complexes/s, peak memory "
          f"{peak_fixed:.2f} GiB; per step K2 launches {K2_CONVS} forward + {K2_CONVS} edge "
          f"backward + {K2_CONVS} sender backward, K3 {K3_CONVS} forward + {K3_CONVS} edge "
          f"backward ({K3_DSH_CONVS} with dsh) + {K3_CONVS} dx, K1 0 ({card})", flush=True)
    del state

    # ---- (a) the training CLI: one epoch over cached complexes + a val-loss epoch
    with tempfile.TemporaryDirectory() as tmp:
        copy_bucket(TRAIN_CACHE_DIR, os.path.join(tmp, "train_smoke"), TRAIN_COMPLEXES)
        copy_bucket(CACHE_DIR, os.path.join(tmp, "val_smoke"), VAL_COMPLEXES)
        run_dir = os.path.join(tmp, "run")
        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        train_cli.main([
            "--cache_path", tmp, "--run_dir", run_dir, "--n_epochs", "1",
            "--batch_size", str(TRAIN_BATCH), "--seed", str(SEED), "--val_inference_freq", "0",
            "--test_sigma_intervals", "5", "--ns", str(cfg.ns), "--nv", str(cfg.nv),
            "--num_conv_layers", str(cfg.num_conv_layers), "--dropout", str(cfg.dropout),
            "--lr", "0.001"])
        torch.cuda.synchronize()
        steps = TRAIN_COMPLEXES // TRAIN_BATCH
        counts = expect_counts("cli.train.main", steps=steps, eval_batches=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        train_rec = [r for r in records if r.get("mode") != "val"]
        val_rec = [r for r in records if r.get("mode") == "val"]
        if len(train_rec) != 1 or len(val_rec) != 1:
            raise AssertionError(f"metrics.jsonl holds {len(records)} records")
        rec = train_rec[0]
        keys = ("loss", "tr_loss", "rot_loss", "tor_loss")
        if rec["steps"] != steps or rec["grad_finite"] != 1.0 \
                or not all(np.isfinite(rec[k]) for k in keys) \
                or not all(np.isfinite(v) for v in val_rec[0].values() if isinstance(v, float)):
            raise AssertionError(f"training metrics not as expected: {rec} {val_rec[0]}")
        run_cfg, reloaded = checkpoints.load_model_dir(
            run_dir, device="cuda", checkpoint=checkpoints.LAST_MODEL, use_ema=True)
        widths = ("ns", "nv", "num_conv_layers", "dropout", "tp_mode", "consider_norm")
        if any(getattr(run_cfg, k) != getattr(cfg, k) for k in widths):
            raise AssertionError("the run directory's config is not at corpus2's width")
        with torch.no_grad():
            out = reloaded(train_batch.replace(t=torch.full((B,), 0.5, device="cuda")))
        if not all(bool(torch.isfinite(o).all()) for o in out):
            raise AssertionError("the reloaded checkpoint's forward is not finite")
    rate = rec["steps"] / rec["epoch_time"]
    print(f"cli.train.main: {rec['steps']} steps of batch {TRAIN_BATCH} in {rec['epoch_time']:.3f} s "
          f"= {rate:.2f} steps/s, {rate * TRAIN_BATCH:.1f} complexes/s (data loading included), "
          f"train loss {rec['loss']:.4f}, val loss {val_rec[0]['loss']:.4f} over "
          f"{VAL_COMPLEXES} complexes, peak memory {peak:.2f} GiB; launches {counts} ({card})",
          flush=True)
    return counts


def copy_bucket(src, dst, n):
    os.makedirs(dst)
    for f, _ in bucket_complexes(src, n):
        shutil.copy(f, dst)


def phase_calibrated(cfg, train_batch, card):
    """(c) and (a) of the calibrated-sampler path; returns the launch counts
    of the CLI epoch."""
    import numpy as np
    import torch

    from diffphore_torch.cli import train as train_cli
    from diffphore_torch.models.layers import set_compute_dtype
    from diffphore_torch.train.ccsampler import (ccsampler_apply_noise, draw_cc,
                                                 make_ccsampler_train_step)
    from diffphore_torch.train.state import create_train_state
    from diffphore_torch.utils.checkpoints import BEST_EMA_MODEL, load_model_dir

    B, T = train_batch.batch_size, train_batch.num_torsions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    draws = draw_cc(B, T, gen, "cuda")

    # ---- (c) one calibrated step, kernels against plain convs (the frozen
    # forward's too), same draws and dropout masks.  Fresh weights, as the
    # plain train step's check: every gradient leaf is held.  Shipped weights:
    # the frozen stage (branch selection, poses, targets) and the loss are
    # held; the gradients are printed, not held: with the trained weights and
    # these draws one element of the model sits on a step function, and
    # rounding noise of 1e-7 put on the plain route's own conv outputs moves
    # the gradients by the same 2.2e-3 of the largest one, to five digits,
    # while every conv output agrees to 5e-7 (PERF.md, section 6).
    # The fresh-weights step runs at f32 and at the shipped bf16 (held as
    # the plain train step's), the shipped-weights step at f32.
    def state_of(weights, use_kernel, cfg_d):
        if weights == "fresh":
            state = create_train_state(cfg_d, seed=SEED, device="cuda")
        else:
            model = load_model_dir(MODEL_DIR, device="cuda")[1]
            set_compute_dtype(model, cfg_d.compute_dtype)
            state = create_train_state(cfg_d, device="cuda", model=model)
        set_use_kernel(state.model, use_kernel)
        return state

    fresh = {}
    for weights, dtype in (("fresh", "float32"), ("fresh", "bfloat16"), ("shipped", "float32")):
        cfg_d = dataclasses.replace(cfg, compute_dtype=dtype)
        step_d = make_ccsampler_train_step(cfg_d, delta_t=CC_DELTA_T)
        results, shares = [], []
        for use_kernel in (True, False):
            state = state_of(weights, use_kernel, cfg_d)
            drop = torch.Generator(device="cuda")
            drop.manual_seed(SEED + 5)
            reset_kernel_counts()
            state, metrics = step_d(state, train_batch, drop, p_from_infer=CC_RATE, draws=draws)
            torch.cuda.synchronize()
            on = 1 if use_kernel else 0
            expect_counts(f"calibrated step, {weights} weights, {dtype}, use_kernel={use_kernel}",
                          steps=on, eval_batches=on)
            if float(metrics["grad_finite"]) != 1.0:
                raise AssertionError(f"calibrated step, {weights} weights: the loss is not finite")
            shares.append(float(metrics["cc_share"]))
            results.append((float(metrics["loss"]),
                            {k: p.grad.clone() for k, p in state.model.named_parameters()}))
            del state
        if shares[0] != shares[1] or not 0.0 < shares[0] < 1.0:
            raise AssertionError(f"calibrated step, {weights} weights: branch shares {shares}")
        what = (f"calibrated train step, {weights} weights, {dtype} ({shares[0]:.2f} of the "
                f"graphs on the calibrated branch)")
        if weights == "fresh":
            fresh[dtype, True], fresh[dtype, False] = results
            if dtype == "float32":
                compare_step_gradients(what, results)
            else:
                compare_bf16_step(what, fresh)
            continue
        (loss_k, grads_k), (loss_p, grads_p) = results
        if not abs(loss_k - loss_p) <= TOL_STEP_GRAD * abs(loss_p):
            raise AssertionError(f"{what}: loss: kernel {loss_k} vs plain {loss_p}")
        gmax = max(float(g.abs().max()) for g in grads_p.values() if g.numel())
        worst = max(float((grads_k[k] - g).abs().max()) for k, g in grads_p.items() if g.numel())
        stage = []
        for use_kernel in (True, False):
            model = state_of(weights, use_kernel, cfg_d).model.eval()
            with torch.no_grad():
                stage.append(ccsampler_apply_noise(train_batch, cfg.sigma_schedule, model, CC_RATE,
                                                   CC_DELTA_T, cfg.no_torsion, draws=draws))
        (nk, tk, uk), (npl, tpl, upl) = stage
        pos_err = float((nk.lig_pos - npl.lig_pos).abs().max())
        rel = {f: float((getattr(tk, f) - getattr(tpl, f)).abs().max()
                        / getattr(tpl, f).abs().max())
               for f in ("tr_score", "rot_score", "tor_score")}
        if not torch.equal(uk, upl) or not torch.equal(nk.t, npl.t) or pos_err > TOL_CC_POS \
                or max(rel.values()) > TOL_CC_TARGET:
            raise AssertionError(f"{what}: frozen stage differs: positions {pos_err} A, "
                                 f"targets {rel}")
        print(f"{what}, kernels vs plain convs, same draws: loss {loss_k:.6f} vs {loss_p:.6f}; "
              f"frozen stage: same branch per graph, poses within {pos_err:.1e} A, targets within "
              f"{max(rel.values()):.1e} of their scale; worst gradient |kernel - plain| over the "
              f"largest gradient {worst / gmax:.2e} (reported, not held)", flush=True)

    # ---- (a) the training CLI: a fine-tune from the shipped weights with the
    # calibrated step engaged from epoch 0
    with tempfile.TemporaryDirectory() as tmp:
        copy_bucket(TRAIN_CACHE_DIR, os.path.join(tmp, "train_smoke"), TRAIN_COMPLEXES)
        run_dir = os.path.join(tmp, "run")
        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        train_cli.main([
            "--cache_path", tmp, "--run_dir", run_dir, "--n_epochs", "1",
            "--batch_size", str(TRAIN_BATCH), "--seed", str(SEED), "--val_inference_freq", "0",
            "--ns", str(cfg.ns), "--nv", str(cfg.nv),
            "--num_conv_layers", str(cfg.num_conv_layers), "--dropout", str(cfg.dropout),
            "--lr", "0.0001", "--pretrain_model_pt", os.path.join(MODEL_DIR, BEST_EMA_MODEL),
            "--rate_from_infer", str(CC_RATE), "--epoch_from_infer", "0", "--dynamic_coeff", "0",
            "--delta_t", str(CC_DELTA_T)])
        torch.cuda.synchronize()
        steps = TRAIN_COMPLEXES // TRAIN_BATCH
        counts = expect_counts("cli.train.main with --rate_from_infer", steps=steps,
                               eval_batches=steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            (rec,) = [json.loads(line) for line in f]
    keys = ("loss", "tr_loss", "rot_loss", "tor_loss")
    if rec["steps"] != steps or rec["grad_finite"] != 1.0 or rec["p_from_infer"] != CC_RATE \
            or not all(np.isfinite(rec[k]) for k in keys):
        raise AssertionError(f"calibrated training metrics not as expected: {rec}")
    expected_share = CC_RATE * (1.0 - CC_DELTA_T)
    if not abs(rec["cc_share"] - expected_share) <= CC_SHARE_BAND:
        raise AssertionError(f"share of graphs on the calibrated branch {rec['cc_share']}, "
                             f"expected {expected_share} +- {CC_SHARE_BAND}")
    rate = rec["steps"] / rec["epoch_time"]
    print(f"cli.train.main --rate_from_infer {CC_RATE}: {rec['steps']} calibrated steps of batch "
          f"{TRAIN_BATCH} in {rec['epoch_time']:.3f} s = {rate:.2f} steps/s, "
          f"{rate * TRAIN_BATCH:.1f} complexes/s (data loading included), train loss "
          f"{rec['loss']:.4f}, share of graphs on the calibrated branch {rec['cc_share']:.3f} "
          f"(expected {expected_share:.3f} +- {CC_SHARE_BAND}), peak memory {peak:.2f} GiB; "
          f"launches {counts}: per step K1 {counts['k1'] // steps}, K2 "
          f"{counts['fwd'] // steps}+{counts['bwd_edge'] // steps}+{counts['bwd_x'] // steps}, "
          f"K3 {counts['k3_fwd'] // steps} forward + {counts['k3_bwd_edge'] // steps} edge "
          f"backward + {counts['k3_bwd_x'] // steps} dx ({card})",
          flush=True)
    return counts


def phase_sampler_modes(cfg, model, job, card):
    """The ODE and per-step candidate selection on one complex."""
    import numpy as np
    import torch

    from diffphore_torch.cli.pipeline import FitEngine
    from diffphore_torch.ops import tp_fused
    from diffphore_torch.sampler.sampling import SamplerSettings

    fits = {}
    for label, kw in (("sde", {}), ("ode", {"ode": True}), ("random_samples=4",
                                                            {"random_samples": 4})):
        engine = FitEngine(cfg, model, samples_per_complex=POSES,
                           settings=SamplerSettings(inference_steps=STEPS, **kw), seed=SEED,
                           device="cuda")
        tp_fused.KERNEL.launches = 0
        (r,) = engine.run_complexes([job])
        torch.cuda.synchronize()
        if tp_fused.KERNEL.launches != CONVS_PER_FORWARD * STEPS:
            raise AssertionError(f"{label}: K1 launched {tp_fused.KERNEL.launches} times")
        if r["poses"].shape != (POSES, job.n_atoms, 3) or not np.isfinite(r["poses"]).all() \
                or not np.isfinite(r["fitscore"]).all():
            raise AssertionError(f"{label}: poses or fitness not finite")
        fits[label] = np.asarray(r["fitscore"])
    med = {k: float(np.median(v)) for k, v in fits.items()}
    print(f"sampler modes, {job.name}, {POSES} poses x {STEPS} steps: median / best fitness "
          + "; ".join(f"{k} {med[k]:.3f} / {fits[k].max():.3f}" for k in fits)
          + f" ({card})", flush=True)
    if not med["random_samples=4"] >= med["sde"] - TOL_CANDIDATE_MEDIAN:
        raise AssertionError(f"candidate selection lowered the median fitness: {med}")


def phase_confidence_serving(cfg, model, jobs, card):
    """Serving with the shipped confidence head: FitEngine with and without
    it on the same complexes (poses/s of each), K1's exact launches with it,
    a finite confidence row that ``rank`` follows, and the head's row from K1
    against plain convs on the same final poses.  Returns the K1 launches of
    the run with the head."""
    import numpy as np
    import torch

    from diffphore_torch.cli.pipeline import FitEngine
    from diffphore_torch.data.graphs import repeat_batch
    from diffphore_torch.models.layers import set_compute_dtype
    from diffphore_torch.ops.fitscore import batch_phore_arrays
    from diffphore_torch.sampler.sampling import SamplerSettings
    from diffphore_torch.utils.checkpoints import load_confidence_dir

    head_cfg, head = load_confidence_dir(CONFIDENCE_DIR, device="cuda")
    if head_cfg.compute_dtype != "bfloat16" or head_cfg.ns != cfg.ns:
        raise AssertionError(f"the shipped head is not at corpus2's width and bf16: {head_cfg}")
    settings = SamplerSettings(inference_steps=STEPS)
    plain = FitEngine(cfg, model, samples_per_complex=POSES, settings=settings, seed=SEED,
                      device="cuda")
    ranked = FitEngine(cfg, model, samples_per_complex=POSES, settings=settings, seed=SEED,
                       device="cuda", confidence=head)
    ranked.run_complexes(jobs[:1])                  # warm-up
    rates = {}
    for label, engine in (("without the head", plain), ("with the head", ranked)):
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.perf_counter()
        results = engine.run_complexes(jobs)
        torch.cuda.synchronize()
        rates[label] = len(jobs) * POSES / (time.perf_counter() - t0)
        per_dispatch = CONVS_PER_FORWARD * STEPS + (HEAD_CONVS if engine is ranked else 0)
        counts = expect_counts(f"serving {label}", k1=len(jobs) * per_dispatch)
    for r in results:
        conf = np.asarray(r["confidence"])
        if conf.shape != (POSES,) or not np.isfinite(conf).all():
            raise AssertionError(f"{r['name']}: confidence row not finite or misshapen")
        if list(r["rank"]) != list(np.argsort(conf)[::-1]):
            raise AssertionError(f"{r['name']}: rank does not follow the confidence row")

    # the head's row from K1 against plain convs on the same final poses
    seen = []
    hook = head.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    job = jobs[0]
    rows = repeat_batch(job.batch.to("cuda"), POSES).replace(names=(), meta=())
    ranked.run_batch(rows, batch_phore_arrays(rows), POSES)
    hook.remove()
    final = seen[0]
    out = {}
    with torch.inference_mode():
        for dtype in ("float32", "bfloat16"):
            set_compute_dtype(head, dtype)
            for use_kernel in (True, False):
                set_use_kernel(head, use_kernel)
                out[dtype, use_kernel] = head(final, pose_group=POSES)
    worst = []
    for i, label in enumerate(("fit", "ph", "ex")):
        b32, b16 = out["float32", False][i], out["bfloat16", False][i]
        scale = float(b32.abs().max().clamp_min(1e-30))
        rel = float((out["float32", True][i] - b32).abs().max()) / scale
        rel_bf = float((out["bfloat16", True][i] - b16).abs().max()) / scale
        gap = float((b32 - b16).abs().max()) / scale
        worst.append(f"{label} {rel:.1e} / {rel_bf:.1e} (gap {gap:.1e})")
        if not rel <= TOL_FORWARD or not rel_bf <= TOL_BF16_GAP * gap:
            raise AssertionError(f"head {label}: kernel vs plain {rel} (f32), {rel_bf} (bf16) "
                                 f"against the plain route's f32-vs-bf16 difference {gap}")
    print(f"serving with the confidence head ({CONFIDENCE_DIR.split('runs/')[-1]}), "
          f"{len(jobs)} complexes x {POSES} poses x {STEPS} steps: "
          + ", ".join(f"{rate:.1f} poses/s {label}" for label, rate in rates.items())
          + f"; K1 launches {counts['k1']} ({counts['k1'] // len(jobs)} per dispatch: "
          f"{CONVS_PER_FORWARD} x {STEPS} + {HEAD_CONVS}); rank follows the confidence row; "
          f"head on the final poses of {job.name}, kernel vs plain convs, max |d| / max|plain| "
          f"f32 / bf16: " + "; ".join(worst) + f" ({card})", flush=True)
    return counts["k1"]


def phase_confidence_training(cfg, train_batch, card):
    """(c) one head train step, kernels against plain convs; (b) 30 steps on
    a fixed batch: the loss falls; (a) one epoch of ``cli.train.main
    --confidence_mode``.  Returns the launch counts of the CLI run."""
    import numpy as np
    import torch

    from diffphore_torch.cli import train as train_cli
    from diffphore_torch.data.transforms import draw_noise
    from diffphore_torch.train.confidence import (create_confidence_train_state,
                                                  make_confidence_train_step)
    from diffphore_torch.utils.checkpoints import BEST_EMA_MODEL, load_confidence_dir

    B, T = train_batch.batch_size, train_batch.num_torsions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    draws = draw_noise(B, T, gen, "cuda")

    # ---- (c) one step from fresh weights, kernels against plain convs, same
    # noise and dropout masks, at f32 (every gradient leaf) and bf16 (one vector)
    results = {}
    for dtype in ("float32", "bfloat16"):
        cfg_d = dataclasses.replace(cfg, compute_dtype=dtype)
        step_d = make_confidence_train_step(cfg_d, label_mode=HEAD_LABEL)
        for use_kernel in (True, False):
            state = create_confidence_train_state(cfg_d, seed=SEED, device="cuda")
            set_use_kernel(state.model, use_kernel)
            drop = torch.Generator(device="cuda")
            drop.manual_seed(SEED + 7)
            reset_kernel_counts()
            state, metrics = step_d(state, train_batch, drop, draws=draws)
            torch.cuda.synchronize()
            expect_counts(f"head {dtype} step with use_kernel={use_kernel}",
                          steps=1 if use_kernel else 0, k2_convs=HEAD_K2_CONVS)
            results[dtype, use_kernel] = (float(metrics["loss"]),
                                          {k: p.grad.clone()
                                           for k, p in state.model.named_parameters()})
            del state
    compare_step_gradients("head train step (f32)",
                           [results["float32", True], results["float32", False]])
    compare_bf16_step("head train step (bf16)", results)

    # ---- (b) one fixed batch, fixed noise, dropout on
    step = make_confidence_train_step(cfg, label_mode=HEAD_LABEL)
    state = create_confidence_train_state(cfg, seed=SEED, device="cuda")
    drop = torch.Generator(device="cuda")
    drop.manual_seed(SEED + 8)
    state, _ = step(state, train_batch, drop, draws=draws)          # warm-up
    torch.cuda.synchronize()
    reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(FIXED_BATCH_STEPS):
        state, metrics = step(state, train_batch, drop, draws=draws)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    expect_counts("head fixed-batch steps", steps=FIXED_BATCH_STEPS, k2_convs=HEAD_K2_CONVS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"head fixed-batch loss did not fall: {losses}")
    print(f"head, fixed batch of {B}, fixed noise, dropout {cfg.dropout}, labels {HEAD_LABEL}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {FIXED_BATCH_STEPS} steps; "
          f"{FIXED_BATCH_STEPS / elapsed:.2f} steps/s, {B * FIXED_BATCH_STEPS / elapsed:.1f} "
          f"complexes/s, peak memory {peak:.3f} GiB; per step K2 {HEAD_K2_CONVS} forward + "
          f"{HEAD_K2_CONVS} edge backward + {HEAD_K2_CONVS} dx, K3 {K3_CONVS} + {K3_CONVS} + "
          f"{K3_CONVS}, K1 0 ({card})", flush=True)
    del state

    # ---- (a) the training CLI in --confidence_mode: one epoch + a val epoch
    with tempfile.TemporaryDirectory() as tmp:
        copy_bucket(TRAIN_CACHE_DIR, os.path.join(tmp, "train_smoke"), TRAIN_COMPLEXES)
        copy_bucket(CACHE_DIR, os.path.join(tmp, "val_smoke"), VAL_COMPLEXES)
        run_dir = os.path.join(tmp, "run")
        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        train_cli.main([
            "--confidence_mode", "--cache_path", tmp, "--run_dir", run_dir, "--n_epochs", "1",
            "--batch_size", str(TRAIN_BATCH), "--seed", str(SEED), "--ns", str(cfg.ns),
            "--nv", str(cfg.nv), "--num_conv_layers", str(cfg.num_conv_layers),
            "--dropout", str(cfg.dropout), "--confidence_label", HEAD_LABEL])
        torch.cuda.synchronize()
        steps = TRAIN_COMPLEXES // TRAIN_BATCH
        counts = expect_counts("cli.train.main --confidence_mode", steps=steps,
                               k2_convs=HEAD_K2_CONVS, k1=HEAD_CONVS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if [r["mode"] for r in records] != ["confidence", "confidence_val"]:
            raise AssertionError(f"metrics.jsonl holds {records}")
        rec, val = records
        keys = ("loss", "loss_ph", "loss_ex", "loss_total")
        if rec["steps"] != steps or not all(np.isfinite(r[k]) for r in records for k in keys):
            raise AssertionError(f"head training metrics not as expected: {records}")
        _, reloaded = load_confidence_dir(run_dir, device="cuda", checkpoint=BEST_EMA_MODEL)
        with torch.no_grad():
            out = reloaded(train_batch.replace(t=torch.zeros((B,), device="cuda")))
        if not all(bool(torch.isfinite(o).all()) for o in out):
            raise AssertionError("the reloaded head's forward is not finite")
    rate = rec["steps"] / rec["epoch_time"]
    print(f"cli.train.main --confidence_mode: {rec['steps']} steps of batch {TRAIN_BATCH} in "
          f"{rec['epoch_time']:.3f} s = {rate:.2f} steps/s, {rate * TRAIN_BATCH:.1f} complexes/s "
          f"(data loading included), train loss {rec['loss']:.4f}, val loss {val['loss']:.4f} "
          f"over {VAL_COMPLEXES} complexes (batch statistics, K1), peak memory {peak:.3f} GiB; "
          f"launches {counts} ({card})", flush=True)
    return counts


def phase_val_inference(cfg, card):
    """One epoch of ``cli.train.main --val_inference_freq 1``: one train
    step, then validation by inference on VALINF_COMPLEXES complexes x
    VALINF_POSES poses x STEPS steps with the EMA weights; exact launches, a
    finite valinf record and the wall time of the validation."""
    import numpy as np
    import torch

    from diffphore_torch.cli import train as train_cli

    timed = []
    sample = train_cli.val_inference

    def timed_val_inference(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(*args, **kw)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        copy_bucket(TRAIN_CACHE_DIR, os.path.join(tmp, "train_smoke"), TRAIN_BATCH)
        copy_bucket(CACHE_DIR, os.path.join(tmp, "val_smoke"), VALINF_COMPLEXES)
        run_dir = os.path.join(tmp, "run")
        reset_kernel_counts()
        train_cli.val_inference = timed_val_inference
        try:
            train_cli.main([
                "--cache_path", tmp, "--run_dir", run_dir, "--n_epochs", "1",
                "--batch_size", str(TRAIN_BATCH), "--seed", str(SEED), "--ns", str(cfg.ns),
                "--nv", str(cfg.nv), "--num_conv_layers", str(cfg.num_conv_layers),
                "--dropout", str(cfg.dropout), "--val_loss_freq", "2",
                "--val_inference_freq", "1", "--num_inference_complexes",
                str(VALINF_COMPLEXES), "--inference_samples", str(VALINF_POSES),
                "--inference_steps", str(STEPS)])
        finally:
            train_cli.val_inference = sample
        torch.cuda.synchronize()
        counts = expect_counts("cli.train.main --val_inference_freq 1", steps=1,
                               k1=VALINF_COMPLEXES * CONVS_PER_FORWARD * STEPS)
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            (vi,) = [r for r in map(json.loads, f) if "valinf_n" in r]
        if not os.path.exists(os.path.join(run_dir, "best_ema_inference_epoch_model.msgpack")):
            raise AssertionError("validation by inference saved no best EMA checkpoint")
    if vi["valinf_n"] != VALINF_COMPLEXES or not all(
            np.isfinite(v) for k, v in vi.items() if k.startswith("valinf_")):
        raise AssertionError(f"valinf record not as expected: {vi}")
    print(f"validation by inference: {VALINF_COMPLEXES} complexes x {VALINF_POSES} poses x "
          f"{STEPS} steps in {timed[0]:.3f} s ({VALINF_COMPLEXES * VALINF_POSES / timed[0]:.1f} "
          f"poses/s, EMA weights, a fresh FitEngine); record "
          + json.dumps({k: vi[k] for k in sorted(vi)}) + f"; launches {counts} ({card})",
          flush=True)
    return counts


# The screening CLI from files: the three rows of examples/task.csv, a
# drug-size SMILES (gefitinib: 31 heavy atoms, a quinazoline, 8 rotatable
# bonds; embedded on the host), a MOL2 the phase writes from EX02.sdf, and an
# unparsable SMILES that is logged and skipped.
SCREEN_SMILES = "COc1cc2ncnc(Nc3ccc(F)c(Cl)c3)c2cc1OCCCN1CCOCC1"
SCREEN_BAD_SMILES = "C1CC(=O"
SCREEN_SAMPLED = 5
# A pose re-scored from its ranked SDF (4-decimal coordinates) against the
# .score file's fitness (6 significant digits), and bond lengths of every
# pose against the input's (rigid moves and torsion rotations keep them; the
# coordinates are rounded to 1e-4 A).
TOL_RESCORE = 1e-3
TOL_BOND = 1e-3


def write_mol2(mol, path):
    """A TRIPOS MOL2 file of ``mol`` (element atom types, aromatic bonds
    "ar")."""
    from diffphore_torch.chem.mol import AROMATIC_BOND

    lines = ["@<TRIPOS>MOLECULE", os.path.basename(path).split(".")[0],
             f"{mol.num_atoms} {len(mol.bonds)} 0 0 0", "SMALL", "NO_CHARGES", "",
             "@<TRIPOS>ATOM"]
    for i, (a, (x, y, z)) in enumerate(zip(mol.atoms, mol.coords)):
        lines.append(f"{i + 1} {a.symbol}{i + 1} {x:.4f} {y:.4f} {z:.4f} {a.symbol} 1 LIG 0.0000")
    lines.append("@<TRIPOS>BOND")
    for k, (i, j, o) in enumerate(mol.bonds):
        lines.append(f"{k + 1} {i + 1} {j + 1} {'ar' if o == AROMATIC_BOND else o}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def screen_rows(tmp):
    """(CSV path, rows) of the six rows of the screen from files: the
    examples' three SDFs, a drug-size SMILES, a MOL2 written here and an
    unparsable SMILES."""
    import csv

    from diffphore_torch.chem.sdf import parse_sdf

    lig = parse_sdf(os.path.join(HERE, "examples", "EX02.sdf"))[0]
    mol2 = os.path.join(tmp, "EX02_mol2.mol2")
    write_mol2(lig, mol2)
    phore_file = os.path.join(HERE, "examples", "example.phore")
    with open(os.path.join(HERE, "examples", "task.csv")) as f:
        rows = [dict(r, ligand_description=os.path.join(HERE, r["ligand_description"]),
                     phore=os.path.join(HERE, r["phore"])) for r in csv.DictReader(f)]
    rows += [{"name": "gefitinib", "ligand_description": SCREEN_SMILES, "phore": phore_file},
             {"name": "EX02_mol2", "ligand_description": mol2, "phore": phore_file},
             {"name": "bad", "ligand_description": SCREEN_BAD_SMILES, "phore": phore_file}]
    task = os.path.join(tmp, "task.csv")
    with open(task, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "ligand_description", "phore"])
        w.writeheader()
        w.writerows(rows)
    return task, rows


def phase_screening_cli(card, device="cuda", poses=POSES, steps=STEPS):
    """``diffphore_torch.cli.inference.main`` on six rows: five complexes
    sampled and one skipped, exact K1 launches, the artifact set, the ranked
    poses re-scored against the phore file, bond lengths kept, the same
    screen through the engine with featurization inline and on two threads
    ahead of the dispatches, K1 against its plain version at the screen's
    own shapes, a resume that samples nothing, and a run with the confidence
    head.  Returns the K1 launches of the first run."""
    import contextlib
    import csv
    import io

    import numpy as np
    import torch

    from diffphore_torch.chem.pharmacophore_rules import ligand_phore_features, scoring_phore_fp
    from diffphore_torch.chem.sdf import parse_sdf
    from diffphore_torch.cli import inference as cli
    from diffphore_torch.data.featurize import load_ligand
    from diffphore_torch.constants import VDW_TABLE
    from diffphore_torch.data.phore import parse_phore
    from diffphore_torch.ops.fitscore import fitscore, make_phore_arrays

    per_dispatch = CONVS_PER_FORWARD * steps if device == "cuda" else 0
    engines, feat_s, dispatch_s = [], {}, []
    original = cli.FitEngine

    class Recording(original):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

        def prepare(self, name, *a, **k):
            t0 = time.perf_counter()
            job = super().prepare(name, *a, **k)
            feat_s[name] = time.perf_counter() - t0
            return job

        def run_complexes(self, jobs, *a, **k):
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().run_complexes(jobs, *a, **k)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            dispatch_s.append(time.perf_counter() - t0)
            return out

    def run(argv):
        """main(argv) with the counts at 0: its wall s, stdout, featurization
        s per complex and dispatch s per call."""
        log = io.StringIO()
        cli.FitEngine = Recording
        feat_s.clear()
        dispatch_s.clear()
        reset_kernel_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                cli.main(argv)
        finally:
            cli.FitEngine = original
        if device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0, log.getvalue(), dict(feat_s), list(dispatch_s)

    def into(argv, out_dir):
        i = argv.index("--out_dir")
        return argv[:i + 1] + [out_dir] + argv[i + 2:]

    def feat_share(out_dir, feat):
        """Featurization's share of the summed run_time of the dock logs."""
        run_time = 0.0
        for name in feat:
            log_file = os.path.join(out_dir, "mapping_process", name, f"{name}_dock.log")
            if os.path.exists(log_file):
                with open(log_file) as f:
                    run_time += json.load(f)["run_time"]
        return sum(t for n, t in feat.items() if n != bad_name) / run_time

    with tempfile.TemporaryDirectory() as tmp:
        task, rows = screen_rows(tmp)
        phore_file = rows[0]["phore"]
        row_names = [cli.complex_name(r) for r in rows]
        bad_name = row_names[-1]
        out = os.path.join(tmp, "screen")
        argv = ["--phore_ligand_csv", task, "--model_dir", MODEL_DIR, "--out_dir", out,
                "--sample_per_complex", str(poses), "--inference_steps", str(steps),
                "--device", device, "--prefetch_workers", "0"]

        # ---- the screen
        wall, log, feat, dispatch = run(argv)
        counts = expect_counts("cli.inference.main", k1=SCREEN_SAMPLED * per_dispatch)
        if f"Featurization failed for `{bad_name}`" not in log:
            raise AssertionError("the unparsable SMILES was not logged as skipped:\n" + log)
        with open(os.path.join(out, "ranked_results.csv")) as f:
            ranked = list(csv.reader(f, delimiter="\t"))
        if ranked[0] != cli.RANKED_COLUMNS or len(ranked) != SCREEN_SAMPLED + 1:
            raise AssertionError(f"ranked_results.csv: {ranked}")
        with open(os.path.join(out, "inference_results.json")) as f:
            journal = json.load(f)
        names = [r[2] for r in ranked[1:]]
        if sorted(journal["name"]) != sorted(names) or len(set(names)) != SCREEN_SAMPLED:
            raise AssertionError(f"sampled {journal['name']}, ranked {names}")
        engine = engines[-1]
        timers = engine.timers.report()
        share = feat_share(out, feat)
        phore = parse_phore(phore_file)[0]
        ref = make_phore_arrays(phore).to(device)
        max_err = max_bond = 0.0
        for rec, name in zip(rows[:-1], row_names):
            sdf = parse_sdf(os.path.join(out, "ranked_poses", f"{name}_ranked.sdf"))
            with open(os.path.join(out, "mapping_process", name, f"{name}.score")) as f:
                table = [line.rstrip("\n").split("\t") for line in f]
            if len(sdf) != poses or len(table) != poses or {len(r) for r in table} != {19}:
                raise AssertionError(f"{name}: {len(sdf)} ranked poses, .score "
                                     f"{len(table)} x {sorted({len(r) for r in table})}")
            mol = load_ligand(rec["ligand_description"])
            if [a.atomic_num for a in sdf[0].atoms] != [a.atomic_num for a in mol.atoms]:
                raise AssertionError(f"{name}: ranked poses' atoms differ from the input's")
            xyz = torch.tensor(np.stack([m.coords for m in sdf]), dtype=torch.float32,
                               device=device)
            fp = torch.tensor(scoring_phore_fp(mol), dtype=torch.float32, device=device)
            count_fp = torch.tensor(ligand_phore_features(mol)[0], dtype=torch.float32,
                                    device=device)
            vdw = torch.tensor(VDW_TABLE[[a.atomic_num - 1 for a in mol.atoms]], device=device)
            sc = fitscore(xyz, torch.ones(xyz.shape[:2], dtype=torch.bool, device=device),
                          fp.expand(poses, -1, -1), vdw.expand(poses, -1), ref.repeat(poses),
                          count_fp=count_fp.expand(poses, -1, -1))
            rescored = sc["phscore1"].cpu().numpy()
            want = np.sort([float(r[15]) for r in table])[::-1]
            max_err = max(max_err, float(np.abs(rescored - want).max()))
            bonds = np.asarray([(i, j) for i, j, _ in mol.bonds])
            d0 = np.linalg.norm(mol.coords[bonds[:, 0]] - mol.coords[bonds[:, 1]], axis=-1)
            for m in sdf:
                d = np.linalg.norm(m.coords[bonds[:, 0]] - m.coords[bonds[:, 1]], axis=-1)
                max_bond = max(max_bond, float(np.abs(d - d0).max()))
        if not max_err <= TOL_RESCORE:
            raise AssertionError(f"ranked poses re-scored differ from the .score file: {max_err}")
        if not max_bond <= TOL_BOND:
            raise AssertionError(f"a pose's bond lengths moved by {max_bond} A")

        # ---- featurization inline, as the CLI does it, against two threads
        # featurizing ahead of the dispatches, as a prefetch pool would: the
        # six rows through the screen's engine, once each, timed end to end
        from concurrent.futures import ThreadPoolExecutor

        def screen(threads):
            t0 = time.perf_counter()
            args = [(n, r["ligand_description"], phore_file) for n, r in zip(row_names, rows)]
            with ThreadPoolExecutor(2) as pool:
                jobs = ((f.result() for f in [pool.submit(engine.prepare, *a) for a in args])
                        if threads else (engine.prepare(*a) for a in args))
                n_jobs = 0
                for job in jobs:
                    if job is not None:
                        engine.run_complexes([job])
                        n_jobs += 1
            if n_jobs != SCREEN_SAMPLED:
                raise AssertionError(f"{n_jobs} jobs prepared, expected {SCREEN_SAMPLED}")
            return time.perf_counter() - t0

        walls = {"inline": [], "threads": []}
        for label in ("inline", "threads"):
            walls[label].append(screen(label == "threads"))

        # ---- K1 against its plain version at the screen's own shapes: the
        # 23 conv inputs of one forward of the SMILES job (32 atoms) and of an
        # SDF job (16), conv by conv at f32 and bf16 (TOL_F32, TOL_BF16) and
        # the whole forward (TOL_FORWARD, TOL_BF16_GAP)
        k1_checks = []
        if device == "cuda":
            from diffphore_torch.ops import tp_fused

            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)
            for i in (3, 0):
                job = engine.prepare(row_names[i], rows[i]["ligand_description"], phore_file)
                batch = posed_rows(job.batch.to("cuda"), poses, engine.cfg, gen)
                errs = [check_k1_call(tp_fused, n, m, a)
                        for n, m, a in capture_conv_calls(engine.model, batch, poses)]
                check_forward(engine.model, batch, engine.cfg.compute_dtype, poses,
                              what=f"screen forward, {row_names[i]}")
                k1_checks.append(
                    f"{row_names[i]} at {batch.num_atoms} x {batch.num_phore} x "
                    f"{batch.num_torsions}: max |kernel - plain| / max|plain| "
                    f"{max(c['err'] / max(c['scale'], 1e-30) for c in errs):.2e} f32, "
                    f"{max(c['err_bf'] / max(c['scale_bf'], 1e-30) for c in errs):.2e} bf16")

        # ---- resume: nothing is sampled, the table is the same
        with open(os.path.join(out, "ranked_results.csv"), "rb") as f:
            table_bytes = f.read()
        n_engines = len(engines)
        run(argv)
        expect_counts("cli.inference.main, resumed", k1=0)
        with open(os.path.join(out, "ranked_results.csv"), "rb") as f:
            if f.read() != table_bytes or len(engines) != n_engines:
                raise AssertionError("the resumed run changed ranked_results.csv or sampled")

        # ---- with the confidence head
        out_head = os.path.join(tmp, "screen_head")
        wall_head, _, _, _ = run(into(argv, out_head)
                                 + ["--confidence_model_dir", CONFIDENCE_DIR])
        per_head = per_dispatch + (HEAD_CONVS if device == "cuda" else 0)
        head_counts = expect_counts("cli.inference.main with the head",
                                    k1=SCREEN_SAMPLED * per_head)
        for name in names:
            sdf_head = parse_sdf(os.path.join(out_head, "ranked_poses", f"{name}_ranked.sdf"))
            conf = [float(m.props["confidence"]) for m in sdf_head]
            if len(conf) != poses or conf != sorted(conf, reverse=True):
                raise AssertionError(f"{name}: confidence property not in descending order")

    def ms(ts):
        return " ".join(f"{1e3 * t:.1f}" for t in ts)

    feat_ms = {n: 1e3 * t for n, t in feat.items()}
    screen_s = sum(dispatch)
    print(f"screening CLI ({device}): {SCREEN_SAMPLED} of 6 complexes sampled (the unparsable "
          f"SMILES skipped and logged) x {poses} poses x {steps} steps; featurization ms per "
          f"complex on the host: SDF " + " ".join(f"{feat_ms[n]:.1f}" for n in row_names[:3])
          + f", SMILES with embedding {feat_ms[row_names[3]]:.1f}, MOL2 "
          f"{feat_ms[row_names[4]]:.1f}; featurization share of run_time {share:.3f}; dispatch "
          f"ms per complex {ms(dispatch)}; screen {SCREEN_SAMPLED * poses / screen_s:.1f} "
          f"poses/s over the dispatches, {SCREEN_SAMPLED * poses / wall:.1f} poses/s over main() "
          f"({wall:.3f} s, model load and writes included), {wall_head:.3f} s with the head; "
          f"K1 launches {counts['k1']} ({per_dispatch} per complex), {head_counts['k1']} with "
          f"the head; re-scored vs .score max |d| {max_err:.2e}; bond lengths max |d| "
          f"{max_bond:.2e} A; resume: 0 launches, same table; the screen's timers: {timers} "
          f"({card})", flush=True)
    print(f"screening CLI ({device}): the six rows through its engine, featurization inline "
          f"as the CLI does it against two threads featurizing ahead of the dispatches, s in "
          f"turns: inline {walls['inline'][0]:.3f}, threads {walls['threads'][0]:.3f}; "
          f"K1 at the screen's shapes against its plain version: "
          + ("; ".join(k1_checks) or "not run on the CPU") + f" ({card})", flush=True)
    return counts["k1"]


# Phase 12: training and evaluation from raw files, in the shipped recipe's
# one (48, 160, 16) bucket (runs/corpus2/pipeline.sh's bucket flags).
RECIPE_BUCKET_FLAGS = ["--bucket_a_min", "48", "--bucket_a_step", "8", "--bucket_p_min", "160",
                       "--bucket_p_step", "32", "--bucket_t_min", "16", "--bucket_t_step", "4"]
RAW_BUCKET = (48, 160, 16)
RAW_TRAIN_ROWS = 2          # the first two flexible rows of runs/corpus2/train.csv
RAW_EPOCHS = 2              # one batch of 24 (repeat-padded) an epoch
RAW_WORKERS = 4             # featurization processes
RAW_STEP_REPEATS = 3        # timed train steps at the recipe's bucket
#: what the report lists of each kernel at the recipe's bucket
RAW_BUCKET_KEYS = ("max_abs_err", "max_rel_err", "max_abs_err_bf16", "ms", "ms_bf16", "plain_ms",
                   "bound_ms", "bound_ms_bf16", "library_ms", "library_ms_bf16")


def phase_raw_files(card, device="cuda", poses=POSES, steps=STEPS, workers=RAW_WORKERS):
    """``cli.train.main`` from a small CSV in the corpus2 recipe (sub-phore
    and conformer augmentation, its buckets, spawn workers): the featurized
    count, K2 and K3 exactly per step, K1 per validation batch; K2 and K3
    held against their plain versions on one training-mode forward of a
    recipe batch at 48 x 160 x 16; the step's peak memory; a second run
    whose featurization does nothing; ``cli.evaluate.main`` with the corpus2
    model and head on three test rows and an SDF (symmetry RMSD): K1 exactly
    481 launches per evaluated complex, the artifact set and finite metrics,
    K1 against its plain version at the bucket; the train records'
    featurization again by one process (the same files as the trainer's
    workers wrote), and one record of each kind serially.  Returns the launch counts of
    the training and the evaluation."""
    import contextlib
    import csv
    import io

    import numpy as np
    import torch

    from diffphore_torch.cli import evaluate as eval_cli
    from diffphore_torch.cli import train as train_cli
    from diffphore_torch.data import dataset as ds
    from diffphore_torch.data.loaders import BucketLoader
    from diffphore_torch.data.transforms import apply_noise, draw_noise
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.utils import flat_yaml
    from diffphore_torch.utils.checkpoints import load_model_dir

    on_card = device == "cuda"
    built = []
    original = train_cli.PhoreDataset

    class Recording(original):
        def __init__(self, *a, **k):
            t0 = time.perf_counter()
            super().__init__(*a, **k)
            built.append((self, time.perf_counter() - t0))

    def rows(name, n, pick=lambda r: True):
        with open(os.path.join(HERE, "runs", "corpus2", name)) as f:
            reader = csv.DictReader(f)
            return reader.fieldnames, [r for r in reader if pick(r)][:n]

    def snapshot(root):
        return {os.path.relpath(os.path.join(d, f), root): os.stat(os.path.join(d, f)).st_mtime_ns
                for d, _, files in os.walk(root) for f in files}

    with tempfile.TemporaryDirectory() as tmp:
        fields, train_rows = rows("train.csv", RAW_TRAIN_ROWS,
                                  lambda r: r["name"].startswith("flex_"))
        _, val_rows = rows("val.csv", 1)
        _, test_rows = rows("test.csv", 3)
        ex01 = os.path.join(HERE, "examples", "EX01.sdf")
        test_rows = test_rows + [{"name": "EX01", "ligand_description": ex01, "aug_num_ex": "3"}]
        paths = {}
        for split, body in (("train", train_rows), ("val", val_rows), ("test", test_rows)):
            paths[split] = os.path.join(tmp, f"{split}.csv")
            with open(paths[split], "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields)
                w.writeheader()
                w.writerows(body)
        config = flat_yaml.load(os.path.join(MODEL_DIR, "model_parameters.yml"))
        config.update(n_epochs=RAW_EPOCHS, phore_augment=1, conf_augment=1)
        yml = os.path.join(tmp, "recipe.yml")
        with open(yml, "w") as f:
            f.write(flat_yaml.dumps(config))
        cache, run_dir = os.path.join(tmp, "cache"), os.path.join(tmp, "run")
        argv = ["--config", yml, "--train_csv", paths["train"], "--val_csv", paths["val"],
                *RECIPE_BUCKET_FLAGS, "--num_dataloader_workers", str(workers),
                "--cache_path", cache, "--run_dir", run_dir, "--val_inference_freq", "0",
                "--seed", str(SEED), "--device", device]

        # ---- the trainer from the CSVs: featurize with the workers, train
        train_cli.PhoreDataset = Recording
        reset_kernel_counts()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            train_cli.main(argv)
        finally:
            train_cli.PhoreDataset = original
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (train_ds, feat_train_s), (val_ds, feat_val_s) = built
        n_records = RAW_TRAIN_ROWS * 3
        skips = [f for f in os.listdir(train_ds.cache_dir) if f.endswith(".skip")]
        if train_ds.featurized != n_records or len(train_ds) + len(skips) != n_records \
                or len(val_ds) != 1 or not len(train_ds):
            raise AssertionError(f"featurized {train_ds.featurized} train records into "
                                 f"{len(train_ds)} complexes and {len(skips)} skips, "
                                 f"{len(val_ds)} val")
        for b in (train_ds[i] for i in range(len(train_ds))):
            if (b.num_atoms, b.num_phore, b.num_torsions) != RAW_BUCKET:
                raise AssertionError(f"{b.names[0]} is not in the recipe's bucket")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        train_rec = [r for r in records if r.get("mode") != "val"]
        n_steps = sum(r["steps"] for r in train_rec)
        if len(train_rec) != RAW_EPOCHS or n_steps != RAW_EPOCHS \
                or not all(np.isfinite(r["loss"]) and r["grad_finite"] == 1.0 for r in train_rec):
            raise AssertionError(f"the trainer's records: {records}")
        train_counts = (expect_counts("cli.train.main from CSVs", steps=n_steps,
                                      eval_batches=RAW_EPOCHS)
                        if on_card else kernel_counts())
        peak_cli = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")

        # ---- again on the same CSVs: every record a cache hit
        before = snapshot(cache)
        built.clear()
        train_cli.PhoreDataset = Recording
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                train_cli.main(argv + ["--featurize_only"])
        finally:
            train_cli.PhoreDataset = original
        if [d.featurized for d, _ in built] != [0, 0] or snapshot(cache) != before:
            raise AssertionError("the second run on the same CSVs featurized again")

        # ---- the same train records into a fresh cache serially: the files
        # of the trainer's cache, which its workers wrote
        train_args = train_cli.parse_args(argv)
        settings = train_cli.dataset_settings(train_args)
        train_records = train_cli.augmented_records(ds.records_from_csv(paths["train"]),
                                                    train_args)
        t0 = time.perf_counter()
        d = ds.PhoreDataset(train_records, settings, os.path.join(tmp, "serial"), 1,
                            name="train")
        serial_s = time.perf_counter() - t0
        serial_files = sorted(os.listdir(d.cache_dir))
        if d.featurized != len(train_records) \
                or serial_files != sorted(os.listdir(train_ds.cache_dir)):
            raise AssertionError(f"one process featurized {d.featurized} of "
                                 f"{len(train_records)} records into {serial_files}, the "
                                 f"trainer's workers {sorted(os.listdir(train_ds.cache_dir))}")

        # ---- serial featurization of one record of each kind
        base = ds.records_from_csv(paths["train"])[-1]
        kinds = {"SDF": {"name": "EX01", "ligand_description": ex01,
                         "phore": os.path.join(HERE, "examples", "example.phore")},
                 "SMILES": base, "SMILES~aug1": {**base, "phore_seed": 1},
                 "SMILES~conf1": {**base, "conf_seed": 1}}
        serial_ms = {}
        for kind, rec in kinds.items():
            t0 = time.perf_counter()
            if ds.featurize_record(rec, settings) is None:
                raise AssertionError(f"{kind} record did not featurize")
            serial_ms[kind] = 1e3 * (time.perf_counter() - t0)

        # ---- a recipe batch: K2 and K3 against their plain versions, the
        # step's peak memory and wall time
        k2_cases = k3_cases = None
        step_ms = peak_step = float("nan")
        if on_card:
            cfg, shipped = load_model_dir(MODEL_DIR, device="cuda")
            batch = next(iter(BucketLoader(train_ds, TRAIN_BATCH, shuffle=False)))
            batch = batch.replace(names=(), meta=()).to("cuda")
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)
            draws = draw_noise(TRAIN_BATCH, RAW_BUCKET[2], gen, "cuda")
            draws.t = torch.linspace(0.02, 0.98, TRAIN_BATCH, device="cuda")
            with torch.no_grad():
                noised, _ = apply_noise(batch, cfg.sigma_schedule, draws=draws)
            k2_calls, k3_calls = capture_training_convs(shipped, noised)
            print(f"raw files: tp_aggregate on the {K2_CONVS} conv calls of one training-mode "
                  f"forward at {RAW_BUCKET}", flush=True)
            k2_cases = phase_k2_check(k2_calls)
            print(f"raw files: tp_scalar on the {K3_CONVS} layer-0 convs of the same forward",
                  flush=True)
            k3_cases = phase_k3_check(k3_calls)
            del k2_calls, k3_calls, noised, shipped
            torch.cuda.empty_cache()
            state = create_train_state(cfg, seed=SEED, device="cuda")
            step = make_train_step(cfg)
            state, _ = step(state, batch, gen)                       # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_counts()
            t0 = time.perf_counter()
            for _ in range(RAW_STEP_REPEATS):
                state, m = step(state, batch, gen)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / RAW_STEP_REPEATS
            peak_step = torch.cuda.max_memory_allocated() / 2**30
            expect_counts("train steps at the recipe's bucket", steps=RAW_STEP_REPEATS)
            if not bool(torch.isfinite(m["loss"])):
                raise AssertionError("a train step at the recipe's bucket is not finite")
            del state
            two_ranks = two_rank_step(batch, os.path.join(tmp, "ranks"), "recipe")
            print(f"raw files: a bf16 train step at {RAW_BUCKET}, batch {TRAIN_BATCH}: one "
                  f"process {step_ms:.1f} ms wall; two gloo ranks sharing the card, 12 rows "
                  f"each: {two_ranks['step_ms']:.1f} ms wall (slowest rank, mean of "
                  f"{RAW_STEP_REPEATS}), launches per rank {two_ranks['counts']} ({card})",
                  flush=True)

        # ---- the evaluation CLI with the corpus2 model and head
        out = os.path.join(tmp, "eval")
        reset_kernel_counts()
        t0 = time.perf_counter()
        res = eval_cli.main([
            "--test_csv", paths["test"], "--model_dir", MODEL_DIR,
            "--confidence_model_dir", CONFIDENCE_DIR, "--sample_per_complex", str(poses),
            "--inference_steps", str(steps), *RECIPE_BUCKET_FLAGS, "--use_symmetry_rmsd", "true",
            "--num_workers", str(workers), "--cache_path", cache, "--out_dir", out,
            "--device", device])
        if on_card:
            torch.cuda.synchronize()
        eval_wall = time.perf_counter() - t0
        names, timings = res["names"], res["timings"]
        per_complex = (CONVS_PER_FORWARD * steps + HEAD_CONVS) if on_card else 0
        eval_counts = expect_counts("cli.evaluate.main", k1=len(names) * per_complex)
        want_files = {"centroid_distances.npy", "confidence.npy", "fitscore.npy",
                      "min_ex_cross_distances.npy", "min_self_distances.npy", "names.json",
                      "performance_metrics.json", "rmsds.npy", "run_times.npy"}
        if set(os.listdir(out)) != want_files or "EX01" not in names or len(names) < 3:
            raise AssertionError(f"evaluation wrote {sorted(os.listdir(out))} for {names}")
        for fname in want_files - {"names.json", "performance_metrics.json", "run_times.npy"}:
            arr = np.load(os.path.join(out, fname))
            if arr.shape != (len(names), poses) or not np.isfinite(arr).all():
                raise AssertionError(f"{fname}: shape {arr.shape} or not finite")
        metrics = res["metrics"]
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"metrics not finite: {metrics}")

        # ---- K1 against its plain version at the recipe's bucket
        k1_check, k1_summary = "not run on the CPU", None
        if on_card:
            from diffphore_torch.ops import tp_fused

            cfg, model = load_model_dir(MODEL_DIR, device="cuda")
            # the first test row, a corpus2 SMILES (the cache files' names
            # are digests of the records, which hold the checkout's paths)
            eval_dir = glob.glob(os.path.join(cache, "eval_*"))[0]
            one = next(b for b in (ds.load_cached(f) for f in glob.glob(
                os.path.join(eval_dir, "*.npz"))) if b.names[0] == test_rows[0]["name"])
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)
            rows_k1 = posed_rows(one.to("cuda"), poses, cfg, gen)
            print(f"raw files: tp_fused on the 23 conv calls of one evaluation forward of "
                  f"{poses} poses of {one.names[0]} at {RAW_BUCKET}", flush=True)
            errs = phase_kernel_check(model, rows_k1, tp_fused)
            check_forward(model, rows_k1, cfg.compute_dtype, poses,
                          what=f"evaluation forward at {RAW_BUCKET}")
            k1_summary = {"max_abs_err": max(c["max_abs_err"] for c in errs),
                          "max_abs_err_bf16": max(c["max_abs_err_bf16"] for c in errs),
                          "max_rel_err": max(c["max_abs_err"] / max(c["max_abs_ref"], 1e-30)
                                             for c in errs),
                          "max_rel_err_bf16": max(c["max_rel_err_bf16"] for c in errs),
                          **{k: sum(c[k] for c in errs)
                             for k in ("ms", "ms_bf16", "bound_ms", "bound_ms_bf16",
                                       "plain_ms")}}
            k1_check = (f"{one.names[0]}: max |kernel - plain| / max|plain| "
                        f"{k1_summary['max_rel_err']:.2e} "
                        f"f32, {k1_summary['max_rel_err_bf16']:.2e} bf16; one forward's 23 "
                        f"calls {k1_summary['ms']:.3f} / {k1_summary['ms_bf16']:.3f} ms f32 / "
                        f"bf16 on the card (graph replay) against bounds "
                        f"{k1_summary['bound_ms']:.3f} / {k1_summary['bound_ms_bf16']:.3f}, "
                        f"plain {k1_summary['plain_ms']:.2f} ms")

    n_train = train_ds.featurized + val_ds.featurized
    print(f"raw files ({device}): cli.train.main from {RAW_TRAIN_ROWS} corpus2 rows + 1 val row "
          f"with --phore_augment 1 --conf_augment 1 at {RAW_BUCKET}: {n_records} train records "
          f"-> {len(train_ds)} complexes + {len(skips)} skipped (bucket caps), featurized with "
          f"{workers} workers in {feat_train_s + feat_val_s:.3f} s = "
          f"{1e3 * (feat_train_s + feat_val_s) / n_train:.1f} ms per complex; the "
          f"{len(train_records)} train records into a fresh cache by one process "
          f"{serial_s:.3f} s (the trainer's {workers} workers {feat_train_s:.3f} s)"
          + "; serial ms per complex: " + ", ".join(f"{k} {v:.1f}" for k, v in serial_ms.items())
          + f"; {n_steps} steps over {RAW_EPOCHS} epochs in {wall:.3f} s (featurization "
          f"included), losses " + " ".join(f"{r['loss']:.4f}" for r in train_rec)
          + f", CLI peak memory {peak_cli:.2f} GiB; launches {train_counts}; second run: 0 "
          f"featurized, cache unchanged; a train step at the bucket (batch {TRAIN_BATCH}, "
          f"bf16): {step_ms:.1f} ms wall, peak memory {peak_step:.2f} GiB ({card})", flush=True)
    print(f"raw files ({device}): cli.evaluate.main on {len(names)} complexes "
          f"({', '.join(names)}) x {poses} poses x {steps} steps with the head in "
          f"{eval_wall:.3f} s: featurization {timings['featurize_s']:.3f} s for "
          f"{timings['featurized']} records with {workers} workers "
          f"({1e3 * timings['featurize_s'] / max(timings['featurized'], 1):.1f} ms per complex); "
          f"dispatch ms per complex {1e3 * timings.get('sample', 0.0) / len(names):.1f}; RMSD ms "
          f"per complex (symmetry-corrected for EX01) "
          f"{1e3 * timings.get('rmsd', 0.0) / len(names):.2f}; K1 launches {eval_counts['k1']} "
          f"({per_complex} per complex); top1 RMSD < 2 A {metrics['top1_rmsds_below_2']}, by "
          f"fitness {metrics['rankbyFitscore_top1_rmsds_below_2']}, by confidence "
          f"{metrics.get('rankbyConfidence_top1_rmsds_below_2')}; K1 at "
          f"{RAW_BUCKET}: {k1_check} ({card})", flush=True)
    return {"train": train_counts, "eval": eval_counts, "k1": k1_summary, "k2_cases": k2_cases,
            "k3_cases": k3_cases}


# Phase 13: scale-out.  Two gloo ranks share the one card (NCCL takes one
# rank per card); NCCL at a world size above 1 needs several cards.
SCALE_WORLD = 2
SCALE_STEP_REPEATS = 3      # timed steps after the compared one
SCALE_SDF_COPIES = 4        # copies of the examples' three SDFs: 12 complexes to stripe
PREFETCH_TURNS = (0, 2)


def scale_out_rank(batch_path, out_path):
    """Rank r of ``SCALE_WORLD`` gloo ranks on cuda:0: one bf16 train step of
    the shipped config from fresh weights on its rows of the global batch
    (the batch, noise and dropout masks of one process), its launch counts,
    then ``SCALE_STEP_REPEATS`` timed steps; writes what it saw."""
    import torch

    from diffphore_torch.parallel import mesh
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.utils.checkpoints import load_config_yaml

    shard, device = mesh.init_process_group("cuda:0", backend="gloo")
    try:
        cfg = load_config_yaml(MODEL_DIR)
        batch = torch.load(batch_path, weights_only=False).to(device)
        state = create_train_state(cfg, seed=SEED, device=str(device))
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        step = make_train_step(cfg, shard=shard)
        reset_kernel_counts()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        counts = kernel_counts()
        grads = {k: p.grad.cpu() for k, p in state.model.named_parameters()}
        params = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
        walls = []
        for _ in range(SCALE_STEP_REPEATS):
            mesh.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch, gen)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        torch.save({"loss": float(m["loss"]), "grads": grads, "params": params,
                    "counts": counts, "walls": walls}, out_path % shard.rank)
    finally:
        mesh.destroy_process_group()


def two_rank_step(batch, tmp, tag):
    """One bf16 train step over two gloo ranks sharing the card against one
    process on the whole batch from the same seed: the loss within
    TOL_STEP_GRAD, the gradient as one vector within TOL_BF16_GAP of the one
    process's own f32-vs-bf16 difference, the replicas' parameters equal
    after the step, K2 and K3 at their per-step counts on each rank.
    Returns the ranks' step wall time (ms, the slower rank's mean) and
    launch counts."""
    import torch

    from diffphore_torch.parallel import mesh
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.utils.checkpoints import load_config_yaml

    os.makedirs(tmp, exist_ok=True)
    batch_path = os.path.join(tmp, f"{tag}_batch.pt")
    torch.save(batch.to("cpu"), batch_path)
    out_path = os.path.join(tmp, f"{tag}_rank%d.pt")
    mesh.launch(scale_out_rank, SCALE_WORLD, batch_path, out_path)
    ranks = [torch.load(out_path % r, weights_only=False) for r in range(SCALE_WORLD)]
    cfg = load_config_yaml(MODEL_DIR)
    results = {}
    for dtype in ("bfloat16", "float32"):
        cfg_d = dataclasses.replace(cfg, compute_dtype=dtype)
        state = create_train_state(cfg_d, seed=SEED, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        state, m = make_train_step(cfg_d)(state, batch, gen)
        results[dtype] = (float(m["loss"]), {k: p.grad.cpu()
                                             for k, p in state.model.named_parameters()})
        del state
    (loss_1, g1), (loss_32, g32) = results["bfloat16"], results["float32"]
    names = [k for k, v in g1.items() if v.numel()]
    flat = lambda d: torch.cat([d[k].flatten() for k in names])
    gap, norm = float((flat(g32) - flat(g1)).norm()), float(flat(g1).norm())
    for r, out in enumerate(ranks):
        if out["counts"] != want_counts(steps=1):
            raise AssertionError(f"{tag}: rank {r} launched {out['counts']} in one step")
        err = float((flat(out["grads"]) - flat(g1)).norm())
        if not err <= TOL_BF16_GAP * gap:
            raise AssertionError(f"{tag}: rank {r}'s gradient differs from one process's by "
                                 f"{err} > {TOL_BF16_GAP} * the f32-vs-bf16 difference {gap}")
        if not abs(out["loss"] - loss_1) <= TOL_STEP_GRAD * abs(loss_1):
            raise AssertionError(f"{tag}: rank {r}'s loss {out['loss']} vs one process's "
                                 f"{loss_1}")
    if any(not torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in names):
        raise AssertionError(f"{tag}: the two replicas' parameters differ after a step")
    step_ms = 1e3 * max(sum(out["walls"]) / len(out["walls"]) for out in ranks)
    print(f"{tag}: a bf16 step of batch {batch.batch_size} over {SCALE_WORLD} gloo ranks "
          f"sharing the card against one process from the same seed: loss "
          f"{ranks[0]['loss']:.6f} vs {loss_1:.6f}; gradient L2 |ranks - one| / |one| "
          + " ".join(f"{float((flat(o['grads']) - flat(g1)).norm()) / norm:.2e}" for o in ranks)
          + f" against the f32-vs-bf16 {gap / norm:.2e}; replicas equal; per rank K2 "
          f"{K2_CONVS} x 3 and K3 {K3_CONVS} x 3 launches", flush=True)
    return {"step_ms": step_ms, "counts": ranks[0]["counts"]}


def artifacts_without_run_time(root):
    """Every file under ``root``, ``run_time`` taken out of the journals,
    dock logs and ranked tables."""
    import csv

    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith((".json", "_dock.log")):
                with open(path) as f:
                    obj = json.load(f)
                obj.pop("run_time")
                out[rel] = obj
            elif name.startswith("ranked_results"):
                with open(path) as f:
                    rows = list(csv.reader(f, delimiter="\t"))
                col = rows[0].index("run_time")
                out[rel] = [r[:col] + r[col + 1:] for r in rows]
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def phase_scale_out(card, train_batch):
    """NCCL at world size 1 against no process group (bit-equal step); two
    gloo ranks sharing the card against one process; one screening process
    against two striped ones on the card, then the merge; the screen from
    files with featurization inline and in two worker processes, in turns,
    with the artifact sets compared.  Returns the screen's K1 launches."""
    import csv
    import contextlib
    import io

    import numpy as np
    import torch

    from diffphore_torch.cli import inference as cli
    from diffphore_torch.cli.profile_screen import dispatch_window, run_processes
    from diffphore_torch.parallel import mesh
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.utils.checkpoints import load_config_yaml

    # ---- NCCL at world size 1: the same bits as no process group
    cfg = load_config_yaml(MODEL_DIR)
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(mesh.free_port()))
    try:
        shard, device = mesh.init_process_group("cuda")
        seen = []
        for one in (None, shard, None):
            state = create_train_state(cfg, seed=SEED, device="cuda")
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)
            state, m = make_train_step(cfg, shard=one)(state, train_batch, gen)
            seen.append([m["loss"]] + [p.grad for p in state.model.parameters()]
                        + [p.detach() for p in state.model.parameters()])
        backend = torch.distributed.get_backend()
    finally:
        mesh.destroy_process_group()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k)
    if not all(torch.equal(a, c) for a, c in zip(seen[0], seen[2])):
        raise AssertionError("two plain train steps from the same seed differ: the step is not "
                             "deterministic on the card")
    if not all(torch.equal(a, b) for a, b in zip(seen[0], seen[1])):
        raise AssertionError(f"a step over {backend} at world size 1 differs from the plain step")
    print(f"scale-out: a bf16 train step over {backend} at world size 1 equals the step without "
          f"a process group, loss, {len(seen[0]) // 2} gradients and parameters bit for bit",
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- two gloo ranks sharing the card, the shipped bf16, 24 x 96 x 8
        two = two_rank_step(train_batch, os.path.join(tmp, "ranks"), "scale-out")

        # ---- one screening process against two striped ones on the card
        phore_file = os.path.join(HERE, "examples", "example.phore")
        rows = []
        for i in range(SCALE_SDF_COPIES):
            for name in ("EX01", "EX02", "EX03"):
                path = os.path.join(tmp, f"{name}_{i}.sdf")
                shutil.copy(os.path.join(HERE, "examples", f"{name}.sdf"), path)
                rows.append({"name": f"{name}_{i}", "ligand_description": path,
                             "phore": phore_file})
        task = os.path.join(tmp, "stripes.csv")
        with open(task, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["name", "ligand_description", "phore"])
            w.writeheader()
            w.writerows(rows)
        n = len(rows)

        def cli_argv(out, *extra):
            return ["--phore_ligand_csv", task, "--model_dir", MODEL_DIR, "--out_dir", out,
                    "--sample_per_complex", str(POSES), "--inference_steps", str(STEPS),
                    "--device", "cuda", "--prefetch_workers", "0", *extra]

        one_out, striped_out = os.path.join(tmp, "one"), os.path.join(tmp, "striped")
        one = run_processes([cli_argv(one_out)], POSES, timeout=600)
        two_proc = run_processes([cli_argv(striped_out, "--num_processes", str(SCALE_WORLD),
                                           "--process_rank", str(r))
                                  for r in range(SCALE_WORLD)], POSES, timeout=600)
        if one["complexes"] != n or two_proc["complexes"] != n:
            raise AssertionError(f"the screens sampled {one['complexes']} and "
                                 f"{two_proc['complexes']} of {n} complexes")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(cli_argv(striped_out, "--num_processes", str(SCALE_WORLD),
                              "--process_rank", "0"))                 # the merge
        tables = {}
        for out in (one_out, striped_out):
            with open(os.path.join(out, "ranked_results.csv")) as f:
                tables[out] = list(csv.DictReader(f, delimiter="\t"))
        if sorted(r["name"] for r in tables[striped_out]) != sorted(
                r["name"] for r in tables[one_out]) or len(tables[one_out]) != n:
            raise AssertionError("the merged striped table does not hold the one process's "
                                 "complexes")
        if not all(np.isfinite(float(r["max_fitscore"])) for r in tables[striped_out]):
            raise AssertionError("the merged table holds a fitness that is not finite")

        # ---- the screen from files, featurization inline and in two worker
        # processes, in turns, through main() in this process
        screen_task, screen = screen_rows(tmp)
        turns, sets = [], []
        reset_kernel_counts()
        for i, workers in enumerate(PREFETCH_TURNS):
            out = os.path.join(tmp, f"prefetch{i}")
            log = io.StringIO()
            t0, wall0 = time.perf_counter(), time.time()
            with contextlib.redirect_stdout(log):
                cli.main(["--phore_ligand_csv", screen_task, "--model_dir", MODEL_DIR,
                          "--out_dir", out, "--sample_per_complex", str(POSES),
                          "--inference_steps", str(STEPS), "--device", "cuda",
                          "--prefetch_workers", str(workers)])
            torch.cuda.synchronize()
            _, first, last = dispatch_window(log.getvalue())
            turns.append((workers, time.perf_counter() - t0, first - wall0, last - first))
            sets.append(artifacts_without_run_time(out))
        counts = expect_counts("the screen in turns",
                               k1=len(PREFETCH_TURNS) * SCREEN_SAMPLED * CONVS_PER_FORWARD * STEPS)
        for i, got in enumerate(sets[1:], 1):
            if got != sets[0]:
                diff = sorted(k for k in set(got) | set(sets[0]) if got.get(k) != sets[0].get(k))
                raise AssertionError(f"turn {i} ({PREFETCH_TURNS[i]} workers) wrote another "
                                     f"artifact set than turn 0: {diff[:5]}")

    def rate(workers, column):
        return " ".join(f"{SCREEN_SAMPLED * POSES / t[column]:.1f}" for t in turns
                        if t[0] == workers)

    def startups(run):
        return " + ".join(f"{s:.3f}" for s in run["startup_s"])

    print(f"scale-out: {n} SDF complexes x {POSES} poses x {STEPS} steps through cli.inference "
          f"processes on the card: one process {one['wall_s']:.3f} s wall = "
          f"{one['poses_per_s_wall']:.1f} poses/s, start-up (launch to first dispatch) "
          f"{startups(one)} s, dispatch window {one['window_s']:.3f} s = "
          f"{one['poses_per_s_window']:.1f} poses/s; two striped processes at once "
          f"{two_proc['wall_s']:.3f} s wall = {two_proc['poses_per_s_wall']:.1f} poses/s, "
          f"start-ups {startups(two_proc)} s, dispatch window over both "
          f"{two_proc['window_s']:.3f} s = {two_proc['poses_per_s_window']:.1f} poses/s; merged "
          f"by rank 0 into the one process's {n} names ({card})", flush=True)
    print(f"scale-out: the screen from files ({SCREEN_SAMPLED} of 6 rows sampled, a SMILES "
          f"embedded) through main() with --prefetch_workers in turns (wall / to the first "
          f"dispatch / dispatch window): "
          + ", ".join(f"{w}: {t:.3f} / {s:.3f} / {d:.3f} s" for w, t, s, d in turns)
          + f"; poses/s over main() inline {rate(0, 1)}, two workers {rate(2, 1)}; over the "
          f"dispatch window inline {rate(0, 3)}, two workers {rate(2, 3)}; artifact sets equal "
          f"but for run_time; K1 launches {counts['k1']} ({card})", flush=True)
    print(f"scale-out: a bf16 step at {BUCKET}, batch {train_batch.batch_size}, two gloo ranks "
          f"sharing the card: {two['step_ms']:.1f} ms wall ({card})", flush=True)
    return counts["k1"]


# Phase 15, the model-family variants off the shipped config: cli.train runs
# of two epochs of one step each, over TRAIN_BATCH cached complexes and a
# validation batch of VAL_COMPLEXES.
VARIANT_EPOCHS = 2
VARIANT_STEP_REPEATS = 3    # timed train steps of the use_att model and of the tank model
RECOVERY_LIGANDS = ("EX01.sdf", "EX02.sdf")   # tank poses from files, at example.phore
ORACLE_COMPLEXES = 4
ORACLE_POSES = 8
# The oracle chain recovers a pose as tests/test_oracle_sampler.py holds the
# JAX chain: per complex at least ORACLE_MIN_RECOVERED of ORACLE_POSES poses
# within 2 A of the clean pose and the best within 1 A.
ORACLE_MIN_RECOVERED = 6
# The same chain on the card and on the CPU, same noise: median pose RMSD (A)
# between the two.  Kabsch and the score tables round differently on the two
# devices; the chain contracts such differences.
TOL_ORACLE_RMSD = 1e-3
# The tank model's validation loss recomputed from its reloaded EMA weights,
# against the trainer's record: the same computation on the same card.
TOL_TANK_RELOAD = 1e-5


def profiled_busy_ms(fn, repeats=2, part=None):
    """The card's busy ms per call of ``fn``: the device time of every
    kernel ``torch.profiler`` sees in ``repeats`` calls (the optimizer's
    annotation range, which repeats its kernels' time, left out); 0 when the
    profiler sees no device time.  With ``part``, also the ms of the kernels
    whose name holds it."""
    import torch

    from diffphore_torch.cli.profile_main_path import _device_us

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Optimizer.")]
    busy = sum(_device_us(e) for e in kernels) / 1e3 / repeats
    if part is None:
        return busy
    return busy, sum(_device_us(e) for e in kernels if part in e.key) / 1e3 / repeats


def sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def reset_peak(device):
    import torch

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak_gib(device):
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")


def timed_steps(step, repeats, device="cuda"):
    """(wall ms per call, peak GiB) of ``repeats`` calls of ``step`` after
    one warm-up call."""
    step()
    sync(device)
    reset_peak(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        step()
    sync(device)
    return 1e3 * (time.perf_counter() - t0) / repeats, peak_gib(device)


def read_records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_variants(card, cfg, train_batch, draws, jobs, device="cuda", poses=POSES, steps=STEPS,
                   tank_width=(16, 8)):
    """The variants on the card: (1) ``cli.train.main`` with the corpus2
    config and ``--use_att true``: exact launches, K2 and K3 against their
    plain versions on one use_att training forward, a step's wall, busy time
    and peak memory; (2) that run directory served by ``FitEngine`` (8
    complexes x 40 poses x 20 steps, K1 exact, a re-sample with the plain
    convs), K1 against its plain version on one use_att forward's 23 conv
    calls, one complex through ``cli.inference.main``; (3) ``cli.train.main
    --model_type tank``: no launch, a checkpoint that reloads to the same
    validation loss, poses recovered from its distance maps on two complexes
    from files; (4) a fully connected model: a dispatch and a train step, no
    launch; (5) a Fourier model's forward on the card against the CPU, and
    the oracle score driving the reverse SDE on the card, against the same
    chain on the CPU.  Returns the launch counts of each path.  With
    ``device="cpu"``, a small ``cfg`` and fewer ``poses`` and ``steps`` it
    rehearses the phase on the CPU (no kernel, so no count is held and the
    kernel checks are left out)."""
    import csv

    import numpy as np
    import torch

    from diffphore_torch.chem.sdf import read_molecule
    from diffphore_torch.cli import inference as infer_cli
    from diffphore_torch.cli import train as train_cli
    from diffphore_torch.cli.pipeline import FitEngine
    from diffphore_torch.data.dataset import CachedDataset, cache_directories
    from diffphore_torch.data.graphs import (build_complex, concat_batches, pad_to_bucket,
                                             repeat_batch)
    from diffphore_torch.data.loaders import BucketLoader
    from diffphore_torch.data.phore import parse_phore
    from diffphore_torch.data.transforms import apply_noise
    from diffphore_torch.models.layers import batch_statistics
    from diffphore_torch.models.score_model import ScoreModel, init_parameters
    from diffphore_torch.ops import tp_fused
    from diffphore_torch.ops.fitscore import batch_phore_arrays
    from diffphore_torch.sampler import oracle
    from diffphore_torch.sampler.sampling import (PriorNoise, SamplerSettings, StepNoise,
                                                  draw_prior, draw_steps, randomize_position,
                                                  reverse_diffusion)
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.train.tank import (create_tank_train_state, make_tank_eval_step,
                                            make_tank_train_step, tank_pose_metrics)
    from diffphore_torch.utils import checkpoints, flat_yaml

    on_card = device == "cuda"

    def expect(what, **kw):
        return expect_counts(what, **kw) if on_card else kernel_counts()

    per_dispatch = CONVS_PER_FORWARD * steps
    laps = [time.perf_counter()]

    def lap():
        """s since the previous lap: each part's share of the phase."""
        laps.append(time.perf_counter())
        return f"[{laps[-1] - laps[-2]:.1f} s]"

    counts = {}
    drop = torch.Generator(device=device)
    drop.manual_seed(SEED + 5)
    with tempfile.TemporaryDirectory() as tmp:
        copy_bucket(TRAIN_CACHE_DIR, os.path.join(tmp, "train_variants"), TRAIN_BATCH)
        copy_bucket(CACHE_DIR, os.path.join(tmp, "val_variants"), VAL_COMPLEXES)

        # ---- 15.1 use_att trained through the CLI, in the corpus2 recipe
        config = flat_yaml.load(os.path.join(MODEL_DIR, "model_parameters.yml"))
        config.update(n_epochs=VARIANT_EPOCHS, use_att=True, trioformer_layer=1, ns=cfg.ns,
                      nv=cfg.nv, num_conv_layers=cfg.num_conv_layers,
                      batch_size=train_batch.batch_size)
        yml = os.path.join(tmp, "use_att.yml")
        with open(yml, "w") as f:
            f.write(flat_yaml.dumps(config))
        att_run = os.path.join(tmp, "use_att")
        reset_kernel_counts()
        train_cli.main(["--config", yml, "--cache_path", tmp, "--run_dir", att_run,
                        "--val_inference_freq", "0", "--seed", str(SEED), "--device", device])
        sync(device)
        counts["use_att_training"] = expect(
            "use_att cli.train.main", steps=VARIANT_EPOCHS, eval_batches=VARIANT_EPOCHS)
        records = read_records(att_run)
        train_rec = [r for r in records if r.get("mode") != "val"]
        val_rec = [r for r in records if r.get("mode") == "val"]
        if (len(train_rec), len(val_rec)) != (VARIANT_EPOCHS, VARIANT_EPOCHS) \
                or any(r["steps"] != 1 or r["grad_finite"] != 1.0 for r in train_rec) \
                or not all(np.isfinite(r["loss"]) for r in train_rec + val_rec):
            raise AssertionError(f"use_att training records: {records}")
        att_cfg, att_model = checkpoints.load_model_dir(att_run, device=device,
                                                        checkpoint=checkpoints.LAST_MODEL)
        if not (att_cfg.use_att and att_cfg.trioformer_layer == 1 and att_cfg.compute_dtype
                == "bfloat16" and (att_cfg.ns, att_cfg.nv, att_cfg.num_conv_layers)
                == (cfg.ns, cfg.nv, cfg.num_conv_layers)):
            raise AssertionError(f"the use_att run is not corpus2's width with use_att: {att_cfg}")
        if on_card:
            with torch.no_grad():
                noised, _ = apply_noise(train_batch, att_cfg.sigma_schedule, draws=draws)
            k2_calls, k3_calls = capture_training_convs(att_model, noised)
            print(f"kernel check: tp_aggregate on the {K2_CONVS} conv calls it takes of one "
                  "training-mode forward of the use_att model", flush=True)
            phase_k2_check(k2_calls)
            print(f"kernel check: tp_scalar on the {K3_CONVS} layer-0 convs of the same "
                  "forward", flush=True)
            phase_k3_check(k3_calls)
            del k2_calls, k3_calls, noised
        state = create_train_state(att_cfg, seed=SEED, device=device)
        step = make_train_step(att_cfg)
        run_step = lambda: step(state, train_batch, drop, draws=draws)
        wall_ms, peak = timed_steps(run_step, VARIANT_STEP_REPEATS, device)
        busy_ms = profiled_busy_ms(run_step) if on_card else 0.0
        del state
        reset_peak(device)
        print(f"use_att training: cli.train.main, {VARIANT_EPOCHS} epochs of one step of "
              f"{TRAIN_BATCH} and a validation batch of {VAL_COMPLEXES}, losses "
              + " ".join(f"{r['loss']:.4f}" for r in train_rec) + "; val "
              + " ".join(f"{r['loss']:.4f}" for r in val_rec)
              + f"; launches {counts['use_att_training']}; a bf16 step of {TRAIN_BATCH} at "
              f"{BUCKET[0]} x {BUCKET[1]} x {BUCKET[2]}: wall {wall_ms:.1f} ms, busy "
              + (f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.3f} of the wall)" if busy_ms
                 else "not measured (the profiler saw no device time)")
              + f", peak memory {peak:.3f} GiB ({card}) {lap()}", flush=True)

        # ---- 15.2 the use_att run directory served
        engine = FitEngine(att_cfg, att_model, samples_per_complex=poses,
                           settings=SamplerSettings(inference_steps=steps), seed=SEED,
                           device=device)
        engine.run_complexes(jobs[:1])                                # warm-up
        sync(device)
        reset_kernel_counts()
        t0 = time.perf_counter()
        results = engine.run_complexes(jobs)
        sync(device)
        elapsed = time.perf_counter() - t0
        counts["use_att_serving"] = expect("use_att serving", k1=len(jobs) * per_dispatch)
        for job, r in zip(jobs, results):
            if r["poses"].shape != (poses, job.n_atoms, 3) or not np.isfinite(r["poses"]).all() \
                    or not np.isfinite(r["fitscore"]).all():
                raise AssertionError(f"use_att {r['name']}: poses or fitscores not finite")
        job = jobs[0]
        noise = engine.draw_noise(poses, job.batch.num_torsions)
        rows = repeat_batch(job.batch.to(device), poses)
        ref = batch_phore_arrays(rows)
        pos_k, _, _ = engine.run_batch(rows, ref, poses, noise)
        set_use_kernel(att_model, False)
        pos_p, _, _ = engine.run_batch(rows, ref, poses, noise)
        set_use_kernel(att_model, True)
        n_at = job.n_atoms
        rmsd = ((pos_k[:, :n_at] - pos_p[:, :n_at]) ** 2).sum(-1).mean(-1).sqrt().cpu().numpy()
        if not np.median(rmsd) <= TOL_RERUN_RMSD:
            raise AssertionError(f"use_att kernel and plain runs diverge: median RMSD "
                                 f"{np.median(rmsd)} A")
        k1_note = "not run (no card)"
        if on_card:
            gen = torch.Generator(device=device)
            gen.manual_seed(SEED)
            posed = posed_rows(job.batch.to(device), poses, att_cfg, gen)
            errs = [check_k1_call(tp_fused, name, mod, args)
                    for name, mod, args in capture_conv_calls(att_model, posed, poses)]
            # the weights and rows the check reads, as digests that a rerun (or
            # analysis/use_att_repro.py) can be held to bit for bit
            print(f"use_att forward check: weights {digest(att_model.state_dict().values())}, "
                  f"rows {digest([posed.lig_pos, posed.t])}", flush=True)
            check_forward(att_model, posed, att_cfg.compute_dtype, poses, what="use_att forward")
            k1_note = ("max |kernel - plain| / max|plain| of a call "
                       f"{max(c['err'] / max(c['scale'], 1e-30) for c in errs):.2e} (f32), "
                       f"{max(c['err_bf'] / max(c['scale_bf'], 1e-30) for c in errs):.2e} "
                       f"(bf16); largest abs err {max(c['err'] for c in errs):.2e}")
            del errs, posed
        print(f"use_att serving: {len(jobs)} complexes x {poses} poses x {steps} steps in "
              f"{elapsed:.3f} s = {len(jobs) * poses / elapsed:.1f} poses/s ({card}); K1 "
              f"{counts['use_att_serving']['k1']} launches; kernel vs plain convs, same noise: "
              f"pose RMSD median {np.median(rmsd):.2e} max {rmsd.max():.2e} A; K1 against its "
              f"plain version on the conv calls of one use_att forward: {k1_note} {lap()}",
              flush=True)
        del engine

        # one complex through the screening CLI from the run directory
        with open(os.path.join(HERE, "examples", "task.csv")) as f:
            row = dict(next(csv.DictReader(f)))
        row = dict(row, ligand_description=os.path.join(HERE, row["ligand_description"]),
                   phore=os.path.join(HERE, row["phore"]))
        task = os.path.join(tmp, "one.csv")
        with open(task, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            w.writeheader()
            w.writerow(row)
        screen = os.path.join(tmp, "att_screen")
        reset_kernel_counts()
        t0 = time.perf_counter()
        infer_cli.main(["--phore_ligand_csv", task, "--model_dir", att_run, "--ckpt",
                        checkpoints.LAST_MODEL, "--out_dir", screen, "--sample_per_complex",
                        str(poses), "--inference_steps", str(steps), "--device", device,
                        "--prefetch_workers", "0"])
        sync(device)
        screen_s = time.perf_counter() - t0
        counts["use_att_cli"] = expect("use_att cli.inference.main", k1=per_dispatch)
        name = infer_cli.complex_name(row)
        with open(os.path.join(screen, "ranked_results.csv")) as f:
            ranked = list(csv.reader(f, delimiter="\t"))
        with open(os.path.join(screen, "mapping_process", name, f"{name}.score")) as f:
            table = [line.rstrip("\n").split("\t") for line in f]
        with open(os.path.join(screen, "ranked_poses", f"{name}_ranked.sdf")) as f:
            n_poses = f.read().count("$$$$")
        if ranked[0] != infer_cli.RANKED_COLUMNS or [r[2] for r in ranked[1:]] != [name] \
                or not os.path.exists(os.path.join(screen, "inference_results.json")) \
                or len(table) != poses or {len(r) for r in table} != {19} or n_poses != poses:
            raise AssertionError(f"use_att cli.inference.main artifacts: {ranked}, "
                                 f"{len(table)} score rows, {n_poses} ranked poses")
        print(f"use_att cli.inference.main: {name}, {poses} poses x {steps} steps in "
              f"{screen_s:.2f} s (model load, featurization and writers included); the "
              f"artifact set complete; K1 {counts['use_att_cli']['k1']} launches ({card}) "
              f"{lap()}", flush=True)
        del att_model
        reset_peak(device)

        # ---- 15.3 the tank mode at the JAX defaults (hidden 16, 8 blocks)
        tank_run = os.path.join(tmp, "tank")
        reset_kernel_counts()
        train_cli.main(["--model_type", "tank", "--cache_path", tmp, "--run_dir", tank_run,
                        "--n_epochs", str(VARIANT_EPOCHS), "--batch_size",
                        str(train_batch.batch_size), "--tank_hidden_dim", str(tank_width[0]),
                        "--tank_blocks", str(tank_width[1]), "--seed", str(SEED),
                        "--device", device])
        sync(device)
        counts["tank"] = expect_counts("tank cli.train.main")
        records = read_records(tank_run)
        train_rec = [r for r in records if r["mode"] == "tank"]
        val_rec = [r for r in records if r["mode"] == "tank_val"]
        if (len(train_rec), len(val_rec)) != (VARIANT_EPOCHS, VARIANT_EPOCHS) \
                or any(r["steps"] != 1 or r["grad_finite"] != 1.0 for r in train_rec) \
                or not all(np.isfinite(r["loss"]) for r in train_rec + val_rec):
            raise AssertionError(f"tank training records: {records}")
        settings, tank = checkpoints.load_tank_dir(tank_run, device=device,
                                                   checkpoint=checkpoints.LAST_MODEL,
                                                   use_ema=True)
        if (settings["tank_hidden_dim"], settings["tank_blocks"]) != tuple(tank_width):
            raise AssertionError(f"the tank run's width: {settings}")
        val_ds = CachedDataset(cache_directories(tmp, "val"))
        (vb,) = list(BucketLoader(val_ds, train_batch.batch_size, shuffle=False))
        affinity = train_cli.batch_affinity(vb).to(device)
        vm = make_tank_eval_step()(tank, vb.replace(names=(), meta=()).to(device), affinity)
        reloaded = float(vm["loss"])
        if not abs(reloaded - val_rec[-1]["loss"]) <= TOL_TANK_RELOAD * abs(val_rec[-1]["loss"]):
            raise AssertionError(f"the reloaded tank model's val loss {reloaded} against the "
                                 f"trainer's {val_rec[-1]['loss']}")
        tstate = create_tank_train_state(*tank_width, seed=SEED, device=device)
        tstep = make_tank_train_step()
        batch_aff = torch.zeros(train_batch.batch_size, device=device)
        tank_ms, tank_peak = timed_steps(lambda: tstep(tstate, train_batch, batch_aff, drop),
                                         VARIANT_STEP_REPEATS, device)
        del tstate
        phore = parse_phore(os.path.join(HERE, "examples", "example.phore"))[0]
        mols = [read_molecule(os.path.join(HERE, "examples", lig), remove_hs=True)
                for lig in RECOVERY_LIGANDS]
        built = [build_complex(lig, m, phore) for lig, m in zip(RECOVERY_LIGANDS, mols)]
        pads = [max(getattr(b, k) for b in built)
                for k in ("num_atoms", "num_phore", "num_torsions")]
        files_batch = concat_batches(pad_to_bucket(built, *pads)).replace(names=(), meta=())
        reset_kernel_counts()
        sync(device)
        t0 = time.perf_counter()
        metrics = tank_pose_metrics(tank, files_batch.to(device), mols,
                                    generator=torch.Generator(device=device).manual_seed(SEED))
        sync(device)
        recovery_ms = 1e3 * (time.perf_counter() - t0) / len(mols)
        expect_counts("tank pose metrics")
        if not np.isfinite(metrics["rmsds"]).all():
            raise AssertionError(f"tank pose metrics: {metrics}")
        print(f"tank: cli.train.main --model_type tank (hidden {tank_width[0]}, {tank_width[1]} "
              f"blocks), {VARIANT_EPOCHS} epochs of one step of {train_batch.batch_size}: losses "
              + " ".join(f"{r['loss']:.4f}" for r in train_rec) + ", val "
              + " ".join(f"{r['loss']:.4f}" for r in val_rec)
              + f"; last_model.msgpack's EMA reloaded: val loss {reloaded:.6f}; a step "
              f"{tank_ms:.1f} ms, peak memory {tank_peak:.3f} GiB; coordinate recovery "
              f"(4 initializations x 500 Adam steps) {recovery_ms:.1f} ms per complex, RMSDs "
              + " ".join(f"{r:.2f}" for r in metrics["rmsds"])
              + f" A; no kernel launched ({card}) {lap()}", flush=True)
        del tank
        reset_peak(device)

    # ---- 15.4 fully connected tensor products, fresh corpus2-width weights
    fc_cfg = dataclasses.replace(cfg, tp_mode="fully_connected")
    fc_model = init_parameters(ScoreModel(fc_cfg), SEED)
    engine = FitEngine(fc_cfg, fc_model, samples_per_complex=poses,
                       settings=SamplerSettings(inference_steps=steps), seed=SEED, device=device)
    engine.calibrate_batch_stats(jobs[0], iters=20)     # random weights, as --allow_random_init
    sync(device)
    reset_kernel_counts()
    reset_peak(device)
    t0 = time.perf_counter()
    (res,) = engine.run_complexes(jobs[:1])
    sync(device)
    fc_s = time.perf_counter() - t0
    fc_peak = peak_gib(device)
    counts["fully_connected_serving"] = expect_counts("fully connected dispatch")
    if not (np.isfinite(res["poses"]).all() and np.isfinite(res["fitscore"]).all()):
        raise AssertionError("fully connected dispatch: poses or fitscores not finite")
    del engine, fc_model
    state = create_train_state(fc_cfg, seed=SEED, device=device)
    step = make_train_step(fc_cfg)
    reset_peak(device)
    reset_kernel_counts()
    t0 = time.perf_counter()
    state, m = step(state, train_batch, drop, draws=draws)
    sync(device)
    fc_step_s = time.perf_counter() - t0
    fc_step_peak = peak_gib(device)
    counts["fully_connected_training"] = expect_counts("fully connected train step")
    if not (np.isfinite(float(m["loss"])) and float(m["grad_finite"]) == 1.0):
        raise AssertionError(f"fully connected train step: {m}")
    del state
    reset_peak(device)
    print(f"fully connected (fresh corpus2-width weights, bf16): one complex x {poses} poses x "
          f"{steps} steps in {fc_s:.3f} s, peak memory {fc_peak:.3f} GiB; one train step of "
          f"{train_batch.batch_size} (the first, no warm-up) {1e3 * fc_step_s:.1f} ms, loss "
          f"{float(m['loss']):.4f}, peak memory {fc_step_peak:.3f} GiB; no kernel launched "
          f"({card}) {lap()}", flush=True)

    # ---- 15.5 the Fourier embedding, and the oracle score driving the chain
    f_cfg = dataclasses.replace(cfg, embedding_type="fourier", compute_dtype="float32")
    f_model = init_parameters(ScoreModel(f_cfg), SEED).eval()
    fb = posed_rows(jobs[0].batch, 8, f_cfg, torch.Generator().manual_seed(SEED))
    fb = fb.replace(t=torch.linspace(0.05, 0.95, 8))
    # fresh weights: the batch norms normalize by the batch's statistics
    # (eval-mode convs, K1 on the card), else the identity running statistics
    # let the activations overflow through the conv stack
    with torch.no_grad(), batch_statistics(f_model):
        cpu_out = f_model(fb)
        f_model.to(device)
        reset_kernel_counts()
        card_out = f_model(fb.to(device))
        sync(device)
    counts["fourier"] = expect("Fourier model forward", k1=CONVS_PER_FORWARD)
    if not all(bool(torch.isfinite(o).all()) for o in tuple(cpu_out) + tuple(card_out)):
        raise AssertionError("Fourier model: a forward is not finite")
    rel = max(float((c.cpu() - p).abs().max()) / max(float(p.abs().max()), 1e-30)
              for c, p in zip(card_out, cpu_out))
    if not rel <= TOL_FORWARD:
        raise AssertionError(f"Fourier model: card against CPU {rel} > {TOL_FORWARD}")
    del f_model

    schedule = cfg.sigma_schedule
    clean = concat_batches([repeat_batch(j.batch, ORACLE_POSES)
                            for j in jobs[:ORACLE_COMPLEXES]]).replace(names=(), meta=())
    B, T = clean.batch_size, clean.num_torsions
    gen = torch.Generator().manual_seed(SEED)
    prior, noise = draw_prior(B, T, gen, "cpu"), draw_steps(STEPS, B, T, gen, "cpu")
    settings = SamplerSettings(inference_steps=STEPS, no_final_step_noise=True)

    def chain(device):
        b = clean.to(device)
        pr = PriorNoise(*(t.to(device) for t in (prior.tor, prior.quat, prior.tr)))
        st = StepNoise(*(t.to(device) for t in (noise.z_tr, noise.z_rot, noise.z_tor)))
        start = randomize_position(b, pr, schedule.tr_sigma_max)
        return reverse_diffusion(oracle.make_oracle_score_fn(b, schedule), start, schedule,
                                 settings, st).lig_pos.cpu()

    reset_kernel_counts()
    sync(device)
    t0 = time.perf_counter()
    on_device = chain(device)
    sync(device)
    oracle_s = time.perf_counter() - t0
    counts["oracle"] = expect_counts("oracle chain")
    on_cpu = chain("cpu")
    m = clean.lig_mask.double()
    rmsd = lambda a, b: (((a.double() - b.double()) ** 2).sum(-1) * m).sum(-1).div(m.sum(-1)).sqrt()
    r = rmsd(on_device, clean.lig_pos).numpy().reshape(-1, ORACLE_POSES)
    if not all((row < 2.0).sum() >= ORACLE_MIN_RECOVERED and row.min() < 1.0 for row in r):
        raise AssertionError(f"the oracle chain did not recover the poses: {r}")
    drift = rmsd(on_device, on_cpu).numpy()
    if not np.median(drift) <= TOL_ORACLE_RMSD:
        raise AssertionError(f"the oracle chain on the card against the CPU: median "
                             f"{np.median(drift)} A")
    print(f"Fourier model (fresh corpus2-width weights, f32, batch statistics): card against "
          f"CPU forward, max "
          f"|d| / max|CPU| {rel:.2e}, K1 {counts['fourier']['k1']} launches (its convs are "
          f"channelwise). Oracle scores drive the reverse SDE on the card: "
          f"{len(r)} complexes x {ORACLE_POSES} poses x {STEPS} steps in "
          f"{oracle_s:.3f} s, RMSD to the clean pose per complex (median, best) "
          + " ".join(f"({np.median(row):.2f}, {row.min():.2f})" for row in r)
          + f" A; against the same chain on the CPU: median {np.median(drift):.2e}, max "
          f"{drift.max():.2e} A; no kernel launched ({card}) {lap()}", flush=True)
    return counts


# ---- 16. l = 2 features (use_second_order_repr) on the 8-lane kernels

PROBE_DIR = os.path.join(HERE, "runs", "second_order_probe")
# the reference rows of reference.npz (analysis/write_second_order_probe.py):
# the first cached complex at these diffusion times, its ligand moved off the
# cached pose (A), where the norm channel's axis would be rounding noise
PROBE_T = (0.7, 0.3)
PROBE_SHIFT = ((0.5, -0.2, 0.1), (-1.0, 0.3, 0.4))
L2_TRAIN_STEPS = 2              # cli.train steps of batch 24 at corpus2's width
L2_STEP_REPEATS = 2             # timed train steps


def phase_second_order(card, jobs, train_batch, draws):
    """16: the second-order model on the 8-lane kernels.  (a) the probe
    checkpoint's kernel-path f32 forward against its JAX reference; (b) K1
    held conv by conv against its plain version on the 23 calls of one
    40-pose forward, f32 and bf16, and the forward against the plain convs;
    (c) K2 and K3 held against their plain versions on the 17 + 6 convs of
    one training-mode forward; (d) a train step, kernels against plain
    convs, same draws, from fresh weights (the gradient as one vector at
    f32 and at bf16); (e) FitEngine serves the probe on phase 4's 8 complexes x 40 x
    20, K1 exactly 460 a dispatch; (f) ``cli.train.main
    --use_second_order_repr true`` at corpus2's width, bf16, two steps of 24
    and a validation batch, launches exact, the checkpoint reloads.  Returns
    the cases and counts for the report."""
    import numpy as np
    import torch

    from diffphore_torch.cli import train as train_cli
    from diffphore_torch.cli.pipeline import FitEngine
    from diffphore_torch.data.graphs import repeat_batch
    from diffphore_torch.data.transforms import apply_noise, draw_noise
    from diffphore_torch.models.layers import DenseTPConv, set_compute_dtype
    from diffphore_torch.ops import tp_fused
    from diffphore_torch.sampler.sampling import SamplerSettings
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.utils import checkpoints

    t_phase = time.perf_counter()
    cfg, model = checkpoints.load_model_dir(PROBE_DIR, device="cuda")
    convs = [m for m in model.modules() if isinstance(m, DenseTPConv)]
    if not (cfg.use_second_order_repr and cfg.compute_dtype == "bfloat16"
            and (cfg.ns, cfg.nv, cfg.num_conv_layers) == (20, 10, 4)
            and all(tp_fused.lanes(m.tp) == tp_fused.K_PAD_L2 for m in convs)):
        raise AssertionError("the probe is not corpus2's width at bf16 on the 8-lane layout")

    # ---- (a) the kernel-path f32 forward against the JAX reference
    ref = np.load(os.path.join(PROBE_DIR, "reference.npz"))
    first = jobs[0].batch.to("cuda")
    rows = repeat_batch(first, len(PROBE_T))
    rows = rows.replace(t=torch.tensor(PROBE_T, dtype=torch.float32, device="cuda"),
                        lig_pos=rows.lig_pos + torch.tensor(PROBE_SHIFT, device="cuda")[:, None])
    set_compute_dtype(model, "float32")
    reset_kernel_counts()
    with torch.inference_mode():
        out = model(rows)
        torch.cuda.synchronize()
        expect_counts("the probe's forward", eval_batches=1, l2=True)
        set_use_kernel(model, False)
        plain = model(rows)
        set_use_kernel(model, True)
    set_compute_dtype(model, cfg.compute_dtype)
    for name, o, p in zip(("tr", "rot", "tor"), out, plain):
        want = ref[name]
        o, p = o.float().cpu().numpy(), p.float().cpu().numpy()
        # of max|JAX|, and of the reference tests' scale max(max|JAX|, 1)
        # (tests/test_torch_score_model.py)
        top = float(np.abs(want).max())
        err = float(np.abs(o - want).max()) / max(top, 1e-30)
        err_plain = float(np.abs(p - want).max()) / max(top, 1e-30)
        err_unit = float(np.abs(o - want).max()) / max(top, 1.0)
        err_kp = float(np.abs(o - p).max()) / max(float(np.abs(p).max()), 1e-30)
        print(f"second order: probe {name} (f32) against the JAX reference, of max|JAX| "
              f"{top:.4g}: kernels {err:.2e}, plain convs on the card {err_plain:.2e} (kernels "
              f"{err_unit:.2e} of max(max|JAX|, 1)); kernels against plain convs {err_kp:.2e} "
              "of max|plain|", flush=True)
        if not (err <= TOL_F32 and err_unit <= TOL_F32 and err_kp <= TOL_F32):
            raise AssertionError(f"probe {name}: {err} of max|JAX| (or {err_unit} of "
                                 f"max(max|JAX|, 1)) or {err_kp} against the plain convs "
                                 f"> {TOL_F32}")

    # ---- (b) K1 on the 23 conv calls of one 40-pose forward
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    batch = posed_rows(first, POSES, cfg, gen)
    print("second order, kernel check: tp_fused (8 lanes) on the 23 conv calls of one forward",
          flush=True)
    k1_cases = phase_kernel_check(model, batch, tp_fused)
    check_forward(model, batch, cfg.compute_dtype, what="second-order forward")
    t_k1 = time.perf_counter()

    # ---- (c) K2 and K3 on the convs of one training-mode forward
    with torch.no_grad():
        noised, _ = apply_noise(train_batch, cfg.sigma_schedule, draws=draws)
    _, train_model = checkpoints.load_model_dir(PROBE_DIR, device="cuda")
    k2_calls, k3_calls = capture_training_convs(train_model, noised)
    print(f"second order, kernel check: tp_aggregate (8 lanes) on the {K2_CONVS} conv calls it "
          "takes of one training-mode forward", flush=True)
    k2_cases = phase_k2_check(k2_calls)
    print(f"second order, kernel check: tp_scalar (8 lanes) on the {K3_CONVS} layer-0 convs",
          flush=True)
    k3_cases = phase_k3_check(k3_calls)
    del train_model, noised, k2_calls, k3_calls
    torch.cuda.empty_cache()
    t_k23 = time.perf_counter()

    # ---- (d) a train step, kernels against plain convs, from fresh weights,
    # on phase 6's draws (the K2/K3 check's draws take every noise level,
    # t = 0.02 included, where the model sits on a step function)
    B = train_batch.batch_size
    gen_d = torch.Generator(device="cuda")
    gen_d.manual_seed(SEED)
    draws = draw_noise(B, train_batch.num_torsions, gen_d, "cuda")
    results = {}
    for dtype in ("float32", "bfloat16"):
        cfg_d = dataclasses.replace(cfg, compute_dtype=dtype)
        step_d = make_train_step(cfg_d)
        for use_kernel in (True, False):
            state = create_train_state(cfg_d, seed=SEED, device="cuda")
            set_use_kernel(state.model, use_kernel)
            drop = torch.Generator(device="cuda")
            drop.manual_seed(SEED + 1)
            reset_kernel_counts()
            state, metrics = step_d(state, train_batch, drop, draws=draws)
            torch.cuda.synchronize()
            expect_counts(f"second-order {dtype} step with use_kernel={use_kernel}",
                          steps=1 if use_kernel else 0, l2=True)
            results[dtype, use_kernel] = (float(metrics["loss"]),
                                          {k: p.grad.clone()
                                           for k, p in state.model.named_parameters()})
            del state
    compare_bf16_step("second-order train step (bf16)", results)
    # f32: the loss, and the gradient as one vector.  Leaf by leaf it is not
    # held: from these fresh weights one element sits on a step function that
    # 1e-7 of relative noise in the plain convs' outputs flips as the kernels'
    # rounding does, moving phore_to_lig_conv_1's edge MLP by 1.2e-3 of its
    # scale either way (PERF.md)
    (loss_k, gk), (loss_p, gp) = results["float32", True], results["float32", False]
    names = [k for k, v in gp.items() if v.numel()]
    flat = lambda d: torch.cat([d[k].flatten() for k in names])
    err = float((flat(gk) - flat(gp)).norm()) / float(flat(gp).norm())
    leaf_err = {k: float((gk[k] - gp[k]).abs().max()) / max(float(gp[k].abs().max()), 1e-30)
                for k in names}
    worst = max(names, key=leaf_err.get)
    print(f"second-order train step (f32), kernels vs plain convs, same draws: loss "
          f"{loss_k:.6f} vs {loss_p:.6f}; gradient over {len(names)} leaves, L2 |kernel - plain| "
          f"/ |plain| {err:.2e} (the worst leaf {worst}: {leaf_err[worst]:.2e} of its scale)",
          flush=True)
    if not (err <= TOL_STEP_GRAD and abs(loss_k - loss_p) <= TOL_STEP_GRAD * abs(loss_p)):
        raise AssertionError(f"second-order f32 step: gradient {err} or loss {loss_k} vs "
                             f"{loss_p} beyond {TOL_STEP_GRAD}")
    del results, gk, gp
    state = create_train_state(cfg, seed=SEED, device="cuda")
    step = make_train_step(cfg)
    drop = torch.Generator(device="cuda")
    drop.manual_seed(SEED + 2)
    run_step = lambda: step(state, train_batch, drop, draws=draws)
    step_ms, step_peak = timed_steps(run_step, L2_STEP_REPEATS)
    step_busy = profiled_busy_ms(run_step)
    del state
    torch.cuda.empty_cache()
    print(f"second-order train step at bf16, batch {B}: {step_ms:.1f} ms wall, {step_busy:.1f} ms "
          f"busy on the card (torch.profiler), peak memory {step_peak:.2f} GiB ({card})",
          flush=True)
    t_step = time.perf_counter()

    # ---- (e) serving: FitEngine on phase 4's complexes
    engine = FitEngine(cfg, model, samples_per_complex=POSES,
                       settings=SamplerSettings(inference_steps=STEPS), seed=SEED, device="cuda")
    engine.run_complexes(jobs[:1])          # warm-up
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    served = engine.run_complexes(jobs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serving = expect_counts("second-order serving",
                            k1=len(jobs) * CONVS_PER_FORWARD * STEPS, l2=True)
    for job, r in zip(jobs, served):
        if r["poses"].shape != (POSES, job.n_atoms, 3) or not np.isfinite(r["poses"]).all() \
                or not np.isfinite(r["fitscore"]).all():
            raise AssertionError(f"second order {r['name']}: poses or fitscores not finite")
    poses_per_s = len(jobs) * POSES / serve_s
    print(f"second-order serving: {len(jobs)} complexes x {POSES} poses x {STEPS} steps in "
          f"{serve_s:.3f} s = {poses_per_s:.1f} poses/s ({card}); K1 (8 lanes) launches "
          f"{serving['k1_l2']} ({serving['k1_l2'] // len(jobs)} per dispatch)", flush=True)
    t_serve = time.perf_counter()

    # ---- (f) the training CLI with --use_second_order_repr true
    with tempfile.TemporaryDirectory() as tmp:
        copy_bucket(TRAIN_CACHE_DIR, os.path.join(tmp, "train_l2"), L2_TRAIN_STEPS * TRAIN_BATCH)
        copy_bucket(CACHE_DIR, os.path.join(tmp, "val_l2"), VAL_COMPLEXES)
        run_dir = os.path.join(tmp, "run")
        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        train_cli.main([
            "--cache_path", tmp, "--run_dir", run_dir, "--n_epochs", "1",
            "--batch_size", str(TRAIN_BATCH), "--seed", str(SEED), "--val_inference_freq", "0",
            "--ns", str(cfg.ns), "--nv", str(cfg.nv), "--num_conv_layers",
            str(cfg.num_conv_layers), "--dropout", str(cfg.dropout), "--compute_dtype",
            "bfloat16", "--use_second_order_repr", "true", "--lr", "0.001"])
        torch.cuda.synchronize()
        cli_counts = expect_counts("cli.train.main --use_second_order_repr true",
                                   steps=L2_TRAIN_STEPS, eval_batches=1, l2=True)
        cli_peak = torch.cuda.max_memory_allocated() / 2**30
        records = read_records(run_dir)
        rec = [r for r in records if r.get("mode") != "val"][0]
        val = [r for r in records if r.get("mode") == "val"][0]
        if rec["steps"] != L2_TRAIN_STEPS or rec["grad_finite"] != 1.0 \
                or not all(np.isfinite(rec[k]) for k in ("loss", "tr_loss", "rot_loss",
                                                        "tor_loss")) \
                or not np.isfinite(val["loss"]):
            raise AssertionError(f"second-order training metrics not as expected: {rec} {val}")
        run_cfg, reloaded = checkpoints.load_model_dir(
            run_dir, device="cuda", checkpoint=checkpoints.LAST_MODEL, use_ema=True)
        if not run_cfg.use_second_order_repr or (run_cfg.ns, run_cfg.nv) != (cfg.ns, cfg.nv):
            raise AssertionError("the run directory's config is not the second-order model")
        with torch.no_grad():
            out = reloaded(train_batch.replace(t=torch.full((B,), 0.5, device="cuda")))
        if not all(bool(torch.isfinite(o).all()) for o in out):
            raise AssertionError("the reloaded second-order checkpoint's forward is not finite")
    print(f"second-order cli.train.main: {rec['steps']} steps of batch {TRAIN_BATCH} in "
          f"{rec['epoch_time']:.3f} s, train loss {rec['loss']:.4f}, val loss {val['loss']:.4f}, "
          f"peak memory {cli_peak:.2f} GiB; launches {cli_counts}; the checkpoint reloads "
          f"({card})", flush=True)
    t_end = time.perf_counter()
    print(f"second order: phase {t_end - t_phase:.1f} s (probe and K1 {t_k1 - t_phase:.1f}, "
          f"K2/K3 {t_k23 - t_k1:.1f}, train steps {t_step - t_k23:.1f}, serving "
          f"{t_serve - t_step:.1f}, cli {t_end - t_serve:.1f})", flush=True)
    return {"k1_cases": k1_cases, "k2_cases": k2_cases, "k3_cases": k3_cases,
            "serving": serving, "cli": cli_counts, "poses_per_s": poses_per_s,
            "step_ms": step_ms, "step_busy_ms": step_busy, "step_peak_gib": step_peak}


KNN = 24                        # phore_knn of the KNN path (runs/knn_probe)
KNN_EXACT = 40                  # at least the largest in-degree of these phores
KNN_PROBE_DIR = os.path.join(HERE, "runs", "knn_probe")
KNN_STEP_REPEATS = 2            # timed train steps
KNN_SCREEN_ROW = "EX01"         # examples/task.csv's row served by cli.inference
# FitEngine runs, in turns: (model, half of phase 4's complexes), so each
# model serves every complex once and the two sit symmetric in the window
KNN_SERVING_TURNS = (("dense", 0), ("KNN", 0), ("KNN", 1), ("dense", 1))


def max_in_degree(batch) -> int:
    """The most senders a receiver of a (cached) batch's phore graph has."""
    m = batch.phore_mask
    return int((batch.phore_edge_mask & m[:, :, None] & m[:, None, :]).sum(-1).max())


def knn_model_dir(tmp, src_dir, knn):
    """A model directory under ``tmp``: ``src_dir``'s model_parameters.yml
    with ``phore_knn: knn`` and its weights (linked: the option adds no
    parameter)."""
    from diffphore_torch.utils.checkpoints import BEST_EMA_MODEL

    out = os.path.join(tmp, f"{os.path.basename(src_dir)}_knn{knn}")
    os.makedirs(out)
    with open(os.path.join(src_dir, "model_parameters.yml")) as f:
        text = f.read()
    if "phore_knn: 0\n" not in text:
        raise RuntimeError(f"{src_dir}: model_parameters.yml has no phore_knn: 0")
    with open(os.path.join(out, "model_parameters.yml"), "w") as f:
        f.write(text.replace("phore_knn: 0\n", f"phore_knn: {knn}\n"))
    os.symlink(os.path.join(src_dir, BEST_EMA_MODEL), os.path.join(out, BEST_EMA_MODEL))
    return out


def capture_index_calls(model, batch, poses=POSES):
    """(name, module, args, sender index) of the sender-index conv calls of
    one eval forward: the KNN_CONVS phore convs of a KNN model."""
    import torch

    from diffphore_torch.models.layers import DenseTPConv

    calls = []
    hooks = [mod.register_forward_hook(
        lambda m, args, kwargs, out, name=name: calls.append(
            (name, m, args, kwargs.get("sender_index"))), with_kwargs=True)
        for name, mod in model.named_modules() if isinstance(mod, DenseTPConv)]
    with torch.inference_mode():
        model(batch, pose_group=poses)
    for h in hooks:
        h.remove()
    indexed = [c for c in calls if c[3] is not None]
    if len(calls) != CONVS_PER_FORWARD or len(indexed) != KNN_CONVS:
        raise RuntimeError(f"captured {len(calls)} conv calls, {len(indexed)} with a sender "
                           f"index; expected {CONVS_PER_FORWARD} and {KNN_CONVS}")
    return indexed


def phase_k1_index_check(calls):
    """K1's sender-index mode against its plain version on captured phore
    conv calls, at f32 and bf16, reruns bit-equal; timed (graph replay and
    per call from Python) beside the plain version and the bound.  Returns
    the cases in phase_kernel_check's form."""
    import torch

    from diffphore_torch.ops import tp_fused

    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for name, mod, args, idx in calls:
        sender, edge_attr, edge_sh, edge_mask, *_ = args
        tp = mod.tp
        x, sh = sender.to(f32).contiguous(), edge_sh.to(f32).contiguous()
        attrs, masks = [edge_attr.to(f32).contiguous()], [edge_mask.contiguous()]
        params = (mod.fc_w1.detach(), mod.fc_b1.detach(), mod.fc_w2.detach(), mod.fc_b2.detach())
        low = (x.to(bf16), sh.to(bf16), [a.to(bf16) for a in attrs])
        kw = {"sender_index": idx}
        with torch.inference_mode():
            ref = tp_fused.tp_aggregate_fused_plain(tp, x, sh, attrs, masks, *params, **kw)
            got = tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params, **kw)
            again = tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params, **kw)
            ref_bf = tp_fused.tp_aggregate_fused_plain(tp, *low, masks, *params, **kw)
            got_bf = tp_fused.tp_aggregate_fused(tp, *low, masks, *params, **kw)
            again_bf = tp_fused.tp_aggregate_fused(tp, *low, masks, *params, **kw)
            torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(got_bf, again_bf)):
            raise AssertionError(f"{name}: two runs of the sender-index tp_fused differ")
        scale, scale_bf = float(ref.abs().max()), float(ref_bf.abs().max())
        err, err_bf = float((got - ref).abs().max()), float((got_bf - ref_bf).abs().max())
        if not err <= TOL_F32 * max(scale, 1e-30):
            raise AssertionError(f"{name}: f32 |kernel - plain| {err} > {TOL_F32} * {scale}")
        if not err_bf <= TOL_BF16 * max(scale_bf, 1e-30):
            raise AssertionError(f"{name}: bf16 |kernel - plain| {err_bf} > {TOL_BF16} * "
                                 f"{scale_bf}")
        with torch.inference_mode():
            call = lambda: tp_fused.tp_aggregate_fused(tp, x, sh, attrs, masks, *params, **kw)
            ms = device_ms(call, 20)
            ms_bf = device_ms(lambda: tp_fused.tp_aggregate_fused(tp, *low, masks, *params, **kw),
                              20)
            call_ms = cuda_ms(call, 20)
            plain_ms = cuda_ms(lambda: tp_fused.tp_aggregate_fused_plain(
                tp, x, sh, attrs, masks, *params, **kw), 5)
        nbytes, mm_ops, vec_ops = k1_work(tp, x, sh, attrs, masks, params[0], params[2], idx)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, (mm_ops + vec_ops) / PEAK_F32 * 1e3
        nbytes_bf, _, _ = k1_work(tp, *low, masks, params[0], params[2], idx)
        bound_bf = max(nbytes_bf / PEAK_BYTES * 1e3,
                       max(mm_ops / PEAK_BF16, vec_ops / PEAK_F32) * 1e3)
        B, N, K, _ = sh.shape
        l2 = tp_fused.lanes(tp) == tp_fused.K_PAD_L2
        if l2:
            per_block, splits, channel_tiles, blocks = tp_fused.grid_l2(tp, B, N, K)
        else:
            per_block, splits = tp_fused.plan_senders(B, N, K)
            channel_tiles, blocks = 1, B * -(-N // tp_fused.TILE_N) * splits
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        cases.append({
            "conv": name, "B": B, "N": N, "K": K, "M_x": x.shape[1], "F": tp.weight_numel,
            "lanes": tp_fused.lanes(tp), "splits": splits, "channel_tiles": channel_tiles,
            "blocks": blocks, "max_abs_err": err,
            "max_abs_err_bf16": err_bf, "max_rel_err_bf16": err_bf / max(scale_bf, 1e-30),
            "max_abs_ref": scale, "ms": ms, "ms_bf16": ms_bf, "bound_ms_bf16": bound_bf,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": bound_by})
        print(f"  {name:28s} B={B:2d} N={N:3d} K={K} M_x={x.shape[1]} F={tp.weight_numel:3d} "
              f"lanes {tp_fused.lanes(tp)} (grid {blocks} blocks: {splits} slot splits, "
              f"{channel_tiles} channel tiles) err={err:.2e} "
              f"bf16_err={err_bf:.2e} (max|ref| {scale:.2e}) reruns bit-equal  kernel {ms:.4f} ms "
              f"on the card (bf16 {ms_bf:.4f}, bound {bound_bf:.4f}), {call_ms:.4f} ms per call "
              f"from Python  plain {plain_ms:.4f} ms  bound {max(t_bytes, t_ops):.4f} ms "
              f"({bound_by}: bytes {t_bytes:.4f}, operations {t_ops:.4f})", flush=True)
    return cases


def index_library_ms(tp, x, sh, w, g, idx):
    """{kernel: ms} on the card (graph replay) of the PyTorch calls that
    compute the sender-index functions: per path, the gather of the senders
    (an index) and the gathered einsum of the forward and of dw, and for dx
    the per-slot einsum and an ``index_add_`` into the senders."""
    import torch

    from diffphore_torch.ops import tp_scalar
    from diffphore_torch.ops.tp_fused import coupling

    B, N, K, _ = sh.shape
    scalar = tp_scalar.all_scalar_paths(tp)
    bidx = torch.arange(B, device=x.device)[:, None, None]
    flat = (idx.long() + x.shape[1] * bidx).reshape(-1)
    in_slices, sh_slices = tp.irreps_in.slices(), tp.irreps_sh.slices()
    paths = []
    for p in tp.paths:
        d1 = 2 * p.l_in + 1
        paths.append({"x": x[..., in_slices[p.i_in]], "mul": p.mul_in, "d1": d1,
                      "sh": sh[..., sh_slices[p.i_sh]],
                      "c": torch.as_tensor(coupling(p, x.dtype), device=x.device).to(x.dtype),
                      "w": w[..., p.w_slice[0]:p.w_slice[1]],
                      "g": g[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1].to(x.dtype)})

    def xg(pp):
        v = pp["x"][bidx, idx]
        return v if scalar else v.reshape(v.shape[:-1] + (pp["mul"], pp["d1"]))

    def fwd():
        for pp in paths:
            if scalar:
                torch.einsum("bnmu,bnmk,bnmu->bnuk", xg(pp), pp["sh"], pp["w"])
            else:
                torch.einsum("bnmui,bnmj,ijk,bnmu->bnuk", xg(pp), pp["sh"], pp["c"], pp["w"])

    def edge():
        for pp in paths:
            if scalar:
                torch.einsum("bnmu,bnmk,bnuk->bnmu", xg(pp), pp["sh"], pp["g"])
            else:
                torch.einsum("bnmui,bnmj,ijk,bnuk->bnmu", xg(pp), pp["sh"], pp["c"], pp["g"])

    def dx():
        for pp in paths:
            if scalar:
                per = torch.einsum("bnmk,bnmu,bnuk->bnmu", pp["sh"], pp["w"], pp["g"])
            else:
                per = torch.einsum("bnmj,ijk,bnmu,bnuk->bnmui", pp["sh"], pp["c"], pp["w"],
                                   pp["g"])
            out = torch.zeros((B * x.shape[1],) + per.shape[3:], dtype=per.dtype,
                              device=x.device)
            out.index_add_(0, flat, per.reshape((-1,) + per.shape[3:]))

    with torch.no_grad():
        return {"fwd": device_ms(fwd, 5), "bwd_edge": device_ms(edge, 5),
                "bwd_x": device_ms(dx, 5)}


def index_k23_check(model, batch):
    """K2's and K3's sender-index mode held (phase_k2_check,
    phase_k3_check) on the phore conv calls of one training-mode forward of
    a KNN model -> (K2 cases, K3 cases)."""
    k2_calls, k3_calls = capture_training_convs(model, batch)
    k2_calls, k3_calls = ([c for c in calls if c[6] is not None] for calls in (k2_calls, k3_calls))
    names = [c[0] for c in k3_calls + k2_calls]
    if names != [f"encoder.phore_conv_{i}" for i in range(KNN_CONVS)]:
        raise AssertionError(f"sender-index training calls {names}")
    return phase_k2_check(k2_calls), phase_k3_check(k3_calls)


# The CUDA kernels behind each sender-index K2 wrapper (at 4 and 8 lanes): the
# forward makes w's live bits (for itself and dx), then the tiled forward on
# the live tiles (and the sum of the slot splits where they split); dx reads
# the live bits and chunk lists that the autograd forward makes for it.
K2_DEVICE_KERNELS_IDX = {
    "fwd": ["tp_aggregate_l2_live_kernel", "tp_aggregate_fwd_idx_tiled_kernel",
            "tp_aggregate_sum_splits"],
    "bwd_edge": ["tp_aggregate_bwd_edge_idx_kernel"],
    "bwd_x": ["tp_aggregate_bwd_x_idx_l2_kernel", "tp_aggregate_bwd_x_idx_sum"],
}


# ... and behind each sender-index K3 wrapper: the forward and dw one kernel
# each (at both lane counts), dx three.
K3_DEVICE_KERNELS_IDX = {
    "fwd": ["tp_scalar_idx_kernel<T, LANES, VEC, DW = false>"],
    "bwd_edge": ["tp_scalar_idx_kernel<T, LANES, VEC, DW = true>"],
    "bwd_x": ["tp_scalar_bwd_x_idx_slots", "tp_scalar_bwd_x_idx_chunks",
              "tp_scalar_bwd_x_idx_sum"],
}


def index_entries(k1_cases, k2_cases, k3_cases, serving, training, l2=False):
    """The report entries of the sender-index kernels (``l2``: the 8-lane
    instantiations): K1's over the phore convs of one 40-pose forward, K2's
    and K3's over those of one train step; launches from the KNN serving
    run and the KNN train step."""
    suffix = "_idx" + ("_l2" if l2 else "")
    k1 = k1_entry("tp_fused" + suffix, k1_cases, serving["k1" + suffix])
    k1["device_kernels"] = (["tp_fused_l2_kernel with a sender index", "tp_fused_l2_sum_splits"]
                            if l2 else ["tp_fused_kernel<T, NC, IDX = true>",
                                        "tp_fused_kernel_sum_splits"])
    k1["unit"] = (f"one forward: the {KNN_CONVS} phore conv calls (K = {KNN}), each timed "
                  "alone; ms on the card (graph replay), f32 inputs (ms) and bf16 ones "
                  "(ms_bf16), call_ms per call from Python")
    entries = [k1]
    labels = {"fwd": ("out",), "bwd_edge": ("dw",), "bwd_x": ("dx",)}
    for family, cases, prefix, source, replaces in (
            ("tp_aggregate", k2_cases, "", "diffphore_torch/csrc/tp_aggregate.cu",
             "diffphore_tpu/ops/pallas/tp_aggregate.py:88"),
            ("tp_scalar", k3_cases, "k3_", "diffphore_torch/csrc/tp_scalar.cu",
             "diffphore_tpu/ops/pallas/tp_scalar.py:43")):
        for k, outputs in labels.items():
            by = {"bytes": 0.0, "operations": 0.0}
            for c in cases:
                by[c["bound"][k][1]] += c["bound"][k][0]
            entries.append({
                "name": f"{family}_{k}{suffix}", "route": "cuda", "source": source,
                "replaces": replaces, "launches": training[prefix + k + suffix],
                "max_abs_err": max(c["errs"][o][0] for c in cases for o in outputs),
                "max_rel_err": max(c["errs"][o][0] / max(c["errs"][o][1], 1e-30)
                                   for c in cases for o in outputs),
                "ms": sum(c["ms"][k] for c in cases),
                "plain_ms": sum(c["plain_ms"][k] for c in cases),
                "bound_ms": sum(c["bound"][k][0] for c in cases),
                "bound_by": "operations" if by["operations"] >= by["bytes"] else "bytes",
                "library_ms": sum(c["library_ms"][k] for c in cases),
                "ms_bf16": sum(c["ms_bf16"][k] for c in cases),
                "bound_ms_bf16": sum(c["bound_bf16"][k][0] for c in cases),
                "library_ms_bf16": sum(c["library_ms_bf16"][k] for c in cases),
                "max_abs_err_bf16": max(c["errs_bf16"][o][0] for c in cases for o in outputs),
                "unit": f"one train step: the {len(cases)} phore conv call(s) on this kernel "
                        f"(K = {KNN}), each timed alone on the card (graph replay; dx with the "
                        "index's inverse lists (K3: and slot chunks) built beforehand, as the "
                        "forward builds them"
                        + ("; K2's forward includes the live pass over w that it runs for "
                           "itself and dx, live_ms that pass alone, and dx reads the bits made "
                           "beforehand" if family == "tp_aggregate" else "") + "), "
                        "f32 (ms) and bf16 (ms_bf16) operands; library_ms is the gather of the "
                        "senders and the gathered per-path torch.einsum (dx: the per-slot "
                        "einsum and index_add_), by graph replay",
            })
            if family == "tp_aggregate":
                entries[-1]["device_kernels"] = K2_DEVICE_KERNELS_IDX[k]
                if k == "fwd":
                    entries[-1]["live_ms"] = sum(c["live_ms"] for c in cases)
                    entries[-1]["live_ms_bf16"] = sum(c["live_ms_bf16"] for c in cases)
            else:
                entries[-1]["device_kernels"] = K3_DEVICE_KERNELS_IDX[k]
    return entries


def phase_knn(card, jobs, train_batch, draws, main_poses_per_s=None):
    """17: the KNN phore grid (phore_knn) on the kernels' sender-index mode.
    (a) K1 held against its plain version on the 3 phore conv calls of one
    40-pose eval forward of corpus2 at K = 24 (a complex whose phore K = 24
    compacts), K2 and K3 on the phore conv calls of one training-mode
    forward of the 24-complex batch; the same at 8 lanes on the second-order
    probe's weights at K = 24.  (b) serving at bf16 from a model directory
    with phore_knn: 24: ``cli.inference.main`` on one SDF row and
    ``FitEngine`` on phase 4's complexes x 40 x 20 in turns with the dense
    model over their two halves (dense, KNN on the first; KNN, dense on the
    second), K1 exactly 400 dense + 60 sender-index
    launches a KNN dispatch, poses/s beside the dense model's and phase 4's;
    the probe's f32 forward against runs/knn_probe/reference.npz; K = 40
    against the dense model.  (c) a train step at K = 24, kernels against
    plain convs (f32 and bf16), K2 15 + 2 and K3 5 + 1 a kernel, its wall,
    busy time and peak memory; the 8-lane serving dispatch and step.
    Returns the report entries."""
    import contextlib
    import io

    import numpy as np
    import torch

    from diffphore_torch.cli import inference as cli
    from diffphore_torch.cli.pipeline import FitEngine
    from diffphore_torch.data.graphs import concat_batches, load_cached
    from diffphore_torch.data.transforms import apply_noise, draw_noise
    from diffphore_torch.models.layers import set_compute_dtype
    from diffphore_torch.sampler.sampling import SamplerSettings
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.utils import checkpoints

    t_phase = time.perf_counter()
    per_dispatch = dict(k1=(CONVS_PER_FORWARD - KNN_CONVS) * STEPS, k1_idx=KNN_CONVS * STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        knn_dir = knn_model_dir(tmp, MODEL_DIR, KNN)
        cfg, model = checkpoints.load_model_dir(knn_dir, device="cuda")
        if not (cfg.phore_knn == KNN and cfg.compute_dtype == "bfloat16"
                and (cfg.ns, cfg.nv, cfg.num_conv_layers) == (20, 10, 4)):
            raise AssertionError("the KNN model is not corpus2 at bf16 with phore_knn 24")
        knn_job = next(j for j in jobs if max_in_degree(j.batch) > KNN)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        batch = posed_rows(knn_job.batch.to("cuda"), POSES, cfg, gen)

        # ---- (a) the kernel checks, 4 lanes
        print(f"KNN, kernel check: tp_fused's sender-index mode on the {KNN_CONVS} phore conv "
              f"calls of one forward of {knn_job.name} (largest in-degree "
              f"{max_in_degree(knn_job.batch)} > K = {KNN})", flush=True)
        k1_cases = phase_k1_index_check(capture_index_calls(model, batch))
        with torch.no_grad():
            noised, _ = apply_noise(train_batch, cfg.sigma_schedule, draws=draws)
        _, train_model = checkpoints.load_model_dir(knn_dir, device="cuda")
        print("KNN, kernel check: tp_scalar's and tp_aggregate's sender-index mode on the phore "
              f"conv calls of one training-mode forward (batch {train_batch.batch_size})",
              flush=True)
        k2_cases, k3_cases = index_k23_check(train_model, noised)
        del train_model
        t_a = time.perf_counter()

        # ---- (b) serving: the probe, K = 40 against the dense grid, the CLI,
        # FitEngine
        rows = concat_batches([load_cached(f) for f in knn_probe_files()]).replace(
            names=(), meta=()).to("cuda")
        rows = rows.replace(t=torch.tensor(PROBE_T, dtype=torch.float32, device="cuda"),
                            lig_pos=rows.lig_pos + torch.tensor(PROBE_SHIFT, device="cuda")[:, None])
        ref = np.load(os.path.join(KNN_PROBE_DIR, "reference.npz"))
        set_compute_dtype(model, "float32")
        with torch.inference_mode():
            out = model(rows)
        for name, o in zip(("tr", "rot", "tor"), out):
            want = ref[name]
            err = float(np.abs(o.float().cpu().numpy() - want).max()) / float(np.abs(want).max())
            print(f"KNN: probe {name} (f32, kernels) against the JAX reference: {err:.2e} of "
                  f"max|JAX| {float(np.abs(want).max()):.4g}", flush=True)
            if not err <= TOL_F32:
                raise AssertionError(f"KNN probe {name}: {err} of max|JAX| > {TOL_F32}")
        _, exact = checkpoints.load_model_dir(knn_model_dir(tmp, MODEL_DIR, KNN_EXACT),
                                              device="cuda")
        _, dense = checkpoints.load_model_dir(MODEL_DIR, device="cuda")
        for m in (exact, dense):
            set_compute_dtype(m, "float32")
        if max_in_degree(knn_job.batch) > KNN_EXACT:
            raise AssertionError(f"K = {KNN_EXACT} is not exact on {knn_job.name}")
        with torch.inference_mode():
            for name, a, b in zip(("tr", "rot", "tor"), exact(batch, pose_group=POSES),
                                  dense(batch, pose_group=POSES)):
                err = float((a - b).abs().max()) / float(b.abs().max())
                print(f"KNN: K = {KNN_EXACT} against the dense grid, {name} (f32, kernels): "
                      f"{err:.2e} of max|dense|", flush=True)
                if not err <= TOL_F32:
                    raise AssertionError(f"K = {KNN_EXACT} {name}: {err} > {TOL_F32}")
        set_compute_dtype(model, cfg.compute_dtype)
        set_compute_dtype(dense, cfg.compute_dtype)
        del exact

        task = os.path.join(tmp, "task.csv")
        with open(os.path.join(HERE, "examples", "task.csv")) as f:
            lines = f.read().splitlines()
        examples = os.path.join(HERE, "examples") + os.sep
        with open(task, "w") as f:      # the row's paths made absolute
            f.write("\n".join([lines[0]] + [r.replace("examples/", examples) for r in lines[1:]
                                            if r.startswith(KNN_SCREEN_ROW + ",")]) + "\n")
        reset_kernel_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["--phore_ligand_csv", task, "--model_dir", knn_dir, "--out_dir",
                      os.path.join(tmp, "screen"), "--sample_per_complex", str(POSES),
                      "--inference_steps", str(STEPS), "--prefetch_workers", "0",
                      "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_counts = expect_counts("KNN cli.inference.main", knn=True, **per_dispatch)
        if not os.path.exists(os.path.join(tmp, "screen", "ranked_results.csv")):
            raise AssertionError("KNN cli.inference.main wrote no ranked_results.csv")
        print(f"KNN cli.inference.main: one complex x {POSES} poses x {STEPS} steps in "
              f"{cli_s:.2f} s; launches {cli_counts}", flush=True)

        engines = {label: FitEngine(c, m, samples_per_complex=POSES,
                                    settings=SamplerSettings(inference_steps=STEPS), seed=SEED,
                                    device="cuda")
                   for label, c, m in (("dense", dataclasses.replace(cfg, phore_knn=0), dense),
                                       ("KNN", cfg, model))}
        for engine in engines.values():
            engine.run_complexes(jobs[:1])          # warm-up
        torch.cuda.synchronize()
        halves = (jobs[:len(jobs) // 2], jobs[len(jobs) // 2:])
        turns = []                                  # (label, complexes, seconds)
        serving = {}
        for label, half in KNN_SERVING_TURNS:
            part = halves[half]
            reset_kernel_counts()
            t0 = time.perf_counter()
            served = engines[label].run_complexes(part)
            torch.cuda.synchronize()
            turns.append((label, len(part), time.perf_counter() - t0))
            if label == "dense":
                expect_counts("dense serving", k1=len(part) * CONVS_PER_FORWARD * STEPS)
                continue
            counts = expect_counts("KNN serving", knn=True,
                                   **{k: len(part) * v for k, v in per_dispatch.items()})
            serving = {k: serving.get(k, 0) + v for k, v in counts.items()}
            for job, r in zip(part, served):
                if r["poses"].shape != (POSES, job.n_atoms, 3) \
                        or not np.isfinite(r["poses"]).all() \
                        or not np.isfinite(r["fitscore"]).all():
                    raise AssertionError(f"KNN serving {r['name']}: not finite")
        knn_rate, dense_rate = (sum(n for k, n, _ in turns if k == label) * POSES
                                / sum(t for k, _, t in turns if k == label)
                                for label in ("KNN", "dense"))
        print(f"KNN serving: {len(jobs)} complexes x {POSES} poses x {STEPS} steps at "
              f"{knn_rate:.1f} poses/s against the dense model's {dense_rate:.1f}, in turns of "
              "half the complexes each "
              + " ".join(f"{k} {n * POSES / t:.1f}" for k, n, t in turns)
              + ("" if main_poses_per_s is None else f"; phase 4 {main_poses_per_s:.1f}")
              + f" ({card}); K1 launches {serving['k1']} dense + {serving['k1_idx']} "
              f"sender-index ({serving['k1'] // len(jobs)} + {serving['k1_idx'] // len(jobs)} "
              "a dispatch)", flush=True)
        del dense, engines
        t_b = time.perf_counter()

        # ---- (c) a train step at K = 24, kernels against plain convs
        B = train_batch.batch_size
        gen_c = torch.Generator(device="cuda")
        gen_c.manual_seed(SEED)
        step_draws = draw_noise(B, train_batch.num_torsions, gen_c, "cuda")
        results = {}
        for dtype in ("float32", "bfloat16"):
            cfg_d = dataclasses.replace(cfg, compute_dtype=dtype)
            step_d = make_train_step(cfg_d)
            for use_kernel in (True, False):
                state = create_train_state(cfg_d, seed=SEED, device="cuda")
                set_use_kernel(state.model, use_kernel)
                drop = torch.Generator(device="cuda")
                drop.manual_seed(SEED + 1)
                reset_kernel_counts()
                state, metrics = step_d(state, train_batch, drop, draws=step_draws)
                torch.cuda.synchronize()
                counts = expect_counts(f"KNN {dtype} step with use_kernel={use_kernel}",
                                       steps=1 if use_kernel else 0, knn=True)
                if use_kernel and dtype == "bfloat16":
                    training = counts
                results[dtype, use_kernel] = (float(metrics["loss"]),
                                              {k: p.grad.clone()
                                               for k, p in state.model.named_parameters()})
                del state
        compare_step_gradients("KNN train step (f32)",
                               [results["float32", True], results["float32", False]])
        compare_bf16_step("KNN train step (bf16)", results)
        del results
        state = create_train_state(cfg, seed=SEED, device="cuda")
        step = make_train_step(cfg)
        drop = torch.Generator(device="cuda")
        drop.manual_seed(SEED + 2)
        run_step = lambda: step(state, train_batch, drop, draws=step_draws)
        step_ms, step_peak = timed_steps(run_step, KNN_STEP_REPEATS)
        step_busy = profiled_busy_ms(run_step)
        del state
        torch.cuda.empty_cache()
        print(f"KNN train step at bf16, batch {B}: {step_ms:.1f} ms wall, {step_busy:.1f} ms busy "
              f"on the card (torch.profiler), peak memory {step_peak:.2f} GiB; launches "
              f"{training} ({card})", flush=True)
        t_c = time.perf_counter()

        # ---- the 8-lane sender-index kernels: the second-order probe's
        # weights at K = 24
        l2_dir = knn_model_dir(tmp, PROBE_DIR, KNN)
        cfg2, model2 = checkpoints.load_model_dir(l2_dir, device="cuda")
        batch2 = posed_rows(knn_job.batch.to("cuda"), POSES, cfg2, gen)
        print("KNN, kernel check at 8 lanes (second-order model): tp_fused", flush=True)
        k1_cases_l2 = phase_k1_index_check(capture_index_calls(model2, batch2))
        _, train2 = checkpoints.load_model_dir(l2_dir, device="cuda")
        with torch.no_grad():
            noised, _ = apply_noise(train_batch, cfg2.sigma_schedule, draws=draws)
        print("KNN, kernel check at 8 lanes: tp_scalar and tp_aggregate", flush=True)
        k2_cases_l2, k3_cases_l2 = index_k23_check(train2, noised)
        del train2, noised
        engine = FitEngine(cfg2, model2, samples_per_complex=POSES,
                           settings=SamplerSettings(inference_steps=STEPS), seed=SEED,
                           device="cuda")
        reset_kernel_counts()
        served = engine.run_complexes([knn_job])
        torch.cuda.synchronize()
        serving_l2 = expect_counts("KNN serving at 8 lanes", knn=True, l2=True, **per_dispatch)
        if not np.isfinite(served[0]["poses"]).all():
            raise AssertionError("KNN serving at 8 lanes: poses not finite")
        state = create_train_state(cfg2, seed=SEED, device="cuda")
        reset_kernel_counts()
        state, metrics = make_train_step(cfg2)(state, train_batch, drop, draws=step_draws)
        torch.cuda.synchronize()
        training_l2 = expect_counts("KNN train step at 8 lanes", steps=1, knn=True, l2=True)
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError("KNN train step at 8 lanes: loss not finite")
        del state, model2, engine
        torch.cuda.empty_cache()
    t_end = time.perf_counter()
    print(f"KNN: phase {t_end - t_phase:.1f} s (kernel checks {t_a - t_phase:.1f}, serving "
          f"{t_b - t_a:.1f}, train steps {t_c - t_b:.1f}, 8 lanes {t_end - t_c:.1f})", flush=True)
    return (index_entries(k1_cases, k2_cases, k3_cases, serving, training)
            + index_entries(k1_cases_l2, k2_cases_l2, k3_cases_l2, serving_l2, training_l2,
                            l2=True))


def knn_probe_files():
    """The cached complexes of runs/knn_probe's reference rows: the first
    two of the bucket whose phore graph K = KNN compacts
    (analysis/write_knn_probe.py)."""
    from diffphore_torch.data.graphs import load_cached

    out = []
    for f in sorted(glob.glob(os.path.join(CACHE_DIR, "*.npz"))):
        b = load_cached(f)
        if (b.num_atoms, b.num_phore, b.num_torsions) == BUCKET and max_in_degree(b) > KNN:
            out.append(f)
        if len(out) == len(PROBE_T):
            return out
    raise RuntimeError(f"fewer than {len(PROBE_T)} complexes of bucket {BUCKET} that K = {KNN} "
                       "compacts")


def knn_alone(card, kind):
    """Phase 17 alone, after the card line and the build: its inputs made
    as main() makes them, then its report entries, the card line and the
    result line."""
    import torch

    from diffphore_torch.cli.pipeline import job_from_cached

    jobs = [job_from_cached(b) for _, b in bucket_complexes(CACHE_DIR, N_COMPLEXES)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    train_batch, draws = recipe_batch(gen)
    entries = phase_knn(card, jobs, train_batch, draws)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def recipe_batch(gen):
    """The first TRAIN_BATCH cached training complexes of the bucket as one
    batch on the card, and noise draws for it from ``gen`` at every noise
    level (t from 0.02 to 0.98)."""
    import torch

    from diffphore_torch.data.graphs import concat_batches
    from diffphore_torch.data.transforms import draw_noise

    train_batch = concat_batches(
        [b for _, b in bucket_complexes(TRAIN_CACHE_DIR, TRAIN_BATCH)]
    ).replace(names=(), meta=()).to("cuda")
    draws = draw_noise(TRAIN_BATCH, BUCKET[2], gen, "cuda")
    draws.t = torch.linspace(0.02, 0.98, TRAIN_BATCH, device="cuda")   # every noise level
    return train_batch, draws


def second_order_entries(second):
    """The report entries of the 8-lane kernels from phase 16's result."""
    return ([k1_entry("tp_fused_l2", second["k1_cases"], second["serving"]["k1_l2"])]
            + k2_kernel_entries(second["k2_cases"], second["cli"], l2=True)
            + k3_kernel_entries(second["k3_cases"], second["cli"], second["cli"], l2=True))


def second_order_alone(card, kind):
    """Phase 16 alone, after the card line and the build: its inputs made as
    main() makes them, then its report entries, the card line and the result
    line."""
    import torch

    from diffphore_torch.cli.pipeline import job_from_cached

    jobs = [job_from_cached(b) for _, b in bucket_complexes(CACHE_DIR, N_COMPLEXES)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    train_batch, draws = recipe_batch(gen)
    second = phase_second_order(card, jobs, train_batch, draws)
    print(json.dumps({"kernels": second_order_entries(second)}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


# Phase 18: the host-only modules.  (a) a synthetic library made by the
# module's CLI, (b) the corpus2 recipe's phase A (runs/corpus2/pipeline.sh:
# the ligand-only pretrain, without augmentation) on it through
# ``cli.train.main``, (c) the AncPhore CLI built from native/ancphore_cli by
# the port's bridge and held against the card's scorer on the ranked poses
# of three screened complexes, (d) the baseline drivers on the same files.
HOST_LIBRARY = 24           # ligands of the library: one batch of the recipe
HOST_WORKERS = 4            # featurization processes of the trainer
HOST_SCREEN = 3             # the SDF rows of examples/task.csv
HOST_COEFFS = {"overlap_coeff": 0.5, "percent_coeff": 0.5}
#: the CLI clamps a negative percent or anchor coefficient to 0 (the JAX
#: package's fitscore does not), so the card's custom fitness is asked for
#: with the anchor coefficient the CLI applies
HOST_CARD_COEFFS = dict(HOST_COEFFS, anchor_coeff=0.0)
#: .score columns held to six significant digits against the CLI's, where
#: the CLI and the port perceive the same ligand features (equal V_db)
HOST_HELD = {6: "V_ref", 7: "V_overlap", 8: "match %", 9: "V_exOverlap", 10: "anchor %",
             11: "ov_pct", 12: "ex_pct", 13: "PhScore1 (raw, col -6)",
             15: "PhScore1 (calibrated)", 16: "PhScore2", 17: "PhScore3", 18: "PhScore4"}
#: columns reported, not held: the CLI's perception of EX03 differs
HOST_REPORTED = {5: "V_db", 14: "fishing"}


#: embeds each row of a library CSV (argv[1]) in 3D and prints, as JSON,
#: whether each came out finite
HOST_EMBED_CHECK = """
import csv, json, sys
import numpy as np
from diffphore_torch.chem.embed import embed_molecule
from diffphore_torch.chem.smiles import mol_from_smiles
finite = []
with open(sys.argv[1], newline="") as f:
    for i, row in enumerate(csv.DictReader(f)):
        mol = mol_from_smiles(row["ligand_description"])
        embed_molecule(mol, seed=i)
        finite.append(bool(np.isfinite(mol.coords).all()))
print(json.dumps(finite))
"""


def sixth_digit_gap(got, want, floor):
    """|got - want| in units of the sixth significant digit of the larger of
    |got|, |want| and ``floor``, a tenth of the quantity's natural scale: a
    value far below its scale (a pose's overlap with a distant sphere, a
    difference of two near-equal terms) is judged at the scale's precision,
    which an f32 sum of double-precision terms can keep, not at its own."""
    import math

    m = max(abs(got), abs(want), floor)
    return round(abs(got - want) / 10 ** (math.floor(math.log10(m)) - 5), 6) if m > 0 else 0.0


def score_table(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def column_gaps(card_rows, cli_rows, columns):
    """{column: the largest sixth-digit gap over the rows}.  Natural scales:
    the reference volume V_ref for V_db, V_ref and V_overlap, the exclusion
    cutoff (500) for V_exOverlap, 1 for the fractions and scores."""
    out = {}
    for col in columns:
        for a, b in zip(card_rows, cli_rows):
            scale = {5: float(b[6]), 6: float(b[6]), 7: float(b[6]), 9: 500.0}.get(col, 1.0)
            gap = sixth_digit_gap(float(a[col]), float(b[col]), 0.1 * scale)
            out[col] = max(out.get(col, 0.0), gap)
    return out


def phase_host_modules(card, device="cuda", poses=POSES, steps=STEPS, config_overrides=None):
    """(a) ``python -m diffphore_torch.data.synth_library``: HOST_LIBRARY
    distinct rows, each parsed and embedded to finite coordinates; (b)
    ``cli.train.main --ligand_only`` on it in the corpus2 recipe's phase A
    (its bucket flags, batch 24, one epoch, HOST_WORKERS processes,
    runs/corpus2/val6.csv): every row featurized, K2 17 x 3 and K3 6 x 3 a
    step and K1 23 a validation batch, exactly, finite losses, a checkpoint
    that reloads, a step's wall, busy time and peak memory; (c) the AncPhore
    CLI built by ``utils/ancphore_bridge.ensure_built`` into build/ancphore
    (native/ untouched), ``cli.inference.main`` on the SDF rows of
    examples/task.csv (K1 exactly HOST_SCREEN x 460), each complex's ranked
    poses scored by the CLI (``calc_phore_fitting``: return_all, fitness 1-6,
    custom coefficients) and by ``ops.fitscore`` on the card, written as a
    .score file, the columns HOST_HELD within one unit of the sixth
    significant digit where the two perceive the same features, the custom
    column against the repaired ``fitscore``; (d) the baseline drivers on
    the same files.  Returns the launch counts of (b) and (c).  With
    ``device="cpu"``, small ``config_overrides`` and fewer ``poses`` and
    ``steps`` it rehearses the phase on the CPU (no count is held)."""
    import csv
    import hashlib

    import numpy as np
    import torch

    from diffphore_torch.baselines import performance_analyze, run_docking, run_ifptarget, \
        run_phore
    from diffphore_torch.chem.pharmacophore_rules import ligand_phore_features, scoring_phore_fp
    from diffphore_torch.chem.sdf import parse_sdf
    from diffphore_torch.chem.smiles import mol_from_smiles
    from diffphore_torch.cli import inference as infer_cli
    from diffphore_torch.cli import train as train_cli
    from diffphore_torch.constants import VDW_TABLE
    from diffphore_torch.data.featurize import load_ligand
    from diffphore_torch.data.loaders import BucketLoader
    from diffphore_torch.data.phore import parse_phore
    from diffphore_torch.ops.fitscore import fitscore, make_phore_arrays
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.utils import ancphore_bridge, checkpoints, flat_yaml

    on_card = device == "cuda"

    def expect(what, **kw):
        return expect_counts(what, **kw) if on_card else kernel_counts()

    def native_digest():
        h = hashlib.sha256()
        root = os.path.join(HERE, "native")
        for d, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                with open(os.path.join(d, f), "rb") as fh:
                    h.update(f.encode() + fh.read())
        return h.hexdigest()

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap():
        """s since the previous lap: each part's share of the phase."""
        laps.append(time.perf_counter())
        return f"[{laps[-1] - laps[-2]:.1f} s]"

    counts, walls = {}, {}
    examples = os.path.join(HERE, "examples")
    phore_file = os.path.join(examples, "example.phore")
    ligands = [os.path.join(examples, f"EX0{i}.sdf") for i in range(1, HOST_SCREEN + 1)]
    native_before = native_digest()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a) the library, through the module's CLI
        lib = os.path.join(tmp, "lib.csv")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "diffphore_torch.data.synth_library", "--n",
                        str(HOST_LIBRARY), "--seed", str(SEED), "--out", lib], check=True,
                       cwd=HERE, capture_output=True)
        walls["library"] = time.perf_counter() - t0
        with open(lib, newline="") as f:
            rows = list(csv.DictReader(f))
        names = [r["name"] for r in rows]
        smiles = [r["ligand_description"] for r in rows]
        if names != [f"synth_{i:05d}" for i in range(HOST_LIBRARY)] \
                or len(set(smiles)) != HOST_LIBRARY:
            raise AssertionError(f"the library's rows: {rows}")
        heavy = [mol_from_smiles(smi).num_atoms for smi in smiles]
        print(f"host modules: synth_library CLI, {HOST_LIBRARY} distinct ligands ({min(heavy)}-"
              f"{max(heavy)} heavy atoms) in {walls['library']:.3f} s = "
              f"{1e3 * walls['library'] / HOST_LIBRARY:.1f} ms per ligand on the host "
              f"(interpreter start-up included) {lap()}", flush=True)
        # each row embedded in 3D in a process of its own, beside the trainer
        embed_check = subprocess.Popen(
            [sys.executable, "-c", HOST_EMBED_CHECK, lib], cwd=HERE, stdout=subprocess.PIPE,
            text=True)

        # ---- (b) the recipe's phase A on the library
        config = flat_yaml.load(os.path.join(MODEL_DIR, "model_parameters.yml"))
        config.update(n_epochs=1, batch_size=TRAIN_BATCH, phore_augment=0, conf_augment=0,
                      **(config_overrides or {}))
        yml = os.path.join(tmp, "phase_a.yml")
        with open(yml, "w") as f:
            f.write(flat_yaml.dumps(config))
        run_dir, cache = os.path.join(tmp, "pretrain"), os.path.join(tmp, "cache")
        built = []
        original = train_cli.PhoreDataset

        class Recording(original):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                built.append(self)

        train_cli.PhoreDataset = Recording
        reset_kernel_counts()
        reset_peak(device)
        t0 = time.perf_counter()
        try:
            train_cli.main(["--config", yml, "--train_csv", lib, "--val_csv",
                            os.path.join(HERE, "runs", "corpus2", "val6.csv"), "--ligand_only",
                            *RECIPE_BUCKET_FLAGS, "--batch_size", str(TRAIN_BATCH),
                            "--n_epochs", "1", "--val_inference_freq", "0",
                            "--num_dataloader_workers", str(HOST_WORKERS), "--cache_path", cache,
                            "--run_dir", run_dir, "--seed", str(SEED), "--device", device])
        finally:
            train_cli.PhoreDataset = original
        sync(device)
        walls["pretrain"] = time.perf_counter() - t0
        records = read_records(run_dir)
        train_rec = [r for r in records if r.get("mode") != "val"]
        val_rec = [r for r in records if r.get("mode") == "val"]
        n_steps = sum(r["steps"] for r in train_rec)
        counts["pretrain"] = expect("ligand-only cli.train.main", steps=n_steps,
                                    eval_batches=len(val_rec))
        train_ds, val_ds = built
        skips = [f for f in os.listdir(train_ds.cache_dir) if f.endswith(".skip")]
        if train_ds.featurized != HOST_LIBRARY or len(train_ds) + len(skips) != HOST_LIBRARY \
                or not len(train_ds) or (n_steps, len(val_rec)) != (1, 1) \
                or not all(np.isfinite(r["loss"]) and r.get("grad_finite", 1.0) == 1.0
                           for r in train_rec) or not np.isfinite(val_rec[0]["loss"]):
            raise AssertionError(f"featurized {train_ds.featurized} of {HOST_LIBRARY} into "
                                 f"{len(train_ds)}, {len(val_ds)} val; records {records}")
        run_cfg, _ = checkpoints.load_model_dir(run_dir, device=device,
                                                checkpoint=checkpoints.LAST_MODEL)
        if (run_cfg.ns, run_cfg.nv, run_cfg.num_conv_layers, run_cfg.compute_dtype) != (
                config["ns"], config["nv"], config["num_conv_layers"], config["compute_dtype"]):
            raise AssertionError(f"the reloaded checkpoint's config: {run_cfg}")
        batch = next(iter(BucketLoader(train_ds, TRAIN_BATCH, shuffle=False)))
        batch = batch.replace(names=(), meta=()).to(device)
        state = create_train_state(run_cfg, seed=SEED, device=device)
        step = make_train_step(run_cfg)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        run_step = lambda: step(state, batch, gen)
        step_ms, peak = timed_steps(run_step, 2, device)
        busy_ms = profiled_busy_ms(run_step) if on_card else 0.0
        del state, batch
        reset_peak(device)
        shape = (train_ds[0].num_atoms, train_ds[0].num_phore, train_ds[0].num_torsions)
        print(f"host modules: cli.train.main --ligand_only on the library (recipe phase A, "
              f"bucket {shape}, {HOST_WORKERS} featurization processes): {train_ds.featurized} "
              f"+ {val_ds.featurized} val records featurized ({len(skips)} + "
              f"{val_ds.featurized - len(val_ds)} past the bucket caps, skipped as the recipe "
              f"skips them), {n_steps} step, losses "
              + " ".join(f"{r['loss']:.4f}" for r in train_rec) + f", val {val_rec[0]['loss']:.4f}"
              + f", {walls['pretrain']:.3f} s (featurization included); launches "
              f"{nonzero(counts['pretrain'])}; checkpoint reloaded; a {run_cfg.compute_dtype} "
              f"step of {TRAIN_BATCH}: wall {step_ms:.1f} ms, busy "
              + (f"{busy_ms:.2f} ms" if busy_ms else "not measured")
              + f", peak memory {peak:.3f} GiB ({card}) {lap()}", flush=True)

        out_check, _ = embed_check.communicate()
        finite = json.loads(out_check)
        if embed_check.returncode != 0 or finite != [True] * HOST_LIBRARY:
            raise AssertionError(f"the library's rows embed to finite coordinates: {finite}")
        print(f"host modules: each of the {HOST_LIBRARY} rows parsed and embedded to finite "
              f"coordinates {lap()}", flush=True)

        # ---- (c) the CLI built by the bridge, against the card's scorer
        build_dir = os.path.join(HERE, "build", "ancphore")
        fresh = not os.path.exists(ancphore_bridge.binary_path())
        t0 = time.perf_counter()
        binary = ancphore_bridge.ensure_built()
        walls["build"] = time.perf_counter() - t0
        if binary is None or os.path.dirname(binary) != build_dir:
            raise AssertionError(f"the AncPhore CLI did not build into {build_dir}: {binary}")
        task = os.path.join(tmp, "task.csv")
        with open(os.path.join(examples, "task.csv")) as f:
            task_rows = [dict(r, ligand_description=os.path.join(HERE, r["ligand_description"]),
                              phore=os.path.join(HERE, r["phore"])) for r in csv.DictReader(f)]
        with open(task, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["name", "ligand_description", "phore"])
            w.writeheader()
            w.writerows(task_rows)
        out = os.path.join(tmp, "screen")
        reset_kernel_counts()
        t0 = time.perf_counter()
        infer_cli.main(["--phore_ligand_csv", task, "--model_dir", MODEL_DIR, "--out_dir", out,
                        "--sample_per_complex", str(poses), "--inference_steps", str(steps),
                        "--device", device, "--prefetch_workers", "0"])
        sync(device)
        walls["screen"] = time.perf_counter() - t0
        counts["screen"] = expect("cli.inference.main on examples/task.csv",
                                  k1=HOST_SCREEN * CONVS_PER_FORWARD * steps if on_card else 0)
        ref = make_phore_arrays(parse_phore(phore_file)[0]).to(device)
        gaps, reported, held, custom_gap, t_cli = {}, {}, [], 0.0, 0.0
        for rec in task_rows:
            name = infer_cli.complex_name(rec)
            ranked = os.path.join(out, "ranked_poses", f"{name}_ranked.sdf")
            mols = parse_sdf(ranked)
            mol = load_ligand(rec["ligand_description"])
            n = len(mols)
            if n != poses:
                raise AssertionError(f"{name}: {n} ranked poses")
            t0 = time.perf_counter()
            cli_file = os.path.join(tmp, f"{name}.cli.score")
            columns = ancphore_bridge.calc_phore_fitting(ranked, phore_file, cli_file,
                                                         overwrite=True, return_all=True)
            by_fitness = {k: ancphore_bridge.calc_phore_fitting(ranked, phore_file, cli_file,
                                                                fitness=k)
                          for k in range(1, 7)}
            custom_file = os.path.join(tmp, f"{name}.custom.score")
            custom = ancphore_bridge.calc_phore_fitting(ranked, phore_file, custom_file,
                                                        overwrite=True, fitness=6, **HOST_COEFFS)
            t_cli += time.perf_counter() - t0
            cli_rows = score_table(cli_file)
            if len(columns) != n or {len(c) for c in columns} != {5} \
                    or any(len(v) != n for v in by_fitness.values()) or len(custom) != n \
                    or {len(r) for r in cli_rows} != {19}:
                raise AssertionError(f"{name}: the CLI's score file is malformed")
            if [float(r[-6]) for r in cli_rows] != by_fitness[6] \
                    or [c[0] for c in columns] != by_fitness[6]:
                raise AssertionError(f"{name}: parse_score_file's columns disagree")
            xyz = torch.tensor(np.stack([m.coords for m in mols]), dtype=torch.float32,
                               device=device)
            args = (xyz, torch.ones(xyz.shape[:2], dtype=torch.bool, device=device),
                    torch.tensor(scoring_phore_fp(mol), dtype=torch.float32,
                                 device=device).expand(n, -1, -1),
                    torch.tensor(VDW_TABLE[[a.atomic_num - 1 for a in mol.atoms]],
                                 device=device).expand(n, -1), ref.repeat(n))
            count_fp = torch.tensor(ligand_phore_features(mol)[0], dtype=torch.float32,
                                    device=device).expand(n, -1, -1)
            sc = {k: v.cpu().numpy() for k, v in fitscore(*args, count_fp=count_fp).items()}
            card_file = os.path.join(tmp, f"{name}.card.score")
            infer_cli.write_score_file(card_file, name, cli_rows[0][2], sc)
            card_rows = score_table(card_file)
            same_features = column_gaps(card_rows, cli_rows, [5])[5] <= 1.0
            g = column_gaps(card_rows, cli_rows, list(HOST_HELD) + list(HOST_REPORTED))
            reported[name] = g
            if same_features:
                held.append(name)
                for col in HOST_HELD:
                    gaps[col] = max(gaps.get(col, 0.0), g[col])
                sc_c = fitscore(*args, count_fp=count_fp, **HOST_CARD_COEFFS)["fitness"]
                custom_gap = max(custom_gap, max(
                    sixth_digit_gap(float(f"{a:.6g}"), b, 0.1)
                    for a, b in zip(sc_c.cpu().numpy(), custom)))
        print(f"host modules: AncPhore CLI built by the bridge into "
              f"{os.path.relpath(binary, HERE)} in {walls['build']:.3f} s "
              f"({'compiled' if fresh else 'already built'}; native/ unchanged); "
              f"cli.inference.main on {HOST_SCREEN} SDF rows x {poses} poses x {steps} steps in "
              f"{walls['screen']:.3f} s, launches {nonzero(counts['screen'])}; the CLI scored the "
              f"{HOST_SCREEN} x {poses} ranked poses in {t_cli:.3f} s (8 calls a complex); the "
              f"card's .score against the CLI's, largest gap in units of the sixth significant "
              f"digit on {', '.join(held)}: "
              + ", ".join(f"{HOST_HELD[c]} {v:.2f}" for c, v in sorted(gaps.items()))
              + f"; custom column -6 ({HOST_COEFFS}) against fitscore with "
              f"{HOST_CARD_COEFFS}: {custom_gap:.2f}; reported, not held: "
              + "; ".join(f"{name}: " + ", ".join(f"{HOST_REPORTED.get(c, HOST_HELD.get(c))} "
                                                  f"{v:.3g}" for c, v in g.items()
                                                  if c in HOST_REPORTED or name not in held)
                          for name, g in reported.items())
              + f" ({card}) {lap()}", flush=True)
        want_held = [infer_cli.complex_name(r) for r in task_rows[:2]]
        if not set(want_held) <= set(held):
            raise AssertionError(f"the CLI perceives other features than the port for "
                                 f"{sorted(set(want_held) - set(held))}")
        bad = {HOST_HELD[c]: v for c, v in gaps.items() if v > 1.0}
        if bad or custom_gap > 1.0:
            raise AssertionError(f"the card's score file against the CLI's, in units of the "
                                 f"sixth significant digit: {bad}, custom column {custom_gap}")
        if native_digest() != native_before:
            raise AssertionError("native/ changed")

        # ---- (d) the baseline drivers on the same files
        base = os.path.join(tmp, "baselines")
        label_csv = os.path.join(tmp, "screen_labels.csv")
        with open(label_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["ligand_description", "label"])
            w.writerows([[p, int(i == 0)] for i, p in enumerate(ligands)])
        phore_dir = os.path.join(tmp, "targets")
        os.makedirs(phore_dir)
        for t in ("targetA", "targetB"):
            shutil.copy(phore_file, os.path.join(phore_dir, f"{t}.phore"))
        truth = os.path.join(tmp, "truth")
        os.makedirs(truth)
        for rec, lig in zip(task_rows, ligands):
            shutil.copy(lig, os.path.join(truth, infer_cli.complex_name(rec) + ".sdf"))
        dock_csv = os.path.join(tmp, "dock.csv")
        with open(dock_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["name", "receptor", "ligand", "cx", "cy", "cz"])
            w.writerows([[f"EX0{i + 1}", "receptor.pdbqt", p, 0, 0, 0]
                         for i, p in enumerate(ligands)])
        drivers = {
            "run_phore align": ("align", lambda d: run_phore.main(
                ["--task", "align", "--dataset_csv", task, "--out_dir", d])),
            "run_phore screen": ("screen", lambda d: run_phore.main(
                ["--task", "screen", "--dataset_csv", label_csv, "--phore", phore_file,
                 "--out_dir", d])),
            "run_phore fishing": ("fishing", lambda d: run_phore.main(
                ["--task", "fishing", "--ligand", ligands[0], "--phore_dir", phore_dir,
                 "--out_dir", d])),
            "performance_analyze": ("table", lambda d: performance_analyze.main(
                ["--poses_dir", os.path.join(out, "ranked_poses"), "--truth_dir", truth,
                 "--out", os.path.join(d, "table.json")])),
            "run_docking": ("docking", lambda d: run_docking.main(
                ["--task", "docking", "--binary", "vina", "--dataset_csv", dock_csv,
                 "--out_dir", d])),
            "run_ifptarget": ("ifptarget", lambda d: run_ifptarget.main(
                ["--ligand_dir", examples, "--out_dir", d])),
        }
        for label, (sub, fn) in drivers.items():
            d = os.path.join(base, sub)
            os.makedirs(d, exist_ok=True)
            t0 = time.perf_counter()
            fn(d)
            walls[label] = time.perf_counter() - t0

        def load(*parts):
            with open(os.path.join(base, *parts)) as f:
                return json.load(f) if parts[-1].endswith(".json") else list(csv.DictReader(f))

        align = load("align", "ancphore_results.json")
        summary = load("screen", "ancphore_screen_summary.json")
        screen_rows_ = load("screen", "ancphore_screen_ranked.csv")
        fishing_rows = load("fishing", "ancphore_fishing_ranked.csv")
        table = load("table", "table.json")
        docking = load("docking", "docking_results.json")
        ifp = load("ifptarget", "summary.json")
        skipped = [b for b in ("vina", "IFPTarget") if shutil.which(b) is None]
        ranked_scores = [float(r["best_score"]) for r in screen_rows_]
        fishing_scores = [float(r["best_score"]) for r in fishing_rows]
        if len(align) != HOST_SCREEN or not all(np.isfinite(r["best_score"]) for r in align) \
                or summary["n"] != HOST_SCREEN or not 0.0 <= summary["roc_auc"] <= 1.0 \
                or ranked_scores != sorted(ranked_scores, reverse=True) \
                or {r["label"] for r in screen_rows_} != {"0", "1"} \
                or sorted(r["target"] for r in fishing_rows) != ["targetA", "targetB"] \
                or fishing_scores != sorted(fishing_scores, reverse=True) \
                or table.get("n_complexes") != HOST_SCREEN \
                or ("vina" in skipped and docking != []) \
                or ("IFPTarget" in skipped and ifp != {"shards": []}):
            raise AssertionError(f"baselines: align {align}, screen {summary} {screen_rows_}, "
                                 f"fishing {fishing_rows}, table {table}, docking {docking}, "
                                 f"ifptarget {ifp}")
        if native_digest() != native_before:
            raise AssertionError("native/ changed")
        print(f"host modules: baseline drivers on the same files ({card}): "
              + ", ".join(f"{k} {walls[k]:.3f} s" for k in drivers)
              + f"; screen AUC {summary['roc_auc']:.3f}, {HOST_SCREEN} complexes' top-1 RMSD "
              f"< 2 A {table['top1_rmsd_below_2']}%; not installed, skipped cleanly: "
              f"{', '.join(skipped) or 'none'} {lap()}", flush=True)
    print(f"host modules: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


# Phase 19: model widths past corpus2's on the kernels.  Fresh weights (a
# seeded create_train_state) at bf16, 4 conv layers: ns / nv = 32 / 16 at l
# <= 1 (E = H = 96: the 4-lane K1's wide kernel, hidden layer in chunks of
# 64; F up to 256) and 48 / 10 at l = 2 (E = H = 144, F up to 528: the
# 8-lane K1's wide kernel, K2's 8-lane kernels past 384 channels, K3's edge
# backward at 36 units of four channels).
WIDTH_CASES = (("32-16-l1", dict(ns=32, nv=16, use_second_order_repr=False)),
               ("48-10-l2", dict(ns=48, nv=10, use_second_order_repr=True)))
WIDTH_STEP_REPEATS = 1          # timed train steps a width (after the counted one)
WIDTH_CALIBRATION = 40          # forwards that move fresh batch norms' statistics (8 rows each)
WIDTH_PROFILED_STEPS = 2        # steps of the dispatch traced by torch.profiler


def phase_widths(card, jobs, train_batch, draws):
    """19: each model of ``WIDTH_CASES`` (its batch norms' statistics moved
    by ``FitEngine.calibrate_batch_stats`` first): (a) K1 held against its plain
    version on the 23 conv calls of one 40-pose forward (f32 and bf16,
    reruns bit-equal; each call timed once at each type by graph replay; each
    wide call's weights resident or staged), and the forward kernel convs
    against plain convs; (b) K2 and K3 held against
    their plain versions on the 17 + 6 conv calls of one training-mode
    forward (phase 5's check); (c) one train step of 24, K2 17 x 3 and K3 6
    x 3 launches exactly, its wall and busy time; (d) one FitEngine dispatch
    of one cached complex x 40 poses x 20 steps, K1 exactly 460, its
    poses/s, and the busy time on the card of a dispatch of
    ``WIDTH_PROFILED_STEPS`` steps and K1's part of it (torch.profiler).  Returns, by width, the cases, counts and times."""
    import numpy as np
    import torch

    from diffphore_torch.cli.pipeline import FitEngine
    from diffphore_torch.data.transforms import apply_noise
    from diffphore_torch.ops import tp_fused
    from diffphore_torch.sampler.sampling import SamplerSettings
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.utils.checkpoints import load_model_dir

    base, _ = load_model_dir(MODEL_DIR, device="cpu")
    out = {}
    for tag, over in WIDTH_CASES:
        t_phase = time.perf_counter()
        cfg = dataclasses.replace(base, compute_dtype="bfloat16", **over)
        l2 = cfg.use_second_order_repr
        state = create_train_state(cfg, seed=SEED, device="cuda")
        model = state.model
        engine = FitEngine(cfg, model, samples_per_complex=POSES,
                           settings=SamplerSettings(inference_steps=STEPS), seed=SEED,
                           device="cuda")
        # fresh weights' identity statistics let eval-mode activations
        # overflow through the conv stack (NaN in tr and rot): move them
        # toward those of randomized poses first, as a random-init serve does
        engine.calibrate_batch_stats(jobs[0], iters=WIDTH_CALIBRATION)

        # ---- (a) K1 on the 23 conv calls of one 40-pose forward
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        batch = posed_rows(jobs[0].batch.to("cuda"), POSES, cfg, gen)
        k1_cases = []
        for name, mod, args in capture_conv_calls(model, batch):
            c = check_k1_call(tp_fused, name, mod, args)
            B, N, M, _ = c["sh"].shape
            pl = tp_fused.plan(c["tp"], B, N, M, len(c["attrs"]), *c["params"][0].shape, 2,
                               False)
            pl4 = tp_fused.plan(c["tp"], B, N, M, len(c["attrs"]), *c["params"][0].shape, 4,
                                False)
            with torch.inference_mode():
                ms = device_ms(lambda: tp_fused.tp_aggregate_fused(
                    c["tp"], c["x"], c["sh"], c["attrs"], c["masks"], *c["params"]), 10,
                    replays=1)
                ms_bf = device_ms(lambda: tp_fused.tp_aggregate_fused(
                    c["tp"], *c["low"], c["masks"], *c["params"]), 10, replays=1)
            nbytes, mm_ops, vec_ops = k1_work(c["tp"], c["x"], c["sh"], c["attrs"], c["masks"],
                                              c["params"][0], c["params"][2])
            nbytes_bf, _, _ = k1_work(c["tp"], c["low"][0], c["low"][1], c["low"][2],
                                      c["masks"], c["params"][0], c["params"][2])
            k1_cases.append({
                "conv": name, "B": B, "N": N, "M": M, "F": c["tp"].weight_numel,
                "E": c["params"][0].shape[0], "wide": pl.wide, "staged": (pl4.staged, pl.staged),
                "channel_tiles": len(pl.tiles),
                "max_abs_err": c["err"], "max_abs_err_bf16": c["err_bf"], "ms": ms,
                "ms_bf16": ms_bf,
                "bound_ms": max(nbytes / PEAK_BYTES, (mm_ops + vec_ops) / PEAK_F32) * 1e3,
                "bound_ms_bf16": max(nbytes_bf / PEAK_BYTES, mm_ops / PEAK_BF16,
                                     vec_ops / PEAK_F32) * 1e3})
        check_forward(model, batch, cfg.compute_dtype, what=f"widths {tag} forward")
        total = {k: sum(c[k] for c in k1_cases) for k in ("ms", "ms_bf16", "bound_ms",
                                                          "bound_ms_bf16")}
        print(f"widths {tag}: K1 held on the 23 conv calls of one forward (f32 and bf16, reruns "
              f"bit-equal; {sum(c['wide'] for c in k1_cases)} on the wide kernel), max err "
              f"{max(c['max_abs_err'] for c in k1_cases):.2e} (bf16 "
              f"{max(c['max_abs_err_bf16'] for c in k1_cases):.2e}); kernel time over the 23 "
              f"{total['ms']:.4f} ms f32, {total['ms_bf16']:.4f} ms bf16 on the card (bound "
              f"{total['bound_ms']:.4f} / {total['bound_ms_bf16']:.4f}) ({card})", flush=True)
        for c in k1_cases:
            form = ("wide, weights f32 / bf16 " + " / ".join(
                f"staged by {st}" if st else "resident" for st in c["staged"])
                if c["wide"] else "narrow")
            print(f"  {c['conv']:28s} E={c['E']:3d} F={c['F']:3d} "
                  f"{form} {c['channel_tiles']} tile(s) "
                  f"err={c['max_abs_err']:.2e} bf16_err={c['max_abs_err_bf16']:.2e} "
                  f"{c['ms']:.4f} / {c['ms_bf16']:.4f} ms (bound {c['bound_ms']:.4f} / "
                  f"{c['bound_ms_bf16']:.4f})", flush=True)
        t_k1 = time.perf_counter()

        # ---- (b) K2 and K3 on the conv calls of one training-mode forward
        with torch.no_grad():
            noised, _ = apply_noise(train_batch, cfg.sigma_schedule, draws=draws)
        k2_calls, k3_calls = capture_training_convs(state.model, noised)
        print(f"widths {tag}, kernel check: tp_aggregate on the {K2_CONVS} conv calls it takes "
              "of one training-mode forward", flush=True)
        k2_cases = phase_k2_check(k2_calls, timed=False)
        print(f"widths {tag}, kernel check: tp_scalar on the {K3_CONVS} layer-0 convs",
              flush=True)
        k3_cases = phase_k3_check(k3_calls, timed=False)
        del noised, k2_calls, k3_calls
        torch.cuda.empty_cache()
        t_k23 = time.perf_counter()

        # ---- (c) one train step of 24, launches exact, then timed
        step = make_train_step(cfg)
        drop = torch.Generator(device="cuda")
        drop.manual_seed(SEED + 1)
        state.model.train()
        reset_kernel_counts()
        state, metrics = step(state, train_batch, drop, draws=draws)
        torch.cuda.synchronize()
        step_counts = expect_counts(f"widths {tag} train step", steps=1, l2=l2)
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"widths {tag}: the train step's loss is not finite")
        run_step = lambda: step(state, train_batch, drop, draws=draws)
        step_ms, step_peak = timed_steps(run_step, WIDTH_STEP_REPEATS)
        step_busy = profiled_busy_ms(run_step, repeats=1)
        print(f"widths {tag}: train step at bf16, batch {train_batch.batch_size}: loss "
              f"{float(metrics['loss']):.4f}; {step_ms:.1f} ms wall, {step_busy:.1f} ms busy on "
              f"the card (torch.profiler), peak memory {step_peak:.2f} GiB; launches "
              f"{nonzero(step_counts)} ({card})", flush=True)
        t_step = time.perf_counter()

        # ---- (d) one dispatch: one complex x 40 poses x 20 steps
        model.eval()
        engine.run_complexes(jobs[:1])          # warm-up
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.perf_counter()
        served = engine.run_complexes(jobs[:1])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serving = expect_counts(f"widths {tag} dispatch", k1=CONVS_PER_FORWARD * STEPS, l2=l2)
        r = served[0]
        if r["poses"].shape != (POSES, jobs[0].n_atoms, 3) or not np.isfinite(r["poses"]).all() \
                or not np.isfinite(r["fitscore"]).all():
            raise AssertionError(f"widths {tag}: poses or fitscores not finite")
        poses_per_s = POSES / serve_s
        short = FitEngine(cfg, model, samples_per_complex=POSES,
                          settings=SamplerSettings(inference_steps=WIDTH_PROFILED_STEPS),
                          seed=SEED, device="cuda")
        short.run_complexes(jobs[:1])           # warm-up
        serve_busy, serve_k1 = profiled_busy_ms(lambda: short.run_complexes(jobs[:1]),
                                                repeats=1, part="tp_fused")
        k1_name = "k1_l2" if l2 else "k1"
        print(f"widths {tag}: one dispatch of {jobs[0].name} x {POSES} poses x {STEPS} steps in "
              f"{serve_s:.3f} s = {poses_per_s:.1f} poses/s; K1 launches {serving[k1_name]}; "
              f"a dispatch of {WIDTH_PROFILED_STEPS} steps {serve_busy:.2f} ms busy on the card, "
              f"K1 {serve_k1:.2f} ms of it (torch.profiler) ({card})", flush=True)
        t_end = time.perf_counter()
        print(f"widths {tag}: phase {t_end - t_phase:.1f} s (K1 {t_k1 - t_phase:.1f}, K2/K3 "
              f"{t_k23 - t_k1:.1f}, train step {t_step - t_k23:.1f}, dispatch "
              f"{t_end - t_step:.1f})", flush=True)
        out[tag] = {"k1_cases": k1_cases, "k2_cases": k2_cases, "k3_cases": k3_cases,
                    "step_counts": step_counts, "serving": serving, "poses_per_s": poses_per_s,
                    "dispatch_busy_ms": serve_busy, "dispatch_k1_ms": serve_k1,
                    "step_ms": step_ms, "step_busy_ms": step_busy, "step_peak_gib": step_peak}
        del state, model, engine, short
        torch.cuda.empty_cache()
    return out


def widths_summary(widths):
    """Phase 19's numbers for the report, by width."""
    return {tag: {"poses_per_s": w["poses_per_s"], "profiled_steps": WIDTH_PROFILED_STEPS,
                  "profiled_busy_ms": w["dispatch_busy_ms"],
                  "profiled_k1_ms": w["dispatch_k1_ms"], "step_ms": w["step_ms"],
                  "step_busy_ms": w["step_busy_ms"], "k1_launches_per_dispatch":
                      max(w["serving"]["k1"], w["serving"]["k1_l2"]),
                  "k1_ms_23_convs": sum(c["ms"] for c in w["k1_cases"]),
                  "k1_ms_bf16_23_convs": sum(c["ms_bf16"] for c in w["k1_cases"]),
                  "k1_bound_ms_23_convs": sum(c["bound_ms"] for c in w["k1_cases"]),
                  "k1_bound_ms_bf16_23_convs": sum(c["bound_ms_bf16"] for c in w["k1_cases"])}
            for tag, w in widths.items()}


def widths_alone(card, kind):
    """Phase 19 alone, after the card line and the build: its inputs made as
    main() makes them, then a summary line, the card line and the result
    line."""
    import torch

    from diffphore_torch.cli.pipeline import job_from_cached

    jobs = [job_from_cached(b) for _, b in bucket_complexes(CACHE_DIR, 1)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    train_batch, draws = recipe_batch(gen)
    widths = phase_widths(card, jobs, train_batch, draws)
    print(json.dumps({"widths": widths_summary(widths)}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def nonzero(counts):
    """The counters a run moved (every other one is 0)."""
    return {k: n for k, n in counts.items() if n}


def k1_entry(name, cases, launches):
    """The report entry of K1's kernel ``name``, summed over one forward's
    conv calls (``cases`` from phase_kernel_check)."""
    by = {"bytes": 0.0, "operations": 0.0}
    for c in cases:
        by[c["bound_by"]] += c["bound_ms"]
    return {
        "name": name,
        "route": "cuda",
        "source": "diffphore_torch/csrc/tp_fused.cu",
        "replaces": "diffphore_tpu/ops/pallas/tp_fused.py:115",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_abs_err_bf16": max(c["max_abs_err_bf16"] for c in cases),
        "max_rel_err_bf16": max(c["max_rel_err_bf16"] for c in cases),
        "ms_bf16": sum(c["ms_bf16"] for c in cases),
        "bound_ms_bf16": sum(c["bound_ms_bf16"] for c in cases),
        "ms": sum(c["ms"] for c in cases),
        "kernel_ms": sum(c["ms"] for c in cases),
        "plain_ms": sum(c["plain_ms"] for c in cases),
        "bound_ms": sum(c["bound_ms"] for c in cases),
        "bound_by": "operations" if by["operations"] >= by["bytes"] else "bytes",
        "library_ms": None,
        "call_ms": sum(c["call_ms"] for c in cases),
        "unit": "one forward: the 23 conv calls, each timed alone; ms on the card (graph replay), "
                "f32 inputs (ms) and bf16 ones (ms_bf16), call_ms per call from Python",
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one GPU.")
    parser.add_argument("--second_order_only", action="store_true",
                        help="after the card line and the build, run phase 16 (l = 2) alone")
    parser.add_argument("--knn_only", action="store_true",
                        help="after the card line and the build, run phase 17 (the KNN phore "
                             "grid) alone")
    parser.add_argument("--host_modules_only", action="store_true",
                        help="after the card line and the build, run phase 18 (the host-only "
                             "modules) alone")
    parser.add_argument("--widths_only", action="store_true",
                        help="after the card line and the build, run phase 19 (model widths "
                             "past corpus2's) alone")
    args = parser.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "diffphore_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke test needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from diffphore_torch.cli.pipeline import FitEngine, job_from_cached
    from diffphore_torch.data.graphs import repeat_batch
    from diffphore_torch.models.layers import DenseTPConv
    from diffphore_torch.ops import build, tp_fused
    from diffphore_torch.ops.fitscore import batch_phore_arrays
    from diffphore_torch.sampler.sampling import SamplerSettings
    from diffphore_torch.utils.checkpoints import load_model_dir

    t_start = time.perf_counter()

    def mark(label):
        print(f"[{time.perf_counter() - t_start:.1f} s] {label} done", flush=True)

    # ---- 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 2. build
    t0 = time.perf_counter()
    built = build.build(["tp_fused", "tp_aggregate", "tp_scalar"])
    build_s = time.perf_counter() - t0
    for name, (path, log) in built.items():
        print(f"build: {name} -> {os.path.relpath(path, HERE)} in {build_s:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")

    mark("build")
    if args.second_order_only:
        return second_order_alone(card, kind)
    if args.knn_only:
        return knn_alone(card, kind)
    if args.widths_only:
        return widths_alone(card, kind)
    if args.host_modules_only:
        host = phase_host_modules(card)
        print(json.dumps({"host_modules_launches": host}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0

    # ---- 3. kernel check on the main path's conv inputs
    cfg, model = load_model_dir(MODEL_DIR, device="cuda")
    if cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"the shipped config computes in {cfg.compute_dtype}, not bfloat16")
    complexes = [b for _, b in bucket_complexes(CACHE_DIR, N_COMPLEXES)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    batch = posed_rows(complexes[0].to("cuda"), POSES, cfg, gen)
    print("kernel check: tp_fused on the 23 conv calls of one forward", flush=True)
    cases = phase_kernel_check(model, batch, tp_fused)
    check_forward(model, batch, cfg.compute_dtype)

    mark("kernel check")

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
    convs = [m for m in model.modules() if isinstance(m, DenseTPConv)]
    job = jobs[0]
    noise = engine.draw_noise(POSES, BUCKET[2])
    rows = repeat_batch(job.batch.to("cuda"), POSES)
    ref = batch_phore_arrays(rows)
    pos_k, sc_k, _ = engine.run_batch(rows, ref, POSES, noise)
    for m in convs:
        m.use_kernel = False
    pos_p, sc_p, _ = engine.run_batch(rows, ref, POSES, noise)
    for m in convs:
        m.use_kernel = True
    n_at = job.n_atoms
    rmsd = ((pos_k[:, :n_at] - pos_p[:, :n_at]) ** 2).sum(-1).mean(-1).sqrt().cpu().numpy()
    dfit = (sc_k["phscore1"] - sc_p["phscore1"]).abs().max().item()
    print(f"kernel vs plain convs, {job.name}, same noise, {STEPS} steps: pose RMSD median "
          f"{np.median(rmsd):.2e} max {rmsd.max():.2e} A; max |d phscore1| {dfit:.2e}")
    if not np.median(rmsd) <= TOL_RERUN_RMSD:
        raise AssertionError(f"kernel and plain runs diverge: median RMSD {np.median(rmsd)} A")

    # the other sampler modes on the same complex
    phase_sampler_modes(cfg, model, job, card)

    mark("main path and sampler modes")

    # ---- 5. K2 and K3 on the conv inputs of one training-mode forward
    from diffphore_torch.data.transforms import apply_noise

    train_batch, draws = recipe_batch(gen)
    with torch.no_grad():
        noised, _ = apply_noise(train_batch, cfg.sigma_schedule, draws=draws)
    _, train_model = load_model_dir(MODEL_DIR, device="cuda")
    k2_calls, k3_calls = capture_training_convs(train_model, noised)
    print(f"kernel check: tp_aggregate forward and backward on the {K2_CONVS} conv calls it "
          "takes of one training-mode forward", flush=True)
    k2_cases = phase_k2_check(k2_calls)
    print(f"kernel check: tp_scalar forward and backward on the {K3_CONVS} layer-0 convs of "
          "the same forward", flush=True)
    k3_cases = phase_k3_check(k3_calls)
    del train_model, noised, k2_calls, k3_calls
    torch.cuda.empty_cache()

    mark("K2 and K3 check")

    # ---- 6. training path
    train_counts = phase_training(cfg, train_batch, card)

    mark("training path")

    # ---- 7. calibrated-sampler path
    cc_counts = phase_calibrated(cfg, train_batch, card)

    mark("calibrated-sampler path")

    # ---- 8. serving with the shipped confidence head
    head_serving_k1 = phase_confidence_serving(cfg, model, jobs, card)

    mark("confidence serving")

    # ---- 9. the confidence head's training path: K2 and K3 on the conv
    # inputs of one training-mode forward of the shipped head, then the steps
    from diffphore_torch.utils.checkpoints import load_confidence_dir, load_config_yaml

    head_cfg = load_config_yaml(CONFIDENCE_DIR)
    _, head = load_confidence_dir(CONFIDENCE_DIR, device="cuda")
    with torch.no_grad():
        noised, _ = apply_noise(train_batch, cfg.sigma_schedule, draws=draws)
    k2_calls, k3_calls = capture_training_convs(head, noised, HEAD_K2_CONVS)
    print(f"kernel check: tp_aggregate on the {HEAD_K2_CONVS} conv calls it takes of one "
          "training-mode forward of the confidence head", flush=True)
    phase_k2_check(k2_calls)
    print(f"kernel check: tp_scalar on the {K3_CONVS} layer-0 convs of the same forward",
          flush=True)
    phase_k3_check(k3_calls)
    del head, noised, k2_calls, k3_calls
    torch.cuda.empty_cache()
    head_counts = phase_confidence_training(head_cfg, train_batch, card)

    mark("confidence training")

    # ---- 10. validation by inference in the training CLI
    valinf_counts = phase_val_inference(cfg, card)

    mark("validation by inference")

    # ---- 11. the screening CLI from files
    screen_k1 = phase_screening_cli(card)

    mark("screening CLI")

    # ---- 12. training and evaluation from raw files
    raw = phase_raw_files(card)

    mark("raw files")

    # ---- 13. scale-out
    scale_k1 = phase_scale_out(card, train_batch)

    mark("scale-out")

    # ---- 15. the model-family variants (ahead of the report)
    variants = phase_variants(card, cfg, train_batch, draws, jobs)

    mark("variants")

    # ---- 16. l = 2 features on the 8-lane kernels (ahead of the report)
    second = phase_second_order(card, jobs, train_batch, draws)

    mark("second order")

    # ---- 17. the KNN phore grid on the sender-index mode (ahead of the report)
    knn = phase_knn(card, jobs, train_batch, draws, poses_per_s)

    mark("KNN phore grid")

    # ---- 18. the host-only modules (ahead of the report)
    host = phase_host_modules(card)

    mark("host modules")

    # ---- 19. model widths past corpus2's (ahead of the report)
    widths = phase_widths(card, jobs, train_batch, draws)
    print(json.dumps({"widths": widths_summary(widths)}))

    mark("widths")

    # ---- 14. report
    kernel = k1_entry("tp_fused", cases, launches)
    kernel.update({
        "launches_training_path": train_counts["k1"],
        "launches_calibrated_path": cc_counts["k1"],
        "launches_confidence_serving": head_serving_k1,
        "launches_confidence_training": head_counts["k1"],
        "launches_val_inference": valinf_counts["k1"],
        "launches_screening_cli": screen_k1,
        "launches_raw_files_training": raw["train"]["k1"],
        "launches_raw_files_evaluate": raw["eval"]["k1"],
        "launches_scale_out_screen": scale_k1,
        "launches_use_att_serving": variants["use_att_serving"]["k1"],
        "launches_use_att_cli": variants["use_att_cli"]["k1"],
        "launches_use_att_training": variants["use_att_training"]["k1"],
        "launches_fourier_forward": variants["fourier"]["k1"],
        "launches_synthetic_pretrain": host["pretrain"]["k1"],
        "launches_host_modules_screen": host["screen"]["k1"],
        "raw_files_bucket": raw["k1"],
    })
    k2_entries = k2_kernel_entries(k2_cases, train_counts)
    for entry, k in zip(k2_entries, ("fwd", "bwd_edge", "bwd_x")):
        entry["launches_calibrated_path"] = cc_counts[k]
    k3_entries = k3_kernel_entries(k3_cases, cc_counts, train_counts)
    raw_entries = (k2_kernel_entries(raw["k2_cases"], raw["train"])
                   + k3_kernel_entries(raw["k3_cases"], raw["train"], raw["train"]))
    for prefix, entries in (("", k2_entries), ("k3_", k3_entries)):
        for entry, k in zip(entries, K3_KERNELS):
            entry["launches_confidence_training"] = head_counts[prefix + k]
            entry["launches_val_inference"] = valinf_counts[prefix + k]
            entry["launches_raw_files_training"] = raw["train"][prefix + k]
    for prefix, entries in (("", k2_entries), ("k3_", k3_entries)):
        for entry, k in zip(entries, K3_KERNELS):
            entry["launches_use_att_training"] = variants["use_att_training"][prefix + k]
            entry["launches_synthetic_pretrain"] = host["pretrain"][prefix + k]
            entry["launches_host_modules_screen"] = host["screen"][prefix + k]
    for entry in [kernel] + k2_entries + k3_entries:
        entry["launches_tank_fully_connected_oracle"] = sum(
            n for path in ("tank", "fully_connected_serving", "fully_connected_training",
                           "oracle") for n in variants[path].values())
    for entry, at_bucket in zip(k2_entries + k3_entries, raw_entries):
        entry["raw_files_bucket"] = {k: at_bucket[k] for k in RAW_BUCKET_KEYS}
    print(json.dumps({"kernels": [kernel] + k2_entries + k3_entries
                      + second_order_entries(second) + knn}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
