"""Write the second-order probe: a full-width l = 2 model directory written
by the JAX package, which the PyTorch port's tests and ``chip_smoke.py``
(phase 16) hold the port's l = 2 path against.

No shipped run uses ``use_second_order_repr``, so this makes one at the
shipped width: ``runs/second_order_probe/`` with

  * ``model_parameters.yml``: corpus2's (runs/corpus2/main) with
    ``use_second_order_repr: true``;
  * ``best_ema_inference_epoch_model.msgpack``: the flax init at seed 0,
    its batch-norm running statistics calibrated as the JAX inference CLI's
    ``--allow_random_init`` calibrates them (``FitEngine.calibrate_batch_stats``:
    batch statistics of forwards at prior poses and uniform t, momentum
    0.1), here on the first 8 cached training complexes of the 24x96x8
    bucket; without it the eval forward overflows;
  * ``reference.npz``: ``tr``, ``rot``, ``tor`` (f32) of the JAX
    ``ScoreModel.apply`` at compute_dtype float32 on two rows of the first
    cached validation complex of that bucket at t = 0.7 and 0.3, the
    ligand of each row moved by ``LIGAND_SHIFT``.  The cached complexes take
    their phore from the ligand's own pose, where ligand and phore norms are
    parallel and the norm channel's rotation axis is rounding noise: there
    1e-6 A of noise in the positions moves the outputs by percents, so an
    f32 forward on another device could not be held to the reference.
    Moved, the same noise moves them by 1e-6 of their scale.

    JAX_PLATFORMS=cpu python analysis/write_second_order_probe.py [--out DIR]
        [--reference_only]

``--reference_only`` rewrites only ``reference.npz`` from the checkpoint in
DIR (the test that regenerates it compares it with the committed file).
A full run takes a few minutes on the CPU, mostly compiling.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CORPUS2 = os.path.join(REPO, "runs", "corpus2", "main")
OUT = os.path.join(REPO, "runs", "second_order_probe")
TRAIN_CACHE = os.path.join(REPO, "data", "cache", "train_f1112e7d33")
VAL_CACHE = os.path.join(REPO, "data", "cache", "val_f1112e7d33")
BUCKET = (24, 96, 8)
CHECKPOINT = "best_ema_inference_epoch_model.msgpack"
CALIBRATION_COMPLEXES = 8
CALIBRATION_ITERS = 80
REFERENCE_T = (0.7, 0.3)
LIGAND_SHIFT = ((0.5, -0.2, 0.1), (-1.0, 0.3, 0.4))   # A, one per reference row


def bucket_files(cache: str, n: int):
    """The first n cached complexes of BUCKET, in name order."""
    out = []
    for f in sorted(glob.glob(os.path.join(cache, "*.npz"))):
        with np.load(f) as z:
            shape = (z["lig_pos"].shape[1], z["phore_pos"].shape[1], z["tor_edges"].shape[1])
        if shape == BUCKET:
            out.append(f)
        if len(out) == n:
            return out
    raise RuntimeError(f"fewer than {n} complexes of bucket {BUCKET} in {cache}")


def write_config(out: str) -> None:
    with open(os.path.join(CORPUS2, "model_parameters.yml")) as f:
        text = f.read()
    if "use_second_order_repr: false\n" not in text:
        raise RuntimeError("corpus2's model_parameters.yml has no use_second_order_repr: false")
    with open(os.path.join(out, "model_parameters.yml"), "w") as f:
        f.write(text.replace("use_second_order_repr: false\n", "use_second_order_repr: true\n"))


def reference_batch():
    import jax.numpy as jnp

    from diffphore_tpu.data.dataset import load_complex
    from diffphore_tpu.data.graphs import repeat_batch

    batch = repeat_batch(load_complex(bucket_files(VAL_CACHE, 1)[0]), len(REFERENCE_T))
    shift = jnp.asarray(LIGAND_SHIFT, jnp.float32)[:, None]
    return batch.replace(names=(), meta=(), t=jnp.asarray(REFERENCE_T, jnp.float32),
                         lig_pos=batch.lig_pos + shift)


def reference_outputs(out: str) -> dict:
    """The f32 forward of the checkpoint in ``out`` on the reference rows."""
    import jax
    from flax import serialization

    from diffphore_tpu.models.score_model import ScoreModel
    from diffphore_tpu.utils.checkpoints import load_config_yaml

    cfg = dataclasses.replace(load_config_yaml(out), compute_dtype="float32")
    with open(os.path.join(out, CHECKPOINT), "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    tr, rot, tor = jax.jit(lambda v, b: ScoreModel(cfg).apply(v, b))(variables, reference_batch())
    return {"tr": np.asarray(tr, np.float32), "rot": np.asarray(rot, np.float32),
            "tor": np.asarray(tor, np.float32)}


def write_checkpoint(out: str) -> None:
    import jax
    from flax import serialization

    from diffphore_tpu.data.dataset import load_complex
    from diffphore_tpu.data.graphs import concat_batches
    from diffphore_tpu.models.score_model import ScoreModel
    from diffphore_tpu.sampler.sampling import randomize_position
    from diffphore_tpu.utils.checkpoints import load_config_yaml

    cfg = load_config_yaml(out)
    model = ScoreModel(cfg)
    batch = concat_batches([load_complex(f) for f in bucket_files(
        TRAIN_CACHE, CALIBRATION_COMPLEXES)]).replace(names=(), meta=())
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), batch)

    @jax.jit
    def step(variables, key):
        k1, k2 = jax.random.split(key)
        b = randomize_position(batch, k1, tr_sigma_max=cfg.tr_sigma_max)
        b = b.replace(t=jax.random.uniform(k2, (batch.batch_size,)))
        _, new_state = model.apply(variables, b, use_running_average=False,
                                   mutable=["batch_stats"])
        return {**variables, "batch_stats": new_state["batch_stats"]}

    key = jax.random.PRNGKey(1)
    for _ in range(CALIBRATION_ITERS):
        key, sub = jax.random.split(key)
        variables = step(variables, sub)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    with open(os.path.join(out, CHECKPOINT), "wb") as f:
        f.write(serialization.to_bytes(variables))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=OUT)
    p.add_argument("--reference_only", action="store_true")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if not args.reference_only:
        write_config(args.out)
        write_checkpoint(args.out)
    ref = reference_outputs(args.out)
    np.savez(os.path.join(args.out, "reference.npz"), **ref)
    print(f"wrote {args.out}: " + ", ".join(f"{k} {v.shape} max|.| {np.abs(v).max():.4g}"
                                            for k, v in ref.items()))


if __name__ == "__main__":
    main()
