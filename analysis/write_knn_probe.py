"""Write the KNN probe: the shipped corpus2 model with its phore grid
compacted to each receiver's 24 nearest senders (``phore_knn: 24``), and the
JAX package's f32 forward of it, which the PyTorch port's tests and
``chip_smoke.py`` (phase 17) hold the port's KNN path against.

``phore_knn`` adds no parameter, so the corpus2 weights
(``runs/corpus2/main/best_ema_inference_epoch_model.msgpack``) run under it
as they are and are not copied.  ``runs/knn_probe/`` holds:

  * ``model_parameters.yml``: corpus2's with ``phore_knn: 24``;
  * ``reference.npz``: ``tr``, ``rot``, ``tor`` (f32) of the JAX
    ``ScoreModel.apply`` at compute_dtype float32, the corpus2 weights, on
    one row of each of the first two cached validation complexes of the
    24x96x8 bucket whose phore graph has a receiver with more than 24
    senders (so that K = 24 drops neighbours there and the reference is the
    KNN model's, not the dense one's), at t = 0.7 and 0.3, the ligand of
    each row moved by ``LIGAND_SHIFT`` (off the cached pose, where the norm
    channel's rotation axis is rounding noise:
    analysis/write_second_order_probe.py).

    JAX_PLATFORMS=cpu python analysis/write_knn_probe.py [--out DIR]

It takes about a minute on the CPU, mostly compiling.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "analysis"))
from write_second_order_probe import BUCKET, CORPUS2, VAL_CACHE  # noqa: E402

OUT = os.path.join(REPO, "runs", "knn_probe")
WEIGHTS = os.path.join(CORPUS2, "best_ema_inference_epoch_model.msgpack")
KNN = 24
REFERENCE_T = (0.7, 0.3)
LIGAND_SHIFT = ((0.5, -0.2, 0.1), (-1.0, 0.3, 0.4))   # A, one per reference row

__all__ = ["BUCKET", "KNN", "OUT", "WEIGHTS", "max_in_degree", "reference_files",
           "reference_outputs"]


def max_in_degree(path: str) -> int:
    """The most senders a receiver of the cached complex's phore graph has."""
    with np.load(path) as z:
        m = z["phore_mask"]
        return int((z["phore_edge_mask"] & m[:, :, None] & m[:, None, :]).sum(-1).max())


def reference_files():
    """The cached complexes of the reference rows, one row each: the first
    of the bucket whose phore graph K = KNN compacts."""
    import glob

    picked = []
    for f in sorted(glob.glob(os.path.join(VAL_CACHE, "*.npz"))):
        with np.load(f) as z:
            shape = (z["lig_pos"].shape[1], z["phore_pos"].shape[1], z["tor_edges"].shape[1])
        if shape == BUCKET and max_in_degree(f) > KNN:
            picked.append(f)
        if len(picked) == len(REFERENCE_T):
            return picked
    raise RuntimeError(f"fewer than {len(REFERENCE_T)} complexes of bucket {BUCKET} whose phore "
                       f"graph K = {KNN} compacts in {VAL_CACHE}")


def write_config(out: str) -> None:
    with open(os.path.join(CORPUS2, "model_parameters.yml")) as f:
        text = f.read()
    if "phore_knn: 0\n" not in text:
        raise RuntimeError("corpus2's model_parameters.yml has no phore_knn: 0")
    with open(os.path.join(out, "model_parameters.yml"), "w") as f:
        f.write(text.replace("phore_knn: 0\n", f"phore_knn: {KNN}\n"))


def reference_batch():
    import jax.numpy as jnp

    from diffphore_tpu.data.dataset import load_complex
    from diffphore_tpu.data.graphs import concat_batches

    batch = concat_batches([load_complex(f) for f in reference_files()])
    shift = jnp.asarray(LIGAND_SHIFT, jnp.float32)[:, None]
    return batch.replace(names=(), meta=(), t=jnp.asarray(REFERENCE_T, jnp.float32),
                         lig_pos=batch.lig_pos + shift)


def reference_outputs(out: str = OUT, phore_knn=None) -> dict:
    """The JAX f32 forward of the corpus2 weights under the config in
    ``out`` (its phore_knn, or ``phore_knn`` when given) on the reference
    rows."""
    import jax
    from flax import serialization

    from diffphore_tpu.models.score_model import ScoreModel
    from diffphore_tpu.utils.checkpoints import load_config_yaml

    cfg = dataclasses.replace(load_config_yaml(out), compute_dtype="float32")
    if phore_knn is not None:
        cfg = dataclasses.replace(cfg, phore_knn=phore_knn)
    with open(WEIGHTS, "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    tr, rot, tor = jax.jit(lambda v, b: ScoreModel(cfg).apply(v, b))(variables, reference_batch())
    return {"tr": np.asarray(tr, np.float32), "rot": np.asarray(rot, np.float32),
            "tor": np.asarray(tor, np.float32)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    write_config(args.out)
    ref = reference_outputs(args.out)
    np.savez(os.path.join(args.out, "reference.npz"), **ref)
    print(f"wrote {args.out}: " + ", ".join(f"{k} {v.shape} max|.| {np.abs(v).max():.4g}"
                                            for k, v in ref.items()))


if __name__ == "__main__":
    main()
