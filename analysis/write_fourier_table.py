"""Write the frozen projections of the JAX package's Gaussian Fourier
timestep embedding for the PyTorch port.

``diffphore_tpu.ops.diffusion.gaussian_fourier_embedding`` draws its
projection as ``jax.random.normal(PRNGKey(0), (dim // 2,))`` (times the
embedding scale); the port cannot reproduce jax.random, so it reads these
raw draws from ``diffphore_torch/ops/fourier_projection.npz``: array
``normal`` (128, 128) f32, row h - 1 holding the h draws of half-width h in
its first h entries (zeros after), for every half-width from 1 to 128.

    JAX_PLATFORMS=cpu python analysis/write_fourier_table.py [--out PATH]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

MAX_HALF = 128
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "diffphore_torch", "ops", "fourier_projection.npz")


def draws(max_half: int = MAX_HALF, seed: int = 0) -> np.ndarray:
    import jax

    table = np.zeros((max_half, max_half), np.float32)
    for h in range(1, max_half + 1):
        table[h - 1, :h] = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (h,),
                                                        dtype=np.float32))
    return table


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=OUT)
    out = p.parse_args(argv).out
    np.savez(out, normal=draws())
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
