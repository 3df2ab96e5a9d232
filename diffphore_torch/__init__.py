"""DiffPhore in PyTorch: pose sampling of ligands against pharmacophores on
an NVIDIA Hopper GPU.

A port of ``diffphore_tpu`` (JAX) that keeps its data layout, parameter
names and numerics, so checkpoints and cached complexes carry over and every
module can be held against the JAX package on the same inputs.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # torch loads on first use: a featurization process imports the package
    # and numpy, not torch
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
