"""Checkpoints of the JAX package, read into the port.

A model directory holds ``model_parameters.yml`` and flax msgpack files of
``{"params": ..., "batch_stats": ...}``.  :func:`convert_variables` maps that
tree onto the port's ``state_dict``: module paths are the same (the port's
attribute names mirror the flax scopes), flax ``Dense.kernel`` (in, out) is
transposed to ``Linear.weight`` (out, in), ``Embed.embedding`` becomes
``Embedding.weight``, and raw parameter matrices (``fc_w1``, ``mix_k``, batch
norm ``weight``/``bias``) and batch statistics (``mean``/``var``, buffers)
map as they are.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.score_model import ScoreModel, ScoreModelConfig
from . import flat_yaml, flax_msgpack

LAST_MODEL = "last_model.msgpack"
BEST_EMA_MODEL = "best_ema_inference_epoch_model.msgpack"
MODEL_PARAMS_YAML = "model_parameters.yml"


def migrate_fc_params(node: Any) -> Any:
    """Rename the older checkpoint format's nested ``fc`` edge MLP
    (Dense_0/Dense_1) of the channelwise convs to ``fc_w1/fc_b1/fc_w2/fc_b2``."""
    if not isinstance(node, dict):
        return node
    out = {}
    for k, v in node.items():
        if k == "fc" and isinstance(v, dict) and "Dense_0" in v and "fc_w1" not in node:
            out["fc_w1"] = v["Dense_0"].get("kernel")
            out["fc_b1"] = v["Dense_0"].get("bias")
            out["fc_w2"] = v["Dense_1"].get("kernel")
            out["fc_b2"] = v["Dense_1"].get("bias")
        else:
            out[k] = migrate_fc_params(v)
    return out


def convert_variables(variables: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """flax ``{"params", "batch_stats"}`` tree of numpy leaves -> state_dict."""
    variables = migrate_fc_params(variables)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for collection in ("params", "batch_stats"):
        for path, leaf in flax_msgpack.flatten(variables.get(collection, {})):
            arr = np.array(leaf, dtype=np.float32)
            *mods, name = path
            if name == "kernel":
                name, arr = "weight", arr.T
            elif name == "embedding":
                name = "weight"
            key = ".".join(mods + [name])
            if key in out:
                raise ValueError(f"duplicate checkpoint key {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_config_yaml(model_dir: str) -> ScoreModelConfig:
    return ScoreModelConfig.from_reference_yaml(
        flat_yaml.load(os.path.join(model_dir, MODEL_PARAMS_YAML)))


def load_model_dir(model_dir: str, device: Optional[str] = None,
                   checkpoint: str = BEST_EMA_MODEL) -> Tuple[ScoreModelConfig, ScoreModel]:
    """The config and the eval-mode model of a model directory, on
    ``device`` (the GPU unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    cfg = load_config_yaml(model_dir)
    model = ScoreModel(cfg)
    state = convert_variables(flax_msgpack.load(os.path.join(model_dir, checkpoint)))
    model.load_state_dict(state, strict=True)
    return cfg, model.to(dev).eval()
