"""Checkpoints in the JAX package's format, read and written by the port.

A model directory holds ``model_parameters.yml`` and flax msgpack files of
``{"params": ..., "batch_stats": ...}``.  :func:`convert_variables` maps that
tree onto the port's ``state_dict``: module paths are the same (the port's
attribute names mirror the flax scopes), flax ``Dense.kernel`` (in, out) is
transposed to ``Linear.weight`` (out, in), ``Embed.embedding`` becomes
``Embedding.weight`` and a ``LayerNorm``'s ``scale`` its ``weight``, and
raw parameter matrices (``fc_w1``, ``mix_k``, batch norm ``weight``/``bias``)
and batch statistics (``mean``/``var``, buffers) map as they are.
:func:`variables_from_tensors` is the inverse, so a run directory the port
writes (``model_parameters.yml`` + ``last_model.msgpack``
holding ``step``, ``params``, ``batch_stats``, ``ema_params`` and the
optimizer moments) loads with :func:`load_model_dir`, here and in the JAX
package's tree layout.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.confidence import ConfidenceModel
from ..models.score_model import ScoreModel, ScoreModelConfig
from ..models.trioformer import TankPhore
from . import flat_yaml, flax_msgpack

LAST_MODEL = "last_model.msgpack"
BEST_EMA_MODEL = "best_ema_inference_epoch_model.msgpack"
MODEL_PARAMS_YAML = "model_parameters.yml"


def migrate_fc_params(node: Any, expects: Optional[Callable[[Tuple[str, ...]], bool]] = None,
                      path: Tuple[str, ...] = ()) -> Any:
    """Rename the older checkpoint format's nested ``fc`` edge MLP
    (Dense_0/Dense_1) of the channelwise convs to ``fc_w1/fc_b1/fc_w2/fc_b2``.
    ``expects(path)`` says whether the module at ``path`` holds ``fc_w1``;
    an ``fc`` elsewhere (the edge MLP of a fully connected conv) keeps its
    name.  Without it every such ``fc`` is renamed."""
    if not isinstance(node, dict):
        return node
    out = {}
    for k, v in node.items():
        if (k == "fc" and isinstance(v, dict) and "Dense_0" in v and "fc_w1" not in node
                and (expects is None or expects(path))):
            out["fc_w1"] = v["Dense_0"].get("kernel")
            out["fc_b1"] = v["Dense_0"].get("bias")
            out["fc_w2"] = v["Dense_1"].get("kernel")
            out["fc_b2"] = v["Dense_1"].get("bias")
        else:
            out[k] = migrate_fc_params(v, expects, path + (str(k),))
    return out


def convert_variables(variables: Dict[str, Any], model: Optional[torch.nn.Module] = None
                      ) -> "OrderedDict[str, torch.Tensor]":
    """flax ``{"params", "batch_stats"}`` tree of numpy leaves -> state_dict.

    Given the ``model`` the tree is for, the older format's ``fc`` edge MLPs
    are renamed only in the convs that hold ``fc_w1`` (see
    :func:`migrate_fc_params`); a flax norm's ``scale`` becomes ``weight``.
    """
    expects = None
    if model is not None:
        names = {name for name, _ in model.named_parameters()}
        expects = lambda path: ".".join(path + ("fc_w1",)) in names
    for collection in ("params", "batch_stats"):
        if collection in variables:
            variables = {**variables,
                         collection: migrate_fc_params(variables[collection], expects)}
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for collection in ("params", "batch_stats"):
        for path, leaf in flax_msgpack.flatten(variables.get(collection, {})):
            arr = np.array(leaf, dtype=np.float32)
            *mods, name = path
            if name == "kernel":
                name, arr = "weight", arr.T
            elif name in ("embedding", "scale"):
                name = "weight"
            key = ".".join(mods + [name])
            if key in out:
                raise ValueError(f"duplicate checkpoint key {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_config_yaml(model_dir: str) -> ScoreModelConfig:
    return ScoreModelConfig.from_reference_yaml(
        flat_yaml.load(os.path.join(model_dir, MODEL_PARAMS_YAML)))


def _load_weights(model: torch.nn.Module, model_dir: str, device, checkpoint: str,
                  use_ema: bool) -> torch.nn.Module:
    dev = resolve_device(device)
    variables = flax_msgpack.load(os.path.join(model_dir, checkpoint))
    if use_ema:
        variables = {**variables, "params": variables["ema_params"]}
    model.load_state_dict(convert_variables(variables, model), strict=True)
    return model.to(dev).eval()


def _load_dir(model_dir: str, make_model, device, checkpoint: str, use_ema: bool):
    cfg = load_config_yaml(model_dir)
    return cfg, _load_weights(make_model(cfg), model_dir, device, checkpoint, use_ema)


def load_model_dir(model_dir: str, *, device: Optional[str] = None,
                   checkpoint: str = BEST_EMA_MODEL, use_ema: bool = False
                   ) -> Tuple[ScoreModelConfig, ScoreModel]:
    """The config and the eval-mode model of a model directory, on
    ``device`` (the GPU unless the caller asks for the CPU).  ``use_ema``
    takes a train-state checkpoint's EMA shadow instead of its raw
    parameters."""
    return _load_dir(model_dir, ScoreModel, device, checkpoint, use_ema)


def load_confidence_dir(model_dir: str, *, device: Optional[str] = None,
                        checkpoint: str = BEST_EMA_MODEL, use_ema: bool = False
                        ) -> Tuple[ScoreModelConfig, ConfidenceModel]:
    """The trunk config and the eval-mode confidence head of a
    ``--confidence_mode`` run directory, as :func:`load_model_dir` reads a
    score model's.  The training settings ``model_parameters.yml`` also
    holds (``mode``, ``confidence_label``, ``by_total``, ...) are ignored."""
    return _load_dir(model_dir, ConfidenceModel, device, checkpoint, use_ema)


def load_tank_dir(run_dir: str, *, device: Optional[str] = None,
                  checkpoint: str = BEST_EMA_MODEL, use_ema: bool = False
                  ) -> Tuple[Dict, TankPhore]:
    """The settings and the eval-mode ``TankPhore`` of a ``--model_type
    tank`` run directory, as :func:`load_model_dir` reads a score model's."""
    settings = flat_yaml.load(os.path.join(run_dir, MODEL_PARAMS_YAML))
    model = TankPhore(settings["tank_hidden_dim"], settings["tank_blocks"])
    return settings, _load_weights(model, run_dir, device, checkpoint, use_ema)


def save_config_yaml(cfg: ScoreModelConfig, model_dir: str, extra: Optional[Dict] = None) -> str:
    """Write the resolved config, plus ``extra`` training settings, under the
    field names ``load_config_yaml`` reads."""
    os.makedirs(model_dir, exist_ok=True)
    d = dataclasses.asdict(cfg)
    d["clash_cutoff"] = list(d["clash_cutoff"])
    d.update(extra or {})
    path = os.path.join(model_dir, MODEL_PARAMS_YAML)
    with open(path, "w") as f:
        f.write(flat_yaml.dumps(d))
    return path


def variables_from_tensors(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict:
    """Tensors keyed like ``model.state_dict()`` (parameters, buffers, or
    anything of their shapes such as optimizer moments) -> the flax tree of
    numpy leaves: the inverse of :func:`convert_variables` for one
    collection."""
    kinds = {name: type(mod) for name, mod in model.named_modules()}
    tree: Dict[str, Any] = {}
    for key, value in tensors.items():
        *mods, name = key.split(".")
        arr = value.detach().cpu().numpy()
        kind = kinds[".".join(mods)]
        if kind is torch.nn.Linear and name == "weight":
            name, arr = "kernel", arr.T
        elif kind is torch.nn.Embedding:
            name = "embedding"
        elif kind is torch.nn.LayerNorm and name == "weight":
            name = "scale"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def save_train_state(state, path: str) -> None:
    """Model, EMA shadow, optimizer moments, step and learning rate of a
    ``train.state.TrainState`` as one msgpack file."""
    model = state.model
    names = {p: name for name, p in model.named_parameters()}
    moments = {"mu": {}, "nu": {}}
    for p, st in state.optimizer.state.items():
        moments["mu"][names[p]] = st["exp_avg"]
        moments["nu"][names[p]] = st["exp_avg_sq"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flax_msgpack.dump({
        "step": int(state.step),
        "params": variables_from_tensors(model, dict(model.named_parameters())),
        "batch_stats": variables_from_tensors(model, dict(model.named_buffers())),
        "ema_params": variables_from_tensors(model, state.ema_params),
        "opt_state": {
            "learning_rate": state.learning_rate,
            "mu": variables_from_tensors(model, moments["mu"]),
            "nu": variables_from_tensors(model, moments["nu"]),
        },
    }, path)


def save_ema_variables(state, path: str) -> None:
    """The EMA shadow and the batch statistics of a
    ``train.state.TrainState`` as ``{"params", "batch_stats"}``: the layout
    of a shipped ``best_ema_inference_epoch_model.msgpack``."""
    model = state.model
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flax_msgpack.dump({
        "params": variables_from_tensors(model, state.ema_params),
        "batch_stats": variables_from_tensors(model, dict(model.named_buffers())),
    }, path)


def load_train_state(state, path: str, weights_only: bool = False):
    """Restore ``state`` in place from a checkpoint.  ``weights_only`` takes
    the parameters, batch statistics and EMA shadow (the parameters where
    the file has no shadow) and leaves optimizer and step fresh: a
    fine-tune, not a resume.  A file of ``{"params", "batch_stats"}`` alone,
    as the JAX package ships, loads that way."""
    raw = flax_msgpack.load(path)
    model, dev = state.model, state.device
    model.load_state_dict(convert_variables(raw, model), strict=True)
    ema = convert_variables({"params": raw.get("ema_params") or raw["params"]}, model)
    for name in state.ema_params:
        state.ema_params[name] = ema[name].to(dev)
    if weights_only:
        return state
    if "opt_state" not in raw or "mu" not in raw["opt_state"]:
        raise ValueError(f"`{path}` holds no optimizer state of the port: it cannot be resumed "
                         f"from (use it as --pretrain_model_pt)")
    state.step = int(raw["step"])
    mu = convert_variables({"params": raw["opt_state"]["mu"]}, model)
    nu = convert_variables({"params": raw["opt_state"]["nu"]}, model)
    for name, p in model.named_parameters():
        if name in mu:
            state.optimizer.state[p] = {
                "step": torch.tensor(float(state.step)),
                "exp_avg": mu[name].to(dev), "exp_avg_sq": nu[name].to(dev)}
    for group in state.optimizer.param_groups:
        group["lr"] = float(raw["opt_state"]["learning_rate"])
    return state
