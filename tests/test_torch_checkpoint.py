"""Checkpoint reading in the port: its own msgpack decoder against flax's,
its flat-YAML reader against PyYAML, and the 1:1 mapping of every
checkpoint leaf onto the port's state_dict."""

import glob
import os

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from diffphore_torch.device import resolve_device
from diffphore_torch.models.score_model import ScoreModel
from diffphore_torch.utils import checkpoints, flat_yaml, flax_msgpack

from torch_port_helpers import REPO

RUNS = os.path.join(REPO, "runs")
MODEL_DIRS = ["corpus2/main", "corpus/main", "posed_probe"]


def _tree_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(RUNS, "corpus2", "*", "*.msgpack"))
    + glob.glob(os.path.join(RUNS, "corpus", "main", "best_ema*.msgpack"))
    + glob.glob(os.path.join(RUNS, "posed_probe", "*.msgpack"))))
def test_msgpack_decoder_matches_flax(path):
    with open(path, "rb") as f:
        raw = f.read()
    _tree_equal(flax_msgpack.loads(raw), serialization.msgpack_restore(raw))


def test_msgpack_decoder_scalars_and_errors():
    import msgpack

    obj = {"a": [1, -3, 300, -70000, 2**40, 1.5, None, True, False, "x" * 40, b"\x00\x01"],
           "b": {"c": "é", "n": -1}}
    assert flax_msgpack.loads(msgpack.packb(obj, use_bin_type=True)) == obj
    with pytest.raises(ValueError):
        flax_msgpack.loads(msgpack.packb(obj) + b"\x00")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(RUNS, "**", "model_parameters.yml"),
                                              recursive=True)))
def test_yaml_reader_matches_pyyaml(path):
    with open(path) as f:
        assert flat_yaml.load(path) == yaml.safe_load(f)


def test_yaml_scalars():
    text = "a: 1\nb: 1.5\nc: 1e-3\nd: true\ne: null\nf: 'q'\ng:\n- 1.0\n- 2\nh:\n"
    assert flat_yaml.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("model_dir", MODEL_DIRS)
def test_every_leaf_maps_one_to_one(model_dir):
    d = os.path.join(RUNS, model_dir)
    tree = flax_msgpack.load(os.path.join(d, checkpoints.BEST_EMA_MODEL))
    leaves = {c: sum(1 for _ in flax_msgpack.flatten(tree[c])) for c in ("params", "batch_stats")}
    state = checkpoints.convert_variables(tree)
    model = ScoreModel(checkpoints.load_config_yaml(d))
    expected = model.state_dict()
    assert set(state) == set(expected)
    assert len(state) == leaves["params"] + leaves["batch_stats"]
    assert len(dict(model.named_parameters())) == leaves["params"]
    assert len(dict(model.named_buffers())) == leaves["batch_stats"]
    for k, v in state.items():
        assert v.shape == expected[k].shape, k
    if model_dir == "corpus2/main":
        assert (leaves["params"], leaves["batch_stats"]) == (280, 46)


def test_dense_kernels_are_transposed_and_fc_params_migrate():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(3, 5)).astype(np.float32)
    old = {"params": {"conv": {"fc": {"Dense_0": {"kernel": k, "bias": np.zeros(5, np.float32)},
                                      "Dense_1": {"kernel": k.T.copy(), "bias": np.ones(3, np.float32)}}},
                      "lin": {"kernel": k, "bias": np.zeros(5, np.float32)},
                      "emb": {"embedding": k}}}
    state = checkpoints.convert_variables(old)
    assert set(state) == {"conv.fc_w1", "conv.fc_b1", "conv.fc_w2", "conv.fc_b2",
                          "lin.weight", "lin.bias", "emb.weight"}
    np.testing.assert_array_equal(state["conv.fc_w1"].numpy(), k)
    np.testing.assert_array_equal(state["lin.weight"].numpy(), k.T)
    np.testing.assert_array_equal(state["emb.weight"].numpy(), k)


def test_load_model_dir_on_cpu_and_device_default():
    cfg, model = checkpoints.load_model_dir(os.path.join(RUNS, "corpus2", "main"), device="cpu")
    assert (cfg.ns, cfg.nv, cfg.num_conv_layers, cfg.tp_mode) == (20, 10, 4, "channelwise")
    assert all(p.device.type == "cpu" for p in model.parameters()) and not model.training
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
