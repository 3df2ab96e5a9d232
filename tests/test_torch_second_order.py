"""l = 2 features (``use_second_order_repr``) in the port against the JAX
package on the CPU, on numpy-seeded inputs.

The port's plain versions of K1, K2 and K3 (the 8-lane layout: five
components a channel, padded to 8) stand in for the CUDA kernels here.
Tolerances follow PERF.md's rule: a convolution at f32 to 1e-5 of its
output scale (the two sides differ by summation order); at bf16 to a
quarter of the JAX package's own f32-vs-bf16 difference on the same inputs,
which is also checked to be far above what the test allows; models at f32
to 1e-4 relative (``assert_close``); a train step's loss to 1e-4 and its
gradient leaves as in ``tests/test_torch_train_state.py``.  The full-width
probe (``runs/second_order_probe``, written by
``analysis/write_second_order_probe.py``) is held against its committed
JAX reference at 1e-4.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from diffphore_torch.data import graphs as tgraphs
from diffphore_torch.data.transforms import apply_noise as t_apply_noise
from diffphore_torch.models import layers as tl
from diffphore_torch.models.confidence import ConfidenceModel as TConfidenceModel
from diffphore_torch.models.layers import set_compute_dtype
from diffphore_torch.ops import tp_fused, tp_scalar
from diffphore_torch.train.losses import score_matching_loss as t_loss
from diffphore_torch.train.state import create_train_state
from diffphore_torch.utils import checkpoints, flax_msgpack
from diffphore_tpu.data.transforms import apply_noise as j_apply_noise
from diffphore_tpu.models import layers as jl
from diffphore_tpu.models.confidence import ConfidenceModel as JConfidenceModel
from diffphore_tpu.models.score_model import ScoreModel as JScoreModel
from diffphore_tpu.train.losses import score_matching_loss as j_loss
from diffphore_tpu.utils import checkpoints as jckpt

from torch_port_helpers import (REPO, SMALL, assert_close, cached_files, configs, load_pair,
                                load_pair_batch, port_leaves, port_model, randomize_stats,
                                train_step_draws)

sys.path.insert(0, os.path.join(REPO, "analysis"))
import write_second_order_probe as probe  # noqa: E402

torch.set_num_threads(2)

CONV_TOL = 1e-5      # of a convolution's output scale, f32
GAP = 0.25           # of JAX's own f32-vs-bf16 difference
RTOL = 1e-4          # models, f32
GRAD_TOL = 2e-2      # of a bf16 conv's edge-MLP and sender gradient norm (tests/test_torch_bf16.py)
SH = "1x0e + 1x1o + 1x2e"
SMALL_L2 = dict(SMALL, use_second_order_repr=True, num_conv_layers=4)
T = lambda x: torch.from_numpy(np.asarray(x).copy())

#: (in irreps, out irreps, edge channels) of the small second-order model:
#: the all-scalar layer-0 conv (K3 in training; its 0e x 2e -> 2e path reads
#: harmonic components 4-8) with two edge channels, a layer-1 conv (l_in and
#: l_out up to 2, K2), and the final conv (l_in 2 -> l_out 1)
CONVS = [
    ("8x0e", "8x0e + 4x1o + 4x2e", 2),
    ("8x0e + 4x1o + 4x2e", "8x0e + 4x1o + 4x2e + 4x1e + 4x2o", 1),
    ("8x0e + 4x1o + 4x2e + 4x1e + 4x2o + 8x0o", "2x1o + 2x1e", 1),
]


def _conv_inputs(irreps_in, n_chan, seed=0, B=2, N=24, M=40, E=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, M, jl.parse(irreps_in).dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, 9)).astype(np.float32)
    attrs = [rng.normal(size=(B, N, M, E)).astype(np.float32) for _ in range(n_chan)]
    masks = [rng.random((B, N, M)) > 0.4 for _ in range(n_chan)]
    return x, sh, attrs, masks


def _jconv(irreps_in, irreps_out, dtype, E=12):
    return jl.DenseTPConv(in_irreps=irreps_in, out_irreps=irreps_out, n_edge_features=E,
                          hidden_features=16, tp_mode="channelwise", compute_dtype=dtype,
                          dropout=0.0)


def _tconv(irreps_in, irreps_out, variables, dtype, E=12):
    conv = tl.DenseTPConv(irreps_in, irreps_out, n_edge_features=E, hidden_features=16,
                          compute_dtype=dtype)
    conv.load_state_dict(checkpoints.convert_variables(
        jax.tree_util.tree_map(np.asarray, dict(variables))), strict=True)
    return conv


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()) / scale


def test_second_order_convs_take_the_8_lane_layout():
    """Every l = 2 product takes 8 lanes, the l <= 1 ones keep 4; the layer-0
    conv is all-scalar (K3), and alpha * cg(0, 2, 2) is the identity there."""
    from diffphore_torch.ops.tensor_product import channelwise_tp

    for irreps_in, irreps_out, _ in CONVS:
        assert tp_fused.lanes(channelwise_tp(irreps_in, SH, irreps_out)) == 8
    assert tp_fused.lanes(channelwise_tp("8x0e + 4x1o", SH, "8x0e + 4x1o + 4x1e")) == 4
    layer0 = channelwise_tp(CONVS[0][0], SH, CONVS[0][1])
    assert tp_scalar.all_scalar_paths(layer0) and tp_scalar.sh_reach(layer0) == 9
    with pytest.raises(ValueError, match="l_in, l_out <= 2"):
        tp_fused.lanes(channelwise_tp("4x3o", SH, "4x3o"))


@pytest.mark.parametrize("irreps_in,irreps_out,n_chan", CONVS)
def test_dense_tp_conv_eval_mode_matches_jax(irreps_in, irreps_out, n_chan):
    """Eval mode (K1's plain version, 8 lanes): f32 to 1e-5 of the output
    scale; bf16 (the JAX package's bf16 convolution) to a quarter of JAX's
    own f32-vs-bf16 difference."""
    x, sh, attrs, masks = _conv_inputs(irreps_in, n_chan)
    jargs = (jnp.asarray(x), [jnp.asarray(a) for a in attrs], jnp.asarray(sh),
             [jnp.asarray(m) for m in masks])
    variables = randomize_stats(_jconv(irreps_in, irreps_out, "float32").init(
        jax.random.PRNGKey(1), *jargs))
    ref32 = np.asarray(_jconv(irreps_in, irreps_out, "float32").apply(variables, *jargs))
    ref16 = np.asarray(_jconv(irreps_in, irreps_out, "bfloat16").apply(variables, *jargs))
    targs = (T(x), [T(a) for a in attrs], T(sh), [T(m) for m in masks])
    with torch.no_grad():
        got32 = _tconv(irreps_in, irreps_out, variables, "float32").eval()(*targs).numpy()
        got16 = _tconv(irreps_in, irreps_out, variables, "bfloat16").eval()(*targs).numpy()
    scale = float(np.abs(ref32).max())
    assert _rel(got32, ref32, scale) <= CONV_TOL
    gap = _rel(ref32, ref16, scale)
    assert _rel(got16, ref16, scale) <= GAP * gap and gap >= 100 * CONV_TOL


@pytest.mark.parametrize("irreps_in,irreps_out,n_chan", CONVS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_tp_conv_train_mode_matches_jax(irreps_in, irreps_out, n_chan, dtype):
    """Training mode at dropout 0 (the edge MLP under autograd, then K3's
    plain version for the all-scalar conv, K2's for the others), batch
    statistics: the output and the gradients of sum(out * g) into every
    parameter and the sender features.  f32: the output to 1e-5 of its
    scale, each gradient leaf to 1e-4 of its scale.  bf16: the output to a
    quarter of JAX's own f32-vs-bf16 difference; the gradients as
    tests/test_torch_bf16.py holds them (the mix and batch-norm leaves,
    formed after the f32 sum over senders, to 1e-5 of their scale; the edge
    MLP's and the sender features' as one vector to GRAD_TOL of its norm:
    JAX sums the bias and sender gradients over edges in bf16, the port in
    f32)."""
    x, sh, attrs, masks = _conv_inputs(irreps_in, n_chan, seed=1)
    rng = np.random.default_rng(2)
    jattrs = ([jnp.asarray(a) for a in attrs], jnp.asarray(sh), [jnp.asarray(m) for m in masks])
    rmask = rng.random((2, 24)) > 0.2
    variables = _jconv(irreps_in, irreps_out, "float32").init(
        jax.random.PRNGKey(3), jnp.asarray(x), *jattrs)
    g = rng.normal(size=(2, 24, jl.parse(irreps_out).dim)).astype(np.float32)

    def jgrads(dt):
        conv = _jconv(irreps_in, irreps_out, dt)

        def loss(params, x_):
            out, _ = conv.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                x_, *jattrs, receiver_mask=jnp.asarray(rmask),
                                deterministic=False, use_running_average=False,
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
            return (out * g).sum(), out

        (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            variables["params"], jnp.asarray(x))
        grads = port_leaves(gp)
        return np.asarray(out), {**{k: v.numpy() for k, v in grads.items()}, "x": np.asarray(gx)}

    ref, want = jgrads(dtype)
    conv = _tconv(irreps_in, irreps_out, variables, dtype).train()
    tx = T(x).requires_grad_(True)
    out = conv(tx, [T(a) for a in attrs], T(sh), [T(m) for m in masks], T(rmask))
    (out * T(g)).sum().backward()
    got = {name: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for name, p in conv.named_parameters()}
    got["x"] = tx.grad.numpy()
    assert set(got) == set(want)
    out = out.detach().numpy()
    want = {k: v for k, v in want.items() if np.size(v)}    # a head's batch norm has no bias
    if dtype == "float32":
        assert _rel(out, ref, float(np.abs(ref).max())) <= CONV_TOL
        for k in want:
            assert _rel(got[k], want[k], float(np.abs(want[k]).max())) <= 1e-4, k
        return
    ref32, want32 = jgrads("float32")
    scale = float(np.abs(ref32).max())
    gap = _rel(ref32, ref, scale)
    assert _rel(out, ref, scale) <= GAP * gap and gap >= 100 * CONV_TOL
    late = [k for k in want if k.startswith(("mix_", "bn."))]
    for k in late:
        assert _rel(got[k], want[k], float(np.abs(want[k]).max())) <= CONV_TOL, k
    early = [k for k in want if k not in late]
    err = np.linalg.norm(np.concatenate([(got[k] - want[k]).ravel() for k in early]))
    norm = np.linalg.norm(np.concatenate([np.asarray(want[k]).ravel() for k in early]))
    assert err <= GRAD_TOL * norm, f"edge MLP and sender gradients: {err / norm:.2e} of norm"


@pytest.fixture(scope="module")
def small_model():
    """(JAX config, JAX model, variables with random running statistics,
    port config) of the small second-order config, 4 conv layers."""
    jcfg, tcfg = configs(**SMALL_L2)
    jmodel = JScoreModel(jcfg)
    jb, _ = load_pair(cached_files(n=1)[0], rows=2, t=[0.7, 0.3])
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb), seed=0)
    return jcfg, jmodel, variables, tcfg


def test_small_model_forward_matches_jax(small_model):
    jcfg, jmodel, variables, tcfg = small_model
    jb, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.7, 0.3])
    ref = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, jb)
    model = port_model(tcfg, variables)
    assert model.encoder.out_irreps == "8x0e + 4x1o + 4x2e + 4x1e + 4x2o + 8x0o"
    with torch.no_grad():
        got = model(tb)
    for name, g, r in zip(("tr", "rot", "tor"), got, ref):
        assert_close(g, r, RTOL, name)


def test_small_model_train_step_matches_jax(small_model):
    """One training forward and backward at dropout 0, batch statistics, the
    same noise: the loss to 1e-4 and every gradient leaf to 1e-4 of its
    scale plus 5e-6 of the largest (tests/test_torch_train_state.py's
    floor for the two transition MLPs whose true gradient is zero)."""
    jcfg, jmodel, variables, tcfg = small_model
    jb, tb = load_pair_batch(cached_files(n=2))
    key = jax.random.PRNGKey(1)
    k_noise, k_drop = jax.random.split(key)
    schedule = jcfg.sigma_schedule

    @jax.jit
    def jax_side(params, batch_stats):
        noised, targets = j_apply_noise(jb, k_noise, schedule)

        def loss_fn(p):
            preds, _ = jmodel.apply({"params": p, "batch_stats": batch_stats}, noised,
                                    deterministic=False, use_running_average=False,
                                    mutable=["batch_stats"], rngs={"dropout": k_drop})
            return j_loss(preds, targets, noised.t, jb.tor_mask, schedule, valid=jb.valid)["loss"]

        return jax.value_and_grad(loss_fn)(params)

    jloss, jgrads = jax_side(variables["params"], variables["batch_stats"])
    model = port_model(tcfg, variables).train()
    noised, targets = t_apply_noise(tb, tcfg.sigma_schedule,
                                    draws=train_step_draws(key, tb.batch_size, tb.num_torsions))
    m = t_loss(model(noised), targets, noised.t, tb.tor_mask, tcfg.sigma_schedule,
               valid=tb.valid)
    m["loss"].backward()
    assert_close(m["loss"], jloss, 1e-4, "loss")
    want = port_leaves(jgrads)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    floor = 5e-6 * max(float(v.abs().max()) for v in want.values() if v.numel())
    for name, p in params.items():
        ref = want[name].numpy()
        if not ref.size:
            continue
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        err = float(np.abs(got - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()) + floor, name


def test_confidence_model_matches_jax():
    """The confidence head at l = 2 (small width, flax-init weights with
    random running statistics), f32."""
    jcfg, tcfg = configs(**SMALL_L2)
    jb, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.6, 0.2])
    jmodel = JConfidenceModel(jcfg)
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(2), jb), seed=2)
    ref = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, jb)
    model = port_model(tcfg, variables, TConfidenceModel)
    with torch.no_grad():
        got = model(tb)
    for name, g, r in zip(("fit", "ph", "ex"), got, ref):
        assert_close(g, r, RTOL, name)


def _probe_rows():
    tb = tgraphs.repeat_batch(tgraphs.load_cached(probe.bucket_files(probe.VAL_CACHE, 1)[0]),
                              len(probe.REFERENCE_T))
    shift = torch.tensor(probe.LIGAND_SHIFT, dtype=torch.float32)[:, None]
    return tb.replace(t=torch.tensor(probe.REFERENCE_T, dtype=torch.float32),
                      lig_pos=tb.lig_pos + shift)


def test_full_width_probe_matches_its_jax_reference():
    """runs/second_order_probe (corpus2's width, ns 20, nv 10, 4 layers) loads
    through the port's entry point and its f32 forward matches the committed
    JAX reference at 1e-4; its shipped bf16 forward is finite."""
    cfg, model = checkpoints.load_model_dir(probe.OUT, device="cpu")
    assert cfg.use_second_order_repr and (cfg.ns, cfg.nv, cfg.num_conv_layers) == (20, 10, 4)
    assert cfg.compute_dtype == "bfloat16"
    ref = np.load(os.path.join(probe.OUT, "reference.npz"))
    tb = _probe_rows()
    set_compute_dtype(model, "float32")
    with torch.no_grad():
        got = model(tb)
    for name, g in zip(("tr", "rot", "tor"), got):
        assert_close(g, ref[name], RTOL, name)
    set_compute_dtype(model, "bfloat16")
    with torch.no_grad():
        assert all(bool(torch.isfinite(o).all()) for o in model(tb))


def test_probe_reference_regenerates_equal():
    """The JAX forward that wrote reference.npz, run again on the committed
    checkpoint, gives the committed numbers."""
    ref = np.load(os.path.join(probe.OUT, "reference.npz"))
    again = probe.reference_outputs(probe.OUT)
    assert set(again) == set(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(again[k], ref[k], err_msg=k)


def test_checkpoints_round_trip_both_ways(small_model, tmp_path):
    """A JAX l = 2 checkpoint restores strictly in the port (every leaf,
    the extra mix blocks and the wider batch-norm vectors included); a
    port-saved one restores strictly in the JAX package (flax's from_bytes
    on the JAX init as template) with the same values."""
    jcfg, jmodel, variables, tcfg = small_model
    path = str(tmp_path / "jax.msgpack")
    jckpt.save_variables(jax.tree_util.tree_map(np.asarray, dict(variables)), path)
    model = port_model(tcfg, flax_msgpack.load(path))      # load_state_dict(strict=True)
    names = set(model.state_dict())
    assert any(n.endswith("mix_4") for n in names)          # the 2o block of a layer-1 conv
    state = create_train_state(tcfg, seed=3, device="cpu", model=model)
    out = str(tmp_path / "port.msgpack")
    checkpoints.save_ema_variables(state, out)
    restored = jckpt.load_variables(jax.tree_util.tree_map(np.asarray, dict(variables)), out)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    a, b = flat(restored), flat(jax.tree_util.tree_map(np.asarray, dict(variables)))
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))
    with open(out, "rb") as f:
        assert serialization.from_bytes(dict(variables), f.read()) is not None


def test_config_yaml_round_trips_the_flag(tmp_path):
    """model_parameters.yml written by the port carries the flag back."""
    _, tcfg = configs(**SMALL_L2)
    checkpoints.save_config_yaml(tcfg, str(tmp_path))
    assert checkpoints.load_config_yaml(str(tmp_path)).use_second_order_repr
