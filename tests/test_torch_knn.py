"""The KNN phore grid (``phore_knn``) in the port against the JAX package on
the CPU: the neighbour selection, the convolutions on a sender-index grid
(K1's, K2's and K3's plain versions of the sender-index mode, which stand
in for the CUDA kernels here, and the gathered ``ChannelwiseTP.aggregate``)
and a small model, on numpy-seeded inputs and cached complexes.

Tolerances: the selection index for index, ties included; a convolution or
an aggregate at f32 to 1e-5 of its output scale (the two sides differ by
summation order), its gradients leaf by leaf to 1e-4 of the leaf's scale
(1e-5 for the aggregate's own x, sh and w); at bf16 to a quarter of the JAX
package's own f32-vs-bf16 difference on the same inputs, which is checked
to be far above what the test allows (the train-mode conv's edge-MLP and
sender gradients as one vector to 2e-2 of its norm, as
tests/test_torch_bf16.py holds them); models at f32 to 1e-4 relative
(``assert_close``); a train step's loss to 1e-4 and its gradient leaves as
in tests/test_torch_train_state.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.models import layers as tl
from diffphore_torch.models.encoder import knn_senders
from diffphore_torch.models.score_model import ScoreModel
from diffphore_torch.ops import tensor_product as ttp
from diffphore_torch.ops import tp_aggregate, tp_fused, tp_scalar
from diffphore_torch.train.losses import score_matching_loss as t_loss
from diffphore_torch.data.transforms import apply_noise as t_apply_noise
from diffphore_torch.utils import checkpoints
from diffphore_tpu.data.dataset import load_complex
from diffphore_tpu.data.transforms import apply_noise as j_apply_noise
from diffphore_tpu.models import layers as jl
from diffphore_tpu.models.score_model import ScoreModel as JScoreModel
from diffphore_tpu.ops import tensor_product as jtp
from diffphore_tpu.train.losses import score_matching_loss as j_loss

from torch_port_helpers import (CACHE, SMALL, assert_close, assert_within_gap,
                                cached_files, configs, load_pair, load_pair_batch, noised_pair,
                                port_leaves, port_model, randomize_stats, train_step_draws)

torch.set_num_threads(2)

CONV_TOL = 1e-5      # of a convolution's output scale, f32
GAP = 0.25           # of JAX's own f32-vs-bf16 difference
RTOL = 1e-4          # models, f32
GRAD_TOL = 2e-2      # of a bf16 conv's edge-MLP and sender gradient norm (tests/test_torch_bf16.py)
SH = "1x0e + 1x1o + 1x2e"
T = lambda x: torch.from_numpy(np.asarray(x).copy())

#: (in irreps, out irreps) of the phore convs of a small model: at 4 lanes
#: (l <= 1; the layer-0 conv all-scalar, K3 in training) and at 8 (l = 2)
CONVS = [
    ("8x0e", "8x0e + 4x1o"),
    ("8x0e + 4x1o", "8x0e + 4x1o + 4x1e"),
    ("8x0e + 4x1o + 4x1e", "8x0e + 4x1o + 4x1e + 8x0o"),
    ("8x0e", "8x0e + 4x1o + 4x2e"),
    ("8x0e + 4x1o + 4x2e", "8x0e + 4x1o + 4x2e + 4x1e + 4x2o"),
]


def _jax_knn(phore_pos, pair_mask, k):
    """The JAX package's selection (diffphore_tpu/models/encoder.py): the
    distances as it computes them, masked to inf, ``jax.lax.top_k``."""
    pos = jnp.asarray(phore_pos)
    p_d = jnp.linalg.norm(pos[:, None, :, :] - pos[:, :, None, :], axis=-1)
    sel = jnp.where(jnp.asarray(pair_mask), p_d, jnp.inf)
    return np.asarray(jax.lax.top_k(-sel, k)[1])


def _port_knn(phore_pos, pair_mask, k):
    """The port's selection as its encoder computes it."""
    pos = T(phore_pos)
    p_d = torch.linalg.norm(pos[:, None, :, :] - pos[:, :, None, :], dim=-1)
    sel = torch.where(T(pair_mask), p_d, torch.full_like(p_d, float("inf")))
    return knn_senders(sel, k).numpy()


@pytest.mark.parametrize("k", [8, 24, 40])
def test_selection_equals_jax_top_k_on_cached_phores(k):
    """Every cached validation complex (P = 64-128): the port's neighbour
    indices equal jax.lax.top_k's, index for index."""
    import glob
    import os

    files = sorted(glob.glob(os.path.join(CACHE, "*.npz")))
    assert len(files) >= 20
    for f in files:
        b = load_complex(f)
        m = np.asarray(b.phore_mask)
        mask = np.asarray(b.phore_edge_mask) & m[:, :, None] & m[:, None, :]
        pos = np.asarray(b.phore_pos, np.float32)
        if k >= pos.shape[1]:
            continue
        np.testing.assert_array_equal(_port_knn(pos, mask, k), _jax_knn(pos, mask, k),
                                      err_msg=os.path.basename(f))


def test_selection_keeps_the_lower_index_among_ties():
    """Tied distances at and around the K-th slot (points on the unit axes
    around each receiver, exact in f32), masked senders and rows with fewer
    than K live senders (inf ties): the lower index first, as top_k."""
    axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0], [0, 0, -1]],
                    np.float32)
    pos = np.concatenate([np.zeros((1, 3), np.float32), axes, 2 * axes, 3 * axes[:2]])[None]
    P = pos.shape[1]
    rng = np.random.default_rng(0)
    mask = np.ones((1, P, P), bool) & ~np.eye(P, dtype=bool)
    mask[0, 5] = rng.random(P) > 0.7                    # a row with few live senders
    mask[0, :, 3] = False                               # a masked sender among the ties
    for k in (3, 4, 6, 7, 9):
        np.testing.assert_array_equal(_port_knn(pos, mask, k), _jax_knn(pos, mask, k))
    # and on keys alone: many exact ties and infs
    sel = rng.integers(0, 4, (3, 9, 17)).astype(np.float32)
    sel[rng.random(sel.shape) > 0.6] = np.inf
    for k in (1, 5, 8, 16):
        np.testing.assert_array_equal(knn_senders(T(sel), k).numpy(),
                                      np.asarray(jax.lax.top_k(-jnp.asarray(sel), k)[1]))


def test_sender_lists_invert_the_index():
    """tp_fused.sender_lists: each sender row's slots, ascending, and
    nothing else; rows no slot names are empty."""
    rng = np.random.default_rng(1)
    B, N, K, Mx = 3, 7, 4, 11
    idx = T(rng.integers(0, Mx - 2, (B, N, K)).astype(np.int32))    # senders 9, 10 unnamed
    order, ptr = tp_fused.sender_lists(idx, Mx)
    assert order.dtype == ptr.dtype == torch.int32 and ptr.shape == (B * Mx + 1,)
    flat = idx.long() + Mx * torch.arange(B)[:, None, None]
    for row in range(B * Mx):
        slots = order[ptr[row]:ptr[row + 1]].long()
        want = torch.nonzero(flat.reshape(-1) == row).flatten()
        assert torch.equal(slots, want), row


def _index_inputs(irreps_in, seed=0, B=2, N=24, K=6, Mx=30, E=12):
    """x (B, Mx, D), a sender index (B, N, K) and the (B, N, K) edge tensors
    of a KNN grid, with short rows (dead slots past a live count) and a dead
    receiver."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, Mx, jl.parse(irreps_in).dim)).astype(np.float32)
    idx = rng.integers(0, Mx, (B, N, K)).astype(np.int32)
    sh = rng.normal(size=(B, N, K, 9)).astype(np.float32)
    attr = rng.normal(size=(B, N, K, E)).astype(np.float32)
    mask = rng.integers(1, K + 1, (B, N, 1)) > np.arange(K)
    mask[:, 3] = False
    return x, idx, sh, attr, mask


def _gathered(x, idx):
    return np.take_along_axis(x[:, None, :, :], idx[..., None].astype(np.int64), axis=2)


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


@pytest.mark.parametrize("irreps_in,irreps_out", CONVS)
def test_knn_conv_eval_mode_matches_jax(irreps_in, irreps_out):
    """Eval mode on a sender-index grid (K1's plain sender-index mode)
    against the JAX conv on gathered senders: f32 to 1e-5 of the output
    scale; bf16 to a quarter of JAX's own f32-vs-bf16 difference."""
    x, idx, sh, attr, mask = _index_inputs(irreps_in)
    jargs = (jnp.asarray(_gathered(x, idx)), jnp.asarray(attr), jnp.asarray(sh),
             jnp.asarray(mask))
    variables = randomize_stats(_jconv(irreps_in, irreps_out, "float32").init(
        jax.random.PRNGKey(1), *jargs))
    ref32 = np.asarray(_jconv(irreps_in, irreps_out, "float32").apply(variables, *jargs))
    ref16 = np.asarray(_jconv(irreps_in, irreps_out, "bfloat16").apply(variables, *jargs))
    targs = (T(x), T(attr), T(sh), T(mask))
    with torch.no_grad():
        got32 = _tconv(irreps_in, irreps_out, variables, "float32").eval()(
            *targs, sender_index=T(idx)).numpy()
        got16 = _tconv(irreps_in, irreps_out, variables, "bfloat16").eval()(
            *targs, sender_index=T(idx)).numpy()
    scale = float(np.abs(ref32).max())
    assert _rel(got32, ref32, scale) <= CONV_TOL
    gap = _rel(ref32, ref16, scale)
    assert _rel(got16, ref16, scale) <= GAP * gap and gap >= 100 * CONV_TOL


@pytest.mark.parametrize("irreps_in,irreps_out", CONVS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_conv_train_mode_matches_jax(irreps_in, irreps_out, dtype):
    """Training mode at dropout 0 on a sender-index grid (the edge MLP under
    autograd, then K3's plain sender-index mode for the all-scalar conv,
    K2's for the others), batch statistics: the output and the gradients of
    sum(out * g) into every parameter and the (ungathered) sender features,
    against the JAX conv on gathered senders.  f32: the output to 1e-5, each
    gradient leaf to 1e-4 of its scale.  bf16: the output to a quarter of
    JAX's own f32-vs-bf16 difference, the mix and batch-norm leaves to 1e-5,
    the edge MLP's and the senders' as one vector to GRAD_TOL of its norm."""
    x, idx, sh, attr, mask = _index_inputs(irreps_in, seed=1)
    rng = np.random.default_rng(2)
    rmask = rng.random((2, 24)) > 0.2
    variables = _jconv(irreps_in, irreps_out, "float32").init(
        jax.random.PRNGKey(3), jnp.asarray(_gathered(x, idx)), jnp.asarray(attr),
        jnp.asarray(sh), jnp.asarray(mask))
    g = rng.normal(size=(2, 24, jl.parse(irreps_out).dim)).astype(np.float32)
    bidx = jnp.arange(2)[:, None, None]

    def jgrads(dt):
        conv = _jconv(irreps_in, irreps_out, dt)

        def loss(params, x_):
            out, _ = conv.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                x_[bidx, jnp.asarray(idx)], jnp.asarray(attr), jnp.asarray(sh),
                                jnp.asarray(mask), receiver_mask=jnp.asarray(rmask),
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
    out = conv(tx, T(attr), T(sh), T(mask), T(rmask), sender_index=T(idx))
    (out * T(g)).sum().backward()
    got = {name: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for name, p in conv.named_parameters()}
    got["x"] = tx.grad.numpy()
    assert set(got) == set(want)
    out = out.detach().numpy()
    want = {k: v for k, v in want.items() if np.size(v)}
    if dtype == "float32":
        assert _rel(out, ref, float(np.abs(ref).max())) <= CONV_TOL
        for k in want:
            assert _rel(got[k], want[k], float(np.abs(want[k]).max())) <= 1e-4, k
        return
    ref32, _ = jgrads("float32")
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


@pytest.mark.parametrize("irreps_in,irreps_out", CONVS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_index_modes_match_the_jax_gathered_einsum(irreps_in, irreps_out, dtype):
    """``ChannelwiseTP.aggregate`` with a sender index, and the plain
    sender-index modes of K2 (``tp_aggregate_plain``) and, for an all-scalar
    product, K3 (``scalar_paths_aggregate_plain``), against the JAX package's
    gathered einsum ``"bnmui,bnmj,ijk,bnmu->bnuk"``: the output and the
    gradients of sum(out * g) into x, sh and w.  f32: to 1e-5 of each
    result's scale; bf16 operands: the output to 1e-5 of scale (and so to a
    quarter of JAX's own f32-vs-bf16 difference), the gradients as one vector
    to GRAD_TOL of its norm."""
    x, idx, sh, _, mask = _index_inputs(irreps_in, seed=4)
    ttp_ = ttp.channelwise_tp(irreps_in, SH, irreps_out)
    jtp_ = jtp.channelwise_tp(irreps_in, SH, irreps_out)
    rng = np.random.default_rng(5)
    w = (rng.normal(size=sh.shape[:3] + (ttp_.weight_numel,)) * mask[..., None]).astype(np.float32)
    g = rng.normal(size=(2, 24, ttp_.weight_numel, tp_fused.lanes(ttp_))).astype(np.float32)
    lanes = np.zeros_like(g)
    for p in ttp_.paths:
        lanes[:, :, p.w_slice[0]:p.w_slice[1], :2 * p.l_out + 1] = 1.0
    g = g * lanes
    bidx = jnp.arange(2)[:, None, None]

    def jax_side(dt):
        def loss(x_, sh_, w_):
            blocks = jtp_.aggregate(x_[bidx, jnp.asarray(idx)].astype(dt), sh_.astype(dt),
                                    w_.astype(dt))
            out = jnp.concatenate([jnp.pad(b, ((0, 0),) * 3 + ((0, g.shape[-1] - b.shape[-1]),))
                                   for b in _path_blocks(jtp_, blocks)], axis=-2)
            return (out * g).sum(), out

        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w))
        return {"out": np.asarray(out), **{k: np.asarray(v) for k, v in zip("x sh w".split(),
                                                                            grads)}}

    tdt = getattr(torch, dtype)
    routes = {"aggregate": lambda a, b, c: tp_fused.padded_from_blocks(
                  ttp_, ttp_.aggregate(a, b, c, T(idx))),
              "k2_plain": lambda a, b, c: tp_aggregate.tp_aggregate_plain(ttp_, a, b, c, T(idx))}
    if tp_scalar.all_scalar_paths(ttp_):
        routes["k3_plain"] = lambda a, b, c: tp_scalar.scalar_paths_aggregate_plain(
            ttp_, a, b, c, T(idx))
    want = jax_side(getattr(jnp, dtype))
    want32 = jax_side(jnp.float32) if dtype == "bfloat16" else None
    for route, fn in routes.items():
        leaves = [T(v).requires_grad_(True) for v in (x, sh, w)]
        out = fn(*(leaf.to(tdt) for leaf in leaves))
        (out * T(g)).sum().backward()
        got = {"out": out.detach().numpy(),
               **{k: leaf.grad.numpy() for k, leaf in zip("x sh w".split(), leaves)}}
        if dtype == "float32":
            for k in want:
                assert _rel(got[k], want[k], float(np.abs(want[k]).max())) <= CONV_TOL, (route, k)
            continue
        # bf16: the output (an f32 sum) as at f32 and within a quarter of the
        # gap; the gradients as one vector to GRAD_TOL of its norm (JAX forms
        # the bf16 operands' gradients in bf16, the port in f32 and rounds
        # once: tests/test_torch_bf16.py)
        assert_within_gap({"out": got["out"]}, {"out": want["out"]}, {"out": want32["out"]},
                          GAP, route)
        assert _rel(got["out"], want["out"], float(np.abs(want["out"]).max())) <= CONV_TOL
        flat = lambda d: np.concatenate([np.asarray(d[k], np.float64).ravel()
                                         for k in ("x", "sh", "w")])
        err = np.linalg.norm(flat(got) - flat(want))
        assert err <= GRAD_TOL * np.linalg.norm(flat(want)), route


def _path_blocks(tp, blocks):
    """JAX's per-irrep blocks split back into per-path channel blocks, in
    path order (the padded layout's channel order)."""
    taken = [0] * len(blocks)
    out = []
    for p in tp.paths:
        start = taken[p.i_out]
        taken[p.i_out] = start + p.mul_in
        out.append(blocks[p.i_out][..., start:start + p.mul_in, :])
    return out


def test_index_mode_refuses_dsh_before_any_launch():
    """The sender-index mode computes no dsh: K2's and K3's edge backward
    refuse it with a clear error, before anything reaches a device."""
    tp2 = ttp.channelwise_tp("8x0e + 4x1o", SH, "8x0e + 4x1o + 4x1e")
    tp3 = ttp.channelwise_tp("8x0e", SH, "8x0e + 4x1o")
    for irreps_in, tp, mod in (("8x0e + 4x1o", tp2, tp_aggregate), ("8x0e", tp3, tp_scalar)):
        x, idx, sh, _, _ = _index_inputs(irreps_in)
        w = torch.zeros(sh.shape[:3] + (tp.weight_numel,))
        g = torch.zeros((2, 24, tp.weight_numel, 4))
        with pytest.raises(ValueError, match="computes no dsh"):
            mod.launch_backward_edge(tp, T(x), T(sh), w, g, True, sender_index=T(idx))


# ---- the small model

SMALL4 = dict(SMALL, num_conv_layers=4)


@pytest.fixture(scope="module")
def batch_pair():
    return load_pair(cached_files(n=1)[0], rows=2, t=[0.7, 0.3])


def _small(jb, k, base=SMALL4, seed=0, **extra):
    jcfg, tcfg = configs(**{**base, "phore_knn": k, **extra})
    jmodel = JScoreModel(jcfg)
    variables = randomize_stats(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jb), seed=seed)
    return jcfg, jmodel, variables, tcfg


@pytest.mark.parametrize("k", [8, 24])
def test_small_knn_model_matches_jax(batch_pair, k):
    """The small model (4 conv layers) on the KNN grid, f32: tr, rot and tor
    to 1e-4 of max(|JAX|, 1)."""
    jb, tb = batch_pair
    _, jmodel, variables, tcfg = _small(jb, k)
    ref = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, jb)
    with torch.no_grad():
        got = port_model(tcfg, variables)(tb)
    for name, g, r in zip(("tr", "rot", "tor"), got, ref):
        assert_close(g, r, RTOL, name)


def test_knn_at_least_p_is_the_dense_model(batch_pair):
    """phore_knn >= P leaves the grid dense: the port's forward equals the
    phore_knn = 0 model's bit for bit, in eval mode and in training mode."""
    jb, tb = batch_pair
    P = tb.phore_pos.shape[1]
    _, _, variables, tcfg = _small(jb, 0)
    dense = port_model(tcfg, variables)
    with torch.no_grad():
        want = dense(tb)
        for k in (P, P + 40):
            _, tk = configs(**{**SMALL4, "phore_knn": k})
            model = port_model(tk, variables)
            for a, b in zip(model(tb), want):
                assert torch.equal(a, b), k
    dense.train()
    want = dense(tb)
    model = port_model(configs(**{**SMALL4, "phore_knn": P})[1], variables).train()
    for a, b in zip(model(tb), want):
        assert torch.equal(a, b)


def test_small_knn_model_matches_jax_at_bf16():
    """The small KNN model (K = 8) with bf16 convs on two noised complexes
    (off the cached pose): each output to a quarter of JAX's own
    f32-vs-bf16 difference."""
    jb, tb = noised_pair([0.7, 0.3], seed=8)
    jcfg16, j16, variables, tcfg16 = _small(jb, 8, base=dict(SMALL4, compute_dtype="bfloat16"))
    jcfg32, _ = configs(**{**SMALL4, "phore_knn": 8})
    ref = jax.jit(lambda v, b: j16.apply(v, b))(variables, jb)
    ref32 = jax.jit(lambda v, b: JScoreModel(jcfg32).apply(v, b))(variables, jb)
    with torch.no_grad():
        got = port_model(tcfg16, variables)(tb)
    gaps = [assert_within_gap({n: g}, {n: r}, {n: r32}, GAP, f"KNN bf16 {n}")
            for n, g, r, r32 in zip(("tr", "rot", "tor"), got, ref, ref32)]
    assert max(gaps) >= 1e-3, gaps


def test_small_knn_train_step_matches_jax():
    """One training forward and backward of the small KNN model (K = 8) at
    dropout 0, batch statistics, the same noise: the loss to 1e-4 and every
    gradient leaf to 1e-4 of its scale plus 5e-6 of the largest
    (tests/test_torch_train_state.py's floor)."""
    jb, tb = load_pair_batch(cached_files(n=2))
    jcfg, jmodel, variables, tcfg = _small(jb, 8)
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
        assert float(np.abs(got - ref).max()) <= 1e-4 * float(np.abs(ref).max()) + floor, name


#: the options that combine with the KNN grid: geometric attention, l = 2
#: features (the 8-lane layout), fully connected tensor products
COMBINED = {
    "use_att": dict(use_att=True),
    "second_order": dict(use_second_order_repr=True),
    "fully_connected": dict(tp_mode="fully_connected"),
}


@pytest.mark.parametrize("option", list(COMBINED))
def test_knn_combines_with_the_other_options(batch_pair, option):
    """The small KNN model (K = 8) with each option: the forward to 1e-4 of
    max(|JAX|, 1), at f32."""
    jb, tb = batch_pair
    _, jmodel, variables, tcfg = _small(jb, 8, **COMBINED[option])
    ref = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, jb)
    model = ScoreModel(tcfg)
    model.load_state_dict(checkpoints.convert_variables(
        jax.tree_util.tree_map(np.asarray, dict(variables)), model), strict=True)
    with torch.no_grad():
        got = model.eval()(tb)
    for name, g, r in zip(("tr", "rot", "tor"), got, ref):
        assert_close(g, r, RTOL, f"{option} {name}")
