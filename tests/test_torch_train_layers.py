"""Training mode of the port's layers against the JAX package with
``deterministic=False, use_running_average=False``: batch-norm batch
statistics and running update, the unfused (edge MLP + K2) branch of
``DenseTPConv`` at dropout 0, and the properties of the port's dropout
(whose masks cannot be replayed from JAX's PRNG).  f32 on both sides;
tolerances are relative to the output scale."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.models import layers as tl
from diffphore_torch.models.score_model import (ScoreModel, init_parameters,
                                                set_dropout_generator)
from diffphore_torch.utils.checkpoints import convert_variables
from diffphore_tpu.models import layers as jl

from torch_port_helpers import SMALL, assert_close, configs, randomize_stats

torch.set_num_threads(1)

RTOL = 2e-5
T = lambda x: torch.from_numpy(np.asarray(x).copy())


def _load(module, variables):
    module.load_state_dict(convert_variables(jax.tree_util.tree_map(np.asarray, dict(variables))),
                           strict=True)
    return module


def test_batch_norm_batch_statistics_and_running_update():
    """Masked batch mean, biased variance around it, mean component power
    for l > 0; running statistics move by momentum 0.1.  Two training calls
    in a row, then the eval output on the updated statistics."""
    irreps = "6x0e + 3x1o + 2x1e + 4x0o"
    rng = np.random.default_rng(2)
    dim = jl.parse(irreps).dim
    mask = rng.random((3, 5)) > 0.3
    jbn = jl.EquivariantBatchNorm(irreps)
    x0 = rng.normal(size=(3, 5, dim)).astype(np.float32) * 3 + 1
    variables = randomize_stats(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x0),
                                         jnp.asarray(mask)), seed=3)
    tbn = _load(tl.EquivariantBatchNorm(irreps), variables).train()
    for _ in range(2):
        x = rng.normal(size=(3, 5, dim)).astype(np.float32) * 3 + 1
        ref, new = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                             use_running_average=False, mutable=["batch_stats"])
        variables = {**variables, **new}
        assert_close(tbn(T(x), T(mask)), ref, RTOL, "train-mode output")
        assert_close(tbn.mean, variables["batch_stats"]["mean"], RTOL, "running mean")
        assert_close(tbn.var, variables["batch_stats"]["var"], RTOL, "running var")
    ref = jbn.apply(variables, jnp.asarray(x0), jnp.asarray(mask))
    assert_close(tbn.eval()(T(x0), T(mask)), ref, RTOL, "eval on updated statistics")


def test_batch_norm_without_mask_counts_every_node():
    irreps = "4x0e + 2x1o"
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 10)).astype(np.float32)
    jbn = jl.EquivariantBatchNorm(irreps)
    ones = jnp.ones((2, 3), bool)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), ones)
    ref, _ = jbn.apply(variables, jnp.asarray(x), ones, use_running_average=False,
                       mutable=["batch_stats"])
    tbn = _load(tl.EquivariantBatchNorm(irreps), variables).train()
    assert_close(tbn(T(x)), ref, RTOL, "no mask")


@pytest.mark.parametrize("irreps_in,irreps_out,n_chan", [
    ("8x0e", "8x0e + 4x1o", 2),
    ("8x0e + 4x1o + 4x1e", "8x0e + 4x1o + 4x1e + 8x0o", 1),
    ("8x0e + 4x1o + 4x1e + 8x0o", "2x1o + 2x1e", 1),
])
def test_dense_tp_conv_training_branch_matches_jax(irreps_in, irreps_out, n_chan):
    """The unfused branch (edge MLP in PyTorch, then K2's plain version on
    the CPU) with batch statistics over the receivers the mask keeps; and
    the gradient of sum(out * g) into every parameter and the sender
    features (1e-4 of each gradient's scale: a batch norm in the chain)."""
    rng = np.random.default_rng(0)
    B, N, M, E = 2, 7, 9, 12
    x = rng.normal(size=(B, M, jl.parse(irreps_in).dim)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, 9)).astype(np.float32)
    attrs = [rng.normal(size=(B, N, M, E)).astype(np.float32) for _ in range(n_chan)]
    masks = [rng.random((B, N, M)) > 0.4 for _ in range(n_chan)]
    rmask = rng.random((B, N)) > 0.2
    jconv = jl.DenseTPConv(in_irreps=irreps_in, out_irreps=irreps_out, n_edge_features=E,
                           hidden_features=16, tp_mode="channelwise", compute_dtype="float32",
                           dropout=0.0)
    jargs = ([jnp.asarray(a) for a in attrs], jnp.asarray(sh), [jnp.asarray(m) for m in masks])
    variables = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x), *jargs)
    g = rng.normal(size=(B, N, jl.parse(irreps_out).dim)).astype(np.float32)

    def jloss(params, x_):
        out, new = jconv.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               x_, *jargs, receiver_mask=jnp.asarray(rmask),
                               deterministic=False, use_running_average=False,
                               mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * g).sum(), (out, new["batch_stats"])

    (_, (ref, new_stats)), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))

    tconv = _load(tl.DenseTPConv(irreps_in, irreps_out, n_edge_features=E, hidden_features=16),
                  variables).train()
    tx = T(x).requires_grad_(True)
    out = tconv(tx, [T(a) for a in attrs], T(sh), [T(m) for m in masks], T(rmask))
    assert_close(out, ref, RTOL, "training output")
    (out * T(g)).sum().backward()
    assert_close(tx.grad, gx, 1e-4, "d/dx")
    want = convert_variables({"params": jax.tree_util.tree_map(np.asarray, dict(gp))})
    for name, p in tconv.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad   # an empty bias has none
        assert_close(grad, want[name], 1e-4, f"d/d{name}")
    stats = convert_variables({"batch_stats": jax.tree_util.tree_map(np.asarray, dict(new_stats))})
    for name, b in tconv.named_buffers():
        assert_close(b, stats[name], RTOL, name)


def test_dropout_properties():
    """Same generator seed -> same mask; another seed -> another mask; kept
    values scale by 1 / (1 - p) and the kept share is near 1 - p; eval mode
    is the identity."""
    drop = tl.Dropout(0.25).train()
    x = torch.ones(200, 50)
    outs = []
    for seed in (7, 7, 8):
        drop.generator = torch.Generator().manual_seed(seed)
        outs.append(drop(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    kept = outs[0] != 0
    assert torch.allclose(outs[0][kept], torch.tensor(1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert torch.equal(drop.eval()(x), x)
    assert tl.Dropout(0.0).train()(x) is x
    with pytest.raises(ValueError):
        tl.Dropout(1.0)


def test_model_dropout_follows_its_generator():
    """A training forward of the score model with dropout 0.1 repeats with
    the generator's seed, changes with it, and differs from the eval
    forward only through dropout and batch statistics (both finite)."""
    from torch_port_helpers import cached_files, load_pair

    _, tcfg = configs(**{**SMALL, "dropout": 0.1})
    model = init_parameters(ScoreModel(tcfg), seed=0)
    _, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.3, 0.7])

    def forward(seed):
        snapshot = {k: v.clone() for k, v in model.state_dict().items()}
        set_dropout_generator(model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            out = model.train()(tb)
        model.load_state_dict(snapshot)       # undo the running-statistics update
        return torch.cat([o.reshape(-1) for o in out])

    a, b, c = forward(1), forward(1), forward(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(torch.isfinite(a).all())


def test_init_parameters_distributions():
    """LeCun normal (variance 1 / fan_in, truncated at 2 std) for Linear and
    fc_w*, Glorot uniform for embeddings and mix_k, zeros and ones elsewhere;
    the same seed gives the same weights."""
    _, tcfg = configs(**SMALL)
    a = init_parameters(ScoreModel(tcfg), seed=3)
    b = init_parameters(ScoreModel(tcfg), seed=3)
    c = init_parameters(ScoreModel(tcfg), seed=4)
    for m in (a, b, c):
        m.requires_grad_(False)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert any(not torch.equal(sa[k], sc[k]) for k in sa)
    conv = a.encoder.lig_conv_1
    fan_in = conv.fc_w1.shape[0]
    assert float(conv.fc_w1.abs().max()) <= 2 / 0.87962566103423978 / fan_in ** 0.5 + 1e-6
    assert abs(float(conv.fc_w1.std()) - fan_in ** -0.5) < 0.15 * fan_in ** -0.5
    assert float(conv.fc_b1.abs().max()) == 0.0 and float(conv.fc_b2.abs().max()) == 0.0
    mix = conv.mix_0
    assert float(mix.abs().max()) <= (6.0 / sum(mix.shape)) ** 0.5
    emb = a.encoder.lig_node_embedding.Embed_0.weight
    assert float(emb.abs().max()) <= (6.0 / sum(emb.shape)) ** 0.5
    assert torch.equal(conv.bn.weight, torch.ones_like(conv.bn.weight))
    assert torch.equal(conv.bn.var, torch.ones_like(conv.bn.var))
    lin = a.tr_final_layer_dense1
    assert float(lin.bias.abs().max()) == 0.0
    assert float(lin.weight.abs().max()) <= 2 / 0.87962566103423978 / lin.in_features ** 0.5 + 1e-6


def test_layer0_conv_through_the_k3_route_matches_jax(monkeypatch):
    """A layer-0 convolution (scalars in: every path has l_in = 0) in
    training mode goes through ``tp_scalar.scalar_paths_aggregate``, never
    through K2, and matches the JAX unfused branch: output 2e-5, gradients
    into the parameters, the sender scalars and the harmonics (which the
    cross-graph convolutions need) 1e-4 of each gradient's scale."""
    from diffphore_torch.ops import tp_aggregate, tp_scalar

    irreps_in, irreps_out = "8x0e", "8x0e + 4x1o"
    rng = np.random.default_rng(4)
    B, N, M, E = 2, 13, 9, 12
    x = rng.normal(size=(B, M, 8)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, 9)).astype(np.float32)
    attr = rng.normal(size=(B, N, M, E)).astype(np.float32)
    mask = rng.random((B, N, M)) > 0.4
    jconv = jl.DenseTPConv(in_irreps=irreps_in, out_irreps=irreps_out, n_edge_features=E,
                           hidden_features=16, tp_mode="channelwise", compute_dtype="float32",
                           dropout=0.0)
    variables = jconv.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(attr),
                           jnp.asarray(sh), jnp.asarray(mask))
    g = rng.normal(size=(B, N, jl.parse(irreps_out).dim)).astype(np.float32)

    def jloss(params, x_, sh_):
        out, _ = jconv.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             x_, jnp.asarray(attr), sh_, jnp.asarray(mask),
                             deterministic=False, use_running_average=False,
                             mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * g).sum(), out

    (_, ref), (gp, gx, gsh) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], jnp.asarray(x), jnp.asarray(sh))

    calls = []
    k3 = tp_scalar.scalar_paths_aggregate
    monkeypatch.setattr(tp_scalar, "scalar_paths_aggregate",
                        lambda *a: calls.append("k3") or k3(*a))
    monkeypatch.setattr(tp_aggregate, "tp_aggregate",
                        lambda *a: pytest.fail("a layer-0 conv must not run K2"))
    tconv = _load(tl.DenseTPConv(irreps_in, irreps_out, n_edge_features=E, hidden_features=16),
                  variables).train()
    tx, tsh = T(x).requires_grad_(True), T(sh).requires_grad_(True)
    out = tconv(tx, T(attr), tsh, T(mask))
    assert calls == ["k3"]
    assert_close(out, ref, RTOL, "training output")
    (out * T(g)).sum().backward()
    assert_close(tx.grad, gx, 1e-4, "d/dx")
    assert_close(tsh.grad, gsh, 1e-4, "d/dsh")
    want = convert_variables({"params": jax.tree_util.tree_map(np.asarray, dict(gp))})
    for name, p in tconv.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        assert_close(grad, want[name], 1e-4, f"d/d{name}")
    # use_kernel = False takes the plain version of the same route
    tconv.use_kernel = False
    assert_close(tconv(T(x), T(attr), T(sh), T(mask)), ref, RTOL, "plain route")
    assert calls == ["k3"]


def test_k3_route_is_chosen_exactly_for_the_layer0_convs(monkeypatch):
    """In a training forward of the score model the six layer-0 convs
    (scalars in) run K3 and every other conv runs K2; an eval forward runs
    neither (K1)."""
    from diffphore_torch.ops import tp_aggregate, tp_scalar
    from torch_port_helpers import cached_files, load_pair

    _, tcfg = configs(**SMALL)
    model = init_parameters(ScoreModel(tcfg), seed=0)
    _, tb = load_pair(cached_files(n=1)[0], rows=2, t=[0.3, 0.7])
    current, routes = [], {}
    for name, mod in model.named_modules():
        if isinstance(mod, tl.DenseTPConv):
            mod.register_forward_pre_hook(lambda m, a, name=name: current.append(name))
    k2, k3 = tp_aggregate.tp_aggregate, tp_scalar.scalar_paths_aggregate
    monkeypatch.setattr(tp_aggregate, "tp_aggregate",
                        lambda *a: routes.setdefault(current[-1], "k2") and k2(*a))
    monkeypatch.setattr(tp_scalar, "scalar_paths_aggregate",
                        lambda *a: routes.setdefault(current[-1], "k3") and k3(*a))
    with torch.no_grad():
        model.train()(tb)
    layer0 = {"encoder." + n for n in (
        "lig_conv_0", "phore_to_lig_conv_0", "phore_to_lig_norm_conv_0", "phore_conv_0",
        "lig_to_phore_conv_0", "lig_to_phore_norm_conv_0")}
    assert {n for n, r in routes.items() if r == "k3"} == layer0
    assert len(routes) == 11 and set(routes.values()) == {"k2", "k3"}
    for name, mod in model.named_modules():
        if isinstance(mod, tl.DenseTPConv):
            assert tp_scalar.all_scalar_paths(mod.tp) == (name in layer0), name
    routes.clear()
    with torch.no_grad():
        model.eval()(tb)
    assert routes == {}
