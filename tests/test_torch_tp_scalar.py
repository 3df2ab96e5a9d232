"""K3 on the CPU: the port's plain scalar-path aggregate against the JAX
package's Pallas kernel in interpret mode (``scalar_path_aggregate(...,
interpret=True)``) on the shapes of its own tests, its autograd gradients
against ``jax.grad`` of the einsum, strided views against contiguous copies,
the conv-level packing against ``ChannelwiseTP.aggregate``, in f32 and
with bf16 operands (the per-path scale of a bf16-rounded coupling tensor),
and the conv-level edge backward's plain version against ``jax.grad`` of
``ChannelwiseTP.aggregate``.  The CUDA kernels themselves are held against
the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffphore_torch.ops import tp_aggregate, tp_fused, tp_scalar
from diffphore_torch.ops.tensor_product import channelwise_tp
from diffphore_tpu.ops.pallas.tp_scalar import scalar_path_aggregate as j_scalar_path_aggregate
from diffphore_tpu.ops.tensor_product import channelwise_tp as j_channelwise_tp

torch.set_num_threads(2)

T = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())
SH = "1x0e + 1x1o + 1x2e"


def _inputs(seed, B, N, M, U, K, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, M, U)).astype(np.float32)
    sh = rng.normal(size=(B, N, M, K)).astype(np.float32)
    w = rng.normal(size=(B, N, M, U)).astype(np.float32)
    if masked:
        w[:, :, M // 2:, :] = 0.0          # the mask folded into w
    return x, sh, w


@pytest.mark.parametrize("seed,B,N,M,U,K,masked", [
    (0, 3, 24, 80, 32, 8, False),
    (1, 2, 13, 40, 16, 4, False),          # N not a multiple of the TPU kernel's tile
    (2, 1, 8, 16, 8, 4, True),
    (3, 2, 13, 24, 20, 1, False),          # the 0e x 0e -> 0e path
    (4, 2, 13, 24, 20, 3, True),           # the 0e x 1o -> 1o path
])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(seed, B, N, M, U, K, masked):
    """atol 1e-3, as the JAX package's own test of the kernel holds it
    against the einsum (sums of up to 80 products of unit normals)."""
    x, sh, w = _inputs(seed, B, N, M, U, K, masked)
    ref = np.asarray(j_scalar_path_aggregate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w),
                                             interpret=True))
    got = tp_scalar.scalar_path_aggregate_plain(T(x), T(sh), T(w))
    assert got.shape == (B, N, U, K) and got.dtype == torch.float32
    assert np.allclose(got.numpy(), ref, atol=1e-3), np.abs(got.numpy() - ref).max()
    if masked:
        half = tp_scalar.scalar_path_aggregate_plain(T(x[:, :M // 2]), T(sh[:, :, :M // 2]),
                                                     T(w[:, :, :M // 2]))
        assert np.allclose(got.numpy(), half.numpy(), atol=1e-5)


@pytest.mark.parametrize("K", [1, 3])
def test_gradients_match_jax_grad_of_the_einsum(K):
    """dx, dsh and dw of sum(out * g): 1e-4 of each gradient's scale (f32,
    summation order only)."""
    B, N, M, U = 2, 13, 24, 20
    x, sh, w = _inputs(5 + K, B, N, M, U, K, masked=True)
    g = np.random.default_rng(9).normal(size=(B, N, U, K)).astype(np.float32)

    def jloss(x_, sh_, w_):
        return (jnp.einsum("bmu,bnmk,bnmu->bnuk", x_, sh_, w_) * g).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w))
    leaves = [T(v).requires_grad_(True) for v in (x, sh, w)]
    (tp_scalar.scalar_path_aggregate_plain(*leaves) * T(g)).sum().backward()
    for name, leaf, ref in zip(("dx", "dsh", "dw"), leaves, want):
        ref = np.asarray(ref)
        err = float(np.abs(leaf.grad.numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (name, err)


def test_strided_views_give_the_result_of_contiguous_copies():
    """The per-path function takes last-axis slices of a conv's full
    harmonics and weights as they are; the result (and the gradient into
    the full tensors) equals that of contiguous copies."""
    B, N, M, ns = 2, 7, 9, 8
    rng = np.random.default_rng(11)
    x = T(rng.normal(size=(B, M, ns)))
    sh_full = T(rng.normal(size=(B, N, M, 9))).requires_grad_(True)
    w_full = T(rng.normal(size=(B, N, M, 2 * ns))).requires_grad_(True)
    sh_v, w_v = sh_full[..., 1:4], w_full[..., ns:2 * ns]
    assert not sh_v.is_contiguous() and not w_v.is_contiguous()
    out_v = tp_scalar.scalar_path_aggregate_plain(x, sh_v, w_v)
    out_c = tp_scalar.scalar_path_aggregate_plain(x, sh_v.detach().contiguous(),
                                            w_v.detach().contiguous())
    assert torch.equal(out_v.detach(), out_c)
    out_v.sum().backward()
    assert float(sh_full.grad[..., 0].abs().max()) == 0.0       # outside the slice
    assert float(sh_full.grad[..., 4:].abs().max()) == 0.0
    assert float(w_full.grad[..., :ns].abs().max()) == 0.0
    assert float(w_full.grad[..., ns:].abs().max()) > 0.0


@pytest.mark.parametrize("irreps_in,irreps_out", [
    ("8x0e", "8x0e + 4x1o"),                       # the layer-0 signature
    ("6x0e + 3x0o", "6x0e + 2x1o + 2x1e + 3x0o"),  # two scalar inputs share harmonics
])
def test_conv_level_packing_matches_channelwise_aggregate(irreps_in, irreps_out):
    """One einsum per l_in = 0 path, packed into (B, N, F, 4): the same
    numbers as K2's plain version (``ChannelwiseTP.aggregate`` with the
    coupling tensors), 1e-5 of scale, and the same gradients."""
    tp = channelwise_tp(irreps_in, SH, irreps_out)
    assert tp_scalar.all_scalar_paths(tp)
    B, N, M = 2, 5, 7
    rng = np.random.default_rng(3)
    vals = [rng.normal(size=(B, M, tp.irreps_in.dim)), rng.normal(size=(B, N, M, 9)),
            rng.normal(size=(B, N, M, tp.weight_numel))]
    g = T(rng.normal(size=(B, N, tp.weight_numel, 4)))
    results = []
    for fn in (tp_scalar.scalar_paths_aggregate, tp_aggregate.tp_aggregate_plain):
        leaves = [T(v).requires_grad_(True) for v in vals]
        out = fn(tp, *leaves)
        (out * g).sum().backward()
        results.append([out.detach()] + [leaf.grad for leaf in leaves])
    for name, got, want in zip(("out", "dx", "dsh", "dw"), *results):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), name
    assert [tuple(v[0].shape) for v in tp_scalar.path_views(tp, *map(T, vals))] \
        == [(B, M, p.mul_in) for p in tp.paths]


def test_route_applies_only_to_all_scalar_convs():
    assert not tp_scalar.all_scalar_paths(channelwise_tp("8x0e + 4x1o", SH, "8x0e + 4x1o"))
    tp = channelwise_tp("8x0e + 4x1o", SH, "8x0e + 4x1o")
    with pytest.raises(ValueError, match="l_in = 0"):
        tp_scalar.scalar_paths_aggregate(tp, torch.zeros(1, 2, 20), torch.zeros(1, 3, 2, 9),
                                         torch.zeros(1, 3, 2, tp.weight_numel))


@pytest.mark.parametrize("irreps_in,irreps_out", [
    ("20x0e", "20x0e + 10x1o"),             # the layer-0 signature, F = 40
    ("3x0e + 1x0o", "3x0e + 1x1o + 1x0o"),  # F = 7; two paths read harmonic component 0
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("need_dsh", [True, False])
def test_edge_backward_plain_matches_jax_grad_of_the_aggregate(irreps_in, irreps_out, dtype,
                                                               need_dsh):
    """``scalar_paths_backward_edge_plain`` (dw, and dsh of the full
    9-component row) against ``jax.grad`` of the JAX package's
    ``ChannelwiseTP.aggregate`` on ragged shapes with masked edges: f32 to
    1e-5 of each gradient's scale; bf16 operands (JAX at bf16, its
    bf16-rounded coupling tensors) within one bf16 rounding step of each
    element plus 1e-6 of scale, except that JAX rounds each path's dsh to
    bf16 and adds the paths in bf16, so a component that k paths read is held
    to k steps; the components no path reads exactly zero; dsh alone
    (``need_dw=False``) gives the same bits."""
    tp, jtp = channelwise_tp(irreps_in, SH, irreps_out), j_channelwise_tp(irreps_in, SH, irreps_out)
    B, N, M, F = 2, 5, 7, tp.weight_numel
    rng = np.random.default_rng(12)
    vals = [rng.normal(size=(B, M, tp.irreps_in.dim)), rng.normal(size=(B, N, M, 9)),
            rng.normal(size=(B, N, M, F)) * (rng.random((B, N, M, 1)) > 0.3)]
    g = T(rng.normal(size=(B, N, F, 4)))                      # noise in the pad lanes too
    g_blocks = [None if b is None else jnp.asarray(b.numpy())
                for b in tp_fused.blocks_from_padded(tp, g)]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jvals = [jnp.asarray(v, jdt) for v in vals]

    def jloss(x_, sh_, w_):
        return sum((blk.astype(jnp.float32) * gb).sum()
                   for blk, gb in zip(jtp.aggregate(x_, sh_, w_), g_blocks) if blk is not None)

    want_dsh, want_dw = (torch.from_numpy(np.array(r, np.float32))
                         for r in jax.grad(jloss, argnums=(1, 2))(*jvals))
    x, sh, w = (torch.from_numpy(np.array(v, np.float32)).to(tdt) for v in jvals)
    dw, dsh = tp_scalar.scalar_paths_backward_edge_plain(tp, x, sh, w, g, need_dsh)
    assert dw.dtype == tdt and (dsh is None) == (not need_dsh)
    readers = torch.zeros(9)
    for p in tp.paths:
        readers[tp.irreps_sh.slices()[p.i_sh]] += 1
    for name, got, want, steps in (("dw", dw, want_dw, 1.0), ("dsh", dsh, want_dsh, readers)):
        if got is None:
            continue
        scale = float(want.abs().max())
        err = (got.float() - want).abs()
        if dtype == "f32":
            assert float(err.max()) <= 1e-5 * scale, (name, float(err.max()))
        else:
            assert bool((err <= steps * 2.0 ** -7 * want.abs() + 1e-6 * scale).all()), name
    if need_dsh:
        assert float(dsh[..., readers == 0].abs().max()) == 0.0
        assert float(dsh[..., 4:].abs().max()) == 0.0
        dw_none, dsh_alone = tp_scalar.scalar_paths_backward_edge_plain(tp, x, sh, w, g, True,
                                                                        need_dw=False)
        assert dw_none is None and torch.equal(dsh_alone, dsh)


def test_launch_counters_stay_zero_on_the_cpu():
    counters = (tp_scalar.FWD, tp_scalar.BWD_EDGE, tp_scalar.BWD_X)
    before = [k.launches for k in counters]
    tp = channelwise_tp("5x0e", SH, "5x0e + 2x1o")
    rng = np.random.default_rng(0)
    leaves = [T(rng.normal(size=s)).requires_grad_(True)
              for s in ((1, 4, 5), (1, 3, 4, 9), (1, 3, 4, tp.weight_numel))]
    tp_scalar.scalar_paths_aggregate(tp, *leaves).sum().backward()
    assert [k.launches for k in counters] == before
