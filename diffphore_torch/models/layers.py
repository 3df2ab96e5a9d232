"""Model layers: Gaussian smearing, MLPs, categorical encoders, dropout from
an explicit generator, equivariant batch norm (running statistics in eval
mode, masked batch statistics in training mode) and the channelwise
dense-edge tensor-product convolution.

``nn.Module.training`` stands for the JAX package's ``deterministic=False``
and ``use_running_average=False``, which its trainers set together.  The one
place that separates them, the confidence head's validation step
(``deterministic=True, use_running_average=False``), runs in eval mode under
:func:`batch_statistics`.

Attribute names mirror the JAX package's flax scope names (``Dense_0``,
``Embed_k``, ``fc_w1``, ``mix_k``, ``bn``), so a checkpoint converts by a
mechanical tree walk (:mod:`diffphore_torch.utils.checkpoints`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Optional, Sequence, Union

import torch
import torch.nn.functional as Fn
from torch import nn

from ..ops import tp_aggregate, tp_fused, tp_scalar
from ..ops.irreps import parse
from ..ops.tensor_product import channelwise_tp, fully_connected_tp


class GaussianSmearing(nn.Module):
    """Distance -> RBF embedding."""

    def __init__(self, start: float = 0.0, stop: float = 5.0, num_gaussians: int = 50):
        super().__init__()
        self.start, self.stop, self.num_gaussians = start, stop, num_gaussians

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        offset = torch.linspace(self.start, self.stop, self.num_gaussians,
                                dtype=torch.float32, device=dist.device)
        coeff = -0.5 / (offset[1] - offset[0]) ** 2
        d = dist[..., None] - offset
        return torch.exp(coeff * d * d)


class Dropout(nn.Module):
    """Inverted dropout whose masks come from ``self.generator`` (the global
    generator of the tensor's device when None).  Identity in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} outside [0, 1)")
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None
        #: set by :func:`data_parallel`: masks are drawn for the global batch
        #: (leading axis) and this rank's rows taken
        self.shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.shard is None:
            u = torch.rand(x.shape, generator=self.generator, device=x.device)
        else:
            shape = (x.shape[0] * self.shard.world,) + tuple(x.shape[1:])
            u = torch.rand(shape, generator=self.generator, device=x.device)
            u = u[self.shard.rows(shape[0])]
        keep = u >= self.rate
        return x * keep.to(x.dtype) / (1.0 - self.rate)


class MLP(nn.Module):
    """Linear - activation - dropout - Linear."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 activation: Callable = torch.relu, dropout: float = 0.0):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, out)
        self.activation = activation
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(self.drop(self.activation(self.Dense_0(x))))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return Fn.leaky_relu(x, 0.01)


class CategoricalEncoder(nn.Module):
    """Sum of per-column embeddings + linear on trailing scalars."""

    def __init__(self, emb_dim: int, feature_dims: Sequence[int], num_scalars: int = 0):
        super().__init__()
        self.n_cols = len(feature_dims)
        for k, vocab in enumerate(feature_dims):
            setattr(self, f"Embed_{k}", nn.Embedding(vocab, emb_dim))
        self.num_scalars = num_scalars
        if num_scalars:
            self.Dense_0 = nn.Linear(num_scalars, emb_dim)

    def forward(self, cat: torch.Tensor, scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = 0.0
        for k in range(self.n_cols):
            out = out + getattr(self, f"Embed_{k}")(cat[..., k])
        if self.num_scalars:
            out = out + self.Dense_0(scalars)
        return out


class EquivariantBatchNorm(nn.Module):
    """Irreps-aware batch norm: scalar fields get mean/var normalization with
    scale and bias, higher-l fields are divided by the root of their mean
    component power and scaled.

    Eval mode reads the running statistics.  Training mode normalizes by the
    statistics of the batch over the nodes ``mask`` marks valid (all of them
    when None): the mean and the biased variance around it for scalars, the
    mean component power for l > 0; and moves the running statistics toward
    them by ``momentum``.  With ``use_batch_stats`` set (see
    :func:`batch_statistics`) eval mode normalizes by the batch's statistics
    too and leaves the running ones as they are, unless ``update_running``
    is set as well: then it moves them as training mode does.  With a
    ``shard`` (see :func:`data_parallel`) the batch's statistics are those of
    the global batch: the sums and the count are summed over the ranks, the
    variance is taken around the global mean, and the gradient flows back
    through the sums to every rank's rows.
    """

    def __init__(self, irreps: str, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.irreps = parse(irreps)
        self.eps = eps
        self.momentum = momentum
        num_scalar_ch = sum(mul for mul, ir in self.irreps if ir.l == 0)
        num_ch = sum(mul for mul, _ in self.irreps)
        self.weight = nn.Parameter(torch.ones(num_ch))
        self.bias = nn.Parameter(torch.zeros(num_scalar_ch))
        self.register_buffer("mean", torch.zeros(num_scalar_ch))
        self.register_buffer("var", torch.ones(num_ch))
        self.use_batch_stats = False
        self.update_running = False
        self.shard = None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch_stats = self.training or self.use_batch_stats
        if batch_stats:
            m = (torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) if mask is None
                 else mask.to(x.dtype))
            total = (lambda v: v) if self.shard is None else self.shard.sum
            denom = torch.clamp(total(m.sum()), min=1.0)
            node_axes = tuple(range(m.dim()))

            def masked_mean(v):                       # (..., mul) -> (mul,)
                return total((v * m[..., None]).sum(dim=node_axes)) / denom

        outs, new_means, new_vars = [], [], []
        ch_off, sc_off = 0, 0
        for (mul, ir), sl in zip(self.irreps, self.irreps.slices()):
            field = x[..., sl].reshape(x.shape[:-1] + (mul, ir.dim))
            w = self.weight[ch_off:ch_off + mul]
            if ir.l == 0:
                if batch_stats:
                    mean = masked_mean(field[..., 0])
                    new_means.append(mean)
                else:
                    mean = self.mean[sc_off:sc_off + mul]
                centered = field[..., 0] - mean
                if batch_stats:
                    var = masked_mean(centered ** 2)
                    new_vars.append(var)
                else:
                    var = self.var[ch_off:ch_off + mul]
                out = centered * torch.rsqrt(var + self.eps) * w + self.bias[sc_off:sc_off + mul]
                outs.append(out)
                sc_off += mul
            else:
                if batch_stats:
                    var = masked_mean((field ** 2).mean(dim=-1))
                    new_vars.append(var)
                else:
                    var = self.var[ch_off:ch_off + mul]
                out = field * (torch.rsqrt(var + self.eps) * w)[..., None]
                outs.append(out.reshape(out.shape[:-2] + (-1,)))
            ch_off += mul
        if self.update_running if self.use_batch_stats else self.training:
            with torch.no_grad():   # the running statistics are updated in place
                if new_means:
                    self.mean.mul_(1 - self.momentum).add_(self.momentum * torch.cat(new_means))
                self.var.mul_(1 - self.momentum).add_(self.momentum * torch.cat(new_vars))
        return torch.cat(outs, dim=-1)


@contextlib.contextmanager
def batch_statistics(model: nn.Module, update: bool = False) -> Iterator[nn.Module]:
    """Within the block, every batch norm of ``model`` normalizes by the
    statistics of the batch it is given, whatever the mode, and leaves its
    running statistics untouched, or with ``update`` moves them toward the
    batch's by its momentum (the JAX package's ``use_running_average=False``
    with ``mutable=["batch_stats"]``); in eval mode dropout stays off and
    the convolutions keep their eval route (K1)."""
    norms = [m for m in model.modules() if isinstance(m, EquivariantBatchNorm)]
    for m in norms:
        m.use_batch_stats = True
        m.update_running = update
    try:
        yield model
    finally:
        for m in norms:
            m.use_batch_stats = False
            m.update_running = False


@contextlib.contextmanager
def data_parallel(model: nn.Module, shard) -> Iterator[nn.Module]:
    """Within the block, the batch norms and dropouts of ``model`` compute as
    rank ``shard.rank`` of a data-parallel step (a
    ``parallel.mesh.DataShard``): batch statistics of the global batch,
    dropout masks drawn for it.  ``shard`` None changes nothing."""
    mods = [m for m in model.modules() if isinstance(m, (EquivariantBatchNorm, Dropout))]
    for m in mods:
        m.shard = shard
    try:
        yield model
    finally:
        for m in mods:
            m.shard = None


def set_compute_dtype(model: nn.Module, compute_dtype: str) -> None:
    """Every ``DenseTPConv`` of ``model`` computes in ``compute_dtype``
    ("float32" or "bfloat16") from now on."""
    dtype = getattr(torch, compute_dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")
    for m in model.modules():
        if isinstance(m, DenseTPConv):
            m.compute_dtype = dtype


class DenseTPConv(nn.Module):
    """Tensor-product message passing over a dense (receiver, sender) grid
    with a masked mean over senders; ``tp_mode`` "channelwise" (the shipped
    configs) or "fully_connected".

    Eval mode: the edge MLP and the sum over senders are one call of K1
    (:func:`diffphore_torch.ops.tp_fused.tp_aggregate_fused`), which has no
    dropout and no backward.  Training mode: the edge MLP runs in PyTorch
    (relu - dropout between its layers, under autograd) and the sum over
    senders is K2 (:func:`diffphore_torch.ops.tp_aggregate.tp_aggregate`),
    whose backward is a kernel too; a convolution whose paths all have
    l_in = 0 (the layer-0 convolutions, scalars in) runs K3 instead
    (:func:`diffphore_torch.ops.tp_scalar.scalar_paths_aggregate`).
    Each is the CUDA kernel for CUDA tensors and its plain version for CPU
    tensors.  Setting
    ``use_kernel = False`` runs the plain versions on any device (a
    comparison run; the main paths leave it on).  Several edge channels
    between the same pairs (ligand bond and radius edges) share the
    harmonics and pass lists of attrs and masks; the masked mean counts
    every channel's edges.  ``receiver_mask`` marks the receivers that enter
    the batch norm's training statistics.

    ``compute_dtype`` rounds as the JAX package's convolution does (its
    default, unfused path): with ``"bfloat16"`` the edge MLP runs in bf16
    (parameters, products, biases, relu, dropout and the masked sum over
    edge channels), the sender features and harmonics are read in bf16, and
    the aggregate multiplies them with bf16-rounded coupling tensors and sums
    in f32; everything from the sum over senders on is f32.  With
    ``"float32"`` (or None) all arithmetic is f32.  Parameters stay f32.

    ``tp_mode="fully_connected"``: the edge MLP is a submodule ``fc`` (the
    JAX package's name) that gives each edge a weight per (input channel,
    output channel) pair of every path, in the compute dtype as above, and
    :meth:`FullyConnectedTP.aggregate` sums the product over senders in
    plain PyTorch on any device, in eval and training mode alike: no kernel
    runs, in the JAX package or here, and there is no mix.

    ``sender_index`` (B, N, K) int32: the sender-index grid of the KNN phore
    graph (``phore_knn``).  The edge tensors are (B, N, K, ...), slot k of
    receiver n reads the sender row ``sender_feat[b, sender_index[b, n,
    k]]`` and ``sender_feat`` stays (B, M, D); K1, K2 and K3 run their
    sender-index mode (the JAX package gathers the senders and takes its
    einsum path), and the fully connected product gathers x.
    """

    def __init__(self, in_irreps: str, out_irreps: str, sh_irreps: str = "1x0e + 1x1o + 1x2e",
                 n_edge_features: int = 48, hidden_features: Optional[int] = None,
                 batch_norm: bool = True, dropout: float = 0.0,
                 compute_dtype: Optional[str] = None, tp_mode: str = "channelwise"):
        super().__init__()
        self.compute_dtype = getattr(torch, compute_dtype or "float32")
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")
        if tp_mode not in ("channelwise", "fully_connected"):
            raise ValueError(f"tp_mode {tp_mode!r}: channelwise or fully_connected")
        self.channelwise = tp_mode == "channelwise"
        hidden = hidden_features or n_edge_features
        if self.channelwise:
            self.tp = channelwise_tp(in_irreps, sh_irreps, out_irreps)
            F = self.tp.weight_numel
            self.fc_w1 = nn.Parameter(torch.zeros(n_edge_features, hidden))
            self.fc_b1 = nn.Parameter(torch.zeros(hidden))
            self.fc_w2 = nn.Parameter(torch.zeros(hidden, F))
            self.fc_b2 = nn.Parameter(torch.zeros(F))
            for k, fan_in, mul_out in self.tp.mix_specs:
                if any(p.i_out == k for p in self.tp.paths):
                    setattr(self, f"mix_{k}", nn.Parameter(torch.zeros(fan_in, mul_out)))
            self.drop = Dropout(dropout)
        else:
            self.tp = fully_connected_tp(in_irreps, sh_irreps, out_irreps)
            self.fc = MLP(n_edge_features, hidden, self.tp.weight_numel, dropout=dropout)
        self.bn = EquivariantBatchNorm(out_irreps) if batch_norm else None
        self.use_kernel = True

    def forward(
        self,
        sender_feat: torch.Tensor,                                   # (B, M, dim_in)
        edge_attr: Union[torch.Tensor, List[torch.Tensor]],          # (B, N, M, E) or C of them
        edge_sh: torch.Tensor,                                       # (B, N, M, sh_dim)
        edge_mask: Union[torch.Tensor, List[torch.Tensor]],          # (B, N, M) or C of them
        receiver_mask: Optional[torch.Tensor] = None,                # (B, N)
        sender_index: Optional[torch.Tensor] = None,                 # (B, N, M) int32
    ) -> torch.Tensor:
        tp = self.tp
        attrs = edge_attr if isinstance(edge_attr, (list, tuple)) else [edge_attr]
        masks = edge_mask if isinstance(edge_mask, (list, tuple)) else [edge_mask]
        f32 = torch.float32
        counts = 0.0
        for m in masks:
            counts = counts + m.to(f32).sum(dim=-1)
        denom = torch.clamp(counts, min=1.0)                         # (B, N)

        cdt = self.compute_dtype
        x, sh = sender_feat.to(cdt).contiguous(), edge_sh.to(cdt).contiguous()
        # the dense grid calls the aggregates as it always has
        index = {} if sender_index is None else {"sender_index": sender_index}
        if not self.channelwise:
            # Peak bytes at the widest call, a cross-graph conv of the last
            # layer in a 40-pose dispatch at 24 x 96 (92,160 edges, 2,200
            # weights each): the (B, N, M, F) weights, 0.41 GB in bf16, up to
            # three times while the edge MLP's output is biased and masked,
            # plus one path's f32 slice of them (0.15 GB) and its f32 product
            # of harmonics and senders (22 MB).  At f32 the sum over senders
            # folds into a matmul; at bf16 the messages the JAX package rounds
            # per edge exist, 18 MB in bf16 for all paths.
            fc = self.fc
            w = tp_fused.edge_weights(attrs, masks, fc.Dense_0.weight.t(), fc.Dense_0.bias,
                                      fc.Dense_1.weight.t(), fc.Dense_1.bias, cdt, fc.drop)
            out = self.tp.aggregate(x, sh, w, **index) / denom[..., None]
            return out if self.bn is None else self.bn(out, receiver_mask)
        if self.training:
            w = tp_fused.edge_weights(attrs, masks, self.fc_w1, self.fc_b1, self.fc_w2,
                                      self.fc_b2, cdt, self.drop)
            if tp_scalar.all_scalar_paths(tp):
                aggregate = (tp_scalar.scalar_paths_aggregate if self.use_kernel
                             else tp_scalar.scalar_paths_aggregate_plain)
            else:
                aggregate = (tp_aggregate.tp_aggregate if self.use_kernel
                             else tp_aggregate.tp_aggregate_plain)
            padded = aggregate(tp, x, sh, w.contiguous(), **index)
        else:
            aggregate = (tp_fused.tp_aggregate_fused if self.use_kernel
                         else tp_fused.tp_aggregate_fused_plain)
            padded = aggregate(
                tp, x, sh, [a.to(cdt).contiguous() for a in attrs],
                [m.contiguous() for m in masks],
                self.fc_w1, self.fc_b1, self.fc_w2, self.fc_b2, **index)
        blocks = tp_fused.blocks_from_padded(tp, padded)

        B, N = padded.shape[:2]
        parts = []
        for (k, _, _), block in zip(tp.mix_specs, blocks):
            mul, ir = tp.irreps_out.items[k]
            if block is None:
                parts.append(torch.zeros((B, N, mul * ir.dim), dtype=f32, device=padded.device))
                continue
            agg = block / denom[..., None, None]
            mixed = torch.einsum("...fd,fv->...vd", agg, getattr(self, f"mix_{k}"))
            parts.append(mixed.reshape(mixed.shape[:-2] + (mul * ir.dim,)))
        out = torch.cat(parts, dim=-1)
        if self.bn is not None:
            out = self.bn(out, receiver_mask)
        return out
