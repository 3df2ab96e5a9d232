"""Weighted tensor products of irreps features, channelwise and fully
connected.

The path tables are static numpy/Python metadata, identical to the JAX
package's; the contractions are torch.  A channelwise ("uvu") product has
one edge weight per input channel per path and a static per-irrep linear
mix to the output multiplicities, applied after the sum over senders; each
path is scaled by sqrt(2*l_out + 1) (component normalization) and the
1/sqrt(fan_in) factor lives in the mix weights.  A fully connected ("uvw")
product has a weight per (input channel, output channel) pair per path and
scales each path by sqrt(2*l_out + 1) / sqrt(fan_in), fan_in the input
channels of all paths into the same output irrep.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch

from .irreps import Irrep, Irreps, parse
from .wigner import wigner_3j


@dataclasses.dataclass(frozen=True)
class _Path:
    i_in: int
    i_sh: int
    i_out: int
    mul_in: int
    mul_out: int
    l_in: int
    l_sh: int
    l_out: int
    w_slice: Tuple[int, int]  # [start, stop) into the flat weight vector
    alpha: float


def gather_senders(x: torch.Tensor, sender_index: torch.Tensor) -> torch.Tensor:
    """Per-receiver senders of a sender-index grid: ``x[b, sender_index[b,
    n, k]]`` -> (B, N, K, ...) from x (B, M, ...) and an integer index (B,
    N, K).  Differentiable in x: its gradient adds each slot's into its
    sender."""
    bidx = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[bidx, sender_index.long()]


def _cg(l1: int, l2: int, l3: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(wigner_3j(l1, l2, l3), dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class FullyConnectedTP:
    """Static path table of a fully connected tensor product; harmonics of
    multiplicity 1."""

    irreps_in: Irreps
    irreps_sh: Irreps
    irreps_out: Irreps
    paths: Tuple[_Path, ...]
    weight_numel: int

    def aggregate(self, x: torch.Tensor, sh: torch.Tensor, weights: torch.Tensor,
                  sender_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The tensor product of each edge summed over senders:

            out[b, n, v, k] = sum_m sum_p alpha_p sum_{u, i, j}
                x[b, m, u, i] sh[b, n, m, j] C_p[i, j, k] w[b, n, m, u, v]

        Args:
          x: (B, M, dim_in) sender features, or (B, N, M, dim_in) senders
            gathered per receiver (the sender-index grid: m is receiver n's
            slot); ``sender_index`` (B, N, M) gathers them from (B, M_x,
            dim_in).
          sh: (B, N, M, sh_dim); weights: (B, N, M, weight_numel), pre-masked.
        Returns:
          (B, N, irreps_out.dim) f32; irreps no path feeds are zero.

        Per path the harmonics meet the sender features first, (B, N, M, u,
        2 l_out + 1) in f32.  f32 operands: one batched matmul per receiver
        contracts that with the weights over (sender, input channel), so the
        sum over senders folds into the matmul and no per-edge message
        exists.  bf16 operands (the coupling tensors rounded to bf16 too):
        the JAX package's bf16 product rounds each path's message of each
        edge to bf16, multiplies it by alpha in bf16 and sums the paths in
        bf16 before the f32 sum over senders, so the messages are formed per
        edge (a matmul per edge over the input channels) and rounded there;
        they cannot be folded without changing the result.
        """
        cg_dtype = x.dtype
        per_edge = x.dtype == torch.bfloat16
        x, sh = x.float(), sh.float()
        if sender_index is not None:
            x = gather_senders(x, sender_index)      # in f32: slots' gradients add in f32
        m = "bnm" if x.dim() == sh.dim() else "bm"
        B, N, M = sh.shape[:3]
        in_slices, sh_slices = self.irreps_in.slices(), self.irreps_sh.slices()
        blocks: List[Optional[torch.Tensor]] = [None] * len(self.irreps_out)
        for p in self.paths:
            d3 = 2 * p.l_out + 1
            xb = x[..., in_slices[p.i_in]]
            xb = xb.reshape(xb.shape[:-1] + (p.mul_in, 2 * p.l_in + 1))
            cg = torch.as_tensor(wigner_3j(p.l_in, p.l_sh, p.l_out), dtype=cg_dtype,
                                 device=x.device).float()
            z = torch.einsum(f"{m}ui,ijk->{m}ujk", xb, cg)
            wb = weights[..., p.w_slice[0]:p.w_slice[1]].float()
            if per_edge:
                y = torch.einsum(f"bnmj,{m}ujk->bnmku", sh[..., sh_slices[p.i_sh]], z)
                msg = torch.bmm(y.reshape(B * N * M, d3, p.mul_in),
                                wb.reshape(B * N * M, p.mul_in, p.mul_out))
                alpha = torch.tensor(p.alpha, dtype=torch.bfloat16, device=x.device)
                contrib = (msg.to(torch.bfloat16) * alpha).reshape(B, N, M, d3, p.mul_out)
            else:
                y = torch.einsum(f"bnmj,{m}ujk->bnkmu", sh[..., sh_slices[p.i_sh]], z)
                msg = torch.bmm(y.reshape(B * N, d3, M * p.mul_in),
                                wb.reshape(B * N, M * p.mul_in, p.mul_out))
                contrib = p.alpha * msg.reshape(B, N, d3, p.mul_out)
            prev = blocks[p.i_out]
            blocks[p.i_out] = contrib if prev is None else prev + contrib
        parts = []
        for k, (mul, ir) in enumerate(self.irreps_out):
            block = blocks[k]
            if block is None:
                parts.append(torch.zeros((B, N, mul * ir.dim), dtype=torch.float32,
                                         device=x.device))
                continue
            if per_edge:
                block = block.float().sum(dim=2)                       # over senders
            parts.append(block.transpose(-1, -2).reshape(B, N, mul * ir.dim))
        return torch.cat(parts, dim=-1)


def _raw_paths(irr_in: Irreps, irr_sh: Irreps, irr_out: Irreps):
    """Every (in, sh, out) irrep triple the selection rule allows, in the JAX
    package's order, and the input channels into each output irrep."""
    raw_paths: List[List] = []
    fan_in = [0] * len(irr_out)
    for i, (mul_in, ir_in) in enumerate(irr_in):
        for j, (mul_sh, ir_sh) in enumerate(irr_sh):
            if mul_sh != 1:
                raise ValueError("sh inputs must be multiplicity-1")
            for k, (mul_out, ir_out) in enumerate(irr_out):
                if ir_out in ir_in * ir_sh:
                    raw_paths.append([i, j, k, mul_in, mul_out, ir_in.l, ir_sh.l, ir_out.l])
                    fan_in[k] += mul_in
    return raw_paths, fan_in


@functools.lru_cache(maxsize=None)
def fully_connected_tp(irreps_in: str, irreps_sh: str, irreps_out: str) -> FullyConnectedTP:
    """Build (and cache) the fully connected path table."""
    irr_in, irr_sh, irr_out = parse(str(irreps_in)), parse(str(irreps_sh)), parse(str(irreps_out))
    raw_paths, fan_in = _raw_paths(irr_in, irr_sh, irr_out)
    paths: List[_Path] = []
    offset = 0
    for i, j, k, mul_in, mul_out, l_in, l_sh, l_out in raw_paths:
        n = mul_in * mul_out
        alpha = math.sqrt(2 * l_out + 1) / math.sqrt(max(fan_in[k], 1))
        paths.append(_Path(i, j, k, mul_in, mul_out, l_in, l_sh, l_out,
                           (offset, offset + n), alpha))
        offset += n
    return FullyConnectedTP(irr_in, irr_sh, irr_out, tuple(paths), offset)


@dataclasses.dataclass(frozen=True)
class ChannelwiseTP:
    irreps_in: Irreps
    irreps_sh: Irreps
    irreps_out: Irreps
    paths: Tuple[_Path, ...]
    weight_numel: int
    #: per output irrep block: (block_index, fan_in_channels, mul_out)
    mix_specs: Tuple[Tuple[int, int, int], ...]

    def aggregate(self, x: torch.Tensor, sh: torch.Tensor, weights: torch.Tensor,
                  sender_index: Optional[torch.Tensor] = None) -> List[Optional[torch.Tensor]]:
        """Edge-summed TP, one einsum per path with the sender sum folded in.

        Args:
          x:  (B, M, dim_in) sender features, or (B, N, M, dim_in) senders
              gathered per receiver for the sender-index (KNN) grid, where m
              is receiver n's slot (the JAX package's
              ``"bnmui,bnmj,ijk,bnmu->bnuk"``); ``sender_index`` (B, N, M)
              gathers them from (B, M_x, dim_in).
          sh: (B, N, M, sh_dim);  weights: (B, N, M, weight_numel), pre-masked.
        Returns:
          list aligned with irreps_out of (B, N, fan_in, 2l+1) f32 sums over M
          (None where no path feeds the irrep).

        bf16 operands are read as they are and multiplied and summed in f32,
        with the coupling tensors rounded to bf16 too, as the JAX package's
        einsum with ``preferred_element_type=f32`` does.  Their gradients
        come back in bf16; x's slots' gradients add in f32 and round once,
        as the kernels' (JAX rounds each slot's).
        """
        cg_dtype = x.dtype
        x, sh, weights = x.float(), sh.float(), weights.float()
        if sender_index is not None:
            x = gather_senders(x, sender_index)      # in f32: slots' gradients add in f32
        m = "bnm" if x.dim() == sh.dim() else "bm"
        in_slices = self.irreps_in.slices()
        sh_slices = self.irreps_sh.slices()
        blocks: List[List[torch.Tensor]] = [[] for _ in self.irreps_out.items]
        for p in self.paths:
            xb = x[..., in_slices[p.i_in]]
            xb = xb.reshape(xb.shape[:-1] + (p.mul_in, 2 * p.l_in + 1))
            shb = sh[..., sh_slices[p.i_sh]]
            wb = weights[..., p.w_slice[0]:p.w_slice[1]]
            cg = torch.as_tensor(wigner_3j(p.l_in, p.l_sh, p.l_out), dtype=cg_dtype,
                                 device=xb.device).float()
            z = torch.einsum(f"{m}ui,ijk->{m}ujk", xb, cg)
            contrib = p.alpha * torch.einsum(f"bnmj,bnmu,{m}ujk->bnuk", shb, wb, z)
            blocks[p.i_out].append(contrib)
        return [torch.cat(parts, dim=-2) if parts else None for parts in blocks]


@functools.lru_cache(maxsize=None)
def channelwise_tp(irreps_in: str, irreps_sh: str, irreps_out: str) -> ChannelwiseTP:
    """Build (and cache) the channel-wise path table."""
    irr_in, irr_sh, irr_out = parse(str(irreps_in)), parse(str(irreps_sh)), parse(str(irreps_out))
    raw_paths, fan_in = _raw_paths(irr_in, irr_sh, irr_out)
    paths: List[_Path] = []
    offset = 0
    for i, j, k, mul_in, mul_out, l_in, l_sh, l_out in raw_paths:
        alpha = math.sqrt(2 * l_out + 1)
        paths.append(_Path(i, j, k, mul_in, mul_out, l_in, l_sh, l_out,
                           (offset, offset + mul_in), alpha))
        offset += mul_in
    mix_specs = tuple(
        (k, fan_in[k], mul_out) for k, (mul_out, _) in enumerate(irr_out.items)
    )
    return ChannelwiseTP(irr_in, irr_sh, irr_out, tuple(paths), offset, mix_specs)


@functools.lru_cache(maxsize=None)
def _full_tp_paths(irreps_1: str, irreps_2: str, filter_out: Optional[Tuple[str, ...]]):
    """Path table of an unweighted full tensor product of two
    multiplicity-1 irreps; ``filter_out`` keeps only the listed output
    irreps (the torsion head consumes l <= 1)."""
    irr1, irr2 = parse(str(irreps_1)), parse(str(irreps_2))
    keep = None if filter_out is None else {repr(Irreps.parse(s).items[0][1]) for s in filter_out}
    paths = []
    out_items: List[Tuple[int, Irrep]] = []
    for i, (mul1, ir1) in enumerate(irr1):
        for j, (mul2, ir2) in enumerate(irr2):
            for ir3 in ir1 * ir2:
                if keep is not None and repr(ir3) not in keep:
                    continue
                k = len(out_items)
                out_items.append((mul1 * mul2, ir3))
                paths.append((i, j, k, ir1.l, ir2.l, ir3.l))
    return irr1, irr2, Irreps(tuple(out_items)), tuple(paths)


def full_tensor_product(
    x: torch.Tensor,
    y: torch.Tensor,
    irreps_1: str,
    irreps_2: str,
    filter_out: Optional[Tuple[str, ...]] = None,
) -> Tuple[torch.Tensor, Irreps]:
    """Unweighted tensor product of two multiplicity-1 irreps features."""
    irr1, irr2, irr_out, paths = _full_tp_paths(str(irreps_1), str(irreps_2), filter_out)
    s1, s2 = irr1.slices(), irr2.slices()
    parts = []
    for i, j, k, l1, l2, l3 in paths:
        xb, yb = x[..., s1[i]], y[..., s2[j]]
        parts.append(math.sqrt(2 * l3 + 1)
                     * torch.einsum("...i,...j,ijk->...k", xb, yb, _cg(l1, l2, l3, xb)))
    return torch.cat(parts, dim=-1), irr_out
