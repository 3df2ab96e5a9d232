"""K3: the scalar-path (l_in = 0) tensor-product aggregate, with its backward.

The port of ``diffphore_tpu/ops/pallas/tp_scalar.py::scalar_path_aggregate``
(the TPU kernel) as CUDA kernels for Hopper, ``csrc/tp_scalar.cu``:

    out[b,n,u,k] = sum_m x[b,m,u] * sh[b,n,m,k] * w[b,n,m,u]

For a path with l_in = 0 the coupling tensor times the path's normalization
is the identity (``wigner_3j(0, l, l)[0] = I / sqrt(2l+1)``, alpha =
``sqrt(2l+1)``), so this is the whole of the path's block in
``ChannelwiseTP.aggregate``.  The layer-0 convolutions of the score model
(``ns x 0e`` in) have only such paths; their training branch runs one launch
per path (:func:`scalar_paths_aggregate`), the other convolutions stay on K2.

:func:`scalar_path_aggregate` launches the kernels for CUDA tensors, forward
and, under autograd, backward (``dw``, ``dsh`` and ``dx``, one kernel each),
and runs :func:`scalar_path_aggregate_plain`, the einsum under autograd, for
CPU tensors.  Operands may be last-axis slices of larger tensors
(``sh[..., 1:4]``, ``w[..., 20:40]``): the kernels take strides, nothing is
copied.  ``FWD``, ``BWD_W``, ``BWD_SH`` and ``BWD_X`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from . import build
from .tensor_product import ChannelwiseTP
from .tp_fused import K_PAD, _check_tp, _Kernel
from .wigner import wigner_3j

FWD = _Kernel()      # tp_scalar_fwd_kernel
BWD_W = _Kernel()    # tp_scalar_bwd_w_kernel (dw)
BWD_SH = _Kernel()   # tp_scalar_bwd_sh_kernel (dsh, when the harmonics need it)
BWD_X = _Kernel()    # tp_scalar_bwd_x_kernel (dx)

K_MAX = 9            # harmonic components of one path the kernels take
U_MAX = 64           # channels of one path the kernels take


def scalar_path_aggregate_plain(x: torch.Tensor, sh: torch.Tensor,
                                w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch -> (B, N, U, K) f32.
    Differentiable by autograd in x, sh and w."""
    f32 = torch.float32
    return torch.einsum("bmu,bnmk,bnmu->bnuk", x.to(f32), sh.to(f32), w.to(f32))


@functools.lru_cache(maxsize=None)
def all_scalar_paths(tp: ChannelwiseTP) -> bool:
    """True when every path of ``tp`` has l_in = 0 (and its scaled coupling
    tensor is the identity, which the wigner tables make it): then the
    aggregate is K3's function path by path."""
    for p in tp.paths:
        if p.l_in != 0:
            return False
        if not np.allclose(p.alpha * wigner_3j(0, p.l_sh, p.l_out)[0], np.eye(2 * p.l_sh + 1),
                           atol=1e-6):
            return False
    return bool(tp.paths)


def path_views(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor):
    """Per path, in launch order, the (x, sh, w) last-axis slices of a
    convolution's full tensors that its K3 call reads."""
    in_slices, sh_slices = tp.irreps_in.slices(), tp.irreps_sh.slices()
    return [(x[..., in_slices[p.i_in]], sh[..., sh_slices[p.i_sh]],
             w[..., p.w_slice[0]:p.w_slice[1]]) for p in tp.paths]


def _check_paths(tp: ChannelwiseTP) -> None:
    _check_tp(tp)
    if not all_scalar_paths(tp):
        raise ValueError("scalar_paths_aggregate: every path must have l_in = 0")


def scalar_paths_aggregate_plain(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    """:func:`scalar_paths_aggregate` in plain PyTorch: the einsum of every
    path, packed into (B, N, F, 4)."""
    _check_paths(tp)
    pieces = []
    for xv, shv, wv in path_views(tp, x, sh, w):          # channel order = path order
        part = scalar_path_aggregate_plain(xv, shv, wv)
        pieces.append(Fn.pad(part, (0, K_PAD - part.shape[-1])))
    return torch.cat(pieces, dim=-2)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("tp_scalar")
    p, i = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.dp_tp_scalar_fwd.argtypes = [p] * 4 + [strides] + [i] * 5 + [p]
    lib.dp_tp_scalar_bwd_w.argtypes = [p] * 4 + [strides] + [i] * 5 + [p]
    lib.dp_tp_scalar_bwd_sh.argtypes = [p] * 4 + [strides] + [i] * 6 + [p]
    lib.dp_tp_scalar_bwd_x.argtypes = [p] * 4 + [strides] + [i] * 6 + [p]
    for fn in (lib.dp_tp_scalar_fwd, lib.dp_tp_scalar_bwd_w, lib.dp_tp_scalar_bwd_sh,
               lib.dp_tp_scalar_bwd_x):
        fn.restype = i
    lib.dp_cuda_error_string.argtypes = [i]
    lib.dp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_library().dp_cuda_error_string(rc).decode()}")


def _check_views(**views: Tuple[torch.Tensor, Tuple[int, ...]]) -> None:
    """Each (tensor, expected shape): f32, on one CUDA device, of that shape,
    with a unit last stride and no negative stride."""
    device = next(iter(views.values()))[0].device
    for name, (t, shape) in views.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"tp_scalar: {name} on {t.device}; all tensors must be on one "
                             f"CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"tp_scalar: {name} must be f32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"tp_scalar: {name} {tuple(t.shape)}, expected {shape}")
        if (t.shape[-1] > 1 and t.stride(-1) != 1) or any(s < 0 for s in t.stride()):
            raise ValueError(f"tp_scalar: {name} must have a unit last stride (a last-axis "
                             f"slice of a contiguous tensor), got strides {t.stride()}")


def _shapes(x: torch.Tensor, sh: torch.Tensor) -> Tuple[int, int, int, int, int]:
    if sh.dim() != 4 or x.dim() != 3:
        raise ValueError(f"tp_scalar: x must be (B, M, U) and sh (B, N, M, K), got "
                         f"{tuple(x.shape)} and {tuple(sh.shape)}")
    B, N, M, K = sh.shape
    U = x.shape[-1]
    if not (1 <= K <= K_MAX and 1 <= U <= U_MAX):
        raise ValueError(f"tp_scalar: K = {K} (1..{K_MAX}) or U = {U} (1..{U_MAX}) outside "
                         f"what the kernels take")
    return B, N, M, U, K


def _strides(*tensors: torch.Tensor):
    """The element strides of the views without their last axis, in order."""
    flat = [s for t in tensors for s in t.stride()[:-1]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_forward(x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel on CUDA views; writes ``out`` (a (B, N, U, K) view,
    made contiguous when not given) and returns it."""
    B, N, M, U, K = _shapes(x, sh)
    if out is None:
        out = torch.empty((B, N, U, K), dtype=torch.float32, device=x.device)
    _check_views(x=(x, (B, M, U)), sh=(sh, (B, N, M, K)), w=(w, (B, N, M, U)),
                 out=(out, (B, N, U, K)))
    rc = _library().dp_tp_scalar_fwd(
        x.data_ptr(), sh.data_ptr(), w.data_ptr(), out.data_ptr(), _strides(x, sh, w, out),
        B, N, M, U, K, _stream(x.device))
    _raise_on(rc, "tp_scalar_fwd")
    FWD.launches += 1
    return out


def launch_backward_w(x: torch.Tensor, sh: torch.Tensor, g: torch.Tensor,
                      dw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dw into the (B, N, M, U) view ``dw`` (every element written)."""
    B, N, M, U, K = _shapes(x, sh)
    if dw is None:
        dw = torch.empty((B, N, M, U), dtype=torch.float32, device=x.device)
    _check_views(x=(x, (B, M, U)), sh=(sh, (B, N, M, K)), grad=(g, (B, N, U, K)),
                 dw=(dw, (B, N, M, U)))
    rc = _library().dp_tp_scalar_bwd_w(
        x.data_ptr(), sh.data_ptr(), g.data_ptr(), dw.data_ptr(), _strides(x, sh, g, dw),
        B, N, M, U, K, _stream(x.device))
    _raise_on(rc, "tp_scalar_bwd_w")
    BWD_W.launches += 1
    return dw


def launch_backward_sh(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       dsh: Optional[torch.Tensor] = None,
                       accumulate: bool = False) -> torch.Tensor:
    """dsh into the (B, N, M, K) view ``dsh``: written, or added to what it
    holds with ``accumulate``."""
    B, N, U, K = g.shape
    M = x.shape[1]
    if dsh is None:
        dsh = torch.empty((B, N, M, K), dtype=torch.float32, device=x.device)
    _shapes(x, dsh)
    _check_views(x=(x, (B, M, U)), w=(w, (B, N, M, U)), grad=(g, (B, N, U, K)),
                 dsh=(dsh, (B, N, M, K)))
    rc = _library().dp_tp_scalar_bwd_sh(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dsh.data_ptr(), _strides(x, w, g, dsh),
        B, N, M, U, K, int(accumulate), _stream(x.device))
    _raise_on(rc, "tp_scalar_bwd_sh")
    BWD_SH.launches += 1
    return dsh


def launch_backward_x(sh: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                      dx: Optional[torch.Tensor] = None,
                      accumulate: bool = False) -> torch.Tensor:
    """dx into the (B, M, U) view ``dx``: written, or added to what it holds
    with ``accumulate``."""
    B, N, M, K = sh.shape
    U = w.shape[-1]
    if dx is None:
        dx = torch.empty((B, M, U), dtype=torch.float32, device=sh.device)
    _shapes(dx, sh)
    _check_views(sh=(sh, (B, N, M, K)), w=(w, (B, N, M, U)), grad=(g, (B, N, U, K)),
                 dx=(dx, (B, M, U)))
    rc = _library().dp_tp_scalar_bwd_x(
        sh.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(), _strides(sh, w, g, dx),
        B, N, M, U, K, int(accumulate), _stream(sh.device))
    _raise_on(rc, "tp_scalar_bwd_x")
    BWD_X.launches += 1
    return dx


class ScalarPathAggregate(torch.autograd.Function):
    """One path under autograd.  ``dsh`` is computed only when sh requires
    grad, ``dx`` only when x does, ``dw`` only when w does."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor):
        ctx.save_for_backward(x, sh, w)
        return launch_forward(x, sh, w)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        x, sh, w = ctx.saved_tensors
        need_dx, need_dsh, need_dw = ctx.needs_input_grad
        g = grad_out.to(torch.float32).contiguous()
        return (launch_backward_x(sh, w, g) if need_dx else None,
                launch_backward_sh(x, w, g) if need_dsh else None,
                launch_backward_w(x, sh, g) if need_dw else None)


def scalar_path_aggregate(x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_m x * sh * w -> (B, N, U, K) f32, differentiable in x, sh, w.

    x (B, M, U); sh (B, N, M, K), K <= 9; w (B, N, M, U) pre-masked, U <= 64;
    all f32 with a unit last stride.  CPU tensors take the plain version;
    CUDA tensors launch the kernels or raise.
    """
    if x.device.type == "cpu" and sh.device.type == "cpu" and w.device.type == "cpu":
        return scalar_path_aggregate_plain(x, sh, w)
    return ScalarPathAggregate.apply(x, sh, w)


class ScalarPathsAggregate(torch.autograd.Function):
    """Every path of an all-l_in-0 convolution under autograd, on the
    convolution's full tensors: each path's kernels read slices of x, sh and
    w and write slices of the packed output and of the full gradients, so no
    slice is copied and no gradient is padded and summed afterwards."""

    @staticmethod
    def forward(ctx, tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor, w: torch.Tensor):
        ctx.tp = tp
        ctx.save_for_backward(x, sh, w)
        B, N = sh.shape[:2]
        out = torch.zeros((B, N, tp.weight_numel, K_PAD), dtype=torch.float32, device=x.device)
        for p, (xv, shv, wv) in zip(tp.paths, path_views(tp, x, sh, w)):
            launch_forward(xv, shv, wv, out[:, :, p.w_slice[0]:p.w_slice[1], :shv.shape[-1]])
        return out

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        tp = ctx.tp
        x, sh, w = ctx.saved_tensors
        _, need_dx, need_dsh, need_dw = ctx.needs_input_grad
        g = grad_out.to(torch.float32).contiguous()
        # every channel of w belongs to one path, so dw is written whole; sh
        # and x may hold components no path reads, and two paths may share one
        dw = torch.empty_like(w) if need_dw else None
        dsh = torch.zeros_like(sh) if need_dsh else None
        dx = torch.zeros_like(x) if need_dx else None
        seen_sh, seen_x = set(), set()
        views = path_views(tp, x, sh, w)
        grads = path_views(tp, dx if need_dx else x, dsh if need_dsh else sh,
                            dw if need_dw else w)
        for p, (xv, shv, wv), (dxv, dshv, dwv) in zip(tp.paths, views, grads):
            gv = g[:, :, p.w_slice[0]:p.w_slice[1], :shv.shape[-1]]
            if need_dw:
                launch_backward_w(xv, shv, gv, dwv)
            if need_dsh:
                launch_backward_sh(xv, wv, gv, dshv, accumulate=p.i_sh in seen_sh)
                seen_sh.add(p.i_sh)
            if need_dx:
                launch_backward_x(shv, wv, gv, dxv, accumulate=p.i_in in seen_x)
                seen_x.add(p.i_in)
        return None, dx, dsh, dw


def scalar_paths_aggregate(tp: ChannelwiseTP, x: torch.Tensor, sh: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """The aggregate of a convolution whose paths all have l_in = 0, one K3
    launch per path -> (B, N, F, 4) f32 in the layout
    :func:`tp_fused.blocks_from_padded` reads; differentiable in x, sh, w.

    x (B, M, D_in); sh (B, N, M, S); w (B, N, M, F) pre-masked; all f32 and
    contiguous.  CPU tensors take the plain version; CUDA tensors launch the
    kernels or raise.
    """
    _check_paths(tp)
    if x.device.type == "cpu" and sh.device.type == "cpu" and w.device.type == "cpu":
        return scalar_paths_aggregate_plain(tp, x, sh, w)
    B, N, M, _ = sh.shape
    expected = {"x": (x, (B, M, tp.irreps_in.dim)), "sh": (sh, (B, N, M, tp.irreps_sh.dim)),
                "w": (w, (B, N, M, tp.weight_numel))}
    _check_views(**expected)
    for name, (t, _) in expected.items():
        if not t.is_contiguous():
            raise ValueError(f"tp_scalar: {name} must be contiguous")
    return ScalarPathsAggregate.apply(tp, x, sh, w)
