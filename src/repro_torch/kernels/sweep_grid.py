"""Grouped small-group plane sweep (row gather + coverage grid):
hand-written CUDA kernel + plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/sweep_grid.py:_sweep_kernel``
(launched by ``sweep_grid``) together with the row gather
``jnp.take(win_rect, idx)`` of ``repro/core/device_plan.py:
fused_batch_query``.  For G groups of at most 32 collided windows each:
gather the (a, b, c, d) rows from the resident ``win_rect`` by the (G, S)
index grid, normalize slots past ``sizes[g]`` into zero-width rects at the
group's max exclusive bound, count how many rects cover each cell of the
group's compressed boundary grid, and return

* ``hot``  uint8 (G, 2S-1, 2S-1): coverage >= m, zero-width x stripes cold;
* ``xs``/``ys`` int32 (G, 2S): the sorted stripe boundaries

— exactly what ``repro_torch.core.query._extract_runs`` reads.

What bounds it on the H100: per-group latency.  A group is a few KB of
rows and outputs and ~10^4 integer operations, far below both the memory
and the compute roofline, so the kernel (``csrc/sweep_grid.cu``) runs one
block per group with the rects, both boundary vectors and the <= 65 x 65
count grid in shared memory, and builds the grid as a difference array of
shared atomics plus two prefix-sum passes (the TPU used an indicator matmul
because it scatters poorly).

:func:`sweep` launches the kernel for CUDA tensors and uses
:func:`sweep_plain` only for CPU tensors.  ``launches`` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches made by :func:`sweep` (CUDA tensors only)
launches = 0

MAX_S = 32                     # windows per group the kernel takes
_NEG = -(1 << 30)              # max exclusive bound of an all-padded group


def _check(win_rect, idx, sizes, m) -> None:
    if win_rect.dtype != torch.int32 or win_rect.dim() != 2 or \
            win_rect.shape[1] != 4:
        raise ValueError("sweep: win_rect must be int32 (nwin, 4), got "
                         f"{win_rect.dtype} {tuple(win_rect.shape)}")
    if idx.dtype != torch.int64 or idx.dim() != 2 or \
            not 1 <= idx.shape[1] <= MAX_S:
        raise ValueError(f"sweep: idx must be int64 (G, S) with 1 <= S <= "
                         f"{MAX_S}, got {idx.dtype} {tuple(idx.shape)}")
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (idx.shape[0],):
        raise ValueError(f"sweep: sizes must be int32 ({idx.shape[0]},), got "
                         f"{sizes.dtype} {tuple(sizes.shape)}")
    if win_rect.shape[0] == 0:
        raise ValueError("sweep: win_rect is empty")
    if m < 1:
        raise ValueError(f"sweep: m must be >= 1, got {m}")
    for name, t in (("idx", idx), ("sizes", sizes)):
        if t.device != win_rect.device:
            raise ValueError(f"sweep: {name} is on {t.device}, win_rect on "
                             f"{win_rect.device}")
    for name, t in (("win_rect", win_rect), ("idx", idx), ("sizes", sizes)):
        if not t.is_contiguous():
            raise ValueError(f"sweep: {name} must be contiguous")


def sweep_plain(win_rect, idx, sizes, m: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same gather, padding normalization,
    ranks, sort and difference-array coverage, vectorized over groups."""
    G, S = idx.shape
    NX, STR = 2 * S, 2 * S + 1
    slot = torch.arange(S, device=idx.device)
    pad = slot[None, :] >= sizes[:, None].to(torch.int64)       # (G, S)
    rect = win_rect[torch.where(pad, 0, idx)]                   # (G, S, 4)
    a, b1 = rect[..., 0], rect[..., 1] + 1
    c, d1 = rect[..., 2], rect[..., 3] + 1
    bmax = torch.where(pad, _NEG, b1).amax(dim=1, keepdim=True)
    dmax = torch.where(pad, _NEG, d1).amax(dim=1, keepdim=True)
    a, b1 = torch.where(pad, bmax, a), torch.where(pad, bmax, b1)
    c, d1 = torch.where(pad, dmax, c), torch.where(pad, dmax, d1)
    bx = torch.cat([a, b1], dim=1)                              # (G, NX)
    by = torch.cat([c, d1], dim=1)

    def rank(bound, v):             # searchsorted-left: #{bound < v}
        return (bound[:, None, :] < v[:, :, None]).sum(dim=2)

    xa, xb, yc, yd = rank(bx, a), rank(bx, b1), rank(by, c), rank(by, d1)
    xs = torch.sort(bx, dim=1).values
    ys = torch.sort(by, dim=1).values
    w = (~pad).to(torch.int32)
    diff = torch.zeros((G, STR * STR), dtype=torch.int32, device=idx.device)
    diff.scatter_add_(1, xa * STR + yc, w)
    diff.scatter_add_(1, xb * STR + yd, w)
    diff.scatter_add_(1, xa * STR + yd, -w)
    diff.scatter_add_(1, xb * STR + yc, -w)
    count = diff.view(G, STR, STR).cumsum(dim=1).cumsum(dim=2)
    hot = (count[:, :NX - 1, :NX - 1] >= m) & \
        (xs[:, 1:] > xs[:, :-1])[:, :, None]
    return hot.to(torch.uint8), xs, ys


def _lib() -> ctypes.CDLL:
    lib = _build.library("sweep_grid")
    fn = lib.sweep_grid_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def sweep(win_rect, idx, sizes, m: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hot uint8 (G, 2S-1, 2S-1), xs int32 (G, 2S), ys int32 (G, 2S)).

    win_rect int32 (nwin, 4) resident rect rows; idx int64 (G, S) row ids
    (slots past ``sizes[g]`` are ignored); sizes int32 (G,); m >= 1.  CUDA
    tensors launch the kernel (or raise); CPU tensors run
    :func:`sweep_plain`.
    """
    global launches
    _check(win_rect, idx, sizes, m)
    dev = win_rect.device
    if dev.type == "cpu":
        return sweep_plain(win_rect, idx, sizes, m)
    if dev.type != "cuda":
        raise ValueError(f"sweep: unsupported device {dev}")
    G, S = idx.shape
    NX = 2 * S
    hot = torch.empty((G, NX - 1, NX - 1), dtype=torch.uint8, device=dev)
    xs = torch.empty((G, NX), dtype=torch.int32, device=dev)
    ys = torch.empty((G, NX), dtype=torch.int32, device=dev)
    if G == 0:
        return hot, xs, ys
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.sweep_grid_launch(
            win_rect.data_ptr(), idx.data_ptr(), sizes.data_ptr(), G, S,
            int(m), hot.data_ptr(), xs.data_ptr(), ys.data_ptr(), stream)
    _build.check(lib, "sweep_grid", code)
    launches += 1
    return hot, xs, ys
