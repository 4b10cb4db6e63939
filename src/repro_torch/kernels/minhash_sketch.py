"""Batched multiset min-hash sketches: hand-written CUDA kernel + plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/minhash_sketch.py:_minhash_kernel``
(launched by ``minhash_sketch``).  For B padded token streams and K seeds,
``out[b, k]`` is the minimum over the positions n with ``tokens[b, n] >=
0`` of ``hash32(seeds[k], tokens[b, n], occ[b, n])`` (the 32-bit family of
:mod:`repro_torch.kernels.common`); a stream with no valid position gets
``0xFFFFFFFF``.

What bounds it on the H100: integer operations, ~23 per (text, seed,
position) against 8 bytes read per position.  The kernel
(``csrc/minhash_sketch.cu``) runs one block per (text, tile of 8 seeds),
reads each position once per tile and keeps the 8 running minima in
registers, then reduces them over warps and the block.

Types: tokens and occ int32 (B, N), seeds int64 (K,) holding uint32
values; the sketch is int64 (B, K) holding uint32 values (torch has no
usable uint32 min).  :func:`minhash_sketch` launches the kernel for CUDA
tensors and uses :func:`minhash_sketch_plain` only for CPU tensors.
``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .common import MASK, hash32

#: kernel launches made by :func:`minhash_sketch` (CUDA tensors only)
launches = 0


def _check(tokens, occ, seeds) -> None:
    if tokens.dim() != 2:
        raise ValueError(f"minhash_sketch: tokens must be (B, N), got "
                         f"{tuple(tokens.shape)}")
    want = {"tokens": (tokens, torch.int32, tuple(tokens.shape)),
            "occ": (occ, torch.int32, tuple(tokens.shape)),
            "seeds": (seeds, torch.int64, (seeds.shape[0],))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"minhash_sketch: {name} must be {dtype} of "
                             f"shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != tokens.device:
            raise ValueError(f"minhash_sketch: {name} is on {t.device}, "
                             f"tokens on {tokens.device}")
        if not t.is_contiguous():
            raise ValueError(f"minhash_sketch: {name} must be contiguous")


def minhash_sketch_plain(tokens, occ, seeds) -> torch.Tensor:
    """Plain PyTorch version of :func:`minhash_sketch`: the (B, K, N) hash
    grid, padding set to ``0xFFFFFFFF``, then the minimum over N."""
    B, N = tokens.shape
    K = seeds.shape[0]
    if N == 0:
        return torch.full((B, K), MASK, dtype=torch.int64,
                          device=tokens.device)
    h = hash32(seeds[None, :, None], tokens.long()[:, None, :],
               occ.long()[:, None, :])
    h = torch.where((tokens >= 0)[:, None, :], h, MASK)
    return h.amin(dim=2)


def _lib() -> ctypes.CDLL:
    lib = _build.library("minhash_sketch")
    fn = lib.minhash_sketch_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def minhash_sketch(tokens, occ, seeds) -> torch.Tensor:
    """(B, K) int64 min-hash sketches of B padded token streams.

    tokens int32 (B, N), -1 = padding; occ int32 (B, N), the 1-based
    occurrence index of each token in its stream; seeds int64 (K,) holding
    uint32 values.  CUDA tensors launch the kernel (or raise); CPU tensors
    run :func:`minhash_sketch_plain`.
    """
    global launches
    _check(tokens, occ, seeds)
    dev = tokens.device
    if dev.type == "cpu":
        return minhash_sketch_plain(tokens, occ, seeds)
    if dev.type != "cuda":
        raise ValueError(f"minhash_sketch: unsupported device {dev}")
    (B, N), K = tokens.shape, seeds.shape[0]
    if B == 0 or K == 0:
        return torch.empty((B, K), dtype=torch.int64, device=dev)
    out = torch.empty((B, K), dtype=torch.int64, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.minhash_sketch_launch(
            tokens.data_ptr(), occ.data_ptr(), seeds.data_ptr(), B, N, K,
            out.data_ptr(), stream)
    _build.check(lib, "minhash_sketch", code)
    launches += 1
    return out
