"""Probe of the fused CSR probe arena: hand-written CUDA kernel + plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/probe_arena.py:_search_kernel``
(launched by ``_arena_search``) together with the hit detect and CSR
lookup that ``repro/core/device_plan.py:_probe_jit_factory`` fused around
it.  For every probe, the leftmost arena slot whose ``(key, tag) >= (probe
key, probe tag)`` — keys ordered as UNSIGNED 64-bit, the tag word as the
tie break (coordinate in "coord" mode, zero in "packed" mode) — and, on an
exact hit, its CSR extent ``(offsets[slot], offsets[slot + 1])``; misses
and invalid probes get ``(0, 0)``.

What bounds it on the H100: memory latency.  A probe is a chain of
``ceil(log2(n + 1))`` dependent 12-byte reads (key + tag) scattered over
the arena, so a batch moves little data; the kernel (``csrc/probe_arena.cu``)
runs one probe per thread so the card keeps thousands of independent
chains in flight, and keys stay whole u64 words (the TPU split them into
u32 halves only for lack of 64-bit lanes).

:func:`arena_probe` launches the kernel for CUDA tensors and uses
:func:`arena_probe_plain` only for CPU tensors.  ``launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches made by :func:`arena_probe` (CUDA tensors only)
launches = 0

_SIGN_BIT = -(1 << 63)      # int64 with only the top bit set


def _check(keys, tags, offsets, qkeys, qtags, valid) -> None:
    n, P = keys.shape[0], qkeys.shape[0]
    want = {"keys": (keys, torch.int64, (n,)),
            "tags": (tags, torch.int32, (n,)),
            "offsets": (offsets, torch.int64, (n + 1,)),
            "qkeys": (qkeys, torch.int64, (P,)),
            "qtags": (qtags, torch.int32, (P,)),
            "valid": (valid, torch.bool, (P,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"arena_probe: {name} must be {dtype} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != keys.device:
            raise ValueError(f"arena_probe: {name} is on {t.device}, keys "
                             f"on {keys.device}")
        if not t.is_contiguous():
            raise ValueError(f"arena_probe: {name} must be contiguous")


def arena_search_plain(keys, tags, qkeys, qtags) -> torch.Tensor:
    """Leftmost slot with ``(key, tag) >= (qkey, qtag)`` per probe, int64:
    the fixed-iteration binary search of the TPU kernel, vectorized over
    probes.  Flipping the sign bit maps unsigned u64 order onto the signed
    int64 order torch compares in."""
    n, P = keys.shape[0], qkeys.shape[0]
    lo = torch.zeros(P, dtype=torch.int64, device=keys.device)
    if n == 0:
        return lo
    kf = keys ^ _SIGN_BIT
    qf = qkeys ^ _SIGN_BIT
    hi = torch.full_like(lo, n)
    for _ in range(n.bit_length()):
        active = lo < hi
        mid = (lo + hi) // 2
        safe = mid.clamp(max=n - 1)
        k, t = kf[safe], tags[safe]
        less = (k < qf) | ((k == qf) & (t < qtags))
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def arena_probe_plain(keys, tags, offsets, qkeys, qtags, valid
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`arena_probe`: the binary search of
    :func:`arena_search_plain`, then the exact-hit test and CSR lookup."""
    n, P = keys.shape[0], qkeys.shape[0]
    zero = torch.zeros(P, dtype=torch.int64, device=keys.device)
    if n == 0 or P == 0:
        return zero, zero.clone()
    pos = arena_search_plain(keys, tags, qkeys, qtags)
    safe = pos.clamp(max=n - 1)
    hit = valid & (pos < n) & (keys[safe] == qkeys) & (tags[safe] == qtags)
    starts = torch.where(hit, offsets[safe], zero)
    ends = torch.where(hit, offsets[safe + 1], zero)
    return starts, ends


def _lib() -> ctypes.CDLL:
    lib = _build.library("probe_arena")
    fn = lib.probe_arena_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def arena_probe(keys, tags, offsets, qkeys, qtags, valid
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(starts, ends) int64 per probe against a resident arena.

    keys int64 (n,) raw u64 bits sorted unsigned, with tags int32 (n,) as
    the tie break; offsets int64 (n + 1,); qkeys int64 (P,), qtags int32
    (P,), valid bool (P,).  CUDA tensors launch the kernel (or raise); CPU
    tensors run :func:`arena_probe_plain`.
    """
    global launches
    _check(keys, tags, offsets, qkeys, qtags, valid)
    dev = keys.device
    if dev.type == "cpu":
        return arena_probe_plain(keys, tags, offsets, qkeys, qtags, valid)
    if dev.type != "cuda":
        raise ValueError(f"arena_probe: unsupported device {dev}")
    n, P = keys.shape[0], qkeys.shape[0]
    if n == 0 or P == 0:
        zero = torch.zeros(P, dtype=torch.int64, device=dev)
        return zero, zero.clone()
    starts = torch.empty(P, dtype=torch.int64, device=dev)
    ends = torch.empty(P, dtype=torch.int64, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.probe_arena_launch(
            keys.data_ptr(), tags.data_ptr(), offsets.data_ptr(), n,
            qkeys.data_ptr(), qtags.data_ptr(), valid.data_ptr(), P,
            starts.data_ptr(), ends.data_ptr(), stream)
    _build.check(lib, "probe_arena", code)
    launches += 1
    return starts, ends
