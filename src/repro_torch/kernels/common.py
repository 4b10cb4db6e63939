"""The 32-bit counter-based hash family of the device sketches, on tensors.

Carried over from ``repro/kernels/common.py`` (murmur3 finalizer
``mix32`` and the two-stage ``hash32(seed, t, x)``), for the plain
PyTorch versions of the sketch kernels; the CUDA kernels compute the same
functions in native ``uint32_t`` arithmetic.  Torch's ``uint32`` support
is thin, so these run on int64 tensors holding values in ``[0, 2**32)``:
every multiply and xor is masked with ``& 0xFFFFFFFF`` and only
non-negative values are shifted, which is bit-equal to uint32 wraparound
(a product of two values below ``2**32`` may wrap int64, but its low 32
bits survive the wrap).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_G = 0x9E3779B9
_P1 = 0xCC9E2D51
_P2 = 0x1B873593


def mix32(z: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding uint32 values."""
    z = z & MASK
    z = ((z ^ (z >> 16)) * _M1) & MASK
    z = ((z ^ (z >> 13)) * _M2) & MASK
    return z ^ (z >> 16)


def hash32(seed: torch.Tensor, t: torch.Tensor, x: torch.Tensor
           ) -> torch.Tensor:
    """Counter-based ``h(t, x)`` for hash function ``seed`` (broadcasting
    int64 tensors; each is read as its low 32 bits, as the reference's
    ``astype(uint32)`` reads it)."""
    a = mix32((seed & MASK) ^ (((t & MASK) * _P1) & MASK) ^ _G)
    return mix32(a ^ (((x & MASK) * _P2) & MASK))
