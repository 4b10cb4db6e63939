"""ICWS over (hash function, token) grids in f32: hand-written CUDA kernels
+ plain PyTorch versions.

Replaces the TPU kernels of ``repro/kernels/icws_hash.py``:

* :func:`icws_hash_grid` — ``_hash_grid_kernel`` (launched by
  ``icws_hash_grid``): ``(k_int, a)`` for every (k, t) of a (K, T) grid,
  what the MonoActive partitioner's active-hash generation consumes;
* :func:`icws_sketch_batch` — ``_sketch_batch_kernel``
  (``icws_sketch_batch``): per (text b, hash function k) the argmin over
  the text's tokens of ``a``, the sketch of a whole query batch in one
  launch (``QueryOptions(sketch_backend="pallas")``);
* :func:`icws_sketch` — ``_sketch_kernel`` (``icws_sketch``): the same
  for one text; it launches the batch kernel with B = 1.

One element, in f32 as the reference computes it: ``valid = w > 0``,
``lw = log(valid ? w : 1)``, ``k_int = floor(lw / r + beta)``,
``a = c * exp(-r * (k_int - beta) - r)``; a masked element is
``(0, 3.0e38)``.  The argmin starts at ``(3.0e38, t = -1, k_int = 0)`` and
moves only to a strictly smaller ``a``: the first index wins a tie, and a
text with every token masked returns ``(3.0e38, -1, 0)``.

What bounds them on the H100: bytes.  An element reads 12 bytes of
r/c/beta for one ``logf`` and one ``expf``, so the kernels
(``csrc/icws_hash.cu``) stream the grids once, coalesced: one thread per
element for the grid, one warp per (b, k) row with a shuffle reduction for
the sketch.  The kernels evaluate ``a`` with explicit round-to-nearest
operations in the order written above, so they round as the plain versions
do on the card; against the reference's XLA ``log``/``exp`` they agree to
a few ulps, and ``k_int``/argmin identities can differ only on near-ties.

The wrappers launch the CUDA kernels for CUDA tensors and use the plain
versions only for CPU tensors.  ``launches`` counts the kernel launches
of each entry point.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches made by each entry point (CUDA tensors only)
launches = {"icws_hash_grid": 0, "icws_sketch_batch": 0, "icws_sketch": 0}

BIG = 3.0e38          # the masked a (rounds to the f32 3.0e38 the kernels use)


def _check(name, r, c, beta, w) -> None:
    want_w = r.shape[:-2] + r.shape[-1:]
    for arg, t, shape in (("r", r, r.shape), ("c", c, r.shape),
                          ("beta", beta, r.shape), ("w", w, want_w)):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{name}: {arg} must be float32 of shape "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != r.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, r on "
                             f"{r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def icws_hash_grid_plain(r, c, beta, w) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`icws_hash_grid`; ``w`` broadcasts
    over the K rows (also over leading batch dimensions)."""
    w = w.unsqueeze(-2)
    valid = w > 0
    lw = torch.log(torch.where(valid, w, 1.0))
    kint = torch.floor(lw / r + beta)
    a = c * torch.exp(-r * (kint - beta) - r)
    return (torch.where(valid, kint, 0.0).to(torch.int32),
            torch.where(valid, a, BIG))


def icws_sketch_batch_plain(r, c, beta, w
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of :func:`icws_sketch_batch`: the hash grid,
    then the first argmin over T (``torch.argmin`` returns the first
    minimal index); rows with no ``a`` below 3.0e38 get ``(3.0e38, -1,
    0)``."""
    B, K, T = r.shape
    if T == 0:
        return _all_masked(B, K, r.device)
    kint, a = icws_hash_grid_plain(r, c, beta, w)
    idx = torch.argmin(a, dim=2, keepdim=True)
    mina = torch.gather(a, 2, idx)[..., 0]
    found = mina < BIG
    argt = torch.where(found, idx[..., 0].to(torch.int32), -1)
    kmin = torch.where(found, torch.gather(kint, 2, idx)[..., 0], 0)
    return mina, argt, kmin


def _all_masked(B, K, dev):
    """The sketch of texts with no valid token: ``(3.0e38, -1, 0)``."""
    return (torch.full((B, K), BIG, dtype=torch.float32, device=dev),
            torch.full((B, K), -1, dtype=torch.int32, device=dev),
            torch.zeros((B, K), dtype=torch.int32, device=dev))


def icws_sketch_plain(r, c, beta, w):
    """Plain PyTorch version of :func:`icws_sketch` (one text)."""
    mina, argt, kint = icws_sketch_batch_plain(r[None], c[None], beta[None],
                                               w[None])
    return mina[0], argt[0], kint[0]


def near_integer(r, beta, w, *, tol: float = 1e-5) -> torch.Tensor:
    """bool, shaped like ``r``: elements whose ``lw / r + beta``,
    recomputed in float64 from the f32 inputs, lies within ``tol`` of an
    integer — where two f32 evaluations may rightly floor to different
    ``k_int`` (masked elements: False)."""
    valid = (w > 0).unsqueeze(-2)
    lw = torch.log(torch.where(valid, w.double().unsqueeze(-2), 1.0))
    q = lw / r.double() + beta.double()
    return ((q - torch.round(q)).abs() <= tol) & valid


def sketch_near_ties(r, c, beta, w, *argts, rtol: float = 2e-5,
                     tol: float = 1e-5) -> torch.Tensor:
    """bool (..., K): the sketch coordinates on which two f32 evaluations
    may rightly pick different identities — the two smallest valid ``a``
    (plain version) within ``rtol`` of each other, or the token that one
    of the given argmins ``argts`` picked is :func:`near_integer`."""
    _kint, a = icws_hash_grid_plain(r, c, beta, w)
    valid = (w > 0).unsqueeze(-2).expand_as(a)
    near = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    if a.shape[-1] >= 2:
        a64 = torch.where(valid, a.double(), float("inf"))
        lo, hi = torch.topk(a64, 2, dim=-1, largest=False).values.unbind(-1)
        near |= torch.isfinite(hi) & (hi - lo <= rtol * lo)
    nint = near_integer(r, beta, w, tol=tol)
    for argt in argts:
        idx = argt.long().clamp(min=0).unsqueeze(-1)
        near |= torch.gather(nint, -1, idx)[..., 0] & (argt >= 0)
    return near


def _lib() -> ctypes.CDLL:
    lib = _build.library("icws_hash")
    if lib.icws_hash_grid_launch.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.icws_hash_grid_launch.argtypes = [p, p, p, p, ll, ll, p, p, p]
        lib.icws_hash_grid_launch.restype = ctypes.c_int
        lib.icws_sketch_batch_launch.argtypes = [p, p, p, p, ll, ll, ll, p,
                                                 p, p, p]
        lib.icws_sketch_batch_launch.restype = ctypes.c_int
    return lib


def _device(name, r) -> torch.device | None:
    """``None`` for a CPU tensor (the plain version runs), the CUDA device
    for a CUDA tensor; anything else raises."""
    if r.device.type == "cpu":
        return None
    if r.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {r.device}")
    return r.device


def icws_hash_grid(r, c, beta, w) -> tuple[torch.Tensor, torch.Tensor]:
    """``(k_int int32, a float32)``, each (K, T), for r, c, beta float32
    (K, T) and w float32 (T,) (w <= 0 masks a token).  CUDA tensors launch
    the kernel (or raise); CPU tensors run :func:`icws_hash_grid_plain`."""
    _check("icws_hash_grid", r, c, beta, w)
    if r.dim() != 2:
        raise ValueError(f"icws_hash_grid: r must be (K, T), got "
                         f"{tuple(r.shape)}")
    dev = _device("icws_hash_grid", r)
    if dev is None:
        return icws_hash_grid_plain(r, c, beta, w)
    K, T = r.shape
    kint = torch.empty((K, T), dtype=torch.int32, device=dev)
    a = torch.empty((K, T), dtype=torch.float32, device=dev)
    if K == 0 or T == 0:
        return kint, a
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.icws_hash_grid_launch(
            r.data_ptr(), c.data_ptr(), beta.data_ptr(), w.data_ptr(), K, T,
            kint.data_ptr(), a.data_ptr(), stream)
    _build.check(lib, "icws_hash", code)
    launches["icws_hash_grid"] += 1
    return kint, a


def _sketch_launch(dev, r, c, beta, w):
    B, K, T = r.shape
    mina = torch.empty((B, K), dtype=torch.float32, device=dev)
    argt = torch.empty((B, K), dtype=torch.int32, device=dev)
    kint = torch.empty((B, K), dtype=torch.int32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.icws_sketch_batch_launch(
            r.data_ptr(), c.data_ptr(), beta.data_ptr(), w.data_ptr(), B, K,
            T, mina.data_ptr(), argt.data_ptr(), kint.data_ptr(), stream)
    _build.check(lib, "icws_hash", code)
    return mina, argt, kint


def icws_sketch_batch(r, c, beta, w
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched fused CWS sketch: r, c, beta float32 (B, K, T), w float32
    (B, T) (w <= 0 masks padding) -> ``(min_a float32, argmin_token int32,
    k_int int32)``, each (B, K).  CUDA tensors launch the kernel (or
    raise); CPU tensors run :func:`icws_sketch_batch_plain`."""
    _check("icws_sketch_batch", r, c, beta, w)
    if r.dim() != 3:
        raise ValueError(f"icws_sketch_batch: r must be (B, K, T), got "
                         f"{tuple(r.shape)}")
    dev = _device("icws_sketch_batch", r)
    if dev is None:
        return icws_sketch_batch_plain(r, c, beta, w)
    B, K, T = r.shape
    if B == 0 or K == 0 or T == 0:
        return _all_masked(B, K, dev)
    out = _sketch_launch(dev, r, c, beta, w)
    launches["icws_sketch_batch"] += 1
    return out


def icws_sketch(r, c, beta, w
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused CWS sketch of one text: r, c, beta float32 (K, T), w float32
    (T,) -> ``(min_a, argmin_token, k_int)``, each (K,).  CUDA tensors
    launch the batch kernel with B = 1 (or raise); CPU tensors run
    :func:`icws_sketch_plain`."""
    _check("icws_sketch", r, c, beta, w)
    if r.dim() != 2:
        raise ValueError(f"icws_sketch: r must be (K, T), got "
                         f"{tuple(r.shape)}")
    dev = _device("icws_sketch", r)
    if dev is None:
        return icws_sketch_plain(r, c, beta, w)
    K, T = r.shape
    if K == 0 or T == 0:
        mina, argt, kint = _all_masked(1, K, dev)
        return mina[0], argt[0], kint[0]
    mina, argt, kint = _sketch_launch(dev, r[None], c[None], beta[None],
                                      w[None])
    launches["icws_sketch"] += 1
    return mina[0], argt[0], kint[0]
