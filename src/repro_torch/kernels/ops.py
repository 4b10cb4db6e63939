"""Public entry points of the sketch kernels (the sketch half of
``repro/kernels/ops.py``).

* :func:`icws_token_params` — the (K, T) f32 r/c/beta grids of the ICWS
  family the index uses (``repro_torch.core.icws``), for given tokens;
* :func:`cws_sketch` — the CWS sketch of one text
  (:func:`~repro_torch.kernels.icws_hash.icws_sketch`);
* :func:`cws_sketch_batch` — the sketch identities of a batch of texts in
  one launch (:func:`~repro_torch.kernels.icws_hash.icws_sketch_batch`),
  what ``QueryOptions(sketch_backend="pallas")`` serves with;
* :func:`multiset_sketch` — batched multiset min-hash sketches
  (:func:`~repro_torch.kernels.minhash_sketch.minhash_sketch`).

The reference's ``use_pallas``/``interpret`` switches have no meaning
here.  ``device`` follows the port's rule: ``None`` means ``"cuda"``
(which raises where CUDA is absent), a CUDA device launches the kernels
and the CPU runs their plain versions.

The r/c/beta grids are built on the host, as the reference builds them,
but in ONE float64 ``_token_params`` call over the (K, N) grid of every
hasher and the concatenated tokens of every text, cast to f32 once —
bit-identical to the reference's per-text, per-hasher loop, whose
elementwise float64 formulas are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.hashing import mix2
from ..core.icws import _token_params
from . import icws_hash, minhash_sketch as _minhash

__all__ = ["icws_token_params", "cws_sketch", "cws_sketch_batch",
           "multiset_sketch"]


def _device(device) -> torch.device:
    from ..core.device_plan import resolve_device
    return resolve_device(device)


def _batch_grids(seed: int, k: int, token_lists, weight_lists):
    """Host grids of a batch of texts: r, c, beta f32 (B, K, Tmax) and
    w f32 (B, Tmax), padded with r = c = beta = 1 and w = 0, and the
    zero-padded tokens int64 (B, Tmax)."""
    B = len(token_lists)
    toks_l = [np.asarray(t, np.int64).ravel() for t in token_lists]
    sizes = np.array([len(t) for t in toks_l], dtype=np.int64)
    Tmax = max(1, int(sizes.max()) if B else 1)
    flat = np.concatenate(toks_l) if B else np.zeros(0, np.int64)
    seeds = mix2(np.uint64(seed), np.arange(k, dtype=np.uint64))
    params = _token_params(seeds[:, None], flat[None, :])     # (K, N) f64
    row = np.repeat(np.arange(B, dtype=np.int64), sizes)
    slot = np.arange(len(flat), dtype=np.int64) - np.repeat(
        np.cumsum(sizes) - sizes, sizes)
    r, c, be = (np.ones((B, k, Tmax), np.float32) for _ in range(3))
    for grid, p in zip((r, c, be), params):
        grid[row, :, slot] = p.T.astype(np.float32)
    w = np.zeros((B, Tmax), np.float32)            # w <= 0 masks padding
    toks = np.zeros((B, Tmax), np.int64)
    if len(flat):
        w[row, slot] = np.concatenate(
            [np.asarray(x, np.float32).ravel() for x in weight_lists])
        toks[row, slot] = flat
    return r, c, be, w, toks


def icws_token_params(seed: int, k: int, tokens, *, device=None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stateless (r, c, beta) grids, float32 (K, T) on ``device``, for the
    ICWS kernels: the ICWS family of the index (``core/icws.py``) for
    hashers ``mix2(seed, 0..k-1)`` and the given tokens."""
    dev = _device(device)
    toks = np.asarray(tokens, np.int64).ravel()
    r, c, be, _w, _t = _batch_grids(seed, k, [toks],
                                    [np.ones(len(toks), np.float32)])
    T = len(toks)
    return tuple(torch.from_numpy(np.ascontiguousarray(g[0, :, :T])).to(dev)
                 for g in (r, c, be))


def cws_sketch(seed: int, k: int, tokens, weights, *, device=None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k-coordinate CWS sketch of one text: ``(argmin token id int64,
    k_int int32, min a float32)``, each (k,), on ``device``.

    tokens: distinct token ids; weights: their ``w(t, f) > 0``.
    """
    dev = _device(device)
    r, c, b = icws_token_params(seed, k, tokens, device=dev)
    w = torch.as_tensor(np.asarray(weights, np.float32)).to(dev)
    mina, argt, kint = icws_hash.icws_sketch(r, c, b, w)
    toks = torch.as_tensor(np.asarray(tokens, np.int64)).to(dev)
    return toks[argt.long()], kint, mina


def cws_sketch_batch(seed: int, k: int, token_lists, weight_lists, *,
                     device=None) -> list[list[tuple[int, int]]]:
    """CWS sketch identities of a batch of texts in ONE kernel launch.

    token_lists[b]: distinct token ids of text b; weight_lists[b]: their
    ``w(t, f) > 0``.  Returns per-text identity lists ``[(token, k_int),
    ...]`` of length k — the sketch-coordinate format ``batch_query``
    probes with.  A coordinate whose text has no valid token (argmin -1)
    reads the last slot of its zero-padded token row, as the reference
    does.  Copying the identities back to the host synchronises with the
    device.
    """
    B = len(token_lists)
    if B == 0:
        return []
    dev = _device(device)
    r, c, be, w, toks = _batch_grids(seed, k, token_lists, weight_lists)
    up = [torch.from_numpy(x).to(dev) for x in (r, c, be, w)]
    _mina, argt, kint = icws_hash.icws_sketch_batch(*up)
    argt = argt.cpu().numpy()
    kint = kint.cpu().numpy()
    t_star = np.take_along_axis(toks, argt.astype(np.int64) % toks.shape[1],
                                axis=1)
    return [list(zip(t_star[b].tolist(), kint[b].tolist()))
            for b in range(B)]


def multiset_sketch(tokens, occ, seeds, *, device=None) -> torch.Tensor:
    """Batched multiset min-hash sketches, int64 (B, K) holding uint32
    values, on ``device``.

    tokens (B, N) int (-1 = padding), occ (B, N) int (1-based occurrence
    index), seeds (K,) uint32: numpy arrays, sequences or tensors.
    """
    dev = _device(device)
    return _minhash.minhash_sketch(_on(tokens, torch.int32, dev),
                                   _on(occ, torch.int32, dev),
                                   _on(seeds, torch.int64, dev))


_NP = {torch.int32: np.int32, torch.int64: np.int64}


def _on(x, dtype, dev) -> torch.Tensor:
    """``x`` as a contiguous ``dtype`` tensor on ``dev`` (uint32 values
    keep their value in int64)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=_NP[dtype]))
    return x.to(device=dev, dtype=dtype).contiguous()
