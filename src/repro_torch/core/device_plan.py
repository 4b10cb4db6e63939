"""The device-resident query pipeline behind ``plan="device"``, in torch.

Rewritten from ``repro/core/device_plan.py`` on an explicit
``torch.device``.  The fused :class:`~repro_torch.core.frozen.ProbeArena`
stays *resident* on the device across batches, the probe and the
small-group sweep run as hand-written CUDA kernels
(:mod:`repro_torch.kernels.probe_arena`, :mod:`repro_torch.kernels.
sweep_grid`), and per batch only

* up:   the probe keys/tags/valid flags and the small-group gather index
  grids,
* down: the CSR probe extents and the hot masks + stripe boundaries the
  final blocks are read from

cross the bus — never the arena, never the window rows.  On a CPU device
the same code runs the kernels' plain versions (what the CPU tests use).

Stages, in the reference's order: encode the batch on the host, probe the
resident arena (kernel: binary search fused with hit detect and the CSR
lookup), group by (query, text) on the host from the text-id column,
gather the rectangle rows and sweep on the device in three size buckets
(kernel), extract the blocks on the host, and sweep the rare groups of
more than 32 windows on the host — the reference's design, counted in
``transfer_stats()["host_large_groups"]``.

Residency: :func:`device_arena` caches a :class:`DeviceArena` on the index
instance keyed by the *identity* of its host ``ProbeArena`` and the
device, so an index uploads at most once per device.  Offsets are int64,
so an arena of any CSR extent can go resident: unlike the reference, there
is no int32-offset host fallback, and an arena that cannot be uploaded
raises.  An empty arena returns empty results.

``transfer_stats()`` exposes logical host<->device byte counters.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import probe_arena, sweep_grid
from .frozen import MODE_PACKED, PACK_SHIFT, _concat_ranges

__all__ = ["DeviceArena", "device_arena", "fused_batch_query",
           "resolve_device", "transfer_stats", "reset_transfer_stats"]

# logical host<->device transfer accounting.  arena_* count the residency
# upload; h2d/d2h the per-batch traffic; host_large_groups the groups of
# more than 32 windows swept on the host instead of by the kernel.
_STATS = {"arena_uploads": 0, "arena_bytes": 0,
          "h2d_bytes": 0, "d2h_bytes": 0, "batches": 0,
          "host_large_groups": 0}


def transfer_stats() -> dict:
    """A snapshot of the module's transfer counters."""
    return dict(_STATS)


def reset_transfer_stats() -> None:
    for key in _STATS:
        _STATS[key] = 0


def resolve_device(device=None) -> torch.device:
    """The device the device plan runs on: ``None`` means ``"cuda"``.  A
    CUDA device where CUDA is unavailable raises; nothing carries on on
    the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the device plan runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (or plan='cpu') to run on the host")
    return dev


@dataclass
class DeviceArena:
    """One ProbeArena, resident on ``device``.

    ``keys`` holds the raw u64 bits as int64 (the kernel compares them
    unsigned); ``tags`` the coordinate words of "coord" mode (zeros in
    "packed" mode); ``offsets`` the CSR row pointers in int64;
    ``win_rect`` only the (a, b, c, d) rectangle columns, because the
    text-id column is read on the host for grouping.
    """

    mode: str
    keys: torch.Tensor        # int64 (n,)
    tags: torch.Tensor        # int32 (n,)
    offsets: torch.Tensor     # int64 (n + 1,)
    win_rect: torch.Tensor    # int32 (nwin, 4)
    nbytes: int


def _build_device_arena(arena, device: torch.device) -> DeviceArena:
    n = len(arena.keys)
    # owned host copies: the store's arrays are read-only mmap views
    keys = np.array(arena.keys, np.uint64).view(np.int64)
    if arena.mode == MODE_PACKED:
        tags = np.zeros(n, np.int32)
    else:
        tags = np.array(arena.coords, np.int32)
    offsets = np.array(arena.offsets, np.int64)
    rect = np.ascontiguousarray(np.asarray(arena.windows)[:, 1:5], np.int32)
    dev = DeviceArena(
        mode=arena.mode,
        keys=torch.from_numpy(keys).to(device),
        tags=torch.from_numpy(tags).to(device),
        offsets=torch.from_numpy(offsets).to(device),
        win_rect=torch.from_numpy(rect).to(device),
        nbytes=keys.nbytes + tags.nbytes + offsets.nbytes + rect.nbytes)
    _STATS["arena_uploads"] += 1
    _STATS["arena_bytes"] += dev.nbytes
    return dev


def device_arena(index, device: torch.device) -> DeviceArena:
    """The index's resident arena on ``device``, uploading on first use
    and caching on the index instance (``SearchIndex._device_arena``),
    keyed by the host ``ProbeArena``'s identity and the device."""
    arena = index.arena()
    cached = index._device_arena
    if cached is not None and cached[0] is arena and cached[1] == device:
        return cached[2]
    dev = _build_device_arena(arena, device)
    index._device_arena = (arena, device, dev)
    return dev


def _encode_queries(mode: str, pkeys: np.ndarray, coords: np.ndarray,
                    valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side probe re-keying, identical to ``ProbeArena.probe``: packed
    arenas fold the coordinate into the key's top bits, coord arenas carry
    it as the tag word.  -> (qkeys as int64 bits, qtags int32)."""
    if mode == MODE_PACKED:
        q = (coords.astype(np.uint64) << np.uint64(PACK_SHIFT)) | \
            np.where(valid, pkeys, 0).astype(np.uint64)
        qtags = np.zeros(len(q), np.int32)
    else:
        q = np.asarray(pkeys, np.uint64)
        qtags = coords.astype(np.int32)
    return np.ascontiguousarray(q).view(np.int64), qtags


def _device_probe(da: DeviceArena, pkeys, coords, valid, device
                  ) -> tuple[np.ndarray, np.ndarray]:
    qkeys, qtags = _encode_queries(da.mode, pkeys, coords, valid)
    valid = np.ascontiguousarray(valid, bool)
    starts, ends = probe_arena.arena_probe(
        da.keys, da.tags, da.offsets, torch.from_numpy(qkeys).to(device),
        torch.from_numpy(qtags).to(device),
        torch.from_numpy(valid).to(device))
    _STATS["h2d_bytes"] += qkeys.nbytes + qtags.nbytes + valid.nbytes
    starts, ends = starts.cpu().numpy(), ends.cpu().numpy()
    _STATS["d2h_bytes"] += starts.nbytes + ends.nbytes
    return starts, ends


def fused_batch_query(index, sketches, B: int, m: int, *,
                      device: torch.device,
                      stage_times: dict | None = None) -> list:
    """The fused frozen-index batch path: device probe over the resident
    arena, host grouping on the windows' text-id column alone, device
    gather of the rectangle rows + device sweep per size bucket, and block
    extraction on the host.  Block-identical to the cpu plan."""
    from .query import (_SIZE_BUCKETS, _SMALL_GROUP_MAX, Alignment,
                        _extract_runs, _group_bounds, _sweep_text)
    t1 = time.perf_counter()
    arena = index.arena()
    k = arena.k
    _STATS["batches"] += 1
    results: list[list[Alignment]] = [[] for _ in range(B)]
    if len(arena.keys) == 0:
        return results
    pkeys, coords, valid = arena.encode_batch(sketches)
    da = device_arena(index, device)
    starts, ends = _device_probe(da, pkeys, coords, valid, device)
    counts = ends - starts
    row_ids = _concat_ranges(starts, counts)
    probe_ids = np.repeat(np.arange(len(pkeys), dtype=np.int64), counts)
    qid_all, cid_all = probe_ids // k, probe_ids % k
    # the ONE window column the host touches: text ids, for grouping and
    # result labelling (mmap page-ins, not bus traffic)
    tid_all = np.asarray(arena.windows[row_ids, 0], np.int64)
    t2 = time.perf_counter()

    if len(qid_all):
        order, g_starts, g_ends, distinct = _group_bounds(
            qid_all, tid_all, cid_all)
        qid_s, tid_s, row_s = qid_all[order], tid_all[order], row_ids[order]
        keep = distinct >= m
        sizes = g_ends - g_starts

        small_results: dict[int, list] = {}
        sm_ids = np.flatnonzero(keep & (sizes <= _SMALL_GROUP_MAX))
        for b_lo, b_hi in _SIZE_BUCKETS:
            ids = sm_ids[(sizes[sm_ids] > b_lo) & (sizes[sm_ids] <= b_hi)]
            if not len(ids):
                continue
            s_starts, s_sizes = g_starts[ids], sizes[ids]
            G, S = len(ids), int(s_sizes.max())
            idx = np.zeros((G, S), np.int64)
            rows = row_s[_concat_ranges(s_starts, s_sizes)]
            slot = np.arange(len(rows)) - np.repeat(
                np.cumsum(s_sizes) - s_sizes, s_sizes)
            idx[np.repeat(np.arange(G), s_sizes), slot] = rows
            sz32 = s_sizes.astype(np.int32)
            # only the (G, S) index grid goes up, never the window rows
            hot, xs, ys = sweep_grid.sweep(
                da.win_rect, torch.from_numpy(idx).to(device),
                torch.from_numpy(sz32).to(device), m)
            _STATS["h2d_bytes"] += idx.nbytes + sz32.nbytes
            hot_np = hot.cpu().numpy().view(bool)
            xs_np, ys_np = xs.cpu().numpy(), ys.cpu().numpy()
            _STATS["d2h_bytes"] += hot_np.nbytes + xs_np.nbytes + ys_np.nbytes
            for g, blocks in zip(ids, _extract_runs(
                    hot_np, xs_np.astype(np.int64), ys_np.astype(np.int64))):
                small_results[int(g)] = blocks

        for g in np.flatnonzero(keep):
            g = int(g)
            lo = g_starts[g]
            if g in small_results:
                blocks = small_results[g]
            else:
                # rare large group: host sweep straight off the mmap rows
                _STATS["host_large_groups"] += 1
                blocks = _sweep_text(
                    np.asarray(arena.windows[row_s[lo:g_ends[g]], 1:5],
                               np.int64), m)
            if blocks:
                results[int(qid_s[lo])].append(
                    Alignment(text_id=int(tid_s[lo]), blocks=blocks,
                              ncoords=int(distinct[g])))
    if stage_times is not None:
        t3 = time.perf_counter()
        stage_times["probe"] = stage_times.get("probe", 0.0) + (t2 - t1)
        stage_times["sweep"] = stage_times.get("sweep", 0.0) + (t3 - t2)
    return results
