"""Port kernels (``repro_torch.kernels``) against the JAX reference.

The plain PyTorch versions — what a kernel wrapper runs for CPU tensors —
must agree bit for bit with the reference's Pallas kernels in interpret
mode and with the reference's host paths:

* probe: ``arena_search_plain`` slot for slot against
  ``repro.kernels.probe_arena.arena_search``, and ``arena_probe`` (the
  wrapper, CPU tensors) ``(starts, ends)`` against
  ``repro.core.frozen.ProbeArena.probe``, on packed arenas (k = 8 and
  k = 160, whose keys carry the top bit), universal and mix coord arenas,
  and a hand-built mix arena with duplicate keys across coordinates;
  probes mix hits, misses, keys >= 2**63 and invalid probes;
* sweep: ``sweep`` (CPU tensors) ``hot``/``xs``/``ys`` against
  ``repro.kernels.sweep_grid.sweep_small_batch_device``, and the blocks
  its grids extract to against ``repro.core.query._sweep_small_batch``.

The wrappers never fall back: a tensor on any device other than the CPU
or CUDA raises before any plain version runs.  All inputs are made with
numpy from a seed and handed to both packages.
"""

from pathlib import Path

import jax  # noqa: F401  (the reference's kernels run on the CPU backend)
import numpy as np
import pytest
import torch

from repro.core.columnar import ColumnarBuilder as RefColumnarBuilder
from repro.core.frozen import KIND_INT as REF_KIND_INT
from repro.core.frozen import ProbeArena as RefProbeArena
from repro.core.query import _sweep_small_batch as ref_sweep_small_batch
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.kernels.probe_arena import arena_search as ref_arena_search
from repro.kernels.sweep_grid import sweep_small_batch_device
from repro_torch.core.device_plan import _encode_queries
from repro_torch.core.frozen import MODE_PACKED, PACK_SHIFT
from repro_torch.core.hashing import MixHash
from repro_torch.core.query import _extract_runs
from repro_torch.kernels import probe_arena, sweep_grid


def _docs(seed, n_docs=5, n=120, vocab=400):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int64)
            for _ in range(n_docs)]


def _ref_arena(kind: str) -> RefProbeArena:
    """A reference arena of each layout the port must probe."""
    docs = _docs(3)
    if kind == "packed_k8":
        scheme = ref_make_scheme("tfidf", seed=1, k=8, corpus=docs)
    elif kind == "packed_k160":
        scheme = ref_make_scheme("weighted", seed=2, k=160)
        docs = docs[:2]
    elif kind == "coord_universal":
        scheme = ref_make_scheme("multiset", seed=3, k=8)
    elif kind == "coord_mix":
        scheme = ref_make_scheme("multiset", seed=4, k=8, family="mix")
    else:                       # mix keys shared across coordinates
        rng = np.random.default_rng(5)
        pool = MixHash.from_seed(7, 1)[0](np.arange(300),
                                          np.ones(300, np.int64))
        k = 6
        packed = [rng.choice(pool, size=int(rng.integers(50, 120)))
                  for _ in range(k)]
        wins = [rng.integers(0, 100, size=(len(p), 5)).astype(np.int32)
                for p in packed]
        return RefProbeArena.from_window_columns(
            [REF_KIND_INT] * k, packed, wins, np.zeros(k, np.int64))
    return RefColumnarBuilder(scheme=scheme).build(docs).freeze(
        arena=True).arena()


ARENAS = ["packed_k8", "packed_k160", "coord_universal", "coord_mix",
          "dup_mix"]


def _probes(arena, seed, n=96):
    """(pkeys u64, coords u16, valid bool): hits, invalid hits, misses and
    keys with the top bit set."""
    rng = np.random.default_rng(seed)
    keys = np.asarray(arena.keys)
    slots = rng.integers(0, len(keys), size=n)
    if arena.mode == MODE_PACKED:
        hk = keys[slots] & np.uint64((1 << PACK_SHIFT) - 1)
        hc = (keys[slots] >> np.uint64(PACK_SHIFT)).astype(np.uint16)
    else:
        hk, hc = keys[slots], np.asarray(arena.coords)[slots]
    miss = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * np.uint64(2)
    top = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) | \
        np.uint64(1 << 63)
    mc = rng.integers(0, arena.k, size=n).astype(np.uint16)
    return (np.concatenate([hk, hk, miss, top]),
            np.concatenate([hc, hc, mc, mc]),
            np.concatenate([np.ones(n, bool), np.zeros(n, bool),
                            np.ones(2 * n, bool)]))


def _device_inputs(arena, pkeys, coords, valid):
    keys = torch.from_numpy(np.array(arena.keys, np.uint64).view(np.int64))
    if arena.mode == MODE_PACKED:
        tags = torch.zeros(len(arena.keys), dtype=torch.int32)
    else:
        tags = torch.from_numpy(np.array(arena.coords, np.int32))
    offsets = torch.from_numpy(np.array(arena.offsets, np.int64))
    qk, qt = _encode_queries(arena.mode, pkeys, coords, valid)
    return keys, tags, offsets, torch.from_numpy(qk), \
        torch.from_numpy(qt), torch.from_numpy(valid.copy())


@pytest.mark.parametrize("kind", ARENAS)
def test_plain_search_matches_pallas_slot_for_slot(kind):
    arena = _ref_arena(kind)
    pkeys, coords, valid = _probes(arena, seed=11)
    keys, tags, _off, qk, qt, _v = _device_inputs(arena, pkeys, coords,
                                                  valid)
    got = probe_arena.arena_search_plain(keys, tags, qk, qt).numpy()
    want = ref_arena_search(np.asarray(arena.keys), tags.numpy().astype(
        np.uint32), qk.numpy().view(np.uint64), qt.numpy().astype(np.uint32),
        interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want, np.int64))


@pytest.mark.parametrize("kind", ARENAS)
def test_probe_matches_host_probe(kind):
    arena = _ref_arena(kind)
    if kind == "packed_k160":
        assert (np.asarray(arena.keys) >> np.uint64(63)).any()
    if kind == "dup_mix":
        assert arena.mode == "coord" and arena.max_run > 1
    pkeys, coords, valid = _probes(arena, seed=12)
    want_s, want_e = arena.probe(pkeys, coords, valid)
    got_s, got_e = probe_arena.arena_probe(
        *_device_inputs(arena, pkeys, coords, valid))
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    assert (want_e > want_s).sum() > 0          # the cases do hit


def test_probe_empty_batch_and_no_launch_on_cpu():
    arena = _ref_arena("packed_k8")
    before = probe_arena.launches
    empty = np.zeros(0, np.uint64)
    s, e = probe_arena.arena_probe(*_device_inputs(
        arena, empty, np.zeros(0, np.uint16), np.zeros(0, bool)))
    assert s.shape == e.shape == (0,)
    assert probe_arena.launches == before


def _groups(seed, S, G=24, nwin=200):
    """win_rect (nwin, 4) with zero-width rects (b = a - 1) and repeated
    boundaries, a (G, S) row-index grid and per-group sizes in 1..S."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 30, size=nwin)
    c = rng.integers(0, 30, size=nwin)
    b = a + rng.integers(-1, 8, size=nwin)
    d = c + rng.integers(0, 8, size=nwin)
    rect = np.stack([a, b, c, d], axis=1).astype(np.int32)
    idx = rng.integers(0, nwin, size=(G, S)).astype(np.int64)
    sizes = rng.integers(1, S + 1, size=G).astype(np.int32)
    sizes[0] = S
    return rect, idx, sizes


@pytest.mark.parametrize("S", [1, 3, 8, 13, 16, 32])
@pytest.mark.parametrize("m", [1, 3])
def test_sweep_matches_pallas_and_host_blocks(S, m):
    rect, idx, sizes = _groups(S * 10 + m, S)
    hot, xs, ys = sweep_grid.sweep(torch.from_numpy(rect),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(sizes), m)
    arr = rect[idx].astype(np.int64)                    # (G, S, 4)
    want_hot, want_xs, want_ys = sweep_small_batch_device(
        arr, sizes, m, interpret=True)
    np.testing.assert_array_equal(hot.numpy().view(bool), want_hot)
    np.testing.assert_array_equal(xs.numpy(), want_xs)
    np.testing.assert_array_equal(ys.numpy(), want_ys)
    blocks = _extract_runs(hot.numpy().view(bool), xs.numpy().astype(
        np.int64), ys.numpy().astype(np.int64))
    assert blocks == ref_sweep_small_batch(arr, sizes.astype(np.int64), m)


def test_sweep_rejects_bad_shapes():
    rect, idx, sizes = _groups(0, 4)
    with pytest.raises(ValueError):
        sweep_grid.sweep(torch.from_numpy(rect),
                         torch.from_numpy(np.zeros((2, 33), np.int64)),
                         torch.from_numpy(np.ones(2, np.int32)), 1)
    with pytest.raises(ValueError):
        sweep_grid.sweep(torch.from_numpy(rect), torch.from_numpy(idx),
                         torch.from_numpy(sizes.astype(np.int64)), 1)


def test_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain versions:
    the wrapper launches its kernel (CUDA) or raises."""
    def boom(*_a):
        raise AssertionError("plain version used for a non-CPU tensor")

    monkeypatch.setattr(probe_arena, "arena_probe_plain", boom)
    monkeypatch.setattr(sweep_grid, "sweep_plain", boom)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        probe_arena.arena_probe(
            torch.empty(4, dtype=torch.int64, device=meta),
            torch.empty(4, dtype=torch.int32, device=meta),
            torch.empty(5, dtype=torch.int64, device=meta),
            torch.empty(2, dtype=torch.int64, device=meta),
            torch.empty(2, dtype=torch.int32, device=meta),
            torch.empty(2, dtype=torch.bool, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        sweep_grid.sweep(torch.empty((4, 4), dtype=torch.int32, device=meta),
                         torch.empty((2, 3), dtype=torch.int64, device=meta),
                         torch.empty(2, dtype=torch.int32, device=meta), 1)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Where the CUDA compiler is missing the build raises; nothing runs
    the plain version instead."""
    from repro_torch.kernels import _build
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.os, "access", lambda *_a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("probe_arena")


def test_kernel_build_dir(monkeypatch, tmp_path):
    """Libraries go where the variable says, else into the checkout's
    ``build/repro_torch``; outside a checkout, without the variable, the
    build raises instead of writing next to the installed package."""
    from repro_torch.kernels import _build
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path))
    assert _build.build_dir() == tmp_path
    monkeypatch.delenv(_build.BUILD_DIR_ENV)
    root = Path(__file__).resolve().parent.parent
    assert _build.build_dir() == root / "build" / "repro_torch"
    monkeypatch.setattr(_build, "_CHECKOUT", tmp_path / "site-packages")
    with pytest.raises(RuntimeError, match="not running from a checkout"):
        _build.build_dir()
