"""The port's CUDA kernels on the card (marker ``gpu``).

Run on a machine with a CUDA card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors — the probe, the sweep and the min-hash must be equal (integer
exact); the f32 ICWS kernels must give equal identities off near-ties
(``icws_hash.sketch_near_ties``) and ``a`` within rtol 2e-5 — and its
launch counter must rise.  The device plan on ``device="cuda"`` is held
against the port's ``plan="cpu"``, with and without the
``sketch_backend="pallas"`` pin.  Whether a
card is present is decided inside the ``cuda`` fixture, so every worker
collects the same tests; without a card they skip.  This file imports no
JAX: the card's machine has none.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.api import Aligner
from repro_torch.core.columnar import ColumnarBuilder
from repro_torch.core.device_plan import _encode_queries, device_arena
from repro_torch.core.frozen import MODE_PACKED, PACK_SHIFT
from repro_torch.core.results import QueryOptions
from repro_torch.core.schemes import make_scheme
from repro_torch.kernels import icws_hash, ops, probe_arena, sweep_grid

minhash = importlib.import_module("repro_torch.kernels.minhash_sketch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    return torch.device("cuda")


def _docs(seed, n_docs=6, n=200, vocab=3000):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int64)
            for _ in range(n_docs)]


@pytest.mark.parametrize("similarity,k,family", [
    ("tfidf", 8, "universal"), ("weighted", 160, "universal"),
    ("multiset", 8, "universal"), ("multiset", 8, "mix")])
def test_probe_kernel_equals_plain(cuda, similarity, k, family):
    docs = _docs(k)
    scheme = make_scheme(similarity, k=k, family=family, corpus=docs)
    index = ColumnarBuilder(scheme=scheme).build(docs).freeze()
    arena = index.arena()
    rng = np.random.default_rng(1)
    slots = rng.integers(0, len(arena.keys), size=300)
    keys = np.asarray(arena.keys)
    if arena.mode == MODE_PACKED:
        pk = keys[slots] & np.uint64((1 << PACK_SHIFT) - 1)
        pc = (keys[slots] >> np.uint64(PACK_SHIFT)).astype(np.uint16)
    else:
        pk, pc = keys[slots], np.asarray(arena.coords)[slots]
    top = rng.integers(0, 1 << 63, size=300, dtype=np.uint64) | \
        np.uint64(1 << 63)
    pkeys = np.concatenate([pk, pk, top])
    coords = np.concatenate([pc, pc, pc])
    valid = np.concatenate([np.ones(300, bool), np.zeros(300, bool),
                            np.ones(300, bool)])
    qk, qt = _encode_queries(arena.mode, pkeys, coords, valid)
    da = device_arena(index, cuda)
    args = (da.keys, da.tags, da.offsets, torch.from_numpy(qk).to(cuda),
            torch.from_numpy(qt).to(cuda), torch.from_numpy(valid).to(cuda))
    before = probe_arena.launches
    got = probe_arena.arena_probe(*args)
    want = probe_arena.arena_probe_plain(*args)
    assert probe_arena.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    host = arena.probe(pkeys, coords, valid)
    np.testing.assert_array_equal(got[0].cpu().numpy(), host[0])
    np.testing.assert_array_equal(got[1].cpu().numpy(), host[1])


@pytest.mark.parametrize("S", list(range(1, 33)))
def test_sweep_kernel_equals_plain(cuda, S):
    rng = np.random.default_rng(S)
    nwin, G = 300, 40
    a = rng.integers(0, 40, size=nwin)
    c = rng.integers(0, 40, size=nwin)
    rect = np.stack([a, a + rng.integers(-1, 9, size=nwin), c,
                     c + rng.integers(0, 9, size=nwin)], 1).astype(np.int32)
    idx = rng.integers(0, nwin, size=(G, S)).astype(np.int64)
    sizes = rng.integers(1, S + 1, size=G).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (rect, idx, sizes)]
    for m in (1, 2, max(1, S // 2)):
        got = sweep_grid.sweep(*args, m)
        want = sweep_grid.sweep_plain(*args, m)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_device_plan_on_cuda_equals_cpu_plan(cuda, tmp_path):
    docs = _docs(7, n_docs=10)
    Aligner.build(docs, similarity="tfidf", k=16, store=tmp_path / "s",
                  device=cuda)
    server = Aligner.load(tmp_path / "s")
    assert server.device.type == "cuda"
    qs = [d[20:80] for d in docs] + [np.arange(60) + 5000]
    before = probe_arena.launches
    for theta in (0.5, 0.8):
        dev = server.find_batch(qs, theta)
        cpu = server.find_batch(qs, theta, options=QueryOptions(plan="cpu"))
        assert [r.to_dict() for r in dev] == [r.to_dict() for r in cpu]
        assert sum(len(r) for r in dev) >= len(docs)
    assert probe_arena.launches == before + 2


def _icws_grids(rng, shape, T, device):
    r = rng.gamma(2.0, 1.0, shape + (T,)).astype(np.float32)
    c = rng.gamma(2.0, 1.0, shape + (T,)).astype(np.float32)
    b = rng.uniform(0, 1, shape + (T,)).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (r, c, b)]


def _assert_sketch(got, want, near):
    assert int(near.sum()) <= 0.01 * near.numel()
    same = (got[1] == want[1]) & (got[2] == want[2])
    assert bool((same | near).all())
    torch.testing.assert_close(got[0][same], want[0][same], rtol=2e-5,
                               atol=0)


@pytest.mark.parametrize("K,T", [(8, 128), (32, 5000), (1, 1), (9, 129)])
def test_icws_hash_grid_kernel_equals_plain(cuda, K, T):
    rng = np.random.default_rng(K + T)
    r, c, b = _icws_grids(rng, (K,), T, cuda)
    w = torch.from_numpy(rng.uniform(0.1, 5.0, T).astype(np.float32)).to(cuda)
    w[torch.from_numpy(rng.random(T) < 0.2).to(cuda)] = 0.0
    before = icws_hash.launches["icws_hash_grid"]
    kint, a = icws_hash.icws_hash_grid(r, c, b, w)
    kint_p, a_p = icws_hash.icws_hash_grid_plain(r, c, b, w)
    assert icws_hash.launches["icws_hash_grid"] == before + 1
    near = icws_hash.near_integer(r, b, w)
    assert int(near.sum()) <= max(1, 0.01 * near.numel())
    same = kint == kint_p
    assert bool((same | near).all())
    torch.testing.assert_close(a[same], a_p[same], rtol=2e-5, atol=0)


@pytest.mark.parametrize("B,K,T", [(1, 32, 120), (64, 32, 120),
                                   (5, 16, 1000), (3, 8, 33)])
def test_icws_sketch_batch_kernel_equals_plain(cuda, B, K, T):
    rng = np.random.default_rng(B * K + T)
    r, c, b = _icws_grids(rng, (B, K), T, cuda)
    w = rng.uniform(0.1, 5.0, (B, T)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    w[np.arange(T)[None, :] >= lens[:, None]] = 0.0
    if B > 1:
        w[-1] = 0.0                      # a text with every token masked
    w = torch.from_numpy(w).to(cuda)
    before = icws_hash.launches["icws_sketch_batch"]
    got = icws_hash.icws_sketch_batch(r, c, b, w)
    want = icws_hash.icws_sketch_batch_plain(r, c, b, w)
    assert icws_hash.launches["icws_sketch_batch"] == before + 1
    _assert_sketch(got, want,
                   icws_hash.sketch_near_ties(r, c, b, w, got[1], want[1]))
    if B > 1:
        assert bool((got[1][-1] == -1).all() and (got[2][-1] == 0).all())
        assert bool((got[0][-1] == 3.0e38).all())


def test_icws_sketch_kernel_equals_plain(cuda):
    rng = np.random.default_rng(3)
    r, c, b = _icws_grids(rng, (32,), 700, cuda)
    w = torch.from_numpy(rng.uniform(0.1, 5.0, 700).astype(np.float32)
                         ).to(cuda)
    before = dict(icws_hash.launches)
    got = icws_hash.icws_sketch(r, c, b, w)
    want = icws_hash.icws_sketch_plain(r, c, b, w)
    assert icws_hash.launches["icws_sketch"] == before["icws_sketch"] + 1
    assert icws_hash.launches["icws_sketch_batch"] == \
        before["icws_sketch_batch"]
    _assert_sketch(got, want,
                   icws_hash.sketch_near_ties(r, c, b, w, got[1], want[1]))


@pytest.mark.parametrize("B,N,K", [(2, 128, 8), (4, 1000, 7), (32, 8192, 64),
                                   (3, 0, 5)])
def test_minhash_kernel_equals_plain(cuda, B, N, K):
    rng = np.random.default_rng(B * N + K)
    tokens = rng.integers(0, 50_000, (B, N)).astype(np.int32)
    tokens[:, N - N // 4:] = -1
    if B > 2:
        tokens[1] = -1
    occ = rng.integers(1, 20, (B, N)).astype(np.int32)
    seeds = rng.integers(0, 2**32, (K,), dtype=np.uint64).astype(np.int64)
    args = [torch.from_numpy(x).to(cuda) for x in (tokens, occ, seeds)]
    before = minhash.launches
    got = minhash.minhash_sketch(*args)
    want = minhash.minhash_sketch_plain(*args)
    assert minhash.launches == before + 1
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_ops_entry_points_on_cuda(cuda):
    rng = np.random.default_rng(8)
    tls = [np.unique(rng.integers(0, 9000, size=n)) for n in (90, 1, 150)]
    wls = [rng.uniform(0.1, 4.0, len(t)) for t in tls]
    before = dict(icws_hash.launches)
    got = ops.cws_sketch_batch(5, 16, tls, wls, device=cuda)
    cpu = ops.cws_sketch_batch(5, 16, tls, wls, device="cpu")
    assert icws_hash.launches["icws_sketch_batch"] == \
        before["icws_sketch_batch"] + 1
    diff = sum(g != c for gr, cr in zip(got, cpu) for g, c in zip(gr, cr))
    assert diff <= 1
    t_star, kint, mina = ops.cws_sketch(5, 16, tls[0], wls[0], device=cuda)
    assert t_star.device.type == "cuda" and t_star.shape == (16,)
    assert icws_hash.launches["icws_sketch"] == before["icws_sketch"] + 1
    before_m = minhash.launches
    sk = ops.multiset_sketch(np.zeros((2, 9), np.int32),
                             np.ones((2, 9), np.int32),
                             np.arange(1, 4, dtype=np.uint32), device=cuda)
    assert sk.shape == (2, 3) and minhash.launches == before_m + 1


def test_pinned_sketch_on_cuda_equals_cpu_plan(cuda, tmp_path):
    docs = _docs(9, n_docs=10)
    Aligner.build(docs, similarity="tfidf", k=16, store=tmp_path / "s",
                  device=cuda)
    server = Aligner.load(tmp_path / "s")
    qs = [d[30:90] for d in docs] + [np.arange(60) + 7000]
    before = icws_hash.launches["icws_sketch_batch"]
    for theta in (0.5, 0.8):
        dev = server.find_batch(qs, theta, options=QueryOptions(
            plan="device", sketch_backend="pallas"))
        cpu = server.find_batch(qs, theta, options=QueryOptions(
            plan="cpu", sketch_backend="pallas"))
        assert [r.to_dict() for r in dev] == [r.to_dict() for r in cpu]
        assert sum(len(r) for r in dev) >= len(docs)
    assert icws_hash.launches["icws_sketch_batch"] == before + 4
