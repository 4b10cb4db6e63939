"""The port's CUDA kernels on the card (marker ``gpu``).

Run on a machine with a CUDA card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (outputs must be equal: both are integer-exact), and the device
plan on ``device="cuda"`` against the port's ``plan="cpu"``.  Whether a
card is present is decided inside the ``cuda`` fixture, so every worker
collects the same tests; without a card they skip.  This file imports no
JAX: the card's machine has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import Aligner
from repro_torch.core.columnar import ColumnarBuilder
from repro_torch.core.device_plan import _encode_queries, device_arena
from repro_torch.core.frozen import MODE_PACKED, PACK_SHIFT
from repro_torch.core.results import QueryOptions
from repro_torch.core.schemes import make_scheme
from repro_torch.kernels import probe_arena, sweep_grid

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
