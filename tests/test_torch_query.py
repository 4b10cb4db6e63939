"""The port's query path against the JAX reference, end to end.

``repro_torch``'s ``plan="device"`` — run on ``device="cpu"``, where the
kernel wrappers take their plain PyTorch versions — must return the same
``QueryResult.to_dict()`` as the reference's ``plan="cpu"`` over every
scheme and theta, and as the reference's ``plan="device"`` (Pallas in
interpret mode).  Also: the plan registry (default plan, pins, auto),
residency caching, and the port's hygiene — no JAX and no ``repro``
module imported, and no silent CPU continuation where CUDA is absent.
"""

import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the reference package runs on the CPU backend)
import numpy as np
import pytest
import torch

from repro.api import Aligner as RefAligner
from repro.core.results import QueryOptions as RefQueryOptions
from repro_torch.api import Aligner
from repro_torch.core import device_plan as dp
from repro_torch.core.plan import resolve_plan
from repro_torch.core.query import batch_query
from repro_torch.core.results import QueryOptions, QueryResult
from repro_torch.kernels import sweep_grid

ROOT = Path(__file__).resolve().parent.parent

SCHEMES = {
    "tfidf": dict(similarity="tfidf"),
    "weighted": dict(similarity="weighted"),
    "multiset_universal": dict(similarity="multiset"),
    "multiset_mix": dict(similarity="multiset", family="mix"),
}


def _corpus(seed=0, n_docs=12, n=160, vocab=5000):
    """Documents with few repeated tokens (small (query, text) groups) plus
    two repetitive ones (groups too large for the sweep kernel)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, vocab, size=n).astype(np.int64)
            for _ in range(n_docs)]
    docs.append(rng.integers(0, 12, size=n).astype(np.int64))
    docs.append(docs[3].copy())
    return docs


def _queries(docs, seed=1, n=14):
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(n):
        d = docs[i % len(docs)]
        o = int(rng.integers(0, len(d) - 40))
        q = d[o:o + 40].copy()
        sub = rng.random(40) < 0.05
        q[sub] = rng.integers(0, 5000, size=int(sub.sum()))
        qs.append(q)
    qs.append(rng.integers(0, 5000, size=40).astype(np.int64))   # miss
    return qs


def _dicts(results):
    return [r.to_dict() for r in results]


@pytest.fixture(scope="module")
def built():
    """(ref aligner, port aligner) per scheme, built once per module."""
    docs = _corpus()
    return docs, {kind: (RefAligner.build(docs, k=16, seed=5,
                                          pipeline="columnar", **kw),
                         Aligner.build(docs, k=16, seed=5, device="cpu",
                                       **kw))
                  for kind, kw in SCHEMES.items()}


@pytest.mark.parametrize("kind", list(SCHEMES))
@pytest.mark.parametrize("theta", [0.5, 0.8])
def test_device_plan_matches_reference_cpu_plan(built, kind, theta):
    docs, aligners = built
    ref, port = aligners[kind]
    qs = _queries(docs)
    want = ref.find_batch(qs, theta, options=RefQueryOptions(plan="cpu"))
    got = port.find_batch(qs, theta)                 # plan="device"
    assert _dicts(got) == _dicts(want)
    assert sum(len(r) for r in got) > 0
    # the port's own cpu plan agrees too
    assert _dicts(port.find_batch(
        qs, theta, options=QueryOptions(plan="cpu"))) == _dicts(want)


def test_device_plan_matches_reference_device_plan(built):
    docs, aligners = built
    ref, port = aligners["tfidf"]
    qs = _queries(docs, seed=2)
    want = ref.find_batch(qs, 0.6, options=RefQueryOptions(plan="device"))
    assert _dicts(port.find_batch(qs, 0.6)) == _dicts(want)


def test_device_plan_uses_sweep_kernel_and_host_large_groups(built,
                                                             monkeypatch):
    """Both sweep routes run on this corpus: small groups through the
    sweep kernel's wrapper, large ones on the host (counted)."""
    docs, aligners = built
    _ref, port = aligners["multiset_universal"]
    calls = []
    orig = sweep_grid.sweep

    def counting(*args):
        calls.append(tuple(args[1].shape))
        return orig(*args)

    monkeypatch.setattr(sweep_grid, "sweep", counting)
    dp.reset_transfer_stats()
    port.find_batch(_queries(docs), 0.5)
    stats = dp.transfer_stats()
    assert calls and all(S <= 32 for _G, S in calls)
    assert stats["host_large_groups"] > 0
    assert stats["batches"] == 1


def test_arena_uploaded_once_per_index_and_device(built):
    docs, aligners = built
    _ref, port = aligners["weighted"]
    port.find_batch(_queries(docs), 0.8)
    dp.reset_transfer_stats()
    for theta in (0.5, 0.8):
        port.find_batch(_queries(docs), theta)
    assert dp.transfer_stats()["arena_uploads"] == 0
    cached = port.index._device_arena
    assert cached[0] is port.index.arena()
    assert cached[2].offsets.dtype == torch.int64


def test_empty_arena_returns_empty_results():
    from repro_torch.core.columnar import ColumnarBuilder
    from repro_torch.core.schemes import make_scheme
    index = ColumnarBuilder(scheme=make_scheme("multiset", k=4)).freeze()
    assert len(index.arena().keys) == 0
    dp.reset_transfer_stats()
    res = batch_query(index, [np.arange(10)], 0.5, device="cpu")
    assert res == [[]]
    assert dp.transfer_stats()["arena_uploads"] == 0


def test_plan_registry():
    assert QueryOptions().plan == "device"
    assert resolve_plan(None).name == "device"
    assert resolve_plan(QueryOptions()).fused
    assert resolve_plan("cpu").probe_backend == "numpy"
    assert resolve_plan("auto").name == \
        ("device" if torch.cuda.is_available() else "cpu")
    assert resolve_plan(QueryOptions(sketch_backend="pallas")
                        ).sketch_backend == "pallas"
    with pytest.raises(TypeError, match="sketch_backend='device'"):
        resolve_plan(QueryOptions(sketch_backend="device"))
    with pytest.raises(TypeError):
        resolve_plan(QueryOptions(plan="cpu", sweep="device"))
    with pytest.raises(ValueError, match="unknown execution plan"):
        resolve_plan("tpu")


def test_wire_schema_round_trips_with_reference(built):
    docs, aligners = built
    ref, port = aligners["tfidf"]
    res = port.find_batch(_queries(docs)[:3], 0.5)
    from repro.core.results import QueryResult as RefQueryResult
    for r in res:
        wire = r.to_json()
        assert RefQueryResult.from_json(wire).to_dict() == r.to_dict()
        assert QueryResult.from_json(wire) == r
    opts = QueryOptions(plan="cpu", sweep="grouped")
    assert RefQueryOptions.from_dict(opts.to_dict()).to_dict() == \
        opts.to_dict()
    assert QueryOptions.from_dict(RefQueryOptions(plan="cpu").to_dict()) == \
        QueryOptions(plan="cpu")
    with pytest.raises(ValueError, match="unknown query options"):
        QueryOptions.from_dict({"plan": "cpu", "fanout": "serial"})


def test_load_without_device_needs_cuda(tmp_path):
    """``Aligner.load(path)`` runs on CUDA by default: it raises where CUDA
    is absent and never carries on on the CPU."""
    Aligner.build(_corpus(n_docs=3), k=4, store=tmp_path / "s",
                  device="cpu")
    if torch.cuda.is_available():
        assert Aligner.load(tmp_path / "s").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Aligner.load(tmp_path / "s")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch_query(Aligner.load(tmp_path / "s", device="cpu").index,
                        [np.arange(8)], 0.5)
    port = Aligner.load(tmp_path / "s", device="cpu")
    assert port.device.type == "cpu"
    assert port.find_batch([np.arange(8)], 0.5,
                           options=QueryOptions(plan="cpu"))[0].theta == 0.5


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import repro_torch, repro_torch.api, repro_torch.core.device_plan\n"
        "import repro_torch.kernels.probe_arena, "
        "repro_torch.kernels.sweep_grid, repro_torch.data.tokenizer\n"
        "import repro_torch.kernels.icws_hash, "
        "repro_torch.kernels.minhash_sketch, repro_torch.kernels.ops, "
        "repro_torch.kernels.common\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_needs_a_card():
    """Without CUDA the smoke test exits nonzero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
