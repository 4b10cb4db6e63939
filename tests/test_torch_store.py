"""Store format v1 as the seam between the JAX reference and the port.

A store built by ``repro`` and one built by ``repro_torch`` from the same
corpus, seed and k hold byte-identical ``.npy`` files and equal manifests;
each package loads the other's store with identical arrays; the port's
``SearchIndex.from_state`` takes the reference's ``state_dict`` and
``scheme_from_spec`` the reference's spec JSON unchanged; a CRC mismatch
raises on load.
"""

import json

import jax  # noqa: F401  (the reference package runs on the CPU backend)
import numpy as np
import pytest
import torch  # noqa: F401  (the port's device side)

from repro.api import Aligner as RefAligner
from repro.core.columnar import ColumnarBuilder as RefColumnarBuilder
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.core.schemes import scheme_spec as ref_scheme_spec
from repro.core.store import load_index as ref_load_index
from repro_torch.api import Aligner
from repro_torch.core.columnar import ColumnarBuilder
from repro_torch.core.schemes import scheme_from_spec
from repro_torch.core.search import SearchIndex
from repro_torch.core.store import load_index

SCHEMES = {
    "tfidf": dict(similarity="tfidf"),
    "weighted": dict(similarity="weighted"),
    "multiset_universal": dict(similarity="multiset"),
    "multiset_mix": dict(similarity="multiset", family="mix"),
}


def _docs(seed=0, n_docs=8, n=150, vocab=300):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, vocab, size=n).astype(np.int64)
            for _ in range(n_docs)]
    docs[-1] = docs[2].copy()
    return docs


def _build_both(tmp_path, kind, k=8, seed=3):
    docs = _docs()
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    RefAligner.build(docs, k=k, seed=seed, pipeline="columnar",
                     store=ref_dir, **SCHEMES[kind])
    Aligner.build(docs, k=k, seed=seed, pipeline="columnar", store=port_dir,
                  device="cpu", **SCHEMES[kind])
    return ref_dir, port_dir


def _arrays(index):
    out = {}
    for i, t in enumerate(index.tables):
        for name in ("keys", "offsets", "windows"):
            out[f"t{i}.{name}"] = np.asarray(getattr(t, name))
        out[f"t{i}.meta"] = (t.kind, t.kint_min)
    ar = index.arena()
    for name in ("keys", "coords", "offsets", "windows"):
        out[f"arena.{name}"] = np.asarray(getattr(ar, name))
    out["arena.meta"] = (ar.mode, ar.max_run, list(ar.kinds),
                         list(np.asarray(ar.kint_mins)))
    out["meta"] = (index.method, index.num_texts, index.num_windows,
                   list(index.text_lengths))
    return out


def _assert_same_arrays(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("kind", list(SCHEMES))
def test_store_files_byte_identical(tmp_path, kind):
    ref_dir, port_dir = _build_both(tmp_path, kind)
    ref_files = sorted(p.name for p in ref_dir.iterdir())
    assert ref_files == sorted(p.name for p in port_dir.iterdir())
    npy = [f for f in ref_files if f.endswith(".npy")]
    assert len(npy) == 3 * 8 + 4
    for name in npy:
        assert (ref_dir / name).read_bytes() == \
            (port_dir / name).read_bytes(), name
    for name in ("manifest.json", "aligner.json"):
        assert json.loads((ref_dir / name).read_text()) == \
            json.loads((port_dir / name).read_text()), name


@pytest.mark.parametrize("kind", list(SCHEMES))
def test_store_loads_both_ways(tmp_path, kind):
    ref_dir, port_dir = _build_both(tmp_path, kind)
    # the port serves the reference's store, the reference the port's
    _assert_same_arrays(_arrays(load_index(ref_dir, mmap=True)),
                        _arrays(ref_load_index(ref_dir, mmap=True)))
    _assert_same_arrays(_arrays(ref_load_index(port_dir, mmap=True)),
                        _arrays(load_index(port_dir, mmap=True)))
    assert load_index(port_dir, mmap=True).is_mmap()


@pytest.mark.parametrize("kind", ["tfidf", "multiset_mix"])
def test_from_state_takes_reference_state_dict(kind):
    docs = _docs(1)
    ref_scheme = ref_make_scheme(seed=9, k=8, corpus=docs, **SCHEMES[kind])
    ref_index = RefColumnarBuilder(scheme=ref_scheme).build(docs).freeze()
    spec = json.loads(json.dumps(ref_scheme_spec(ref_scheme)))
    scheme = scheme_from_spec(spec)
    index = SearchIndex.from_state(scheme, ref_index.state_dict())
    _assert_same_arrays(_arrays(index), _arrays(ref_index))
    # the rebuilt hash family sketches exactly like the reference's
    qs = [d[10:60] for d in docs[:3]]
    assert scheme.sketch_batch(qs) == ref_scheme.sketch_batch(qs)
    assert [scheme.sketch(q) for q in qs] == \
        [ref_scheme.sketch(q) for q in qs]
    # and the port's own build of the same corpus is the same index
    ported = ColumnarBuilder(scheme=scheme).build(docs).freeze()
    _assert_same_arrays(_arrays(ported), _arrays(ref_index))


def test_crc_mismatch_raises(tmp_path):
    _ref_dir, port_dir = _build_both(tmp_path, "tfidf")
    path = port_dir / "table_03.windows.npy"
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum mismatch"):
        load_index(port_dir)
    with pytest.raises(ValueError, match="checksum mismatch"):
        Aligner.load(port_dir, device="cpu")


def test_unported_build_options_raise():
    docs = _docs()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Aligner.build(docs, method="allalign", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Aligner.build(docs, pipeline="dict", device="cpu")
    with pytest.raises(ValueError, match="unknown partition method"):
        Aligner.build(docs, method="nope", device="cpu")
