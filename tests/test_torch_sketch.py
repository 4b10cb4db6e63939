"""The port's sketch kernels against the JAX reference, on the CPU.

The plain PyTorch versions — what the wrappers run for CPU tensors — of
``icws_hash_grid``, ``icws_sketch``, ``icws_sketch_batch`` and
``minhash_sketch`` are held against the reference's Pallas kernels in
interpret mode, ``repro_torch.kernels.ops`` against ``repro.kernels.ops``,
and the pinned ``QueryOptions(sketch_backend="pallas")`` slice against the
reference's, on inputs made with numpy from a seed.

Tolerances.  The min-hash is integer: bit-equal.  The ICWS kernels compute
in f32 with torch's ``log``/``exp`` against XLA's, which differ by ulps, so
``a`` agrees within rtol 2e-5 (the reference's own kernel-vs-oracle
tolerance), and ``k_int``/argmin must be equal on every coordinate that is
not a **near-tie**: a coordinate where the reference's two smallest valid
``a`` are within rtol 2e-5 of each other, or where a winner's (the
reference's or the port's) ``lw / r + beta``, recomputed in float64 from
the same f32 inputs, is within 1e-5 of an integer.  Near-ties must be at
most 1 % of the coordinates; their count is printed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Aligner as RefAligner
from repro.core.results import QueryOptions as RefQueryOptions
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels.icws_hash import icws_hash_grid as ref_hash_grid
from repro.kernels.icws_hash import icws_sketch as ref_sketch
from repro.kernels.icws_hash import icws_sketch_batch as ref_sketch_batch
from repro.kernels.minhash_sketch import minhash_sketch as ref_minhash
from repro_torch.api import Aligner
from repro_torch.core.plan import resolve_plan
from repro_torch.core.results import QueryOptions
from repro_torch.kernels import icws_hash, ops

minhash = importlib.import_module("repro_torch.kernels.minhash_sketch")

RTOL = 2e-5          # a / min_a, and the two-smallest near-tie test
INT_TOL = 1e-5       # lw / r + beta this close to an integer is a near-tie
MAX_NEAR = 0.01      # near-ties allowed, as a share of coordinates


def _icws_inputs(rng, shape, T):
    """r, c, beta f32 (*shape, T) and w f32 (T,) as tests/test_kernels.py
    draws them."""
    r = rng.gamma(2.0, 1.0, shape + (T,)).astype(np.float32)
    c = rng.gamma(2.0, 1.0, shape + (T,)).astype(np.float32)
    b = rng.uniform(0, 1, shape + (T,)).astype(np.float32)
    w = rng.uniform(0.1, 5.0, (T,)).astype(np.float32)
    return r, c, b, w


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _near_integer(r, b, w):
    """bool, shaped like r: ``lw / r + beta`` in float64 from the f32
    inputs is within INT_TOL of an integer (masked tokens: False)."""
    return icws_hash.near_integer(*_t(r, b, w), tol=INT_TOL).numpy()


def _sketch_near_ties(r, c, b, w, argt_ref, argt_port):
    """bool (..., K): the near-tie coordinates of a sketch (see module
    docstring); r, c, b (..., K, T) and w (..., T) numpy f32."""
    a = np.stack([np.asarray(ref_oracles.icws_hash_grid_ref(
        jnp.asarray(ri), jnp.asarray(ci), jnp.asarray(bi), jnp.asarray(wi))[1])
        for ri, ci, bi, wi in zip(r.reshape(-1, *r.shape[-2:]),
                                  c.reshape(-1, *r.shape[-2:]),
                                  b.reshape(-1, *r.shape[-2:]),
                                  w.reshape(-1, w.shape[-1]))]).reshape(r.shape)
    valid = np.broadcast_to((w > 0)[..., None, :], a.shape)
    srt = np.sort(np.where(valid, a.astype(np.float64), np.inf), axis=-1)
    near = np.zeros(a.shape[:-1], bool)
    if a.shape[-1] >= 2:
        lo, hi = srt[..., 0], srt[..., 1]
        two = np.isfinite(hi)
        near[two] |= hi[two] - lo[two] <= RTOL * lo[two]
    nint = _near_integer(r, b, w)
    for argt in (argt_ref, argt_port):
        argt = np.asarray(argt).astype(np.int64)
        hit = np.take_along_axis(nint, np.maximum(argt, 0)[..., None],
                                 axis=-1)[..., 0]
        near |= hit & (argt >= 0)
    return near


def _assert_sketch_close(got, want, near, label):
    """got/want: (min_a, argt, kint) numpy; near: the near-tie mask."""
    mina, argt, kint = (np.asarray(x) for x in got)
    mina_r, argt_r, kint_r = (np.asarray(x) for x in want)
    n_near = int(near.sum())
    print(f"{label}: {n_near} near-ties of {near.size} coordinates")
    assert n_near <= MAX_NEAR * near.size
    same = (argt == argt_r) & (kint == kint_r)
    assert (same | near).all(), f"{label}: identities differ off near-ties"
    assert argt.dtype == np.int32 and kint.dtype == np.int32
    assert mina.dtype == np.float32
    np.testing.assert_allclose(mina[same], mina_r[same], rtol=RTOL)


# --------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K,T", [(8, 128), (16, 256), (5, 100), (64, 391),
                                 (1, 1), (9, 129)])
def test_icws_hash_grid_matches_reference(K, T):
    rng = np.random.default_rng(K * 1000 + T)
    r, c, b, w = _icws_inputs(rng, (K,), T)
    w[rng.random(T) < 0.2] = 0.0                 # masked tokens
    kint, a = icws_hash.icws_hash_grid(*_t(r, c, b, w))
    kint_r, a_r = (np.asarray(x) for x in ref_hash_grid(
        *map(jnp.asarray, (r, c, b, w)), interpret=True))
    near = _near_integer(r, b, w)
    n_near = int(near.sum())
    print(f"hash grid ({K}, {T}): {n_near} near-ties of {near.size}")
    assert n_near <= MAX_NEAR * near.size
    kint, a = kint.numpy(), a.numpy()
    assert kint.dtype == np.int32 and a.dtype == np.float32
    same = kint == kint_r
    assert (same | near).all()
    np.testing.assert_allclose(a[same], a_r[same], rtol=RTOL)
    masked = np.broadcast_to(w <= 0, a.shape)
    assert (kint[masked] == 0).all() and (a[masked] == a_r[masked]).all()


@pytest.mark.parametrize("K,T", [(8, 128), (16, 300), (3, 17), (64, 1024)])
def test_icws_sketch_matches_reference(K, T):
    rng = np.random.default_rng(K + T)
    r, c, b, w = _icws_inputs(rng, (K,), T)
    got = icws_hash.icws_sketch(*_t(r, c, b, w))
    want = ref_sketch(*map(jnp.asarray, (r, c, b, w)), interpret=True)
    near = _sketch_near_ties(r, c, b, w, want[1], got[1].numpy())
    _assert_sketch_close([x.numpy() for x in got], want, near,
                         f"sketch ({K}, {T})")


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K,T", [(8, 128), (16, 300), (3, 17)])
def test_icws_sketch_batch_matches_reference(B, K, T):
    """Texts padded to T with w = 0 past their length; with B = 4 the last
    text is fully masked and must return (3.0e38, -1, 0) in both."""
    rng = np.random.default_rng(B * 100 + K + T)
    r, c, b, _ = _icws_inputs(rng, (B, K), T)
    w = rng.uniform(0.1, 5.0, (B, T)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    w[np.arange(T)[None, :] >= lens[:, None]] = 0.0
    if B > 1:
        w[-1] = 0.0
    got = icws_hash.icws_sketch_batch(*_t(r, c, b, w))
    want = ref_sketch_batch(*map(jnp.asarray, (r, c, b, w)), interpret=True)
    near = _sketch_near_ties(r, c, b, w, want[1], got[1].numpy())
    _assert_sketch_close([x.numpy() for x in got], want, near,
                         f"sketch batch ({B}, {K}, {T})")
    if B > 1:
        mina, argt, kint = (x[-1].numpy() for x in got)
        assert (argt == -1).all() and (kint == 0).all()
        assert (mina == np.float32(3.0e38)).all()
        assert (np.asarray(want[1])[-1] == -1).all()


@pytest.mark.parametrize("B,N,K", [(2, 128, 8), (3, 200, 16), (1, 64, 64),
                                   (4, 1000, 7)])
def test_minhash_sketch_matches_reference(B, N, K):
    rng = np.random.default_rng(B * N + K)
    tokens = rng.integers(0, 5000, (B, N)).astype(np.int32)
    tokens[:, N - N // 4:] = -1          # padding tail
    occ = rng.integers(1, 20, (B, N)).astype(np.int32)
    seeds = rng.integers(1, 2**32 - 1, (K,), dtype=np.uint32)
    got = minhash.minhash_sketch(*_t(tokens, occ, seeds.astype(np.int64)))
    want = np.asarray(ref_minhash(jnp.asarray(tokens), jnp.asarray(occ),
                                  jnp.asarray(seeds), interpret=True))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_minhash_sketch_fully_padded_text():
    tokens = np.full((2, 40), -1, np.int32)
    tokens[0, :10] = np.arange(10)
    occ = np.ones((2, 40), np.int32)
    seeds = np.arange(1, 6, dtype=np.uint32)
    got = minhash.minhash_sketch(*_t(tokens, occ, seeds.astype(np.int64)))
    want = np.asarray(ref_minhash(jnp.asarray(tokens), jnp.asarray(occ),
                                  jnp.asarray(seeds), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got[1] == 0xFFFFFFFF).all()


# --------------------------------------------------------------------------
# ops: host grids and the public entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,k,n", [(0, 16, 120), (7, 32, 1), (123, 5, 777),
                                      (2**40 + 3, 9, 64)])
def test_icws_token_params_bit_equal_to_reference(seed, k, n):
    rng = np.random.default_rng(seed % 1000 + n)
    tokens = np.unique(rng.integers(0, 2**40, size=n))
    got = ops.icws_token_params(seed, k, tokens, device="cpu")
    want = ref_ops.icws_token_params(seed, k, tokens)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (k, len(tokens))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _text_lists(rng, B, vocab=5000):
    """Distinct sorted tokens and tf-idf-like weights of B texts of
    varying length."""
    tls, wls = [], []
    for i in range(B):
        n = int(rng.integers(1, 150)) if i else 149
        t = np.unique(rng.integers(0, vocab, size=n))
        tls.append(t)
        wls.append(rng.uniform(0.05, 6.0, len(t)))
    return tls, wls


@pytest.mark.parametrize("B,k", [(1, 16), (5, 32), (12, 8)])
def test_cws_sketch_batch_matches_reference(B, k):
    rng = np.random.default_rng(B * 31 + k)
    tls, wls = _text_lists(rng, B)
    seed = int(rng.integers(1 << 30))
    got = ops.cws_sketch_batch(seed, k, tls, wls, device="cpu")
    want = ref_ops.cws_sketch_batch(seed, k, tls, wls, interpret=True)
    assert len(got) == B and all(len(g) == k for g in got)
    r, c, be, w, _ = ops._batch_grids(seed, k, tls, wls)
    tok_index = [{int(t): i for i, t in enumerate(tl)} for tl in tls]
    argt_r = np.array([[tok_index[b][t] for t, _ in row]
                       for b, row in enumerate(want)])
    argt_p = np.array([[tok_index[b][t] for t, _ in row]
                       for b, row in enumerate(got)])
    near = _sketch_near_ties(r, c, be, w, argt_r, argt_p)
    n_near = int(near.sum())
    print(f"cws_sketch_batch ({B}, {k}): {n_near} near-ties of {near.size}")
    assert n_near <= MAX_NEAR * near.size
    for b in range(B):
        for i in range(k):
            assert near[b, i] or got[b][i] == want[b][i]
            assert isinstance(got[b][i][0], int)
            assert isinstance(got[b][i][1], int)


def test_cws_sketch_matches_reference():
    rng = np.random.default_rng(5)
    tls, wls = _text_lists(rng, 1)
    tokens, weights = tls[0], wls[0]
    t_star, kint, mina = ops.cws_sketch(11, 16, tokens, weights, device="cpu")
    t_r, kint_r, mina_r = ref_ops.cws_sketch(11, 16, tokens, weights,
                                             interpret=True)
    r, c, b = (x.numpy() for x in ops.icws_token_params(11, 16, tokens,
                                                        device="cpu"))
    w = np.asarray(weights, np.float32)
    pos = {int(t): i for i, t in enumerate(tokens)}
    argt_r = np.array([pos[int(t)] for t in np.asarray(t_r)])
    argt_p = np.array([pos[int(t)] for t in t_star.numpy()])
    near = _sketch_near_ties(r, c, b, w, argt_r, argt_p)
    _assert_sketch_close((mina.numpy(), argt_p.astype(np.int32),
                          kint.numpy()),
                         (mina_r, argt_r.astype(np.int32), kint_r), near,
                         "cws_sketch")
    assert t_star.dtype == torch.int64


def test_multiset_sketch_matches_reference():
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 3000, (3, 300)).astype(np.int32)
    tokens[1, 200:] = -1
    occ = rng.integers(1, 9, (3, 300)).astype(np.int32)
    seeds = rng.integers(1, 2**32 - 1, (12,), dtype=np.uint32)
    got = ops.multiset_sketch(tokens, occ, seeds, device="cpu")
    want = np.asarray(ref_ops.multiset_sketch(tokens, occ, seeds,
                                              interpret=True))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    again = ops.multiset_sketch(torch.from_numpy(tokens),
                                torch.from_numpy(occ),
                                torch.from_numpy(seeds.astype(np.int64)),
                                device="cpu")
    assert torch.equal(got, again)


def test_kernels_package_exports_match_reference():
    import repro.kernels as ref_kernels
    import repro_torch.kernels as port_kernels
    names = ["cws_sketch", "cws_sketch_batch", "multiset_sketch",
             "icws_token_params", "icws_hash_grid", "icws_sketch",
             "icws_sketch_batch", "minhash_sketch"]
    for name in names:
        assert name in ref_kernels.__all__ and name in port_kernels.__all__
        assert callable(getattr(port_kernels, name))
    assert port_kernels.minhash_sketch is minhash.minhash_sketch


def test_wrappers_raise_on_other_devices():
    meta = torch.device("meta")
    f = torch.empty((4, 8), dtype=torch.float32, device=meta)
    w = torch.empty(8, dtype=torch.float32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        icws_hash.icws_hash_grid(f, f, f, w)
    with pytest.raises(ValueError, match="unsupported device"):
        icws_hash.icws_sketch(f, f, f, w)
    with pytest.raises(ValueError, match="unsupported device"):
        icws_hash.icws_sketch_batch(f[None], f[None], f[None], w[None])
    with pytest.raises(ValueError, match="unsupported device"):
        minhash.minhash_sketch(
            torch.empty((2, 8), dtype=torch.int32, device=meta),
            torch.empty((2, 8), dtype=torch.int32, device=meta),
            torch.empty(3, dtype=torch.int64, device=meta))
    with pytest.raises(ValueError, match="float32"):
        c = torch.zeros((4, 8), dtype=torch.float32)
        icws_hash.icws_hash_grid(c.double(), c, c, torch.ones(8))
    with pytest.raises(ValueError, match="int64"):
        minhash.minhash_sketch(torch.zeros((2, 8), dtype=torch.int32),
                               torch.zeros((2, 8), dtype=torch.int32),
                               torch.zeros(3, dtype=torch.int32))


def test_ops_default_device_needs_cuda():
    """``device=None`` means CUDA: without a card the entry points raise
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.cws_sketch_batch(0, 4, [np.arange(5)], [np.ones(5)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.multiset_sketch(np.zeros((1, 4), np.int32),
                            np.ones((1, 4), np.int32),
                            np.ones(2, np.uint32))


# --------------------------------------------------------------------------
# the pinned slice end to end, and the pin on the wire
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    """A reference-built tfidf k=16 store of 10 documents x 200 tokens,
    loaded by both packages, and queries cut from it."""
    rng = np.random.default_rng(14)
    docs = [rng.integers(0, 3000, size=200).astype(np.int64)
            for _ in range(10)]
    store = tmp_path_factory.mktemp("pinned") / "store"
    RefAligner.build(docs, similarity="tfidf", k=16, seed=3,
                     pipeline="columnar", store=store)
    qs = []
    for i in range(12):
        d = docs[i % 10]
        o = int(rng.integers(0, 140))
        q = d[o:o + 60].copy()
        sub = rng.random(60) < 0.05
        q[sub] = rng.integers(0, 3000, size=int(sub.sum()))
        qs.append(q)
    qs.append(rng.integers(0, 3000, size=60).astype(np.int64))
    return (RefAligner.load(store), Aligner.load(store, device="cpu"), qs)


@pytest.mark.parametrize("plan", ["cpu", "device"])
def test_pinned_slice_matches_reference(pinned, plan):
    ref, port, qs = pinned
    want_sk = ref.scheme.sketch_batch(qs, backend="pallas")
    got_sk = port.scheme.sketch_batch(qs, backend="pallas",
                                            device="cpu")
    exact = port.scheme.sketch_batch(qs)
    same = [g == w for g, w in zip(got_sk, want_sk)]
    print(f"pinned sketches equal on {sum(same)}/{len(qs)} queries; "
          f"{sum(a != b for g, e in zip(got_sk, exact) for a, b in zip(g, e))}"
          f" coordinates differ from the exact sketch")
    assert sum(same) == len(qs)
    for theta in (0.5, 0.8):
        want = ref.find_batch(qs, theta, options=RefQueryOptions(
            plan="cpu", sketch_backend="pallas"))
        got = port.find_batch(qs, theta, options=QueryOptions(
            plan=plan, sketch_backend="pallas"))
        for i, (g, w) in enumerate(zip(got, want)):
            if same[i]:
                assert g.to_dict() == w.to_dict()
        assert sum(len(g) for g in got) >= 10


def test_pinned_sketch_stage_is_timed(pinned):
    _ref, port, qs = pinned
    stages = {}
    port.find_batch(qs[:3], 0.5, options=QueryOptions(
        plan="device", sketch_backend="pallas"), stage_times=stages)
    assert set(stages) == {"sketch", "probe", "sweep"}
    assert stages["sketch"] > 0


def test_multiset_scheme_ignores_the_pin(tmp_path):
    rng = np.random.default_rng(2)
    docs = [rng.integers(0, 400, size=80).astype(np.int64) for _ in range(4)]
    port = Aligner.build(docs, similarity="multiset", k=8, device="cpu")
    scheme = port.scheme
    assert scheme.sketch_batch(docs, backend="pallas") == \
        scheme.sketch_batch(docs)
    opts = QueryOptions(plan="cpu", sketch_backend="pallas")
    assert [r.to_dict() for r in port.find_batch(docs, 0.8, options=opts)] \
        == [r.to_dict() for r in port.find_batch(
            docs, 0.8, options=QueryOptions(plan="cpu"))]


def test_sketch_pin_round_trips_with_reference():
    for plan in ("cpu", "device"):
        opts = QueryOptions(plan=plan, sketch_backend="pallas")
        wire = opts.to_dict()
        assert wire == {"plan": plan, "sketch_backend": "pallas"}
        assert RefQueryOptions.from_dict(wire).to_dict() == wire
        assert QueryOptions.from_dict(RefQueryOptions(
            plan=plan, sketch_backend="pallas").to_dict()) == opts


def test_sketch_pin_resolves_and_bad_pins_raise():
    for plan in ("cpu", "device"):
        xp = resolve_plan(QueryOptions(plan=plan, sketch_backend="pallas"))
        assert xp.name == plan and xp.sketch_backend == "pallas"
        assert resolve_plan(QueryOptions(plan=plan)).sketch_backend == "exact"
        with pytest.raises(TypeError, match="sketch_backend='device'"):
            resolve_plan(QueryOptions(plan=plan, sketch_backend="device"))
    # values the reference refuses for every plan: refused here too
    from repro.core.plan import resolve_plan as ref_resolve_plan
    with pytest.raises(TypeError):
        ref_resolve_plan(RefQueryOptions(plan="cpu",
                                         sketch_backend="device"))
