#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py                 # 400 docs x 1000 tokens, seed 0
    python3 chip_smoke.py --docs 100      # a cut corpus (printed as a cut)

Phases, none of them caught — any failure exits nonzero:

1. Device: the card's name and power limit, the device count; the four
   CUDA sources of ``src/repro_torch/csrc`` built (one ``nvcc`` each,
   started together), with the compiler's register/shared-memory report.
2. Main path, through the entry points a user calls, on two corpora of
   400 documents x 1000 tokens over the 50,257-token vocabulary:
   ``Aligner.build(pipeline="columnar", store=...)`` of a tfidf k=32 store,
   ``Aligner.load(mmap=True)``, then batches of 64 queries with
   ``plan="device"``; every batch's ``QueryResult.to_dict()`` must equal
   the ``plan="cpu"`` result.  The kernels' launch counters are set to 0
   just before and read just after each corpus's device batches.

   * ``uniform`` (the main path of the report): uniform tokens, 8 batches
     at theta=0.8 and 2 at theta=0.5.  Distinctive documents give small
     (query, text) window groups, the regime of the repo's device-plan
     benchmark (``benchmarks/bench_query.py:_dup_corpus``); both kernels
     must launch.
   * ``zipf``: Zipf(1.3) tokens as ``benchmarks/common.py:zipf_text``
     draws them, 2 batches at theta=0.8 and 1 at theta=0.5 (each such
     batch sweeps thousands of large groups on the host, in both plans).
     Every query collides with every document through the frequent
     tokens, every kept group holds more than 32 windows, so the sweep is
     all on the host (``host_large_groups``) and the sweep kernel is not
     expected to launch; the probe kernel must.

   Queries: 75 % are 120-token passages cut from indexed documents with
   5 % of their tokens substituted, 25 % are fresh texts.
3. The sketch paths, each driven through its user entry point with every
   launch count set to 0 just before and read just after:

   * ``pinned``: the uniform store serves 4 of its batches (3 at
     theta=0.8, 1 at 0.5) with ``QueryOptions(plan="device",
     sketch_backend="pallas")``; ``icws_sketch_batch`` must launch once
     per batch, the probe and the sweep must launch, and every batch must
     equal ``plan="cpu"`` with the same pin.  Printed: the stage seconds
     with the host r/c/beta grid build on its own, queries/s beside the
     exact-sketch device plan's on the same batches, the identity
     mismatch rate of the pinned sketch against the exact host sketch
     (reported, not gated), and passage recall with and without the pin;
   * ``ops.cws_sketch`` of one uniform document (``icws_sketch``);
   * ``repro_torch.kernels.icws_hash_grid`` over the distinct (document,
     token) columns of all uniform documents with their tfidf weights,
     K=32 (``icws_hash_grid``);
   * ``ops.multiset_sketch`` of the uniform documents as a (400, 1000)
     batch with their occurrence indices, K=32, and at
     ``benchmarks/bench_sketch_kernels.py``'s largest shape (32, 8192, 64)
     (``minhash_sketch``, 2 launches).
4. Kernels against their plain PyTorch versions on the card: the probe on
   both corpora's arenas (the main path's own probes, plus seeded hits,
   misses, keys >= 2**63 and invalid probes on the uniform arena), on a
   packed k=160 arena and on a mix-hash coord arena with duplicate keys
   across coordinates; the sweep on the main path's real bucketed groups
   and on seeded groups for every S in 1..32 with padding and zero-width
   rects.  Outputs must be equal.  The sketch kernels on their paths' own
   inputs, ``icws_sketch_batch`` also on seeded grids with fully masked
   texts: the min-hash must be bit-equal; the ICWS kernels' identities
   (argmin, k_int) must be equal off near-ties
   (``icws_hash.sketch_near_ties``: the two smallest ``a`` within rtol
   2e-5, or a winner's ``lw / r + beta`` within 1e-5 of an integer), whose
   count is printed, and ``a`` within rtol 2e-5.
5. Report: per-kernel device times at the uniform main path's shapes
   (CUDA events around replays of a CUDA graph of the calls, after
   warm-up; the wall time per eager call between CUDA events is printed
   beside it) with the plain versions, the bound and a library call; per corpus the resident arena bytes,
   host_large_groups, stage times, queries/s and peak device memory; a
   ``kernels`` JSON line; and last the ``{"ok": true, "device": ...}``
   line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

VOCAB = 50_257
K = 32
DOC_LEN = 1000
QUERY_LEN = 120
BATCH = 64
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
INT_OPS_PER_S = 67e12            # H100 SXM non-tensor 32-bit rate
# special-function unit (log2/exp2) results: 16 per clock per SM on
# compute capability 9.0 (CUDA C++ Programming Guide, throughput table),
# 132 SMs at the 1,980 MHz boost clock
SFU_OPS_PER_S = 132 * 16 * 1.98e9
PINNED_BATCHES = (0, 1, 2, 8)    # uniform batches: 3 at theta 0.8, 1 at 0.5
MINHASH_BENCH_SHAPE = (32, 8192, 64)   # bench_sketch_kernels.py's largest
DEVICE = "cuda"                  # the kernel checks' device


def uniform_tokens(n: int, rng) -> np.ndarray:
    return rng.integers(0, VOCAB, size=n, dtype=np.int64)


def zipf_tokens(n: int, rng) -> np.ndarray:
    """OWT-like token ids, as ``benchmarks/common.py:zipf_text`` draws
    them."""
    return np.minimum(rng.zipf(1.3, size=n) - 1, VOCAB - 1).astype(np.int64)


CORPORA = {"uniform": (uniform_tokens, (0.8,) * 8 + (0.5,) * 2),
           "zipf": (zipf_tokens, (0.8, 0.8, 0.5))}


def make_workload(corpus: str, n_docs: int, seed: int):
    """(docs, batches): batches is a list of (theta, queries, sources),
    sources[i] the document a passage was cut from (-1 for fresh)."""
    draw, thetas = CORPORA[corpus]
    rng = np.random.default_rng(seed)
    docs = [draw(DOC_LEN, np.random.default_rng(seed * 1_000_003 + i))
            for i in range(n_docs)]
    n_pass = BATCH * 3 // 4
    batches = []
    for theta in thetas:
        qs, src = [], []
        for _ in range(n_pass):
            d = int(rng.integers(n_docs))
            o = int(rng.integers(0, DOC_LEN - QUERY_LEN + 1))
            q = docs[d][o:o + QUERY_LEN].copy()
            sub = rng.random(QUERY_LEN) < 0.05
            q[sub] = draw(int(sub.sum()), rng)
            qs.append(q)
            src.append(d)
        for _ in range(BATCH - n_pass):
            qs.append(draw(QUERY_LEN, rng))
            src.append(-1)
        batches.append((theta, qs, src))
    return docs, batches


def call_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` between two CUDA events: the
    stream's wall time, which includes the host's launch overhead when
    the host cannot keep the card busy."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, *, reps: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call of ``fn``: ``reps`` calls are
    captured once into a CUDA graph, and ``replays`` replays of the graph
    are timed between two CUDA events.  The replays launch the captured
    kernels back to back, so the Python launch overhead that
    :func:`call_ms` includes stays out of this time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    if not ms > 0:
        raise AssertionError(f"graph replay timed at {ms} ms")
    return ms


def _max_abs_err(pairs) -> int:
    worst = 0
    for got, want in pairs:
        if got.shape != want.shape:
            raise AssertionError(f"shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
        if got.numel():
            worst = max(worst, int((got.long() - want.long()).abs().max()))
    return worst


# --------------------------------------------------------------------------
# phase 1: device and kernel build
# --------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{kind} count {count}")
    t0 = time.perf_counter()
    _build.build(_build.SOURCES)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return {"smi": smi, "kind": kind, "count": count}


# --------------------------------------------------------------------------
# phase 2: the main path
# --------------------------------------------------------------------------

def _minhash_module():
    # the package exports the function under the module's name
    return importlib.import_module("repro_torch.kernels.minhash_sketch")


def zero_counts() -> None:
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels import icws_hash, probe_arena, sweep_grid
    probe_arena.launches = 0
    sweep_grid.launches = 0
    for name in icws_hash.launches:
        icws_hash.launches[name] = 0
    _minhash_module().launches = 0


def read_counts() -> dict:
    """Every kernel's launch count, by kernel (entry point) name."""
    from repro_torch.kernels import icws_hash, probe_arena, sweep_grid
    return {"probe_arena": probe_arena.launches,
            "sweep_grid": sweep_grid.launches, **icws_hash.launches,
            "minhash_sketch": _minhash_module().launches}


class _Recorder:
    """Wraps a kernel module's entry point to keep the inputs of every
    call, for the phase-3 comparisons and timings (the device plan never
    writes to a kernel's inputs, so references suffice)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls: list = []
        setattr(module, name, self)

    def __call__(self, *args):
        self.calls.append(args)
        return self.orig(*args)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def phase_main_path(corpus: str, n_docs: int, seed: int, workdir: Path,
                    need_sweep: bool) -> dict:
    """Build, load and serve one corpus; the kernels' launch counters are
    set to 0 just before its device batches and read just after."""
    import torch

    from repro_torch.api import Aligner
    from repro_torch.core import device_plan as dp
    from repro_torch.core.results import QueryOptions
    from repro_torch.kernels import probe_arena, sweep_grid

    docs, batches = make_workload(corpus, n_docs, seed)
    store = workdir / f"store-{corpus}"
    t0 = time.perf_counter()
    Aligner.build(docs, similarity="tfidf", k=K, seed=0,
                  pipeline="columnar", store=store)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    server = Aligner.load(store, mmap=True)
    t_load = time.perf_counter() - t0
    print(f"[{corpus}] store: {n_docs} docs x {DOC_LEN} tokens, "
          f"{server.num_windows} windows, build {t_build:.1f} s, "
          f"load {t_load:.2f} s")

    rec_probe = _Recorder(probe_arena, "arena_probe")
    rec_sweep = _Recorder(sweep_grid, "sweep")
    probe_per_batch, sweep_per_batch = [], []
    dp.reset_transfer_stats()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stages: dict = {}
    batch_s = []
    results = []
    for theta, qs, _src in batches:
        n_p, n_s = len(rec_probe.calls), len(rec_sweep.calls)
        t0 = time.perf_counter()
        res = server.find_batch(qs, theta, stage_times=stages)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        results.append(res)
        probe_per_batch.append(len(rec_probe.calls) - n_p)
        sweep_per_batch.append(len(rec_sweep.calls) - n_s)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = dp.transfer_stats()
    rec_probe.restore()
    rec_sweep.restore()

    # the cpu plan (NumPy) on the same batches: results must be identical
    hits = fresh_hits = found = n_pass = 0
    cpu_s = []
    for (theta, qs, src), res in zip(batches, results):
        t0 = time.perf_counter()
        ref = server.find_batch(qs, theta, options=QueryOptions(plan="cpu"))
        cpu_s.append(time.perf_counter() - t0)
        got = [r.to_dict() for r in res]
        want = [r.to_dict() for r in ref]
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            raise AssertionError(f"[{corpus}] theta={theta}: plan='device' "
                                 f"differs from plan='cpu' at query {bad}")
        for r, s in zip(res, src):
            hits += len(r)
            if s < 0:
                fresh_hits += len(r)
            else:
                n_pass += 1
                found += any(m.doc_id == s for m in r)
    n_queries = sum(len(qs) for _t, qs, _s in batches)
    print(f"[{corpus}] main path: {len(batches)} batches x {BATCH} queries "
          f"(theta {[t for t, _q, _s in batches]}), plan='device' == "
          f"plan='cpu' on every batch; {hits} matches, passage recall "
          f"{found}/{n_pass}, fresh-text matches {fresh_hits}")
    if found < 0.9 * n_pass:
        raise AssertionError(f"[{corpus}] passage recall {found}/{n_pass} "
                             "< 90 %")
    required = ("probe_arena", "sweep_grid") if need_sweep else \
        ("probe_arena",)
    for name in required:
        if launches[name] == 0:
            raise AssertionError(f"[{corpus}] kernel {name} was not launched "
                                 "on the main path")
    print(f"[{corpus}] launches on the main path: {launches} (probe per "
          f"batch {probe_per_batch}, sweep per batch {sweep_per_batch})")
    print(f"[{corpus}] resident arena bytes: {stats['arena_bytes']} "
          f"(uploads {stats['arena_uploads']})")
    print(f"[{corpus}] host_large_groups: {stats['host_large_groups']}")
    print(f"[{corpus}] transfer per batch: h2d "
          f"{stats['h2d_bytes'] / len(batches):.0f} B, d2h "
          f"{stats['d2h_bytes'] / len(batches):.0f} B")
    print(f"[{corpus}] stage seconds (device plan, all batches): " +
          json.dumps(stages))
    steady = sum(len(qs) for _t, qs, _s in batches[1:]) / sum(batch_s[1:])
    print(f"[{corpus}] batch seconds: device plan {batch_s} (the first "
          f"includes the arena upload); cpu plan {cpu_s}")
    print(f"[{corpus}] queries/s (host clock): device plan {steady} over "
          f"batches 2-{len(batches)}, {n_queries / sum(batch_s)} with the "
          f"first; cpu plan {n_queries / sum(cpu_s)}")
    print(f"[{corpus}] peak device memory: {peak} bytes")
    return {"server": server, "docs": docs, "batches": batches,
            "launches": launches, "recall": (found, n_pass),
            "probe_calls": rec_probe.calls, "sweep_calls": rec_sweep.calls,
            "probe_per_batch": probe_per_batch,
            "sweep_per_batch": sweep_per_batch}


# --------------------------------------------------------------------------
# phase 3: the sketch paths
# --------------------------------------------------------------------------

def _passage_recall(results, batches) -> tuple[int, int]:
    """(passages whose source document is among their matches, passages)
    over per-batch result lists."""
    found = n_pass = 0
    for res, (_theta, _qs, sources) in zip(results, batches):
        for r, s in zip(res, sources):
            if s >= 0:
                n_pass += 1
                found += any(m.doc_id == s for m in r)
    return found, n_pass


class _Timed:
    """Wraps a module function to add up the wall seconds of its calls."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.seconds, self.calls = 0.0, 0
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.orig(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1

    def restore(self):
        setattr(self.module, self.name, self.orig)


def phase_pinned(leg: dict) -> dict:
    """The uniform store served with ``sketch_backend="pallas"``: counts
    set to 0 just before the pinned device batches and read just after."""
    import torch

    from repro_torch.core.results import QueryOptions
    from repro_torch.kernels import icws_hash, ops

    server = leg["server"]
    batches = [leg["batches"][i] for i in PINNED_BATCHES
               if i < len(leg["batches"])]
    pinned = QueryOptions(plan="device", sketch_backend="pallas")
    rec = _Recorder(icws_hash, "icws_sketch_batch")
    grid_build = _Timed(ops, "_batch_grids")
    zero_counts()
    stages: dict = {}
    batch_s, results = [], []
    for theta, qs, _src in batches:
        t0 = time.perf_counter()
        results.append(server.find_batch(qs, theta, options=pinned,
                                         stage_times=stages))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    launches = read_counts()
    rec.restore()
    grid_build.restore()
    if launches["icws_sketch_batch"] != len(batches):
        raise AssertionError(f"[pinned] icws_sketch_batch launched "
                             f"{launches['icws_sketch_batch']} times for "
                             f"{len(batches)} batches")
    for name in ("probe_arena", "sweep_grid"):
        if launches[name] == 0:
            raise AssertionError(f"[pinned] kernel {name} was not launched")

    cpu_pinned = QueryOptions(plan="cpu", sketch_backend="pallas")
    exact_s, exact_res = [], []
    for (theta, qs, _src), res in zip(batches, results):
        ref = server.find_batch(qs, theta, options=cpu_pinned)
        if [r.to_dict() for r in res] != [r.to_dict() for r in ref]:
            raise AssertionError(f"[pinned] theta={theta}: plan='device' "
                                 "differs from plan='cpu' with the pin")
        t0 = time.perf_counter()
        exact_res.append(server.find_batch(qs, theta))
        torch.cuda.synchronize()
        exact_s.append(time.perf_counter() - t0)

    scheme = server.scheme
    differ = coords = 0
    for _theta, qs, _src in batches:
        pin = scheme.sketch_batch(qs, backend="pallas", device=server.device)
        exact = scheme.sketch_batch(qs)
        differ += sum(a != b for p, e in zip(pin, exact)
                      for a, b in zip(p, e))
        coords += len(qs) * scheme.k
    rec_pin = _passage_recall(results, batches)
    rec_exact = _passage_recall(exact_res, batches)
    n_queries = sum(len(qs) for _t, qs, _s in batches)
    print(f"[pinned] {len(batches)} batches x {BATCH} queries (theta "
          f"{[t for t, _q, _s in batches]}) with sketch_backend='pallas': "
          f"plan='device' == plan='cpu' on every batch; launches {launches}")
    print("[pinned] stage seconds: " + json.dumps(stages) +
          f"; of the sketch stage, host r/c/beta grid build "
          f"{grid_build.seconds} s over {grid_build.calls} calls")
    print(f"[pinned] batch seconds: pinned {batch_s}; exact-sketch device "
          f"plan {exact_s}")
    print(f"[pinned] queries/s (host clock): pinned {n_queries / sum(batch_s)}"
          f", exact-sketch device plan {n_queries / sum(exact_s)}")
    print(f"[pinned] identity mismatch against the exact sketch: {differ}/"
          f"{coords} coordinates = {differ / coords}")
    print(f"[pinned] passage recall: pinned {rec_pin[0]}/{rec_pin[1]}, "
          f"exact {rec_exact[0]}/{rec_exact[1]}")
    return {"launches": launches, "sketch_calls": rec.calls}


def occurrence_index(tokens: np.ndarray) -> np.ndarray:
    """int32 1-based occurrence index of each token within ``tokens``."""
    order = np.argsort(tokens, kind="stable")
    s = tokens[order]
    first = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    run_start = np.repeat(first, np.diff(np.r_[first, len(s)]))
    occ = np.empty(len(s), np.int32)
    occ[order] = np.arange(len(s)) - run_start + 1
    return occ


def phase_sketch_paths(leg: dict, seed: int) -> dict:
    """``ops.cws_sketch``, ``kernels.icws_hash_grid`` and
    ``ops.multiset_sketch`` each driven with the counts set to 0 just
    before and read just after."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.kernels import icws_hash, ops

    server, docs = leg["server"], leg["docs"]
    scheme, dev = server.scheme, server.device
    out = {"launches": {}}

    # one text through ops.cws_sketch
    toks, freqs = np.unique(docs[0], return_counts=True)
    rec = _Recorder(icws_hash, "icws_sketch")
    zero_counts()
    t_star, kint, _mina = ops.cws_sketch(scheme.seed, K, toks,
                                         scheme.weight(toks, freqs),
                                         device=dev)
    torch.cuda.synchronize()
    out["launches"]["icws_sketch"] = read_counts()["icws_sketch"]
    rec.restore()
    if out["launches"]["icws_sketch"] == 0:
        raise AssertionError("[cws_sketch] icws_sketch was not launched")
    exact = scheme.sketch(docs[0])
    differ = sum((t, k) != e for t, k, e in zip(t_star.tolist(),
                                                kint.tolist(), exact))
    print(f"[cws_sketch] one document ({len(toks)} distinct tokens, k={K}): "
          f"{differ}/{K} coordinates differ from the exact sketch; "
          f"launches {read_counts()}")
    out["single"] = rec.calls[0]

    # the hash grid over every document's distinct (token, weight) columns
    cols_t, cols_w = [], []
    for d in docs:
        t, f = np.unique(d, return_counts=True)
        cols_t.append(t)
        cols_w.append(scheme.weight(t, f))
    tokens = np.concatenate(cols_t)
    t0 = time.perf_counter()
    r, c, b = ops.icws_token_params(scheme.seed, K, tokens, device=dev)
    w = torch.from_numpy(np.concatenate(cols_w).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    t_params = time.perf_counter() - t0
    zero_counts()
    kint_g, a_g = kernels.icws_hash_grid(r, c, b, w)
    torch.cuda.synchronize()
    out["launches"]["icws_hash_grid"] = read_counts()["icws_hash_grid"]
    if out["launches"]["icws_hash_grid"] == 0:
        raise AssertionError("[hash grid] icws_hash_grid was not launched")
    if kint_g.shape != (K, len(tokens)) or \
            not bool(torch.isfinite(a_g).all()):
        raise AssertionError("[hash grid] wrong shape or non-finite a")
    print(f"[hash grid] {len(docs)} documents: (K, T) = ({K}, "
          f"{len(tokens)}), host r/c/beta grids {t_params} s; launches "
          f"{read_counts()}")
    out["grid"] = (r, c, b, w)

    # min-hash sketches of the corpus and at the benchmark's largest shape
    rng = np.random.default_rng(seed + 29)
    corpus_tok = np.stack(docs).astype(np.int32)
    corpus_occ = np.stack([occurrence_index(d) for d in docs])
    corpus_seeds = rng.integers(1, 2**31, (K,), dtype=np.uint32)
    B, N, KB = MINHASH_BENCH_SHAPE
    bench_tok = rng.integers(0, 50_000, (B, N)).astype(np.int32)
    bench_occ = rng.integers(1, 50, (B, N)).astype(np.int32)
    bench_seeds = rng.integers(1, 2**31, (KB,), dtype=np.uint32)
    mh = _minhash_module()
    rec = _Recorder(mh, "minhash_sketch")
    zero_counts()
    corpus_sk = ops.multiset_sketch(corpus_tok, corpus_occ, corpus_seeds,
                                    device=dev)
    bench_sk = ops.multiset_sketch(bench_tok, bench_occ, bench_seeds,
                                   device=dev)
    torch.cuda.synchronize()
    out["launches"]["minhash_sketch"] = read_counts()["minhash_sketch"]
    rec.restore()
    if out["launches"]["minhash_sketch"] != 2:
        raise AssertionError("[multiset] minhash_sketch launched "
                             f"{out['launches']['minhash_sketch']} times")
    for sk, shape in ((corpus_sk, (len(docs), K)), (bench_sk, (B, KB))):
        if tuple(sk.shape) != shape or int(sk.min()) < 0 or \
                int(sk.max()) > 0xFFFFFFFF:
            raise AssertionError("[multiset] sketch of the wrong shape or "
                                 "out of the uint32 range")
    dup = int((corpus_sk[:, None, :] == corpus_sk[None, :, :]).all(-1).sum()
              - len(docs))
    print(f"[multiset] sketches (B, N, K) = ({len(docs)}, {DOC_LEN}, {K}) "
          f"and {MINHASH_BENCH_SHAPE}; identical document sketches off the "
          f"diagonal: {dup}; launches {read_counts()}")
    out["minhash"] = rec.calls
    return out


# --------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# --------------------------------------------------------------------------

def _probe_cases(arena, rng, n: int):
    """Seeded (pkeys u64, coords u16, valid bool) probes on ``arena``:
    hits, hits marked invalid, misses and keys >= 2**63."""
    from repro_torch.core.frozen import MODE_PACKED, PACK_SHIFT
    keys = np.asarray(arena.keys)
    slots = rng.integers(0, len(keys), size=n)
    if arena.mode == MODE_PACKED:
        hk = keys[slots] & np.uint64((1 << PACK_SHIFT) - 1)
        hc = (keys[slots] >> np.uint64(PACK_SHIFT)).astype(np.uint16)
    else:
        hk = keys[slots]
        hc = np.asarray(arena.coords)[slots]
    miss = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * np.uint64(2)
    top = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) | \
        np.uint64(1 << 63)
    mc = rng.integers(0, arena.k, size=n).astype(np.uint16)
    pkeys = np.concatenate([hk, hk, miss, top])
    coords = np.concatenate([hc, hc, mc, mc])
    valid = np.concatenate([np.ones(n, bool), np.zeros(n, bool),
                            np.ones(2 * n, bool)])
    return pkeys, coords, valid


def _probe_inputs(da, arena, pkeys, coords, valid, device):
    import torch

    from repro_torch.core.device_plan import _encode_queries
    qk, qt = _encode_queries(arena.mode, pkeys, coords, valid)
    return (da.keys, da.tags, da.offsets, torch.from_numpy(qk).to(device),
            torch.from_numpy(qt).to(device),
            torch.from_numpy(np.ascontiguousarray(valid)).to(device))


def _small_index(similarity: str, k: int, seed: int, family="universal"):
    from repro_torch.core.columnar import ColumnarBuilder
    from repro_torch.core.schemes import make_scheme
    docs = [uniform_tokens(300, np.random.default_rng(seed + i))
            for i in range(8)]
    scheme = make_scheme(similarity, k=k, seed=seed, family=family,
                         corpus=docs)
    return ColumnarBuilder(scheme=scheme).build(docs).freeze()


def _dup_mix_arena(rng):
    """A coord-mode arena of mix-hash keys with duplicates across
    coordinates (each coordinate draws its keys from one shared pool)."""
    from repro_torch.core.frozen import KIND_INT, ProbeArena
    from repro_torch.core.hashing import MixHash
    k = 16
    h = MixHash.from_seed(7, 1)[0]
    pool = h(np.arange(4000), np.ones(4000, np.int64))
    packed, wins = [], []
    for _ in range(k):
        n = int(rng.integers(200, 600))
        packed.append(rng.choice(pool, size=n))
        w = rng.integers(0, 900, size=(n, 5)).astype(np.int32)
        w[:, 2] = w[:, 1] + rng.integers(0, 20, size=n)
        w[:, 4] = w[:, 3] + rng.integers(0, 20, size=n)
        wins.append(w)
    arena = ProbeArena.from_window_columns([KIND_INT] * k, packed, wins,
                                           np.zeros(k, np.int64))
    if arena.mode != "coord" or arena.max_run < 2:
        raise AssertionError("the mix arena must be coord mode with "
                             "duplicate keys")
    return arena


class _Holder:
    _device_arena = None

    def __init__(self, arena):
        self._arena = arena

    def arena(self):
        return self._arena


def _seeded_groups(rng, S: int, device):
    """win_rect, idx, sizes for G groups of width S: padding slots,
    zero-width rects (b = a - 1) and repeated boundaries."""
    import torch
    nwin, G = 512, 64
    a = rng.integers(0, 60, size=nwin)
    c = rng.integers(0, 60, size=nwin)
    b = a + rng.integers(-1, 12, size=nwin)        # -1: zero-width
    d = c + rng.integers(0, 12, size=nwin)
    rect = np.stack([a, b, c, d], axis=1).astype(np.int32)
    idx = rng.integers(0, nwin, size=(G, S)).astype(np.int64)
    sizes = rng.integers(1, S + 1, size=G).astype(np.int32)
    sizes[0] = S
    return (torch.from_numpy(rect).to(device), torch.from_numpy(idx).to(device),
            torch.from_numpy(sizes).to(device))


def phase_kernels(legs: dict, seed: int) -> dict:
    import torch

    from repro_torch.core.device_plan import device_arena
    from repro_torch.kernels import probe_arena, sweep_grid
    device = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 17)
    probe_pairs, sweep_pairs = [], []

    def check_probe(args, label):
        got = probe_arena.arena_probe(*args)
        want = probe_arena.arena_probe_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"probe kernel != plain on {label}")
        probe_pairs.extend(zip(got, want))
        return int((got[1] > got[0]).sum())

    for corpus, leg in legs.items():
        arena = leg["server"].index.arena()
        for args in leg["probe_calls"]:
            check_probe(args, f"[{corpus}] main-path probes")
        print(f"probe == plain: [{corpus}] main arena ({arena.mode}, "
              f"{len(arena.keys)} slots): {len(leg['probe_calls'])} "
              "main-path launches")
    index = legs["uniform"]["server"].index
    arena = index.arena()
    da = device_arena(index, device)
    hits = check_probe(_probe_inputs(da, arena, *_probe_cases(arena, rng, 512),
                                     device), "main arena, seeded")
    print(f"probe == plain: [uniform] main arena, seeded ({hits} hits)")
    idx = _small_index("tfidf", 160, 5)
    ar = idx.arena()
    top = int((np.asarray(ar.keys) >> np.uint64(63)).sum())
    if ar.mode != "packed" or top == 0:
        raise AssertionError("the k=160 arena must be packed with keys "
                             ">= 2**63")
    d = device_arena(idx, device)
    hits = check_probe(_probe_inputs(d, ar, *_probe_cases(ar, rng, 512),
                                     device), "packed k=160")
    print(f"probe == plain: packed k=160 ({len(ar.keys)} slots, {top} keys "
          f">= 2**63, {hits} hits)")
    ar = _dup_mix_arena(rng)
    holder = _Holder(ar)
    d = device_arena(holder, device)
    hits = check_probe(_probe_inputs(d, ar, *_probe_cases(ar, rng, 512),
                                     device), "mix coord")
    print(f"probe == plain: mix coord arena ({len(ar.keys)} slots, max_run "
          f"{ar.max_run}, {hits} hits)")

    def check_sweep(args, label):
        got = sweep_grid.sweep(*args)
        want = sweep_grid.sweep_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g.long(), w.long()):
                raise AssertionError(f"sweep kernel != plain on {label}")
        sweep_pairs.extend(zip(got, want))

    for corpus, leg in legs.items():
        for args in leg["sweep_calls"]:
            check_sweep(args, f"[{corpus}] main-path group "
                        f"S={args[1].shape[1]}")
    for S in range(1, sweep_grid.MAX_S + 1):
        rect, idx, sizes = _seeded_groups(rng, S, device)
        for m in (1, 2, max(1, S // 2)):
            check_sweep((rect, idx, sizes, m), f"seeded S={S} m={m}")
    print("sweep == plain: " + ", ".join(
        f"[{c}] {len(leg['sweep_calls'])}" for c, leg in legs.items()) +
        " main-path bucket launches + seeded S=1..32")
    return {"probe_err": _max_abs_err(probe_pairs),
            "sweep_err": _max_abs_err(sweep_pairs)}


def _seeded_sketch_grids(rng, B: int, T: int, device):
    """r, c, beta (B, K, T) and w (B, T) as the reference's kernel tests
    draw them, texts padded past a random length and the last fully
    masked."""
    import torch
    r = rng.gamma(2.0, 1.0, (B, K, T)).astype(np.float32)
    c = rng.gamma(2.0, 1.0, (B, K, T)).astype(np.float32)
    b = rng.uniform(0, 1, (B, K, T)).astype(np.float32)
    w = rng.uniform(0.1, 5.0, (B, T)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    w[np.arange(T)[None, :] >= lens[:, None]] = 0.0
    w[-1] = 0.0
    return [torch.from_numpy(x).to(device) for x in (r, c, b, w)]


def check_sketch_kernels(pinned: dict, paths: dict, seed: int) -> dict:
    """The four sketch kernels against their plain versions on their
    paths' inputs (see the module docstring for the criteria)."""
    import torch

    from repro_torch.kernels import icws_hash
    mh = _minhash_module()
    rng = np.random.default_rng(seed + 41)
    stats = {}

    def sketch_pair(kernel, plain, args, label, name):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        near = icws_hash.sketch_near_ties(*args, got[1], want[1])
        same = (got[1] == want[1]) & (got[2] == want[2])
        if not bool((same | near).all()):
            raise AssertionError(f"{name} kernel != plain off near-ties "
                                 f"on {label}")
        if int(near.sum()) > 0.01 * near.numel():
            raise AssertionError(f"{name}: {int(near.sum())} near-ties of "
                                 f"{near.numel()} on {label}")
        torch.testing.assert_close(got[0][same], want[0][same], rtol=2e-5,
                                   atol=0)
        st = stats.setdefault(name, {"err": 0.0, "near": 0, "coords": 0,
                                     "differ": 0})
        if bool(same.any()):
            st["err"] = max(st["err"], float(
                (got[0][same] - want[0][same]).abs().max()))
        st["near"] += int(near.sum())
        st["coords"] += near.numel()
        st["differ"] += int((~same).sum())
        return got

    for args in pinned["sketch_calls"]:
        sketch_pair(icws_hash.icws_sketch_batch,
                    icws_hash.icws_sketch_batch_plain, args,
                    "the pinned path's grids", "icws_sketch_batch")
    for B, T in ((64, 120), (7, 1000), (3, 5)):
        got = sketch_pair(icws_hash.icws_sketch_batch,
                          icws_hash.icws_sketch_batch_plain,
                          _seeded_sketch_grids(rng, B, T, DEVICE),
                          f"seeded ({B}, {K}, {T})", "icws_sketch_batch")
        if not (bool((got[1][-1] == -1).all()) and
                bool((got[2][-1] == 0).all()) and
                bool((got[0][-1] == 3.0e38).all())):
            raise AssertionError("icws_sketch_batch: a fully masked text "
                                 "must give (3.0e38, -1, 0)")
    sketch_pair(icws_hash.icws_sketch, icws_hash.icws_sketch_plain,
                paths["single"], "one document", "icws_sketch")

    r, c, b, w = paths["grid"]
    kint, a = icws_hash.icws_hash_grid(r, c, b, w)
    kint_p, a_p = icws_hash.icws_hash_grid_plain(r, c, b, w)
    torch.cuda.synchronize()
    near = icws_hash.near_integer(r, b, w)
    same = kint == kint_p
    if not bool((same | near).all()):
        raise AssertionError("icws_hash_grid kernel != plain off near-ties")
    torch.testing.assert_close(a[same], a_p[same], rtol=2e-5, atol=0)
    stats["icws_hash_grid"] = {
        "err": float((a[same] - a_p[same]).abs().max()),
        "near": int(near.sum()), "coords": near.numel(),
        "differ": int((~same).sum())}
    del kint, a, kint_p, a_p

    worst = 0
    for args in paths["minhash"]:
        got = mh.minhash_sketch(*args)
        want = mh.minhash_sketch_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"minhash_sketch kernel != plain at "
                                 f"{tuple(args[0].shape)}")
        worst = max(worst, int((got - want).abs().max()))
    stats["minhash_sketch"] = {"err": worst, "near": 0, "differ": 0,
                               "coords": sum(a[0].shape[0] * a[2].shape[0]
                                             for a in paths["minhash"])}
    for name, st in stats.items():
        print(f"{name} == plain: {st['coords']} coordinates, "
              f"{st['near']} near-ties, {st['differ']} identities differ "
              f"(all on near-ties), max |a - a_plain| (min-hash: |sketch "
              f"difference|) {st['err']}")
    return stats


# --------------------------------------------------------------------------
# phase 5: timings at the main path's shapes
# --------------------------------------------------------------------------

def phase_report(main: dict, errs: dict) -> list[dict]:
    import torch

    from repro_torch.kernels import probe_arena, sweep_grid

    # probe: the first main-path batch's launch
    args = main["probe_calls"][0]
    keys, _tags, _off, qkeys, _qt, _valid = args
    n, P = keys.shape[0], qkeys.shape[0]
    flipped = keys ^ (-(1 << 63))                 # unsigned order, signed
    qflipped = qkeys ^ (-(1 << 63))
    timed = {
        "probe kernel": lambda: probe_arena.arena_probe(*args),
        "probe plain": lambda: probe_arena.arena_probe_plain(*args),
        "torch.searchsorted": lambda: torch.searchsorted(flipped, qflipped),
    }
    starts, ends = probe_arena.arena_probe_plain(*args)
    hits = int((ends > starts).sum())
    probe_bytes = P * (8 + 4 + 1) + P * 16 + P * (8 + 4) + hits * 16
    probe_bound = probe_bytes / HBM_BYTES_PER_S * 1e3

    # sweep: the first main-path batch's bucket launches, summed
    k0 = main["sweep_per_batch"][0]
    calls = main["sweep_calls"][:k0]
    timed["sweep kernel"] = lambda: [sweep_grid.sweep(*a) for a in calls]
    timed["sweep plain"] = lambda: [sweep_grid.sweep_plain(*a)
                                    for a in calls]
    ms = {}
    for name, fn in timed.items():
        ms[name] = device_ms(fn)
        print(f"{name}: {ms[name]:.6f} ms device (graph replay), "
              f"{call_ms(fn):.6f} ms per call between CUDA events")
    s_bytes = s_ops = 0
    for _rect, idx, sizes, _m in calls:
        G, S = idx.shape
        NX = 2 * S
        s_bytes += (G * S * 8 + G * 4 + int(sizes.sum()) * 16 +
                    G * (NX - 1) ** 2 + 2 * G * NX * 4)
        s_ops += G * (4 * S * NX + 2 * NX * NX + 4 * S +
                      2 * (NX + 1) ** 2 + (NX - 1) ** 2)
    sweep_bound = max(s_bytes / HBM_BYTES_PER_S, s_ops / INT_OPS_PER_S) * 1e3
    sweep_by = "bytes" if s_bytes / HBM_BYTES_PER_S >= \
        s_ops / INT_OPS_PER_S else "operations"
    shapes = [tuple(c[1].shape) for c in calls]
    print(f"probe timing shape: n={n} slots, P={P} probes ({hits} hits); "
          f"sweep timing shapes (G, S): {shapes}")
    return [
        {"name": "probe_arena", "route": "cuda",
         "source": "src/repro_torch/csrc/probe_arena.cu",
         "replaces": "src/repro/kernels/probe_arena.py:42",
         "launches": main["launches"]["probe_arena"],
         "max_abs_err": errs["probe_err"], "ms": ms["probe kernel"],
         "plain_ms": ms["probe plain"], "bound_ms": probe_bound,
         "bound_by": "bytes", "library_ms": ms["torch.searchsorted"]},
        {"name": "sweep_grid", "route": "cuda",
         "source": "src/repro_torch/csrc/sweep_grid.cu",
         "replaces": "src/repro/kernels/sweep_grid.py:69",
         "launches": main["launches"]["sweep_grid"],
         "max_abs_err": errs["sweep_err"], "ms": ms["sweep kernel"],
         "plain_ms": ms["sweep plain"], "bound_ms": sweep_bound,
         "bound_by": sweep_by, "library_ms": None},
    ]


def _icws_bound(r, w, out_bytes: int) -> tuple[float, str]:
    """Least time for an ICWS call on these inputs: the r/c/beta bytes of
    the valid (token, hasher) elements, w of the valid tokens and the
    outputs over the memory rate, against one log per valid token and one
    exp per valid element over the special-function units' rate."""
    v_tok = int((w > 0).sum())
    v_elem = v_tok * r.shape[-2]
    t_bytes = (v_elem * 12 + v_tok * 4 + out_bytes) / HBM_BYTES_PER_S
    t_ops = (v_tok + v_elem) / SFU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _minhash_bound(tokens, seeds) -> tuple[float, str]:
    """Least time for a min-hash call: 8 bytes per valid position, the
    seeds and the sketch over the memory rate, against 20 integer
    operations per (text, seed, valid position) plus 2 per position (the
    kernel's hash chain and min) over the 32-bit rate."""
    B, K_ = tokens.shape[0], seeds.shape[0]
    valid = int((tokens >= 0).sum())
    t_bytes = (valid * 8 + K_ * 8 + B * K_ * 8) / HBM_BYTES_PER_S
    t_ops = (valid * K_ * 20 + valid * 2) / INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def report_sketch(pinned: dict, paths: dict, stats: dict) -> list[dict]:
    """Device times of the sketch kernels at their paths' shapes, with
    their plain versions and bounds, as ``kernels`` entries."""
    from repro_torch.kernels import icws_hash
    mh = _minhash_module()
    batch = pinned["sketch_calls"][0]
    single = paths["single"]
    grid = paths["grid"]
    corpus, bench = paths["minhash"]
    cases = {
        "icws_sketch_batch": (icws_hash.icws_sketch_batch,
                              icws_hash.icws_sketch_batch_plain, batch,
                              _icws_bound(batch[0], batch[3],
                                          batch[0].shape[0] *
                                          batch[0].shape[1] * 12),
                              "src/repro/kernels/icws_hash.py:137",
                              pinned["launches"]["icws_sketch_batch"]),
        "icws_sketch": (icws_hash.icws_sketch, icws_hash.icws_sketch_plain,
                        single, _icws_bound(single[0], single[3],
                                            single[0].shape[0] * 12),
                        "src/repro/kernels/icws_hash.py:75",
                        paths["launches"]["icws_sketch"]),
        "icws_hash_grid": (icws_hash.icws_hash_grid,
                           icws_hash.icws_hash_grid_plain, grid,
                           _icws_bound(grid[0], grid[3],
                                       grid[0].numel() * 8),
                           "src/repro/kernels/icws_hash.py:32",
                           paths["launches"]["icws_hash_grid"]),
        "minhash_sketch": (mh.minhash_sketch, mh.minhash_sketch_plain,
                           corpus, _minhash_bound(corpus[0], corpus[2]),
                           "src/repro/kernels/minhash_sketch.py:29",
                           paths["launches"]["minhash_sketch"]),
    }
    entries = []
    for name, (kernel, plain, args, (bound, by), replaces, n) in \
            cases.items():
        ms = device_ms(lambda: kernel(*args))
        plain_ms = device_ms(lambda: plain(*args))
        print(f"{name} kernel: {ms:.6f} ms device (graph replay), "
              f"{call_ms(lambda: kernel(*args)):.6f} ms per call between "
              f"CUDA events; plain {plain_ms:.6f} ms; bound {bound:.6f} ms "
              f"({by}); shape {tuple(args[0].shape)}")
        source = "icws_hash" if name.startswith("icws") else name
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": n,
            "max_abs_err": stats[name]["err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "near_ties": stats[name]["near"]})
    bound, by = _minhash_bound(bench[0], bench[2])
    print(f"minhash_sketch kernel at {MINHASH_BENCH_SHAPE}: "
          f"{device_ms(lambda: mh.minhash_sketch(*bench)):.6f} ms device, "
          f"plain {device_ms(lambda: mh.minhash_sketch_plain(*bench)):.6f} "
          f"ms, bound {bound:.6f} ms ({by})")
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=400,
                    help="documents of the uniform corpus")
    ap.add_argument("--zipf-docs", type=int, default=400,
                    help="documents of the Zipf corpus")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "the card only", file=sys.stderr)
        return 2
    for corpus, n in (("uniform", args.docs), ("zipf", args.zipf_docs)):
        if n != 400:
            print(f"corpus cut: [{corpus}] {n} documents instead of 400")
    t_start = time.perf_counter()
    dev = phase_device()
    build_root = ROOT / "build"
    build_root.mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke-", dir=build_root))
    phase_s = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t0
        return out

    try:
        legs = {"uniform": timed("uniform", phase_main_path, "uniform",
                                 args.docs, args.seed, workdir,
                                 need_sweep=True),
                "zipf": timed("zipf", phase_main_path, "zipf",
                              args.zipf_docs, args.seed, workdir,
                              need_sweep=False)}
        pinned = timed("pinned", phase_pinned, legs["uniform"])
        paths = timed("sketch paths", phase_sketch_paths, legs["uniform"],
                      args.seed)
        errs = timed("probe/sweep checks", phase_kernels, legs, args.seed)
        stats = timed("sketch checks", check_sketch_kernels, pinned, paths,
                      args.seed)
        kernels = timed("report", lambda: phase_report(
            legs["uniform"], errs) + report_sketch(pinned, paths, stats))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("phase seconds: " + json.dumps(phase_s))
    print(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
