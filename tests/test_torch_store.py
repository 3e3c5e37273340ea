"""``repro_torch.store`` (the incremental segment store) against the JAX
package's ``repro.store``.

The contract under test: for any edit sequence an incremental run gives
the counters and register banks of a cold assessment of the final bytes,
unchanged segments are served from frozen state, the port rescans the
same segments the JAX runner rescans, and a store written by either
package is reused by the other with no segment rescanned.  Damaged store
files degrade to a rescan of the affected segments only.

The port runs with ``device="cpu"`` (its kernel wrappers then run their
plain torch versions), the JAX package its ``jnp`` backend, as in its own
store tests (``tests/test_store.py``).

Tolerances: within the port, and for counters, register banks,
``n_triples``, segment and byte counts and every value derived only from
counters across the packages: exact.  ``sketch_estimates``, ``CN2_EXACT``
and ``SCH1`` come from the float32 HLL estimator, whose sum of
``exp2(-regs)`` XLA and torch add in different orders: ``rel=1e-6``
across the packages.
"""
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from repro import qa as jqa
from repro.core.metrics import Metric as JMetric
from repro.core.metrics import register as j_register
from repro.core.metrics import unregister as j_unregister
from repro.core.metrics import valid_triple as j_valid_triple
from repro.store import SegmentState as JSegmentState
from repro.store import SegmentStore as JSegmentStore
from repro.store import engine_signature as j_engine_signature
from repro.store import iter_segments as j_iter_segments
from repro.store import split_segments as j_split_segments

from repro_torch import kernels as K
from repro_torch import qa
from repro_torch.core import report
from repro_torch.core.metrics import (ALL_METRICS, SKETCH_METRICS, Metric,
                                      register, unregister, valid_triple)
from repro_torch.rdf import TermDictionary, bsbm_ntriples
from repro_torch.rdf import ingest as rdf_ingest
from repro_torch.rdf.triple_tensor import COL_S
from repro_torch.store import (SegmentState, SegmentStore, engine_signature,
                               iter_segments, split_segments)
from repro_torch.store.runner import plans_renumbering_invariant

BASE = ("http://bsbm.example.org/",)
SEG = 16384         # small target → many segments on the test corpus
SKETCH_VALUES = set(SKETCH_METRICS)
STATS = ("chunks_total", "segments_reused", "segments_rescanned",
         "bytes_total", "bytes_rescanned", "footprints_replayed")
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def corpus(n_products=200, seed=11) -> bytes:
    return bsbm_ntriples(n_products, seed=seed).encode()


def tpipe(store=None, backend="fused_scan", metrics=ALL_METRICS):
    p = qa.pipeline().metrics(metrics).backend(backend).base(*BASE) \
        .device("cpu")
    if store is not None:
        p = p.incremental(os.fspath(store), segment_bytes=SEG)
    return p


def jpipe(store=None, metrics=ALL_METRICS):
    p = jqa.pipeline().metrics(metrics).base(*BASE)
    if store is not None:
        p = p.incremental(os.fspath(store), segment_bytes=SEG)
    return p


def assert_bit_identical(res, ref):
    """Exact equality within the port."""
    assert res.n_triples == ref.n_triples
    assert res.counts == ref.counts
    assert res.values == ref.values
    assert res.sketch_estimates == ref.sketch_estimates
    assert set(res.registers) == set(ref.registers)
    for k in ref.registers:
        np.testing.assert_array_equal(res.registers[k], ref.registers[k], k)


def assert_matches_jax(res, jres):
    """The port's result against the JAX package's on the same bytes."""
    assert res.n_triples == jres.n_triples
    assert res.counts == jres.counts
    assert set(res.registers) == set(jres.registers)
    for k in jres.registers:
        np.testing.assert_array_equal(res.registers[k],
                                      np.asarray(jres.registers[k]), k)
    assert set(res.values) == set(jres.values)
    for k, v in jres.values.items():
        if k in SKETCH_VALUES:
            assert res.values[k] == pytest.approx(v, rel=1e-6), k
        else:
            assert res.values[k] == v, k
    for k, v in jres.sketch_estimates.items():
        assert res.sketch_estimates[k] == pytest.approx(v, rel=1e-6), k


def stats_of(res) -> dict:
    return {k: getattr(res.exec_stats, k) for k in STATS}


# --- the copied modules ---------------------------------------------------------

@pytest.mark.parametrize("name", ["segmenter.py", "store.py"])
def test_copied_modules_equal_the_originals(name):
    """``segmenter`` and ``store`` carry no JAX: they are copies, held to
    the originals byte for byte (the on-disk identity depends on it)."""
    with open(os.path.join(SRC, "repro", "store", name), "rb") as f:
        original = f.read()
    with open(os.path.join(SRC, "repro_torch", "store", name), "rb") as f:
        assert f.read() == original


@pytest.mark.parametrize("target,data", [
    (1024, "corpus"), (16384, "corpus"), (1 << 20, "large"),
    (4096, "newline-free")], ids=["1KiB", "16KiB", "1MiB", "newline-free"])
def test_segment_boundaries_equal_jax(tmp_path, target, data):
    blob = {"corpus": lambda: corpus(200),
            "large": lambda: bsbm_ntriples(12_000, seed=5).encode(),
            "newline-free": lambda: b"x" * (1 << 20)}[data]()
    segs = split_segments(blob, target)
    assert segs == j_split_segments(blob, target)
    assert b"".join(segs) == blob
    if data != "newline-free":
        assert len(segs) > 2
    path = tmp_path / "d.nt"
    path.write_bytes(blob)
    with open(path, "rb") as f:
        from_file = list(iter_segments(f, target))
    with open(path, "rb") as f:
        assert from_file == list(j_iter_segments(f, target)) == segs


@pytest.mark.parametrize("case", ["all", "paper", "per-metric", "hll10"])
def test_engine_signature_equals_jax(case):
    """No key for the package, device or backend: equal signatures are what
    lets either package reuse the other's store."""
    t, j = tpipe(), jpipe()
    if case == "paper":
        t, j = t.metrics("paper"), j.metrics("paper")
    elif case == "per-metric":
        t, j = t.per_metric(), j.per_metric()
    elif case == "hll10":
        t, j = t.hll(10), j.hll(10)
    sig = engine_signature(t.evaluator(), BASE)
    assert sig == j_engine_signature(j.evaluator(), BASE)
    for be in ("torch", "twopass"):
        assert engine_signature(t.backend(be).evaluator(), BASE) == sig
    assert "device" not in sig and "backend" not in sig


# --- exactness and rescan sets ------------------------------------------------

def _random_edit(rng, data: bytes) -> bytes:
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    op = rng.integers(0, 3)
    if op == 0 or len(lines) < 10:       # append a few fresh triples
        extra = bsbm_ntriples(int(rng.integers(1, 6)),
                              seed=int(rng.integers(1 << 30)))
        return data + extra.encode()
    if op == 1:                           # delete a random region
        i = int(rng.integers(0, len(lines) - 5))
        j = i + int(rng.integers(1, min(len(lines) - i, 200)))
        del lines[i:j]
    else:                                 # in-place mutation
        i = int(rng.integers(0, len(lines)))
        lines[i] = (b'<http://mut.example/s%d> <http://mut.example/p> '
                    b'"%d" .' % (int(rng.integers(1000)),
                                 int(rng.integers(1000))))
    return b"\n".join(lines) + b"\n"


def test_cold_warm_and_edit_sequence_match_single_shot_and_jax(tmp_path):
    """Cold, warm, then random appends, deletes and mutations: every
    backend of the port equals its own single shot exactly, equals the
    JAX runner's result, and rescans the same segments and bytes and
    replays the same footprints as the JAX runner on its own store."""
    rng = np.random.default_rng(0xC0FFEE)
    data = corpus(220, seed=3)
    backends = ("fused_scan", "twopass", "torch")
    steps = ["cold", "warm"] + ["edit"] * 4
    for step in steps:
        if step == "edit":
            data = _random_edit(rng, data)
        text = data.decode()
        jres = jpipe(tmp_path / "jax").run(text)
        single = tpipe().run(text)
        for be in backends:
            res = tpipe(tmp_path / be, backend=be).run(text)
            assert_bit_identical(res, single)
            assert_matches_jax(res, jres)
            assert stats_of(res) == stats_of(jres), (step, be)
            assert res.exec_stats.mode == "incremental"
            assert res.passes == (res.exec_stats.segments_rescanned
                                  * res.exec_stats.passes_per_chunk)
        assert res.passes == jres.passes        # torch ↔ jnp: 1 + S
        if step == "cold":
            assert jres.exec_stats.segments_reused == 0
            assert jres.exec_stats.segments_rescanned > 4
        if step == "warm":
            assert jres.exec_stats.bytes_rescanned == 0
            assert res.passes == 0
    hist = SegmentStore(os.fspath(tmp_path / "torch"), engine_signature(
        tpipe().evaluator(), BASE)).history()
    assert len(hist) == len(steps)
    assert any(h.get("segments_reused", 0) > 0 for h in hist[2:])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_reused_across_packages(tmp_path, writer):
    """A store written by one package is reused by the other with no
    segment rescanned (registers equal and counters equal to a cold run);
    after one edit either package rescans the same segments of it."""
    data = corpus(250, seed=9)
    store = tmp_path / "st"
    cold = tpipe().run(data.decode())
    first = (jpipe(store) if writer == "jax" else tpipe(store)).run(
        data.decode())
    assert first.exec_stats.segments_rescanned == first.exec_stats \
        .chunks_total > 4
    if writer == "jax":
        warm = tpipe(store).run(data.decode())
        assert_bit_identical(warm, cold)
    else:
        warm = jpipe(store).run(data.decode())
        assert_matches_jax(cold, warm)
    assert warm.exec_stats.segments_rescanned == 0
    assert warm.exec_stats.segments_reused == warm.exec_stats.chunks_total
    assert warm.passes == 0
    assert all(np.asarray(v).dtype == np.int32
               for v in warm.registers.values())

    a = data.find(b"\n", len(data) // 3) + 1
    b = data.find(b"\n", a + len(data) // 20) + 1
    edited = (data[:a] + bsbm_ntriples(12, seed=999).encode()
              + data[b:]).decode()
    shutil.copytree(store, tmp_path / "copy")
    t_res = tpipe(store).run(edited)
    j_res = jpipe(tmp_path / "copy").run(edited)
    assert stats_of(t_res) == stats_of(j_res)
    assert 1 <= t_res.exec_stats.segments_rescanned \
        < t_res.exec_stats.chunks_total
    assert_bit_identical(t_res, tpipe().run(edited))
    assert_matches_jax(t_res, j_res)


def test_duplicate_segments_and_explicit_chunk_streams(tmp_path):
    """The same bytes twice are one state file but two merge
    contributions; an iterable of text chunks is an explicit
    segmentation, one segment a chunk."""
    block = corpus(120, seed=21)
    doubled = (block + block).decode()
    cold = tpipe().run(doubled)
    assert_bit_identical(tpipe(tmp_path / "dup").run(doubled), cold)
    warm = tpipe(tmp_path / "dup").run(doubled)
    assert warm.exec_stats.segments_rescanned == 0
    assert_bit_identical(warm, cold)

    blocks = [bsbm_ntriples(60, seed=s) for s in (1, 2, 3)]
    inc = tpipe(tmp_path / "st").run(iter(blocks))
    assert_bit_identical(inc, tpipe().run("".join(blocks)))
    assert inc.exec_stats.chunks_total == 3
    blocks[1] = bsbm_ntriples(60, seed=8)
    inc2 = tpipe(tmp_path / "st").run(iter(blocks))
    assert_bit_identical(inc2, tpipe().run("".join(blocks)))
    assert inc2.exec_stats.segments_rescanned == 1
    assert inc2.exec_stats.segments_reused == 2
    with pytest.raises(TypeError, match="text/bytes"):
        tpipe(tmp_path / "st").run(iter([3.5]))


@pytest.mark.parametrize("prefetch", [1, 2])
def test_pipelined_incremental(tmp_path, prefetch):
    """Segments parsed and staged on the scheduler's producer thread,
    frozen on the consumer thread: the sequential run's result and rescan
    set."""
    data = corpus(250, seed=4).decode()
    store = tmp_path / "st"
    p = tpipe(store).pipelined(prefetch)
    inc = p.run(data)
    assert_bit_identical(inc, tpipe().run(data))
    assert inc.exec_stats.mode == "incremental+pipelined"
    assert inc.exec_stats.segments_rescanned == inc.exec_stats.chunks_total
    sync = tpipe(tmp_path / "sync").run(data)
    assert stats_of(inc) == stats_of(sync)
    warm = p.run(data)
    assert warm.exec_stats.segments_rescanned == 0
    assert_bit_identical(warm, inc)


@pytest.mark.parametrize("backend", ["fused_scan", "twopass", "torch"])
def test_padded_and_unpadded_segments_give_equal_state(backend):
    """The JAX runner pads each segment to a power-of-two row bucket; the
    port does not. Zero rows are invisible: each segment's counters and
    registers are equal either way, and equal the JAX evaluator's on the
    padded segment."""
    from repro.core.evaluator import QualityEvaluator as JEvaluator
    from repro.rdf import TripleTensor as JTripleTensor
    ev = tpipe(backend=backend).evaluator()
    jev = JEvaluator(list(ALL_METRICS), backend="jnp")
    d = TermDictionary(BASE)
    for seg in split_segments(corpus(150, seed=2), SEG):
        tt = rdf_ingest.parse_encode(seg, dictionary=d)
        bucket = 1024
        while bucket < len(tt):
            bucket <<= 1
        padded = tt.padded_to(bucket)
        assert padded.planes.shape[0] == bucket > len(tt)
        counts, regs = ev.eval_chunk(tt)
        p_counts, p_regs = ev.eval_chunk(padded)
        j_counts, j_regs = jev.eval_chunk(JTripleTensor(
            padded.planes, padded.n_valid, padded.n_terms))
        for c, pc, jc in zip(counts, p_counts, j_counts):
            np.testing.assert_array_equal(c, pc)
            np.testing.assert_array_equal(c, np.asarray(jc))
        assert set(regs) == set(p_regs) == set(j_regs) == {"spo", "p"}
        for k in regs:
            np.testing.assert_array_equal(regs[k], p_regs[k])
            np.testing.assert_array_equal(regs[k], np.asarray(j_regs[k]))


# --- robustness -----------------------------------------------------------------

def _state_files(store):
    seg_dir = os.path.join(os.fspath(store), "segments")
    return sorted(os.path.join(seg_dir, n) for n in os.listdir(seg_dir)
                  if n.endswith(".seg"))


def _truncate(path):
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])


def _flip_byte(path, at=100):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


def _corrupt_manifest_digest(store):
    manifest = os.path.join(store, "manifest.json")
    with open(manifest) as f:
        doc = json.load(f)
    doc["payload"]["segments"][0]["n_triples"] += 1     # digest now wrong
    with open(manifest, "w") as f:
        json.dump(doc, f)


def _truncate_manifest(store):
    manifest = os.path.join(store, "manifest.json")
    with open(manifest, "r+") as f:
        f.truncate(os.path.getsize(manifest) // 2)


# damage, and the segments the next run must rescan
DAMAGE = {
    "truncated-seg": (lambda s: _truncate(_state_files(s)[2]), 1),
    "bitflip-seg": (lambda s: _flip_byte(_state_files(s)[0]), 1),
    "missing-seg": (lambda s: os.remove(_state_files(s)[1]), 1),
    # self-verifying states are adopted as orphans after a bad manifest
    "corrupt-manifest": (_corrupt_manifest_digest, 0),
    # a crash between the freezes and the manifest commit
    "crash-before-commit": (
        lambda s: os.remove(os.path.join(s, "manifest.json")), 0),
    "torn-manifest": (_truncate_manifest, 0),
}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("damage", list(DAMAGE))
def test_damaged_store_degrades_to_local_rescans(tmp_path, damage, writer):
    data = corpus(200, seed=7).decode()
    store = os.fspath(tmp_path / "st")
    cold = tpipe().run(data)
    (tpipe(store) if writer == "port" else jpipe(store)).run(data)
    hurt, rescans = DAMAGE[damage]
    hurt(store)
    inc = tpipe(store).run(data)
    assert_bit_identical(inc, cold)
    s = inc.exec_stats
    assert s.segments_rescanned == rescans
    assert s.segments_reused == s.chunks_total - rescans
    # the rescan re-froze what it had to: the next run is fully warm
    warm = tpipe(store).run(data)
    assert warm.exec_stats.segments_rescanned == 0
    assert_bit_identical(warm, cold)


def _forge_old_layout(store):
    """Re-freeze a store under the previous plane layout's signature (no
    ``plane_layout`` key), as a store written before layout v2 holds."""
    sig_new = engine_signature(tpipe().evaluator(), BASE)
    sig_old = {k: v for k, v in sig_new.items() if k != "plane_layout"}
    cur, old = SegmentStore(store, sig_new), SegmentStore(store, sig_old)
    descrs = cur.known_segments
    for d in descrs:
        old.put_state(cur.load_state(d["fp"]))
    old.commit([{k: s[k] for k in ("fp", "n_bytes", "n_triples")}
                for s in descrs])


@pytest.mark.parametrize("case", ["other-engine", "orphans-other-engine",
                                  "old-plane-layout"])
def test_engine_signature_change_invalidates_store(tmp_path, case):
    """States frozen under another engine (metrics, ``hll_p``, plane
    layout) describe other counter layouts or register banks: never
    reused, never a crash, and the store is rebuilt."""
    data = corpus(150, seed=10).decode()
    store = os.fspath(tmp_path / "st")
    tpipe(store).run(data)
    if case == "old-plane-layout":
        _forge_old_layout(store)
        other = tpipe(store)
    else:
        if case == "orphans-other-engine":
            os.remove(os.path.join(store, "manifest.json"))
        other = tpipe(store, metrics="paper").hll(10)
    inc = other.run(data)
    assert inc.exec_stats.segments_reused == 0
    assert inc.exec_stats.segments_rescanned == inc.exec_stats.chunks_total
    assert_bit_identical(inc, other.single_shot().run(data))
    back = tpipe(store).run(data)
    assert back.exec_stats.segments_reused == (
        back.exec_stats.chunks_total if case == "old-plane-layout" else 0)


def test_user_metric_on_id_planes_keeps_replay_gate(tmp_path):
    """A user metric that sketches a raw id plane keeps the replayed-id
    equality gate: an early delete renumbers ids and rescans the
    downstream segments — the same ones the JAX runner rescans."""
    def id_sketch(cls, counter):
        return cls(name="ID_SKETCH", dimension="custom",
                   description="distinct subjects via the raw id plane",
                   counters=(("total", counter),),
                   finalize=lambda c: float(c.get("sketch:s_id", 0)),
                   sketches=(("s_id", (COL_S,)),))

    register(id_sketch(Metric, valid_triple()))
    j_register(id_sketch(JMetric, j_valid_triple()))
    try:
        names = tuple(ALL_METRICS) + ("ID_SKETCH",)
        t_inc = tpipe(tmp_path / "t", metrics=names)
        j_inc = jpipe(tmp_path / "j", metrics=names)
        assert not plans_renumbering_invariant(t_inc.evaluator())
        assert plans_renumbering_invariant(tpipe().evaluator())
        assert engine_signature(t_inc.evaluator(), BASE) == \
            j_engine_signature(j_inc.evaluator(), BASE)
        data = corpus(300, seed=40)
        t_inc.run(data.decode())
        j_inc.run(data.decode())
        cut = data.find(b"\n", 1500) + 1
        cut2 = data.find(b"\n", 6000) + 1
        edited = (data[:cut] + data[cut2:]).decode()
        res, jres = t_inc.run(edited), j_inc.run(edited)
        assert_bit_identical(res, t_inc.single_shot().run(edited))
        assert_matches_jax(res, jres)
        assert res.exec_stats.segments_rescanned > 2
        assert stats_of(res) == stats_of(jres)
    finally:
        unregister("ID_SKETCH")
        j_unregister("ID_SKETCH")


def test_lazy_footprint_replay(tmp_path):
    """A warm run replays no footprint; an edit near the start replays at
    most the footprints of the segments before it."""
    data = corpus(300)
    store = tmp_path / "st"
    path = tmp_path / "d.nt"
    path.write_bytes(data)
    cold = tpipe(store).run(os.fspath(path))
    assert cold.exec_stats.footprints_replayed == 0
    warm = tpipe(store).run(os.fspath(path))
    assert warm.exec_stats.segments_rescanned == 0
    assert warm.exec_stats.footprints_replayed == 0
    assert_bit_identical(warm, cold)
    a = data.find(b"\n", len(data) // 20) + 1
    b = data.find(b"\n", a) + 1
    path.write_bytes(data[:a] + b"<http://x/s> <http://x/p> <http://x/o> .\n"
                     + data[b:])
    res = tpipe(store).run(os.fspath(path))
    s = res.exec_stats
    assert s.segments_rescanned >= 1
    assert s.footprints_replayed <= 1 and s.footprints_replayed \
        < s.segments_reused
    assert_bit_identical(res, tpipe().run(os.fspath(path)))


# --- maintenance ----------------------------------------------------------------

def test_compact_removes_stale_segments_and_keeps_reuse(tmp_path):
    data = corpus(300)
    store = tmp_path / "st"
    path = tmp_path / "d.nt"
    path.write_bytes(data)
    tpipe(store).run(os.fspath(path))
    for seed in (71, 72):      # two generations of stale segments
        a = data.find(b"\n", len(data) // 2) + 1
        b = data.find(b"\n", a + len(data) // 10) + 1
        data = data[:a] + bsbm_ntriples(30, seed=seed).encode() + data[b:]
        path.write_bytes(data)
        tpipe(store).run(os.fspath(path))
    st = SegmentStore(os.fspath(store), signature={})
    live = {s["fp"] for s in st._disk_manifest_raw()["segments"]}
    on_disk = {os.path.basename(f)[:-4] for f in _state_files(store)}
    assert on_disk > live               # stale generations survived GC
    stats = SegmentStore.compact_dir(store)
    assert stats["segments_removed"] == len(on_disk - live)
    assert stats["bytes_reclaimed"] > 0
    assert {os.path.basename(f)[:-4] for f in _state_files(store)} == live
    warm = tpipe(store).run(os.fspath(path))
    assert warm.exec_stats.segments_rescanned == 0
    assert_bit_identical(warm, tpipe().run(os.fspath(path)))
    assert SegmentStore.compact_dir(tmp_path / "nowhere") == {
        "segments_kept": 0, "segments_removed": 0, "bytes_reclaimed": 0,
        "history_dropped": 0}


def test_history_and_max_history(tmp_path):
    data = corpus(80, seed=3)
    store = tmp_path / "st"
    path = tmp_path / "d.nt"
    p = tpipe(metrics="paper").incremental(
        os.fspath(store), segment_bytes=SEG, max_history=3,
        dataset_uri="urn:test:d")
    assert p.exec.max_history == 3 and p.exec.dataset_uri == "urn:test:d"
    for i in range(5):
        path.write_bytes(data + bsbm_ntriples(i + 1, seed=i).encode())
        p.run(os.fspath(path))
    hist = report.load_history(store / "history.jsonl")
    assert len(hist) == 3
    counts = [h["nTriples"] for h in hist]
    assert counts == sorted(counts) and counts[-1] > counts[0]
    assert all(h["dataset"] == "urn:test:d" for h in hist)
    assert hist[-1]["segments_reused"] >= 1
    assert report.to_dqv_history(hist)["snapshots"] == 3
    assert SegmentStore.compact_dir(store, max_history=1)[
        "history_dropped"] == 2
    assert len(report.load_history(store / "history.jsonl")) == 1
    with pytest.raises(ValueError, match="max_history"):
        qa.ExecutionConfig(max_history=-1)


def _verify_clean(store):
    return SegmentStore.verify_dir(store)


def _verify_damaged(store):
    files = _state_files(store)
    with open(files[0], "r+b") as f:       # flip a byte past the header
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    os.unlink(files[1])
    return SegmentStore.verify_dir(store)


def _verify_orphan(store):
    with open(os.path.join(os.fspath(store), "segments",
                           "feed" * 8 + ".seg"), "wb") as f:
        f.write(b"stray bytes not in any manifest")
    return SegmentStore.verify_dir(store)


@pytest.mark.parametrize("case", ["clean", "damaged", "orphan", "no-store"])
def test_verify(tmp_path, case):
    store = tmp_path / "st"
    data = corpus(200, seed=6).decode()
    if case == "no-store":
        rep = SegmentStore.verify_dir(store)
        assert rep == {"exists": False, "clean": True, "segments_checked": 0,
                       "segments_ok": 0, "missing": [], "corrupt": [],
                       "orphans": 0}
        assert not os.path.exists(store)     # probing creates nothing
        return
    tpipe(store).run(data)
    rep = {"clean": _verify_clean, "damaged": _verify_damaged,
           "orphan": _verify_orphan}[case](store)
    assert rep["exists"]
    assert rep == JSegmentStore.verify_dir(store)
    if case == "clean":
        assert rep["clean"] and rep["segments_checked"] == \
            rep["segments_ok"] > 1
    elif case == "orphan":
        assert rep["clean"] and rep["orphans"] == 1
    else:
        assert not rep["clean"]
        assert len(rep["corrupt"]) == 1 and len(rep["missing"]) == 1
        assert "digest" in rep["corrupt"][0]["issue"]
        res = tpipe(store).run(data)         # self-heals by rescanning
        assert res.exec_stats.bytes_rescanned > 0
        assert SegmentStore.verify_dir(store)["clean"]


# --- two monitors, one per package ----------------------------------------------

def _mini_state(cls, fp: str, seed: int):
    rng = np.random.default_rng(seed)
    return cls(fingerprint=fp, n_bytes=64, n_triples=2,
               counts=[rng.integers(0, 9, 3).astype(np.int64)],
               regs={"spo": rng.integers(0, 5, 16).astype(np.int32)},
               keys=[b"<http://x/a>", b"<http://x/b>"],
               flags=np.array([9, 9], np.int32),
               lengths=np.array([10, 10], np.int64),
               datatypes=np.array([0, 0], np.int32),
               ids=np.array([0, 1], np.int64))


def test_interleaved_commits_across_packages(tmp_path):
    """A JAX runner and a port runner in the race window (both load, one
    commits while the other holds pending work): the loser's pending
    state survives the winner's GC, its commit CASes past the winner's
    version and may reference what only the winner froze, and what each
    froze the other loads."""
    sig = {"format": 1, "plane_layout": 2, "test": True}
    d = os.fspath(tmp_path / "st")
    j_store, t_store = JSegmentStore(d, sig), SegmentStore(d, sig)
    assert j_store.version == t_store.version == 0
    j_store.put_state(_mini_state(JSegmentState, "aaaa", 1))
    t_store.put_state(_mini_state(SegmentState, "bbbb", 2))
    t_store.commit([{"fp": "bbbb", "n_bytes": 64, "n_triples": 2}])
    assert t_store.version == 1
    assert os.path.exists(os.path.join(d, "segments", "aaaa.seg"))
    j_store.commit([{"fp": "aaaa", "n_bytes": 64, "n_triples": 2},
                    {"fp": "bbbb", "n_bytes": 64, "n_triples": 2}])
    assert j_store.version == 2
    fresh = SegmentStore(d, sig)
    assert fresh.version == 2
    assert [s["fp"] for s in fresh.known_segments] == ["aaaa", "bbbb"]
    for fp, seed in (("aaaa", 1), ("bbbb", 2)):
        want = _mini_state(SegmentState, fp, seed)
        got = fresh.load_state(fp)
        np.testing.assert_array_equal(got.counts[0], want.counts[0])
        np.testing.assert_array_equal(got.regs["spo"], want.regs["spo"])
        assert got.counts[0].dtype == np.int64
        assert got.regs["spo"].dtype == np.int32


def test_two_monitors_one_per_package_on_one_store(tmp_path):
    """A JAX monitor and a port monitor assessing two versions of a dataset
    against one store at once: both complete, the manifest stays monotone,
    and the final warm run is the cold result."""
    data = corpus(150, seed=31)
    edited = data + bsbm_ntriples(5, seed=32).encode()
    store = os.fspath(tmp_path / "st")
    gate = threading.Barrier(2, timeout=30)
    errors = []

    def monitor(make, ds: bytes):
        try:
            gate.wait()
            for _ in range(2):
                make(store).run(ds.decode())
        except Exception as e:               # pragma: no cover - fail loudly
            errors.append(e)

    threads = [threading.Thread(target=monitor, args=(jpipe, data)),
               threading.Thread(target=monitor, args=(tpipe, edited))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    final = tpipe(store).run(edited.decode())
    assert_bit_identical(final, tpipe().run(edited.decode()))
    st = SegmentStore(store, engine_signature(tpipe().evaluator(), BASE))
    assert st.version >= 5
    assert st.known_segments


# --- the API surface ------------------------------------------------------------

def test_incremental_pipeline_surface(tmp_path):
    import gzip
    text = bsbm_ntriples(80, seed=2)
    store = os.fspath(tmp_path / "st")
    res = qa.assess(text, metrics="paper", base=BASE, device="cpu",
                    store=store, segment_bytes=SEG)
    assert res.exec_stats.bytes_total == len(text.encode())
    res2 = qa.assess(text, metrics="paper", base=BASE, device="cpu",
                     store=store, segment_bytes=SEG)
    assert res2.exec_stats.segments_rescanned == 0
    assert res2.values == res.values
    # a gzip twin (bytes and path) reuses every segment of the raw text
    gz = tmp_path / "d.nt.gz"
    gz.write_bytes(gzip.compress(text.encode()))
    p = tpipe(store, metrics="paper")
    for ds in (gzip.compress(text.encode()), os.fspath(gz), gz):
        assert p.run(ds).exec_stats.segments_rescanned == 0
    with pytest.raises(ValueError, match="segment_bytes"):
        qa.ExecutionConfig(segment_bytes=-1)
    with pytest.raises(TypeError, match="segment store"):
        p.run(p.single_shot().ingest(text))
    with pytest.raises(FileNotFoundError):
        p.run(os.fspath(tmp_path / "missing.nt"))
    with pytest.raises(TypeError):
        p.run(3.5)
    assert repr(p) == (f"qa.Pipeline[7 metrics | fused | fused_scan | "
                       f"hll_p=12 | incremental@{store} seg={SEG}B | cpu]")
    assert "async×2" in repr(p.pipelined(2))
    assert p.single_shot().exec.store_dir is None
    assert p.evaluator() is p.single_shot().evaluator()   # shared engine
    assert repr(p.chunked(4, checkpoint_dir="c").incremental(store)) \
        .count("ckpt") == 0


def test_incremental_on_a_missing_card_fails_even_when_warm(tmp_path):
    """The default device is the card: where there is none, a warm store
    (nothing to rescan) fails as a cold one does, never a silent CPU
    run."""
    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    data = corpus(100, seed=1).decode()
    store = tmp_path / "st"
    tpipe(store).run(data)
    on_card = qa.pipeline().metrics("all").base(*BASE).incremental(
        os.fspath(store), segment_bytes=SEG)
    K.reset_launches()
    with pytest.raises((RuntimeError, AssertionError)):
        on_card.run(data)
    assert K.LAUNCHES == {"qap_count": 0, "fused_scan": 0, "hll_fold": 0}


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("backend,metrics,launch", [
    ("fused_scan", "all", {"fused_scan": 1}),
    ("fused_scan", "paper", {"qap_count": 1}),
    ("twopass", "all", {"qap_count": 1, "hll_fold": 2}),
], ids=["fused_scan", "paper", "twopass"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_gpu_incremental_matches_plain_backend_and_launches_per_rescan(
        cuda, tmp_path, backend, metrics, launch, prefetch):
    """Incremental runs on the card through the scan kernels: every step
    equals the plain backend on the card, each rescanned segment launches
    the backend's kernels once (``hll_fold`` once per sketch), a warm run
    launches nothing."""
    rng = np.random.default_rng(5)
    data = corpus(300, seed=12)
    p = (qa.pipeline().metrics(metrics).backend(backend).base(*BASE)
         .incremental(os.fspath(tmp_path / "st"), segment_bytes=SEG)
         .pipelined(prefetch))
    for step in ("cold", "warm", "edit", "edit"):
        if step == "edit":
            data = _random_edit(rng, data)
        K.reset_launches()
        res = p.run(data.decode())
        launched = dict(K.LAUNCHES)
        plain = qa.assess(data.decode(), metrics=metrics, backend="torch",
                          base=BASE)
        assert_bit_identical(res, plain)
        n = res.exec_stats.segments_rescanned
        assert launched == {k: launch.get(k, 0) * n for k in launched}, step
        assert res.passes == n * res.exec_stats.passes_per_chunk
        if step == "warm":
            assert n == 0 and res.exec_stats.bytes_rescanned == 0


@pytest.mark.gpu
def test_gpu_store_reused_from_the_cpu_and_jax(cuda, tmp_path):
    """Stores written on the CPU (by the port and by the JAX package) are
    reused on the card with no launch, and an edit rescans on the card the
    segments the CPU run rescans."""
    data = corpus(250, seed=9).decode()

    def on_card(store):
        return qa.pipeline().metrics("all").base(*BASE).incremental(
            os.fspath(store), segment_bytes=SEG)

    for writer in (tpipe, jpipe):
        store = tmp_path / writer.__name__
        writer(store).run(data)
        K.reset_launches()
        warm = on_card(store).run(data)
        assert warm.exec_stats.segments_rescanned == 0
        assert sum(K.LAUNCHES.values()) == 0
        assert_bit_identical(warm, tpipe().run(data))
    edited = data + bsbm_ntriples(5, seed=77)
    shutil.copytree(tmp_path / "tpipe", tmp_path / "copy")
    K.reset_launches()
    res = on_card(tmp_path / "tpipe").run(edited)
    cpu = tpipe(tmp_path / "copy").run(edited)
    assert stats_of(res) == stats_of(cpu)
    assert K.LAUNCHES["fused_scan"] == res.exec_stats.segments_rescanned >= 1
    assert_bit_identical(res, cpu)
