"""The port's span tracing inside the serving path (`repro_torch.obs.trace`).

* Window totals: count, total and self time per span name, on two threads;
  reset by `enable_tracing`, kept after `disable_tracing` and carried by
  its closing snapshot.
* Parent links in the JSONL.
* Host-only spans enter `torch.profiler` as ranges while tracing is on, on
  the profiler's own clock; other spans never do.
* With tracing off every kind of span is the shared null singleton.
* A `MicroBatcher` over a CPU `PredictionEngine` (the benchmark's batcher
  settings, 4096-row requests, 1024-row chunks): each serving span a
  batch, and the exact count of reads from the card a batch, on the
  block-sparse backend (the Morton sort and each chunk's tile list) and on
  the dense one.
* The benchmark's four readers of those totals (`gpbench/metrics/`, loaded
  by path), and None when the program keeps no span totals.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.obs import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _clean():
    obs.disable_tracing(snapshot_metrics=False)
    obs.drain_events()
    obs.registry().reset()
    yield
    obs.disable_tracing(snapshot_metrics=False)
    obs.drain_events()
    obs.registry().reset()


def _run_threads(fn, n):
    ts = [threading.Thread(target=fn) for _ in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in ts)


def _nested():
    for _ in range(3):
        with obs.span("outer"):
            time.sleep(0.002)
            with obs.host_span("inner"):
                time.sleep(0.001)
            with obs.read_span("inner_read"):
                pass


def test_window_totals_self_time_reset_and_snapshot():
    obs.enable_tracing(None)
    _run_threads(_nested, 2)
    late = obs.span("late")
    late.__enter__()
    obs.disable_tracing()
    late.__exit__(None, None, None)   # closes with tracing off: not counted
    events = obs.drain_events()
    snap = obs.registry().snapshot()
    outer, inner, read = (snap[f"span.{n}"] for n in ("outer", "inner", "inner_read"))
    assert (outer["kind"], inner["kind"], read["kind"]) == ("plain", "host", "read")
    assert outer["count"] == inner["count"] == read["count"] == 6
    assert "span.late" not in snap
    assert outer["self_ms"] == pytest.approx(
        outer["total_ms"] - inner["total_ms"] - read["total_ms"], rel=1e-9)
    assert outer["self_ms"] >= 6 * 2.0 and inner["total_ms"] >= 6 * 1.0
    for s in (inner, read):
        assert s["self_ms"] == pytest.approx(s["total_ms"], rel=1e-12)
    durs = [e["dur"] for e in events if e.get("name") == "outer"]
    # the JSONL stamps whole microseconds: each span within 1 us of its total
    assert abs(sum(durs) / 1e3 - outer["total_ms"]) <= len(durs) * 1e-3
    closing = [e for e in events if e.get("name") == "repro.metrics"]
    assert closing[-1]["args"]["span.outer"] == outer      # the snapshot carries them
    obs.enable_tracing(None)                               # a new window
    assert obs.registry().snapshot()["span.outer"]["count"] == 0


def test_parent_ids_in_the_jsonl(tmp_path):
    path = tmp_path / "t.jsonl"
    with obs.trace_session(str(path)):
        _run_threads(_nested, 2)
        with obs.span("root"):
            with obs.span("mid"):
                with obs.host_span("leaf"):
                    pass
    spans = [json.loads(line) for line in path.read_text().splitlines()]
    spans = [e for e in spans if e.get("ph") == "X"]
    by_id = {e["span_id"]: e for e in spans}
    assert len(by_id) == len(spans) == 6 * 3 + 3
    for e in spans:
        parent = by_id.get(e["parent_id"])
        if e["name"] in ("outer", "root"):
            assert e["parent_id"] is None
        else:
            assert parent["name"] == {"inner": "outer", "inner_read": "outer",
                                      "mid": "root", "leaf": "mid"}[e["name"]]
            assert parent["tid"] == e["tid"]
            assert parent["ts"] <= e["ts"] and \
                e["ts"] + e["dur"] <= parent["ts"] + parent["dur"]
    assert len({e["tid"] for e in spans if e["name"] == "outer"}) == 2


def _kineto_events(prof):
    return [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()]


def test_host_spans_are_profiler_ranges_on_its_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.host_span("host_off"):
            pass
        obs.enable_tracing(None)
        with obs.host_span("host_on"):
            time.sleep(0.001)
        with obs.span("plain_on"):
            with obs.read_span("read_on"):
                pass
        obs.disable_tracing(snapshot_metrics=False)
    events = {e["name"]: e for e in obs.drain_events() if e.get("ph") == "X"}
    ranges = dict(_kineto_events(prof))
    assert "host_on" in ranges
    assert not {"host_off", "plain_on", "read_on"} & set(ranges)
    assert abs(events["host_on"]["ts"] - ranges["host_on"] / 1e3) <= 500.0


@pytest.mark.parametrize("make", (obs.span, obs.host_span, obs.read_span),
                         ids=lambda f: f.__name__)
def test_tracing_off_is_the_null_singleton(make):
    assert not obs.tracing_enabled()
    sp = make("x", rows=4)
    assert sp is trace._NULL_SPAN and make("y") is sp
    with sp as inner:
        assert inner.set(a=1) is sp
    assert not any(v["count"] for k, v in obs.registry().snapshot().items()
                   if k.startswith("span."))


# -- the serving path -----------------------------------------------------------

ROWS, CHUNK, BATCHES = 4096, 1024, 3
CHUNKS = ROWS // CHUNK
# each new span a batch: the wait, assembly, scatter and two reads of the
# block's results, plus on the block-sparse backend the sort's read and the
# sort, and per chunk of the mean's and of the variance's cross product its
# tile count, tile list and CSR
PER_BATCH = {
    "pallas": {"serve_batch_wait": 1, "serve_assemble": 1, "serve_scatter": 1,
               "serve_to_host": 2},
    "blocksparse": {"serve_batch_wait": 1, "serve_assemble": 1, "serve_scatter": 1,
                    "serve_to_host": 2, "serve_sort_read": 1, "serve_morton_sort": 1,
                    "sparse_tile_count": 2 * CHUNKS, "sparse_tile_list": 2 * CHUNKS,
                    "sparse_csr": 2 * CHUNKS},
}
READS = {"pallas": 2, "blocksparse": 1 + 2 * 2 * CHUNKS + 2}


def _engine(backend):
    from repro_torch.core.kernels_math import init_kernel_params, init_params
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.serve import PredictionEngine, fit_posterior

    rng = np.random.default_rng(3)
    if backend == "pallas":
        X = rng.standard_normal((512, 9)).astype(np.float32)
        y = np.sin(X @ rng.standard_normal(9)).astype(np.float32)
        params = init_params(lengthscale=3.0, outputscale=1.0, noise=0.05)
        kernel = "matern32"
    else:
        X = rng.uniform(size=(1024, 2)).astype(np.float32)
        y = (np.sin(6 * X[:, 0]) * np.cos(4 * X[:, 1])).astype(np.float32)
        kernel = "matern32 * wendland2"
        params = init_kernel_params(kernel, lengthscale=0.2, radius=0.15, noise=0.1)
    op = make_operator(OperatorConfig(kernel=kernel, backend=backend, row_block=64),
                       X, params, device="cpu")
    art = fit_posterior(op, y, v0=torch.as_tensor(rng.standard_normal(X.shape[0]),
                                                  dtype=torch.float32),
                        precond_rank=16, lanczos_rank=16, pred_tol=0.01)
    return PredictionEngine(art, chunk_size=CHUNK, device="cpu"), X.shape[1]


def _serve_window(backend):
    """The benchmark's batcher settings, one client, BATCHES requests of ROWS
    rows, traced; the registry's span totals afterwards."""
    from repro_torch.serve import BatcherConfig, MicroBatcher

    engine, d = _engine(backend)
    rng = np.random.default_rng(4)
    obs.enable_tracing(None)
    with MicroBatcher(engine, BatcherConfig(max_batch=128, max_wait_ms=2.0,
                                            bucket_sizes=(16, 64, 128))) as mb:
        for _ in range(BATCHES):
            q = rng.uniform(size=(ROWS, d)).astype(np.float32)
            mean, var = mb.submit(q).result(timeout=TIMEOUT)
            assert mean.shape == var.shape == (ROWS,)
        deadline = time.monotonic() + TIMEOUT
        while mb.batches_run < BATCHES and time.monotonic() < deadline:
            time.sleep(0.001)   # the last batch's scatter closes after its reply
        assert mb.batches_run == BATCHES
        obs.disable_tracing(snapshot_metrics=False)
    obs.drain_events()
    return {k[len("span."):]: v for k, v in obs.registry().snapshot().items()
            if k.startswith("span.") and v["count"]}


@pytest.mark.parametrize("backend", ("blocksparse", "pallas"))
def test_batcher_spans_and_reads_a_batch(backend):
    spans = _serve_window(backend)
    assert spans["serve_batch"]["count"] == BATCHES
    assert spans["serve_predict"]["count"] == BATCHES
    counts = {name: spans[name]["count"] / BATCHES for name in PER_BATCH[backend]}
    assert counts == PER_BATCH[backend]
    if backend == "pallas":
        assert not {n for n in spans if n.startswith("sparse_")}
    reads = sum(v["count"] for v in spans.values() if v["kind"] == "read")
    assert reads == READS[backend] * BATCHES
    kinds = {name: spans[name]["kind"] for name in PER_BATCH[backend]}
    assert {n for n, k in kinds.items() if k == "read"} == \
        {"serve_to_host", "serve_sort_read", "sparse_tile_count",
         "sparse_tile_list"} & set(kinds)
    assert {n for n, k in kinds.items() if k == "host"} == set(kinds) - \
        {"serve_to_host", "serve_sort_read", "sparse_tile_count", "sparse_tile_list"}


def _reader(name):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from gpbench.harness import manifest

    return manifest.load_reader(name, os.path.join(ROOT, "gpbench"))


def _expected(name, spans):
    host = sum(v["self_ms"] for n, v in spans.items()
               if v["kind"] == "host" and n != "serve_batch_wait")
    return {"serve.batch_wait_ms": spans["serve_batch_wait"]["self_ms"] / BATCHES,
            "serve.host_ms_per_batch": host / BATCHES,
            "serve.host_ms_per_batch.taper": host / BATCHES,
            "serve.host_reads_per_batch.taper": READS["blocksparse"]}[name]


@pytest.mark.parametrize("name", ("serve.batch_wait_ms", "serve.host_ms_per_batch",
                                  "serve.host_ms_per_batch.taper",
                                  "serve.host_reads_per_batch.taper"))
def test_readers_on_the_totals_and_none_without(name, monkeypatch):
    read = _reader(name)
    assert read({}) is None                     # no traced window yet
    spans = _serve_window("blocksparse")
    value = read({"cell": "taper-serve"})
    assert value == pytest.approx(_expected(name, spans), rel=1e-12)
    assert value > 0
    # a program that keeps no span totals (the parent commit's)
    monkeypatch.setattr(obs, "registry", lambda: obs.MetricsRegistry())
    assert read({"cell": "taper-serve"}) is None
