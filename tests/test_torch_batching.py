"""The port's ContinuousBatcher against the reference's tests and engine.

The ports of the reference's `test_continuous_batcher_{matches_direct,
multimodel_fairness, remove_model_fails_pending, close_fails_undelivered}`
(`tests/test_serve.py`), on port engines restored from an artifact the
reference wrote, with the served predictions held against the reference's
engine (values 1e-10 in float64, the conformance tolerance); the request
spans' names and argument keys against the reference's scheduler; and the
kernel launch counters under concurrent increments. Every future wait has
a timeout and every batcher is closed in a `with` or `finally`.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core import OperatorConfig as RefConfig
from repro.core import init_params as ref_init_params
from repro.core import make_operator as ref_make
from repro.serve import PredictionEngine as RefEngine
from repro.serve import artifact as ref_artifact
from repro.serve.batching import ContinuousBatcher as RefBatcher
from repro.serve.batching import SchedulerConfig as RefSchedulerConfig
from repro_torch import obs
from repro_torch.kernels import kmvm
from repro_torch.serve import (
    ContinuousBatcher, PredictionEngine, SchedulerConfig, load_artifact,
)

TIMEOUT = 30
VAL_TOL = 1e-10


def _data(n=160, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sin(X @ rng.normal(size=d)) + 0.1 * rng.normal(size=n)
    return X, y


def _ref_artifact(X, y, seed=0):
    op = ref_make(RefConfig(kernel="matern32", backend="partitioned",
                            row_block=32), jnp.asarray(X),
                  ref_init_params(noise=0.2, dtype=jnp.float64))
    return ref_artifact.fit_posterior(op, jnp.asarray(y),
                                      jax.random.PRNGKey(seed), precond_rank=30,
                                      lanczos_rank=40, pred_tol=1e-4)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(port engine, reference engine) over one reference-written artifact,
    and the same pair over a second one fit on half the rows."""
    X, y = _data()
    out = []
    for i, rows in enumerate((X.shape[0], X.shape[0] // 2)):
        art_ref = _ref_artifact(X[:rows], y[:rows], seed=i)
        path = str(tmp_path_factory.mktemp(f"art{i}"))
        ref_artifact.save_artifact(path, art_ref)
        out.append((PredictionEngine(load_artifact(path, device="cpu"),
                                     chunk_size=32, device="cpu"),
                    RefEngine(ref_artifact.load_artifact(path), chunk_size=32)))
    return out


def _direct(engine, q):
    return [a.numpy() for a in engine.predict(q)]


def _close(a, b):
    np.testing.assert_allclose(a, np.asarray(b), rtol=VAL_TOL,
                               atol=VAL_TOL * np.abs(np.asarray(b)).max())


def test_continuous_batcher_matches_direct(engines):
    """Concurrent requests through the scheduler == direct engine calls,
    and the reference's engine serves the same."""
    (engine, ref_engine), _ = engines
    rng = np.random.default_rng(1)
    reqs = [rng.normal(size=(int(rng.integers(1, 7)), 3)) for _ in range(24)]
    with ContinuousBatcher(engine, SchedulerConfig(
            max_batch=32, bucket_sizes=(8, 32))) as cb:
        with ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(lambda q: cb.predict(q, timeout=TIMEOUT), reqs))
        assert cb.requests_served == len(reqs)
        assert 0 < cb.batches_run <= len(reqs)
    for q, (m, v) in zip(reqs, outs):
        ref_m, ref_v = _direct(engine, q)
        np.testing.assert_allclose(m, ref_m, rtol=1e-12)
        np.testing.assert_allclose(v, ref_v, rtol=1e-12)
        m_ref, v_ref = ref_engine.predict(q)
        _close(m, m_ref)
        _close(v, v_ref)


def test_continuous_batcher_multimodel_fairness(engines):
    """Two models share the scheduler: every request is answered by its
    model's engine, and a flood on one cannot starve the other."""
    (ea, ea_ref), (eb, eb_ref) = engines
    rng = np.random.default_rng(2)
    with ContinuousBatcher({"a": ea, "b": eb}, SchedulerConfig(
            max_batch=16, bucket_sizes=(8, 16))) as cb:
        flood_q = [rng.normal(size=(4, 3)) for _ in range(40)]
        trickle_q = [rng.normal(size=(2, 3)) for _ in range(4)]
        flood = [cb.submit(q, model="a") for q in flood_q]
        trickle = [cb.submit(q, model="b") for q in trickle_q]
        outs_b = [f.result(timeout=TIMEOUT) for f in trickle]
        outs_a = [f.result(timeout=TIMEOUT) for f in flood]
    for q, (m, v) in zip(trickle_q, outs_b):
        np.testing.assert_allclose(m, _direct(eb, q)[0], rtol=1e-12)
        _close(m, eb_ref.predict(q)[0])
        assert not np.allclose(m, _direct(ea, q)[0])
    for q, (m, v) in zip(flood_q[:3], outs_a[:3]):
        np.testing.assert_allclose(m, _direct(ea, q)[0], rtol=1e-12)
        _close(m, ea_ref.predict(q)[0])


def test_continuous_batcher_remove_model_fails_pending(engines):
    (engine, _), _ = engines
    cb = ContinuousBatcher({"m": engine},
                           SchedulerConfig(max_batch=8, max_inflight=1))
    try:
        with pytest.raises(KeyError):
            cb.predict(np.zeros((1, 3)), model="ghost", timeout=TIMEOUT)
        cb.remove_model("m")
        with pytest.raises(KeyError):
            cb.submit(np.zeros((1, 3)), model="m")
    finally:
        cb.close()


def test_continuous_batcher_close_fails_undelivered(engines):
    (engine, _), _ = engines
    cb = ContinuousBatcher(engine, SchedulerConfig())
    cb.close()
    cb.close()  # idempotent
    with pytest.raises(RuntimeError):
        cb.submit(np.zeros((1, 3)))


def test_continuous_batcher_fails_mixed_widths_and_keeps_serving(engines):
    """A block whose requests cannot be stacked fails those requests and
    the scheduler goes on serving."""
    (engine, _), _ = engines
    with ContinuousBatcher(engine, SchedulerConfig(max_inflight=1)) as cb:
        with cb._lock:  # both land in one block
            bad = [cb.submit(np.zeros((1, 3))), cb.submit(np.zeros((1, 2)))]
        for f in bad:
            with pytest.raises(ValueError):
                f.result(timeout=TIMEOUT)
        m, _ = cb.predict(np.zeros((2, 3)), timeout=TIMEOUT)
        assert m.shape == (2,)


def _request_spans(batcher_cls, config_cls, tracer, to_out):
    class FakeEngine:
        def predict(self, X):
            return to_out(np.zeros(X.shape[0])), to_out(np.ones(X.shape[0]))

    tracer.enable_tracing(None)
    try:
        with batcher_cls(FakeEngine(), config_cls(max_batch=8)) as cb:
            futs = [cb.submit(np.zeros((2, 3))) for _ in range(5)]
            for f in futs:
                f.result(timeout=TIMEOUT)
        events = tracer.drain_events()
    finally:
        tracer.disable_tracing(snapshot_metrics=False)
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            spans.setdefault(e["name"], set()).add(tuple(sorted(e["args"])))
    return spans, {e["tid"] for e in events
                   if e.get("ph") == "X" and e["name"] == "serve_request"}


def test_request_spans_match_reference():
    """The scheduler's spans (per-request flow and the block span): the
    reference's names and argument keys, one synthetic tid per request;
    beside them only the port's spans of the host's work on a block."""
    spans, tids = _request_spans(ContinuousBatcher, SchedulerConfig, obs,
                                 torch.as_tensor)
    spans_ref, tids_ref = _request_spans(RefBatcher, RefSchedulerConfig,
                                         ref_obs, np.asarray)
    host_work = {"serve_assemble", "serve_scatter", "serve_to_host"}
    assert set(spans) - set(spans_ref) == host_work
    assert {k: v for k, v in spans.items() if k not in host_work} == spans_ref
    assert {"serve_request", "serve_queue", "serve_solve",
            "serve_block"} <= set(spans)
    assert len(tids) == len(tids_ref) == 5
    assert all(str(t).startswith("req:r") for t in tids)
    snap = obs.registry().snapshot()
    assert snap["serve.inflight"] == 0
    assert "serve.deficit.default" in snap
    assert snap["serve.queue_depth.default"] is not None


def test_launch_counts_stay_whole_under_threads():
    """Batcher workers count kernel launches from several threads: with a
    short switch interval and more threads than cores, no increment is
    lost."""
    threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    kmvm.reset_launch_counts()
    try:
        ts = [threading.Thread(target=lambda: [kmvm._count("kmvm")
                                               for _ in range(per)])
              for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in ts)
        assert kmvm.launch_counts["kmvm"] == threads * per
    finally:
        sys.setswitchinterval(old)
        kmvm.reset_launch_counts()
