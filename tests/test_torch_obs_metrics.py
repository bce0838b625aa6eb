"""The port's `obs` metrics against the reference's, on the same samples:
`latency_summary`, `Histogram` summaries (with the reservoir's
decimation), `SLOTracker` summaries with and without a target, and the
registry. Both are host-side numpy code, so the results must be equal.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import math

import numpy as np
import pytest

from repro.obs import metrics as ref_metrics
from repro_torch.obs import metrics


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(b[k], float) and math.isnan(b[k]):
            assert math.isnan(a[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("count", (0, 1, 37, 250))
def test_latency_summary_matches_reference(count):
    lats = np.random.default_rng(count).lognormal(-5.0, 0.7, size=count)
    _same(metrics.latency_summary(lats, 1.7),
          ref_metrics.latency_summary(lats, 1.7))
    _same(metrics.latency_summary(lats), ref_metrics.latency_summary(lats))


@pytest.mark.parametrize("max_samples", (65536, 64))
def test_histogram_matches_reference(max_samples):
    """Quantiles, mean and max; a small reservoir decimates identically."""
    xs = np.random.default_rng(1).exponential(3.0, size=500)
    h = metrics.Histogram("h", max_samples=max_samples)
    h_ref = ref_metrics.Histogram("h", max_samples=max_samples)
    h.observe_many(xs)
    h_ref.observe_many(xs)
    _same(h.summary(), h_ref.summary())
    assert h.percentiles((10, 50, 95)) == h_ref.percentiles((10, 50, 95))
    assert h.count == h_ref.count == 500
    h.reset()
    _same(h.summary(), ref_metrics.Histogram("e").summary())


@pytest.mark.parametrize("target_ms", (None, 12.0))
def test_slo_tracker_matches_reference(target_ms):
    """Summary, breaches and burn rate on the same latencies and clock; QPS
    decays once the window has passed."""
    rng = np.random.default_rng(2)
    lats = rng.lognormal(-4.5, 0.6, size=120)
    t = metrics.SLOTracker("s", window_s=5.0, target_ms=target_ms)
    t_ref = ref_metrics.SLOTracker("s", window_s=5.0, target_ms=target_ms)
    breaches = []
    for i, lat in enumerate(lats):
        now = 100.0 + 0.05 * i
        breaches.append((t.record(lat, rows=3, now=now),
                         t_ref.record(lat, rows=3, now=now)))
    assert all(a == b for a, b in breaches)
    for now in (106.0, 200.0):
        _same(t.summary(now=now), t_ref.summary(now=now))
    assert t.summary(now=200.0)["qps"] == 0.0
    if target_ms is not None:
        s = t.summary(now=106.0)
        assert s["breaches"] == sum(lats * 1e3 > target_ms) > 0
        assert s["burn_rate"] == s["breaches"] / 120


def test_registry_matches_reference():
    reg, reg_ref = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    for r in (reg, reg_ref):
        r.counter("serve.fleet.loads").inc(3)
        r.gauge("serve.inflight").set(2)
        r.histogram("serve.batch_rows").observe_many([8, 16, 64])
        r.slo("serve.slo.m").record(0.01, now=1.0)
    snap, snap_ref = reg.snapshot(), reg_ref.snapshot()
    assert list(snap) == list(snap_ref)
    for k in snap:
        if isinstance(snap[k], dict):
            _same(snap[k], snap_ref[k])
        else:
            assert snap[k] == snap_ref[k]
    with pytest.raises(TypeError):
        reg.gauge("serve.fleet.loads")
    reg.reset("serve.")
    assert reg.counter("serve.fleet.loads").value == 0
