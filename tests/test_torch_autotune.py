"""The column-split autotuner (`repro_torch.kernels.autotune`): the
reference's `tests/test_autotune.py` and `test_obs.py::test_autotune_counters`
on the port, with an injected `measure` and device name (they need no card),
plus what is the port's own:

* the key never holds the launch's row count;
* a miss while a CUDA graph is captured (or under torch.compile) falls back
  to the static split without memoizing;
* `PallasFusedOperator` hands the tuned split to B1 and B2 (the same split
  for the same t), and serving's cross launches keep the static one;
* on the CPU `autotune=True` changes no bit (the plain versions have no
  split), and `tiles_for_spec` sweeps nothing there;
* `_column_split` at every candidate depends on n only.

Kernel launches at every candidate against the plain version, and the
row-count and B2 == B1 pins at the tuned split, need the card:
tests/test_torch_gpu.py.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import inspect
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.kernels_math import init_params
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.kernels import autotune, kmvm, ops
from repro_torch.kernels.autotune import (
    DEFAULT_CANDIDATES,
    DEFAULT_TILES,
    autotune_tiles,
    cache_key,
    clear_memo,
    key_hash,
    prewarm,
    shape_bucket,
    tiles_for_spec,
)

COMPONENTS = (("rbf", "matern32"),)
CARD = "NVIDIA H100 80GB HBM3"          # an injected device name
ARGS = dict(compute_dtype="float32", device_name=CARD)


@pytest.fixture(autouse=True)
def _fresh_memo():
    clear_memo()
    obs.registry().reset("autotune.")
    yield
    clear_memo()


def _fixed_measure(table):
    """Deterministic injectable measure; records the sweep order."""
    calls = []

    def measure(split):
        calls.append(split)
        return table.get(split, 1.0)

    measure.calls = calls
    return measure


# ---------------------------------------------------------------------------
# the reference's tests/test_autotune.py
# ---------------------------------------------------------------------------


def test_sweep_picks_minimum_and_persists(tmp_path):
    cdir = str(tmp_path)
    measure = _fixed_measure({128: 0.1, 16: 0.5})
    choice = autotune_tiles(COMPONENTS, 1000, 1000, 8, 9, **ARGS,
                            candidates=DEFAULT_CANDIDATES, measure=measure,
                            cache_dir=cdir)
    assert choice == 128
    assert measure.calls == list(DEFAULT_CANDIDATES)
    # one entry on disk, named by the content hash, carrying the timings
    files = os.listdir(cdir)
    assert len(files) == 1
    key = cache_key(COMPONENTS, 1000, 1000, 8, 9, **ARGS)
    assert files[0] == key_hash(key) + ".json"
    with open(os.path.join(cdir, files[0])) as f:
        entry = json.load(f)
    assert entry["tiles_per_split"] == 128
    assert entry["key"] == key
    assert entry["timings"]["128"] == pytest.approx(0.1)
    assert set(entry["timings"]) == {str(c) for c in DEFAULT_CANDIDATES}


def test_disk_roundtrip_skips_measurement(tmp_path):
    cdir = str(tmp_path)
    m1 = _fixed_measure({0: 0.01})
    first = autotune_tiles(COMPONENTS, 500, 500, 4, 3, **ARGS, measure=m1,
                           cache_dir=cdir)
    assert first == 0
    # a fresh process (memo cleared) must hit the disk entry, not re-sweep
    clear_memo()
    m2 = _fixed_measure({16: 0.0})  # would pick differently
    second = autotune_tiles(COMPONENTS, 500, 500, 4, 3, **ARGS, measure=m2,
                            cache_dir=cdir)
    assert second == first
    assert m2.calls == []


def test_memo_skips_disk(tmp_path):
    cdir = str(tmp_path)
    measure = _fixed_measure({})
    first = autotune_tiles(COMPONENTS, 64, 64, 2, 1, **ARGS, measure=measure,
                           cache_dir=cdir)
    os.unlink(os.path.join(cdir, os.listdir(cdir)[0]))
    second = autotune_tiles(COMPONENTS, 64, 64, 2, 1, **ARGS, measure=measure,
                            cache_dir=cdir)
    assert second == first
    assert len(measure.calls) == len(DEFAULT_CANDIDATES)  # swept only once


def test_tie_breaks_toward_earliest_candidate(tmp_path):
    # every candidate times identically -> the FIRST in the sweep wins
    measure = _fixed_measure({c: 0.25 for c in DEFAULT_CANDIDATES})
    choice = autotune_tiles(COMPONENTS, 256, 256, 4, 2, **ARGS, measure=measure,
                            cache_dir=str(tmp_path))
    assert choice == DEFAULT_CANDIDATES[0]


def test_deterministic_under_fixed_measure(tmp_path):
    table = {32: 0.3, 128: 0.2, 256: 0.7}
    picks = []
    for i in range(3):
        clear_memo()
        picks.append(autotune_tiles(
            COMPONENTS, 2048, 2048, 16, 9, **ARGS, measure=_fixed_measure(table),
            cache_dir=str(tmp_path / f"run{i}")))
    assert picks == [128] * 3


def test_shape_bucket_is_next_pow2():
    assert [shape_bucket(x) for x in (1, 2, 3, 64, 65, 1000, 1024)] == \
        [1, 2, 4, 64, 128, 1024, 1024]


def test_key_invalidates_on_dtype_device_and_shape_bucket():
    k0 = cache_key(COMPONENTS, 1000, 1000, 8, 9, **ARGS)
    # same bucket (513..1024 -> 1024): same key, cache hit
    assert key_hash(cache_key(COMPONENTS, 700, 513, 8, 9, **ARGS)) == key_hash(k0)
    kd = cache_key(COMPONENTS, 1000, 1000, 8, 9, compute_dtype="bfloat16",
                   device_name=CARD)
    kc = cache_key(COMPONENTS, 1000, 1000, 8, 9, compute_dtype="float32",
                   device_name="NVIDIA H200")
    kn = cache_key(COMPONENTS, 1025, 1025, 8, 9, **ARGS)
    kdd = cache_key(COMPONENTS, 1000, 1000, 9, 9, **ARGS)
    kt = cache_key(COMPONENTS, 1000, 1000, 8, 17, **ARGS)
    ks = cache_key((("rbf",),), 1000, 1000, 8, 9, **ARGS)
    hashes = {key_hash(k) for k in (k0, kd, kc, kn, kdd, kt, ks)}
    assert len(hashes) == 7


def test_cache_hit_across_shapes_in_same_bucket(tmp_path):
    cdir = str(tmp_path)
    a = autotune_tiles(COMPONENTS, 900, 900, 5, 3, **ARGS,
                       measure=_fixed_measure({32: 0.0}), cache_dir=cdir)
    clear_memo()
    m2 = _fixed_measure({256: 0.0})
    # n 900 -> 1024 and 600 -> 1024, d 5 -> 8 and 7 -> 8, t 3 -> 4, 4 -> 4
    b = autotune_tiles(COMPONENTS, 600, 600, 7, 4, **ARGS, measure=m2,
                       cache_dir=cdir)
    assert b == a == 32
    assert m2.calls == []
    assert len(os.listdir(cdir)) == 1


def test_cache_miss_under_capture_falls_back_without_memoizing(tmp_path,
                                                                monkeypatch):
    """A miss while a CUDA graph is captured returns the static split (a
    timed launch is not allowed there) and persists nothing, so a later
    eager call still runs the real sweep."""
    cdir = str(tmp_path)
    monkeypatch.setattr(autotune, "_capturing", lambda: True)
    measure = _fixed_measure({})
    got = autotune_tiles(COMPONENTS, 64, 64, 2, 1, **ARGS, measure=measure,
                         cache_dir=cdir)
    assert got == DEFAULT_TILES == kmvm._SPLIT_TILES
    assert measure.calls == [] and os.listdir(cdir) == []
    assert obs.registry().snapshot()["autotune.trace_fallbacks"] == 1
    monkeypatch.setattr(autotune, "_capturing", lambda: False)
    eager = autotune_tiles(COMPONENTS, 64, 64, 2, 1, **ARGS,
                           measure=_fixed_measure({256: 0.0}), cache_dir=cdir)
    assert eager == 256
    assert len(os.listdir(cdir)) == 1


def test_tiles_for_spec_and_prewarm_route_through_cache(tmp_path):
    cdir = str(tmp_path)
    params = init_params(dtype=torch.float32)
    plan = ops.mvm_plan("matern32", params)
    # seed the cache entry via the low-level API at prewarm's key
    autotune_tiles(plan.passes[0].components, 64, 64, 3, 9, **ARGS,
                   measure=_fixed_measure({16: 0.9, 256: 0.1}), cache_dir=cdir)
    card = torch.device("cuda")  # only its type is read here; no launch
    got = prewarm("matern32", params, 64, 3, num_probes=8, device=card,
                  device_name=CARD, cache_dir=cdir)
    assert got == 256
    assert tiles_for_spec("matern32", params, 64, 64, 3, 9, device=card,
                          device_name=CARD, compute_dtype="float32",
                          cache_dir=cdir) == 256
    assert obs.registry().snapshot()["autotune.hits"] == 2


# ---------------------------------------------------------------------------
# the reference's test_obs.py::test_autotune_counters
# ---------------------------------------------------------------------------


def test_autotune_counters(tmp_path):
    components = (("matern32",),)
    calls = []

    def measure(split):
        calls.append(split)
        return 1.0 if split != 256 else 0.5

    args = dict(**ARGS, candidates=(128, 256), measure=measure,
                cache_dir=str(tmp_path))
    choice = autotune_tiles(components, 512, 512, 4, 9, **args)
    assert choice == 256 and len(calls) == 2
    snap = obs.registry().snapshot()
    assert snap["autotune.misses"] == 1 and snap["autotune.sweeps"] == 1
    assert snap["autotune.sweep_ms"]["count"] == 1
    # memo hit: no new sweep
    assert autotune_tiles(components, 512, 512, 4, 9, **args) == choice
    snap = obs.registry().snapshot()
    assert snap["autotune.hits"] == 1 and snap["autotune.sweeps"] == 1
    # disk hit after memo clear
    clear_memo()
    assert autotune_tiles(components, 512, 512, 4, 9, **args) == choice
    assert obs.registry().snapshot()["autotune.hits"] == 2
    assert len(calls) == 2  # measure never re-ran


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def test_key_has_no_row_count():
    """The entry points take the launch's rows `m` where the reference's
    do, but the key never holds it: a row's result must not depend on how
    many rows a launch holds, so every m shares the (n, n) launch's split
    (one sweep for two m: tests/test_torch_api_surface.py)."""
    key = cache_key(COMPONENTS, 1000, 1000, 8, 9, **ARGS)
    assert set(key) == {"device", "compute_dtype", "components", "n", "d", "t"}
    for m in (1, 64, 4096):
        assert cache_key(COMPONENTS, m, 1000, 8, 9, **ARGS) == key
    for fn, first in ((cache_key, "components"), (autotune_tiles, "components"),
                      (tiles_for_spec, "params")):
        names = list(inspect.signature(fn).parameters)
        i = names.index(first)
        assert names[i + 1:i + 5] == ["m", "n", "d", "t"], fn.__name__


def test_default_directory_is_the_ports_own(monkeypatch, tmp_path):
    """The reference's (bm, bn) entries are never read as the port's: the
    default directory differs and an entry without `tiles_per_split` is a
    miss."""
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    parts = autotune.default_cache_dir().split(os.sep)
    assert parts[-2:] == ["repro-gp", "autotune-torch"]
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    assert autotune.default_cache_dir() == str(tmp_path)
    key = cache_key(COMPONENTS, 64, 64, 2, 1, **ARGS)
    with open(tmp_path / (key_hash(key) + ".json"), "w") as f:
        json.dump({"key": key, "bm": 256, "bn": 256}, f)
    measure = _fixed_measure({32: 0.0})
    assert autotune_tiles(COMPONENTS, 64, 64, 2, 1, **ARGS, measure=measure) == 32
    assert measure.calls == list(DEFAULT_CANDIDATES)


def test_capture_guard_reads_graph_capture_and_compile(monkeypatch):
    assert autotune._capturing() is False
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert autotune._capturing() is True
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert autotune._capturing() is True


def test_cpu_device_returns_the_static_split_without_sweeping(tmp_path):
    params = init_params(dtype=torch.float32)
    got = tiles_for_spec("matern32", params, 1 << 16, 1 << 16, 9, 9,
                         device="cpu", cache_dir=str(tmp_path))
    assert got == DEFAULT_TILES
    assert os.listdir(tmp_path) == []
    assert obs.registry().snapshot().get("autotune.misses", 0) == 0


@pytest.mark.parametrize("split", DEFAULT_CANDIDATES + (None,))
def test_column_split_depends_on_n_only(split):
    """At every candidate the split of the column range is the same for any
    launch rows; 0 is one split over all columns, None the static default;
    above 1 GiB of partials the split still coarsens."""
    for n in (1, 4096, 4097, 1 << 16, 1 << 17):
        ntiles = -(-n // 64)
        splits = {kmvm._column_split(m, n, t, split)
                  for m in (1, 64, 2048, 1 << 16) for t in (1, 9)}
        assert len(splits) == 1, (n, splits)
        nsplit, per = splits.pop()
        want = {None: kmvm._SPLIT_TILES, 0: ntiles}.get(split, split)
        assert per == want and nsplit == -(-ntiles // per)
    nsplit, per = kmvm._column_split(1 << 20, 1 << 20, 128, split)
    assert nsplit * (1 << 20) * 128 * 4 <= 1 << 30
    with pytest.raises(ValueError):
        kmvm._column_split(64, 64, 1, -1)


def _operator(autotune_on, X):
    return make_operator(OperatorConfig(kernel="matern32", backend="pallas",
                                        autotune=autotune_on),
                         X, init_params(noise=0.3), device="cpu")


def test_operator_hands_the_tuned_split_to_b1_and_b2(monkeypatch):
    """matvec (B1) and fused_matvec_dots (B2) launch at the split that
    `tiles_for_spec` picked for (n, d, t); cross launches keep None."""
    X = torch.as_tensor(np.random.default_rng(0).normal(size=(96, 5)),
                        dtype=torch.float32)
    asked, seen = [], []

    def fake_tiles(kernel, params, m, n, d, t, *, device, compute_dtype=None):
        assert m == n
        asked.append((n, d, t, torch.device(device).type))
        return 16 * t

    def spy_b1(components, Xi, Xj, V, scalars, split_tiles=None):
        seen.append(("B1", split_tiles))
        return kmvm.kmvm_plain(components, Xi, Xj, V, scalars)

    def spy_b2(components, Xi, Xj, V, Vrow, R, scalars, split_tiles=None):
        seen.append(("B2", split_tiles))
        return kmvm.kmvm_dots_plain(components, Xi, Xj, V, Vrow, R, scalars)

    monkeypatch.setattr(autotune, "tiles_for_spec", fake_tiles)
    monkeypatch.setattr(ops, "kmvm_fused", spy_b1)
    monkeypatch.setattr(ops, "kmvm_fused_dots", spy_b2)
    op = _operator(True, X)
    V = torch.ones((96, 3))
    op.matvec(V)
    op.fused_matvec_dots(V, V)
    op.matvec(V[:, 0])
    op.cross_matvec(X[:7], V)
    assert asked == [(96, 5, 3, "cpu"), (96, 5, 3, "cpu"), (96, 5, 1, "cpu")]
    assert seen[:3] == [("B1", 48), ("B2", 48), ("B1", 16)]
    assert seen[3:] and all(s == ("B1", None) for s in seen[3:])
    seen.clear()
    asked.clear()
    _operator(False, X).matvec(V)
    assert asked == [] and seen == [("B1", None)]


def test_autotune_on_cpu_changes_no_bit(tmp_path, monkeypatch):
    """On the CPU the plain versions have no split: autotune=True gives the
    default operator's results bit for bit and sweeps nothing."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.normal(size=(96, 5)), dtype=torch.float32)
    V = torch.as_tensor(rng.normal(size=(96, 9)), dtype=torch.float32)
    R = torch.as_tensor(rng.normal(size=(96, 9)), dtype=torch.float32)
    on, off = _operator(True, X), _operator(False, X)
    assert torch.equal(on.matvec(V), off.matvec(V))
    for a, b in zip(on.fused_matvec_dots(V, R), off.fused_matvec_dots(V, R)):
        assert torch.equal(a, b)
    assert os.listdir(tmp_path) == []


def test_trainer_prewarms_the_training_shape(monkeypatch):
    """A full-data stage on the pallas backend with autotune set resolves
    the (n, d, y + probes) split before its first step, inside an
    `autotune` span; without autotune it does not ask."""
    from repro_torch.core.gp import ExactGP, ExactGPConfig
    from repro_torch.train.gp_trainer import GPTrainConfig, fit_exact_gp

    calls = []
    real = autotune.prewarm

    def spy(kernel, params, n, d, **kw):
        calls.append((n, d, kw["num_probes"], str(kw["device"])))
        return real(kernel, params, n, d, **kw)

    monkeypatch.setattr(autotune, "prewarm", spy)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 2)).astype(np.float32)
    y = np.sin(X[:, 0]).astype(np.float32)
    spans = {}
    for on in (True, False):
        gp = ExactGP(ExactGPConfig(backend="pallas", autotune=on, num_probes=4,
                                   precond_rank=8, train_max_cg_iters=10))
        obs.enable_tracing(None)
        try:
            res = fit_exact_gp(gp, X, y, method="adam", device="cpu",
                               cfg=GPTrainConfig(plain_adam_steps=1))
            spans[on] = [e["name"] for e in obs.drain_events()]
        finally:
            obs.disable_tracing()
        assert np.isfinite(res.loss_trace).all()
    assert calls == [(64, 2, 4, "cpu")]
    assert "autotune" in spans[True] and "autotune" not in spans[False]
