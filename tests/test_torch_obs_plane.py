"""The port's measurement plane against the reference's, on the same inputs.

Pure modules, held to exact equality unless stated:

* `costmodel`: `mll_step_cost`, `mll_phase_costs` and
  `dist_collective_cost` equal the reference's on a grid (every backend,
  warm and cold, fill 0.1 and 1, bm 64 and 256, the paper's d and r); the
  port's default bm is B1-B3's 64-row tile;
* `record_solver_step`: the same record and the same registry snapshot;
* `health`: the reference test's synthetic aux gives the same events, and
  each package's `load_health` reads the other's JSONL;
* `report`: a trace JSONL written by either package reads the same through
  both packages' `load_trace` / `assign_self_times` / `phase_breakdown` /
  `format_report`, truncated lines and unclosed spans included;
* `regress` / `obs_diff`: the same findings, text, JSON and exit codes on
  the repo's BENCH files and perturbed copies;
* `measure`: the same comparison table on the same spans, [] from
  `collective_microbench` without a second rank, and a gloo world of 2
  timing each primitive at the reference's byte volume;
* `obs_report --json --compare-model --health`: the reference's output,
  but for the trace path.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import contextlib
import io
import itertools
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from repro.launch import obs_diff as ref_obs_diff
from repro.launch import obs_report as ref_obs_report
from repro.obs import costmodel as ref_cost
from repro.obs import health as ref_health
from repro.obs import measure as ref_measure
from repro.obs import metrics as ref_metrics
from repro.obs import regress as ref_regress
from repro.obs import report as ref_report
from repro.obs import trace as ref_trace
from repro_torch import obs
from repro_torch.launch import obs_diff, obs_report
from repro_torch.obs import costmodel, health, measure, metrics, regress, report

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "experiments" / "benchmarks"


@pytest.fixture(autouse=True)
def _clean():
    for h in (health, ref_health):
        h.disable_health()
        h.drain_health_events()
    for t in (obs, ref_trace):
        t.disable_tracing(snapshot_metrics=False)
        t.drain_events()
    yield
    for h in (health, ref_health):
        h.disable_health()
        h.drain_health_events()
    for t in (obs, ref_trace):
        t.disable_tracing(snapshot_metrics=False)
        t.drain_events()


# -- costmodel ----------------------------------------------------------------

BACKENDS = ("dense", "partitioned", "pallas", "blocksparse", "sharded")
# (n, d, num_rhs): the paper's houseelectric (d 9) and its widest set, d 385
# (CT slice), at the smoke's and the 1M-point run's n; r = 1 + 8 probes
WIDTHS = ((1 << 16, 9, 9), (1 << 20, 9, 9), (1 << 17, 385, 9), (4096, 2, 1))


@pytest.mark.parametrize("backend", BACKENDS)
def test_costmodel_equals_reference_on_a_grid(backend):
    grid = itertools.product(WIDTHS, (False, True), (0.1, 1.0), (64, 256),
                             (20, 100), (512, 1024), (False, True))
    for (n, d, r), warm, fill, bm, iters, row_block, bwd in grid:
        kw = dict(backend=backend, row_block=row_block, bm=bm, fill=fill,
                  warm_init=warm)
        assert tuple(costmodel.mll_step_cost(
            n, d, r, iters, include_backward=bwd, **kw)) == tuple(
            ref_cost.mll_step_cost(n, d, r, iters, include_backward=bwd, **kw))
        for rank in (0, 100):
            port = costmodel.mll_phase_costs(n, d, r, iters, precond_rank=rank,
                                             **kw)
            ref = ref_cost.mll_phase_costs(n, d, r, iters, precond_rank=rank,
                                           **kw)
            assert list(port) == list(ref)
            assert all(tuple(port[k]) == tuple(ref[k]) for k in ref)


def test_costmodel_default_tile_is_the_hopper_kernels():
    """bm=None prices the port's 64-row tile (the reference's default is
    its TPU tile of 256); at bm=64 both agree."""
    from repro_torch.kernels.kmvm import ROW_TILE

    assert costmodel._DEFAULT_BM == ROW_TILE == 64
    port = costmodel.mll_step_cost(1 << 16, 9, 9, 20, backend="pallas")
    assert tuple(port) == tuple(ref_cost.mll_step_cost(
        1 << 16, 9, 9, 20, backend="pallas", bm=64))


def test_dist_collective_cost_equals_reference():
    for n, r, d_row, d_col, overlap, b in itertools.product(
            (4096, 1 << 20, 786432), (1, 9), (1, 2, 4, 8), (1, 2, 4),
            (False, True), (2, 4)):
        kw = dict(d_row=d_row, d_col=d_col, overlap=overlap, dtype_bytes=b)
        assert tuple(costmodel.dist_collective_cost(n, r, **kw)) == tuple(
            ref_cost.dist_collective_cost(n, r, **kw))


# -- record_solver_step ---------------------------------------------------------


@pytest.mark.parametrize("extras", [
    {},
    {"launches": 12, "hbm_bytes": 3.5e9},
    {"launches": 7, "hbm_bytes": 1e6,
     "phase_ms": {"precond_build": 1.5, "cg_solve": 20.25,
                  "slq_logdet": 0.5, "eq2_backward": 7.0}},
])
def test_record_solver_step_equals_reference(extras):
    port_reg, ref_reg = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    steps = [("cold", [3, 5, 4], 0.0, 0.25), ("warm", [1, 2, 2], 0.05, 0.125),
             ("refresh", [4, 4, 6], 0.5, 0.3)]
    for mode, iters, drift, secs in steps:
        kw = dict(mode=mode, iters_per_rhs=np.asarray(iters), drift=drift,
                  seconds=secs, **extras)
        assert metrics.record_solver_step(reg=port_reg, **kw) == \
            ref_metrics.record_solver_step(reg=ref_reg, **kw)
    assert port_reg.snapshot() == ref_reg.snapshot()


# -- health ---------------------------------------------------------------------


def _sentinel_run(h):
    """The reference test's synthetic aux (tests/test_obs_v2.py)."""
    h.enable_health(None)
    kinds = [
        h.check_solver_step(step=0, mode="warm", tol=1e-2, max_iters=10,
                            iters_per_rhs=[5], rel_residual=[float("nan")]),
        h.check_solver_step(step=1, mode="warm", tol=1e-2, max_iters=10,
                            iters_per_rhs=[10], rel_residual=[0.5]),
        h.check_solver_step(step=2, mode="warm", tol=1e-2, max_iters=10,
                            iters_per_rhs=[3], rel_residual=[0.5],
                            residuals=np.array([[1.0], [0.01], [0.5]])),
        h.check_solver_step(step=3, mode="warm", tol=1e-2, max_iters=20,
                            iters_per_rhs=[15], rel_residual=[0.49],
                            residuals=np.linspace(0.5, 0.49, 15)[:, None]),
        h.check_solver_step(step=4, mode="warm", tol=1e-2, max_iters=20,
                            iters_per_rhs=[12], rel_residual=[1e-8],
                            residuals=np.geomspace(1.0, 1e-8, 12)[:, None]),
        h.check_solver_step(step=5, mode="refresh", tol=1.0, max_iters=20,
                            iters_per_rhs=[4, 20], rel_residual=[0.5, 2.0],
                            drift=0.25),
    ]
    h.precond_stale(step=6, drift=0.5, threshold=0.1)
    h.sparse_replan(step=7, fill_before=0.3, fill_after=0.4)
    events = h.drain_health_events()
    h.disable_health()
    return kinds, [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_health_sentinels_equal_reference():
    kinds, events = _sentinel_run(health)
    assert (kinds, events) == _sentinel_run(ref_health)
    assert kinds[:5] == [["cg.nan"], ["cg.max_iters"], ["cg.divergence"],
                         ["cg.stagnation"], []]
    assert (health.STAGNATION_WINDOW, health.STAGNATION_RATIO,
            health.DIVERGENCE_RATIO) == (ref_health.STAGNATION_WINDOW,
                                         ref_health.STAGNATION_RATIO,
                                         ref_health.DIVERGENCE_RATIO)


@pytest.mark.parametrize("writer,reader", [(health, ref_health),
                                           (ref_health, health)])
def test_health_jsonl_reads_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "h.jsonl")
    writer.enable_health(path)
    writer.emit("cg.max_iters", step=3, columns=[0])
    writer.precond_stale(step=4, drift=0.5, threshold=0.1)
    writer.check_solver_step(step=5, mode="cold", tol=1.0, max_iters=4,
                             iters_per_rhs=[4], rel_residual=[float("inf")])
    writer.disable_health()
    with open(path, "a") as f:
        f.write('{"kind": "cg.na')  # a process died mid-write
    events = reader.load_health(path)
    assert events == writer.load_health(path)
    assert [e["kind"] for e in events] == ["cg.max_iters", "precond.stale",
                                           "cg.nan"]
    assert reader.summarize_health(events) == writer.summarize_health(events)


# -- report ---------------------------------------------------------------------


def _write_trace(tr, path):
    """A trace through one package's tracing API: nested spans, a request
    flow on a synthetic tid, an instant, a counter sample and metrics."""
    with tr.trace_session(path):
        with tr.span("fit_exact_gp", n=64):
            with tr.span("mll_step", mode="cold"):
                with tr.span("cg_solve", measured_ms=2.0, backend="pallas",
                             modeled_hbm_bytes=1e6, modeled_launches=8):
                    sum(range(2000))
                with tr.span("eq2_backward", measured_ms=1.0,
                             backend="pallas", modeled_hbm_bytes=2e6,
                             modeled_launches=4):
                    pass
            tr.instant("sparse_plan", pairs=3)
            tr.counter_event("mem.fit", cuda0=123)
            with tr.span("optimizer_step"):
                pass
        tr.complete_event("serve_request", 10.0, 500.0, tid="req:r1",
                          model="m0")
        tr.complete_event("serve_queue", 10.0, 200.0, tid="req:r1")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_report_reads_either_packages_trace(tmp_path, writer):
    path = str(tmp_path / "t.jsonl")
    _write_trace(obs if writer == "port" else ref_trace, path)
    outs = []
    for rep in (report, ref_report):
        events, snap = rep.load_trace(path)
        spans = rep.assign_self_times(events)
        phase, req = rep.split_request_spans(spans)
        rows, wall = rep.phase_breakdown(phase, root="fit_exact_gp")
        outs.append((events, snap, [tuple(s) for s in spans],
                     [tuple(r) for r in rows], wall,
                     rep.request_breakdown(req),
                     rep.format_report(path, root="fit_exact_gp")))
    assert outs[0] == outs[1]
    rows, wall = outs[0][3], outs[0][4]
    assert abs(sum(r[3] for r in rows) - wall) <= 1e-9 * wall


def test_report_survives_truncated_lines_and_unclosed_spans(tmp_path):
    def ev(name, ts, dur, tid=1):
        return {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": 1,
                "tid": tid, "args": {}}

    path = tmp_path / "t.jsonl"
    path.write_text("\n".join([
        json.dumps(ev("root", 0.0, 100.0)),
        '{"name": "b", "ph": "X", "ts": 5',      # killed mid-write
        "not json at all",
        "[1, 2, 3]",
        json.dumps({"name": "unclosed", "ph": "X", "ts": 10.0, "tid": 1}),
        json.dumps(ev("child", 20.0, 30.0)),
        json.dumps(ev("straddler", 80.0, 50.0)),
    ]) + "\n")
    outs = []
    for rep in (report, ref_report):
        events, _ = rep.load_trace(str(path))
        spans = rep.assign_self_times(events)
        outs.append(([e["name"] for e in events], [tuple(s) for s in spans],
                     rep.format_report(str(path), root="root")))
    assert outs[0] == outs[1]
    assert outs[0][0] == ["root", "unclosed", "child", "straddler"]
    root = next(s for s in outs[0][1] if s[0] == "root")
    assert root[5] == pytest.approx(50.0)  # child and the 20 us overlap


# -- regress and obs_diff -----------------------------------------------------


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _perturbed(tmp_path):
    """Copies of the committed BENCH files: one timing column 10x slower,
    one 10x faster, one accuracy cell better, one record dropped."""
    cur = tmp_path / "cur"
    cur.mkdir()
    for f in BENCH_DIR.glob("BENCH_*.json"):
        shutil.copy(f, cur / f.name)
    edits = 0
    for f in sorted(cur.glob("BENCH_*.json")):
        data = json.loads(f.read_text())
        recs = data.get("records", [])
        for col in data.get("header", []):
            rule = regress.rule_for(col)
            if rule is None or rule.direction == "info" or not recs:
                continue
            v = regress.parse_value(recs[0].get(col))
            if v is None or v == 0:
                continue
            recs[0][col] = v * (10.0 if edits % 2 == 0 else 0.1)
            edits += 1
            break
        if len(recs) > 2 and edits % 3 == 0:
            recs.pop()
        f.write_text(json.dumps(data))
    assert edits >= 4
    return cur


def test_regress_equals_reference_on_bench_files(tmp_path):
    cur = _perturbed(tmp_path)
    for f in sorted(BENCH_DIR.glob("BENCH_*.json")):
        base = regress.load_bench(str(f))
        for c in (f, cur / f.name):
            now = regress.load_bench(str(c))
            for scale in (1.0, 2.5):
                p = regress.compare_bench(base, now, tol_scale=scale)
                r = ref_regress.compare_bench(base, now, tol_scale=scale)
                assert p == r
                assert regress.format_diff([p], tol_scale=scale) == \
                    ref_regress.format_diff([r], tol_scale=scale)
                assert regress.diff_to_json([p]) == ref_regress.diff_to_json([r])
    for col in ("backend", "rmse", "fit_s", "qps", "wins", "cg_iters",
                "saved_pct", "mvm_ms", "temp_GiB"):
        assert regress.rule_for(col) == ref_regress.rule_for(col)
    for v in (3, "3.2±0.1", "7.5", "-", "", None, True, "fast"):
        assert regress.parse_value(v) == ref_regress.parse_value(v)


@pytest.mark.parametrize("case", ["self", "perturbed", "json", "only",
                                  "report", "nothing"])
def test_obs_diff_equals_reference(tmp_path, case):
    cur = _perturbed(tmp_path) if case != "self" else BENCH_DIR
    args = [str(cur), "--baseline", str(BENCH_DIR)]
    if case == "json":
        args.append("--json")
    elif case == "only":
        args += ["--only", "serve_latency,table2_timing", "--tol-scale", "0.5"]
    elif case == "nothing":
        args = [str(tmp_path / "nowhere"), "--baseline", str(BENCH_DIR)]
    outs = []
    for i, main in enumerate((obs_diff.main, ref_obs_diff.main)):
        argv = list(args)
        if case == "report":
            argv += ["--report", str(tmp_path / f"r{i}" / "out.md")]
        outs.append(_run(main, argv))
    assert outs[0] == outs[1]
    rc = outs[0][0]
    assert rc == {"self": 0, "nothing": 2, "only": rc}.get(case, 1)
    if case == "report":
        assert (tmp_path / "r0" / "out.md").read_text() == \
            (tmp_path / "r1" / "out.md").read_text()


# -- measure ------------------------------------------------------------------


def test_phase_model_comparison_equals_reference(tmp_path):
    path = str(tmp_path / "t.jsonl")
    _write_trace(obs, path)
    events, _ = report.load_trace(path)
    events += [{"name": "slq_logdet", "ph": "X", "ts": 0.0, "dur": 1.0,
                "tid": 2, "args": {"measured_ms": 0.5, "backend": "dense",
                                   "modeled_hbm_bytes": 0.0,
                                   "modeled_launches": 1}}]
    for gbps in (100.0, measure.DEFAULT_HBM_GBPS):
        rows = measure.phase_model_comparison(events, hbm_gbps=gbps)
        ref_rows = ref_measure.phase_model_comparison(events, hbm_gbps=gbps)
        assert json.dumps(rows) == json.dumps(ref_rows)
        assert measure.format_model_comparison(rows, hbm_gbps=gbps) == \
            ref_measure.format_model_comparison(ref_rows, hbm_gbps=gbps)
    assert measure.format_model_comparison([]) .splitlines()[1:] == \
        ref_measure.format_model_comparison([]).splitlines()[1:]
    assert measure.PHASE_SPANS == ref_measure.PHASE_SPANS
    assert measure.DEFAULT_HBM_GBPS == 3350.0


def test_phase_histogram_summary_equals_reference():
    port_reg, ref_reg = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    for ms in (1.0, 2.0, 5.0):
        kw = dict(mode="cold", iters_per_rhs=[2], drift=0.0, seconds=0.1,
                  phase_ms={"cg_solve": ms, "eq2_backward": ms / 2})
        metrics.record_solver_step(reg=port_reg, **kw)
        ref_metrics.record_solver_step(reg=ref_reg, **kw)
    assert measure.phase_histogram_summary(port_reg) == \
        ref_measure.phase_histogram_summary(ref_reg)


def test_profiling_is_null_when_off_and_a_session_writes_a_chrome_trace(
        tmp_path):
    from repro_torch.obs import profiling

    assert not profiling.profiling_enabled()
    assert profiling.annotate("a") is profiling.step_annotation(0) \
        is profiling.named_scope("b")
    assert profiling.memory_snapshot("off") == {}
    with profiling.profile_session(str(tmp_path / "prof")) as prof:
        assert profiling.profiling_enabled()
        with profiling.step_annotation(3):
            torch.ones(8, 8) @ torch.ones(8, 8)
        # no card here: nothing to read, as the reference without stats
        assert profiling.memory_snapshot("cpu") == {}
    assert not profiling.profiling_enabled()
    names = {e.get("name") for e in
             json.loads(pathlib.Path(prof.path).read_text())["traceEvents"]}
    assert "train_step#3" in names


def test_collective_microbench_without_a_second_rank():
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert measure.collective_microbench() == []
    assert measure.format_collective_bench([]).startswith("collectives: one rank")


def test_collective_microbench_gloo_world_of_two(tmp_path):
    """Each primitive of a 2-rank world (the ring on a 2 x 1 mesh, the
    reduce-scatter on a 1 x 2 mesh) timed, at the reference's bytes."""
    outs = worker.spawn("obs_microbench", 2, {"n": 4096, "t": 8}, tmp_path)
    for out in outs:
        for key, name in (("ring", "ppermute_ring"), ("scatter", "psum_scatter")):
            rows, geom = out[key]
            assert [r["collective"] for r in rows] == [name]
            (row,) = rows
            assert row["ms_per_op"] > 0 and row["devices"] == 2
            cost = ref_cost.dist_collective_cost(
                geom["n"], 8, d_row=geom["d_row"], d_col=geom["d_col"],
                dtype_bytes=4)
            chunk = geom["n_local"] * 8 * 4
            want = chunk if name == "ppermute_ring" else cost.scatter_bytes
            assert row["bytes_per_device"] == float(want)
        assert out["auto"] == ["ppermute_ring"]


# -- obs_report ---------------------------------------------------------------


def _traced_fit_files(tmp_path):
    """A traced CPU fit with the health sink on: the files obs_report reads."""
    from repro_torch.core.gp import ExactGP, ExactGPConfig
    from repro_torch.train.gp_trainer import GPTrainConfig, fit_exact_gp

    rng = np.random.default_rng(0)
    X = rng.normal(size=(96, 5))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=96)
    gp = ExactGP(ExactGPConfig(kernel="matern32", backend="pallas",
                               row_block=32, precond_rank=10, num_probes=4,
                               train_max_cg_iters=20))
    tpath, hpath = str(tmp_path / "t.jsonl"), str(tmp_path / "h.jsonl")
    health.enable_health(hpath)
    try:
        with obs.trace_session(tpath):
            fit_exact_gp(gp, X, y, method="adam", device="cpu",
                         cfg=GPTrainConfig(plain_adam_steps=3, refresh_every=2))
    finally:
        health.disable_health()
    return tpath, hpath


def test_obs_report_json_equals_reference(tmp_path):
    """The same files through both launchers at the same --hbm-gbps (the
    defaults differ by design: the port's is the H100's 3350 GB/s, the
    reference's a placeholder of 100)."""
    tpath, hpath = _traced_fit_files(tmp_path)
    outs = []
    for main in (obs_report.main, ref_obs_report.main):
        for extra in (["--json"], []):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                main([tpath, *extra, "--compare-model", "--hbm-gbps", "3350",
                      "--health", hpath])
            outs.append(out.getvalue())
    port_json, ref_json = json.loads(outs[0]), json.loads(outs[2])
    assert port_json.pop("trace") == ref_json.pop("trace") == tpath
    assert json.dumps(port_json, sort_keys=True) == \
        json.dumps(ref_json, sort_keys=True)
    assert outs[1] == outs[3]
    assert {r["phase"] for r in port_json["model_comparison"]} == \
        set(measure.PHASE_SPANS)
    assert port_json["health"]["precond.refresh"]["count"] >= 1
    assert obs_report.DEFAULT_HBM_GBPS == 3350.0  # the --hbm-gbps default
