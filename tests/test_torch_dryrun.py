"""The port's dry run (`repro_torch.launch.dryrun`) on fake meshes of
(2, 4) and (2, 2, 2) ranks, reduced configs.

The checks run in one subprocess (`tests/_torch_dryrun_worker.py`), since
the fake process group must be its process's only group; the tests here
read its results:

* Per-device FLOPs: a column- then row-parallel MLP over a (2, 4) mesh
  counts 1/8 of its global FLOPs per device, a replicated matmul its full
  FLOPs, and `CommDebugMode` and the counter both see one all-reduce.
* One cell per family (dense, moe, ssm, hybrid, encdec, vlm) at train,
  prefill and decode ends `ok` with finite, positive roofline terms (two
  of them on the (2, 2, 2) ("pod", "data", "model") mesh as well).
* `_extrapolate` from depths 1 and 2 equals the full count of a reduced
  smollm at depth 4 (train, prefill and decode): FLOPs, bytes,
  transcendentals, collective bytes and the argument, output and temp
  bytes.
* The GP train and predict cells end `ok` at n = 4096 on `partitioned`
  with fixed trips (20 and 100), and `--gp-backend pallas` is refused.
* At full size on the (16, 16) production mesh (a second subprocess, 256
  fake ranks), the GP cells' all-gathers and reduce-scatters equal those
  of the reference's `experiments/dryrun/` JSONs in bytes and calls.
* Each written JSON has the top-level, `roofline`, `cost`, `collectives`
  and `memory` keys of `experiments/dryrun/gp-exact-1m__gp_train__16x16.json`
  (the reference's current code adds `gp_overlap`, and so does the port),
  plus the port's `fallbacks`: the ops DTensor could not shard, run on
  replicated operands.
* The default `--out` is not the reference's `experiments/dryrun`.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REF_JSON = os.path.join(ROOT, "experiments", "dryrun",
                        "gp-exact-1m__gp_train__16x16.json")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Both worker processes, run side by side: the checks on the (2, 4)
    and (2, 2, 2) meshes, and the GP cells on the production mesh."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), HERE]))
    args = {"results": str(tmp / "json"), "production_gp": "production"}
    procs = {}
    for name, arg in args.items():
        with open(tmp / f"{name}.err", "w") as err:
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "_torch_dryrun_worker.py"),
                 str(tmp / f"{name}.json"), arg],
                stdout=subprocess.DEVNULL, stderr=err, env=env)
    out = {}
    try:
        for name, proc in procs.items():
            proc.wait(timeout=600)
            assert proc.returncode == 0, (tmp / f"{name}.err").read_text()[-3000:]
            with open(tmp / f"{name}.json") as f:
                out[name] = json.load(f)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["results"]["json_dir"] = args["results"]
    return out


@pytest.fixture(scope="module")
def results(workers):
    return workers["results"]


@pytest.fixture(scope="module")
def production_gp(workers):
    return workers["production_gp"]


def test_per_device_flops_of_a_tensor_parallel_mlp(results):
    r = results["mlp"]
    assert r["flops"] == r["global"] / 8
    assert r["replicated_flops"] == r["replicated_global"]
    assert r["coll"]["all-reduce"] == 1 and r["comm"] == r["coll"]
    assert sum(r["coll"].values()) == 1


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("family", FAMILIES)
def test_family_cells_ok(results, family, kind):
    cells = {k: v for k, v in results["families"].items()
             if k.startswith(f"{family}/{kind}/")}
    assert f"{family}/{kind}/2x4" in cells
    for name, c in cells.items():
        assert c["status"] == "ok", name
        assert c["finite"] and c["positive"], name
        assert c["collectives"] > 0, name


def test_three_axis_mesh_cells(results):
    three = [k for k in results["families"] if k.endswith("/2x2x2")]
    assert len(three) == 2


def _check_extrapolation(r):
    assert r["grew"] and all(r["memory_grew"].values())
    assert r["ext"] == r["full"]
    # argument, output and temp bytes at full depth, not one layer's
    assert r["ext_memory"] == r["full_memory"]


def test_extrapolation_equals_full_depth(results):
    _check_extrapolation(results["extrapolation"]["train"])


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_extrapolation_equals_full_depth_serving(results, kind):
    _check_extrapolation(results["extrapolation"][kind])


@pytest.mark.parametrize("kind,depth", (("gp_train", 20), ("gp_predict", 100)))
def test_gp_cells_ok_with_fixed_trips(results, kind, depth):
    r = results["gp"][kind]
    assert r["status"] == "ok" and r["depth"] == depth and r["finite"]
    assert r["flops"] > 0
    # 2-D mode: one all-gather and one reduce-scatter per CG iteration
    assert r["counts"]["reduce-scatter"] >= depth


@pytest.mark.parametrize("kind", ("gp_train", "gp_predict"))
def test_gp_collectives_match_reference(production_gp, kind):
    """The GP cells' collectives at full size on (16, 16) against the
    reference's dry run (`experiments/dryrun/`): the MVM's all-gathers and
    reduce-scatters equal in bytes and calls, no all-to-all or permute, and
    the total within 1%. The all-reduces are the CG's scalar dots and the
    preconditioner's small sums, which XLA combines into fewer calls."""
    with open(os.path.join(ROOT, "experiments", "dryrun",
                           f"gp-exact-1m__{kind}__16x16.json")) as f:
        ref = json.load(f)["collectives"]
    got = production_gp[kind]
    for k in ("all-gather", "reduce-scatter", "all-to-all", "collective-permute"):
        assert got[k] == ref[k], k
        assert got["counts"][k] == ref["counts"][k], k
    assert abs(got["total"] - ref["total"]) <= 0.01 * ref["total"]


def test_pallas_backend_refused(results):
    assert "pallas" in results["gp"]["pallas"] and "fake" in results["gp"]["pallas"]


@pytest.mark.parametrize("name", ("gp__gp_train", "gp__gp_predict", "lm__train"))
def test_json_keys_match_reference(results, name):
    with open(REF_JSON) as f:
        ref = json.load(f)
    with open(os.path.join(results["json_dir"], name + ".json")) as f:
        got = json.load(f)
    lm_only = {"gp_mode", "pcg_method", "gp_backend", "gp_compute_dtype"}
    want_top = set(ref) - (lm_only if name.startswith("lm") else set())
    # the port's own: the ops run on replicated operands (depth-2 pass)
    extra = {"fallbacks"} | ({"gp_overlap"} if name.startswith("gp") else set())
    assert set(got) == want_top | extra
    for k in ("roofline", "cost", "collectives", "memory"):
        assert set(got[k]) == set(ref[k]), k
    assert set(got["collectives"]["counts"]) == set(ref["collectives"]["counts"])
    assert got["status"] == "ok" and got["mesh"] == "2x4"


def test_default_out_is_not_the_reference_directory():
    from repro_torch.launch import dryrun

    assert os.path.normpath(dryrun.DEFAULT_OUT) != os.path.normpath("experiments/dryrun")
    assert "dryrun" in dryrun.DEFAULT_OUT
