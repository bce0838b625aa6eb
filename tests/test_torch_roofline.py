"""The port's roofline (`repro_torch.launch.roofline`) against the
reference's `repro.launch.roofline`.

* `model_flops_for` equals the reference's exactly for every (arch,
  shape) cell and both GP cells: it is arithmetic on the config.
* `analyze`, with the reference's v5e constants patched into the port's
  module, equals the reference's on the same cost / collective dicts; with
  the port's own constants it prices at the H100 SXM datasheet peaks.
* `collective_stats` returns the reference's keys, and its `wire` follows
  the reference's ring formulas (`roofline.py:114-134`): the same records
  written as HLO lines and parsed by the reference's `collective_bytes`
  give the same dict.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import pytest

from repro.configs.gp_exact_1m import CONFIG as RGP
from repro.launch import roofline as ref_rl
from repro.launch.specs import SHAPES
from repro.launch.specs import cell_for as ref_cell_for
from repro.launch.specs import gp_cells as ref_gp_cells
from repro.models import get_arch as ref_get_arch
from repro.models import registry as ref_registry
from repro_torch.configs.gp_exact_1m import CONFIG as GP
from repro_torch.launch import roofline as rl
from repro_torch.launch.specs import cell_for, gp_cells
from repro_torch.models import get_arch

LM_ARCHS = tuple(a for a in ref_registry.ARCH_IDS if a != "gp-exact-1m")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_flops_match_reference_exactly(arch):
    rcfg, cfg = ref_get_arch(arch), get_arch(arch)
    for shape in SHAPES:
        got = rl.model_flops_for(cfg, cell_for(cfg, shape))
        want = ref_rl.model_flops_for(rcfg, ref_cell_for(rcfg, shape))
        assert got == want, (shape, got, want)
        assert got > 0
    assert rl._lm_mixer_flops_fwd(cfg, 3, 100) == ref_rl._lm_mixer_flops_fwd(rcfg, 3, 100)
    assert rl._lm_mixer_flops_fwd(cfg, 3, 100, decode_ctx=77) == \
        ref_rl._lm_mixer_flops_fwd(rcfg, 3, 100, decode_ctx=77)


def test_gp_model_flops_match_reference_exactly():
    for c, rc in zip(gp_cells(GP), ref_gp_cells(RGP)):
        assert rl.model_flops_for(GP, c) == ref_rl.model_flops_for(RGP, rc)


def _records():
    # (kind, result bytes, group size)
    return [("all-reduce", 4096, 16), ("all-reduce", 12, 256),
            ("all-gather", 65536, 16), ("reduce-scatter", 2048, 16),
            ("all-to-all", 8192, 16), ("collective-permute", 1024, 16),
            ("all-gather", 512, 1)]


def _hlo(records) -> str:
    lines = []
    for i, (kind, nbytes, gs) in enumerate(records):
        groups = 256 // gs if gs > 1 else 256
        lines.append(f"  %c{i} = f32[{nbytes // 4}]{{0}} {kind}(f32[] %x), "
                     f"replica_groups=[{groups},{gs}]<=[256]")
    return "\n".join(lines)


def test_collective_stats_match_reference_ring_formulas():
    got = rl.collective_stats(_records())
    want = ref_rl.collective_bytes(_hlo(_records()))
    assert set(got) == set(want) == set(ref_rl._COLLECTIVES) | {"total", "wire", "counts"}
    assert got == want
    empty = rl.collective_stats([])
    assert empty["total"] == 0 and empty["wire"] == 0
    assert set(empty["counts"]) == set(ref_rl._COLLECTIVES)
    with pytest.raises(ValueError):
        rl.collective_stats([("broadcast", 8, 2)])


def test_analyze_matches_reference_with_its_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "PEAK_FLOPS_FP32", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(rl, name, getattr(ref_rl, name))
    coll = rl.collective_stats(_records())
    for cost, dt in (({"flops": 3.2e15, "bytes accessed": 7.1e12}, "bf16"),
                     ({"flops": 4.0e12, "bytes accessed": 2.0e12}, "float32"),
                     ({"flops": 1.0e9, "bytes accessed": 1.0e6}, None),
                     ({"flops": 0.0, "bytes accessed": 0.0}, "bfloat16")):
        got = rl.analyze(cost, coll, 6.4e16, 256, compute_dtype=dt)
        want = ref_rl.analyze(cost, coll, 6.4e16, 256, compute_dtype=dt)
        assert got._asdict() == want._asdict()
        assert rl.format_row("a", "s", "16x16", got) == \
            ref_rl.format_row("a", "s", "16x16", want)


def test_h100_constants_and_peak_by_dtype():
    assert rl.PEAK_FLOPS == 989e12 and rl.PEAK_FLOPS_FP32 == 67e12
    assert rl.HBM_BW == 3.35e12 and rl.LINK_BW == 50e9
    assert rl.peak_flops_for("float32") == rl.peak_flops_for(None) == 67e12
    assert rl.peak_flops_for("bf16") == rl.peak_flops_for("bfloat16") == 989e12
    r = rl.analyze({"flops": 989e12, "bytes accessed": 3.35e12},
                   {"total": 25e9, "wire": 50e9}, 256 * 989e12, 256)
    assert r.t_compute == pytest.approx(1.0) and r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(0.5) and r.t_collective_wire == pytest.approx(1.0)
    assert r.useful_ratio == pytest.approx(1.0)
