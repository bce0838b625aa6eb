"""The DKL cell (`dkl-granite-train`) end to end on the CPU at a tiny size:
the configuration's layer pattern, held share and router width with every
width cut (d 64), 256 training sequences of 16 tokens, and the program's
`get_arch` answering the same cut. A run reads correct with its result
line's metrics, traced and untraced; the controls' stand-ins read what
their limits must refuse; a backbone that Adam leaves unchanged reads 1 on
`backbone_change_gap` and the run is not correct; the parent of the family
(a program whose `get_arch` does not know the architecture) stops before
any work."""

from __future__ import annotations

import contextlib
import time

import pytest
import torch

from gpbench.controls import readings
from gpbench.harness import manifest

CELL = "dkl-granite-train"


def tiny_arch(real):
    return real._replace(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
                         d_shared=48, vocab=256, n_experts=12, top_k=4, ssm_state=16,
                         ssm_head_dim=16, ssm_chunk=8, attention_multiplier=1.0 / 16,
                         attn_chunk=8)


OVERRIDES = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 16, "intermediate_size": 32, "shared_intermediate_size": 48,
    "vocab_size": 256, "router_experts": 12, "num_experts_per_tok": 4,
    "num_local_experts": 3, "mamba_d_state": 16, "mamba_d_head": 16,
    "mamba_n_heads": 8, "attention_multiplier": 1.0 / 16,
    "data": {"n": 256, "n_test": 16, "seq": 16, "vocab": 256},
    "dkl": {"microbatch": 64, "check_sequences": 8, "vjp_block": 64},
    "gp": {"precond_rank": 16},
    "hyperparameters": {"lengthscale": 2.93},   # the median pairwise distance here
}
# bf16 reads higher at d 64 than at the cell's d 4096 (0.032 and 0.078 on the
# card): the backbone's two limits at this size, each still under every
# stand-in's reading here; the configuration's other limits as committed
TINY_LIMITS = {"features_gap": 0.1, "backbone_grad_gap": 0.3}


@pytest.fixture
def tiny(monkeypatch):
    import repro_torch.models as models

    real = models.get_arch
    monkeypatch.setattr(models, "get_arch", lambda name: tiny_arch(real(name)))
    torch.set_num_threads(2)
    cell = manifest.find_cell(CELL)
    limits = {"dkl": {**cell.config["limits"]["dkl"], **TINY_LIMITS}}
    monkeypatch.setitem(OVERRIDES, "limits", limits)
    return cell


def _limits(cell):
    return OVERRIDES["limits"][manifest.load_driver(cell.traffic["driver"]).LIMITS]


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_reads_correct(tiny, trace, capsys):
    from gpbench.run import run_cell

    line = run_cell(tiny, seed=2**31 + 301, seconds=0.2, trace=trace, device="cpu",
                    t_start=time.perf_counter(), overrides=OVERRIDES)
    assert line["correct"], line["checks"]
    assert line["checks"]["moe_dropped"]["value"] == 0.0
    names = set(line["metrics"])
    if trace:
        # (no kernel launches on the CPU: mfu.dkl and the card's metrics read
        # nothing there)
        assert names == {"dkl.backbone_ms", "dkl.gp_head_ms", "dkl.moe_dispatch_ms"}
    else:
        assert names == {"setup_s", "train_step_s"}


def test_controls_read_not_correct(tiny):
    row = readings(tiny, 2**31 + 303, seconds=0.2, control=True, device="cpu",
                   overrides=OVERRIDES)
    limits = _limits(tiny)
    bad = {k: row["checks"][k] for k, v in limits.items() if not row["checks"][k] <= v}
    assert bad == {}
    for stand_in, number in (("fp8", "features_gap"), ("fp8", "backbone_grad_gap"),
                             ("capacity", "features_gap"), ("capacity", "moe_dropped"),
                             ("residual", "features_gap"),
                             ("half_g_x", "backbone_grad_gap"),
                             ("unchanged", "backbone_change_gap")):
        assert row[stand_in][number] > limits[number], (stand_in, row[stand_in])
    assert row["unchanged"]["backbone_change_gap"] == 1.0
    assert "logdet_gap" in row["program"] and "logdet_gap" not in limits


def test_a_backbone_left_unchanged_is_not_correct(tiny, monkeypatch):
    """The fault: `fit_dkl`'s Adam moves the GP head but hands the backbone
    its leaves back unchanged."""
    from gpbench.run import run_cell
    from repro_torch.train import gp_trainer

    real = gp_trainer.adam_update

    @contextlib.contextmanager
    def frozen():
        def update(params, grads, state, lr, **kw):
            (_, head), st = real(params, grads, state, lr, **kw)
            return (params[0], head), st

        monkeypatch.setattr(gp_trainer, "adam_update", update)
        yield

    line = run_cell(tiny, seed=2**31 + 305, seconds=0.2, trace=False, device="cpu",
                    t_start=time.perf_counter(), overrides=OVERRIDES, fault=frozen)
    assert not line["correct"]
    assert line["checks"]["backbone_change_gap"]["value"] == 1.0


def test_a_program_without_the_family_stops_at_once(monkeypatch):
    import repro_torch.models as models
    from gpbench.run import run_cell

    def unknown(name):
        raise KeyError(name)

    monkeypatch.setattr(models, "get_arch", unknown)
    cell = manifest.find_cell(CELL)
    t = time.perf_counter()
    with pytest.raises(KeyError):
        run_cell(cell, seed=1, seconds=0.2, trace=False, device="cpu",
                 t_start=t, overrides=OVERRIDES)
    assert time.perf_counter() - t < 5.0
