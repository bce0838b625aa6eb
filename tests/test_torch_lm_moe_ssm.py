"""The port's LM stack against the reference on the CPU in fp32: the moe
family (granite, qwen2-moe) and the ssm family (mamba2), each on its
reduced config.

For each arch (`tests/_torch_lm_case.py`): `forward_hidden` (h and the
MoE aux), `train_loss` and both of its metrics, every leaf's gradient of
`train_loss`, `prefill`'s last-token logits and every cache leaf, and 3
`decode_step`s' logits and caches, all at the conformance tolerances
(arrays within 2e-4 of their largest entry, scalars within 3e-5
relative), with the same weights and inputs on both sides.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import pytest

from _torch_lm_case import (
    check_decode, check_forward_hidden, check_grads, check_prefill,
    check_train_loss)

ARCHS = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b", "mamba2-130m")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(arch):
    check_forward_hidden(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(arch):
    check_train_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    check_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    check_decode(arch)
