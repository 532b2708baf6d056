"""Mamba, RG-LRU, whisper and the MoE archs at ``reduced()``: the port
against the JAX package with the same weights (``params_from_jax``) and
inputs, forward logits, loss and a step-by-step decode from an empty cache
(tolerances in ``tests/torch_models_parity.py``).  The MoE archs compare in
float32 only: in bf16 a rounding step can flip a top-k expert choice, after
which the two packages route a token to different experts."""

import pytest

from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_models_parity import no_grad  # noqa: F401  (autouse)
from torch_models_parity import check_arch

MIXED = ["falcon-mamba-7b", "recurrentgemma-2b", "whisper-small"]
MOE = ["moonshot-v1-16b-a3b", "qwen2-moe-a2.7b"]


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("arch", MIXED)
def test_mixed_arch_matches_jax(arch, dtype, monkeypatch):
    check_arch(arch, dtype, monkeypatch)


@pytest.mark.parametrize("arch", MOE)
def test_moe_arch_matches_jax_in_float32(arch, monkeypatch):
    errs = check_arch(arch, "float32", monkeypatch)
    assert "aux" in errs
