"""The attention archs at ``reduced()``: the port against the JAX package
with the same weights (``params_from_jax``) and inputs, forward logits,
loss and a step-by-step decode from an empty cache, in float32 and in bf16
(tolerances in ``tests/torch_models_parity.py``)."""

import pytest

from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_models_parity import no_grad  # noqa: F401  (autouse)
from torch_models_parity import check_arch

DENSE = ["qwen3-1.7b", "qwen2-0.5b", "granite-20b", "gemma2-9b",
         "phi-3-vision-4.2b"]


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_matches_jax(arch, dtype, monkeypatch):
    check_arch(arch, dtype, monkeypatch)
