"""The loss's grads of the attention archs at ``reduced()``: the port's
backward (autograd, block remat) against ``jax.grad`` of the JAX package's
loss from the same weights, in float32 compute; each leaf within 1e-4 of
its own largest absolute grad (``tests/torch_models_parity.py``)."""

import pytest

from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_models_parity import check_grads


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-0.5b", "gemma2-9b",
                                  "granite-20b", "phi-3-vision-4.2b"])
def test_dense_arch_grads_match_jax(arch, monkeypatch):
    check_grads(arch, monkeypatch)
