"""The loss's grads of the MoE, Mamba, hybrid and encoder-decoder archs at
``reduced()`` against ``jax.grad`` of the JAX package's loss from the same
weights, in float32 compute: each leaf within 1e-4 of its own largest
absolute grad, 1e-3 for the ssm and hybrid families, whose scans combine in
another order (``tests/torch_models_parity.py``).  The hybrid gives every
leaf a nonzero grad, as the reference's ``test_gradients_flow_everywhere``
asks of it."""

import pytest
import torch

from repro_torch.models import ARCHS, Model
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_models_parity import batch, check_grads


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen2-moe-a2.7b",
                                  "falcon-mamba-7b", "recurrentgemma-2b",
                                  "whisper-small"])
def test_mixed_arch_grads_match_jax(arch, monkeypatch):
    check_grads(arch, monkeypatch)


def test_gradients_flow_everywhere():
    cfg = ARCHS["recurrentgemma-2b"].reduced()
    model = Model(cfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batch(cfg, seed=3).items()}
    loss, _ = model.loss(b)
    loss.backward()
    zero = [k for k, p in model.named_parameters()
            if float(p.grad.abs().max()) == 0.0]
    assert zero == []
