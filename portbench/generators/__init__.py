"""Input generators, made on the device from the run's seed.

A configuration names its generator (``"generator"`` in its file), the
module ``portbench/generators/<generator>.py``, whose ``generate(cfg, seed,
device)`` returns the relations of one dataset as ``(keys int64, values
float32)`` pairs, every row valid, keys uint32 values below ``0xFFFFFFFF``.
Generators draw with a ``torch.Generator`` on the device, in a few large
calls, so the same seed gives the same inputs on the same kind of device.
"""

from __future__ import annotations

import hashlib
import importlib


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (data, requests, ...)."""
    h = hashlib.sha256("/".join(map(str, (seed, *tags))).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, device):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "data"))
    return g


def generate(cfg: dict, seed: int, device) -> list:
    mod = importlib.import_module(f"portbench.generators.{cfg['generator']}")
    return mod.generate(cfg, seed, device)
