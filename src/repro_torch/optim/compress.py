"""int8 error-feedback gradient compression for the data-parallel
all-reduce: the port of the JAX package's ``optim/compress.py``.

Per-leaf symmetric int8 quantization with an error-feedback accumulator:
the quantization residual is carried to the next step, so the compressed
trajectory tracks the exact one (Karimireddy et al., 2019).  The payload is
each leaf's codes widened to float16 times its float16 scale, summed over
the group in float16 and divided by its size, as the reference's ``psum``
does; here every leaf's payload travels in one all_reduce, metered by
``core/distributed.COMM`` like every other collective.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distributed import all_reduce


def compress_int8(x: torch.Tensor) -> tuple:
    """-> (int8 codes, float32 0-d scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


@torch.no_grad()
def ef_compress_grads(grads: dict, error_buf: dict, group=None) -> tuple:
    """Compress, sum over ``group`` (the default group when None) and
    decompress every leaf with error feedback.  Returns (mean grads, new
    error buffer), dicts keyed as ``grads``."""
    k = dist.get_world_size(group)
    names = list(grads)
    payload, new_e = [], {}
    for name in names:
        g = grads[name].float() + error_buf[name]
        codes, scale = compress_int8(g)
        new_e[name] = g - decompress_int8(codes, scale)
        payload.append((codes.half() * scale.half()).reshape(-1))
    summed = all_reduce(torch.cat(payload), group).float() / k
    parts = summed.split([p.numel() for p in payload])
    return ({n: part.view_as(grads[n]) for n, part in zip(names, parts)},
            new_e)
