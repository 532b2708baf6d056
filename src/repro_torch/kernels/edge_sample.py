"""CUDA kernel: fused two-way edge sampler, Algorithm 2
(``csrc/edge_sample.cu``).

Replaces the TPU kernel ``repro/kernels/edge_sample.py`` (``_kernel`` /
``edge_sample_batched``).  One warp per (slot, stratum): its lanes stride
over the draws ``t < min(b_max, b_i)`` of a joinable stratum, hash each draw
into both sides' segments, gather the two values, form ``f`` and keep
``n``, ``sum f`` and ``sum f^2`` in registers, then reduce with warp
shuffles.  No ``[S, b_max]`` tile exists, and a masked draw reads nothing.

What bounds it on the card: bytes, as random 4-byte gathers (two per draw)
from the sorted value arrays, plus 45 bytes of operands and 12 of results
per stratum.  The TPU kernel pins both value arrays in VMEM and asserts they
fit in 8 MiB; at 2^24 rows per side they are 64 MiB each, so here they stay
in global memory and the gathers go through L2.

The plain version is :func:`repro_torch.kernels.ref.edge_sample_ref`; a CPU
tensor takes it, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import edge_sample_ref

__all__ = ["edge_sample_batched", "edge_sample_ref"]

EXPRS = ("sum", "product")


def edge_sample_batched(values1: torch.Tensor, values2: torch.Tensor,
                        keys: torch.Tensor,
                        start1: torch.Tensor, count1: torch.Tensor,
                        start2: torch.Tensor, count2: torch.Tensor,
                        joinable: torch.Tensor, b_i: torch.Tensor,
                        seeds: torch.Tensor, b_max: int, expr: str = "sum"):
    """Per-slot per-stratum (n_sampled, sum_f, sum_f2), float32 ``[B, S]``.

    ``values1``/``values2`` float32 ``[B, n_side]`` sorted by key;
    ``keys``/``start*``/``count*`` int64, ``joinable`` bool and ``b_i``
    float32, each ``[B, S]``; ``seeds`` int64 ``[B]``.  Starts and counts
    must come from ``sampling.build_strata`` over these values: the kernel
    trusts every joinable segment to lie inside its array.
    """
    if expr not in EXPRS:
        raise ValueError(f"edge_sample: expr must be one of {EXPRS}")
    if not keys.is_cuda:
        return edge_sample_ref(values1, values2, keys, start1, count1,
                               start2, count2, joinable, b_i, b_max, seeds,
                               expr)
    B, S = keys.shape
    dev = keys.device
    n1, n2 = values1.shape[1], values2.shape[1]
    req = _build.require
    req("edge_sample", values1, torch.float32, (B, n1), dev)
    req("edge_sample", values2, torch.float32, (B, n2), dev)
    for t in (keys, start1, count1, start2, count2):
        req("edge_sample", t, torch.int64, (B, S), dev)
    req("edge_sample", joinable, torch.bool, (B, S), dev)
    req("edge_sample", b_i, torch.float32, (B, S), dev)
    req("edge_sample", seeds, torch.int64, (B,), dev)
    if not 0 <= b_max < 2**31:
        raise ValueError(f"edge_sample: b_max {b_max} out of range")
    if B > 65535:
        raise ValueError(f"edge_sample: at most 65535 slots, got {B}")
    out = torch.empty((3, B, S), dtype=torch.float32, device=dev)
    if B * S == 0:
        return out[0], out[1], out[2]
    fn = _build.function("edge_sample", "edge_sample", "ppiippppppppiiiipppp")
    with torch.cuda.device(dev):
        rc = fn(values1.data_ptr(), values2.data_ptr(), n1, n2,
                keys.data_ptr(), start1.data_ptr(), count1.data_ptr(),
                start2.data_ptr(), count2.data_ptr(), joinable.data_ptr(),
                b_i.data_ptr(), seeds.data_ptr(), B, S, b_max,
                int(expr == "product"), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), _build.stream(dev))
    edge_sample_batched.launches += 1
    _build.check(rc, "edge_sample")
    return out[0], out[1], out[2]


edge_sample_batched.launches = 0

