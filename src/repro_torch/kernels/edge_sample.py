"""CUDA kernel: fused two-way edge sampler, Algorithm 2
(``csrc/edge_sample.cu``).

Replaces the TPU kernel ``repro/kernels/edge_sample.py`` (``_kernel`` /
``edge_sample_batched``).  A joinable stratum draws the ``n_i`` draws
``t < b_max`` with ``float(t) < b_i``; each draw hashes into both sides'
segments, gathers the two values and forms ``f``; the kernel returns ``n``,
``sum f`` and ``sum f^2`` per stratum.  No ``[S, b_max]`` tile exists, and a
masked draw reads nothing.

What bounds it on the card: operations, per draw the rest of two counter
hashes and two remainders, and each stratum's chain of dependent steps; its
bytes need far less time.  A plan kernel lists the drawing strata with
their operands in a compact list and writes zeros for the others; a
persistent grid then gives a stratum of more than 256 draws a block of 4
warps and the others a warp each, 8 draws a thread at once so 16 gathers are
in flight.  The draw counter's hash round comes from a table made once per
launch, the rounds' meeting xor-shifts cancel, and ``h % count`` is a
multiply-high by a per-stratum magic number.  The sums are added in a fixed
order whichever block or warp takes a stratum, so the results are
deterministic: two launches agree bit for bit, and a ``B``-slot launch
equals ``B`` one-slot launches.

The plain version is :func:`repro_torch.kernels.ref.edge_sample_ref`; a CPU
tensor takes it, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, traffic
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
    if not 0 <= b_max <= 2**24:
        # every t < b_max is a float32, so n_sampled is exact
        raise ValueError(f"edge_sample: b_max {b_max} not in [0, 2^24]")
    if max(n1, n2, B * S) >= 2**31:
        raise ValueError("edge_sample: values and B * S must stay below 2^31")
    out = torch.empty((3, B, S), dtype=torch.float32, device=dev)
    if B * S == 0:
        return out[0], out[1], out[2]
    nbytes = _build.function("edge_sample", "edge_sample_scratch_bytes", "iii",
                             ctypes.c_int64)(B, S, b_max)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = _build.function("edge_sample", "edge_sample",
                         "ppiippppppppiiiippppp")
    with torch.cuda.device(dev):
        rc = fn(values1.data_ptr(), values2.data_ptr(), n1, n2,
                keys.data_ptr(), start1.data_ptr(), count1.data_ptr(),
                start2.data_ptr(), count2.data_ptr(), joinable.data_ptr(),
                b_i.data_ptr(), seeds.data_ptr(), B, S, b_max,
                int(expr == "product"), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), scratch.data_ptr(), _build.stream(dev))
    edge_sample_batched.launches += 1
    traffic.record("edge_sample", lambda: traffic.edge_sample_bytes(
        B, S, traffic.edge_sample_gathered(out[0], (count1, count2),
                                           joinable)))
    _build.check(rc, "edge_sample")
    return out[0], out[1], out[2]


edge_sample_batched.launches = 0

