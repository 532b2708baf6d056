"""Roofline of one step from what a dry run meters, on the H100's rates.

Three terms a rank, in seconds:

    compute    = flops        / PEAK_FLOPS
    memory     = bytes        / HBM_BW
    collective = sum over the census of each call's bytes over its link's
                 rate: NVLINK_BW inside a node of GPUS_PER_NODE consecutive
                 ranks, NET_BW across nodes

The rates are the H100 SXM5's datasheet figures (not measured here).  The
JAX package reads these terms off a compiled HLO module; the port runs
eagerly and meters the step as it runs (:class:`Meters`):

* flops: ``torch.utils.flop_counter.FlopCounterMode``, which counts the
  products only (matmuls, convolutions, attention), 2 per multiply-add;
  elementwise work and reductions count nothing;
* bytes: a dispatch mode adds, for every aten op that is not a view, each
  input's bytes once and each output's once.  The port runs eager, so
  these unfused bytes are the traffic it makes.  A CUDA kernel launched
  through ctypes is not an aten op: its wrapper hands the bytes of
  ``kernels/traffic.py`` to the meter instead;
* collectives: the census of ``core/distributed.COMM`` (kind, group size,
  whether the group lies in one node; a ring's bytes, as
  ``collective_bytes`` of the JAX package counts them);
* peak memory: on ``meta`` tensors a tracker of live bytes by storage (an
  op's new storages counted at birth, dropped when the last tensor on them
  dies); on the card ``torch.cuda.max_memory_allocated``.  The record says
  which (``peak_from``).
"""

from __future__ import annotations

import statistics
import time
import weakref
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.cost import sync
from repro_torch.core.distributed import COMM, GPUS_PER_NODE
from repro_torch.kernels import traffic

# H100 SXM5 datasheet figures, per GPU
PEAK_FLOPS = 989.4e12     # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12          # HBM3 bytes/s
NVLINK_BW = 450e9         # NVLink 4 bytes/s a direction, inside a node
NET_BW = 50e9             # bytes/s a GPU across nodes (400 Gb/s NDR)

FLOPS_COUNTED = ("products only (FlopCounterMode: matmuls, convolutions, "
                 "attention; 2 per multiply-add)")
BYTES_COUNTED = ("unfused: each non-view aten op's inputs once and outputs "
                 "once, plus each kernel launch's modeled bytes")

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NET_BW", "GPUS_PER_NODE",
           "Meters", "Roofline", "analyze", "collective_stats",
           "count_params", "ep_moe_correction", "model_flops_for"]

_aten = torch.ops.aten
# ops that move no data, and ops that write their output without reading it
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_like.default,
               _aten.empty_strided.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten.set_.source_Storage,
               _aten.set_.source_Storage_storage_offset,
               _aten.resize_.default}
_WRITE_ONLY = {_aten.fill_.Scalar, _aten.fill_.Tensor, _aten.zero_.default}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Live:
    """Live bytes by storage: a storage is counted when an op makes it and
    dropped when the last tracked tensor on it dies."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._refs: dict = {}      # storage key -> [tensors alive, bytes]

    def _dead(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def _track(self, t: torch.Tensor, key: int) -> None:
        self._refs[key][0] += 1
        weakref.finalize(t, self._dead, key)

    def op(self, inputs: list, outputs: list) -> None:
        seen = {_storage_key(t) for t in inputs}
        for t in outputs:
            key = _storage_key(t)
            if key in self._refs:
                self._track(t, key)          # a view, or an in-place op
            elif key not in seen:            # a new storage
                self._refs[key] = [0, t.untyped_storage().nbytes()]
                self.live += self._refs[key][1]
                self._track(t, key)
        self.peak = max(self.peak, self.live)


class _ByteMode(TorchDispatchMode):
    """Adds each non-view aten op's input and output bytes; with ``live``,
    tracks live bytes by storage."""

    def __init__(self, live: _Live | None):
        super().__init__()
        self.bytes = 0
        self.live = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":          # c10d: the census counts it
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not func.is_view and func not in _NO_TRAFFIC:
            if func in _WRITE_ONLY:
                ins = []
            elif func is _aten.copy_.default:
                ins = ins[1:]                 # copy_ reads src, writes self
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if self.live is not None:
            self.live.op(ins, outs)
        return out


class Meters:
    """The three meters of a step, for the block: flops, bytes (aten ops
    and kernel launches) and the collective census, and the peak memory:
    tracked on ``meta`` (``device``), the card's allocator's on a card.
    Resets ``COMM`` on entry."""

    def __init__(self, device="meta"):
        self.device = torch.device(device)
        self.flops = 0
        self.aten_bytes = 0
        self.kernel_bytes: dict = {}
        self.census: list = []
        self.peak_bytes = 0
        self.peak_from = ("cuda.max_memory_allocated"
                          if self.device.type == "cuda"
                          else "live storages, tracked by op")

    def _kernel(self, name: str, nbytes: float) -> None:
        self.kernel_bytes[name] = self.kernel_bytes.get(name, 0) + nbytes

    def __enter__(self):
        COMM.reset()
        traffic.METERS.append(self._kernel)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self._base = torch.cuda.memory_allocated(self.device)
            live = None
        else:
            live = _Live()
        # the byte mode under the flop counter: it sees the ops the flop
        # counter lets through, decompositions included
        self._bytes = _ByteMode(live)
        self._flops = FlopCounterMode(display=False)
        self._bytes.__enter__()
        self._flops.__enter__()
        return self

    def __exit__(self, *exc):
        self._flops.__exit__(*exc)
        self._bytes.__exit__(*exc)
        traffic.METERS.remove(self._kernel)
        self.flops = self._flops.get_total_flops()
        self.aten_bytes = self._bytes.bytes
        self.census = COMM.census()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak_bytes = (torch.cuda.max_memory_allocated(self.device)
                               - self._base)
        else:
            self.peak_bytes = self._bytes.live.peak
        return False

    @property
    def hbm_bytes(self) -> float:
        return float(self.aten_bytes + sum(self.kernel_bytes.values()))


class CollectiveStats(NamedTuple):
    bytes_by_kind: dict
    count_by_kind: dict
    nvlink_bytes: float
    network_bytes: float

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    @property
    def seconds(self) -> float:
        return self.nvlink_bytes / NVLINK_BW + self.network_bytes / NET_BW


def collective_stats(census: list) -> CollectiveStats:
    """Bytes and calls by kind, and the bytes on each kind of link, of a
    ``COMM.census()``."""
    by_bytes: dict = {}
    by_count: dict = {}
    nvlink = network = 0.0
    for c in census:
        by_bytes[c["kind"]] = by_bytes.get(c["kind"], 0.0) + c["bytes"]
        by_count[c["kind"]] = by_count.get(c["kind"], 0) + c["calls"]
        if c["intra_node"]:
            nvlink += c["bytes"]
        else:
            network += c["bytes"]
    return CollectiveStats(by_bytes, by_count, nvlink, network)


class Roofline(NamedTuple):
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float              # this rank's counted flops
    hbm_bytes: float          # this rank's unfused bytes
    coll_bytes: float         # this rank's collective bytes (ring model)
    collectives: dict         # calls per kind
    model_flops: float        # 6ND-style useful flops (global)
    useful_fraction: float    # model_flops / (flops * chips)
    nvlink_bytes: float       # of coll_bytes, on groups inside a node
    network_bytes: float      # of coll_bytes, on groups across nodes

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def floor_s(self) -> float:
        """The least time one device's own work could take: the larger of
        its compute and memory terms (what a measured time is held to)."""
        return max(self.compute_s, self.memory_s)

    def against(self, measured_s: float) -> str:
        """`` measured=...s floor/measured=...`` for a report line."""
        return (f" measured={measured_s:.4e}s "
                f"floor/measured={self.floor_s / measured_s:.3f}")


def analyze(meters: Meters, *, chips: int, model_flops: float) -> Roofline:
    """The roofline of the step ``meters`` metered on one of ``chips``
    ranks."""
    coll = collective_stats(meters.census)
    flops = float(meters.flops)
    hbm = meters.hbm_bytes
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=hbm / HBM_BW,
        collective_s=coll.seconds,
        flops=flops, hbm_bytes=hbm, coll_bytes=coll.total_bytes,
        collectives={k: v for k, v in coll.count_by_kind.items() if v},
        model_flops=model_flops,
        useful_fraction=model_flops / max(flops * chips, 1.0),
        nvlink_bytes=coll.nvlink_bytes, network_bytes=coll.network_bytes)


def roofline_record(roof: Roofline) -> dict:
    """The record's ``roofline`` entries of ``roof``."""
    return {"compute_s": roof.compute_s, "memory_s": roof.memory_s,
            "collective_s": roof.collective_s, "dominant": roof.dominant,
            "flops_per_device": roof.flops,
            "hbm_bytes_per_device": roof.hbm_bytes,
            "coll_bytes_per_device": roof.coll_bytes,
            "nvlink_bytes_per_device": roof.nvlink_bytes,
            "network_bytes_per_device": roof.network_bytes,
            "collective_ops": roof.collectives,
            "model_flops": roof.model_flops,
            "useful_fraction": roof.useful_fraction,
            "flops_counted": FLOPS_COUNTED, "bytes_counted": BYTES_COUNTED}


def timed(run, device, reps: int) -> float:
    """Median wall seconds of ``run()`` on ``device`` (synchronized on the
    card), unmetered: what a floor is held against."""
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        run()
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def ep_moe_correction(cfg, cell_kind: str, batch: int, seq: int,
                      chips: int, tp: int) -> tuple:
    """Analytic (flops, hbm bytes) a rank of the EP MoE layers' expert
    matmuls: what the JAX package adds to an HLO count that cannot see
    inside ``shard_map`` bodies.  The port's flop counter sees the EP
    bodies, so the port's counts never add it; it is kept to compare.

      * dispatched slots a rank = E_pad * C / tp (block-EP), the same as
        E * C * (ffe / tp) / ffe (ffe-TP);
      * 3 matmuls (wg, wu, wd) x 2 flops, x4 for train (forward, 2 x
        backward, remat's forward again), x1 otherwise;
      * bytes: the expert weights a rank holds (float32) read each pass,
        and the bucket tensors (xs, h, ys in bf16) written and read.
    """
    m = cfg.moe
    E, K, ffe, d = m.num_experts, m.top_k, m.d_ff_expert, cfg.d_model
    E_pad = -(-E // tp) * tp
    n_dp = max(chips // tp, 1)
    n_tok_local = max(batch * seq // n_dp, 1) if cell_kind != "decode" \
        else max(batch // n_dp, 1)
    C = max(int(n_tok_local * K * m.capacity_factor) // E, K)
    layers = cfg.n_layers
    passes = 4.0 if cell_kind == "train" else 1.0
    slot_flops = 3 * 2 * (E_pad * C // tp) * d * ffe
    flops = layers * passes * slot_flops
    w_bytes = 3 * E * d * ffe * 4 / tp
    bucket_bytes = 3 * (E_pad * C // tp) * max(d, ffe) * 2 * 2
    hbm = layers * passes * (w_bytes + bucket_bytes)
    return float(flops), float(hbm)


def model_flops_for(cfg, n_params: int, n_active: int, cell_kind: str,
                    batch: int, seq: int) -> float:
    """6ND (train) / 2ND (prefill) / 2N per token (decode), active params."""
    if cell_kind == "train":
        return 6.0 * n_active * batch * seq
    if cell_kind == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch      # decode: one token per sequence


def count_params(model, cfg) -> tuple:
    """(total, active) parameter counts of a whole (unsharded) ``Model``,
    ``meta`` serves.  Counted by the JAX package's leaves (the port's
    stacks stacked, ``convert.reference_groups``), with its rule: a leaf
    of three or more dims under an ``ff_`` key and not ``shared`` counts
    ``top_k / num_experts`` of itself as active (rounded down a leaf)."""
    from repro_torch.models.convert import is_stacked, reference_groups
    named = dict(model.named_parameters())
    total = active = 0
    for path, group in reference_groups(named).items():
        names = path.split(".")
        n = sum(named[g].numel() for g in group)
        ndim = named[group[0]].dim() + is_stacked(group[0])
        total += n
        if cfg.moe and any(x.startswith("ff_") for x in names) \
                and "shared" not in names and ndim >= 3:
            active += int(n * (cfg.moe.top_k / cfg.moe.num_experts))
        else:
            active += n
    return total, active
