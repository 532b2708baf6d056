#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: a CUDA card must be present; prints its name and nvidia-smi's
   name and power limit;
2. build: compiles the three CUDA kernels from ``src/repro_torch/csrc`` into
   ``build/repro_torch_kernels/`` (one nvcc per source, in parallel); prints
   the card's integer rates (SMs x lanes x nvidia-smi's maximum SM clock)
   and each kernel's integer operations per key or draw (``INT_OPS``);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (B = 1), and a B = 4 batch with mixed
   seeds against four B = 1 calls; filter words, probe masks and draw counts
   must match exactly, the float sums within rtol 1e-5 (atol 1e-3), since
   they add in another order.  Times each (CUDA events, median of 20 after
   warm-up) beside its bound: the larger of its bytes over the memory rate
   and its operations over the float32 and integer rates.  The build is
   also checked and timed on 2^24 distinct keys, where every key commits;
4. main path: ``approx_join(..., use_kernels=True)`` on two relations of
   2^24 rows (an exact SUM, a sampled SUM twice under one SigmaRegistry, a
   sampled AVG, a sampled SUM of products, twice over), checked against a
   float64 numpy oracle of the exact join; every kernel must have launched
   during it;
5. profile: device time by kernel for one more warm sampled request.

It then prints one line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX.  Run from a checkout of another commit (the
script copied into it), it times that commit's kernels the same way.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ROWS = 1 << 24            # rows per input relation
KEYS_PER_DATASET = 1 << 16
MAX_STRATA = 1 << 16
B_MAX = 2048
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12          # H100 SXM float32 rate outside the tensor cores
# Hopper SM: 4 partitions, each with 16 lanes of the integer ALU pipe and
# 16 of the multiply-add pipe that runs IMAD, and one warp instruction
# dispatched a clock
INT_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128
REPS = 20
PLAIN_REPS = 10
MIXED_SEEDS = (0, 1, 0x9E3779B1, 0xFFFFFFFF)
# line of pl.pallas_call in each TPU kernel, src/repro/kernels/<name>.py
REPLACES = {"bloom_build": 53, "bloom_probe": 67, "edge_sample": 94}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int) -> float:
    """Median time of one call of ``fn`` on the card, by CUDA events."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def int_rates(torch):
    """(operations per second of each integer pipe, of instruction dispatch,
    where the figures come from): SMs x lanes x the SM clock's maximum as
    nvidia-smi reports it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi clocks.max.sm failed")
    mhz = float(smi.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (sms * INT_LANES_PER_SM * mhz * 1e6,
            sms * DISPATCH_LANES_PER_SM * mhz * 1e6,
            f"{sms} SMs x {INT_LANES_PER_SM} lanes (ALU pipe; IMAD pipe the "
            f"same) or x {DISPATCH_LANES_PER_SM} (dispatch) x {mhz:.0f} MHz "
            f"(nvidia-smi clocks.max.sm)")


# Integer operations per key (bloom_build, bloom_probe) or per drawn edge
# (edge_sample) that each function needs, counted from csrc/hashing.cuh and
# the kernels' sources: one per 32-bit multiply, add, shift, compare or
# logic operation (one LOP3 takes any logic of three inputs), once per key
# even where two lanes share a key.  Loads, stores, address arithmetic and
# per-stratum work are left out.  "fma": multiplies, and adds, which either
# pipe runs, on the multiply-add pipe; "alu": shifts, logic and compares,
# which only the ALU pipe runs.
#   hash2_premixed: xor, fmix32 (3 shifts, 3 xors, 2 multiplies): 7 alu,
#     2 fma; block index (h & mask): 1 alu; lane_masks: h * C + 1, fmix32,
#     8 x (multiply, shift, 1 << s): 22 alu, 11 fma;
#   bloom_build: + validity test, 8 ORs of the lanes' bits: 9 alu;
#   bloom_probe: + 8 x (mask & ~word, OR-ed together), test for 0: 9 alu;
#   edge_sample: t * GOLDEN, + 1 for side 1: 2 fma; per side 3 fmix32, 2
#     xors and % by the stratum's count (multiply-high, multiply-subtract,
#     2 compares, 2 conditional subtractions): 22 alu, 10 fma; the draw
#     counter's add and compare with b_max: 1 fma, 1 alu.
INT_OPS = {"bloom_build": dict(alu=39, fma=13),
           "bloom_probe": dict(alu=39, fma=13),
           "edge_sample": dict(alu=45, fma=23)}


def bound(rates, nbytes: float, flops: float = 0.0, alu: float = 0.0,
          fma: float = 0.0):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate, the float operations over the float32 rate,
    each integer pipe's operations over its rate, and all operations (one
    instruction each) over the dispatch rate."""
    pipe, dispatch = rates
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS, alu / pipe, fma / pipe,
                (alu + fma + flops) / dispatch) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def oracle(rels):
    """Exact join aggregates in float64 on the host: count, SUM(v1+v2),
    SUM(v1*v2)."""
    from repro_torch.core.relation import to_numpy
    parts = []
    for r in rels:
        k, v = to_numpy(r)
        u, inv, c = np.unique(k, return_inverse=True, return_counts=True)
        parts.append((u, c.astype(np.float64),
                      np.bincount(inv, weights=v.astype(np.float64))))
    (u1, c1, s1), (u2, c2, s2) = parts
    _, i1, i2 = np.intersect1d(u1, u2, assume_unique=True,
                               return_indices=True)
    c1, s1, c2, s2 = c1[i1], s1[i1], c2[i2], s2[i2]
    return dict(count=float(np.sum(c1 * c2)),
                sum=float(np.sum(s1 * c2 + s2 * c1)),
                product=float(np.sum(s1 * s2)))


def kernel_phase(rels, torch, rates):
    """Phase 3: each kernel against its plain version at main-path shapes,
    timed beside its bound (``rates``: the integer pipe and dispatch rates)."""
    from repro_torch.core import bloom
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.hashing import fmix32
    from repro_torch.core.join import (decide_sample_sizes,
                                       prepare_stage_kernels)
    from repro_torch.kernels import bloom_build as kb
    from repro_torch.kernels import bloom_probe as kp
    from repro_torch.kernels import edge_sample as ke

    dev = rels[0].keys.device
    nb = bloom.num_blocks_for(ROWS, 0.01)
    seed1 = torch.tensor([SEED], device=dev)
    seeds4 = torch.tensor(MIXED_SEEDS, device=dev)
    keys = [r.keys[None] for r in rels]
    valid = [r.valid[None] for r in rels]
    lines = []

    def int_ops(name, items):
        return {pipe: items * n for pipe, n in INT_OPS[name].items()}

    def line(name, err, ms, plain_ms, nbytes, items, flops=0.0):
        ops = int_ops(name, items)
        b_ms, b_by = bound(rates, nbytes, flops, **ops)
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/csrc/{name}.cu",
                    replaces=f"src/repro/kernels/{name}.py:{REPLACES[name]}",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, bound_ops=sum(ops.values()),
                    share_of_bound=b_ms / ms,
                    library_ms=None)

    # --- bloom_build: one input's filter -------------------------------
    words_k = [kb.bloom_build_batched(k, v, nb, seed1)
               for k, v in zip(keys, valid)]
    words_p = kb.bloom_build_ref(keys[0], valid[0], nb, seed1)
    check(torch.equal(words_k[0], words_p), "bloom_build words != plain")
    keys4 = torch.cat([keys[0], keys[1], keys[0], keys[1]])
    valid4 = torch.cat([valid[0], valid[1], valid[0], valid[1]])
    words4 = kb.bloom_build_batched(keys4, valid4, nb, seeds4)
    for b in range(4):
        one = kb.bloom_build_batched(keys4[b:b + 1], valid4[b:b + 1], nb,
                                     seeds4[b:b + 1])
        check(torch.equal(words4[b:b + 1], one),
              f"bloom_build B=4 slot {b} != B=1 call")
    ms = time_ms(lambda: kb.bloom_build_batched(keys[0], valid[0], nb, seed1),
                 REPS)
    plain_ms = time_ms(
        lambda: kb.bloom_build_ref(keys[0], valid[0], nb, seed1), PLAIN_REPS)
    n_valid = float(valid[0].sum())
    lines.append(line("bloom_build",
                      float((words_k[0].long() - words_p.long()).abs().max()),
                      ms, plain_ms, ROWS * (8 + 1) + 8 + nb * 32, n_valid))
    # the worst case for committing only missing bits: 2^24 distinct keys
    # (fmix32 is a bijection), every one of which must commit
    dkeys = fmix32(torch.arange(ROWS, device=dev))[None]
    dvalid = torch.ones_like(dkeys, dtype=torch.bool)
    check(torch.equal(kb.bloom_build_batched(dkeys, dvalid, nb, seed1),
                      kb.bloom_build_ref(dkeys, dvalid, nb, seed1)),
          "bloom_build words != plain on distinct keys")
    d_ms = time_ms(lambda: kb.bloom_build_batched(dkeys, dvalid, nb, seed1),
                   REPS)
    d_bound, d_by = bound(rates, ROWS * (8 + 1) + 8 + nb * 32, 0.0,
                          **int_ops("bloom_build", ROWS))
    print(f"kernel bloom_build on {ROWS} distinct keys: {d_ms:.4f} ms "
          f"(bound {d_bound:.4f} ms by {d_by})")

    # --- bloom_probe: one input's keys against the join filter ---------
    jwords = words_k[0] & words_k[1]
    mask_k = kp.bloom_probe_batched(jwords, keys[0], seed1)
    mask_p = kp.bloom_probe_ref(jwords, keys[0], seed1)
    check(torch.equal(mask_k, mask_p), "bloom_probe mask != plain")
    check(bool(mask_k[valid[0]].any()), "bloom_probe: no key passed")
    mask4 = kp.bloom_probe_batched(words4, keys4, seeds4)
    for b in range(4):
        one = kp.bloom_probe_batched(words4[b:b + 1], keys4[b:b + 1],
                                     seeds4[b:b + 1])
        check(torch.equal(mask4[b:b + 1], one),
              f"bloom_probe B=4 slot {b} != B=1 call")
        check(bool(one[valid4[b:b + 1]].all()),
              f"bloom_probe slot {b}: a built key missed")
    ms = time_ms(lambda: kp.bloom_probe_batched(jwords, keys[0], seed1), REPS)
    plain_ms = time_ms(lambda: kp.bloom_probe_ref(jwords, keys[0], seed1),
                       PLAIN_REPS)
    lines.append(line("bloom_probe",
                      float((mask_k.int() - mask_p.int()).abs().max()),
                      ms, plain_ms, ROWS * 8 + nb * 32 + 8 + ROWS * 1,
                      ROWS))

    # --- edge_sample: the sampled SUM's first (pilot) request ----------
    prep = prepare_stage_kernels(rels, nb, MAX_STRATA, SEED)
    st = prep.strata
    b_i = decide_sample_sizes(QueryBudget(error=0.01), st, None, 0.0, None,
                              0.95)
    v1, v2 = (r.values[None] for r in prep.sorted_rels)
    ops = [x[None].contiguous() for x in (st.keys, st.starts[0], st.counts[0],
                                          st.starts[1], st.counts[1],
                                          st.joinable, b_i)]
    seed_s = torch.tensor([SEED + 1], device=dev)
    out_k = ke.edge_sample_batched(v1, v2, *ops, seed_s, B_MAX)
    out_p = ke.edge_sample_ref(v1, v2, *ops, B_MAX, seed_s)
    check(torch.equal(out_k[0], out_p[0]), "edge_sample n_sampled != plain")
    for got, want, what in zip(out_k[1:], out_p[1:], ("sum_f", "sum_f2")):
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
              f"edge_sample {what} != plain")
    draws = float(out_k[0].sum())
    check(draws > 0, "edge_sample drew nothing")
    rep4 = lambda x: x.expand(4, -1).contiguous()  # noqa: E731
    out4 = ke.edge_sample_batched(rep4(v1), rep4(v2), *map(rep4, ops),
                                  seeds4, B_MAX)
    for b in range(4):
        one = ke.edge_sample_batched(v1, v2, *ops, seeds4[b:b + 1], B_MAX)
        for got, want in zip(out4, one):
            check(torch.equal(got[b:b + 1], want),
                  f"edge_sample B=4 slot {b} != B=1 call")
    ms = time_ms(lambda: ke.edge_sample_batched(v1, v2, *ops, seed_s, B_MAX),
                 REPS)
    plain_ms = time_ms(lambda: ke.edge_sample_ref(v1, v2, *ops, B_MAX, seed_s),
                       PLAIN_REPS)
    S = st.keys.shape[0]
    gathered = sum(min(draws, v.shape[1]) * 4 for v in (v1, v2))
    err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
    lines.append(line("edge_sample", err, ms, plain_ms,
                      S * (8 + 4 * 8 + 1 + 4) + 8 + gathered + S * 3 * 4,
                      draws, flops=5 * draws))
    for ln in lines:
        print(f"kernel {ln['name']}: {ln['ms']:.4f} ms (bound "
              f"{ln['bound_ms']:.4f} ms by {ln['bound_by']}, "
              f"{100 * ln['share_of_bound']:.1f}% of it; "
              f"{ln['bound_ops']:.4g} int ops), plain {ln['plain_ms']:.4f} "
              f"ms, max_abs_err {ln['max_abs_err']}")
    print(f"kernel shapes: rows {ROWS}, num_blocks {nb}, strata {S}, "
          f"b_max {B_MAX}, draws {draws:.0f}")
    return lines


def main_path(rels, truth, torch):
    """Phase 4: the port's approx_join on the card, against the oracle."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.cost import SigmaRegistry
    from repro_torch.core.join import approx_join

    def request(label, budget, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = approx_join(rels, budget, seed=SEED, max_strata=MAX_STRATA,
                          b_max=B_MAX, use_kernels=True, **kw)
        est, bnd = float(res.estimate), float(res.error_bound)
        total = time.perf_counter() - t0
        d = res.diagnostics
        check(int(d.strata_overflow) == 0, f"{label}: strata overflow")
        check(np.isfinite(est) and np.isfinite(bnd), f"{label}: not finite")
        print(f"request {label}: total {total * 1e3:.3f} ms = prepare "
              f"{d.d_filter_s * 1e3:.3f} + sample {d.d_sample_s * 1e3:.3f} + "
              f"estimate {d.d_estimate_s * 1e3:.3f} ms (+ host); estimate "
              f"{est!r} bound {bnd!r}, strata {int(d.num_strata)}, "
              f"draws {float(d.sample_draws):.0f}")
        return res, est, bnd

    def sampled_ok(label, est, bnd, want):
        check(bnd > 0, f"{label}: error bound {bnd} not positive")
        check(abs(est - want) <= 3 * bnd,
              f"{label}: |{est} - {want}| > 3 x bound {bnd}")

    # two rounds: the first pays PyTorch's one-time CUDA set-up per
    # operator, the second shows the steady state
    for rnd in ("first", "warm"):
        res, est, _ = request(f"{rnd}/exact-sum", QueryBudget())
        check(not res.diagnostics.sampled, "exact request sampled")
        check(abs(est - truth["sum"]) <= 1e-4 * abs(truth["sum"]),
              f"exact SUM {est} vs oracle {truth['sum']}")
        cnt = float(res.count)
        check(abs(cnt - truth["count"]) <= 1e-6 * truth["count"],
              f"exact count {cnt} vs oracle {truth['count']}")

        reg = SigmaRegistry()
        for run in ("pilot", "sigma"):
            label = f"{rnd}/sampled-sum-{run}"
            check((run == "sigma") == reg.has("q-sum"),
                  f"{label}: sigma registry state")
            _, est, bnd = request(label, QueryBudget(error=0.01),
                                  sigma_registry=reg, query_id="q-sum")
            sampled_ok(label, est, bnd, truth["sum"])
        _, est, bnd = request(f"{rnd}/sampled-avg", QueryBudget(error=0.01),
                              agg="avg")
        sampled_ok(f"{rnd}/sampled-avg", est, bnd,
                   truth["sum"] / truth["count"])
        _, est, bnd = request(f"{rnd}/sampled-product",
                              QueryBudget(error=0.01), expr="product")
        sampled_ok(f"{rnd}/sampled-product", est, bnd, truth["product"])


def profile_phase(rels, torch):
    """Phase 5: where the time of one warm sampled SUM request goes, from
    torch.profiler's device trace: kernel time by name and the share of the
    request's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.join import approx_join

    def run():
        res = approx_join(rels, QueryBudget(error=0.01), seed=SEED,
                          max_strata=MAX_STRATA, b_max=B_MAX,
                          use_kernels=True)
        float(res.estimate)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in by_name.values())
    if not by_name:
        print("profile: the profiler recorded no device time (not measured)")
        return
    print(f"profile: request wall {wall_us / 1e3:.3f} ms under the profiler, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
          f"{sum(n for _, n in by_name.values())} device events")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / 1e3:9.4f} ms {n:4d}x  {name[:90]}")


def main() -> int:
    import torch

    # --- phase 1: device ------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    print(f"device: {kind}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 2: build ---------------------------------------------------
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(report)}")
    for name, (_, log) in sorted(report.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    *rates, rates_src = int_rates(torch)
    print(f"integer rates: {rates[0]:.4g} operations/s a pipe, {rates[1]:.4g} "
          f"dispatched = {rates_src}")
    print(f"integer operations per key or draw, from the source: {INT_OPS}")

    from repro_torch.data.synthetic import overlapping_relations
    from repro_torch.kernels import bloom_build, bloom_probe, edge_sample
    t0 = time.perf_counter()
    rels = overlapping_relations([ROWS, ROWS], overlap_fraction=0.1,
                                 keys_per_dataset=KEYS_PER_DATASET, lam=10,
                                 seed=SEED, device="cuda")
    truth = oracle(rels)
    print(f"data: 2 x {ROWS} rows in {time.perf_counter() - t0:.1f} s; "
          f"oracle {truth}")

    # --- phase 3: kernels against their plain versions ---------------------
    lines = kernel_phase(rels, torch, rates)

    # --- phase 4: main path -----------------------------------------------
    wrappers = {"bloom_build": bloom_build.bloom_build_batched,
                "bloom_probe": bloom_probe.bloom_probe_batched,
                "edge_sample": edge_sample.edge_sample_batched}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    main_path(rels, truth, torch)
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"main path: launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    for ln in lines:
        ln["launches"] = launches[ln["name"]]

    # --- phase 5: where the time goes --------------------------------------
    profile_phase(rels, torch)

    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
