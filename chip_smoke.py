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
   they add in another order, and two edge_sample launches bit for bit.
   Times each on the device (CUDA-graph replays) and from the host, beside
   its bound: the larger of its bytes over the memory rate and its
   operations over the float32 and integer rates.  The build is also
   checked and timed on 2^24 distinct keys, where every key commits, and
   edge_sample on the strata of two Zipf(1.5)-skewed relations;
4. main path: ``approx_join(..., use_kernels=True)`` on two relations of
   2^24 rows (an exact SUM, a sampled SUM twice under one SigmaRegistry, a
   sampled AVG, a sampled SUM of products, twice over), checked against a
   float64 numpy oracle of the exact join; every kernel must have launched
   during it;
5. profile: device time by kernel for one more warm sampled request;
6. serving: one ``JoinServer(batch_slots=8)`` serves, through the three
   kernels, a large class (the phase-4 pair registered as a dataset: 8 SUM
   requests, 3 query ids under an error budget twice each and 2 exact,
   mixed seeds with 0xFFFFFFFF among them) and a small class (16 tenants of
   2 x 2^16 rows, 4 requests each, interleaved), twice.  Every result of
   the first pass must equal the port's direct
   ``approx_join(use_kernels=True)`` bit for bit (each query id's requests
   through a sequential driver with its own SigmaRegistry); exact SUMs
   within rtol 1e-4 of the oracle, sampled ones within 3 x their bound (a
   bound of 0, every stratum drawn in full, within 3 x the bound without
   its finite-population term, which must reject the answer of a sampler
   that draws only each stratum's first edge on most such results).
   Every step must launch the probe once per input (and once more per input
   when it warms a fresh prepare stage) and the sampler at most once, the
   builds must equal the filter-cache misses, the second pass must build
   nothing, each class must serve a step of more than one slot, a traced
   step must pass ``validate_chrome_trace``, and a large step's peak device
   memory must stay within 1.5 x ``slot_bytes`` x its slots.  Prints each
   class's q/s and latency percentiles over the warm second pass, every
   step's time and peak, a traced step's host time by part, the device busy
   share and longest device ops of a step of each class, and
   ``bloom_probe`` timed at the small class's served shape beside its bound;
7. streaming: one ``StreamJoinServer(batch_slots=4, window_slots=8)`` serves
   three sessions through the three kernels, every window a SUM under
   ``QueryBudget(error=0.01)``: A slides windows of 8 sub-windows of 2^20
   rows a side by one over the phase-4 pair cut into 16 micro-batches, B
   the same over a second pair (seed 1), C tumbles over the phase-4 pair;
   16 ticks push one micro-batch a session and input, then ``run()``.  Every
   window must equal its rows registered as a dataset on a fresh
   ``JoinServer(batch_slots=1)`` bit for bit (the session's query id, seeds
   and budget, in window order), its ORed words a fresh build over its rows;
   the builds, filter-cache hits and retired word entries must be as
   reckoned (``STREAM_*``), every step launch the probe twice (four times
   when it warms a fresh stage) and the sampler once; each window within 3 x
   its bound of a float64 oracle of its rows (per-tick key counts and sums,
   grouped on the card), C's running estimate within 3 x its bound of its
   windows' summed oracle; every session's sketch equal to the same folds of
   CPU copies bit for bit; each step's peak within 1.5 x ``slot_bytes`` x
   slots; ``edge_sample`` on the operands a step of 3 windows gave it equal
   to its plain version bit for bit.  Prints windows a second, window e2e
   p50/p95, the pushes' host time by part, each step, the device busy share
   of a steady-state step, and ``bloom_build`` and ``bloom_probe`` timed at
   the stream's shapes;
8. plans: three relations of 2^24 rows (``overlapping_relations([2^24] *
   3, 0.1, keys_per_dataset=2^16, lam=10, seed=0)``) registered as datasets
   A, B and C on a ``JoinServer``; a two-node plan, ``ab`` = (A, B) and
   ``abc`` = (ab, C), which fuses to a 3-way join, both SUMs under
   ``QueryBudget(error=0.01)`` on the kernel route, submitted twice, then
   once with exact budgets.  Every node must equal the port's composed
   direct ``approx_join(use_kernels=True)`` bit for bit; the second
   submission must compile nothing; the compiled byte model must put the
   fused stage's bytes below the binary tree's; exact nodes within rtol
   1e-4 of a float64 oracle (for the 3-way SUM of sums, sum over keys of
   s1 c2 c3 + c1 s2 c3 + c1 c2 s3), sampled ones within 3 x their bound (as
   phase 6 holds them); every step must launch the probe once per input
   (twice when it warms its stage), the sampler once for a sampled 2-way
   node and never for a 3-way one, and the build once per filter-cache miss
   (3 for the 3-way node on a cold cache); each step's peak within 1.5 x
   its ``slot_bytes``.  Prints the plan's compile time, each node's wall
   time and peak memory against ``slot_bytes``, the device
   busy share of a 3-way step, and the device time of the plain n-way
   sample stage beside the 2-way kernel sampler's;
9. the fleet: (a) an ``AsyncJoinFrontDoor(replicas=2)`` on the card serves
   phase 6's small class (16 tenants x 4 requests, interleaved) and phase
   8's plan once; every result must equal the port's sync path bit for bit
   (each query id through a sequential driver with its own SigmaRegistry),
   and it prints q/s, the steals, queue and e2e p50/p95 and the fleet's
   peak device memory.  (b) The fault drill: two ``StreamJoinServer``
   replicas checkpointing into a temporary directory, one session of
   tumbling windows of 4 micro-batches over the phase-4 pair cut into 16
   micro-batches of 2^20 rows a side; replica0 is killed once 2 windows
   have resolved and 2 more micro-batches are in (its newest checkpoint,
   which holds every push, then carries 2 live sub-windows), and the
   successor restores it.  Windows 2-3 must equal an uninterrupted run
   bit for bit, with no window shed, one failover and equal sigma tables.
   Prints the checkpoints written, their bytes, the capture time under the
   engine lock and the restore time;
10. the mesh (``core/distributed.py``, ``JoinServer(mesh=...)``): (a) mesh 1
   over NCCL in this process, (b) 2 and 4 spawned ranks, over NCCL with a
   card a rank where there are that many cards, else sharing the one card
   over gloo, which carries their tensors through host memory (NCCL
   refuses two ranks on one card; what it says is printed).  On each mesh,
   ``distributed_approx_join`` on the phase-4 pair: exact and sampled SUM
   (``QueryBudget(error=0.01)``) under the gather merge equal to
   ``approx_join`` bit for bit, under psum within rtol 1e-5; each rank's
   shuffled bytes equal what the data routes off it; the same exact SUM
   without the filter stage must shuffle more tuple bytes (the ratio
   printed) and with buckets of ``MESH_SMALL_CAP`` rows must count its
   drops.  A ``JoinServer(mesh=k)`` serves phase 6's large class as mesh
   classes (exact-parity, and at k > 1 psum) and as kernel classes:
   exact-parity and kernel results equal a meshless server's bit for bit,
   psum within rtol 1e-5 with nothing dropped; the kernel classes' gather
   to rank 0 is metered (0 at mesh 1), their filters (the OR of the ranks'
   partition builds through the build kernel) equal a plain build over the
   whole relation, each pass's shuffled bytes by rank equal the data's and
   stay within the wire model.  The build kernel at each mesh's partition
   shape equals its plain version on every rank and is timed.  Prints
   each join's and serving pass's time with each collective's calls,
   bytes and time (the gloo times are host staging on one card, not an
   interconnect's);
11. the rest of the mesh: (a) streaming at phase 7's shape (micro-batches
   of 2^20 rows a side of the phase-4 pair, windows of 8 sliding by one,
   16 ticks: 9 windows a session) through three sessions of one
   ``StreamJoinServer(mesh=...)``: K on the kernel route (its sub-window
   filters built by the build kernel on every rank and OR-merged, its
   windows served on rank 0), E as mesh classes in exact-parity, P under
   psum; on mesh 1 over NCCL in this process and on 2 spawned ranks (NCCL
   a card a rank where there are 2 cards, else gloo sharing the one card).
   K and E must equal a meshless ``StreamJoinServer``'s windows bit for
   bit (surfaces, draws, words), P within rtol 1e-5 of E's with its
   buckets planned from the rolling overlap; rank 0's scatter bytes as
   reckoned (each sub-window once for its build, each plain window once,
   the session's model); once drained, every rank holds the words of the
   live sub-windows and nothing else; windows/s is the steady rate, after
   the tick of the first windows.  On the 2 ranks also (b) phase 8's
   plan over 3 relations of 2^24 rows as mesh classes twice,
   then on the kernel route, every node equal to a meshless server's, the
   byte model equal, one compile; (c) phase 6's small class on a sync mesh
   server, its snapshot with 2 rounds queued restored into a meshless
   server (the same results), the workload through a front door of two
   mesh servers over the same ranks (the same results), and phase 9 (b)'s
   drill as mesh classes over 16 micro-batches, replica0 killed after its
   second window and 2 pushes: 1 failover onto the mesh, 0 shed, every
   window equal to the uninterrupted mesh run.  Every kernel must launch
   in the phase's mesh runs.  Every kernel call of the phase (the
   meshless references', mesh 1's and each rank's) keeps its operands at
   each new shape, and after the path each is held against its plain
   version on them on the process that made it, bit for bit;
12. the model stack (``repro_torch.models``; no kernel of the port): (a)
   ``qwen3-1.7b`` at full width and depth, its float32 weights made on the
   card from a seeded ``torch.Generator``: a forward of [2, 4096] tokens
   (the chunked attention), timed warm, with its peak memory; 8 sequences
   decoded for 128 steps from an empty cache of 4,096 positions, every
   step's logits within 0.08 of the scale of a forward's over the same
   tokens (the reference's own bound, ``tests/test_models.py``) in float32
   (the bf16 figure printed), timed in bf16 with its peak against the
   weights' and the cache's bytes and the device busy share of 16 profiled
   steps; (b) the other nine configs at full width, their depth cut to two
   pattern periods (one for a pattern of three; whisper whole, 12 + 12
   layers over 1,500 frames), a forward of [2, 512] (phi-3-vision with its
   576 image tokens) and 32 decode steps held the same way in float32 and
   in bf16 (an MoE's bf16 figure printed: a rounding step can flip a top-k
   choice); (c) every config's ``reduced()`` form, weights made on the CPU
   and carried to the card through the JAX package's pytree layout
   (``params_to_jax`` / ``params_from_jax``), forward and decode on the
   card against the CPU in float32 (within 1e-4 of the scale, 1e-3 for the
   scans) and in bf16 (mean within 2e-2, largest 0.08; not the MoE); (d)
   the three join examples (``examples/torch_*.py``), each a process on
   the card, each exiting 0 with its own check;
13. training (``repro_torch.runtime.train``; no kernel of the port): (a)
   ``qwen3-1.7b`` whole, 8 AdamW steps on structured ``lm_batch`` of
   [2, 4096] under block remat: step times, tokens/s of the warm steps,
   the AdamW update alone (CUDA events) against its least traffic, the
   peak against params + grads + m + v, a profiled step's busy share and
   top device ops; every loss finite, the last 3 below the first 3; (b)
   the other nine configs at phase 12's cut depths, 2 steps of [2, 512],
   every loss and grad norm finite, ``recurrentgemma-2b`` a nonzero grad
   on every leaf; (c) one ``reduced()`` config a family on the card
   against the CPU from the same weights in float32: the loss within rtol
   1e-5, every grad within 1e-4 of its leaf's scale; (d) 2 gloo ranks
   sharing the card, ``qwen2-0.5b`` at full width cut to 2 layers: plain
   DP against one process on the whole batch (rtol 5e-3, atol 5e-4),
   int8-EF DP lowering the loss with live residuals, and each mode's
   all_reduce bytes (float16 half of float32); (e) the train launcher
   killed (``--kill-after 6``) and rerun: "resumed from step 6", its
   step-12 checkpoint against an uninterrupted run's (bit for bit, or
   within 1e-5 of the scale); (f) ``examples/torch_train_lm.py`` (~100M
   parameters, 300 steps) exiting 0 on the card with its check;
14. tensor and expert parallelism (``sharding.specs``; no kernel of the
   port), the model ranks sharing the card over gloo: (a)
   ``qwen2-moe-a2.7b`` at full width cut to 2 layers, a forward of
   [2, 1024] at tp 2 (block-EP) and tp 8 (ffe-TP), ``moe_impl`` "ep" and
   "gspmd": float32 logits within 1e-4 of the scale of one process's on
   the card, the overflow equal (bf16 printed), each rank's all_reduce
   calls and bytes equal to the model's; its time and a rank's peak
   printed; (b) 2 train steps at tp 2: loss and grad norm within rtol
   1e-4 of one process's; (c) the train launcher at dp 2 x tp 2 with
   checkpoints, resumed at dp 1 x tp 1: its last loss and the next loss
   under its step-4 checkpoint within rtol 5e-3, atol 5e-4 of an
   uninterrupted run's; (d) 2 data ranks of a reduced MoE at a global
   N * K over 4096: the overflow equal to one process's, nonzero;
15. tensor parallelism of the Mamba and RG-LRU mixers and of whisper, and
   decode of a sharded model on a ``kv_seq``-sharded cache (no kernel of
   the port), the model ranks sharing the card over gloo: (a)
   ``falcon-mamba-7b`` cut to 2 layers, ``recurrentgemma-2b`` to one
   pattern period and ``whisper-small`` whole (1,500 frames), at full
   width, a float32 forward of [2, 512] at tp 2 and 8 (the RG-LRU's
   channels whole blocks at 2, straddling them at 8): logits within 1e-4
   of the scale of one process's (1e-3 on a scan), each rank's collective
   calls and bytes equal to the model's (``scan_forward_comm``); (b) 2
   train steps of each at tp 2: loss and grad norm within rtol 1e-4; (c)
   sharded decode, 16 steps in float32 against one process (the same
   bounds), each rank's collectives equal to the model's
   (``scan_decode_comm``) and its cut leaves' bytes the whole's over tp:
   ``qwen3-1.7b`` at full width cut to 2 layers, 8 sequences on a cache of
   32,768 positions filled from the seeded generator to 32,704 and cut by
   ``shard_cache``, and the three configs of (a) from an empty cache of 64
   positions (2 sequences).
16. the dry-run family (``launch/roofline.py``, ``dryrun_join.py``,
   ``dryrun.py``), each a child process playing rank 0 of a fake process
   group: (a) the join at (16, 16) over 2^26 rows (2^18 a rank) on the card
   and on the CPU, whose censuses must be equal call for call and byte for
   byte, every kernel launching on the card; (b) model cells on ``meta``
   tensors, each ``ok``: ``qwen3-1.7b`` ``train_4k``, ``prefill_32k`` and
   ``decode_32k``, ``qwen2-moe-a2.7b`` ``train_4k``, ``qwen2-0.5b`` and
   ``whisper-small`` ``train_4k`` under their ``seq`` rule, and
   ``qwen3-1.7b`` ``decode_32k`` at (2, 16, 16); (c) ``qwen3-1.7b`` at full
   width cut to 2 layers, a [2, 4096] forward and a train step at mesh 1,
   on ``meta`` and for real on the card: the counted flops equal, the
   ``meta`` peak within 0.75-1.33 x the card allocator's growth, and the
   floor max(compute, memory) on the H100's datasheet rates at most the
   measured time; the join at mesh 1 over 2^24 rows a relation (phase 4's
   size) likewise, each record's floor at most its measured time.  Prints
   each cell's terms and measured / floor.

It then prints one line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX.  Run from a checkout of another commit (the
script copied into it), it times that commit's kernels the same way.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
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
# edge_sample's sampler (csrc/edge_sample.cu): warps a block (kWarps), and
# the draws a warp takes at once (kWarpDraws), above which a stratum takes
# a block
SAMPLER_WARPS = 4
WARP_DRAWS = 256
REPS = 20
PLAIN_REPS = 10
MIXED_SEEDS = (0, 1, 0x9E3779B1, 0xFFFFFFFF)
# phase 6: the JoinServer's width, and its small class: 16 tenants, each a
# pair of 2^16 rows over 2^12 keys, 4 requests each
SERVE_SLOTS = 8
SMALL_ROWS = 1 << 16
SMALL_KEYS = 1 << 12
SMALL_STRATA = 1 << 13
SMALL_TENANTS = 16
SMALL_ROUNDS = 4
# a large step's measured peak device memory over slot_bytes x its slots:
# what join_serve.SLOT_MEMORY_SHARE leaves room for
PEAK_MARGIN = 1.5
# phase 7: a StreamJoinServer of 4 slots, 8 queued windows a session;
# windows of 8 sub-windows of 2^20 rows a side, 16 ticks (the phase-4 pair
# cut into micro-batches)
STREAM_SLOTS = 4
STREAM_WINDOW_SLOTS = 8
STREAM_SIZE = 8
STREAM_TICKS = 16
STREAM_SUB_ROWS = ROWS // STREAM_TICKS
# (stream, slide) of each session, in push order: A and B slide by one
# sub-window over streams A and B, C tumbles over stream A
STREAM_SESSIONS = {"A": ("A", 1), "B": ("B", 1), "C": ("A", STREAM_SIZE)}
# Reckoned from the streaming rules for these sessions:
#   windows: a sliding session emits one a tick from tick 7 on (9), the
#     tumbling one at ticks 7 and 15 (2);
#   builds: one per (micro-batch, input, stream), 16 x 2 x 2 = 64, since A
#     and C share fingerprints, num_blocks and filter seed, and a retire
#     never drops words a later window needs;
#   cache hits: every window asks for 8 sub-windows x 2 inputs, 20 x 16 =
#     320 asks, of which 64 build: 256;
#   retired entries: B retires its expired sub-window at each of its 9
#     windows (18); A's at ticks 8-14 (14), but not at tick 7 or 15, when
#     C still holds that sub-window live; C's tumbles at ticks 7 and 15 each
#     retire the one sub-window A no longer holds (4): 36.
STREAM_WINDOWS = {"A": 9, "B": 9, "C": 2}
STREAM_BUILDS = 64
STREAM_CACHE_HITS = 256
STREAM_RETIRED = 36
# phase 8: the plan's node budgets (both nodes the operator's SUM)
PLAN_NODES = (("ab", ("A", "B")), ("abc", ("ab", "C")))
PLAN_LEAVES = {"ab": "AB", "abc": "ABC"}
# phase 9 (b): tumbling windows of 4 micro-batches, a checkpoint at most
# every half second (each holds the live sub-windows, the queued windows
# and the cached words, up to a few hundred MB at this width)
DRILL_SIZE = 4
DRILL_KILL_WINDOWS = 2
DRILL_MID_PUSHES = 2      # pushed into window 2 before the kill
DRILL_CHECKPOINT_EVERY_S = 0.5
# line of pl.pallas_call in each TPU kernel, src/repro/kernels/<name>.py
REPLACES = {"bloom_build": 53, "bloom_probe": 67, "edge_sample": 94}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def entry_name(mangled: str) -> str:
    """A kernel's own name from its C++-mangled one
    (``_ZN12_GLOBAL__N_113plan_kernelE...`` -> ``plan_kernel``)."""
    if not mangled.startswith("_Z"):
        return mangled
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    return name


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


def kernel_ms(fn, reps: int = REPS, inner: int = 10):
    """(device ms of one call of ``fn``, ms of one call as ``time_ms`` sees
    it).  The first is the median over ``reps`` of ``inner`` back-to-back
    replays of a CUDA graph of ``fn`` between two events: the device's time,
    gaps between the call's launches included, without the host's time to
    issue them.  The second times one call from the host, the wrapper's
    Python included when the device waits for it."""
    import torch
    call = time_ms(fn, reps)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    return statistics.median(times), call


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
#   edge_sample, per draw: counter_hash(seed, key, t, side) is three
#     fmix32 rounds, but x -> x ^ (x >> 16) is its own inverse, so the last
#     step of one round and the first of the next, around the xor with the
#     key's or the seed's term, make one xor with a per-stratum constant
#     (csrc/edge_sample.cu finish_hash).  Per side: that xor, a round's
#     middle (multiply, shift, xor, multiply), the xor with the seed's
#     constant, a round's middle, the last shift and xor: 8 alu, 4 fma; % by
#     the segment's count (multiply-high by the stratum's magic number,
#     multiply-add, add, min): 1 alu, 3 fma; per draw the counter's add and
#     compare: 1 fma, 1 alu;
#   edge_sample, once per (draw counter t < b_max, side) of a launch
#     (INT_OPS_PER_LAUNCH): t * GOLDEN + side and the first round up to its
#     last step, which depend on neither the stratum nor the seed: 4 alu,
#     4 fma.
INT_OPS = {"bloom_build": dict(alu=39, fma=13),
           "bloom_probe": dict(alu=39, fma=13),
           "edge_sample": dict(alu=19, fma=15)}
INT_OPS_PER_LAUNCH = {"edge_sample": dict(alu=4, fma=4)}


def bound(rates, nbytes: float, flops: float = 0.0, float_instr: float = 0.0,
          alu: float = 0.0, fma: float = 0.0):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate, the float operations over the float32 rate,
    each integer pipe's operations over its rate, and all instructions (the
    integer operations and ``float_instr`` float ones, an FFMA being two
    flops in one) over the dispatch rate."""
    pipe, dispatch = rates
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS, alu / pipe, fma / pipe,
                (alu + fma + float_instr) / dispatch) * 1e3
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


def edge_sample_case(label, rels, torch, line, whole_rounds=False):
    """edge_sample on the strata of ``rels`` and the pilot sizes of
    QueryBudget(error=0.01), as the sampled SUM's first request gives them:
    n exact and the sums within tolerance of the plain version, a B = 4
    batch with mixed seeds equal to four B = 1 calls, timed beside its
    bound.  Prints the sampler's grid and the strata each of its blocks and
    warps takes; with ``whole_rounds`` (every drawing stratum taking a
    block) also times the call cut to whole rounds of the grid, to show what
    the last, partly empty round costs.  Returns (its kernels-line entry,
    its draws)."""
    from repro_torch.kernels import traffic
    from repro_torch.core import bloom
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.join import (decide_sample_sizes,
                                       prepare_stage_kernels)
    from repro_torch.kernels import _build
    from repro_torch.kernels import edge_sample as ke

    dev = rels[0].keys.device
    nb = bloom.num_blocks_for(ROWS, 0.01)
    prep = prepare_stage_kernels(rels, nb, MAX_STRATA, SEED)
    st = prep.strata
    b_i = decide_sample_sizes(QueryBudget(error=0.01), st, None, 0.0, None,
                              0.95)
    v1, v2 = (r.values[None] for r in prep.sorted_rels)
    ops = [x[None].contiguous() for x in (st.keys, st.starts[0], st.counts[0],
                                          st.starts[1], st.counts[1],
                                          st.joinable, b_i)]
    seed_s = torch.tensor([SEED + 1], device=dev)
    seeds4 = torch.tensor(MIXED_SEEDS, device=dev)
    out_k = ke.edge_sample_batched(v1, v2, *ops, seed_s, B_MAX)
    out_p = ke.edge_sample_ref(v1, v2, *ops, B_MAX, seed_s)
    check(torch.equal(out_k[0], out_p[0]),
          f"edge_sample {label}: n_sampled != plain")
    for got, want, what in zip(out_k[1:], out_p[1:], ("sum_f", "sum_f2")):
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
              f"edge_sample {label}: {what} != plain")
    again = ke.edge_sample_batched(v1, v2, *ops, seed_s, B_MAX)
    check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
          f"edge_sample {label}: two launches differ")
    draws = float(out_k[0].sum())
    check(draws > 0, f"edge_sample {label}: drew nothing")
    rep4 = lambda x: x.expand(4, -1).contiguous()  # noqa: E731
    out4 = ke.edge_sample_batched(rep4(v1), rep4(v2), *map(rep4, ops),
                                  seeds4, B_MAX)
    for b in range(4):
        one = ke.edge_sample_batched(v1, v2, *ops, seeds4[b:b + 1], B_MAX)
        for got, want in zip(out4, one):
            check(torch.equal(got[b:b + 1], want),
                  f"edge_sample {label}: B=4 slot {b} != B=1 call")
    ms, call_ms = kernel_ms(
        lambda: ke.edge_sample_batched(v1, v2, *ops, seed_s, B_MAX))
    plain_ms = time_ms(lambda: ke.edge_sample_ref(v1, v2, *ops, B_MAX, seed_s),
                       PLAIN_REPS)
    # the same call with no stratum joinable: what a launch costs before
    # and beside its draws
    idle = [*ops[:5], torch.zeros_like(ops[5]), ops[6]]
    idle_ms, _ = kernel_ms(
        lambda: ke.edge_sample_batched(v1, v2, *idle, seed_s, B_MAX))
    # bytes: each stratum's operands and results, and per side the values a
    # joinable stratum's draws need, min(draws, count) of them
    join = st.joinable
    n_i = out_k[0][0]
    gathered = traffic.edge_sample_gathered(n_i, st.counts, join)
    nbytes = traffic.edge_sample_bytes(1, st.keys.shape[0], gathered)
    err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
    # float work a draw: f (an add or a multiply), sum += f and sum2 += f * f
    # (one FFMA): 4 flops in 3 instructions
    ln = line("edge_sample", err, ms, call_ms, plain_ms, nbytes, draws,
              flops=4 * draws, float_instr=3 * draws, per_launch=2 * B_MAX)
    d = n_i[join]
    print(f"edge_sample {label}: {int(join.sum())} joinable strata, draws "
          f"{draws:.0f}, per joinable stratum min {float(d.min()):.0f} median "
          f"{float(d.median()):.0f} max {float(d.max()):.0f}, "
          f"{int((d == B_MAX).sum())} draw b_max; values read "
          f"{gathered / 1e6:.3f} MB; {idle_ms:.4f} ms on the device with "
          f"no stratum joinable")
    # the sampler's persistent grid: a stratum of more draws than a warp
    # takes at once goes to a block, the others to a warp, in turn (an
    # older kernel without a persistent sampler exports no grid)
    if not hasattr(_build.load("edge_sample"), "edge_sample_grid_blocks"):
        return ln, draws
    blocks = _build.function("edge_sample", "edge_sample_grid_blocks", "",
                             ctypes.c_int64)()
    warps = blocks * SAMPLER_WARPS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    by_block = int((n_i > WARP_DRAWS).sum())
    by_warp = int(((n_i > 0) & (n_i <= WARP_DRAWS)).sum())
    print(f"edge_sample {label}: sampler grid {blocks} blocks ({blocks / sms:g} "
          f"an SM) of {SAMPLER_WARPS} warps; {by_block} strata a block "
          f"(mean {by_block / blocks:.2f}, most {-(-by_block // blocks)} a "
          f"block), {by_warp} strata a warp (mean {by_warp / warps:.2f}, most "
          f"{-(-by_warp // warps)} a warp)")
    if whole_rounds:
        check(by_warp == 0 and by_block >= blocks,
              f"edge_sample {label}: not every drawing stratum takes a block")
        kept = by_block // blocks * blocks
        cut = ops[5].clone()
        cut[0, torch.nonzero(cut[0])[kept:, 0]] = False
        cut_ops = [*ops[:5], cut, ops[6]]
        cut_ms, _ = kernel_ms(
            lambda: ke.edge_sample_batched(v1, v2, *cut_ops, seed_s, B_MAX))
        balanced = idle_ms + (cut_ms - idle_ms) * by_block / kept
        print(f"edge_sample {label}: cut to {kept} strata ({kept // blocks} "
              f"whole rounds) {cut_ms:.4f} ms on the device; {by_block} "
              f"strata spread evenly would take {balanced:.4f} ms, so the "
              f"last round's tail costs {ms - balanced:.4f} ms of the "
              f"{ms - 2 * ln['bound_ms']:.4f} ms between this call and twice "
              f"its bound")
    return ln, draws


def kernel_phase(rels, torch, rates):
    """Phase 3: each kernel against its plain version at main-path shapes,
    timed beside its bound (``rates``: the integer pipe and dispatch rates)."""
    from repro_torch.kernels import traffic
    from repro_torch.core import bloom
    from repro_torch.core.hashing import fmix32
    from repro_torch.data.synthetic import skewed_relation
    from repro_torch.kernels import bloom_build as kb
    from repro_torch.kernels import bloom_probe as kp

    dev = rels[0].keys.device
    nb = bloom.num_blocks_for(ROWS, 0.01)
    seed1 = torch.tensor([SEED], device=dev)
    seeds4 = torch.tensor(MIXED_SEEDS, device=dev)
    keys = [r.keys[None] for r in rels]
    valid = [r.valid[None] for r in rels]
    lines = []

    def int_ops(name, items, per_launch=0):
        once = INT_OPS_PER_LAUNCH.get(name, {})
        return {pipe: items * n + per_launch * once.get(pipe, 0)
                for pipe, n in INT_OPS[name].items()}

    def line(name, err, ms, call_ms, plain_ms, nbytes, items, flops=0.0,
             float_instr=0.0, per_launch=0):
        ops = int_ops(name, items, per_launch)
        b_ms, b_by = bound(rates, nbytes, flops, float_instr, **ops)
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/csrc/{name}.cu",
                    replaces=f"src/repro/kernels/{name}.py:{REPLACES[name]}",
                    max_abs_err=err, ms=ms, call_ms=call_ms,
                    plain_ms=plain_ms, bound_ms=b_ms,
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
    ms, call_ms = kernel_ms(
        lambda: kb.bloom_build_batched(keys[0], valid[0], nb, seed1))
    plain_ms = time_ms(
        lambda: kb.bloom_build_ref(keys[0], valid[0], nb, seed1), PLAIN_REPS)
    n_valid = float(valid[0].sum())
    lines.append(line("bloom_build",
                      float((words_k[0].long() - words_p.long()).abs().max()),
                      ms, call_ms, plain_ms,
                      traffic.bloom_build_bytes(1, ROWS, nb), n_valid))
    # the worst case for committing only missing bits: 2^24 distinct keys
    # (fmix32 is a bijection), every one of which must commit
    dkeys = fmix32(torch.arange(ROWS, device=dev))[None]
    dvalid = torch.ones_like(dkeys, dtype=torch.bool)
    check(torch.equal(kb.bloom_build_batched(dkeys, dvalid, nb, seed1),
                      kb.bloom_build_ref(dkeys, dvalid, nb, seed1)),
          "bloom_build words != plain on distinct keys")
    d_ms, _ = kernel_ms(
        lambda: kb.bloom_build_batched(dkeys, dvalid, nb, seed1))
    d_bound, d_by = bound(rates, traffic.bloom_build_bytes(1, ROWS, nb),
                          **int_ops("bloom_build", ROWS))
    extra = [f"kernel bloom_build on {ROWS} distinct keys: {d_ms:.4f} ms "
             f"(bound {d_bound:.4f} ms by {d_by})"]

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
    ms, call_ms = kernel_ms(
        lambda: kp.bloom_probe_batched(jwords, keys[0], seed1))
    plain_ms = time_ms(lambda: kp.bloom_probe_ref(jwords, keys[0], seed1),
                       PLAIN_REPS)
    lines.append(line("bloom_probe",
                      float((mask_k.int() - mask_p.int()).abs().max()),
                      ms, call_ms, plain_ms,
                      traffic.bloom_probe_bytes(1, ROWS, nb), ROWS))

    # --- edge_sample: the sampled SUM's first (pilot) request ----------
    # on the main path's strata (uniform: every joinable stratum draws
    # b_max) and on two Zipf-skewed relations; the line is the uniform one
    uniform, draws = edge_sample_case("uniform", rels, torch, line,
                                      whole_rounds=True)
    lines.append(uniform)
    skewed_rels = [skewed_relation(ROWS, KEYS_PER_DATASET, zipf_a=1.5, lam=10,
                                   seed=s, device=dev) for s in (1, 2)]
    skewed, _ = edge_sample_case("skewed", skewed_rels, torch, line)
    del skewed_rels
    extra.append(
        f"kernel edge_sample on skewed strata: {skewed['ms']:.4f} ms on the "
        f"device, {skewed['call_ms']:.4f} ms a call from the host (bound "
        f"{skewed['bound_ms']:.4f} ms by {skewed['bound_by']}, "
        f"{100 * skewed['share_of_bound']:.1f}% of it), plain "
        f"{skewed['plain_ms']:.4f} ms, max_abs_err {skewed['max_abs_err']}")
    for ln in lines:
        print(f"kernel {ln['name']}: {ln['ms']:.4f} ms on the device, "
              f"{ln['call_ms']:.4f} ms a call from the host (bound "
              f"{ln['bound_ms']:.4f} ms by {ln['bound_by']}, "
              f"{100 * ln['share_of_bound']:.1f}% of it; "
              f"{ln['bound_ops']:.4g} int ops), plain {ln['plain_ms']:.4f} "
              f"ms, max_abs_err {ln['max_abs_err']}")
    for msg in extra:
        print(msg)
    print(f"kernel shapes: rows {ROWS}, num_blocks {nb}, strata "
          f"{MAX_STRATA}, b_max {B_MAX}, draws {draws:.0f}")
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


def device_profile(torch, run):
    """(wall microseconds of one ``run()``, {device op name: (microseconds,
    count)}) from torch.profiler's device trace; ``run`` must end in a
    synchronize.  The dict is empty when the profiler saw no device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    return wall_us, by_name


def profile_phase(rels, torch):
    """Phase 5: where the time of one warm sampled SUM request goes, from
    torch.profiler's device trace: kernel time by name and the share of the
    request's wall time the device was busy."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.join import approx_join

    def run():
        res = approx_join(rels, QueryBudget(error=0.01), seed=SEED,
                          max_strata=MAX_STRATA, b_max=B_MAX,
                          use_kernels=True)
        float(res.estimate)
        torch.cuda.synchronize()

    run()
    wall_us, by_name = device_profile(torch, run)
    busy = sum(us for us, _ in by_name.values())
    if not by_name:
        print("profile: the profiler recorded no device time (not measured)")
        return
    print(f"profile: request wall {wall_us / 1e3:.3f} ms under the profiler, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
          f"{sum(n for _, n in by_name.values())} device events")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / 1e3:9.4f} ms {n:4d}x  {name[:90]}")


class Serving:
    """Phase 6's server and the record of every step it serves: each step's
    launches of the three kernels, checked against one launch of the probe
    per input (two more when the step warms a fresh prepare stage), at most
    one of the sampler, and one build per filter-cache miss; and each
    step's peak device memory above what was allocated before it."""

    def __init__(self, torch, wrappers):
        from repro_torch.runtime.join_serve import JoinServer
        self.torch, self.wrappers = torch, wrappers
        self.srv = JoinServer(batch_slots=SERVE_SLOTS)
        self.steps = []          # dicts: class, real, slots, ms, peak

    def counts(self):
        return {name: w.launches for name, w in self.wrappers.items()}

    def prepares(self):
        return sum(1 for key in self.srv._stage_keys if key[0] == "prepare")

    def submit(self, dataset, spec, **kw):
        """Submit (query id, budget, seed) triples on a registered dataset;
        returns the requests."""
        from repro_torch.runtime.join_serve import JoinRequest
        return [self.srv.submit(JoinRequest(
            dataset=dataset, budget=budget, query_id=qid, seed=seed,
            b_max=B_MAX, use_kernels=True, **kw)) for qid, budget, seed in spec]

    def step(self, label):
        """Serve one step, check its launches, record its time and peak."""
        from repro_torch.core.relation import bucket_capacity
        torch, srv = self.torch, self.srv
        before, fresh0 = self.counts(), self.prepares()
        builds0 = srv.diagnostics.filter_builds
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        n = srv.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = {k: v - before[k] for k, v in self.counts().items()}
        fresh = self.prepares() - fresh0
        check(d["bloom_probe"] == 2 * (1 + fresh),
              f"serve {label}: {d['bloom_probe']} probe launches in a step "
              f"({fresh} fresh prepare)")
        check(d["edge_sample"] <= 1,
              f"serve {label}: {d['edge_sample']} sampler launches in a step")
        check(d["bloom_build"] == srv.diagnostics.filter_builds - builds0,
              f"serve {label}: build launches {d['bloom_build']} != filter "
              f"builds")
        self.steps.append(dict(label=label, real=n,
                               slots=bucket_capacity(n), ms=ms, fresh=fresh,
                               peak=torch.cuda.max_memory_allocated() - base))
        return n

    def drain(self, label):
        t0 = time.perf_counter()
        while self.srv.queue:
            self.step(label)
        return time.perf_counter() - t0


def large_spec(tag=""):
    """The large class's 8 SUM requests in submission order: 3 query ids
    under an error budget, each twice (sigma pipelining defers the repeat a
    step), and 2 exact ones, with mixed seeds (0xFFFFFFFF among them)."""
    from repro_torch.core.budget import QueryBudget
    e, x = QueryBudget(error=0.01), QueryBudget()
    return [(f"L{tag}/a", e, 0), (f"L{tag}/b", e, 0xFFFFFFFF),
            (f"L{tag}/x0", x, 5), (f"L{tag}/c", e, 7), (f"L{tag}/a", e, 1),
            (f"L{tag}/b", e, 2), (f"L{tag}/x1", x, 0x9E3779B1),
            (f"L{tag}/c", e, 3)]


def four_spec(seeds):
    """Four large SUM requests of distinct query ids under the error
    budget: three with a sigma from the passes before, one without; the
    seeds are among the passes' own, so their filter words are cached."""
    from repro_torch.core.budget import QueryBudget
    e = QueryBudget(error=0.01)
    return [(f"L/{q}", e, s) for q, s in zip("abcd", seeds)]


def small_spec(rounds=range(SMALL_ROUNDS), tenants=range(SMALL_TENANTS)):
    """(dataset, (query id, budget, seed)) of the small class: each tenant's
    own query id under QueryBudget(error=0.05), the tenants interleaved."""
    from repro_torch.core.budget import QueryBudget
    return [(f"s{t}", (f"s{t}/sum", QueryBudget(error=0.05), 1000 * q + t))
            for q in rounds for t in tenants]


def check_served(label, reqs, rels, truth):
    """Every served request against the port's approx_join(use_kernels=True)
    on the same relations and seed, bit for bit: each query id's requests
    in order through one sequential driver with its own SigmaRegistry (the
    first is then a plain direct call).  Exact SUMs within rtol 1e-4 of the
    float64 oracle, sampled ones as ``served_ok`` says.  Returns (requests
    checked, the readings of the sampled ones of bound 0)."""
    from repro_torch.core.cost import SigmaRegistry
    from repro_torch.core.join import approx_join

    regs, zero = {}, []
    fields = ("estimate", "error_bound", "count", "dof")
    for q in reqs:
        reg = regs.setdefault(q.query_id, SigmaRegistry())
        d = approx_join(rels, q.budget, seed=q.seed, max_strata=q.max_strata,
                        b_max=q.b_max, use_kernels=True, query_id=q.query_id,
                        sigma_registry=reg)
        got = [float(getattr(q.result, f)) for f in fields]
        want = [float(getattr(d, f)) for f in fields]
        check(got == want, f"serve {label} {q.query_id} seed {q.seed}: "
                           f"served {got} != direct {want}")
        if q.budget.is_exact:
            est = got[0]
            check(abs(est - truth["sum"]) <= 1e-4 * abs(truth["sum"]),
                  f"serve {label} {q.query_id}: exact SUM {est} vs oracle "
                  f"{truth['sum']}")
        else:
            r = served_ok(f"{label} {q.query_id}", q.result, truth["sum"])
            zero += [r] if r else []
    return len(reqs), zero


def replacement_bound(stats, confidence: float = 0.95) -> float:
    """The expansion estimator's CLT bound without the finite-population
    term: what drawing b_i edges WITH replacement leaves, sum_i B_i^2 r_i^2
    / b_i under the normal quantile (float64, from a result's stats)."""
    import torch
    f64 = torch.float64
    b = stats.n_sampled.to(f64)
    ok = stats.valid & (b > 0)
    b = torch.clamp(b, min=1.0)
    r2 = torch.clamp((stats.sum_f2.to(f64) - stats.sum_f.to(f64) ** 2 / b)
                     / torch.clamp(b - 1.0, min=1.0), min=0.0)
    var = (stats.population.to(f64) ** 2 * r2 / b)[ok].sum()
    z = torch.special.ndtri(torch.tensor(0.5 + confidence / 2, dtype=f64))
    return float(z * torch.sqrt(var))


def served_ok(label, res, want):
    """A sampled estimate within 3 x its error bound.  The CLT bound's
    finite-population term is 0 where a stratum drew as many edges as it
    holds, though the draws are with replacement and the estimate keeps
    their error: a bound of 0 is allowed only where every joinable stratum
    drew its whole population, and the estimate is then held to 3 x the
    bound without that term (``replacement_bound``).  Returns None for a
    bound above 0, else (want, that bound, |est - want| over it)."""
    est, bnd = float(res.estimate), float(res.error_bound)
    if bnd == 0:
        st = res.stats
        full = bool((st.n_sampled >= st.population)[st.valid].all())
        wr = replacement_bound(st)
        check(full and abs(est - want) <= 3 * wr,
              f"serve {label}: bound 0 (every stratum drawn in full: {full})"
              f" and |{est} - {want}| > 3 x {wr}, the bound without the "
              f"finite-population term")
        return want, wr, abs(est - want) / wr
    check(bnd > 0 and abs(est - want) <= 3 * bnd,
          f"serve {label}: |{est} - {want}| > 3 x bound {bnd}")
    return None


def first_edge_sum(rels):
    """SUM(v1 + v2) as a sampler would answer it whose draws all land on
    each stratum's first edge (its index hash reduced to 0), where it draws
    every stratum in full: each key's first row on each side, times the
    stratum's edges (float64, on the host)."""
    from repro_torch.core.relation import to_numpy
    parts = []
    for r in rels:
        k, v = to_numpy(r)
        u, first, c = np.unique(k, return_index=True, return_counts=True)
        parts.append((u, c.astype(np.float64), v[first].astype(np.float64)))
    (u1, c1, f1), (u2, c2, f2) = parts
    _, i1, i2 = np.intersect1d(u1, u2, assume_unique=True,
                               return_indices=True)
    return float(np.sum(c1[i1] * c2[i2] * (f1[i1] + f2[i2])))


def small_shape_kernels(small, torch, rates):
    """The three kernels at the small class's served shape (8 slots of 2^16
    keys, a 4,096-block filter each, the strata of those slots): build,
    probe and sampler against their plain versions, as in phase 3; the
    probe timed beside its bound.  Returns the probe's timing."""
    from repro_torch.kernels import traffic
    from repro_torch.core import bloom
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.join import (_slot, decide_sample_sizes,
                                       prepare_stage_kernels_batched)
    from repro_torch.core.relation import Relation
    from repro_torch.kernels import bloom_build as kb
    from repro_torch.kernels import bloom_probe as kp
    from repro_torch.kernels import edge_sample as ke

    B = SERVE_SLOTS
    pairs = [small[f"s{t}"] for t in range(B)]
    sides = [Relation(*(torch.stack([p[i][f] for p in pairs])
                        for f in range(3))) for i in range(2)]
    nb = bloom.num_blocks_for(SMALL_ROWS, 0.01)
    seeds = torch.tensor([1000 * SMALL_ROUNDS + t for t in range(B)],
                         device=sides[0].keys.device)
    words = [kb.bloom_build_batched(r.keys, r.valid, nb, seeds)
             for r in sides]
    for w, r in zip(words, sides):
        check(torch.equal(w, kb.bloom_build_ref(r.keys, r.valid, nb, seeds)),
              "bloom_build at the small served shape != plain")
    jw, keys = words[0] & words[1], sides[0].keys
    check(torch.equal(kp.bloom_probe_batched(jw, keys, seeds),
                      kp.bloom_probe_ref(jw, keys, seeds)),
          "bloom_probe at the small served shape != plain")
    prep = prepare_stage_kernels_batched(sides, torch.stack(words, 1),
                                         SMALL_STRATA, seeds)
    st = prep.strata
    b_i = torch.stack([decide_sample_sizes(QueryBudget(error=0.05),
                                           _slot(st, b), None, 0.0, None,
                                           0.95) for b in range(B)])
    args = [prep.sorted_rels[0].values, prep.sorted_rels[1].values, st.keys,
            st.starts[:, 0].contiguous(), st.counts[:, 0].contiguous(),
            st.starts[:, 1].contiguous(), st.counts[:, 1].contiguous(),
            st.joinable.contiguous(), b_i]
    got = ke.edge_sample_batched(*args, seeds, B_MAX)
    want = ke.edge_sample_ref(*args, B_MAX, seeds)
    check(torch.equal(got[0], want[0]) and float(got[0].sum()) > 0,
          "edge_sample at the small served shape: n_sampled != plain")
    check(all(torch.allclose(g, w, rtol=1e-5, atol=1e-3)
              for g, w in zip(got[1:], want[1:])),
          "edge_sample at the small served shape: sums != plain")
    ms, call_ms = kernel_ms(lambda: kp.bloom_probe_batched(jw, keys, seeds))
    n_keys = B * SMALL_ROWS
    b_ms, b_by = bound(rates, traffic.bloom_probe_bytes(B, SMALL_ROWS, nb),
                       **{p: n_keys * v
                          for p, v in INT_OPS["bloom_probe"].items()})
    print(f"serve small shape: bloom_build, bloom_probe and edge_sample "
          f"({float(got[0].sum()):.0f} draws) match their plain versions")
    print(f"kernel bloom_probe at the small served shape ({B} slots x "
          f"{SMALL_ROWS} keys, {nb} blocks = {nb * 32 // 1024} KiB a filter):"
          f" {ms:.4f} ms on the device, {call_ms:.4f} ms a call from the "
          f"host (bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of "
          f"it)")
    return dict(slots=B, keys=SMALL_ROWS, num_blocks=nb, ms=ms,
                call_ms=call_ms, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / ms)


def serve_phase(rels, truth, torch, rates, wrappers):
    """Phase 6: a JoinServer(batch_slots=8) on the card serving a large
    class (the smoke's pair, 8 requests) and a small class (16 tenants, 64
    requests) through the three kernels.  Returns (each kernel's launches
    while it served, the probe's timing at the small served shape)."""
    from repro_torch.data.synthetic import overlapping_relations
    from repro_torch.runtime.join_serve import (NULL_TRACER, slot_bytes,
                                                slot_budget)
    from repro_torch.runtime.telemetry import (Tracer, chrome_trace,
                                               validate_chrome_trace)

    dev = rels[0].keys.device
    t0 = time.perf_counter()
    small = {f"s{t}": overlapping_relations(
        [SMALL_ROWS, SMALL_ROWS], 0.1, keys_per_dataset=SMALL_KEYS, lam=10,
        seed=t, device=dev) for t in range(SMALL_TENANTS)}
    small_truth = {name: oracle(r) for name, r in small.items()}
    sv = Serving(torch, wrappers)
    srv = sv.srv
    srv.register_dataset("large", rels)
    for name, r in small.items():
        srv.register_dataset(name, r)
    print(f"serve: {SMALL_TENANTS} small tenants of 2 x {SMALL_ROWS} rows "
          f"made and {1 + SMALL_TENANTS} datasets registered in "
          f"{time.perf_counter() - t0:.1f} s")
    small_kw = dict(max_strata=SMALL_STRATA)

    def submit_small(spec):
        return [r for ds, s in spec for r in sv.submit(ds, [s], **small_kw)]

    # -- the path: every count from 0 -----------------------------------
    for w in wrappers.values():
        w.launches = 0
    # pass 1: both classes, checked against direct calls below
    large1 = sv.submit("large", large_spec(), max_strata=MAX_STRATA)
    sv.drain("large/1")
    small1 = submit_small(small_spec())
    sv.drain("small/1")
    builds1 = sv.counts()["bloom_build"]
    check(builds1 == srv.diagnostics.filter_builds,
          f"serve: {builds1} build launches != {srv.diagnostics.filter_builds}"
          f" filter builds")
    # pass 2, timed: the same requests again, warm
    timed = {}
    for cls, submit in (
            ("large", lambda: sv.submit("large", large_spec(),
                                        max_strata=MAX_STRATA)),
            ("small", lambda: submit_small(small_spec()))):
        srv.diagnostics.reset_latencies()
        reqs = submit()
        dt = sv.drain(f"{cls}/2")
        zero = [r for q in reqs if not q.budget.is_exact
                for r in [served_ok(f"{cls}/2 {q.query_id}", q.result,
                                    (truth if cls == "large" else
                                     small_truth[q.dataset])["sum"])] if r]
        timed[cls] = (len(reqs), dt, srv.diagnostics.snapshot(), zero)
    check(sv.counts()["bloom_build"] == builds1,
          "serve: the second pass over the same datasets built filters")
    # one large request alone: a step of one slot
    sv.submit("large", [("L/one", large_spec()[0][1], 11)],
              max_strata=MAX_STRATA)
    sv.step("large/B=1")
    # a traced large step of 4 slots (3 ids with sigma), its host time split
    srv.tracer = Tracer(enabled=True)
    split = {}

    def synced(name):
        fn = getattr(srv, name)

        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            split[name] = split.get(name, 0.0) + time.perf_counter() - t
            return out
        setattr(srv, name, run)

    parts = ("_batch_inputs", "_decide_b_rows", "_finish_batch")
    for n in parts:
        synced(n)
    filter_s0 = srv.diagnostics.filter_s
    sv.submit("large", four_spec((0, 0xFFFFFFFF, 7, 5)), max_strata=MAX_STRATA)
    sv.step("large/traced")
    split["prepare"] = srv.diagnostics.filter_s - filter_s0
    for n in parts:
        delattr(srv, n)
    trace = chrome_trace(srv.tracer,
                         reconciliation=srv.reconciliation_report())
    n_events = validate_chrome_trace(trace)
    stage_ms = {e["name"]: e["dur"] * 1e3 for e in srv.tracer.events
                if e["tid"] == "engine" and e["cat"] in ("stage", "serve")}
    srv.tracer = NULL_TRACER
    # one large and one small step under the profiler
    profiles = {}
    for cls, submit in (
            ("large", lambda: sv.submit(
                "large", four_spec((1, 2, 3, 0x9E3779B1)),
                max_strata=MAX_STRATA)),
            ("small", lambda: submit_small(small_spec(
                rounds=[SMALL_ROUNDS], tenants=range(SERVE_SLOTS))))):
        reqs = submit()
        profiles[cls] = (len(reqs), device_profile(
            torch, lambda: sv.step(f"{cls}/profiled")))
    launches = sv.counts()
    for name, n in launches.items():
        check(n > 0, f"{name} never launched while serving")
    check(launches["bloom_build"] == srv.diagnostics.filter_builds,
          "serve: build launches != filter builds")
    d = srv.diagnostics
    by_cls = {}
    for s in sv.steps:
        by_cls.setdefault(s["label"].split("/")[0], []).append(s["real"])
    for cls, ns in sorted(by_cls.items()):
        check(max(ns) > 1, f"serve {cls}: no step served more than one slot")
    check(d.max_batch > 1, "serve: max_batch 1")
    # -- end of the path ------------------------------------------------

    n_checked, zero = check_served("large/1", large1, rels, truth)
    wrong = tried = 0
    for name, r in small.items():
        n, z = check_served("small/1", [q for q in small1 if q.dataset == name],
                            r, small_truth[name])
        n_checked, zero = n_checked + n, zero + z
        # the gate against a wrong answer: a sampler whose draws all hit
        # each stratum's first edge, held to the served result's own bound
        bad = first_edge_sum(r)
        wrong += sum(abs(bad - want) > 3 * wr for want, wr, _ in z)
        tried += len(z)
    print(f"serve: {n_checked} served results of the first pass equal the "
          f"port's approx_join(use_kernels=True) bit for bit; exact SUMs "
          f"within rtol 1e-4 of the oracle, sampled within 3 x their bound "
          f"({len(zero)} of bound 0, every stratum drawn in full, within 3 x"
          f" the bound without its finite-population term)")
    timed_zero = [z for t in timed.values() for z in t[3]]
    for when, z in (("first pass", zero), ("timed pass", timed_zero)):
        if z:
            print(f"serve {when}: bound-0 results' |est - want| / that "
                  f"bound: largest {max(x for *_, x in z):.4f}, median "
                  f"{statistics.median(x for *_, x in z):.4f}, over {len(z)};"
                  f" 3 x the bound is at most "
                  f"{3 * max(wr / w for w, wr, _ in z):.3e} of the SUM")
    if tried:
        print(f"serve: a sampler drawing only each stratum's first edge "
              f"would fail the bound-0 gate on {wrong} of {tried} small-class"
              f" first-pass results")
        check(2 * wrong > tried, f"serve: the bound-0 gate rejects the "
              f"first-edge sampler's answer on only {wrong} of {tried}")

    print(f"serve: launches while serving {launches}; steps {d.steps}, "
          f"max_batch {d.max_batch}, compiles {d.compiles}, cache_hits "
          f"{d.cache_hits}, filter_builds {d.filter_builds}, "
          f"filter_cache_hits {d.filter_cache_hits}, sigma_deferrals "
          f"{d.sigma_deferrals}, deadline_promotions "
          f"{d.deadline_promotions}")
    for s in sv.steps:
        print(f"  step {s['label']}: {s['real']} requests in {s['slots']} "
              f"slots, {s['ms']:.3f} ms{' (warms its stage)' * bool(s['fresh'])}"
              f", peak {s['peak'] / 2**30:.3f} GiB above the step's start")
    for cls, (n, dt, snap, zero) in timed.items():
        print(f"serve {cls}: {n} queries in {dt * 1e3:.3f} ms = "
              f"{n / dt:.2f} q/s (warm), {len(zero)} sampled with every "
              f"stratum drawn in full (bound 0); queue latency p50 "
              f"{snap['queue_latency_p50_s'] * 1e3:.3f} p95 "
              f"{snap['queue_latency_p95_s'] * 1e3:.3f} ms, e2e p50 "
              f"{snap['e2e_latency_p50_s'] * 1e3:.3f} p95 "
              f"{snap['e2e_latency_p95_s'] * 1e3:.3f} ms")
    # peak memory of a large step against the rule's slot_bytes x slots
    large_cls = large1[0]._class
    per_slot = slot_bytes(large_cls)
    print(f"serve large: slot_bytes {per_slot / 2**30:.4f} GiB, budget "
          f"{slot_budget(dev) / 2**30:.2f} GiB (cap "
          f"{srv._slot_cap(large_cls, dev)} slots of {SERVE_SLOTS})")
    for s in sv.steps:
        if s["label"].startswith("large"):
            ratio = s["peak"] / (s["slots"] * per_slot)
            print(f"  {s['label']}: peak {s['peak'] / 2**30:.3f} GiB = "
                  f"{ratio:.3f} x slot_bytes x {s['slots']}")
            check(ratio <= PEAK_MARGIN, f"serve {s['label']}: peak "
                  f"{ratio:.3f} x slot_bytes x B, beyond the margin of "
                  f"{PEAK_MARGIN} that SLOT_MEMORY_SHARE leaves room for")
    small_cls = small1[0]._class
    small_peak = max(s["peak"] / s["slots"] for s in sv.steps
                     if s["label"].startswith("small"))
    print(f"serve small: slot_bytes {slot_bytes(small_cls) / 2**20:.3f} MiB, "
          f"largest peak a slot {small_peak / 2**20:.3f} MiB")
    total = sum(split.values())
    stages = ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items())
    print(f"serve large/traced (4 requests, 3 with sigma): {n_events} trace "
          f"events valid; stages {stages}; host split (each part "
          f"synchronized): "
          + ", ".join(f"{k.strip('_')} {v * 1e3:.3f} ms"
                      for k, v in split.items())
          + f", {total * 1e3:.3f} ms in all")
    for cls, (n, (wall_us, by_name)) in profiles.items():
        if not by_name:
            print(f"serve {cls} profile: no device time recorded (not "
                  f"measured)")
            continue
        busy = sum(us for us, _ in by_name.values())
        print(f"serve {cls} profile: a step of {n} requests, wall "
              f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
              f"({100 * busy / wall_us:.1f}%); longest device ops:")
        for name, (us, k) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:5]:
            print(f"  {us / 1e3:9.4f} ms {k:4d}x  {name[:90]}")

    return launches, small_shape_kernels(small, torch, rates)


def stream_window_truth(pair, torch):
    """Per input of a stream: (its distinct valid keys, and per tick their
    row counts and value sums, float64 [STREAM_TICKS, K]) as host numpy
    arrays.  The rows are grouped on the card (``torch.unique`` and
    ``bincount``, none of the port's code); ``window_truth`` sums a
    window's ticks and joins the two inputs in numpy."""
    out = []
    for r in pair:
        keys, inv = torch.unique(r.keys, return_inverse=True)
        K = keys.shape[0]
        tick = torch.arange(r.capacity, device=r.keys.device) \
            // STREAM_SUB_ROWS
        cell = tick * K + inv
        w = r.valid.to(torch.float64)
        counts = torch.bincount(cell, weights=w,
                                minlength=STREAM_TICKS * K)
        sums = torch.bincount(cell, weights=w * r.values.to(torch.float64),
                              minlength=STREAM_TICKS * K)
        out.append((keys.cpu().numpy(),
                    counts.view(STREAM_TICKS, K).cpu().numpy(),
                    sums.view(STREAM_TICKS, K).cpu().numpy()))
    return out


def window_truth(tables, start, end):
    """The exact join aggregates (count, SUM(v1 + v2)) of the rows of ticks
    ``[start, end)`` of both inputs, in float64."""
    (u1, c1, s1), (u2, c2, s2) = tables
    _, i1, i2 = np.intersect1d(u1, u2, assume_unique=True,
                               return_indices=True)
    c1, s1 = c1[start:end, i1].sum(0), s1[start:end, i1].sum(0)
    c2, s2 = c2[start:end, i2].sum(0), s2[start:end, i2].sum(0)
    return dict(count=float(np.sum(c1 * c2)),
                sum=float(np.sum(s1 * c2 + s2 * c1)))


def stream_kernels(torch, rates, mbs, served, tick, sampled):
    """bloom_build at the sub-window shape (one micro-batch's 2^20 keys into
    the window's 2^19 blocks) and bloom_probe at a 4-slot step's (4 windows'
    2^23 keys against their 2^19-block join filters), each against its plain
    version and timed beside its bound; edge_sample on the operands that
    the step of tick ``tick`` gave it (``sampled``: 3 real windows in 4
    slots, the strata of 2^23-row windows, sigma-fed b_i, a seed a window),
    equal to its plain version bit for bit."""
    from repro_torch.kernels import traffic
    from repro_torch.core import bloom
    from repro_torch.kernels import bloom_build as kb
    from repro_torch.kernels import bloom_probe as kp
    from repro_torch.kernels import edge_sample as ke

    nb = bloom.num_blocks_for(STREAM_SIZE * STREAM_SUB_ROWS, 0.01)
    sub = mbs["A"][0][0]
    keys, valid = sub.keys[None], sub.valid[None]
    seed1 = torch.tensor([SEED], device=keys.device)
    got = kb.bloom_build_batched(keys, valid, nb, seed1)
    check(torch.equal(got, kb.bloom_build_ref(keys, valid, nb, seed1)),
          "stream: bloom_build at the sub-window shape != plain")
    ms, call_ms = kernel_ms(lambda: kb.bloom_build_batched(keys, valid, nb,
                                                           seed1))
    plain_ms = time_ms(lambda: kb.bloom_build_ref(keys, valid, nb, seed1),
                       PLAIN_REPS)
    n = STREAM_SUB_ROWS
    b_ms, b_by = bound(rates, traffic.bloom_build_bytes(1, n, nb),
                       **{p: float(valid.sum()) * v
                          for p, v in INT_OPS["bloom_build"].items()})
    build = dict(keys=n, num_blocks=nb, ms=ms, call_ms=call_ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 share_of_bound=b_ms / ms)

    reqs = [served[k][w] for k, w in (("A", 0), ("B", 0), ("C", 0),
                                      ("A", 1))]
    pkeys = torch.stack([r.rels[0].keys for r in reqs])
    jwords = torch.stack([r._words[0] & r._words[1] for r in reqs])
    seeds = torch.tensor([r.filter_seed for r in reqs], device=pkeys.device)
    mask = kp.bloom_probe_batched(jwords, pkeys, seeds)
    check(torch.equal(mask, kp.bloom_probe_ref(jwords, pkeys, seeds)),
          "stream: bloom_probe at the step's shape != plain")
    ms, call_ms = kernel_ms(lambda: kp.bloom_probe_batched(jwords, pkeys,
                                                           seeds))
    plain_ms = time_ms(lambda: kp.bloom_probe_ref(jwords, pkeys, seeds),
                       PLAIN_REPS)
    B, n = pkeys.shape
    b_ms, b_by = bound(rates, traffic.bloom_probe_bytes(B, n, nb),
                       **{p: B * n * v
                          for p, v in INT_OPS["bloom_probe"].items()})
    probe = dict(slots=B, keys=n, num_blocks=nb, ms=ms, call_ms=call_ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 share_of_bound=b_ms / ms)
    # the sampler: (values1, values2, keys, start1, count1, start2, count2,
    # joinable, b_i, seeds, b_max[, expr]) as the step passed them
    a, k = sampled
    *arrays, seeds, b_max = a[:11]
    expr = a[11] if len(a) > 11 else k.get("expr", "sum")
    got = ke.edge_sample_batched(*arrays, seeds, b_max, expr)
    want = ke.edge_sample_ref(*arrays, b_max, seeds, expr)
    for g, w, what in zip(got, want, ("n_sampled", "sum_f", "sum_f2")):
        check(torch.equal(g, w), f"stream: edge_sample on the step of tick "
                                 f"{tick}: {what} != plain")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    B, S = arrays[2].shape
    sampler = dict(tick=tick, slots=B, strata=S, rows=arrays[0].shape[1],
                   seeds=seeds.tolist(), draws=float(got[0].sum()),
                   max_abs_err=err)
    check(sampler["draws"] > 0, "stream: the traced step drew nothing")
    print(f"kernel edge_sample on the step of tick {tick} ({B} slots, seeds "
          f"{sampler['seeds']}, {S} strata over {sampler['rows']} rows a "
          f"side, {sampler['draws']:.0f} draws): n_sampled, sum_f and sum_f2 "
          f"equal its plain version bit for bit")
    for name, t, shape in (
            ("bloom_build", build, f"{build['keys']} keys into "
             f"{nb} blocks"),
            ("bloom_probe", probe, f"{B} slots x {n} keys against {nb}-block "
             f"filters")):
        print(f"kernel {name} at the stream's shape ({shape}): "
              f"{t['ms']:.4f} ms on the device, {t['call_ms']:.4f} ms a call "
              f"from the host (bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']}, {100 * t['share_of_bound']:.1f}% of it), "
              f"plain {t['plain_ms']:.4f} ms; matches its plain version")
    return build, probe, sampler


def sync_sites(torch, fn):
    """Where ``fn`` makes the host wait for the card: the file:line of each
    synchronizing call torch's sync debug mode reports (a prototype, which
    may miss some)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
            if "synchronizing" in str(w.message)]


def stream_phase(rels, truth, torch, rates, wrappers):
    """Phase 7: one StreamJoinServer(batch_slots=4, window_slots=8) on the
    card serving three streaming sessions over micro-batches of 2^20 rows a
    side through the three kernels, 16 ticks: A and B slide windows of 8
    sub-windows by one over the phase-4 pair and a second pair, C tumbles
    over the phase-4 pair.  Returns (each kernel's launches in the
    streaming pass, bloom_build's and bloom_probe's timings at the stream's
    shapes)."""
    from repro_torch.core import bloom
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.relation import Relation, bucket_capacity
    from repro_torch.core.sampling import reservoir_empty, reservoir_extend
    from repro_torch.core.window import WindowSpec
    from repro_torch.data.synthetic import overlapping_relations
    from repro_torch.kernels import bloom_build as kb
    from repro_torch.kernels import ops
    from repro_torch.runtime import stream_join
    from repro_torch.runtime.join_serve import (JoinRequest, JoinServer,
                                                slot_bytes)

    dev = rels[0].keys.device
    t0 = time.perf_counter()
    streams = {"A": rels, "B": overlapping_relations(
        [ROWS, ROWS], 0.1, keys_per_dataset=KEYS_PER_DATASET, lam=10,
        seed=SEED + 1, device=dev)}
    print(f"stream: pair B of 2 x {ROWS} rows made in "
          f"{time.perf_counter() - t0:.1f} s")
    mbs = {name: [[Relation(*(f[m * STREAM_SUB_ROWS:(m + 1) * STREAM_SUB_ROWS]
                              for f in r)) for r in pair]
                  for m in range(STREAM_TICKS)]
           for name, pair in streams.items()}
    budget = QueryBudget(error=0.01)
    srv = stream_join.StreamJoinServer(batch_slots=STREAM_SLOTS,
                                       window_slots=STREAM_WINDOW_SLOTS)
    sess = {name: srv.open_stream(
        name, WindowSpec(STREAM_SIZE, slide, STREAM_SUB_ROWS), budget=budget,
        max_strata=MAX_STRATA, b_max=B_MAX, seed=SEED, fp_rate=0.01,
        use_kernels=True) for name, (_, slide) in STREAM_SESSIONS.items()}

    # host time of the pushes by part (host clock around each part, no
    # synchronize added: a part that copies to the host waits there)
    split = {}

    def clocked(obj, attr, label):
        fn = getattr(obj, attr)

        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[label] = split.get(label, 0.0) + time.perf_counter() - t
        setattr(obj, attr, run)

    for s in sess.values():
        for attr, label in (("_admit", "admission with fingerprint"),
                            ("_fold_sketch", "sketch"),
                            ("_window_words", "words (new builds, OR)")):
            clocked(s, attr, label)
    clocked(srv, "_submit_window", "submit")
    patched = {name: getattr(stream_join, name)
               for name in ("fingerprint", "window_relations")}
    clocked(stream_join, "fingerprint", "of which fingerprint")
    clocked(stream_join, "window_relations", "window assembly")

    # the sampler's operands of the last step that serves 3 windows, as
    # the step hands them to the kernel's wrapper (checked after the pass)
    sampled = {}
    sample = ops.edge_sample_batched

    def keep_operands(*a, **k):
        sampled["last"] = (a, k)
        return sample(*a, **k)
    ops.edge_sample_batched = keep_operands

    def prepares():
        return sum(1 for key in srv._stage_keys if key[0] == "prepare")

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    # -- the path: every count from 0 -----------------------------------
    for w in wrappers.values():
        w.launches = 0
    served = {name: [] for name in sess}
    ticks = []
    for t in range(STREAM_TICKS):
        before, steps0, fresh0 = counts(), srv.diagnostics.steps, prepares()
        builds0 = srv.diagnostics.filter_builds
        torch.cuda.synchronize()
        tp = time.perf_counter()
        for name, (stream, _) in STREAM_SESSIONS.items():
            sess[name].push(mbs[stream][t])
        torch.cuda.synchronize()
        tr = time.perf_counter()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        srv.run()
        torch.cuda.synchronize()
        te = time.perf_counter()
        d = {k: v - before[k] for k, v in counts().items()}
        steps, fresh = srv.diagnostics.steps - steps0, prepares() - fresh0
        done = {name: s.drain() for name, s in sess.items()}
        for name, reqs in done.items():
            served[name] += reqs
        real = sum(map(len, done.values()))
        last = sampled.pop("last", None)
        if real == 3 and last is not None:
            sampled["step"] = (t, last)
        check(steps == (1 if real else 0) and real <= STREAM_SLOTS,
              f"stream tick {t}: {real} windows in {steps} steps")
        check(d["bloom_probe"] == 2 * (steps + fresh),
              f"stream tick {t}: {d['bloom_probe']} probe launches in "
              f"{steps} steps ({fresh} fresh prepare)")
        check(d["edge_sample"] <= steps,
              f"stream tick {t}: {d['edge_sample']} sampler launches")
        check(d["bloom_build"] == srv.diagnostics.filter_builds - builds0,
              f"stream tick {t}: build launches {d['bloom_build']} != "
              f"filter builds")
        ticks.append(dict(tick=t, real=real, slots=bucket_capacity(real),
                          push_ms=(tr - tp) * 1e3, run_ms=(te - tr) * 1e3,
                          fresh=fresh,
                          peak=torch.cuda.max_memory_allocated() - base))
    launches = counts()
    # -- end of the path ------------------------------------------------
    for name, fn in patched.items():
        setattr(stream_join, name, fn)
    ops.edge_sample_batched = sample
    pass_s = sum(x["push_ms"] + x["run_ms"] for x in ticks) / 1e3
    dg, ds = srv.diagnostics, srv.stream_diagnostics
    for name, n in STREAM_WINDOWS.items():
        got = [r.window_id for r in served[name]]
        check(got == list(range(n)), f"stream {name}: served windows {got}")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched while streaming")
    check(launches["bloom_build"] == dg.filter_builds == STREAM_BUILDS,
          f"stream: {launches['bloom_build']} build launches, "
          f"{dg.filter_builds} filter builds, reckoned {STREAM_BUILDS}")
    check(dg.filter_cache_hits == STREAM_CACHE_HITS,
          f"stream: {dg.filter_cache_hits} filter cache hits, reckoned "
          f"{STREAM_CACHE_HITS}")
    check(ds.retired_filter_words == STREAM_RETIRED,
          f"stream: {ds.retired_filter_words} retired word entries, "
          f"reckoned {STREAM_RETIRED}")
    n_windows = sum(STREAM_WINDOWS.values())
    check(ds.windows_served == n_windows and ds.windows_shed == 0,
          f"stream: {ds.windows_served} served, {ds.windows_shed} shed")
    check(launches["edge_sample"] == dg.steps,
          f"stream: {launches['edge_sample']} sampler launches in "
          f"{dg.steps} steps")

    # gate 1: each window equal bit for bit to its rows registered as a
    # dataset on a fresh server, queried in window order
    t0 = time.perf_counter()
    fields = ("estimate", "error_bound", "count", "dof")
    base_srv = JoinServer(batch_slots=1)

    def window_rows(name, w):
        stream, slide = STREAM_SESSIONS[name]
        lo = w * slide * STREAM_SUB_ROWS
        return [Relation(*(f[lo:lo + STREAM_SIZE * STREAM_SUB_ROWS]
                           for f in r)) for r in streams[stream]]

    for name, reqs in served.items():
        for r in reqs:
            w = r.window_id
            base_srv.register_dataset(f"{name}{w}", window_rows(name, w))
            q = base_srv.submit(JoinRequest(
                dataset=f"{name}{w}", budget=budget,
                query_id=sess[name].query_id, seed=SEED + 1 + w,
                filter_seed=sess[name].filter_seed, max_strata=MAX_STRATA,
                b_max=B_MAX, use_kernels=True))
            base_srv.run()
            got = [float(getattr(r.result, f)) for f in fields]
            want = [float(getattr(q.result, f)) for f in fields]
            check(got == want, f"stream {name} window {w}: served {got} != "
                               f"re-registered {want}")
    print(f"stream: {n_windows} windows equal their rows re-registered as "
          f"datasets bit for bit ({time.perf_counter() - t0:.1f} s)")

    # gate 2: each window's ORed words equal a fresh build over its rows
    nb = bloom.num_blocks_for(STREAM_SIZE * STREAM_SUB_ROWS, 0.01)
    for name, reqs in served.items():
        seed_t = torch.tensor([sess[name].filter_seed], device=dev)
        for r in reqs:
            for side, rel in enumerate(window_rows(name, r.window_id)):
                fresh = kb.bloom_build_batched(rel.keys[None],
                                               rel.valid[None], nb, seed_t)[0]
                check(torch.equal(r._words[side], fresh),
                      f"stream {name} window {r.window_id} input {side}: "
                      f"ORed words != a fresh build")
    a0, c0 = served["A"][0].result, served["C"][0].result
    check([float(getattr(a0, f)) for f in fields]
          == [float(getattr(c0, f)) for f in fields],
          "stream: A's and C's window 0 (same rows, same seeds) differ")
    print(f"stream: every window's ORed words equal a fresh build over its "
          f"rows; A's and C's window 0 are equal")

    # gate 5: each window against the float64 oracle of its rows
    t0 = time.perf_counter()
    tables = {name: stream_window_truth(pair, torch)
              for name, pair in streams.items()}
    want0 = window_truth(tables["A"], 0, STREAM_SIZE)
    full0 = oracle(window_rows("A", 0))
    check(want0["count"] == full0["count"] and want0["sum"] == full0["sum"],
          f"stream: the per-tick oracle of window A0 {want0} != the oracle "
          f"of its rows {full0}")
    readings, zero = [], []
    for name, reqs in served.items():
        stream, slide = STREAM_SESSIONS[name]
        for r in reqs:
            want = window_truth(tables[stream], r.window_id * slide,
                                r.window_id * slide + STREAM_SIZE)
            cnt = float(r.result.count)
            check(abs(cnt - want["count"]) <= 1e-6 * want["count"],
                  f"stream {name} window {r.window_id}: count {cnt} vs "
                  f"oracle {want['count']}")
            z = served_ok(f"stream {name} window {r.window_id}", r.result,
                          want["sum"])
            zero += [z] if z else []
            bnd = float(r.result.error_bound)
            if bnd > 0:
                readings.append(abs(float(r.result.estimate) - want["sum"])
                                / bnd)
    c_want = sum(window_truth(tables["A"], w * STREAM_SIZE,
                              (w + 1) * STREAM_SIZE)["sum"]
                 for w in range(STREAM_WINDOWS["C"]))
    run_c = sess["C"].running_estimate()
    est, bnd = float(run_c.estimate), float(run_c.error_bound)
    check(sess["C"].accumulated_windows == STREAM_WINDOWS["C"],
          f"stream C: {sess['C'].accumulated_windows} windows accumulated")
    check(bnd > 0 and abs(est - c_want) <= 3 * bnd,
          f"stream C: running estimate |{est} - {c_want}| > 3 x {bnd}")
    print(f"stream: every window within 3 x its bound of the float64 oracle "
          f"of its rows ({len(zero)} of bound 0, held to 3 x the bound "
          f"without the finite-population term); |est - want| / bound: "
          f"median {statistics.median(readings):.4f}, largest "
          f"{max(readings):.4f} over {len(readings)}; oracle "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"stream C: running estimate over its {STREAM_WINDOWS['C']} "
          f"tumbling windows {est!r} +- {bnd!r}, the windows' summed oracle "
          f"{c_want!r} ({abs(est - c_want) / bnd:.4f} x the bound); the "
          f"whole pair's join (phase 4's oracle, {truth['sum']!r}) also "
          f"counts the pairs across the two windows, "
          f"{truth['sum'] / c_want:.4f} x as much")

    # gate 6: the sketches on the card equal the same folds on the CPU
    t0 = time.perf_counter()
    for stream, pair in streams.items():
        cpu = [Relation(*(f.cpu() for f in r)) for r in pair]
        res = [reservoir_empty(sess["A"].sketch_strata, sess["A"].sketch_cap,
                               device="cpu") for _ in cpu]
        for t in range(STREAM_TICKS):
            lo, hi = t * STREAM_SUB_ROWS, (t + 1) * STREAM_SUB_ROWS
            res = [reservoir_extend(x, r.keys[lo:hi], r.values[lo:hi],
                                    r.valid[lo:hi], SEED, t)
                   for x, r in zip(res, cpu)]
        for name, (st, _) in STREAM_SESSIONS.items():
            if st != stream:
                continue
            for side in range(2):
                for f, got, want in zip(("priority", "values", "n_seen"),
                                        sess[name].sketch[side], res[side]):
                    check(torch.equal(got.cpu(), want),
                          f"stream {name} input {side}: sketch {f} on the "
                          f"card != the same folds on the CPU")
    print(f"stream: every session's sketch equals the same folds of CPU "
          f"copies bit for bit ({time.perf_counter() - t0:.1f} s)")

    # gate 7: each step's peak device memory against slot_bytes x slots
    cls = served["A"][0]._class
    per_slot = slot_bytes(cls)
    for x in ticks:
        if not x["real"]:
            continue
        x["ratio"] = x["peak"] / (x["slots"] * per_slot)
        check(x["ratio"] <= PEAK_MARGIN,
              f"stream tick {x['tick']}: peak {x['ratio']:.3f} x slot_bytes "
              f"x {x['slots']}, beyond {PEAK_MARGIN}")

    # a fold must not wait for the card; a push that emits no window
    # waits only for its fingerprints' host copies
    r = mbs["A"][0][0]
    fold_at = sync_sites(torch, lambda: reservoir_extend(
        sess["A"].sketch[0], r.keys, r.values, r.valid, SEED, STREAM_TICKS))
    check(not fold_at, f"stream: a sketch fold synchronizes at {fold_at}")
    probe = srv.open_stream("sync-probe", WindowSpec(
        STREAM_SIZE, 1, STREAM_SUB_ROWS), use_kernels=True, seed=SEED)
    push_at = sync_sites(torch, lambda: probe.push(mbs["A"][0]))
    check(all(x.startswith("src/repro_torch/core/relation.py")
              for x in push_at),
          f"stream: a push synchronizes outside its fingerprints: {push_at}")
    print(f"stream: a fold synchronizes nowhere; a push without a window at "
          f"{push_at} (the fingerprints' host copies)")

    steps = dg.steps
    # a steady-state step of two windows again, under the profiler
    for name in ("A", "B"):
        r = served[name][-1]
        q = JoinRequest(rels=r.rels, budget=budget,
                        query_id=sess[name].query_id, seed=r.seed,
                        filter_seed=r.filter_seed, max_strata=MAX_STRATA,
                        b_max=B_MAX, use_kernels=True)
        q._words = r._words
        srv.submit(q)

    def one_step():
        srv.step()
        torch.cuda.synchronize()

    wall_us, by_name = device_profile(torch, one_step)

    snap = ds.snapshot()
    print(f"stream: {n_windows} windows from {len(sess)} sessions in "
          f"{pass_s:.3f} s = {n_windows / pass_s:.2f} windows/s ("
          + ", ".join(f"{name} {len(r) / pass_s:.2f}"
                      for name, r in served.items())
          + f"); window e2e p50 {snap['window_latency_p50_s'] * 1e3:.3f} p95 "
          f"{snap['window_latency_p95_s'] * 1e3:.3f} ms; launches "
          f"{launches}, steps {steps}, filter_builds {dg.filter_builds}, "
          f"filter_cache_hits {dg.filter_cache_hits}, retired "
          f"{ds.retired_filter_words}, compiles {dg.compiles}")
    pushes = STREAM_TICKS * len(sess)
    push_s = sum(x["push_ms"] for x in ticks) / 1e3
    print(f"stream: {pushes} pushes took {push_s * 1e3:.3f} ms on the host "
          f"({push_s / pushes * 1e3:.3f} ms a push), by part: "
          + ", ".join(f"{k} {split[k] * 1e3:.3f} ms" for k in (
              "admission with fingerprint", "of which fingerprint", "sketch",
              "words (new builds, OR)", "window assembly", "submit")))
    print(f"stream: slot_bytes {per_slot / 2**30:.4f} GiB; steps:")
    for x in ticks:
        if x["real"]:
            print(f"  tick {x['tick']}: {x['real']} windows in {x['slots']} "
                  f"slots, push {x['push_ms']:.3f} ms, step "
                  f"{x['run_ms']:.3f} ms"
                  f"{' (warms its stage)' * bool(x['fresh'])}, peak "
                  f"{x['peak'] / 2**30:.3f} GiB = {x['ratio']:.3f} x "
                  f"slot_bytes x {x['slots']}")
    if by_name:
        busy = sum(us for us, _ in by_name.values())
        print(f"stream profile: a step of 2 windows, wall {wall_us / 1e3:.3f}"
              f" ms, device busy {busy / 1e3:.3f} ms "
              f"({100 * busy / wall_us:.1f}%); longest device ops:")
        for name, (us, k) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:5]:
            print(f"  {us / 1e3:9.4f} ms {k:4d}x  {name[:90]}")
    else:
        print("stream profile: no device time recorded (not measured)")
    check("step" in sampled, "stream: no step of 3 windows sampled")
    build, probe, sampler = stream_kernels(torch, rates, mbs, served,
                                           *sampled.pop("step"))
    return launches, {"bloom_build": build, "bloom_probe": probe,
                      "edge_sample": sampler}


def nway_truth(rels, torch):
    """The exact n-way join's count and SUM of sums in float64: each input's
    rows grouped by key on the card (``torch.unique`` and ``bincount``,
    none of the port's code), the keys joined on the host; SUM = sum over
    keys of sum_i s_i prod_{j != i} c_j."""
    parts = []
    for r in rels:
        keys, inv = torch.unique(r.keys[r.valid], return_inverse=True)
        c = torch.bincount(inv, minlength=keys.shape[0]).to(torch.float64)
        v = torch.bincount(inv, weights=r.values[r.valid].to(torch.float64),
                           minlength=keys.shape[0])
        parts.append((keys.cpu().numpy(), c.cpu().numpy(), v.cpu().numpy()))
    common = parts[0][0]
    for k, _, _ in parts[1:]:
        common = np.intersect1d(common, k, assume_unique=True)
    cs, ss = [], []
    for k, c, v in parts:
        i = np.searchsorted(k, common)
        cs.append(c[i])
        ss.append(v[i])
    count = np.prod(cs, axis=0)
    total = sum(s * np.prod([c for j, c in enumerate(cs) if j != i], axis=0)
                for i, s in enumerate(ss))
    return dict(count=float(np.sum(count)), sum=float(np.sum(total)),
                keys=int(common.shape[0]))


def make_plan(budget):
    from repro_torch.core.plan import Plan, PlanNode
    return Plan(tuple(PlanNode(name, inputs, budget=budget, use_kernels=True,
                               max_strata=MAX_STRATA, b_max=B_MAX,
                               fp_rate=0.01)
                      for name, inputs in PLAN_NODES))


def check_plan(label, results, datasets, budget, seed, plan_id, truth):
    """Each node of a served plan against the port's composed direct
    approx_join(use_kernels=True) over its leaf relations, bit for bit;
    exact nodes within rtol 1e-4 of the oracle, sampled ones as
    ``served_ok`` holds them.  Returns the bound-0 readings."""
    from repro_torch.core.join import approx_join
    fields = ("estimate", "error_bound", "count", "dof")
    zero = []
    for name, leaves in PLAN_LEAVES.items():
        rels = [r for d in leaves for r in datasets[d]]
        d = approx_join(rels, budget, seed=seed, max_strata=MAX_STRATA,
                        b_max=B_MAX, use_kernels=True,
                        query_id=f"{plan_id}/{name}")
        got = [float(getattr(results[name], f)) for f in fields]
        want = [float(getattr(d, f)) for f in fields]
        check(got == want, f"plan {label} {name}: served {got} != composed "
                           f"direct {want}")
        cnt, t = got[2], truth[name]
        check(abs(cnt - t["count"]) <= 1e-6 * t["count"],
              f"plan {label} {name}: count {cnt} vs oracle {t['count']}")
        if budget.is_exact:
            check(abs(got[0] - t["sum"]) <= 1e-4 * abs(t["sum"]),
                  f"plan {label} {name}: exact SUM {got[0]} vs oracle "
                  f"{t['sum']}")
        else:
            z = served_ok(f"plan {label} {name}", results[name], t["sum"])
            zero += [z] if z else []
    return zero


def plan_phase(torch, wrappers, dev):
    """Phase 8: a two-node plan (``ab`` = A x B, ``abc`` = ab x C, fused to
    a 3-way join) over three relations of 2^24 rows, served by a JoinServer
    on the kernel route.  Returns (each kernel's launches while it served,
    the relations by dataset name, the oracle by node)."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.data.synthetic import overlapping_relations
    from repro_torch.runtime import join_serve as js
    from repro_torch.runtime.join_serve import JoinServer, slot_bytes

    t0 = time.perf_counter()
    rels = overlapping_relations([ROWS] * 3, 0.1,
                                 keys_per_dataset=KEYS_PER_DATASET, lam=10,
                                 seed=SEED, device=dev)
    datasets = {name: [r] for name, r in zip("ABC", rels)}
    truth = {name: nway_truth([r for d in leaves for r in datasets[d]],
                              torch) for name, leaves in PLAN_LEAVES.items()}
    print(f"plan: 3 x {ROWS} rows made and grouped in "
          f"{time.perf_counter() - t0:.1f} s; oracle {truth}")
    srv = JoinServer(batch_slots=SERVE_SLOTS)
    for name, r in datasets.items():
        srv.register_dataset(name, r)
    sampled, exact = QueryBudget(error=0.01), QueryBudget()
    plan = make_plan(sampled)
    steps = []

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    def prepares():
        return sum(1 for key in srv._stage_keys if key[0] == "prepare")

    def step(label):
        req = srv.queue[0]
        n_in = req._class.n_inputs
        before, fresh0 = counts(), prepares()
        builds0 = srv.diagnostics.filter_builds
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        check(srv.step() == 1, f"plan {label}: a step of more than one node")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        d = {k: v - before[k] for k, v in counts().items()}
        fresh = prepares() - fresh0
        builds = srv.diagnostics.filter_builds - builds0
        check(d["bloom_probe"] == n_in * (1 + fresh),
              f"plan {label}: {d['bloom_probe']} probe launches, {n_in} "
              f"inputs ({fresh} fresh prepare)")
        want_sampler = int(n_in == 2 and not req.budget.is_exact)
        check(d["edge_sample"] == want_sampler,
              f"plan {label}: {d['edge_sample']} sampler launches, want "
              f"{want_sampler}")
        check(d["bloom_build"] == builds,
              f"plan {label}: {d['bloom_build']} build launches != {builds} "
              f"filter builds")
        peak, per_slot = torch.cuda.max_memory_allocated() - base, \
            slot_bytes(req._class)
        check(peak <= PEAK_MARGIN * per_slot,
              f"plan {label}: peak {peak / per_slot:.3f} x slot_bytes, "
              f"beyond {PEAK_MARGIN}")
        steps.append(dict(label=label, node=req.plan_node, inputs=n_in,
                          ms=ms, fresh=fresh, launches=d, peak=peak,
                          slot_bytes=per_slot, cls=req._class))
        return steps[-1]

    def submit(p, plan_id, seed):
        t = time.perf_counter()
        h = srv.submit_plan(p, query_id=plan_id, seed=seed)
        return h, time.perf_counter() - t

    # -- the path: every count from 0 -----------------------------------
    for w in wrappers.values():
        w.launches = 0
    h1, compile1 = submit(plan, "P1", 1)
    step("P1/ab")
    step("P1/abc")
    check(srv.diagnostics.plan_compiles == 1, "plan: first submission "
          f"compiled {srv.diagnostics.plan_compiles} plans")
    h2, compile2 = submit(plan, "P2", 2)
    check(srv.diagnostics.plan_compiles == 1
          and srv.diagnostics.plan_cache_hits == 1,
          f"plan: the second submission compiled "
          f"({srv.diagnostics.plan_compiles} compiles, "
          f"{srv.diagnostics.plan_cache_hits} cache hits)")
    step("P2/ab")
    srv._filter_words.clear()       # the 3-way node on a cold filter cache
    cold = step("P2/abc")
    check(cold["launches"]["bloom_build"] == 3
          and cold["launches"]["bloom_probe"] == 3,
          f"plan: the 3-way node on a cold cache launched "
          f"{cold['launches']}, want 3 builds and 3 probes")
    hx, _ = submit(make_plan(exact), "X", 3)
    step("X/ab")
    step("X/abc")
    launches = counts()
    # -- end of the path ------------------------------------------------
    for name, n in launches.items():
        check(n > 0, f"{name} never launched while serving the plan")
    for h in (h1, h2, hx):
        check(h.done and not srv.plans, f"plan {h.plan_id}: not done")
    zero = []
    for label, h, budget, seed in (("P1", h1, sampled, 1),
                                   ("P2", h2, sampled, 2),
                                   ("X", hx, exact, 3)):
        zero += check_plan(label, h.results(), datasets, budget, seed,
                           h.plan_id, truth)
    model = h1.requests["abc"]._bytes_model
    check(model["bytes_pushdown"] < model["bytes_binary"],
          f"plan: pushdown {model['bytes_pushdown']} bytes not below the "
          f"binary tree's {model['bytes_binary']}")
    print(f"plan: every node of 3 submissions equals the composed direct "
          f"approx_join(use_kernels=True) bit for bit; exact nodes within "
          f"rtol 1e-4 of the oracle, sampled within 3 x their bound "
          f"({len(zero)} of bound 0); launches {launches}")
    print(f"plan: compile {compile1 * 1e3:.3f} ms (flatten, validate and "
          f"the byte model over 3 x {ROWS} rows), again "
          f"{compile2 * 1e3:.3f} ms (cache hit); abc bytes pushdown "
          f"{model['bytes_pushdown']} vs binary {model['bytes_binary']} "
          f"({model['reduction_x']:.4f}x), overlap {model['overlap']:.6f}")
    cls3 = steps[1]["cls"]
    print(f"plan: a 3-way kernel class of this shape takes "
          f"{srv._slot_cap(cls3, dev)} of {SERVE_SLOTS} slots a step "
          f"(slot_bytes {slot_bytes(cls3) / 2**30:.4f} GiB, the plain "
          f"sampler's grids included)")
    for s in steps:
        print(f"  step {s['label']}: {s['inputs']}-way, {s['ms']:.3f} ms"
              f"{' (warms its stage)' * bool(s['fresh'])}, launches "
              f"{s['launches']}, peak {s['peak'] / 2**30:.3f} GiB = "
              f"{s['peak'] / s['slot_bytes']:.3f} x slot_bytes "
              f"({s['slot_bytes'] / 2**30:.4f} GiB) x 1")

    # a warm submission more: its sample stages captured (the sampler
    # kernel's two-way one and the plain n-way one, keyed by inputs), its
    # 3-way step under the profiler
    captured = {}
    samplers = {"sample_stage_kernels_batched": lambda a: len(a[0]),
                "_sample_slots": lambda a: a[0].n_inputs}

    def capturing(fn, inputs):
        def run(*a, **k):
            captured[inputs(a)] = (fn, a, k)
            return fn(*a, **k)
        return run

    originals = {name: getattr(js, name) for name in samplers}
    for name, inputs in samplers.items():
        setattr(js, name, capturing(originals[name], inputs))
    try:
        submit(plan, "P3", 4)
        step("P3/ab")
        wall_us, by_name = device_profile(torch, lambda: step("P3/abc"))
    finally:
        for name, fn in originals.items():
            setattr(js, name, fn)
    if by_name:
        busy = sum(us for us, _ in by_name.values())
        print(f"plan profile: a 3-way step, wall {wall_us / 1e3:.3f} ms, "
              f"device busy {busy / 1e3:.3f} ms "
              f"({100 * busy / wall_us:.1f}%); longest device ops:")
        for name, (us, k) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:5]:
            print(f"  {us / 1e3:9.4f} ms {k:4d}x  {name[:90]}")
    else:
        print("plan profile: no device time recorded (not measured)")
    check(sorted(captured) == [2, 3], f"plan: sample stages {captured}")
    for n_in, (fn, a, k) in sorted(captured.items()):
        fn(*a, **k)
        torch.cuda.synchronize()
        wall_us, by_name = device_profile(
            torch, lambda: (fn(*a, **k), torch.cuda.synchronize()))
        busy = sum(us for us, _ in by_name.values())
        what = ("the CUDA sampler and the estimator" if n_in == 2 else
                "plain torch: draw, gather, dedup sort, estimator")
        dev_ms = f"{busy / 1e3:.4f} ms" if by_name else "not measured"
        print(f"plan sample stage, {n_in}-way ({what}): device {dev_ms} in "
              f"{sum(k for _, k in by_name.values())} device ops, wall "
              f"{wall_us / 1e3:.3f} ms")
    return launches, datasets, truth


def fleet_phase(torch, wrappers, datasets, truth, dev):
    """Phase 9 (a): an AsyncJoinFrontDoor(replicas=2) on the card serving
    phase 6's small class and phase 8's plan once; every result against
    the port's sync path.  Returns each kernel's launches meanwhile."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.data.synthetic import overlapping_relations
    from repro_torch.runtime.async_serve import AsyncJoinFrontDoor
    from repro_torch.runtime.join_serve import JoinRequest

    small = {f"s{t}": overlapping_relations(
        [SMALL_ROWS, SMALL_ROWS], 0.1, keys_per_dataset=SMALL_KEYS, lam=10,
        seed=t, device=dev) for t in range(SMALL_TENANTS)}
    small_truth = {name: oracle(r) for name, r in small.items()}
    plan = make_plan(QueryBudget(error=0.01))
    fd = AsyncJoinFrontDoor(replicas=2, batch_slots=SERVE_SLOTS, device=dev)
    try:
        for name, r in {**small, **datasets}.items():
            fd.register_dataset(name, r)
        # -- the path: every count from 0 -------------------------------
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        futs = [fd.submit(JoinRequest(
            dataset=ds, budget=budget, query_id=qid, seed=seed,
            max_strata=SMALL_STRATA, b_max=B_MAX, use_kernels=True))
            for ds, (qid, budget, seed) in small_spec()]
        plan_futs = fd.submit_plan(plan, query_id="F", seed=5)
        reqs = [f.result(timeout=600) for f in futs]
        nodes = {name: f.result(timeout=600) for name, f in plan_futs.items()}
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = {name: w.launches for name, w in wrappers.items()}
        # -- end of the path --------------------------------------------
        snap = fd.snapshot()
    finally:
        fd.close(timeout=120)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched while the fleet served")
    n_checked, zero = 0, []
    for name, r in small.items():
        n, z = check_served("fleet", [q for q in reqs if q.dataset == name],
                            r, small_truth[name])
        n_checked, zero = n_checked + n, zero + z
    zero += check_plan("fleet", {k: v.result for k, v in nodes.items()},
                       datasets, plan.nodes[0].budget, 5, "F", truth)
    served = {name: d["queries"] for name, d in snap["replicas"].items()}
    check(sum(served.values()) == len(reqs) + len(nodes),
          f"fleet: replicas served {served}")
    every = reqs + list(nodes.values())
    q = [r.queue_latency_s * 1e3 for r in every]
    e = [r.e2e_latency_s * 1e3 for r in every]
    print(f"fleet: {n_checked} small-class results and the plan's 2 nodes "
          f"equal the port's sync path bit for bit ({len(zero)} of bound "
          f"0); launches {launches}")
    print(f"fleet: {len(every)} queries in {dt * 1e3:.3f} ms = "
          f"{len(every) / dt:.2f} q/s over 2 replicas {served}, steals "
          f"{snap['steals']}; queue latency p50 {np.percentile(q, 50):.3f} "
          f"p95 {np.percentile(q, 95):.3f} ms, e2e p50 "
          f"{np.percentile(e, 50):.3f} p95 {np.percentile(e, 95):.3f} ms; "
          f"peak device memory {peak / 2**30:.3f} GiB above the fleet's "
          f"start")
    return launches


def drill_phase(torch, rels, wrappers):
    """Phase 9 (b): the fault drill at phase 7's width.  Returns each
    kernel's launches during the faulted run."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.relation import Relation
    from repro_torch.core.window import WindowSpec
    from repro_torch.runtime import async_serve
    from repro_torch.runtime.fault import InjectedFault
    from repro_torch.runtime.stream_join import StreamJoinServer

    spec = WindowSpec(DRILL_SIZE, DRILL_SIZE, STREAM_SUB_ROWS)
    mbs = [[Relation(*(f[m * STREAM_SUB_ROWS:(m + 1) * STREAM_SUB_ROWS]
                       for f in r)) for r in rels]
           for m in range(STREAM_TICKS)]
    kw = dict(budget=QueryBudget(error=0.01), max_strata=MAX_STRATA,
              b_max=B_MAX, seed=SEED, use_kernels=True)
    fields = ("estimate", "error_bound", "count", "dof")

    def key(r):
        return [float(getattr(r.result, f)) for f in fields]

    base = StreamJoinServer(batch_slots=STREAM_SLOTS)
    bsess = base.open_stream("D", spec, **kw)
    for mb in mbs:
        bsess.push(mb)
        base.run()
    baseline = {r.window_id: key(r) for r in bsess.drain()}
    n_windows = STREAM_TICKS // DRILL_SIZE
    check(sorted(baseline) == list(range(n_windows)),
          f"drill: baseline windows {sorted(baseline)}")

    # the successor's restore, timed where the front door calls it
    restores = []
    restore = async_serve.elastic_restore_engine

    restored_live = []

    def timed_restore(ckpt_dir, engine, **k):
        t = time.perf_counter()
        try:
            return restore(ckpt_dir, engine, **k)
        finally:
            restores.append(time.perf_counter() - t)
            restored_live.append(len(engine.sessions["D"].buffer.live))
    async_serve.elastic_restore_engine = timed_restore

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {}
    try:
        fd = async_serve.AsyncJoinFrontDoor(
            replicas=2, checkpoint_dir=tmp, device=rels[0].keys.device,
            checkpoint_every_s=DRILL_CHECKPOINT_EVERY_S,
            engine_factory=lambda i: StreamJoinServer(
                batch_slots=STREAM_SLOTS))
        try:
            # -- the path: every count from 0 ---------------------------
            for w in wrappers.values():
                w.launches = 0
            rep, _ = fd.open_stream("D", spec, **kw)
            pre = DRILL_KILL_WINDOWS * DRILL_SIZE + DRILL_MID_PUSHES
            futs = [f for t in range(pre) for f in fd.push("D", mbs[t])]
            for f in futs:
                r = f.result(timeout=600)
                out[r.window_id] = key(r)
            # the newest checkpoint must hold every push before the kill:
            # a no-op call lands after the last step's bookkeeping, then
            # the idle loop checkpoints once its cadence allows
            rep.call(lambda: None).result(timeout=60)
            deadline = time.monotonic() + 60
            while rep._dirty and time.monotonic() < deadline:
                time.sleep(0.01)
            check(not rep._dirty, "drill: replica0 never checkpointed")
            t_kill = time.perf_counter()
            rep.kill_after(0)
            rep._thread.join(60)
            check(not rep._thread.is_alive()
                  and isinstance(rep.error, InjectedFault),
                  f"drill: replica0 did not die ({rep.error!r})")
            # the idle successor's loop may have failed it over already;
            # this waits on the routing lock until the failover is done
            fd.maybe_failover()
            failover_s = time.perf_counter() - t_kill
            for t in range(pre, STREAM_TICKS):
                for f in fd.push("D", mbs[t]):
                    r = f.result(timeout=600)
                    out[r.window_id] = key(r)
            torch.cuda.synchronize()
            launches = {name: w.launches for name, w in wrappers.items()}
            # -- end of the path ----------------------------------------
            snap = fd.snapshot()
            succ = next(r for r in fd.replicas if r.error is None)
            shed = succ.call(
                lambda: succ.engine.stream_diagnostics.windows_shed).result(
                    timeout=60)
            ckpts, capture_s = rep.stats["checkpoints"], \
                rep.stats["checkpoint_s"]
            adopted = restored_live[0] if restored_live else None
        finally:
            fd.close(timeout=120)
        dead_dir = os.path.join(tmp, "replica0")
        sizes = {d: sum(os.path.getsize(os.path.join(dead_dir, d, f))
                        for f in os.listdir(os.path.join(dead_dir, d)))
                 for d in os.listdir(dead_dir)}
        nbytes, on_disk = sum(sizes.values()), len(sizes)
        newest = sizes[max(sizes)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        async_serve.elastic_restore_engine = restore
    for name, n in launches.items():
        check(n > 0, f"{name} never launched during the drill")
    check(len(restores) == 1 and snap["failovers"] == 1
          and snap["failed"] == ["replica0"],
          f"drill: failovers {snap['failovers']}, failed {snap['failed']}")
    check(shed == 0, f"drill: {shed} windows shed")
    check(adopted == DRILL_MID_PUSHES, f"drill: the successor adopted "
          f"{adopted} live sub-windows, want {DRILL_MID_PUSHES}")
    check(sorted(out) == list(range(n_windows)),
          f"drill: windows served {sorted(out)}")
    for w in range(n_windows):
        check(out[w] == baseline[w], f"drill: window {w} {out[w]} != the "
              f"uninterrupted run's {baseline[w]}")
    check(fd.sigma.table == base.sigma.table,
          "drill: the fleet's sigma table != the uninterrupted run's")
    print(f"drill: replica0 killed after {DRILL_KILL_WINDOWS} of "
          f"{n_windows} windows and {DRILL_MID_PUSHES} pushes into the next; "
          f"the successor adopted {adopted} live sub-windows; 1 failover, 0 "
          f"shed; windows "
          f"{DRILL_KILL_WINDOWS}-{n_windows - 1} (and the ones before) equal "
          f"the uninterrupted run bit for bit; sigma tables equal; launches "
          f"{launches}")
    print(f"drill: replica0 wrote {ckpts} checkpoints (every "
          f"{DRILL_CHECKPOINT_EVERY_S} s at most; {on_disk} on disk, "
          f"{nbytes / 2**20:.1f} MiB, the newest {newest / 2**20:.1f} MiB), "
          f"capture under the engine lock {capture_s * 1e3:.3f} "
          f"ms in all ({capture_s / max(ckpts, 1) * 1e3:.3f} ms each); "
          f"restore (load and adopt) {restores[0] * 1e3:.3f} ms, kill to "
          f"failover done {failover_s * 1e3:.3f} ms")
    return launches


# phase 10: the mesh.  Ranks of 2 and 4 share the one card over gloo; a
# forced bucket of this many rows a (source, dest) pair must overflow.
MESH_SIZES = (2, 4)
MESH_SMALL_CAP = 1 << 10
MESH_TIMEOUT_S = 240
NCCL_PROBE_TIMEOUT_S = 60


def surface(res):
    """(estimate, bound, count, dof) of a result, as Python floats."""
    return tuple(float(getattr(res, f))
                 for f in ("estimate", "error_bound", "count", "dof"))


def rtol_ok(got, want, rtol=1e-5):
    return all(abs(g - w) <= rtol * max(abs(w), 1e-30)
               for g, w in zip(got, want))


def mesh_serve(torch, srv, rels, cfg, modes=("exact-parity", "psum",
                                             "kernel")):
    """Serve the mesh workload on ``srv``: phase 6's large class (8 SUM
    requests, their filters all of seed 0) as mesh classes in exact-parity,
    the same under psum (query ids L/P...), and the same as kernel classes
    (L/K..., filter seed 11, which no mesh class uses, so the build kernel
    builds their filters), as far as ``modes`` names them.  Returns {mode:
    (surfaces, run seconds, steps, communication meter, drops, each rank's
    shuffled bytes in the pass)} and the diagnostics.  The kernel class's
    dataset filters (on a mesh the OR of the ranks' partition filters,
    each built by the build kernel from the rank's block) must equal a
    plain single build over the whole relation bit for bit."""
    from repro_torch.core import bloom
    from repro_torch.core import distributed as D
    from repro_torch.core.cost import sync
    from repro_torch.runtime.join_serve import JoinRequest

    dev = rels[0].keys.device
    srv.register_dataset("L", rels)
    kw = dict(dataset="L", max_strata=cfg["max_strata"], b_max=cfg["b_max"])
    plan = (("exact-parity", large_spec("M"), {"filter_seed": cfg["seed"]}),
            ("psum", large_spec("P"), {"filter_seed": cfg["seed"],
                                       "serve_mode": "psum"}),
            ("kernel", large_spec("K"), {"filter_seed": 11,
                                         "use_kernels": True}))
    out = {}
    for mode, spec, extra in plan:
        if mode not in modes:
            continue
        reqs = [srv.submit(JoinRequest(budget=b, query_id=q, seed=sd, **kw,
                                       **extra)) for q, b, sd in spec]
        steps = srv.diagnostics.steps
        per0 = np.array(srv.diagnostics.per_device_shuffled_bytes, float)
        D.COMM.reset()
        D.COMM.timed = True
        sync(dev)
        t0 = time.perf_counter()
        srv.run()
        sync(dev)
        dt = time.perf_counter() - t0
        D.COMM.timed = False
        per = np.array(srv.diagnostics.per_device_shuffled_bytes, float)
        out[mode] = ([surface(q.result) for q in reqs], dt,
                     srv.diagnostics.steps - steps, D.COMM.snapshot(),
                     [float(q.result.diagnostics.dist_dropped_tuples)
                      for q in reqs], (per - per0).tolist())
        if mode == "kernel":
            cls = reqs[0]._class
            nb = bloom.num_blocks_for(max(cls.caps), cls.fp_rate)
            for s_, r in enumerate(rels):
                got = srv._filter_words[(reqs[0]._fps[s_], nb, 11)]
                check(torch.equal(got, bloom.build(r.keys, r.valid, nb,
                                                   11).words),
                      f"serve: the kernel class's filter of input {s_} "
                      f"({nb} blocks, mesh {srv.mesh_k}) "
                      f"!= a plain build over the whole relation")
    return out, srv.diagnostics.snapshot()


def mesh_joins(torch, mesh, rels, cfg):
    """distributed_approx_join on every rank: exact and sampled SUM in
    both merges, the exact SUM without the filter stage and with a forced
    small bucket.  Returns {case: (surface, meters, seconds, comm)}."""
    from repro_torch.core import distributed as D
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.cost import sync

    dev = rels[0].keys.device
    kw = dict(seed=cfg["seed"], max_strata=cfg["max_strata"],
              b_max=cfg["b_max"])
    cases = {
        "gather/exact": dict(mode="exact"),
        "gather/sampled": dict(mode="sample", budget=QueryBudget(error=0.01)),
        "psum/exact": dict(mode="exact", merge="psum"),
        "psum/sampled": dict(mode="sample", budget=QueryBudget(error=0.01),
                             merge="psum"),
        "unfiltered/exact": dict(mode="exact", filter_stage=False),
        "small-bucket/exact": dict(mode="exact",
                                   bucket_cap=cfg["small_cap"]),
    }
    out = {}
    for name, case in cases.items():
        D.COMM.reset()
        D.COMM.timed = True
        sync(dev)
        t0 = time.perf_counter()
        r = D.distributed_approx_join(mesh, rels, **kw, **case)
        sync(dev)
        dt = time.perf_counter() - t0
        D.COMM.timed = False
        meters = dict(shuffled=float(r.shuffled_tuple_bytes),
                      per_rank=r.device_shuffled_bytes.tolist(),
                      overflow=int(r.bucket_overflow),
                      dropped=r.device_dropped.tolist(),
                      live=float(r.live_total), total=float(r.input_total))
        out[name] = (surface(r), meters, dt, D.COMM.snapshot())
    return out


def mesh_rank(mesh, dev, data_dir, cfg):
    """One rank of phase 10 (b): the joins on every rank, then a JoinServer
    on rank 0 with the others as its workers; then, off the path, the
    build kernel at the partition shape (this rank's block into the
    dataset's blocks) against its plain version.  Returns what it measured
    and this rank's kernel launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import bloom
    from repro_torch.core.relation import relation, shard_to_mesh
    from repro_torch.kernels import bloom_build, bloom_probe, edge_sample
    from repro_torch.runtime.join_serve import (JoinServer,
                                                close_mesh_workers,
                                                serve_mesh_worker)

    wrappers = {"bloom_build": bloom_build.bloom_build_batched,
                "bloom_probe": bloom_probe.bloom_probe_batched,
                "edge_sample": edge_sample.edge_sample_batched}
    rels = [relation(*(np.load(os.path.join(data_dir, f"{i}_{f}.npy"))
                       for f in ("keys", "values", "valid")), device=dev)
            for i in range(2)]
    block = shard_to_mesh(rels[0], mesh, mesh.mesh_dim_names)
    keys, valid = block.keys[None].clone(), block.valid[None].clone()
    nb = bloom.num_blocks_for(rels[0].capacity, 0.01)
    for w in wrappers.values():
        w.launches = 0
    joins = mesh_joins(torch, mesh, rels, cfg)
    if dist.get_rank() == 0:
        srv = JoinServer(batch_slots=cfg["slots"], mesh=mesh)
        served = mesh_serve(torch, srv, rels, cfg)
        srv.shutdown()
        close_mesh_workers()
    else:
        del rels
        serve_mesh_worker(mesh, dev)
        served = None
    launches = {n: w.launches for n, w in wrappers.items()}
    # -- end of the path: the partition build of the kernel class ----------
    seed = torch.tensor([11], device=dev)
    kb = bloom_build
    equal = torch.equal(kb.bloom_build_batched(keys, valid, nb, seed),
                        kb.bloom_build_ref(keys, valid, nb, seed))
    build = dict(keys=keys.shape[1], num_blocks=nb, equal=equal)
    if dev.type == "cuda":
        dist.barrier()        # the other ranks are done: rank 0 times alone
    if dev.type == "cuda" and dist.get_rank() == 0:
        build["ms"], build["call_ms"] = kernel_ms(
            lambda: kb.bloom_build_batched(keys, valid, nb, seed))
        build["plain_ms"] = time_ms(
            lambda: kb.bloom_build_ref(keys, valid, nb, seed), PLAIN_REPS)
        build["bound_ms"], build["bound_by"] = bound(
            cfg["rates"], keys.shape[1] * (8 + 1) + 8 + nb * 32,
            **{p: float(valid.sum()) * v
               for p, v in INT_OPS["bloom_build"].items()})
    return dict(joins=joins, served=served, launches=launches, build=build,
                peak=torch.cuda.max_memory_allocated()
                if dev.type == "cuda" else 0)


def routed_bytes(rels, k, seed, filter_stage=True):
    """What the data says each rank of a mesh of ``k`` ranks over ``data``
    puts into the key shuffle of a join of filter seed ``seed``: TUPLE_BYTES
    for each live row of its block whose key routes to another rank (rows
    past a small bucket included: the shuffle meters what it routes, as the
    reference's does), a live row being one that the single-device joint
    filter passes.  Returns (bytes by rank, live rows in all)."""
    import torch
    from repro_torch.core import bloom
    from repro_torch.core.hashing import hash2
    from repro_torch.core.join import TUPLE_BYTES

    nb = bloom.num_blocks_for(max(r.capacity for r in rels), 0.01)
    jf = bloom.intersect_all([bloom.build(r.keys, r.valid, nb, seed)
                              for r in rels])
    per, live = np.zeros(k), 0
    for r in rels:
        ok = r.valid & bloom.contains(jf, r.keys) if filter_stage \
            else r.valid
        block = torch.arange(r.capacity, device=r.keys.device) \
            // (r.capacity // k)
        off = ok & (hash2(r.keys, seed + 101) % k != block)
        per += off.view(k, -1).sum(1).cpu().numpy()
        live += int(ok.sum())
    return (per * TUPLE_BYTES).tolist(), live


def bytes_ok(got, want):
    """Shuffled bytes against the data's: float32 sums hold these counts
    to within a few units in 2^24."""
    return len(got) == len(want) and all(
        abs(g - w) <= 1e-6 * max(w, 1.0) for g, w in zip(got, want))


def print_comm(label, comm):
    parts = [f"{op} {c['calls']}x {c['bytes'] / 2**20:.3f} MiB "
             f"{c['ms']:.3f} ms" for op, c in sorted(comm.items())]
    print(f"  {label} collectives: " + ("; ".join(parts) or "none"))


def check_mesh_joins(label, joins, want, routed, cfg, note=""):
    """The joins of one mesh against the single-device results: gather
    bit for bit, psum within rtol 1e-5; each rank's shuffled bytes equal
    what the data routes off it (``routed``: filtered and unfiltered, from
    :func:`routed_bytes`); the filter must cut the shuffle and the small
    bucket must count its drops."""
    for case, (got, meters, dt, comm) in joins.items():
        merge, kind = case.split("/")
        if merge == "gather":
            check(got == want[kind], f"mesh {label} {case}: {got} != "
                                     f"single-device {want[kind]}")
        elif merge == "psum":
            check(rtol_ok(got, want[kind]), f"mesh {label} {case}: {got} "
                  f"not within rtol 1e-5 of {want[kind]}")
        print(f"mesh {label} join {case}: {dt * 1e3:.3f} ms{note}; "
              f"estimate {got[0]!r} bound {got[1]!r}; shuffled "
              f"{meters['shuffled']:.0f} B {meters['per_rank']}, overflow "
              f"{meters['overflow']}")
        print_comm(f"{label} {case}", comm)
        check(meters["overflow"] == sum(meters["dropped"]),
              f"mesh {label} {case}: overflow {meters['overflow']} != the "
              f"ranks' drops {meters['dropped']}")
        data = routed["unfiltered" if merge == "unfiltered" else "filtered"]
        check(bytes_ok(meters["per_rank"], data[0]),
              f"mesh {label} {case}: shuffled bytes by rank "
              f"{meters['per_rank']} != the data's {data[0]}")
    small = joins["small-bucket/exact"][1]
    check(small["overflow"] > 0, f"mesh {label}: a bucket of "
          f"{cfg['small_cap']} rows dropped nothing")
    for case in ("gather/exact", "gather/sampled", "psum/exact"):
        check(joins[case][1]["overflow"] == 0,
              f"mesh {label} {case}: lossless buckets dropped rows")
    filt = joins["gather/exact"][1]["shuffled"]
    unf = joins["unfiltered/exact"][1]["shuffled"]
    if note:
        check(0 < filt < unf, f"mesh {label}: filtered shuffle {filt} not "
              f"below the unfiltered {unf}")
        k = len(joins["gather/exact"][1]["per_rank"])
        live = joins["gather/exact"][1]["live"]
        print(f"mesh {label}: shuffled tuple bytes with the filter stage "
              f"{filt:.0f}, without {unf:.0f}: {unf / filt:.4f}x less "
              f"(live {live:.0f} of "
              f"{joins['gather/exact'][1]['total']:.0f} rows); each rank's "
              f"equal the rows the data routes off it; the filtered total "
              f"is {filt / (live * 8 * (k - 1) / k):.6f} x live x 8 B x "
              f"(k-1)/k")


def check_mesh_serve(label, served, diag, want, k, routed, note=""):
    """A mesh server's results against the meshless server's: exact-parity
    and kernel classes bit for bit, psum within rtol 1e-5 with nothing
    dropped; the kernel class's host gather metered (0 at mesh 1); each
    pass's shuffled bytes by rank equal what the data routes off each rank
    (``routed``, a filter of seed 0, once a request; the kernel class
    shuffles nothing), and all of them lie within the wire model's
    buffers."""
    for mode, (got, dt, steps, comm, dropped, per) in served.items():
        data = [0.0] * k if mode == "kernel" else \
            [len(got) * b for b in routed["filtered"][0]]
        check(bytes_ok(per, data), f"serve mesh {label} {mode}: shuffled "
              f"bytes by rank {per} != the data's {data}")
        # the meshless server's exact-parity results are those of the psum
        # requests too: the same seeds and budgets, each id its own sigmas
        ref = want["exact-parity" if mode == "psum" else mode][0]
        if mode == "psum":
            check(all(rtol_ok(g, w) for g, w in zip(got, ref)),
                  f"serve mesh {label} psum: {got} not within rtol 1e-5 of "
                  f"the meshless server's {ref}")
            check(sum(dropped) == 0, f"serve mesh {label} psum dropped "
                  f"{dropped}")
        else:
            check(got == ref, f"serve mesh {label} {mode}: {got} != the "
                              f"meshless server's {ref}")
        print(f"serve mesh {label} {mode}: {len(got)} requests in {steps} "
              f"steps, {dt * 1e3:.3f} ms, {dt * 1e3 / max(steps, 1):.3f} ms "
              f"a step{note}")
        print_comm(f"serve {label} {mode}", comm)
    gb = diag["kernel_gather_bytes"]
    check((gb == 0) if k == 1 else (gb > 0),
          f"serve mesh {label}: kernel_gather_bytes {gb}")
    model = diag["dist_wire_bytes_model"]
    moved = diag["dist_shuffled_tuple_bytes"]
    per = diag["per_device_shuffled_bytes"]
    check(abs(sum(per) - moved) <= 1e-6 * max(moved, 1),
          f"serve mesh {label}: per-rank bytes {per} sum != {moved}")
    check(moved <= model, f"serve mesh {label}: shuffled {moved} above the "
                          f"wire model {model}")
    print(f"serve mesh {label}: kernel_gather_bytes {gb:.0f}, shuffled "
          f"tuple bytes {moved:.0f} (per rank {per}) within the wire model "
          f"{model:.0f} ({moved / model if model else 0:.4f} of it), "
          f"dropped {diag['dist_dropped_tuples']:.0f}, filter exchange "
          f"measured {diag['filter_exchange_bytes_measured']:.0f} B")


def nccl_two_ranks_probe():
    """Two NCCL ranks on the one card: what NCCL says (recorded, not
    required)."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    try:
        run_ranks(_nccl_probe_rank, 2, backend="nccl", device="cuda",
                  timeout_s=NCCL_PROBE_TIMEOUT_S)
        said = "both ranks started and all_reduced"
    except (RuntimeError, TimeoutError) as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        hits = [ln for ln in lines if "NCCL" in ln or "uplicate" in ln]
        said = (hits or lines)[-1][:400] if lines else repr(e)
    print(f"mesh 2/nccl on one card ({time.perf_counter() - t0:.1f} s): "
          f"{said}")


def _nccl_probe_rank(mesh, dev):
    return True


def mesh_phase(rels, torch, wrappers, rates):
    """Phase 10: the distributed pipeline and the mesh JoinServer.  (a)
    mesh 1 over NCCL in this process; (b) meshes of 2 and 4 ranks,
    spawned: over NCCL, a card a rank, where there are that many cards,
    else sharing the one card over gloo.  Returns each kernel's launches
    in the phase (every rank's) and the build kernel at each mesh's
    partition shape.  On CPU relations (a rehearsal) every mesh runs over
    gloo."""
    import torch.distributed as dist
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.join import approx_join
    from repro_torch.launch.mesh import (init_ranks, make_host_mesh,
                                         run_ranks, stop_rank_server)
    from repro_torch.runtime.join_serve import JoinServer

    t_phase = time.perf_counter()
    dev = rels[0].keys.device
    card = dev.type == "cuda"
    cfg = dict(seed=SEED, max_strata=MAX_STRATA, b_max=B_MAX,
               slots=SERVE_SLOTS, small_cap=MESH_SMALL_CAP, rates=rates)
    kw = dict(seed=SEED, max_strata=MAX_STRATA, b_max=B_MAX)
    want = {"exact": surface(approx_join(rels, QueryBudget(), **kw)),
            "sampled": surface(approx_join(rels, QueryBudget(error=0.01),
                                           **kw))}
    print(f"mesh: single-device references {want}")
    meshless, _ = mesh_serve(torch, JoinServer(batch_slots=SERVE_SLOTS),
                             rels, cfg, ("exact-parity", "kernel"))
    routed = {k: {"filtered": routed_bytes(rels, k, SEED),
                  "unfiltered": routed_bytes(rels, k, SEED, False)}
              for k in (1, *MESH_SIZES)}
    for w in wrappers.values():
        w.launches = 0

    # -- (a) mesh 1 over NCCL, this process ---------------------------------
    one = "1/nccl" if card else "1/gloo"
    tmp = tempfile.mkdtemp(prefix="mesh1-")
    init_ranks(0, 1, backend="nccl" if card else "gloo", device=dev,
               store_path=os.path.join(tmp, "store"),
               timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = make_host_mesh(1, 1)
        check_mesh_joins(one, mesh_joins(torch, mesh, rels, cfg), want,
                         routed[1], cfg)
        srv = JoinServer(batch_slots=SERVE_SLOTS, mesh=mesh)
        served, diag = mesh_serve(torch, srv, rels, cfg,
                                  ("exact-parity", "kernel"))
        srv.shutdown()
        check_mesh_serve(one, served, diag, meshless, 1, routed[1])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {n: w.launches for n, w in wrappers.items()}

    # -- (b) 2 and 4 ranks: a card each over NCCL, or one card over gloo ----
    if card:
        torch.cuda.empty_cache()
    builds = {}
    try:
        with tempfile.TemporaryDirectory(prefix="mesh-data-") as data_dir:
            for i, r in enumerate(rels):
                np.save(os.path.join(data_dir, f"{i}_keys.npy"),
                        r.keys.cpu().numpy().astype(np.uint32))
                np.save(os.path.join(data_dir, f"{i}_values.npy"),
                        r.values.cpu().numpy())
                np.save(os.path.join(data_dir, f"{i}_valid.npy"),
                        r.valid.cpu().numpy())
            for k in MESH_SIZES:
                nccl = card and torch.cuda.device_count() >= k
                backend = "nccl" if nccl else "gloo"
                note = " (nccl, a card a rank)" if nccl else \
                    " (gloo through the host, one card)" if card else \
                    " (gloo, CPU)"
                t0 = time.perf_counter()
                ranks = run_ranks(mesh_rank, k, (data_dir, cfg),
                                  backend=backend, device=dev.type,
                                  timeout_s=MESH_TIMEOUT_S)
                print(f"mesh {k}/{backend}:{note} ran in "
                      f"{time.perf_counter() - t0:.1f} s, peak device memory "
                      f"by rank "
                      f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB")
                for r in ranks:
                    check(all(r["joins"][c][:2] == ranks[0]["joins"][c][:2]
                              for c in r["joins"]),
                          f"mesh {k}: the ranks' join results differ")
                check_mesh_joins(f"{k}/{backend}", ranks[0]["joins"], want,
                                 routed[k], cfg, note)
                served, diag = ranks[0]["served"]
                check_mesh_serve(f"{k}/{backend}", served, diag, meshless, k,
                                 routed[k], note)
                for r in ranks:
                    for n, c in r["launches"].items():
                        launches[n] += c
                build = ranks[0]["build"]
                check(all(r["build"]["equal"] for r in ranks),
                      f"mesh {k}: bloom_build at the partition shape != plain "
                      f"on ranks {[i for i, r in enumerate(ranks)
                                   if not r['build']['equal']]}")
                builds[k] = build
                timed = f": {build['ms']:.4f} ms on the device, " \
                    f"{build['call_ms']:.4f} ms a call, plain " \
                    f"{build['plain_ms']:.4f} ms, bound " \
                    f"{build['bound_ms']:.4f} ms by {build['bound_by']}" \
                    if "ms" in build else ""
                print(f"kernel bloom_build at mesh {k}'s partition shape "
                      f"({build['keys']} keys into {build['num_blocks']} "
                      f"blocks) equals its plain version on every "
                      f"rank{timed}")
        if card and torch.cuda.device_count() < 2:
            nccl_two_ranks_probe()
    finally:
        # the fork server and resource tracker the spawns started leave now,
        # not some time after this script has ended
        stop_rank_server()
    print(f"mesh: launches {launches}; phase 10 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    for name, n in launches.items():
        check(n > 0, f"mesh: {name} never launched in phase 10")
    return launches, builds


# phase 11: the rest of the mesh.  (a) streams at phase 7's shape, (b) phase
# 8's plan, (c) the fleet, the drill of phase 9 (b) and a restore; every
# mesh server exact-parity unless a session says psum.  Every kernel call
# of the phase keeps its operands at each new shape, and after the path
# each is held against the plain version on them.
# K first: each new sub-window's filter is built through the build kernel
# (on every rank, OR-merged), and E and P hit the cache (the same words)
SLICE_SESSIONS = (("K", None, True), ("E", "exact-parity", False),
                  ("P", "psum", False))
SLICE_FLEET_SLOTS = 4     # a replica's step: 4 plain small-class slots
SLICE_DRILL_KILL = DRILL_KILL_WINDOWS * DRILL_SIZE + DRILL_MID_PUSHES
KERNEL_FNS = ("bloom_build_batched", "bloom_probe_batched",
              "edge_sample_batched")
SLICE_TIMEOUT_S = 600
FIELDS = ("estimate", "error_bound", "count", "dof")


def keep_operands(torch):
    """Route the three kernel wrappers, where the port calls them
    (``kernels/ops.py``), through a hook that keeps a copy of the operands
    of the first call at each shape.  Returns the kept calls and the undo;
    launches are counted as before."""
    from repro_torch.kernels import ops
    kept, saved = {}, {n: getattr(ops, n) for n in KERNEL_FNS}

    def hook(name, fn):
        def call(*a):
            key = (name,) + tuple(
                (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                else x for x in a)
            if key not in kept:
                kept[key] = (name, [x.clone() if isinstance(x, torch.Tensor)
                                    else x for x in a])
            return fn(*a)
        return call
    for n, fn in saved.items():
        setattr(ops, n, hook(n, fn))

    def undo():
        for n, fn in saved.items():
            setattr(ops, n, fn)
    return kept, undo


def check_kept(torch, kept):
    """Each kept call again through the kernel and through its plain
    version on the same operands.  Returns per call the kernel, its shape,
    the largest absolute difference and whether the two are equal bit for
    bit."""
    from repro_torch.kernels import bloom_build as kb
    from repro_torch.kernels import bloom_probe as kp
    from repro_torch.kernels import edge_sample as ke

    out = []
    for name, a in kept.values():
        if name == "bloom_build_batched":
            keys, _, nb, _ = a
            got = [kb.bloom_build_batched(*a)]
            want = [kb.bloom_build_ref(*a)]
            shape = f"{keys.shape[0]} x {keys.shape[1]} keys into {nb} blocks"
        elif name == "bloom_probe_batched":
            words, keys, _ = a
            got = [kp.bloom_probe_batched(*a)]
            want = [kp.bloom_probe_ref(*a)]
            shape = f"{keys.shape[0]} x {keys.shape[1]} keys against " \
                    f"{words.shape[1]}-block filters"
        else:
            *arrays, seeds, b_max, expr = a
            got = ke.edge_sample_batched(*arrays, seeds, b_max, expr)
            want = ke.edge_sample_ref(*arrays, b_max, seeds, expr)
            B, S = arrays[2].shape
            shape = f"{B} x {S} strata over {arrays[0].shape[1]} rows, " \
                    f"b_max {b_max}"
        err = max((float((g.double() - w.double()).abs().max())
                   if g.numel() else 0.0) for g, w in zip(got, want))
        out.append(dict(kernel=name.removesuffix("_batched"), shape=shape,
                        max_abs_err=err,
                        equal=all(torch.equal(g, w)
                                  for g, w in zip(got, want))))
    return out


def check_kept_calls(label, calls):
    for c in calls:
        check(c["equal"], f"slice {label}: {c['kernel']} at {c['shape']} != "
              f"its plain version (max abs err {c['max_abs_err']})")
    for c in calls:
        print(f"slice kernels {label}: {c['kernel']} at {c['shape']} equals "
              f"its plain version (max abs err {c['max_abs_err']})")


def words_digest(words):
    """A window's filter words, one SHA-1 a side."""
    import hashlib
    return [hashlib.sha1(w.cpu().numpy().tobytes()).hexdigest()
            for w in words]


def slice_micro_batches(rels, ticks):
    from repro_torch.core.relation import Relation
    return [[Relation(*(f[m * STREAM_SUB_ROWS:(m + 1) * STREAM_SUB_ROWS]
                        for f in r)) for r in rels] for m in range(ticks)]


def slice_stream(torch, srv, mbs, sessions):
    """Phase 11 (a)'s sessions on ``srv``: each slides windows of
    ``STREAM_SIZE`` sub-windows by one over ``mbs``, a SUM under
    ``QueryBudget(error=0.01)``, one push a session and a ``run()`` a tick.
    Returns per session its windows (surface, draws, the words' digests,
    drops, bucket cap), its rolling overlap, the seconds and windows
    served after the tick of the first windows (the steady rate: the
    first window builds all its sub-windows' filters), the scatter bytes
    and, on a mesh, each rank's relation and word ids once the stream is
    drained and its requests dropped, with the server's word ids of the
    live sub-windows."""
    import gc

    from repro_torch.core import distributed as D
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.window import WindowSpec

    spec = WindowSpec(STREAM_SIZE, 1, STREAM_SUB_ROWS)
    sess = {name: srv.open_stream(
        name, spec, budget=QueryBudget(error=0.01), max_strata=MAX_STRATA,
        b_max=B_MAX, seed=SEED, serve_mode=mode, use_kernels=kernels)
        for name, mode, kernels in sessions}
    out = {name: [] for name in sess}
    dev = mbs[0][0].keys.device
    sent = D.COMM.bytes["scatter"]
    t0, steady = None, 0
    for mb in mbs:
        for s in sess.values():
            s.push(mb)
        srv.run()
        served = 0
        for name, s in sess.items():
            # plain values only: a served window's request holds its rows
            done = s.drain()
            served += len(done)
            out[name] += [dict(
                w=r.window_id, surface=surface(r.result),
                n_sampled=r.result.stats.n_sampled.cpu().numpy(),
                words=words_digest(r._words),
                dropped=float(r.result.diagnostics.dist_dropped_tuples),
                cap=r._class.bucket_cap) for r in done]
        if t0 is not None:
            steady += served
        elif served:
            torch.cuda.synchronize(dev) if dev.type == "cuda" else None
            t0 = time.perf_counter()
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    got = dict(windows=out, seconds=time.perf_counter() - t0, steady=steady,
               ewma={n: s.overlap_ewma for n, s in sess.items()},
               scattered=D.COMM.bytes["scatter"] - sent,
               model={n: s.window_scatter_bytes_model()
                      for n, s in sess.items()},
               diag=srv.diagnostics.snapshot())
    if srv.mesh is not None:
        del sess, s, done
        gc.collect()
        got["live"] = srv.mesh_state()
        got["word_ids"] = sorted(srv._word_ids.values())
    return got


def slice_plan(srv, dev):
    """Phase 11 (b): phase 8's plan over ``ROWS``-row relations A, B and C
    on ``srv``: twice as mesh classes, then once on the kernel
    route.  Returns each submission's node surfaces, the compiled byte
    model and the plan cache's compiles and hits."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.data.synthetic import overlapping_relations

    rels = overlapping_relations([ROWS] * 3, 0.1,
                                 keys_per_dataset=KEYS_PER_DATASET, lam=10,
                                 seed=SEED, device=dev)
    for name, r in zip("ABC", rels):
        srv.register_dataset(name, [r])
    plan = make_plan(QueryBudget(error=0.01))
    subs = []
    t0 = time.perf_counter()
    for i, kernels in enumerate((False, False, True)):
        h = srv.submit_plan(plan, query_id=f"S{i}", seed=5 + i,
                            use_kernels=kernels)
        srv.run()
        subs.append({n: surface(r) for n, r in h.results().items()})
    return dict(nodes=subs, model=srv.compile_plan(plan).bytes_model,
                compiles=srv.diagnostics.plan_compiles,
                hits=srv.diagnostics.plan_cache_hits,
                seconds=time.perf_counter() - t0)


def slice_small(dev):
    from repro_torch.data.synthetic import overlapping_relations
    return {f"s{t}": overlapping_relations(
        [SMALL_ROWS, SMALL_ROWS], 0.1, keys_per_dataset=SMALL_KEYS, lam=10,
        seed=t, device=dev) for t in range(SMALL_TENANTS)}


def slice_requests(rounds):
    from repro_torch.runtime.join_serve import JoinRequest
    return [JoinRequest(dataset=ds, budget=b, query_id=q, seed=s,
                        max_strata=SMALL_STRATA, b_max=B_MAX)
            for ds, (q, b, s) in small_spec(rounds)]


def slice_fleet(torch, mesh, dev):
    """Phase 11 (c), the fleet: phase 6's small class as mesh classes on a
    sync mesh server (rounds 0-1 served, rounds 2-3 queued and
    snapshotted, then served), the snapshot restored into a meshless
    server on the card and served, and the whole workload through a front
    door of two mesh servers over the same ranks.  Returns the three's
    surfaces and the fleet's q/s."""
    from repro_torch.runtime.async_serve import AsyncJoinFrontDoor
    from repro_torch.runtime.join_serve import JoinServer

    small = slice_small(dev)
    srv = JoinServer(batch_slots=SLICE_FLEET_SLOTS, mesh=mesh)
    for name, r in small.items():
        srv.register_dataset(name, r)
    first = [srv.submit(q) for q in slice_requests(range(2))]
    srv.run()
    later = [srv.submit(q) for q in slice_requests(range(2, SMALL_ROUNDS))]
    flat, meta = srv.snapshot_state()
    srv.run()
    sync = [surface(q.result) for q in first + later]
    srv.shutdown()
    flat = {k: v.cpu().numpy() for k, v in flat.items()}
    dst = JoinServer(batch_slots=SLICE_FLEET_SLOTS)
    restored = dst.restore_state(flat, meta, device=dev)
    dst.run()
    fd = AsyncJoinFrontDoor(replicas=2, device=dev, engine_factory=lambda i:
                            JoinServer(batch_slots=SLICE_FLEET_SLOTS,
                                       mesh=mesh))
    try:
        for name, r in small.items():
            fd.register_dataset(name, r)
        torch.cuda.synchronize() if dev.type == "cuda" else None
        t0 = time.perf_counter()
        futs = [fd.submit(q) for q in slice_requests(range(SMALL_ROUNDS))]
        reqs = [f.result(timeout=SLICE_TIMEOUT_S) for f in futs]
        dt = time.perf_counter() - t0
        steals = fd.steals
    finally:
        fd.close(timeout=120)
    return dict(sync=sync, restored=[surface(q.result) for q in restored],
                later=[surface(q.result) for q in later],
                fleet=[surface(q.result) for q in reqs], seconds=dt,
                steals=steals)


def slice_drill(torch, mesh, rels):
    """Phase 11 (c), the drill: phase 9 (b)'s tumbling windows as mesh
    classes, an uninterrupted run on a sync mesh StreamJoinServer, then two
    mesh-server replicas checkpointing, replica0 killed after its second
    window and 2 more pushes; the successor restores onto the mesh."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.window import WindowSpec
    from repro_torch.runtime.async_serve import AsyncJoinFrontDoor
    from repro_torch.runtime.fault import InjectedFault
    from repro_torch.runtime.stream_join import StreamJoinServer

    spec = WindowSpec(DRILL_SIZE, DRILL_SIZE, STREAM_SUB_ROWS)
    mbs = slice_micro_batches(rels, STREAM_TICKS)
    kw = dict(budget=QueryBudget(error=0.01), max_strata=MAX_STRATA,
              b_max=B_MAX, seed=SEED)

    def engine():
        return StreamJoinServer(batch_slots=STREAM_SLOTS, mesh=mesh)
    base = engine()
    bsess = base.open_stream("D", spec, **kw)
    for mb in mbs:
        bsess.push(mb)
        base.run()
    baseline = {r.window_id: surface(r.result) for r in bsess.drain()}
    base.shutdown()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt11_")
    out = {}
    try:
        fd = AsyncJoinFrontDoor(
            replicas=2, checkpoint_dir=tmp, device=rels[0].keys.device,
            checkpoint_every_s=DRILL_CHECKPOINT_EVERY_S,
            engine_factory=lambda i: engine())
        try:
            rep, _ = fd.open_stream("D", spec, **kw)
            futs = [f for t in range(SLICE_DRILL_KILL)
                    for f in fd.push("D", mbs[t])]
            for f in futs:
                r = f.result(timeout=SLICE_TIMEOUT_S)
                out[r.window_id] = surface(r.result)
            rep.call(lambda: None).result(timeout=60)
            deadline = time.monotonic() + 60
            while rep._dirty and time.monotonic() < deadline:
                time.sleep(0.01)
            rep.kill_after(0)
            rep._thread.join(60)
            died = not rep._thread.is_alive() \
                and isinstance(rep.error, InjectedFault)
            fd.maybe_failover()
            for t in range(SLICE_DRILL_KILL, STREAM_TICKS):
                for f in fd.push("D", mbs[t]):
                    r = f.result(timeout=SLICE_TIMEOUT_S)
                    out[r.window_id] = surface(r.result)
            succ = next(r for r in fd.replicas if r.error is None)
            shed = succ.call(
                lambda: succ.engine.stream_diagnostics.windows_shed).result(
                    timeout=60)
            failovers, ckpts = fd.failovers, rep.stats["checkpoints"]
            dead_stopped = rep.engine._ranks is None
        finally:
            fd.close(timeout=120)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(baseline=baseline, out=out, shed=shed, failovers=failovers,
                died=died, checkpoints=ckpts, dead_stopped=dead_stopped)


def slice_rank(mesh, dev, data_dir, cfg):
    """One rank of phase 11's 2-rank mesh: rank 0 streams (a), serves the
    plan (b), the fleet and the drill (c) on mesh servers, the others
    serve them; then each rank holds the kernel calls it made at each
    shape against the plain versions.  Returns rank 0's results (the
    others' worker reports), this rank's kernel launches and its kept
    calls' checks."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.relation import relation
    from repro_torch.kernels import bloom_build, bloom_probe, edge_sample
    from repro_torch.runtime.join_serve import (JoinServer,
                                                close_mesh_workers,
                                                serve_mesh_worker)
    from repro_torch.runtime.stream_join import StreamJoinServer

    globals().update(cfg)          # the sizes a rehearsal shrinks
    wrappers = {"bloom_build": bloom_build.bloom_build_batched,
                "bloom_probe": bloom_probe.bloom_probe_batched,
                "edge_sample": edge_sample.edge_sample_batched}
    for w in wrappers.values():
        w.launches = 0
    kept, undo = keep_operands(torch)
    if dist.get_rank() != 0:
        report = serve_mesh_worker(mesh, dev)
        undo()
        return dict(worker=report,
                    launches={n: w.launches for n, w in wrappers.items()},
                    kernels=check_kept(torch, kept))
    try:
        rels = [relation(*(np.load(os.path.join(data_dir, f"{i}_{f}.npy"))
                           for f in ("keys", "values", "valid")), device=dev)
                for i in range(2)]
        srv = StreamJoinServer(batch_slots=STREAM_SLOTS,
                               window_slots=STREAM_WINDOW_SLOTS, mesh=mesh)
        stream = slice_stream(torch, srv, slice_micro_batches(
            rels, STREAM_TICKS), SLICE_SESSIONS)
        srv.shutdown()
        srv = JoinServer(batch_slots=SERVE_SLOTS, mesh=mesh)
        plan = slice_plan(srv, dev)
        plan["gathered"] = srv.host_gather_bytes
        srv.shutdown()
        t0 = time.perf_counter()
        fleet = slice_fleet(torch, mesh, dev)
        drill = slice_drill(torch, mesh, rels)
        fleet_s = time.perf_counter() - t0
    finally:
        close_mesh_workers()
        undo()
    launches = {n: w.launches for n, w in wrappers.items()}
    del rels, srv
    return dict(stream=stream, plan=plan, fleet=fleet, drill=drill,
                fleet_s=fleet_s, launches=launches,
                kernels=check_kept(torch, kept))


def check_slice_stream(label, got, want, k, note):
    """A mesh stream against the meshless one: E and K bit for bit (draws
    and words too), P within rtol 1e-5 of E with its buckets planned from
    the rolling overlap and its drops counted; the ranks hold the words of
    the live sub-windows only; the scatter bytes as reckoned."""
    windows = got["windows"]
    n_win = len(want["windows"]["E"])
    for name in ("E", "K"):
        check(len(windows[name]) == n_win, f"slice {label} {name}: "
              f"{len(windows[name])} windows, want {n_win}")
        for g, w in zip(windows[name], want["windows"][name]):
            check(g["surface"] == w["surface"]
                  and np.array_equal(g["n_sampled"], w["n_sampled"])
                  and g["words"] == w["words"],
                  f"slice {label} {name} window {g['w']}: {g['surface']} != "
                  f"the meshless stream's {w['surface']}")
    drops = [g["dropped"] for g in windows["P"]]
    for g, w in zip(windows["P"], want["windows"]["E"]):
        if g["dropped"] == 0:
            check(rtol_ok(g["surface"], w["surface"]),
                  f"slice {label} P window {g['w']}: {g['surface']} not "
                  f"within rtol 1e-5 of {w['surface']}")
    ewma = got["ewma"]["P"]
    caps = [g["cap"] for g in windows["P"]]
    check(ewma is not None and ewma < 1.0 and caps[-1] < caps[0]
          if k > 1 else ewma is not None,
          f"slice {label} P: overlap_ewma {ewma}, bucket caps {caps}")
    d = got["diag"]
    check(d["kernel_queries"] == n_win, f"slice {label}: kernel windows "
          f"{d['kernel_queries']}")
    check(d["kernel_gather_bytes"] == 0, f"slice {label}: the kernel "
          f"windows gathered {d['kernel_gather_bytes']} B")
    subs = (n_win - 1) + STREAM_SIZE
    sub_b = 2 * 12 * STREAM_SUB_ROWS * (k - 1) // k * subs
    model = got["model"]
    want_b = sub_b + n_win * (model["E"] + model["P"])
    check(got["scattered"] == want_b, f"slice {label}: scattered "
          f"{got['scattered']} B, reckoned {want_b}")
    live = got["live"]
    check(len(got["word_ids"]) == 2 * (STREAM_SIZE - 1)
          and all(w == got["word_ids"] and not r for r, w in live),
          f"slice {label}: the ranks hold {live}, the live sub-windows "
          f"{got['word_ids']}")
    wps = got["steady"] / got["seconds"]
    print(f"slice stream {label}{note}: {3 * n_win} windows of "
          f"{STREAM_SIZE} x {STREAM_SUB_ROWS} rows a side, the "
          f"{got['steady']} after the first tick in {got['seconds']:.3f} s = "
          f"{wps:.3f} windows/s; E and K bit for "
          f"bit with the meshless stream, P within rtol 1e-5 (drops "
          f"{drops}, overlap_ewma {ewma!r}, bucket caps {caps})")
    print(f"slice stream {label}: scatter {model['E']:.0f} B a plain window "
          f"(the model), {sub_b / subs:.0f} B a sub-window build; "
          f"{got['scattered']} B in all as reckoned; after the last retire "
          f"the ranks hold word ids {got['word_ids']} "
          f"({len(got['word_ids'])} = {STREAM_SIZE - 1} live sub-windows x "
          f"2 sides) and no relation")
    return wps


def slice_phase(rels, torch, wrappers):
    """Phase 11: the rest of the mesh.  (a) the streaming sessions at phase
    7's shape against a meshless StreamJoinServer, on mesh 1 over NCCL in
    this process and on 2 spawned ranks (NCCL a card a rank where there
    are 2 cards, else gloo sharing the one card); (b) the plan, (c) the
    fleet, a restore into a meshless server and the drill on the 2 ranks.
    Every kernel call of the phase is held against its plain version at
    each shape it took.  Returns each kernel's launches in the phase's
    mesh runs, and those checks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (init_ranks, make_host_mesh,
                                         run_ranks, stop_rank_server)
    from repro_torch.runtime.join_serve import JoinServer
    from repro_torch.runtime.stream_join import StreamJoinServer

    t_phase = time.perf_counter()
    dev = rels[0].keys.device
    card = dev.type == "cuda"
    mbs = slice_micro_batches(rels, STREAM_TICKS)
    kept, undo = keep_operands(torch)
    # -- the meshless references -------------------------------------------
    want = slice_stream(torch, StreamJoinServer(
        batch_slots=STREAM_SLOTS, window_slots=STREAM_WINDOW_SLOTS), mbs,
        [s for s in SLICE_SESSIONS if s[0] != "P"])
    print(f"slice: the meshless stream, {len(want['windows']['E'])} windows "
          f"a session, {want['steady']} after the first tick in "
          f"{want['seconds']:.3f} s = "
          f"{want['steady'] / want['seconds']:.3f} windows/s")
    plan_want = slice_plan(JoinServer(batch_slots=SERVE_SLOTS), dev)
    for w in wrappers.values():
        w.launches = 0
    # -- (a) mesh 1 over NCCL, this process ----------------------------------
    tmp = tempfile.mkdtemp(prefix="mesh11-")
    init_ranks(0, 1, backend="nccl" if card else "gloo", device=dev,
               store_path=os.path.join(tmp, "store"),
               timeout_s=MESH_TIMEOUT_S)
    try:
        srv = StreamJoinServer(batch_slots=STREAM_SLOTS,
                               window_slots=STREAM_WINDOW_SLOTS,
                               mesh=make_host_mesh(1, 1))
        one = slice_stream(torch, srv, mbs, SLICE_SESSIONS)
        srv.shutdown()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        undo()
    launches = {n: w.launches for n, w in wrappers.items()}
    wps = {1: check_slice_stream("1/nccl" if card else "1/gloo", one, want,
                                 1, "")}
    # the kernel calls of the references and of mesh 1, against plain
    calls = check_kept(torch, kept)
    check_kept_calls("this process", calls)
    del kept
    # -- 2 ranks: (a), (b) and (c) ---------------------------------------------
    if card:
        torch.cuda.empty_cache()
    nccl = card and torch.cuda.device_count() >= 2
    backend = "nccl" if nccl else "gloo"
    note = " (nccl, a card a rank)" if nccl else \
        " (gloo through the host, one card)" if card else " (gloo, CPU)"
    cfg = {k: globals()[k] for k in (
        "ROWS", "KEYS_PER_DATASET", "MAX_STRATA", "B_MAX", "SERVE_SLOTS",
        "SMALL_ROWS", "SMALL_KEYS", "SMALL_STRATA", "STREAM_SUB_ROWS",
        "STREAM_TICKS")}
    try:
        with tempfile.TemporaryDirectory(prefix="mesh11-data-") as data_dir:
            for i, r in enumerate(rels):
                np.save(os.path.join(data_dir, f"{i}_keys.npy"),
                        r.keys.cpu().numpy().astype(np.uint32))
                np.save(os.path.join(data_dir, f"{i}_values.npy"),
                        r.values.cpu().numpy())
                np.save(os.path.join(data_dir, f"{i}_valid.npy"),
                        r.valid.cpu().numpy())
            t0 = time.perf_counter()
            ranks = run_ranks(slice_rank, 2, (data_dir, cfg),
                              backend=backend, device=dev.type,
                              timeout_s=SLICE_TIMEOUT_S)
            spawn_s = time.perf_counter() - t0
    finally:
        stop_rank_server()
    label = f"2/{backend}"
    got = ranks[0]
    for r in ranks:
        for n, c in r["launches"].items():
            launches[n] += c
    check(all(r["worker"].open == () for r in ranks[1:]),
          f"slice {label}: a worker still held a server's state at close")
    for i, r in enumerate(ranks):
        check_kept_calls(f"{label} rank {i}", r["kernels"])
        calls += r["kernels"]
    wps[2] = check_slice_stream(label, got["stream"], want, 2, note)
    # (b) the plan
    plan = got["plan"]
    for i, (g, w) in enumerate(zip(plan["nodes"], plan_want["nodes"])):
        check(g == w, f"slice {label} plan submission {i}: {g} != the "
              f"meshless server's {w}")
    check(plan["model"] == plan_want["model"],
          f"slice {label}: the compiled byte model differs from the "
          f"meshless one")
    check((plan["compiles"], plan["hits"]) == (plan_want["compiles"],
                                               plan_want["hits"]) == (1, 3),
          f"slice {label}: plan compiles/hits {plan['compiles']}/"
          f"{plan['hits']}, meshless {plan_want['compiles']}/"
          f"{plan_want['hits']}")
    print(f"slice plan {label}{note}: 3 submissions (mesh classes twice, "
          f"then the kernel route) of 2 nodes over 3 x {ROWS} rows in "
          f"{plan['seconds']:.3f} s, every node bit for bit with the "
          f"meshless server's; byte model equal; 1 compile, then 3 cache "
          f"hits; the model's rows gathered once: {plan['gathered']:.0f} B")
    # (c) the fleet, the restore and the drill
    fleet = got["fleet"]
    check(fleet["fleet"] == fleet["sync"], f"slice {label}: the mesh "
          f"fleet's results != the sync mesh server's")
    check(fleet["restored"] == fleet["later"], f"slice {label}: the "
          f"meshless server restored from the mesh's snapshot served "
          f"{fleet['restored']} != {fleet['later']}")
    n_fleet = len(fleet["fleet"])
    print(f"slice fleet {label}{note}: {n_fleet} small-class requests "
          f"through 2 mesh-server replicas in {fleet['seconds']:.3f} s = "
          f"{n_fleet / fleet['seconds']:.3f} q/s (steals {fleet['steals']}),"
          f" bit for bit with the sync mesh server; its snapshot of "
          f"{len(fleet['later'])} queued requests restored into a meshless "
          f"server served them bit for bit")
    drill = got["drill"]
    n_win = STREAM_TICKS // DRILL_SIZE
    check(drill["died"] and drill["failovers"] == 1 and drill["shed"] == 0
          and drill["dead_stopped"],
          f"slice {label} drill: died {drill['died']}, failovers "
          f"{drill['failovers']}, shed {drill['shed']}, dead server "
          f"stopped {drill['dead_stopped']}")
    check(sorted(drill["out"]) == sorted(drill["baseline"])
          == list(range(n_win)) and drill["out"] == drill["baseline"],
          f"slice {label} drill: windows {drill['out']} != the "
          f"uninterrupted run's {drill['baseline']}")
    print(f"slice drill {label}{note}: replica0 killed after "
          f"{DRILL_KILL_WINDOWS} of {n_win} windows and {DRILL_MID_PUSHES} "
          f"pushes, {drill['checkpoints']} "
          f"checkpoints; 1 failover onto the mesh, 0 shed, every window "
          f"bit for bit with the uninterrupted mesh run; the fleet, restore "
          f"and drill took {got['fleet_s']:.1f} s")
    print(f"slice: windows/s by mesh size {wps} (mesh 2{note}); the 2 ranks "
          f"ran in {spawn_s:.1f} s; launches {launches}; phase 11 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    for name, n in launches.items():
        check(n > 0, f"slice: {name} never launched in phase 11")
    return launches, calls


# phase 12: the model stack's forward and decode (``repro_torch.models``).
# (a) qwen3-1.7b whole: a forward of [2, 4096] tokens (the chunked
# attention), then 8 sequences decoded for 128 steps from an empty cache of
# 4,096 positions; (b) the other nine configs at full width with their
# depth cut (``model_cut``); (c) every config's ``reduced()`` form on the
# card against the CPU; (d) the three join examples on the card.
MODEL_MAIN = "qwen3-1.7b"
MODEL_PREFILL = (2, 4096)
MODEL_DECODE = (8, 128)          # sequences, steps
MODEL_MAX_SEQ = 4096
MODEL_PROFILE_STEPS = 16
OTHER_PREFILL = (2, 512)
OTHER_DECODE = (2, 32)
SMALL_MODEL = (2, 16)            # (c): batch, tokens and decode steps
# a decode step's logits against the teacher-forced forward's, relative to
# the latter's largest magnitude: the reference's own bound
# (tests/test_models.py); the card against the CPU in bf16 (the mean and
# the largest difference) and in float32, as the CPU tests hold the port to
# the JAX package (tests/torch_models_parity.py)
DECODE_BOUND = 0.08
BF16_MEAN, BF16_MAX = 2e-2, 0.08
F32_TOL = {"ssm": 1e-3, "hybrid": 1e-3}   # by family; 1e-4 otherwise
EXAMPLES = ("torch_quickstart", "torch_network_flows", "torch_tpch_budget")
EXAMPLE_TIMEOUT_S = 300


def model_cut(cfg):
    """(the config phase 12 (b) runs, the cut as words): full width, depth
    cut to two pattern periods, one for a pattern of three; whisper
    whole."""
    import dataclasses
    if cfg.is_encdec:
        return cfg, (f"whole: {cfg.encoder.n_layers} + {cfg.n_layers} layers,"
                     f" {cfg.encoder.n_frames} frames")
    period = len(cfg.mixer_pattern)
    n = period * (1 if period >= 3 else 2)
    return dataclasses.replace(cfg, n_layers=n), \
        f"depth {cfg.n_layers} -> {n} ({n // period} x {cfg.mixer_pattern})"


def model_inputs(torch, cfg, B, T, gen):
    """Random tokens and the stub frontends' inputs, on the card."""
    from repro_torch.models.model import CLIP_DIM
    dev = gen.device
    b = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                 device=dev)}
    if cfg.num_img_tokens:
        b["img_embeds"] = torch.randn((B, cfg.num_img_tokens, CLIP_DIM),
                                      generator=gen, device=dev)
    if cfg.is_encdec:
        e = cfg.encoder
        b["frames"] = torch.randn((B, e.n_frames, e.d_input), generator=gen,
                                  device=dev)
    return b


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (dicts, lists, tuples; other leaves,
    such as a cache's flags, hold none)."""
    if hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    if not isinstance(tree, (dict, list, tuple)):
        return 0
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(tensor_bytes(t) for t in items)


def decode_errors(torch, model, b, steps, max_seq):
    """Largest error of ``steps`` decode steps' logits from an empty cache
    against the teacher-forced forward's at each position (its largest
    magnitude the scale), as a float; and whether all are finite.  A VLM
    decodes without its image prefix, so its forward is the text-only one
    of the same weights."""
    import dataclasses
    cfg = model.cfg
    toks = b["tokens"][:, :steps]
    model.cfg = dataclasses.replace(cfg, num_img_tokens=0)
    try:
        with torch.inference_mode():
            want, _ = model.forward({**b, "tokens": toks})
    finally:
        model.cfg = cfg
    cache = model.init_cache(toks.shape[0], max_seq, b.get("frames"))
    errs = torch.empty(steps, device=toks.device)
    finite = torch.ones((), dtype=torch.bool, device=toks.device)
    for t in range(steps):
        got, cache = model.decode_step(toks[:, t], cache)
        w = want[:, t]
        errs[t] = (got - w).abs().max() / w.abs().max()
        finite &= torch.isfinite(got).all()
    return float(errs.max()), bool(finite)


def main_model(torch, gen):
    """Phase 12 (a): qwen3-1.7b whole on the card."""
    from repro_torch.models import ARCHS, Model
    cfg = ARCHS[MODEL_MAIN]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    weights = tensor_bytes(list(model.parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {MODEL_MAIN}: {cfg.n_layers} layers, d_model {cfg.d_model},"
          f" {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, attn_chunk {cfg.attn_chunk}: "
          f"{n_params} float32 parameters ({weights / 1e9:.3f} GB) "
          f"initialised on the card in {time.perf_counter() - t0:.3f} s")
    out = {"arch": MODEL_MAIN, "params": n_params, "weight_bytes": weights}
    # prefill: the first forward pays the library's set-up, the second is
    # the steady one
    B, T = MODEL_PREFILL
    b = model_inputs(torch, cfg, B, T, gen)
    for rnd in ("first", "warm"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = model.forward(b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(tuple(logits.shape) == (B, T, cfg.vocab),
              f"model prefill: logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()),
              "model prefill: logits not finite")
        del logits
        print(f"model prefill {rnd} [{B}, {T}]: {dt:.4f} s = "
              f"{B * T / dt:.1f} tokens/s; peak device memory "
              f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} above the "
              f"weights' {weights / 1e9:.3f} GB)")
    out.update(prefill_s=dt, prefill_tokens_per_s=B * T / dt,
               prefill_peak_bytes=peak)
    # decode: 8 sequences from an empty cache of 4,096 positions, every
    # step held against the forward over the same 128 tokens, in float32
    # (the port's compute dtype switched, the cache's with it); in bf16 the
    # two paths' rounding steps, amplified through 28 layers, part them by
    # more than the bound (PERF.md), so the bf16 figure is printed
    B, steps = MODEL_DECODE
    b = model_inputs(torch, cfg, B, steps, gen)
    with compute_dtype(torch.float32):
        err, finite = decode_errors(torch, model, b, steps, MODEL_MAX_SEQ)
    check(finite, "model decode: float32 logits not finite")
    check(err < DECODE_BOUND, f"model decode: a step's float32 logits {err} "
          f"of the scale from the forward's (bound {DECODE_BOUND})")
    err16, finite = decode_errors(torch, model, b, steps, MODEL_MAX_SEQ)
    check(finite, "model decode: bf16 logits not finite")
    torch.cuda.empty_cache()

    def loop(n):
        cache = model.init_cache(B, MODEL_MAX_SEQ)
        for t in range(n):
            _, cache = model.decode_step(b["tokens"][:, t], cache)
        torch.cuda.synchronize()
        return cache

    cache_bytes = tensor_bytes(model.cache_shape(B, MODEL_MAX_SEQ)["blocks"])
    loop(4)                         # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop(steps)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = dt / steps * 1e3
    print(f"model decode [{B} sequences, {steps} steps, cache of "
          f"{MODEL_MAX_SEQ}]: {step_ms:.4f} ms a step = {B * steps / dt:.1f}"
          f" tokens/s; every step's logits within {err:.4g} of the "
          f"forward's scale in float32 (bound {DECODE_BOUND}), {err16:.4g} "
          f"in bf16 (not held); peak device memory "
          f"{peak / 1e9:.3f} GB against the weights' {weights / 1e9:.3f} GB "
          f"+ the cache's {cache_bytes / 1e9:.3f} GB")
    wall_us, by_name = device_profile(
        torch, lambda: loop(MODEL_PROFILE_STEPS))
    busy = sum(us for us, _ in by_name.values())
    if by_name:
        print(f"model decode profile ({MODEL_PROFILE_STEPS} steps): wall "
              f"{wall_us / 1e3:.3f} ms under the profiler, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
              f"{sum(n for _, n in by_name.values())} device events")
        for name, (us, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
            print(f"  {us / 1e3:9.4f} ms {n:6d}x  {name[:90]}")
    else:
        print("model decode profile: the profiler recorded no device time "
              "(not measured)")
    out.update(decode_ms_per_step=step_ms, decode_tokens_per_s=B * steps / dt,
               decode_max_err=err, decode_max_err_bf16=err16,
               decode_peak_bytes=peak,
               cache_bytes=cache_bytes,
               decode_busy_share=busy / wall_us if by_name else None)
    return out


def other_models(torch, gen):
    """Phase 12 (b): the other nine configs at full width, depth cut."""
    from repro_torch.models import ARCHS, Model
    out = {}
    for name, full in ARCHS.items():
        if name == MODEL_MAIN:
            continue
        cfg, cut = model_cut(full)
        print(f"model cut {name}: {cut}")
        torch.cuda.empty_cache()
        model = Model(cfg, device="cuda", generator=gen)
        weights = tensor_bytes(list(model.parameters()))
        B, T = OTHER_PREFILL
        b = model_inputs(torch, cfg, B, T, gen)
        with torch.inference_mode():
            model.forward(b)                # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, aux = model.forward(b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(tuple(logits.shape) == (B, T, cfg.vocab),
              f"model {name}: logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()),
              f"model {name}: logits not finite")
        del logits
        moe = (f", moe overflow {int(aux['moe_overflow'])}"
               if "moe_overflow" in aux else "")
        Bd, steps = OTHER_DECODE
        bd = model_inputs(torch, cfg, Bd, steps, gen)
        errs = {}
        for label, dtype in (("float32", torch.float32),
                             ("bf16", torch.bfloat16)):
            with compute_dtype(dtype):
                err, finite = decode_errors(torch, model, bd, steps, steps)
            check(finite, f"model {name} decode: {label} logits not finite")
            # in bf16 a rounding step can flip an MoE's top-k choice between
            # the two paths: its bf16 figure is printed, not held
            check(err < DECODE_BOUND or (label == "bf16" and cfg.moe),
                  f"model {name} decode: a step's {label} logits {err} of "
                  f"the scale from the forward's")
            errs[label] = err
        prefix = (f" (+{cfg.num_img_tokens} image tokens)"
                  if cfg.num_img_tokens else "")
        print(f"model {name}: {weights / 1e9:.3f} GB of weights; forward "
              f"[{B}, {T}]{prefix} {dt:.4f} s = {B * T / dt:.1f} tokens/s, "
              f"peak {peak / 1e9:.3f} GB{moe}; {steps} decode steps of {Bd} "
              f"within {errs['float32']:.4g} (float32) and "
              f"{errs['bf16']:.4g} (bf16{', not held' if cfg.moe else ''}) "
              f"of the forward's scale")
        out[name] = {"cut": cut, "forward_s": dt, "peak_bytes": peak,
                     "decode_max_err": errs}
        del model
    return out


class compute_dtype:
    """Both the card and the CPU compute in ``dtype`` (the port's module
    constants; the KV cache's dtype is bound as a default)."""

    def __init__(self, dtype):
        from repro_torch.models import layers, moe, rglru, ssm
        self.mods, self.dtype = (layers, moe, ssm, rglru), dtype
        self.layers = layers

    def __enter__(self):
        self.saved = [m.COMPUTE_DTYPE for m in self.mods]
        self.defaults = self.layers.init_kv_cache.__defaults__
        for m in self.mods:
            m.COMPUTE_DTYPE = self.dtype
        self.layers.init_kv_cache.__defaults__ = (self.dtype, "cuda")

    def __exit__(self, *exc):
        for m, d in zip(self.mods, self.saved):
            m.COMPUTE_DTYPE = d
        self.layers.init_kv_cache.__defaults__ = self.defaults


def small_models_card_vs_cpu(torch):
    """Phase 12 (c): every config's ``reduced()`` form, weights made on the
    CPU from a seed, carried to the card through the JAX package's pytree
    layout (``params_to_jax`` / ``params_from_jax``), forward and decode on
    both; float32 at the CPU tests' tight tolerance, bf16 at their loose
    one (the MoE configs in float32 only: a bf16 rounding step can flip a
    top-k expert choice)."""
    from repro_torch.models import ARCHS, Model
    from repro_torch.models.convert import params_from_jax, params_to_jax
    worst = {}
    for i, (name, full) in enumerate(ARCHS.items()):
        cfg = full.reduced()
        cpu = Model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(SEED + i))
        card = params_from_jax(cfg, params_to_jax(cpu), device="cuda")
        B, T = SMALL_MODEL
        b = model_inputs(torch, cfg, B, T,
                         torch.Generator().manual_seed(SEED + i))
        dtypes = [("float32", torch.float32)] + (
            [] if cfg.moe else [("bf16", torch.bfloat16)])
        for label, dtype in dtypes:
            with compute_dtype(dtype):
                got = [x.cpu() for x in run_small(
                    torch, card, {k: v.cuda() for k, v in b.items()}, T)]
                want = run_small(torch, cpu, b, T)
            errs = []
            for w, g in zip(want, got):
                d = (g.double() - w.double()).abs()
                scale = float(w.abs().max())
                errs.append((float(d.max()) / scale, float(d.mean()) / scale))
            if label == "float32":
                tol = F32_TOL.get(cfg.family, 1e-4)
                ok = all(e <= tol for e, _ in errs)
            else:
                ok = all(e <= BF16_MAX and m <= BF16_MEAN for e, m in errs)
            check(ok, f"model {name} reduced, {label}: card against CPU "
                  f"(largest, mean) of forward and decode {errs}")
            worst[f"{name}/{label}"] = max(e for e, _ in errs)
    print(f"model reduced configs, card against CPU (largest error of "
          f"forward and decode logits over their scale): "
          f"{json.dumps(worst)}")
    return worst


def run_small(torch, model, b, steps):
    """(forward logits, ``steps`` decode steps' logits) of ``model``."""
    with torch.inference_mode():
        logits, _ = model.forward(b)
    cache = model.init_cache(b["tokens"].shape[0], steps, b.get("frames"))
    dec = []
    for t in range(steps):
        step, cache = model.decode_step(b["tokens"][:, t], cache)
        dec.append(step)
    return logits, torch.stack(dec, 1)


def run_examples(torch):
    """Phase 12 (d): the three join examples, each a process on the card,
    all at once; each must exit 0 and print its own check."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", f"{name}.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env) for name in EXAMPLES}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=EXAMPLE_TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    kind = torch.cuda.get_device_name(0)
    for name, (stdout, stderr) in outs.items():
        rc = procs[name].returncode
        check(rc == 0, f"example {name} exited {rc}: {stderr[-2000:]}")
        check(stdout.startswith(f"on {kind}"),
              f"example {name} did not run on the card: {stdout[:200]}")
        check("[OK]" in stdout, f"example {name} printed no check")
        for line in stdout.strip().splitlines():
            print(f"  {name}: {line}")
    print(f"examples: {len(outs)} on the card in "
          f"{time.perf_counter() - t0:.1f} s, each exited 0 with its check")


def model_phase(torch):
    """Phase 12: the model stack's forward and decode on the card, and the
    join examples.  Returns the numbers it printed."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"main": main_model(torch, gen)}
    torch.cuda.empty_cache()
    out["others"] = other_models(torch, gen)
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = small_models_card_vs_cpu(torch)
    run_examples(torch)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"model: no kernel of the port runs on this path; phase 12 took "
          f"{out['seconds']:.1f} s")
    print(f"model summary: {json.dumps(out)}")
    return out


# phase 13: training (``repro_torch.runtime.train``; no kernel of the port).
# (a) qwen3-1.7b whole, 8 AdamW steps on structured ``lm_batch`` of
# [2, 4096] (phase 12's prefill shape) under block remat; (b) the other
# nine configs at phase 12's cut depths, 2 steps of [2, 512]; (c) one
# ``reduced()`` config a family on the card against the CPU in float32;
# (d) data parallelism, 2 gloo ranks sharing the card, plain, int8-EF and
# ZeRO-1 (AdamW's slots cut over the data ranks);
# (e) the train launcher killed after its step-6 checkpoint and resumed;
# (f) ``examples/torch_train_lm.py`` (~100M parameters, 300 steps).
TRAIN_MAIN = "qwen3-1.7b"
TRAIN_BATCH = (2, 4096)
TRAIN_STEPS = 8
TRAIN_WARM = slice(2, None)       # steps 3-8: the warm step time
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 3e-4, 2, 10
TRAIN_OTHER = (2, 512)
TRAIN_OTHER_STEPS = 2
TRAIN_FAMILIES = {"dense": "qwen3-1.7b", "moe": "qwen2-moe-a2.7b",
                  "ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-2b",
                  "vlm": "phi-3-vision-4.2b", "audio": "whisper-small"}
TRAIN_SMALL = (2, 16)
TRAIN_GRAD_TOL = 1e-4             # card against CPU, of a leaf's scale
DP_ARCH = "qwen2-0.5b"
DP_BATCH = (4, 512)               # global [B, T]; 2 rows a rank
DP_PLAIN_STEPS, DP_EF_STEPS = 3, 10
DP_RTOL, DP_ATOL = 5e-3, 5e-4     # tests/test_torch_train_distributed.py
# ZeRO-1 against plain DP on the same ranks (tests/test_torch_zero1.py):
# params rtol 1e-5, atol 1e-6 (a bias that starts at 0 moves by steps whose
# size follows grads below AdamW's eps)
ZERO1_RTOL, ZERO1_ATOL = 1e-5, 1e-6
DP_EF_LR = 1e-3
DP_TIMEOUT_S = 300
RESUME_ARGS = ("--arch", "qwen2-0.5b", "--reduced", "--steps", "12",
               "--ckpt-every", "6")
TRAIN_EXAMPLE_TIMEOUT_S = 300


def lm_inputs(torch, cfg, B, T, step, gen):
    """Structured ``lm_batch`` tokens and targets of ``step``, with the
    stub frontends' random inputs, on the generator's device."""
    from repro_torch.data.pipeline import lm_batch
    b = model_inputs(torch, cfg, B, T, gen)
    b.update(lm_batch(step, 0, batch=B, seq=T, vocab=cfg.vocab,
                      structured=True, device=gen.device))
    return b


def train_main(torch, gen):
    """Phase 13 (a): qwen3-1.7b whole, trained on the card."""
    from repro_torch.models import ARCHS, Model
    from repro_torch.optim.adamw import adamw_update, cosine_schedule
    from repro_torch.runtime.train import make_train_step, train_state_init
    cfg = ARCHS[TRAIN_MAIN]
    check(cfg.remat == "block", f"train: {TRAIN_MAIN} remat {cfg.remat}")
    torch.cuda.empty_cache()
    model = Model(cfg, device="cuda", generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    weights = tensor_bytes(list(model.parameters()))
    state_bytes = 4 * weights          # params, grads, m, v
    step = make_train_step(model, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_TOTAL)
    state = train_state_init(model)
    B, T = TRAIN_BATCH
    batches = [lm_inputs(torch, cfg, B, T, i, gen)
               for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, gnorms = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"train {TRAIN_MAIN}: losses {losses}, grad norms {gnorms}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"train {TRAIN_MAIN}: the loss did not fall: {losses}")
    warm = statistics.median(times[TRAIN_WARM])
    print(f"train {TRAIN_MAIN}: {cfg.n_layers} layers, {n_params} float32 "
          f"parameters, remat {cfg.remat}; {TRAIN_STEPS} steps of [{B}, {T}]"
          f" (lr {TRAIN_LR}, warmup {TRAIN_WARMUP}, total {TRAIN_TOTAL}): "
          f"step times {[round(t, 4) for t in times]} s, warm (median of "
          f"steps 3-{TRAIN_STEPS}) {warm:.4f} s = {B * T / warm:.1f} "
          f"tokens/s; losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in gnorms]}; peak device memory "
          f"{peak / 1e9:.3f} GB against params + grads + m + v "
          f"{state_bytes / 1e9:.3f} GB")
    # the AdamW update alone, on this step's grads (CUDA events, 3 calls)
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss(batches[0])
    loss.backward()
    grads = {k: p.grad for k, p in state.params.items()}
    lr_fn = cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL)
    opt_ms = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        _, opt, _ = adamw_update(state.params, grads, state.opt,
                                 lr_fn=lr_fn)
        ev[1].record()
        torch.cuda.synchronize()
        opt_ms.append(ev[0].elapsed_time(ev[1]))
        state = state._replace(opt=opt)
    del grads
    for p in model.parameters():
        p.grad = None
    opt_bytes = 12 * weights           # read p, g, m, v; write p, m, v
    print(f"train {TRAIN_MAIN} AdamW update alone: {[round(t, 4) for t in opt_ms]}"
          f" ms over {len(state.params)} leaves; its least traffic "
          f"{opt_bytes / 1e9:.3f} GB = {opt_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
          f" ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"{100 * statistics.median(opt_ms) / 1e3 / warm:.2f}% of a warm "
          f"step")
    # one profiled step: the device's busy share and its top ops
    b = batches[-1]

    def one():
        nonlocal state
        state, _ = step(state, b)
        torch.cuda.synchronize()
    wall_us, by_name = device_profile(torch, one)
    busy = sum(us for us, _ in by_name.values())
    if by_name:
        print(f"train {TRAIN_MAIN} profile (1 step): wall {wall_us / 1e3:.3f}"
              f" ms under the profiler, device busy {busy / 1e3:.3f} ms "
              f"({100 * busy / wall_us:.1f}%), "
              f"{sum(n for _, n in by_name.values())} device events")
        for name, (us, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:10]:
            print(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:90]}")
    else:
        print(f"train {TRAIN_MAIN} profile: the profiler recorded no device "
              f"time (not measured)")
    by_op = op_profile(torch, one)
    if by_op:
        print(f"train {TRAIN_MAIN} profile (1 more step) by PyTorch op, "
              f"self device time:")
        for name, (us, n) in list(by_op.items())[:12]:
            print(f"  {us / 1e3:9.3f} ms {n:6d}x  {name}")
    out = {"arch": TRAIN_MAIN, "params": n_params, "step_s": times,
           "warm_step_s": warm, "tokens_per_s": B * T / warm,
           "losses": losses, "grad_norms": gnorms, "peak_bytes": peak,
           "state_bytes": state_bytes, "adamw_ms": opt_ms,
           "busy_share": busy / wall_us if by_name else None}
    del state, step, model, batches
    return out


def op_profile(torch, run) -> dict:
    """{PyTorch op: (self device microseconds, calls)} of one ``run()``
    from torch.profiler's ``key_averages``, largest first; empty when the
    profiler saw no device."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    ops = [(e.key, getattr(e, "self_device_time_total", 0.0), e.count)
           for e in prof.key_averages()]
    return {k: (us, n) for k, us, n in sorted(ops, key=lambda o: -o[1])
            if us > 0}


def train_others(torch, gen):
    """Phase 13 (b): the other nine configs at phase 12's cut depths."""
    from repro_torch.models import ARCHS, Model
    from repro_torch.runtime.train import make_train_step, train_state_init
    out = {}
    B, T = TRAIN_OTHER
    for name, full in ARCHS.items():
        if name == TRAIN_MAIN:
            continue
        cfg, cut = model_cut(full)
        torch.cuda.empty_cache()
        model = Model(cfg, device="cuda", generator=gen)
        step = make_train_step(model, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                               total_steps=TRAIN_TOTAL)
        state = train_state_init(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses, gnorms = [], [], []
        for i in range(TRAIN_OTHER_STEPS):
            b = lm_inputs(torch, cfg, B, T, i, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        peak = torch.cuda.max_memory_allocated()
        # a non-finite grad anywhere makes the global norm non-finite
        check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
              f"train {name}: losses {losses}, grad norms {gnorms}")
        zero = None
        if name == "recurrentgemma-2b":
            loss, _ = model.loss(lm_inputs(torch, cfg, B, T, 0, gen))
            loss.backward()
            zero = [k for k, p in model.named_parameters()
                    if not bool(torch.isfinite(p.grad).all())
                    or float(p.grad.abs().max()) == 0.0]
            check(zero == [], f"train {name}: leaves with a zero or "
                  f"non-finite grad: {zero}")
        print(f"train {name} ({cut}): {TRAIN_OTHER_STEPS} steps of [{B}, {T}]"
              f" in {[round(t, 4) for t in times]} s, losses "
              f"{[round(x, 4) for x in losses]}, grad norms "
              f"{[round(x, 4) for x in gnorms]}, peak {peak / 1e9:.3f} GB"
              + ("; every leaf's grad nonzero and finite"
                 if zero == [] else ""))
        out[name] = {"cut": cut, "step_s": times, "losses": losses,
                     "peak_bytes": peak}
        del state, step, model
    return out


def train_card_vs_cpu(torch):
    """Phase 13 (c): one ``reduced()`` config a family, the same weights
    on the card and the CPU, one step's loss and grads in float32."""
    from repro_torch.models import ARCHS, Model
    from repro_torch.models.convert import params_from_jax, params_to_jax
    worst = {}
    B, T = TRAIN_SMALL
    for i, (family, name) in enumerate(TRAIN_FAMILIES.items()):
        cfg = ARCHS[name].reduced()
        gen = torch.Generator().manual_seed(SEED + i)
        cpu = Model(cfg, device="cpu", generator=gen)
        card = params_from_jax(cfg, params_to_jax(cpu), device="cuda")
        b = lm_inputs(torch, cfg, B, T, i, gen)
        res = []
        with compute_dtype(torch.float32):
            for model, batch in ((cpu, b), (card, {k: v.cuda()
                                                   for k, v in b.items()})):
                loss, _ = model.loss(batch)
                loss.backward()
                res.append((float(loss.detach()), {k: p.grad.double().cpu()
                                          for k, p in
                                          model.named_parameters()}))
        (lc, gc), (lg, gg) = res
        loss_err = abs(lg - lc) / abs(lc)
        grad_err = max(float((gg[k] - w).abs().max())
                       / (float(w.abs().max()) or 1.0)
                       for k, w in gc.items())
        check(loss_err <= 1e-5, f"train {name} reduced: loss on the card "
              f"{lg!r} against the CPU's {lc!r}")
        check(grad_err <= TRAIN_GRAD_TOL, f"train {name} reduced: a grad "
              f"{grad_err} of its leaf's scale from the CPU's")
        worst[f"{family}/{name}"] = {"loss": loss_err, "grads": grad_err}
    print(f"train reduced configs, card against CPU in float32 (loss "
          f"relative error; largest grad error over its leaf's scale, "
          f"bound {TRAIN_GRAD_TOL}): {json.dumps(worst)}")
    return worst


def train_rank(mesh, dev, runs):
    """One rank of phase 13 (d): each run of ``runs`` in turn (``(cfg,
    steps, lr, mode, B, T)``: ``steps`` steps of ``cfg`` on this rank's
    rows of the global [B, T] batch, in float32 compute, ``mode`` "plain",
    "int8-EF" or "zero1"); with ``mesh`` None, one process on the whole
    batch.  Returns, a run, the losses, the params, the residuals' sum, the
    ``COMM`` meters, the seconds, the AdamW slots' bytes on this rank and
    this process's peak of card memory over the run."""
    import torch
    from repro_torch.core.distributed import COMM
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import Model
    from repro_torch.runtime.train import make_train_step, train_state_init
    group = None if mesh is None else mesh.get_group("data")
    rank = 0 if group is None else group.rank()
    world = 1 if group is None else group.size()
    out = []
    for cfg, steps, lr, mode, B, T in runs:
        compress, zero1 = mode == "int8-EF", mode == "zero1"
        torch.cuda.reset_peak_memory_stats(dev)
        with compute_dtype(torch.float32):
            model = Model(cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED))
            kw = {} if group is None else {
                "compress_group" if compress else "data_group": group}
            step = make_train_step(model, lr=lr, warmup=TRAIN_WARMUP,
                                   total_steps=steps, zero1=zero1, **kw)
            state = train_state_init(model, compress=compress, zero1=zero1,
                                     data_group=group)
            batch_fn = make_batch_fn(cfg, B, T, SEED, device=dev, rank=rank,
                                     world=world)
            COMM.reset()
            losses = []
            t0 = time.perf_counter()
            for i in range(steps):
                state, m = step(state, batch_fn(i))
                losses.append(float(m["loss"]))
            seconds = time.perf_counter() - t0
        ef = state.ef_error or {}
        out.append({"losses": losses, "seconds": seconds,
                    "params": {k: p.detach().cpu().numpy()
                               for k, p in state.params.items()},
                    "ef_abs": float(sum(float(e.abs().sum())
                                        for e in ef.values())),
                    "comm": COMM.snapshot(),
                    "slot_bytes": sum(t.numel() * t.element_size()
                                      for f in (state.opt.m, state.opt.v)
                                      for t in f.values()),
                    "peak_bytes": torch.cuda.max_memory_allocated(dev)})
        # the next run's peak must not hold this one's residuals
        del state, step, model, ef
    return out


def train_dp(torch, dev="cuda"):
    """Phase 13 (d): 2 gloo ranks sharing the card (``dev``), plain DP
    against one process on the whole batch, int8-EF DP, and ZeRO-1 DP
    against plain; each mode's collective bytes per rank and step, and
    ZeRO-1's slots and peak against plain's."""
    from repro_torch.launch.mesh import run_ranks, stop_rank_server
    from repro_torch.models import ARCHS
    cfg, cut = model_cut(ARCHS[DP_ARCH])
    B, T = DP_BATCH
    plain_run = (cfg, DP_PLAIN_STEPS, TRAIN_LR, "plain", B, T)
    ef_run = (cfg, DP_EF_STEPS, DP_EF_LR, "int8-EF", B, T)
    zero1_run = (cfg, DP_PLAIN_STEPS, TRAIN_LR, "zero1", B, T)
    torch.cuda.empty_cache()
    one, = train_rank(None, torch.device(dev), [plain_run])
    try:
        ranks = run_ranks(train_rank, 2, ([plain_run, ef_run, zero1_run],),
                          backend="gloo", device=dev,
                          timeout_s=DP_TIMEOUT_S)
    finally:
        stop_rank_server()
    plain, ef, zero1 = ([r[i] for r in ranks] for i in range(3))
    n = sum(v.size for v in one["params"].values())
    worst = 0.0
    for k, want in one["params"].items():
        got = plain[0]["params"][k]
        check(np.array_equal(got, plain[1]["params"][k]),
              f"train dp: the ranks' {k} differ")
        check(np.allclose(got, want, rtol=DP_RTOL, atol=DP_ATOL),
              f"train dp: {k} off the one-process run's by "
              f"{float(np.abs(got - want).max())}")
        worst = max(worst, float(np.abs(got - want).max()))
    check(np.allclose(plain[0]["losses"], one["losses"], rtol=DP_RTOL,
                      atol=DP_ATOL), f"train dp: losses {plain[0]['losses']}"
          f" against one process's {one['losses']}")
    losses = ef[0]["losses"]
    check(all(np.isfinite(losses)) and np.mean(losses[-3:])
          < np.mean(losses[:3]), f"train dp int8-EF: losses {losses}")
    check(all(r["ef_abs"] > 0 for r in ef), "train dp int8-EF: a rank's "
          "residuals are all zero")
    per_step = {
        "plain": plain[0]["comm"]["all_reduce"]["bytes"] / DP_PLAIN_STEPS,
        "int8-EF": ef[0]["comm"]["all_reduce"]["bytes"] / DP_EF_STEPS}
    check(per_step["int8-EF"] * 2 == per_step["plain"],
          f"train dp: all_reduce bytes a step {per_step}")
    print(f"train dp {DP_ARCH} ({cut}, {n} parameters), global [{B}, {T}] "
          f"over 2 gloo ranks on one card, float32 compute: plain "
          f"{DP_PLAIN_STEPS} steps, losses {plain[0]['losses']} against one "
          f"process's {one['losses']}, params within {worst:.3g} (rtol "
          f"{DP_RTOL}, atol {DP_ATOL}), ranks equal; int8-EF {DP_EF_STEPS} "
          f"steps (lr {DP_EF_LR}), losses {[round(x, 4) for x in losses]}, "
          f"residuals {[round(r['ef_abs'], 4) for r in ef]}; all_reduce "
          f"bytes per rank and step {per_step} (float16 at half the "
          f"float32); step time plain "
          f"{plain[0]['seconds'] / DP_PLAIN_STEPS:.3f} s, int8-EF "
          f"{ef[0]['seconds'] / DP_EF_STEPS:.3f} s, one process "
          f"{one['seconds'] / DP_PLAIN_STEPS:.3f} s")
    return {"plain_losses": plain[0]["losses"], "one_losses": one["losses"],
            "max_abs_err": worst, "ef_losses": losses,
            "allreduce_bytes_per_step": per_step,
            "zero1": train_zero1(plain, zero1)}


def train_zero1(plain: list, zero1: list) -> dict:
    """Phase 13 (d)'s ZeRO-1 run against plain DP on the same 2 ranks:
    params, slots, collective bytes a step and each rank's peak."""
    worst = 0.0
    for k, want in plain[0]["params"].items():
        got = zero1[0]["params"][k]
        check(np.array_equal(got, zero1[1]["params"][k]),
              f"train dp zero1: the ranks' {k} differ")
        check(np.allclose(got, want, rtol=ZERO1_RTOL, atol=ZERO1_ATOL),
              f"train dp zero1: {k} off plain DP's by "
              f"{float(np.abs(got - want).max())}")
        worst = max(worst, float(np.abs(got - want).max()))
    check(np.allclose(zero1[0]["losses"], plain[0]["losses"],
                      rtol=ZERO1_RTOL), f"train dp zero1: losses "
          f"{zero1[0]['losses']} against plain DP's {plain[0]['losses']}")

    def per_step(run, op):
        return run["comm"].get(op, {"bytes": 0})["bytes"] / DP_PLAIN_STEPS
    moved = {op: per_step(zero1[0], op) for op in (
        "zero1_reduce_scatter", "zero1_all_gather", "all_reduce")}
    plain_ar = per_step(plain[0], "all_reduce")
    check(sum(moved.values()) == plain_ar, f"train dp zero1: bytes a step "
          f"{moved} against plain DP's all_reduce {plain_ar}")
    check(moved["zero1_reduce_scatter"] > 0 and moved["zero1_all_gather"]
          == moved["zero1_reduce_scatter"], f"train dp zero1: {moved}")
    slots = [r["slot_bytes"] for r in zero1]
    whole = plain[0]["slot_bytes"]
    check(all(s < whole for s in slots), f"train dp zero1: slots {slots} "
          f"against the whole {whole}")
    peaks = {"plain": [r["peak_bytes"] for r in plain],
             "zero1": [r["peak_bytes"] for r in zero1]}
    print(f"train dp zero1 {DP_ARCH}, 2 gloo ranks on one card, "
          f"{DP_PLAIN_STEPS} steps: params within {worst:.3g} of plain DP's "
          f"(rtol {ZERO1_RTOL}, atol {ZERO1_ATOL}), ranks equal, losses "
          f"{zero1[0]['losses']}; a rank's slots {slots} B against the whole "
          f"{whole} B ({slots[0] / whole:.4f}); bytes a rank and step "
          f"{moved} = {sum(moved.values())} against plain's all_reduce "
          f"{plain_ar}; each rank's peak {peaks['zero1']} B against plain "
          f"DP's {peaks['plain']} B; step time "
          f"{zero1[0]['seconds'] / DP_PLAIN_STEPS:.3f} s against plain "
          f"{plain[0]['seconds'] / DP_PLAIN_STEPS:.3f} s")
    return {"max_abs_err": worst, "slot_bytes": slots, "whole_slots": whole,
            "bytes_per_step": moved, "plain_allreduce": plain_ar,
            "peak_bytes": peaks,
            "step_s": zero1[0]["seconds"] / DP_PLAIN_STEPS}


def _train_launch(args, ckpt_dir, *extra):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--ckpt-dir", ckpt_dir, *extra], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)


def train_resume_and_example(torch):
    """Phase 13 (e) and (f): the train launcher killed after its step-6
    checkpoint and rerun, against an uninterrupted run; and the training
    example, which runs beside them."""
    from repro_torch.runtime.checkpoint import latest_step, load_checkpoint
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    with tempfile.TemporaryDirectory(prefix="train13-") as tmp:
        straight, killed = (os.path.join(tmp, d) for d in ("a", "b"))
        procs = {
            "example": subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "examples",
                                              "torch_train_lm.py")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=ROOT, env=env),
            "straight": _train_launch(RESUME_ARGS, straight),
            "killed": _train_launch(RESUME_ARGS, killed, "--kill-after",
                                    "6")}
        try:
            outs = {k: _wait(procs[k]) for k in ("straight", "killed")}
            rc, out, err = outs["straight"]
            check(rc == 0, f"train resume: the uninterrupted run exited "
                  f"{rc}: {err[-2000:]}")
            rc, out, err = outs["killed"]
            check(rc == -9 and latest_step(killed) == 6,
                  f"train resume: the drill exited {rc} with checkpoint "
                  f"{latest_step(killed)}: {err[-2000:]}")
            procs["resumed"] = _train_launch(RESUME_ARGS, killed)
            rc, out, err = _wait(procs["resumed"])
            resume_s = time.perf_counter() - t0
            check(rc == 0 and "[train] resumed from step 6" in out,
                  f"train resume: the rerun exited {rc}: {out[-1000:]} "
                  f"{err[-2000:]}")
            outs["example"] = _wait(procs["example"])
            example_s = time.perf_counter() - t0
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        want, _ = load_checkpoint(straight, 12)
        got, _ = load_checkpoint(killed, 12)
        check(set(got) == set(want), "train resume: the checkpoints' leaves "
              "differ")
        exact = all(np.array_equal(got[k], w) for k, w in want.items())
        rel = max(float(np.abs(got[k].astype(np.float64) - w).max())
                  / (float(np.abs(w).max()) or 1.0)
                  for k, w in want.items())
        check(rel <= 1e-5, f"train resume: step 12 {rel} of the scale from "
              f"the uninterrupted run")
        print(f"train resume: killed (SIGKILL) after its step-6 checkpoint, "
              f"rerun resumed from step 6; its step-12 params, moments and "
              f"step {'equal bit for bit' if exact else 'within '}"
              f"{'' if exact else f'{rel:.3g} of the scale'} to the "
              f"uninterrupted run's; the three runs done after "
              f"{resume_s:.1f} s")
    rc, out, err = outs["example"]
    check(rc == 0, f"example torch_train_lm exited {rc}: {err[-2000:]}")
    check(out.startswith(f"on {kind}"),
          f"example torch_train_lm did not run on the card: {out[:200]}")
    check("[OK]" in out, "example torch_train_lm printed no check")
    lines = out.strip().splitlines()
    steps = [ln for ln in lines if ln.startswith("[train] step")]
    for line in [ln for ln in lines if ln not in steps] + steps[-2:]:
        print(f"  torch_train_lm: {line}")
    print(f"train example: exited 0 after {example_s:.1f} s")
    return {"resume_exact": exact, "resume_rel": rel,
            "example_s": example_s}


def _wait(p) -> tuple:
    """(returncode, stdout, stderr) of ``p``, waiting at most
    ``TRAIN_EXAMPLE_TIMEOUT_S``."""
    out, err = p.communicate(timeout=TRAIN_EXAMPLE_TIMEOUT_S)
    return p.returncode, out, err


def train_phase(torch):
    """Phase 13: training on the card.  Returns the numbers it printed."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"main": train_main(torch, gen)}
    torch.cuda.empty_cache()
    out["others"] = train_others(torch, gen)
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = train_card_vs_cpu(torch)
    out["dp"] = train_dp(torch)
    torch.cuda.empty_cache()
    out.update(train_resume_and_example(torch))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"train: no kernel of the port runs on this path; phase 13 took "
          f"{out['seconds']:.1f} s")
    print(f"train summary: {json.dumps(out)}")
    return out


# phase 14: tensor and expert parallelism of the model stack over a
# (data, model) mesh (``sharding.specs``; no kernel of the port).  The model
# ranks share the one card over gloo (NCCL refuses two ranks on one card):
# (a) qwen2-moe-a2.7b at full width, depth 24 -> 2, a forward of [2, 1024]
# at model 2 (block-EP, 30 experts a rank) and 8 (ffe-TP, 176 of ffe a
# rank), moe_impl "ep" and "gspmd", against one process on the card; (b) 2
# train steps at model 2 against one process; (c) the train launcher at
# dp 2 x tp 2 with a checkpoint, resumed at dp 1 x tp 1; (d) 2 data ranks
# of a reduced MoE at a global N * K over 4096 against one process.
TP_ARCH = "qwen2-moe-a2.7b"
TP_BATCH = (2, 1024)           # N * K = 8192: meshless and EP capacity 170
TP_SIZES = (2, 8)
TP_IMPLS = ("ep", "gspmd")
TP_TOL = 1e-4                  # float32 logits, of the one-process scale
TP_TRAIN_STEPS = 2
TP_C6_BATCH = (4, 1024)        # global N * K = 8192, 4096 a data rank
TP_TIMEOUT_S = 600
TP_LAUNCH = ("--arch", TP_ARCH, "--reduced", "--batch", "4", "--seq", "32",
             "--ckpt-every", "2", "--dist-backend", "gloo")


def tp_config():
    """(a)'s config and its cut; (d)'s reduced MoE at capacity factor 1."""
    import dataclasses
    from repro_torch.models import ARCHS
    cfg, cut = model_cut(ARCHS[TP_ARCH])
    small = ARCHS[TP_ARCH].reduced(vocab=128)
    small = dataclasses.replace(small, moe=dataclasses.replace(
        small.moe, capacity_factor=1.0))
    return cfg, cut, small


def tp_build(torch, cfg, mesh, dev):
    """``cfg``'s model from the seeded generator, cut to this rank's shards
    (``shard_params``); the ranks build in turns, so that one whole model
    at a time is on the card."""
    import torch.distributed as dist
    from repro_torch.models import Model
    from repro_torch.sharding.specs import shard_params
    model = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            model = Model(cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED))
            shard_params(model, mesh)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return model


def tp_forward(torch, model, cfg, b, dtype):
    """One timed forward (after one untimed) of ``cfg`` in ``dtype``:
    (logits, moe_overflow, seconds, peak bytes, COMM meters).  On the card
    the meters time each collective, waiting for the card before and
    after it (those waits are in the forward's time)."""
    from repro_torch.core.cost import sync
    from repro_torch.core.distributed import COMM
    dev = model.device
    card = dev.type == "cuda"
    model.cfg = cfg
    with compute_dtype(dtype), torch.inference_mode():
        model.forward(b)
        sync(dev)
        if card:
            torch.cuda.reset_peak_memory_stats(dev)
        COMM.reset()
        COMM.timed = card     # each collective's time, between syncs
        t0 = time.perf_counter()
        try:
            logits, aux = model.forward(b)
            sync(dev)
        finally:
            COMM.timed = False
        seconds = time.perf_counter() - t0
    return (logits, float(aux["moe_overflow"]), seconds,
            torch.cuda.max_memory_allocated(dev) if card else 0,
            COMM.snapshot())


def tp_rank(mesh, dev, cfg, small, tokens, refs, train, c6):
    """One rank of phase 14 (a) at model ``mesh``'s size: each impl's
    forward of ``cfg`` in float32 and bf16, this rank's logits slice
    against the one-process logits' (``refs``, files by dtype); on 2 ranks
    also (b) the train steps of ``train`` (the batches, CPU) and (d) the
    forward of ``small`` on ``c6`` (the global batch) on a (2, 1) mesh of
    the ranks."""
    import dataclasses

    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.train import make_train_step, train_state_init
    from repro_torch.sharding.specs import logical_rules
    model = tp_build(torch, cfg, mesh, dev)
    weights = tensor_bytes(list(model.parameters()))
    V_l = model.embed.shape[0]
    lo = mesh.get_local_rank("model") * V_l
    b = {"tokens": tokens.to(dev)}
    out = {"weights": weights, "forward": {}}
    with logical_rules(mesh):
        for impl in TP_IMPLS:
            for name, dtype in (("float32", torch.float32),
                                ("bf16", torch.bfloat16)):
                logits, ovf, s, peak, comm = tp_forward(
                    torch, model, dataclasses.replace(cfg, moe_impl=impl), b,
                    dtype)
                want = torch.load(refs[name], mmap=True)[..., lo:lo + V_l]
                err = float((logits - want.to(dev)).abs().max())
                out["forward"][f"{impl}/{name}"] = {
                    "max_abs_err": err, "overflow": ovf, "seconds": s,
                    "peak": peak, "comm": comm}
                del logits, want
        if train is not None:
            model.cfg = cfg
            step = make_train_step(model, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                   total_steps=TRAIN_TOTAL,
                                   model_group=mesh.get_group("model"))
            state = train_state_init(model)
            losses, gnorms = [], []
            with compute_dtype(torch.float32):
                for batch in train:
                    state, m = step(state, {k: v.to(dev)
                                            for k, v in batch.items()})
                    losses.append(float(m["loss"]))
                    gnorms.append(float(m["grad_norm"]))
            out["train"] = {"losses": losses, "grad_norms": gnorms}
            del state, step
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if c6 is not None:
        data = make_host_mesh(2, 1)
        r = data.get_local_rank("data")
        n = c6.shape[0] // 2
        with logical_rules(data):
            _, ovf, *_ = tp_forward(torch, tp_build(torch, small, data, dev),
                                    small, {"tokens": c6[r * n:(r + 1) * n]
                                            .to(dev)}, torch.float32)
        out["c6_overflow"] = ovf
    return out


def tp_reference(torch, cfg, tokens, train, tmp):
    """One process on the card: the forward's float32 and bf16 logits
    (saved under ``tmp`` for the ranks), their overflow and time, and
    (b)'s train steps."""
    from repro_torch.models import Model
    from repro_torch.runtime.train import make_train_step, train_state_init
    torch.cuda.empty_cache()
    model = Model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    b = {"tokens": tokens.cuda()}
    out = {"weights": tensor_bytes(list(model.parameters())), "forward": {},
           "refs": {}}
    for name, dtype in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        logits, ovf, s, peak, _ = tp_forward(torch, model, cfg, b, dtype)
        out["refs"][name] = os.path.join(tmp, f"logits_{name}.pt")
        torch.save(logits.cpu(), out["refs"][name])
        out["forward"][name] = {"overflow": ovf, "seconds": s, "peak": peak,
                                "scale": float(logits.abs().max())}
        del logits
    step = make_train_step(model, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_TOTAL)
    state = train_state_init(model)
    losses, gnorms = [], []
    with compute_dtype(torch.float32):
        for batch in train:
            state, m = step(state, {k: v.cuda() for k, v in batch.items()})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    out["train"] = {"losses": losses, "grad_norms": gnorms}
    del state, step, model
    torch.cuda.empty_cache()
    return out


def tp_c6_reference(torch, small, c6):
    """(d) on one process: the reduced MoE's forward overflow on the whole
    global batch."""
    from repro_torch.models import Model
    model = Model(small, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    return tp_forward(torch, model, small, {"tokens": c6.cuda()},
                      torch.float32)[1]


def tp_launcher(torch):
    """Phase 14 (c): the train launcher at dp 2 x tp 2 (gloo ranks on the
    card) with checkpoints every 2 steps, stopped after 4, resumed at dp 1
    x tp 1 to step 6; an uninterrupted run at dp 1 x tp 1 beside it.  The
    resumed run's last loss and step 4's loss under each step-4
    checkpoint, against the uninterrupted run's, within the DP
    tolerances."""
    from repro_torch.launch.train import arch_config, make_batch_fn
    from repro_torch.models import Model
    from repro_torch.runtime.checkpoint import latest_step, restore_checkpoint
    from repro_torch.runtime.train import (load_train_state,
                                           train_state_init,
                                           train_state_tree)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tp14-") as tmp:
        tp, one = (os.path.join(tmp, d) for d in ("tp", "one"))
        procs = {"tp": _train_launch(TP_LAUNCH + ("--steps", "4", "--dp",
                                                  "2", "--tp", "2"), tp),
                 "one": _train_launch(TP_LAUNCH + ("--steps", "6"), one)}
        try:
            outs = {k: _wait(p) for k, p in procs.items()}
            for k, (rc, out, err) in outs.items():
                check(rc == 0, f"tp launcher {k}: exited {rc}: "
                      f"{err[-2000:]}")
            check("dp 2 x tp 2" in outs["tp"][1] and latest_step(tp) == 4,
                  f"tp launcher: {outs['tp'][1][-500:]}")
            procs["resumed"] = _train_launch(TP_LAUNCH + ("--steps", "6"), tp)
            rc, out, err = _wait(procs["resumed"])
            check(rc == 0 and "[train] resumed from step 4" in out,
                  f"tp launcher resumed: exited {rc}: {out[-500:]} "
                  f"{err[-2000:]}")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        last = {k: float([ln for ln in o.splitlines()
                          if ln.startswith("[train] step")][-1]
                         .split("loss=")[1].split()[0])
                for k, o in (("resumed", out), ("one", outs["one"][1]))}
        cfg = arch_config(TP_ARCH, True)
        nxt = {}
        for k, d in (("tp", tp), ("one", one)):
            model = Model(cfg, device="cuda")
            like = train_state_tree(train_state_init(model))
            tree, _ = restore_checkpoint(d, 4, like, device="cpu")
            load_train_state(tree, model)
            with torch.no_grad():
                nxt[k] = float(model.loss(make_batch_fn(
                    cfg, 4, 32, device="cuda")(4))[0])
    for what, got, want in (("last", last["resumed"], last["one"]),
                            ("next", nxt["tp"], nxt["one"])):
        check(np.isclose(got, want, rtol=DP_RTOL, atol=DP_ATOL),
              f"tp launcher: the {what} loss {got!r} against the "
              f"uninterrupted run's {want!r}")
    s = time.perf_counter() - t0
    print(f"tp launcher: {TP_ARCH} reduced at dp 2 x tp 2 over gloo on the "
          f"card, 4 steps with checkpoints, resumed at dp 1 x tp 1 to step "
          f"6: step 4's loss under the dp 2 x tp 2 checkpoint {nxt['tp']!r} "
          f"against the uninterrupted run's {nxt['one']!r}, the last loss "
          f"{last['resumed']!r} against {last['one']!r} (rtol {DP_RTOL}, "
          f"atol {DP_ATOL}); the three runs {s:.1f} s")
    return {"next_loss": nxt, "last_loss": last, "seconds": s}


def tp_phase(torch):
    """Phase 14: tensor and expert parallelism on the card.  Returns the
    numbers it printed."""
    from repro_torch.launch.mesh import run_ranks, stop_rank_server
    t_phase = time.perf_counter()
    cfg, cut, small = tp_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, T = TP_BATCH
    tokens = model_inputs(torch, cfg, B, T, gen)["tokens"].cpu()
    train = [{k: v.cpu() for k, v in lm_inputs(torch, cfg, B, T, i,
                                               gen).items()}
             for i in range(TP_TRAIN_STEPS)]
    c6 = model_inputs(torch, small, *TP_C6_BATCH, gen)["tokens"].cpu()
    out = {"arch": TP_ARCH, "cut": cut, "tp": {}}
    with tempfile.TemporaryDirectory(prefix="tp14-") as tmp:
        ref = tp_reference(torch, cfg, tokens, train, tmp)
        c6_one = tp_c6_reference(torch, small, c6)
        out["one"] = {k: ref[k] for k in ("weights", "forward", "train")}
        f32 = ref["forward"]["float32"]
        print(f"tp {TP_ARCH} ({cut}), [{B}, {T}], one process on the card: "
              f"{ref['weights']} bytes of float32 weights; forward float32 "
              f"{f32['seconds']:.4f} s, peak {f32['peak'] / 1e9:.3f} GB, "
              f"overflow {f32['overflow']}; bf16 "
              f"{ref['forward']['bf16']['seconds']:.4f} s; train "
              f"{TP_TRAIN_STEPS} steps: losses {ref['train']['losses']}, "
              f"grad norms {ref['train']['grad_norms']}")
        try:
            for tp in TP_SIZES:
                t0 = time.perf_counter()
                extra = (train, c6) if tp == 2 else (None, None)
                ranks = run_ranks(tp_rank, tp, (cfg, small, tokens,
                                                ref["refs"], *extra),
                                  backend="gloo", device="cuda",
                                  mesh_shape=(1, tp), timeout_s=TP_TIMEOUT_S)
                out["tp"][tp] = tp_check(tp, ranks, ref, cfg,
                                         time.perf_counter() - t0)
                if tp == 2:
                    out["c6"] = tp_check_c6(ranks, c6_one)
        finally:
            stop_rank_server()
    out["launcher"] = tp_launcher(torch)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"tp: no kernel of the port runs on this path; phase 14 took "
          f"{out['seconds']:.1f} s")
    print(f"tp summary: {json.dumps(out)}")
    return out


def tp_check(tp, ranks, ref, cfg, spawn_s):
    """Hold (a) (and (b) on 2 ranks) of ``ranks`` against the one-process
    run; print the forward times, peaks and all_reduce meters."""
    N, d = TP_BATCH[0] * TP_BATCH[1], cfg.d_model
    # a layer's attention (where its heads shard) and MoE, the embedding
    # (where the vocabulary shards)
    calls = cfg.n_layers * (1 + (cfg.n_heads % tp == 0)) \
        + (cfg.vocab % tp == 0)
    out = {}
    for key in ranks[0]["forward"]:
        impl, name = key.split("/")
        want = ref["forward"][name]
        rel = max(r["forward"][key]["max_abs_err"] for r in ranks) \
            / want["scale"]
        ovf = {r["forward"][key]["overflow"] for r in ranks}
        comm = ranks[0]["forward"][key]["comm"].get("all_reduce", {})
        nbytes = calls * 2 * N * d * 4 * (tp - 1) // tp
        if name == "float32":
            check(rel <= TP_TOL, f"tp {tp} {impl}: logits {rel} of the "
                  f"scale from one process's")
            check(ovf == {want["overflow"]}, f"tp {tp} {impl}: overflow "
                  f"{ovf} against one process's {want['overflow']}")
        check(comm.get("calls") == calls and comm.get("bytes") == nbytes,
              f"tp {tp} {impl} {name}: all_reduce {comm}, the model "
              f"{calls} calls, {nbytes} bytes")
        peaks = [r["forward"][key]["peak"] for r in ranks]
        secs = [r["forward"][key]["seconds"] for r in ranks]
        out[key] = {"rel_err": rel, "overflow": sorted(ovf),
                    "seconds": max(secs), "peaks": peaks,
                    "all_reduce": comm}
        print(f"tp {tp} {impl} {name}: logits {rel:.3g} of the scale from "
              f"one process's ({'held to ' + str(TP_TOL) if name == 'float32' else 'printed, not held'}), "
              f"overflow {sorted(ovf)} (one process {want['overflow']}); "
              f"forward {max(secs):.4f} s (one process {want['seconds']:.4f}"
              f"); peak a rank {max(peaks) / 1e9:.3f} GB against weights/tp "
              f"{ranks[0]['weights'] / 1e9:.3f} GB; all_reduce a rank "
              f"{comm.get('calls')} calls, {comm.get('bytes')} bytes (the "
              f"model: {calls} of [{N}, {d}] float32, {nbytes} bytes), "
              f"{max(r['forward'][key]['comm']['all_reduce']['ms'] for r in ranks):.3f}"
              f" ms of it at most a rank")
    if "train" in ranks[0]:
        want = ref["train"]
        for r in ranks:
            for k in ("losses", "grad_norms"):
                check(np.allclose(r["train"][k], want[k], rtol=TP_TOL,
                                  atol=0.0), f"tp {tp} train: {k} "
                      f"{r['train'][k]} against one process's {want[k]}")
        out["train"] = ranks[0]["train"]
        print(f"tp {tp} train, float32, {TP_TRAIN_STEPS} steps: losses "
              f"{ranks[0]['train']['losses']}, grad norms "
              f"{ranks[0]['train']['grad_norms']} against one process's "
              f"{want['losses']}, {want['grad_norms']} (rtol {TP_TOL})")
    print(f"tp {tp}: the ranks' spawn, builds and phases {spawn_s:.1f} s")
    return out


def tp_check_c6(ranks, one):
    """Hold (d): the data ranks' global overflow equals one process's."""
    got = [r["c6_overflow"] for r in ranks]
    check(one > 0 and all(g == one for g in got), f"tp C6: overflow "
          f"{got} on 2 data ranks against one process's {one}")
    print(f"tp C6: {TP_ARCH} reduced (capacity factor 1.0), global "
          f"{list(TP_C6_BATCH)} over 2 data ranks on the card: overflow "
          f"{got} equal to one process's {one}")
    return {"overflow": got, "one": one}


SCAN_ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b", "whisper-small")
SCAN_BATCH = (2, 512)
SCAN_SIZES = (2, 8)
SCAN_TRAIN_STEPS = 2
SCAN_DECODE = (2, 64, 16)              # sequences, cache positions, steps
KV_ARCH = "qwen3-1.7b"
KV_DECODE = (8, 32768, 32704, 16)      # sequences, positions, filled, steps
SCAN_TIMEOUT_S = 600


def scan_configs():
    """(the (a) configs with their cuts, (c)'s config with its cut)."""
    from repro_torch.models import ARCHS
    return [model_cut(ARCHS[a]) for a in SCAN_ARCHS], \
        model_cut(ARCHS[KV_ARCH])


def scan_tol(cfg) -> float:
    return F32_TOL.get(cfg.family, TP_TOL)


def _comm_add(ops, op, calls, nbytes):
    c = ops.setdefault(op, [0, 0])
    c[0] += calls
    c[1] += nbytes


def _ar(numel, tp, elem=4):
    """A ring all_reduce's bytes a rank (``core.distributed.all_reduce``)."""
    return 2 * numel * elem * (tp - 1) // tp


def _layer_kinds(cfg):
    period = len(cfg.mixer_pattern)
    return [cfg.mixer_pattern[i % period] for i in range(cfg.n_layers)]


def _cuts(cfg, tp):
    """What the model dim cuts: heads, kv heads, ff, d_inner, lru, vocab,
    and whether a rank's RG-LRU channels straddle its gate blocks."""
    import math
    heads = cfg.n_heads % tp == 0
    cut = {"heads": heads, "kv": cfg.n_kv_heads % tp == 0,
           "ff": cfg.d_ff > 0 and cfg.d_ff % tp == 0,
           "vocab": cfg.vocab % tp == 0}
    if cfg.ssm:
        d_inner = cfg.ssm.expand * cfg.d_model
        cut["d_inner"] = d_inner % tp == 0
        cut["x_proj"] = (cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)) \
            + 2 * cfg.ssm.d_state
    if cfg.rglru:
        lru = cfg.rglru.lru_width or cfg.d_model
        cut["lru"] = lru // tp if lru % tp == 0 else 0
        cut["straddle"] = bool(cut["lru"] % cfg.rglru.block_width)
    return cut


def scan_forward_comm(cfg, tp, B, T) -> dict:
    """The collective model of a float32 forward of [B, T] over a model dim
    of ``tp``, a rank: {op: [calls, bytes]}.  A layer: attention one
    all_reduce of [N, d] (``wo``) where the heads shard; an MLP one where
    ``ff`` shards; Mamba two (``x_proj``'s [N, dt_rank + 2 d_state] and
    ``out_proj``'s [N, d]) where ``d_inner`` shards; RG-LRU one (``out``)
    where ``lru`` shards, and one all_gather of [N, lru / tp] where a
    rank's channels straddle the gate blocks; whisper's encoder layers on
    its B x 1,500 frames and its decoder's cross-attention one more each.
    The embedding: one all_reduce of [N, d] where the vocabulary shards."""
    N, d = B * T, cfg.d_model
    c = _cuts(cfg, tp)
    ops: dict = {}
    if c["vocab"]:
        _comm_add(ops, "all_reduce", 1, _ar(N * d, tp))
    if cfg.is_encdec:
        NF = B * cfg.encoder.n_frames
        per = c["heads"] + c["ff"]
        _comm_add(ops, "all_reduce", cfg.encoder.n_layers * per,
                  cfg.encoder.n_layers * per * _ar(NF * d, tp))
        per = 2 * c["heads"] + c["ff"]
        _comm_add(ops, "all_reduce", cfg.n_layers * per,
                  cfg.n_layers * per * _ar(N * d, tp))
        return ops
    for kind in _layer_kinds(cfg):
        if kind in ("attn", "local") and c["heads"]:
            _comm_add(ops, "all_reduce", 1, _ar(N * d, tp))
        elif kind == "mamba" and c["d_inner"]:
            _comm_add(ops, "all_reduce", 2,
                      _ar(N * c["x_proj"], tp) + _ar(N * d, tp))
        elif kind == "rglru" and c["lru"]:
            _comm_add(ops, "all_reduce", 1, _ar(N * d, tp))
            if c["straddle"]:
                _comm_add(ops, "all_gather", 1, N * c["lru"] * 4 * (tp - 1))
        if cfg.ff_kind != "none" and c["ff"]:
            _comm_add(ops, "all_reduce", 1, _ar(N * d, tp))
    return ops


def scan_decode_comm(cfg, tp, B, S) -> dict:
    """The collective model of one float32 decode step of B sequences on a
    cache of S positions (a local layer's: its window) over a model dim of
    ``tp``, the logits gathered, a rank: {op: [calls, bytes]}.  An
    attention layer: one all_gather of the new token's q (and k, v where
    the kv heads shard) of [B, (H + 2 Hk) hd / tp] where the heads shard;
    two all_reduces of the log-sum-exp combine where the positions shard
    (the max, [B, H], and the sum of exps with the weighted values,
    [B, H, hd + 1]); one all_reduce of [B, d] (``wo``) where the heads
    shard.  Whisper's cross-attention one more where the heads shard; the
    other mixers, the MLP and the embedding as in the forward; the logits'
    all_gather of [B, V / tp] where the vocabulary shards."""
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    c = _cuts(cfg, tp)
    ops: dict = {}
    if c["vocab"]:
        _comm_add(ops, "all_reduce", 1, _ar(B * d, tp))
        _comm_add(ops, "all_gather", 1,
                  B * (cfg.vocab // tp) * 4 * (tp - 1))

    def attn(length):
        if c["heads"]:
            n = H // tp + (2 * cfg.n_kv_heads // tp if c["kv"] else 0)
            _comm_add(ops, "all_gather", 1, B * n * hd * 4 * (tp - 1))
            _comm_add(ops, "all_reduce", 1, _ar(B * d, tp))
        if length % tp == 0:
            _comm_add(ops, "all_reduce_lse", 2,
                      _ar(B * H, tp) + _ar(B * H * (hd + 1), tp))

    def ff():
        if cfg.ff_kind != "none" and c["ff"]:
            _comm_add(ops, "all_reduce", 1, _ar(B * d, tp))
    if cfg.is_encdec:
        for _ in range(cfg.n_layers):
            attn(S)
            if c["heads"]:
                _comm_add(ops, "all_reduce", 1, _ar(B * d, tp))
            ff()
        return ops
    for kind in _layer_kinds(cfg):
        if kind in ("attn", "local"):
            attn(S if kind == "attn" else cfg.window)
        elif kind == "mamba" and c["d_inner"]:
            _comm_add(ops, "all_reduce", 2,
                      _ar(B * c["x_proj"], tp) + _ar(B * d, tp))
        elif kind == "rglru" and c["lru"]:
            _comm_add(ops, "all_reduce", 1, _ar(B * d, tp))
            if c["straddle"]:
                _comm_add(ops, "all_gather", 1, B * c["lru"] * 4 * (tp - 1))
        ff()
    return ops


def comm_of(snapshot) -> dict:
    """{op: [calls, bytes]} of a ``COMM.snapshot()``."""
    return {op: [m["calls"], m["bytes"]] for op, m in snapshot.items()
            if m["calls"]}


def scan_inputs(torch, cfgs, kv_cfg, gen):
    """(per (a) config: the forward batch, the train batches and the decode
    inputs; (c)'s tokens), on the CPU."""
    B, T = SCAN_BATCH
    dB, _, steps = SCAN_DECODE
    out = []
    for cfg, _ in cfgs:
        out.append({
            "forward": {k: v.cpu() for k, v in
                        model_inputs(torch, cfg, B, T, gen).items()},
            "train": [{k: v.cpu() for k, v in
                       lm_inputs(torch, cfg, B, T, i, gen).items()}
                      for i in range(SCAN_TRAIN_STEPS)],
            "decode": {k: v.cpu() for k, v in
                       model_inputs(torch, cfg, dB, steps, gen).items()}})
    kB, _, _, ksteps = KV_DECODE
    kv = torch.randint(0, kv_cfg.vocab, (kB, ksteps), generator=gen,
                       device=gen.device).cpu()
    return out, kv


def scan_forward(torch, model, b):
    """One timed float32 forward (after one untimed): (logits, seconds,
    peak bytes, COMM meters), each collective timed between syncs on the
    card."""
    from repro_torch.core.cost import sync
    from repro_torch.core.distributed import COMM
    dev = model.device
    card = dev.type == "cuda"
    b = {k: v.to(dev) for k, v in b.items()}
    with compute_dtype(torch.float32), torch.inference_mode():
        model.forward(b)
        sync(dev)
        if card:
            torch.cuda.reset_peak_memory_stats(dev)
        COMM.reset()
        COMM.timed = card
        t0 = time.perf_counter()
        try:
            logits, _ = model.forward(b)
            sync(dev)
        finally:
            COMM.timed = False
        seconds = time.perf_counter() - t0
    return (logits, seconds,
            torch.cuda.max_memory_allocated(dev) if card else 0,
            COMM.snapshot())


def scan_decode(torch, model, tokens, cache):
    """Float32 decode of ``tokens`` [B, steps] a step at a time from
    ``cache``, the logits gathered: (logits [B, steps, V], ms a step, COMM
    meters of the steps)."""
    from repro_torch.core.cost import sync
    from repro_torch.core.distributed import COMM
    dev = model.device
    tokens = tokens.to(dev)
    out = []
    with compute_dtype(torch.float32), torch.inference_mode():
        sync(dev)
        COMM.reset()
        t0 = time.perf_counter()
        for t in range(tokens.shape[1]):
            logits, cache = model.decode_step(tokens[:, t], cache)
            out.append(logits)
        sync(dev)
        ms = 1e3 * (time.perf_counter() - t0) / tokens.shape[1]
    return torch.stack(out, 1), ms, COMM.snapshot()


def scan_train(torch, model, batches, **kw):
    """(losses, grad norms) of float32 train steps on ``batches``."""
    from repro_torch.runtime.train import make_train_step, train_state_init
    step = make_train_step(model, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_TOTAL, **kw)
    state = train_state_init(model)
    losses, gnorms = [], []
    with compute_dtype(torch.float32):
        for b in batches:
            state, m = step(state, {k: v.to(model.device)
                                    for k, v in b.items()})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    return losses, gnorms


def kv_whole_cache(torch, model, dev, kv_decode):
    """(c)'s whole cache (``kv_decode`` as ``KV_DECODE``), outside any
    binding: k and v of positions below the fill drawn from the seeded
    generator, ``pos`` the fill."""
    from repro_torch.sharding.axes import cache_map
    B, S, P, _ = kv_decode
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    with compute_dtype(torch.float32):
        shape = model.cache_shape(B, S)

    def fill(path, t):
        out = torch.zeros(t.shape, dtype=t.dtype, device=dev)
        if path.endswith((".k", ".v")):
            out[:, :P] = torch.randn((t.shape[0], P) + tuple(t.shape[2:]),
                                     generator=gen, device=dev)
        elif path.endswith(".pos"):
            out.fill_(P)
        return out
    return cache_map(shape, fill)


def cache_bytes(torch, cache, whole_shape, tp):
    """(this rank's cache bytes, the whole's, the cut leaves' bytes here and
    the whole's over tp)."""
    from repro_torch.sharding.axes import cache_leaves
    local, whole = cache_leaves(cache), cache_leaves(whole_shape)
    cut = [k for k in local if local[k].numel() < whole[k].numel()]
    return (tensor_bytes(list(local.values())),
            tensor_bytes(list(whole.values())),
            tensor_bytes([local[k] for k in cut]),
            tensor_bytes([whole[k] for k in cut]) // tp)


def scan_reference(torch, cfgs, kv_cfg, inputs, kv_tokens, tmp):
    """One process on the card: each (a) config's forward, train steps and
    decode, (c)'s decode; logits saved under ``tmp`` for the ranks."""
    from repro_torch.models import Model
    out = {"configs": [], "refs": []}
    dB, S, _ = SCAN_DECODE
    for (cfg, _), inp in zip(cfgs, inputs):
        torch.cuda.empty_cache()
        model = Model(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(SEED))
        logits, s, peak, _ = scan_forward(torch, model, inp["forward"])
        refs = {"forward": os.path.join(tmp, f"{cfg.name}_fwd.pt"),
                "decode": os.path.join(tmp, f"{cfg.name}_dec.pt")}
        torch.save(logits.cpu(), refs["forward"])
        res = {"weights": tensor_bytes(list(model.parameters())),
               "seconds": s, "peak": peak,
               "scale": float(logits.abs().max())}
        del logits
        frames = inp["decode"].get("frames")
        with compute_dtype(torch.float32), torch.inference_mode():
            cache = model.init_cache(dB, S, None if frames is None
                                     else frames.cuda())
        dl, ms, _ = scan_decode(torch, model, inp["decode"]["tokens"], cache)
        torch.save(dl.cpu(), refs["decode"])
        res.update(decode_ms=ms, decode_scale=float(dl.abs().max()))
        del dl, cache
        res["losses"], res["grad_norms"] = scan_train(torch, model,
                                                      inp["train"])
        out["configs"].append(res)
        out["refs"].append(refs)
        del model
    torch.cuda.empty_cache()
    model = Model(kv_cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    cache = kv_whole_cache(torch, model, model.device, KV_DECODE)
    dl, ms, _ = scan_decode(torch, model, kv_tokens, cache)
    out["refs"].append({"decode": os.path.join(tmp, "kv_dec.pt")})
    torch.save(dl.cpu(), out["refs"][-1]["decode"])
    from repro_torch.sharding.axes import cache_leaves
    out["kv"] = {"decode_ms": ms, "scale": float(dl.abs().max()),
                 "cache_bytes": tensor_bytes(list(cache_leaves(cache)
                                                  .values()))}
    del model, cache, dl
    torch.cuda.empty_cache()
    return out


def scan_rank(mesh, dev, cfgs, kv_cfg, inputs, kv_tokens, refs, train,
              sizes):
    """One rank of phase 15 at model ``mesh``'s size: each (a) config's
    forward, decode (and, with ``train``, its train steps), then (c)'s
    decode on the filled cache cut by ``shard_cache`` (the ranks fill and
    cut in turns).  ``sizes``: (``SCAN_DECODE``, ``KV_DECODE``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.sharding.specs import logical_rules, shard_cache
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    rank = mesh.get_local_rank("model")
    (dB, S, _), kv_decode = sizes
    out = []

    def err(got, path):
        want = torch.load(path, mmap=True)
        V_l = got.shape[-1]
        want = want[..., rank * V_l:(rank + 1) * V_l] \
            if V_l < want.shape[-1] else want
        return float((got - want.to(got.device)).abs().max())
    for (cfg, _), inp, ref in zip(cfgs, inputs, refs):
        model = tp_build(torch, cfg, mesh, dev)
        res = {"weights": tensor_bytes(list(model.parameters()))}
        with logical_rules(mesh):
            logits, s, peak, comm = scan_forward(torch, model,
                                                 inp["forward"])
            res.update(forward_err=err(logits, ref["forward"]), seconds=s,
                       peak=peak, comm=comm)
            del logits
            frames = inp["decode"].get("frames")
            with compute_dtype(torch.float32), torch.inference_mode():
                cache = model.init_cache(dB, S, None if frames is None
                                         else frames.to(dev))
            dl, ms, dcomm = scan_decode(torch, model,
                                        inp["decode"]["tokens"], cache)
            res.update(decode_err=err(dl, ref["decode"]), decode_ms=ms,
                       decode_comm=dcomm)
            del dl
        with compute_dtype(torch.float32):
            whole = model.cache_shape(dB, S)
        res["cache"] = cache_bytes(torch, cache, whole, tp)
        del cache
        if train:
            with logical_rules(mesh):
                res["losses"], res["grad_norms"] = scan_train(
                    torch, model, inp["train"],
                    model_group=mesh.get_group("model"))
        out.append(res)
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    model = tp_build(torch, kv_cfg, mesh, dev)
    cache = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            whole = kv_whole_cache(torch, model, dev, kv_decode)
            cache = shard_cache(whole, mesh)
            del whole
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    B, S_kv, _, _ = kv_decode
    with compute_dtype(torch.float32):
        whole = model.cache_shape(B, S_kv)
    kv = {"cache": cache_bytes(torch, cache, whole, tp)}
    with logical_rules(mesh):
        dl, ms, dcomm = scan_decode(torch, model, kv_tokens, cache)
    kv.update(decode_err=err(dl, refs[-1]["decode"]), decode_ms=ms,
              decode_comm=dcomm)
    out.append(kv)
    del model, cache, dl
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def scan_check(tp, ranks, ref, cfgs, kv_cfg, spawn_s):
    """Hold (a), (c) (and (b) at tp 2) of ``ranks`` against the one-process
    run and the collective models; print what they measured."""
    B, T = SCAN_BATCH
    dB, S, steps = SCAN_DECODE
    kB, kS, _, ksteps = KV_DECODE
    out = {}
    for i, (cfg, cut) in enumerate(cfgs):
        one = ref["configs"][i]
        got = [r[i] for r in ranks]
        bound = scan_tol(cfg)
        rel = max(g["forward_err"] for g in got) / one["scale"]
        drel = max(g["decode_err"] for g in got) / one["decode_scale"]
        check(rel <= bound, f"scan tp {tp} {cfg.name}: forward logits {rel} "
              f"of the scale from one process's")
        check(drel <= bound, f"scan tp {tp} {cfg.name}: decode logits {drel}"
              f" of the scale from one process's")
        fwant = scan_forward_comm(cfg, tp, B, T)
        dwant = {op: [c * steps, b * steps] for op, (c, b) in
                 scan_decode_comm(cfg, tp, dB, S).items()}
        for g in got:
            check(comm_of(g["comm"]) == fwant, f"scan tp {tp} {cfg.name}: "
                  f"forward collectives {comm_of(g['comm'])}, the model "
                  f"{fwant}")
            check(comm_of(g["decode_comm"]) == dwant, f"scan tp {tp} "
                  f"{cfg.name}: decode collectives "
                  f"{comm_of(g['decode_comm'])}, the model {dwant}")
            here, _, cut_here, cut_want = g["cache"]
            check(cut_here == cut_want, f"scan tp {tp} {cfg.name}: the cut "
                  f"cache leaves {cut_here} bytes, the whole's / tp "
                  f"{cut_want}")
        ms = {op: max(g["comm"][op]["ms"] for g in got) for op in fwant}
        res = {"forward_rel_err": rel, "decode_rel_err": drel,
               "seconds": max(g["seconds"] for g in got),
               "peaks": [g["peak"] for g in got],
               "weights": got[0]["weights"], "comm": fwant,
               "comm_ms": ms, "decode_ms": max(g["decode_ms"] for g in got),
               "decode_comm": dwant, "cache": got[0]["cache"]}
        print(f"scan tp {tp} {cfg.name} ({cut}): forward [{B}, {T}] float32 "
              f"logits {rel:.3g} of the scale from one process's (held to "
              f"{bound}); {res['seconds']:.4f} s (one process "
              f"{one['seconds']:.4f}); peak a rank "
              f"{max(res['peaks']) / 1e9:.3f} GB against "
              f"{res['weights'] / 1e9:.3f} GB of shards (one process "
              f"{one['peak'] / 1e9:.3f} GB, "
              f"{one['weights'] / 1e9:.3f} GB of weights); collectives a rank "
              f"{fwant} (the model), "
              f"{', '.join(f'{k} {v:.3f} ms' for k, v in ms.items())} at "
              f"most a rank")
        print(f"scan tp {tp} {cfg.name} decode: {steps} steps of {dB} "
              f"sequences on {S} positions, logits {drel:.3g} of the scale "
              f"(held to {bound}); {res['decode_ms']:.3f} ms a step (one "
              f"process {one['decode_ms']:.3f}); collectives a rank over the "
              f"steps {dwant} (the model); cache a rank {res['cache'][0]} "
              f"bytes of {res['cache'][1]} whole, its cut leaves "
              f"{res['cache'][2]} = whole / tp {res['cache'][3]}")
        if "losses" in got[0]:
            for g in got:
                for k in ("losses", "grad_norms"):
                    check(np.allclose(g[k], one[k], rtol=TP_TOL, atol=0.0),
                          f"scan tp {tp} {cfg.name} train: {k} {g[k]} "
                          f"against one process's {one[k]}")
            res["train"] = {k: got[0][k] for k in ("losses", "grad_norms")}
            print(f"scan tp {tp} {cfg.name} train, float32, "
                  f"{SCAN_TRAIN_STEPS} steps of [{B}, {T}]: losses "
                  f"{got[0]['losses']}, grad norms {got[0]['grad_norms']} "
                  f"against one process's {one['losses']}, "
                  f"{one['grad_norms']} (rtol {TP_TOL})")
        out[cfg.name] = res
    got = [r[-1] for r in ranks]
    bound = scan_tol(kv_cfg)
    drel = max(g["decode_err"] for g in got) / ref["kv"]["scale"]
    check(drel <= bound, f"scan tp {tp} {kv_cfg.name}: decode logits {drel} "
          f"of the scale from one process's")
    dwant = {op: [c * ksteps, b * ksteps] for op, (c, b) in
             scan_decode_comm(kv_cfg, tp, kB, kS).items()}
    for g in got:
        check(comm_of(g["decode_comm"]) == dwant, f"scan tp {tp} "
              f"{kv_cfg.name}: decode collectives "
              f"{comm_of(g['decode_comm'])}, the model {dwant}")
        here, whole, cut_here, cut_want = g["cache"]
        check(cut_here == cut_want and whole == ref["kv"]["cache_bytes"],
              f"scan tp {tp} {kv_cfg.name}: cache {g['cache']}")
    lse = max(g["decode_comm"].get("all_reduce_lse", {}).get("ms", 0.0)
              for g in got)
    out[kv_cfg.name] = {"decode_rel_err": drel,
                        "decode_ms": max(g["decode_ms"] for g in got),
                        "decode_comm": dwant, "cache": got[0]["cache"]}
    print(f"scan tp {tp} {kv_cfg.name} decode: {ksteps} steps of {kB} "
          f"sequences on {kS} positions filled to {KV_DECODE[2]}, logits "
          f"{drel:.3g} of the scale (held to {bound}); "
          f"{out[kv_cfg.name]['decode_ms']:.3f} ms a step (one process "
          f"{ref['kv']['decode_ms']:.3f}); cache a rank {got[0]['cache'][0]}"
          f" bytes of {got[0]['cache'][1]} whole, its cut leaves "
          f"{got[0]['cache'][2]} = whole / tp {got[0]['cache'][3]}; "
          f"collectives a rank over the steps {dwant} (the model)"
          + (f", all_reduce_lse {lse:.3f} ms" if lse else ""))
    print(f"scan tp {tp}: the ranks' spawn, builds and phases {spawn_s:.1f} s")
    return out


def scan_phase(torch):
    """Phase 15: tensor parallelism of the scans and whisper, and sharded
    decode, on the card.  Returns the numbers it printed."""
    from repro_torch.launch.mesh import run_ranks, stop_rank_server
    t_phase = time.perf_counter()
    cfgs, (kv_cfg, kv_cut) = scan_configs()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    inputs, kv_tokens = scan_inputs(torch, cfgs, kv_cfg, gen)
    out = {"configs": {c.name: cut for c, cut in cfgs},
           "kv": {kv_cfg.name: kv_cut}, "tp": {}}
    with tempfile.TemporaryDirectory(prefix="scan15-") as tmp:
        ref = scan_reference(torch, cfgs, kv_cfg, inputs, kv_tokens, tmp)
        out["one"] = {c.name: r for (c, _), r in zip(cfgs, ref["configs"])}
        out["one"][kv_cfg.name] = ref["kv"]
        for (cfg, cut), r in zip(cfgs, ref["configs"]):
            print(f"scan {cfg.name} ({cut}), one process on the card: "
                  f"{r['weights']} bytes of float32 weights; forward "
                  f"{r['seconds']:.4f} s, peak {r['peak'] / 1e9:.3f} GB; "
                  f"decode {r['decode_ms']:.3f} ms a step; train losses "
                  f"{r['losses']}, grad norms {r['grad_norms']}")
        print(f"scan {kv_cfg.name} ({kv_cut}), one process on the card: "
              f"decode {ref['kv']['decode_ms']:.3f} ms a step on "
              f"{ref['kv']['cache_bytes']} bytes of cache")
        try:
            for tp in SCAN_SIZES:
                t0 = time.perf_counter()
                ranks = run_ranks(scan_rank, tp, (cfgs, kv_cfg, inputs,
                                                  kv_tokens, ref["refs"],
                                                  tp == 2, (SCAN_DECODE,
                                                            KV_DECODE)),
                                  backend="gloo", device="cuda",
                                  mesh_shape=(1, tp),
                                  timeout_s=SCAN_TIMEOUT_S)
                out["tp"][tp] = scan_check(tp, ranks, ref, cfgs, kv_cfg,
                                           time.perf_counter() - t0)
        finally:
            stop_rank_server()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"scan: no kernel of the port runs on this path; phase 15 took "
          f"{out['seconds']:.1f} s")
    print(f"scan summary: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the dry-run family (``launch/roofline.py``, ``dryrun_join.py``,
# ``dryrun.py``) in child processes, each rank 0 of a fake process group:
# (a) the join at (16, 16) and 2^26 rows on the card and on the CPU, (b)
# model cells on ``meta`` tensors, and the train cells again under
# ``--zero1``, (c) the meters against the card, and ``--zero1`` at mesh 1
# (the identity) against the plain step.
# ---------------------------------------------------------------------------

DRY_JOIN_LOG2 = 26
# (arch, shapes, mesh tag, more arguments): one child process each
DRY_CELLS = (("qwen3-1.7b", ("train_4k", "prefill_32k", "decode_32k"),
              "singlepod", ()),
             ("qwen2-moe-a2.7b", ("train_4k",), "singlepod", ()),
             ("qwen2-0.5b", ("train_4k",), "singlepod", ()),
             ("whisper-small", ("train_4k",), "singlepod", ()),
             ("qwen3-1.7b", ("decode_32k",), "multipod", ("--multi-pod",)))
# (b) under --zero1, in one child: beside (b)'s plain records of these
DRY_ZERO1_ARCHS = ("qwen3-1.7b", "qwen2-moe-a2.7b")
# (c): qwen3-1.7b at full width cut to 2 layers, [2, 4096], mesh 1; the
# join at mesh 1 on phase 4's 2^24 rows a relation
DRY_CHECK = ("--mesh", "1x1", "--arch", "qwen3-1.7b", "--set", "n_layers=2",
             "--batch", "2", "--seq", "4096")
DRY_CHECK_SHAPES = ("prefill_32k", "train_4k")
DRY_JOIN_CHECK_LOG2 = 24
DRY_PEAK_RANGE = (0.75, 1.33)      # meta's peak over the card allocator's
DRY_TIMEOUT_S = 300


def _shapes(shapes) -> tuple:
    return tuple(a for s in shapes for a in ("--shape", s))


def _dry_start(args, log):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    if "repro_torch.launch.dryrun" in args and "cuda" not in args:
        env["OMP_NUM_THREADS"] = "1"       # meta tensors compute nothing
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                            stdout=log, stderr=subprocess.STDOUT, text=True)


def _dry_wait(procs: dict, logs: dict) -> None:
    """Wait for every child; a child that fails fails the phase with its
    output's end; none outlives this call."""
    try:
        for name, p in procs.items():
            rc = p.wait(timeout=DRY_TIMEOUT_S)
            logs[name].seek(0)
            text = logs[name].read()
            check(rc == 0, f"dry {name} exited {rc}: {text[-3000:]}")
            for line in text.strip().splitlines():
                if line.strip():
                    print(f"  {name}: {line.strip()}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _dry_run(jobs: dict, tmp: str) -> None:
    logs = {name: open(os.path.join(tmp, f"{name}.log"), "w+")
            for name in jobs}
    try:
        procs = {name: _dry_start(args, logs[name])
                 for name, args in jobs.items()}
        _dry_wait(procs, logs)
    finally:
        for f in logs.values():
            f.close()


def _load(path):
    with open(path) as f:
        return json.load(f)


def dry_phase(torch) -> dict:
    """Phase 16.  Returns each kernel's launches in (a)'s card run."""
    from repro_torch.launch.dryrun_join import KERNELS
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dry-")
    try:
        join = ("repro_torch.launch.dryrun_join", "--log2-rows",
                str(DRY_JOIN_LOG2))
        model = ("repro_torch.launch.dryrun",)
        # (a) and (b), and (c)'s meta runs, side by side
        jobs = {"join_cuda": (*join, "--out", f"{tmp}/join_cuda.json"),
                "join_cpu": (*join, "--device", "cpu", "--out",
                             f"{tmp}/join_cpu.json")}
        for i, (arch, shapes, _, extra) in enumerate(DRY_CELLS):
            jobs[f"cell{i}"] = (*model, "--arch", arch, *_shapes(shapes),
                                *extra, "--out", f"{tmp}/cell{i}")
        jobs["zero1"] = (*model, *(a for arch in DRY_ZERO1_ARCHS
                                   for a in ("--arch", arch)),
                         "--shape", "train_4k", "--zero1", "--out",
                         f"{tmp}/zero1")
        jobs["check_meta"] = (*model, *DRY_CHECK, *_shapes(DRY_CHECK_SHAPES),
                              "--out", f"{tmp}/meta")
        jobs["check_zero1"] = (*model, *DRY_CHECK, "--shape", "train_4k",
                               "--zero1", "--out", f"{tmp}/meta_zero1")
        _dry_run(jobs, tmp)
        t_ab = time.perf_counter() - t_start
        # (c) on the card, one after another, alone
        _dry_run({"check_cuda": (*model, *DRY_CHECK,
                                 *_shapes(DRY_CHECK_SHAPES), "--device",
                                 "cuda", "--out", f"{tmp}/cuda")}, tmp)
        _dry_run({"join_check": (
            "repro_torch.launch.dryrun_join", "--mesh", "1x1", "--log2-rows",
            str(DRY_JOIN_CHECK_LOG2), "--reps", "3", "--out",
            f"{tmp}/join_check.json")},
            tmp)

        # (a) the card's census equals the CPU's, call for call
        cuda, cpu = (_load(f"{tmp}/join_{d}.json") for d in ("cuda", "cpu"))
        launches = {k: 0 for k in KERNELS}
        for rc, rp in zip(cuda, cpu):
            check(rc["census"] == rp["census"],
                  f"dry join {rc['operator']}: the card's census "
                  f"{rc['census']} != the CPU's {rp['census']}")
            check(rc["device"].startswith("cuda"), "dry join not on the card")
            for k in KERNELS:
                launches[k] += rc["launches"][k]
        for k, n in launches.items():
            check(n > 0, f"dry join: {k} never launched on the card")
        ratio = cuda[2]["coll_bytes_per_device"] / max(
            cuda[3]["coll_bytes_per_device"], 1)
        print(f"dry join (16, 16), 2^{DRY_JOIN_LOG2} rows: census equal on "
              f"the card and the CPU for the 4 records; naive / planned "
              f"collective bytes {ratio:.4f}x; launches {launches}")
        # (b) every model cell ok
        for i, (arch, shapes, tag, _) in enumerate(DRY_CELLS):
            for shape in shapes:
                rec = _load(f"{tmp}/cell{i}/{arch}__{shape}__{tag}.json")
                check(rec["status"] == "ok",
                      f"dry {arch} {shape} {tag}: {rec.get('error')}")
                rf = rec["roofline"]
                print(f"dry {arch} {shape} {tag}: rules "
                      f"{rec['rules_bound']}, terms ({rf['compute_s']:.4e}, "
                      f"{rf['memory_s']:.4e}, {rf['collective_s']:.4e}) s, "
                      f"{rf['dominant']}; peak "
                      f"{rec['memory']['peak_bytes'] / 2**30:.3f} GiB; "
                      f"collectives {rf['collective_ops']}")
        zero1 = dry_zero1(tmp)
        # (c) the meters against the card
        for shape in DRY_CHECK_SHAPES:
            meta, card = (_load(f"{tmp}/{d}/qwen3-1.7b__{shape}__1x1.json")
                          for d in ("meta", "cuda"))
            for rec in (meta, card):
                check(rec["status"] == "ok", f"dry check {shape}: "
                      f"{rec.get('error')} {rec.get('traceback')}")
            fm, fc = (r["roofline"]["flops_per_device"] for r in (meta, card))
            check(fm == fc, f"dry check {shape}: flops {fm} on meta, {fc} on "
                  f"the card")
            pm, pc = (r["memory"]["temp_bytes"] for r in (meta, card))
            share = pm / pc
            check(DRY_PEAK_RANGE[0] <= share <= DRY_PEAK_RANGE[1],
                  f"dry check {shape}: meta peak {pm} over the card's {pc} "
                  f"= {share:.4f}")
            rf = card["roofline"]
            floor = max(rf["compute_s"], rf["memory_s"])
            check(floor <= card["measured_s"], f"dry check {shape}: floor "
                  f"{floor} s above the measured {card['measured_s']} s")
            print(f"dry check qwen3-1.7b (2 layers) {shape} [2, 4096] mesh "
                  f"1: flops {fc:.6e} on both; peak meta {pm} / card {pc} = "
                  f"{share:.4f}; floor {floor:.6e} s (compute "
                  f"{rf['compute_s']:.6e}, memory {rf['memory_s']:.6e}), "
                  f"measured {card['measured_s']:.6e} s = "
                  f"{card['measured_s'] / floor:.3f} x the floor")
        for rec in _load(f"{tmp}/join_check.json"):
            floor = max(rec["compute_s"], rec["memory_s"])
            check(floor <= rec["measured_s"], f"dry join check "
                  f"{rec['operator']}: floor {floor} s above the measured "
                  f"{rec['measured_s']} s")
            print(f"dry join check {rec['operator']} mesh 1, "
                  f"2^{DRY_JOIN_CHECK_LOG2} rows: floor {floor:.6e} s, "
                  f"measured {rec['measured_s']:.6e} s = "
                  f"{rec['measured_s'] / floor:.3f} x; peak "
                  f"{rec['peak_bytes']} B; launches {rec['launches']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"dry: no new kernel on this path; (a) and (b) took {t_ab:.1f} s, "
          f"phase 16 {time.perf_counter() - t_start:.1f} s")
    print(f"dry zero1 summary: {json.dumps(zero1)}")
    return launches


def dry_zero1(tmp: str) -> dict:
    """Phase 16's ``--zero1`` records against the plain ones: (b)'s train
    cells at (16, 16) (memory, census, collective bytes) and (c)'s step at
    mesh 1, where ZeRO-1 is the identity (counted flops, bytes and
    memory equal)."""
    out = {}
    plain_of = {arch: f"{tmp}/cell{i}/{arch}__train_4k__singlepod.json"
                for i, (arch, shapes, tag, _) in enumerate(DRY_CELLS)
                if tag == "singlepod" and "train_4k" in shapes}
    for arch in DRY_ZERO1_ARCHS:
        rec = _load(f"{tmp}/zero1/{arch}__train_4k__singlepod_zero1.json")
        check(rec["status"] == "ok" and rec.get("zero1") is True,
              f"dry zero1 {arch}: {rec.get('error')}")
        plain = _load(plain_of[arch])
        census = rec["roofline"]["census"]
        kinds = {e["kind"] for e in census if e["group"] == 16}
        check({"reduce_scatter", "all_gather"} <= kinds,
              f"dry zero1 {arch}: census {census}")
        mem = {k: (rec["memory"][k], plain["memory"][k]) for k in (
            "argument_bytes", "temp_bytes", "peak_bytes")}
        check(mem["argument_bytes"][0] < mem["argument_bytes"][1],
              f"dry zero1 {arch}: argument bytes {mem['argument_bytes']}")
        coll = (rec["roofline"]["coll_bytes_per_device"],
                plain["roofline"]["coll_bytes_per_device"])
        print(f"dry zero1 {arch} train_4k (16, 16), zero1 / plain: "
              + ", ".join(f"{k} {a} / {b} ({a / 2**30:.3f} / "
                          f"{b / 2**30:.3f} GiB)" for k, (a, b) in
                          mem.items())
              + f"; collective bytes a rank {coll[0]:.0f} / {coll[1]:.0f} "
              f"({coll[0] / coll[1]:.6f}x); census {census} / "
              f"{plain['roofline']['census']}")
        out[arch] = {"memory": mem, "coll_bytes": coll, "census": census}
    meta, z = (_load(f"{tmp}/{d}/qwen3-1.7b__train_4k__1x1{t}.json")
               for d, t in (("meta", ""), ("meta_zero1", "_zero1")))
    check(z["status"] == "ok", f"dry zero1 check: {z.get('error')}")
    same = {k: (z["roofline"][k], meta["roofline"][k]) for k in (
        "flops_per_device", "hbm_bytes_per_device")}
    same.update({k: (z["memory"][k], meta["memory"][k]) for k in (
        "argument_bytes", "temp_bytes")})
    check(all(a == b for a, b in same.values()), f"dry zero1 check at mesh "
          f"1: {same}")
    print(f"dry zero1 check qwen3-1.7b (2 layers) train_4k [2, 4096] mesh 1 "
          f"on meta: the identity, equal to the plain step: {same}")
    out["mesh1"] = same
    return out


def main() -> int:
    """Phases 1-16."""
    t_start = time.perf_counter()
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
        entry = "?"
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = entry_name(m.group(1))
            elif "Used" in line or "spill" in line:
                print(f"  {name} {entry}: {line.strip()}")
    *rates, rates_src = int_rates(torch)
    print(f"integer rates: {rates[0]:.4g} operations/s a pipe, {rates[1]:.4g} "
          f"dispatched = {rates_src}")
    print(f"integer operations per key or draw, from the source: {INT_OPS}; "
          f"per draw counter and side of a launch: {INT_OPS_PER_LAUNCH}")

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

    # --- phase 6: serving -------------------------------------------------
    served, small_probe = serve_phase(rels, truth, torch, rates, wrappers)
    for ln in lines:
        ln["serve_launches"] = served[ln["name"]]
        if ln["name"] == "bloom_probe":
            ln["small_served"] = small_probe

    # --- phase 7: streaming -----------------------------------------------
    t0 = time.perf_counter()
    streamed, shapes = stream_phase(rels, truth, torch, rates, wrappers)
    print(f"stream: phase 7 took {time.perf_counter() - t0:.1f} s")
    for ln in lines:
        ln["stream_launches"] = streamed[ln["name"]]
        if ln["name"] in shapes:
            ln["stream_shape"] = shapes[ln["name"]]

    # --- phase 8: plans ---------------------------------------------------
    t0 = time.perf_counter()
    planned, datasets, plan_truth = plan_phase(torch, wrappers,
                                               rels[0].keys.device)
    print(f"plan: phase 8 took {time.perf_counter() - t0:.1f} s")

    # --- phase 9: the fleet and its fault drill -----------------------------
    t0 = time.perf_counter()
    fleet = fleet_phase(torch, wrappers, datasets, plan_truth,
                        rels[0].keys.device)
    del datasets
    drilled = drill_phase(torch, rels, wrappers)
    print(f"fleet: phase 9 took {time.perf_counter() - t0:.1f} s")
    for ln in lines:
        ln["plan_launches"] = planned[ln["name"]]
        ln["fleet_launches"] = fleet[ln["name"]]
        ln["drill_launches"] = drilled[ln["name"]]

    # --- phase 10: the mesh --------------------------------------------------
    meshed, builds = mesh_phase(rels, torch, wrappers, rates)
    for ln in lines:
        ln["mesh_launches"] = meshed[ln["name"]]
        if ln["name"] == "bloom_build":
            ln["mesh_shape"] = {str(k): {f: b[f] for f in (
                "keys", "num_blocks", "ms", "plain_ms", "bound_ms",
                "bound_by")} for k, b in builds.items()}
    # --- phase 11: the rest of the mesh -------------------------------------
    sliced, calls = slice_phase(rels, torch, wrappers)
    for ln in lines:
        ln["phase11_launches"] = sliced[ln["name"]]
        ln["phase11_shapes"] = sorted({c["shape"] for c in calls
                                       if c["kernel"] == ln["name"]})
    # --- phase 12: the model stack and the examples -------------------------
    model_phase(torch)
    # --- phase 13: training -------------------------------------------------
    for w in wrappers.values():
        w.launches = 0
    train_phase(torch)
    for ln in lines:
        ln["phase13_launches"] = wrappers[ln["name"]].launches
    # --- phase 14: tensor and expert parallelism ---------------------------
    for w in wrappers.values():
        w.launches = 0
    tp_phase(torch)
    for ln in lines:
        ln["phase14_launches"] = wrappers[ln["name"]].launches
    # --- phase 15: the scans and whisper over the model dim, sharded decode --
    for w in wrappers.values():
        w.launches = 0
    scan_phase(torch)
    for ln in lines:
        ln["phase15_launches"] = wrappers[ln["name"]].launches
    # --- phase 16: the dry-run family ----------------------------------------
    dried = dry_phase(torch)
    for ln in lines:
        ln["phase16_launches"] = dried[ln["name"]]
    print(f"chip_smoke: phases 1-16 took "
          f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
