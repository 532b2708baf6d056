"""Time the model stack's meshless decode of two checkouts on one card, in
turns.

Runs ``chip_smoke.py``'s phase 12 (a) (``main_model``: ``qwen3-1.7b``
whole, its prefill of [2, 4096] and 128 decode steps of 8 sequences on a
cache of 4,096 positions, with the decode's device profile) of each
checkout given, each in a process of its own, in the order given, so that
two versions are compared on the same host and card:

    python3 tools/decode_ab.py build/parent . . build/parent

A checkout is a directory holding ``chip_smoke.py`` and ``src/``.  Prints
the card's name and power limit, each run's output, then one JSON object:
the card, and per run the checkout, the decode ms a step, the device's
busy share and device events under the profiler, and the prefill seconds.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

EVENTS = re.compile(r"model decode profile .*?(\d+) device events")


def run_one(root: str) -> None:
    """In this process: phase 12 (a) of the checkout at ``root``."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    out = chip_smoke.main_model(torch, gen)
    print("decode_ab: " + json.dumps(out), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        run_one(os.path.abspath(argv[1]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "not read"
    print(card)
    runs = []
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
                              text=True, timeout=900)
        print(f"--- {root} (exit {proc.returncode})")
        print(proc.stdout[-6000:])
        if proc.returncode:
            print(proc.stderr[-6000:], file=sys.stderr)
            return 1
        out = json.loads(proc.stdout.split("decode_ab: ")[-1].splitlines()[0])
        events = EVENTS.search(proc.stdout)
        runs.append({"checkout": root,
                     "decode_ms_per_step": out["decode_ms_per_step"],
                     "busy_share": out["decode_busy_share"],
                     "device_events": int(events.group(1)) if events
                     else None,
                     "prefill_s": out["prefill_s"]})
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
