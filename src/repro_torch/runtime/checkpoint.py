"""Atomic, verified checkpointing of a flat tree of tensors.

Layout (the JAX package's, so either implementation reads the other's):

    <dir>/step_<N>/
        manifest.json      {"step": N, "leaves": {path: {file, shape,
                            dtype, sha}}, "extra": {...}}
        <leaf-path>.npy    one file per leaf

Guarantees:

* **atomic**: written to ``step_<N>.tmp-<nonce>`` then ``os.rename``'d; a
  crash mid-save never corrupts the latest checkpoint, and ``latest_step``
  only sees fully renamed directories.
* **verified**: every leaf carries a content hash (the first 16 hex digits
  of its SHA-256), checked on restore.
* **device-agnostic**: leaves are stored as host arrays keyed by tree path,
  so a restore may place them on any device (``restore_checkpoint``'s
  ``device``).
* **async**: ``save_checkpoint(..., sync=False)`` copies every leaf to the
  host first, synchronously (a ``non_blocking`` copy would hand the writer a
  buffer still being filled), then hands the host arrays to a daemon
  thread, so serving continues while the previous step serializes.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
import uuid
from typing import Optional

import numpy as np
import torch

_SEP = "."

# a .tmp-* dir older than this is a leftover from a crashed writer, not an
# in-flight save: latest_step sweeps it
_STALE_TMP_S = 600.0


class CheckpointCorruptError(Exception):
    """A checkpoint failed integrity validation (checksum/shape/missing leaf).

    Raised instead of ``assert`` so the guard survives ``python -O``."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: tuple = ()) -> dict:
    """{dotted path: leaf} over dicts (sorted keys), lists, tuples and
    NamedTuples (by field name); None holds no leaf, any other object is
    one.  The paths are the ones ``jax.tree_util`` gives the same tree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {_SEP.join(prefix): tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def _unflatten(like, values: dict, prefix: tuple = ()):
    """``like``'s structure with each leaf replaced by ``values[path]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, values, prefix + (str(k),))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, values, prefix + (f,))
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, values, prefix + (str(i),))
                          for i, v in enumerate(like))
    return values[_SEP.join(prefix)]


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that shares no memory with it (``.cpu()`` of
    a CPU tensor, or ``np.asarray`` of an array, would be a view)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def save_checkpoint(directory: str, step: int, tree, *, sync: bool = True,
                    extra: Optional[dict] = None) -> threading.Thread | None:
    """Write the tree; returns the writer thread when ``sync=False``.

    The host copy of every leaf is taken here, before any writer starts,
    so the caller may mutate its tensors as soon as this returns."""
    host = {k: _host(v) for k, v in _flatten(tree).items()}

    def write():
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}, "extra": extra or {}}
        for k, a in host.items():
            fn = k.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fn), a)
            manifest["leaves"][k] = {"file": fn, "shape": list(a.shape),
                                     "dtype": str(a.dtype), "sha": _sha(a)}
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)
        if os.path.exists(final):  # re-save of same step (retry path)
            shutil.rmtree(final)
        os.rename(tmp, final)

    if sync:
        write()
        return None

    def guarded():
        # a daemon thread's traceback goes to stderr and vanishes: record
        # the failure on the thread object so whoever joins it can surface
        # it (otherwise checkpointing silently stops and the newest
        # checkpoint goes stale without anyone noticing)
        try:
            write()
        except BaseException as e:  # noqa: BLE001 (must not die silently)
            th.exception = e

    th = threading.Thread(target=guarded, daemon=True)
    th.exception = None
    th.start()
    return th


def _manifest_ok(step_dir: str) -> bool:
    """True iff the dir holds a readable, parseable manifest.json."""
    try:
        with open(os.path.join(step_dir, "manifest.json")) as fh:
            json.load(fh)
        return True
    except (OSError, ValueError):
        return False


def latest_step(directory: str) -> Optional[int]:
    """Newest *complete* checkpoint step, or None.

    Torn ``step_*`` dirs (no readable manifest, e.g. a partial copy) are
    skipped, and stale ``.tmp-*`` dirs left by a crashed async writer are
    swept so they cannot accumulate."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        full = os.path.join(directory, d)
        if ".tmp-" in d:
            try:
                if time.time() - os.path.getmtime(full) > _STALE_TMP_S:
                    shutil.rmtree(full, ignore_errors=True)
            except OSError:
                pass
            continue
        m = re.fullmatch(r"step_(\d+)", d)
        if m and _manifest_ok(full):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _load_leaf(step_dir: str, key: str, meta: dict) -> np.ndarray:
    try:
        a = np.load(os.path.join(step_dir, meta["file"]))
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"unreadable leaf {key}: {e}") from e
    if _sha(a) != meta["sha"]:
        raise CheckpointCorruptError(f"checksum mismatch for {key}")
    return a


def _manifest(directory: str, step: int) -> tuple[str, dict]:
    d = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as fh:
            return d, json.load(fh)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest for step {step}: {e}") from e


def load_checkpoint(directory: str, step: int) -> tuple[dict, dict]:
    """Structure-free restore: ``(flat {path: np.ndarray}, extra)``.

    Verifies every leaf's checksum and manifest shape.  Used when the
    restoring side does not know the tree shapes in advance (e.g. adopting a
    dead replica's engine state, whose queue depth and dataset sizes are
    whatever they were at death)."""
    d, manifest = _manifest(directory, step)
    flat = {}
    for k, meta in manifest["leaves"].items():
        a = _load_leaf(d, k, meta)
        if list(a.shape) != list(meta["shape"]):
            raise CheckpointCorruptError(
                f"shape mismatch for {k}: {list(a.shape)} vs {meta['shape']}")
        flat[k] = a
    return flat, manifest.get("extra", {})


def restore_checkpoint(directory: str, step: int, like_tree, *, device=None):
    """Restore into the structure of ``like_tree`` (shapes must match), each
    leaf a tensor on ``device`` (the card unless the caller asks for the
    CPU).  Returns ``(tree, extra)``."""
    d, manifest = _manifest(directory, step)
    device = torch.device("cuda" if device is None else device)
    out = {}
    for k, leaf in _flatten(like_tree).items():
        if k not in manifest["leaves"]:
            raise CheckpointCorruptError(f"missing leaf {k} in step {step}")
        a = _load_leaf(d, k, manifest["leaves"][k])
        want = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else np.shape(leaf)
        if tuple(a.shape) != want:
            raise CheckpointCorruptError(
                f"shape mismatch for {k}: {a.shape} vs {want}")
        out[k] = torch.as_tensor(a, device=device)
    return _unflatten(like_tree, out), manifest["extra"]
