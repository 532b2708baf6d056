"""The assigned input-shape cells and per-arch applicability.

LM shapes (seq_len x global_batch):
  train_4k     4,096 x 256   lowers train_step
  prefill_32k  32,768 x 32   lowers the forward (prefill) pass
  decode_32k   32,768 x 128  lowers serve_step (1 token, KV cache of 32k)
  long_500k    524,288 x 1   lowers serve_step; SUB-QUADRATIC ARCHS ONLY

``long_500k`` is skipped for every arch whose mixer pattern contains global
attention (quadratic decode state) — per the assignment note; the skips are
listed explicitly in DESIGN.md §5 and EXPERIMENTS.md §Dry-run.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.models.config import ArchConfig


class ShapeCell(NamedTuple):
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("quadratic attention: 500k KV cache/attention is the "
                       "thing sub-quadratic archs exist to avoid (skip per "
                       "assignment)")
    if cfg.is_encdec and shape == "long_500k":
        return False, "enc-dec decoder is full-attention (quadratic)"
    return True, ""


def cells_for(cfg: ArchConfig) -> list[ShapeCell]:
    return [c for n, c in SHAPES.items() if applicable(cfg, n)[0]]
