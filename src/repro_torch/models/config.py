"""Architecture configurations: the 10 assigned archs, the port's own copy
of the JAX package's ``models/config.py`` (values verbatim; sources noted
per entry in ``repro_torch/configs/<id>.py``; stub modality frontends for
[audio]/[vlm]).

The trunk consumes a *layer pattern*: a cycle of mixer kinds applied
round-robin over the depth, one block per full pattern period.  The JAX
package scans the blocks; the port loops over them.  ``remat`` steers the
block remat and ``moe_impl`` the MoE dispatch under a mesh binding (the
reference's shard_map rule for "ep"); ``rules`` are kept as data (the
per-arch overrides the reference's dry runs read; the launchers bind the
default rules).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0           # shared experts (always-on), same d_ff
    capacity_factor: float = 1.25
    router_softmax_after_topk: bool = True  # normalize the top-k weights


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)


@dataclass(frozen=True)
class RGLRUCfg:
    lru_width: Optional[int] = None  # default d_model
    d_conv: int = 4
    block_width: int = 256           # block-diagonal gate projections


@dataclass(frozen=True)
class EncoderCfg:
    n_layers: int
    n_frames: int = 1500          # whisper encoder positions (30 s audio)
    d_input: int = 80             # mel bins (stub frontend projects these)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    mixer_pattern: Tuple[str, ...] = ("attn",)  # cycle: attn|local|mamba|rglru
    ff_kind: str = "swiglu"                 # swiglu | geglu | gelu | moe
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rglru: Optional[RGLRUCfg] = None
    window: int = 4096                      # local-attention window
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    scale_embed: bool = False               # gemma-style sqrt(d) embed scale
    norm_eps: float = 1e-6
    post_norms: bool = False                # gemma2 post-sublayer norms
    encoder: Optional[EncoderCfg] = None    # whisper
    num_img_tokens: int = 0                 # phi-3-vision stub frontend
    remat: str = "block"                    # none | block (see trunk)
    moe_impl: str = "gspmd"                 # gspmd | ep (shard_map dispatch)
    attn_chunk: Optional[int] = None        # flash-style KV-chunked softmax
                                            # for train/prefill (layers.py)
    rules: Optional[Tuple] = None           # per-arch logical-rule overrides
                                            # as ((logical, mesh_axis), ...)
                                            # — tuple so the config stays
                                            # hashable (e.g. seq->model when
                                            # heads don't divide the axis)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def sub_quadratic(self) -> bool:
        """True when decode memory/compute is O(1)-ish in context length
        (no global-attention mixer anywhere in the pattern)."""
        return all(m in ("mamba", "rglru", "local")
                   for m in self.mixer_pattern)

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small: dict = dict(
            n_layers=len(self.mixer_pattern) * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // self.n_heads),
            head_dim=16,
            d_ff=128,
            vocab=256,
            window=32,
            num_img_tokens=4 if self.num_img_tokens else 0,
        )
        if self.moe:
            small["moe"] = MoECfg(num_experts=8, top_k=2, d_ff_expert=32,
                                  num_shared=self.moe.num_shared and 1)
        if self.ssm:
            small["ssm"] = SSMCfg(d_state=4, d_conv=4, expand=2, dt_rank=8)
        if self.rglru:
            small["rglru"] = RGLRUCfg(lru_width=64, block_width=16)
        if self.encoder:
            small["encoder"] = EncoderCfg(n_layers=2, n_frames=16, d_input=8)
        small.update(overrides)
        return dataclasses.replace(self, **small)


ARCHS: dict[str, ArchConfig] = {}


def _register(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    return ARCHS[name]


# The 10 assigned architecture instances live in
# ``repro_torch/configs/<id>.py`` (one file per arch); importing
# ``repro_torch.configs`` registers them here.
