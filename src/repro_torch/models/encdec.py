"""Whisper-small encoder-decoder (the [audio] arch): the port of the JAX
package's ``models/encdec.py``.

The conv frontend is a STUB: precomputed mel frames [B, n_frames, d_input]
come in; a linear projection stands in for the two convs.  Positions are
sinusoidal for both stacks (whisper uses learned decoder positions; the
reference's deviation, kept).  Norms are LayerNorm (with bias), pre-norm
arrangement, GELU MLP.

Encoder: bidirectional attention over frames.  Decoder: causal
self-attention + cross-attention to encoder output; decode caches self-KV
per layer, cross-KV precomputed once at prefill.  Both stacks are
``nn.ModuleList``s run by a loop (the reference scans them), each layer
under block remat (``layers.remat``), as the reference checkpoints its scan
step.

Over a mesh's model dim (``sharding.specs.logical_rules``) both stacks'
attention and MLP are tensor-parallel as in ``layers``; ``frame_proj`` and
the LayerNorms stay whole.  The decoder's cross-attention takes the local
heads' keys and values of the encoder states; the decode cache keeps
``cross_k``/``cross_v`` whole (the reference names their heads dim None),
built once from the gathered weights (``layers.cross_kv(whole=True)``), and
its self-attention caches hold ``S / tp`` positions each
(``layers.attention_decode``).

Under the ``seq`` rule each stack whose sequence divides the model dim runs
sequence parallel (``sp``, ``layers``): the decoder over its tokens, the
encoder over its frames (1,500 frames do not divide 16 and stay whole).
The decoder's cross-attention takes the encoder states whole: gathered
once (``gather_seq``) from a sequence-parallel encoder.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.core.distributed import gather_seq
from repro_torch.models import layers as L


def init_enc_block(init, cfg) -> L.Params:
    return L.Params(pre_attn=L.layernorm_init(init, cfg.d_model),
                    attn=L.init_attention(init, cfg),
                    pre_mlp=L.layernorm_init(init, cfg.d_model),
                    mlp=L.init_mlp(init, cfg))


def init_dec_block(init, cfg) -> L.Params:
    return L.Params(pre_self=L.layernorm_init(init, cfg.d_model),
                    self_attn=L.init_attention(init, cfg),
                    pre_cross=L.layernorm_init(init, cfg.d_model),
                    cross_attn=L.init_attention(init, cfg),
                    pre_mlp=L.layernorm_init(init, cfg.d_model),
                    mlp=L.init_mlp(init, cfg))


def init_encdec(init, cfg) -> L.Params:
    enc = cfg.encoder
    return L.Params(
        frame_proj=init.dense((enc.d_input, cfg.d_model)),
        enc_blocks=nn.ModuleList([init_enc_block(init, cfg)
                                  for _ in range(enc.n_layers)]),
        enc_norm=L.layernorm_init(init, cfg.d_model),
        dec_blocks=nn.ModuleList([init_dec_block(init, cfg)
                                  for _ in range(cfg.n_layers)]),
    )


def encode(p, frames, cfg, sp=None) -> torch.Tensor:
    """frames [B, F, d_input] -> encoder states [B, F, d]: this rank's
    chunk of the frames under sequence parallelism (``sp``)."""
    B, F, _ = frames.shape
    pos = torch.arange(F, dtype=torch.int32, device=frames.device)
    if sp is not None:
        n = F // sp.size
        frames = frames.narrow(1, sp.rank * n, n)
        pos = pos.narrow(0, sp.rank * n, n)
    ps = L.seq_params(p, sp)
    x = frames.to(L.COMPUTE_DTYPE) @ ps["frame_proj"].to(L.COMPUTE_DTYPE)
    x = x + L.sinusoidal_embedding(pos, cfg.d_model).to(x.dtype)
    for bp in p["enc_blocks"]:
        x = L.remat(cfg, _enc_layer, bp, x, cfg, sp)
    return L.layernorm(ps["enc_norm"], x, cfg.norm_eps)


def _enc_layer(bp, x, cfg, sp=None):
    norms = L.seq_params(bp, sp)
    h = L.layernorm(norms["pre_attn"], x, cfg.norm_eps)
    x = x + L.attention_train(bp["attn"], h, cfg, kind="full", sp=sp)
    h = L.layernorm(norms["pre_mlp"], x, cfg.norm_eps)
    return x + L.mlp(bp["mlp"], h, cfg, sp)


def decode_train(p, x, enc_out, cfg, positions, sp=None,
                 enc_sp=None) -> torch.Tensor:
    """Teacher-forced decoder pass: x [B, T, d] token embeddings (this
    rank's chunk of them under ``sp``); ``enc_out`` this rank's chunk of
    the encoder states when the encoder ran under ``enc_sp``."""
    gathered = enc_sp is not None
    if gathered:
        enc_out = gather_seq(enc_out, enc_sp.group)
    for bp in p["dec_blocks"]:
        x = L.remat(cfg, _dec_layer, bp, x, enc_out, cfg, positions, sp,
                    gathered)
    return x


def _dec_layer(bp, x, enc_out, cfg, positions, sp=None, gathered=False):
    norms = L.seq_params(bp, sp)
    h = L.layernorm(norms["pre_self"], x, cfg.norm_eps)
    x = x + L.attention_train(bp["self_attn"], h, cfg, kind="causal",
                              positions=positions, sp=sp)
    h = L.layernorm(norms["pre_cross"], x, cfg.norm_eps)
    kv = L.cross_kv(bp["cross_attn"], enc_out, cfg, sp=sp, gathered=gathered)
    x = x + L.attention_train(bp["cross_attn"], h, cfg, kind="cross", kv=kv,
                              sp=sp)
    h = L.layernorm(norms["pre_mlp"], x, cfg.norm_eps)
    return x + L.mlp(bp["mlp"], h, cfg, sp)


class EncDecCache(NamedTuple):
    self_kv: list            # one L.KVCache a decoder layer
    cross_k: list            # one [B, F, Hk, hd] a decoder layer
    cross_v: list


def cross_cache(p, enc_out, cfg) -> tuple:
    """Each decoder layer's cross-attention keys and values of every kv
    head, from the encoder output: (cross_k, cross_v) lists."""
    ck, cv = zip(*[L.cross_kv(bp["cross_attn"], enc_out, cfg, whole=True)
                   for bp in p["dec_blocks"]])
    return list(ck), list(cv)


def decode_step(p, x, cfg, cache: EncDecCache) -> tuple:
    """One-token decoder step: x [B, 1, d] -> (x, new cache)."""
    new_self = []
    for bp, skv, ck, cv in zip(p["dec_blocks"], cache.self_kv,
                               cache.cross_k, cache.cross_v):
        h = L.layernorm(bp["pre_self"], x, cfg.norm_eps)
        mx, nkv = L.attention_decode(bp["self_attn"], h, cfg, skv,
                                     kind="causal")
        x = x + mx
        h = L.layernorm(bp["pre_cross"], x, cfg.norm_eps)
        x = x + L.attention_train(bp["cross_attn"], h, cfg, kind="cross",
                                  kv=(ck, cv))
        h = L.layernorm(bp["pre_mlp"], x, cfg.norm_eps)
        x = x + L.mlp(bp["mlp"], h, cfg)
        new_self.append(nkv)
    return x, cache._replace(self_kv=new_self)
