"""Top-level Model: forward (prefill logits), loss and decode for every arch,
the port of the JAX package's ``models/model.py`` as an ``nn.Module``.

The parameters live in the module (the reference passes a pytree ``p`` to
pure functions); ``convert.params_from_jax`` fills them from the reference's
pytree.  Loss is next-token cross-entropy in f32 with z-loss; the MoE aux
loss folds in when present.  The parameters are trainable
(``runtime/train.py`` differentiates ``loss``); the serving calls
(``init_cache``, ``decode_step``) record no graph.

Sharded over a mesh's ``model`` dim (``sharding.specs.shard_params``, run
under ``logical_rules``), the embedding and the unembedding are
vocab-parallel where ``vocab % tp == 0``: a rank looks up the tokens of its
rows of the table and one ``reduce_from_group`` sums the lookups; it
computes its slice of the logits, and the loss is a vocab-parallel
cross-entropy (an all_reduce of the max, of the sum of exps and of the gold
logit) that never gathers ``[B, T, V]``.  ``forward`` gathers the logits
only when asked, ``decode_step`` always.  Every family runs so: the
attention and MLP layers (``layers``), the Mamba mixer over ``d_inner``
(``ssm``), the RG-LRU mixer over ``lru`` (``rglru``), whisper's stacks
(``encdec``).

Under the ``seq`` rule (``sharding.specs.seq_axis``) a sequence that divides
the model dim runs sequence parallel (``layers``): the vocab-parallel
lookup ends in a reduce_scatter to this rank's chunk of the sequence (a
whole table looks up the chunk's tokens), and the head, whose logits the
rule lays out as seq chunks over the whole vocabulary ("a mesh axis appears
once per spec: its first use wins"), ends in one all_to_all from vocab
slices to seq chunks.  The loss is then each chunk's mean, averaged over
the dim.

Under a binding ``init_cache`` allocates only this rank's shard of the
decode cache (``sharding.specs.cache_specs``: ``k``/``v`` hold ``S / tp``
positions of every kv head, the recurrent states the local channels, the
batch this data rank's rows; ``layers.KVCache.seq`` marks a cut of the
positions); ``cache_shape`` gives those local shapes.
``sharding.specs.shard_cache`` cuts a whole cache the same way and
``gather_cache`` puts it back together.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.distributed import (all_gather, all_reduce,
                                          copy_to_group, exchange_grad,
                                          gather_dim, gather_seq,
                                          reduce_from_group, scatter_seq)
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import trunk as TR
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.specs import (cache_sharding, current_binding,
                                        cut_cache, local_shape, model_axis,
                                        seq_axis, shard_hint)

Z_LOSS_WEIGHT = 1e-4
MOE_AUX_WEIGHT = 1e-2
CLIP_DIM = 1024  # phi-3-vision stub frontend: projected CLIP patch features


def card_or_cpu(device) -> torch.device:
    """``device`` as a torch.device; raises for the card when there is none
    (an entry point never falls back to the CPU unasked).  ``meta`` gives
    shapes without memory."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card; pass device='cpu' to build on the "
                           "CPU")
    return dev


class Model(nn.Module):
    """One arch's parameters, initialised on ``device`` (the card by
    default) from ``generator`` (a ``torch.Generator`` on that device;
    seeded 0 when None; none on ``meta``)."""

    def __init__(self, cfg: ArchConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = card_or_cpu(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        init = L.Init(dev, generator)
        self.cfg = cfg
        self.embed = nn.Parameter(init.normal((cfg.vocab, cfg.d_model), 0.02))
        if cfg.is_encdec:
            self.encdec = ED.init_encdec(init, cfg)
        else:
            self.trunk = TR.init_trunk(init, cfg)
        self.final_norm = (L.layernorm_init(init, cfg.d_model)
                           if cfg.family == "audio"
                           else L.rmsnorm_init(init, cfg.d_model))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(init.dense((cfg.d_model, cfg.vocab)))
        if cfg.num_img_tokens:
            self.img_proj = nn.Parameter(init.dense((CLIP_DIM, cfg.d_model)))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # --- shared pieces --------------------------------------------------------

    def _vocab_axis(self):
        """The model dim when the table holds a shard of the vocabulary
        (else None), and its local rows."""
        V_l = self.embed.shape[0]
        return (model_axis() if V_l < self.cfg.vocab else None), V_l

    def _embed(self, tokens, sp=None):
        """The tokens' embeddings: this rank's chunk of the sequence under
        sequence parallelism (``sp``)."""
        cfg = self.cfg
        tp, V_l = self._vocab_axis()
        if tp is None:
            table = self.embed
            if sp is not None:
                n = tokens.shape[1] // sp.size
                tokens = tokens[:, sp.rank * n:(sp.rank + 1) * n]
                table = copy_to_group(table, sp.group)
            x = table[tokens].to(L.COMPUTE_DTYPE)
        else:
            t = tokens.long() - tp.rank * V_l
            mine = (t >= 0) & (t < V_l)
            x = (self.embed[t.clamp(0, V_l - 1)] * mine[..., None]).to(
                L.COMPUTE_DTYPE)
            x = reduce_from_group(x, tp.group) if sp is None \
                else scatter_seq(x, tp.group)
        if cfg.scale_embed:
            x = x * torch.sqrt(torch.tensor(cfg.d_model, dtype=L.COMPUTE_DTYPE,
                                            device=x.device))
        return x

    def _final_norm(self, x, sp=None):
        cfg = self.cfg
        p = L.seq_params(self.final_norm, sp)
        return (L.layernorm(p, x, cfg.norm_eps) if cfg.family == "audio"
                else L.rmsnorm(p, x, cfg.norm_eps))

    def _logits(self, x, sp=None):
        """float32 logits: this rank's vocabulary slice when the table is
        sharded; under sequence parallelism (``sp``) this rank's chunk of
        the sequence over the whole vocabulary."""
        cfg = self.cfg
        tp = self._vocab_axis()[0]
        head = self.embed.T if cfg.tie_embeddings else self.head
        if sp is None:
            x = copy_to_group(x, None if tp is None else tp.group)
        elif tp is None:
            head = copy_to_group(head, sp.group)
        else:
            x = gather_seq(x, sp.group)
        logits = x @ head.to(L.COMPUTE_DTYPE)
        logits = L.softcap(logits.float(), cfg.logit_softcap)
        if sp is not None and tp is not None:     # vocab slices -> seq chunks
            logits = exchange_grad(logits, tp.group, 1, 2, "all_to_all_logits")
        T = logits.shape[1] * (1 if sp is None else sp.size)
        return shard_hint(logits, ("batch", "seq", "vocab"),
                          (logits.shape[0], T, cfg.vocab))

    # --- forward (train / prefill) -------------------------------------------

    def forward(self, batch: dict, gather: bool = False) -> tuple:
        """-> (logits over token positions [B, T, V], aux dict).  On a
        vocab-sharded model the logits are this rank's [B, T, V / tp] slice,
        under sequence parallelism its [B, T / tp, V] chunk, unless
        ``gather`` asks for all of them (which carry no grad)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, T = tokens.shape
        dev = tokens.device
        sp = seq_axis(T)
        if sp is not None and cfg.num_img_tokens:
            raise NotImplementedError("sequence parallelism with image "
                                      "tokens has no layout yet")
        x = self._embed(tokens, sp)
        aux: dict = {}
        if cfg.is_encdec:
            frames = batch["frames"]
            # the encoder cuts its frames only beside a cut decoder
            enc_sp = None if sp is None else seq_axis(frames.shape[1])
            enc_out = ED.encode(self.encdec, frames, cfg, enc_sp)
            pos = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
            lo = 0 if sp is None else sp.rank * x.shape[1]
            x = x + L.sinusoidal_embedding(pos[0, lo:lo + x.shape[1]],
                                           cfg.d_model).to(x.dtype)[None]
            x = ED.decode_train(self.encdec, x, enc_out, cfg, pos, sp,
                                enc_sp)
        else:
            P_img = 0
            if cfg.num_img_tokens:
                img = batch["img_embeds"].to(L.COMPUTE_DTYPE)
                x = torch.cat(
                    [img @ self.img_proj.to(L.COMPUTE_DTYPE), x], dim=1)
                P_img = cfg.num_img_tokens
            n = x.shape[1] * (1 if sp is None else sp.size)
            pos = torch.arange(n, dtype=torch.int32, device=dev)
            pos = pos[None, :].expand(B, n)
            x, aux = TR.trunk_train(self.trunk, x, cfg, pos, sp)
            if P_img:
                x = x[:, P_img:]
        x = self._final_norm(x, sp)
        logits = self._logits(x, sp)
        if gather and sp is not None:
            logits = gather_dim(logits.detach(), sp.group, 1)
        elif gather and logits.shape[-1] < cfg.vocab:
            parts = all_gather(logits.detach(), current_binding()[0], "model")
            logits = torch.cat(list(parts), dim=-1)
        return logits, aux

    def loss(self, batch: dict) -> tuple:
        """-> (scalar loss, metrics dict)."""
        logits, aux = self.forward(batch)
        targets = batch["targets"]
        sp = seq_axis(targets.shape[1])
        if sp is not None:
            n = targets.shape[1] // sp.size
            targets = targets[:, sp.rank * n:(sp.rank + 1) * n]
        logz, gold = self._logz_gold(logits, targets)
        nll = torch.mean(logz - gold)
        zloss = Z_LOSS_WEIGHT * torch.mean(logz ** 2)
        if sp is not None:        # the chunks' means, averaged over the dim
            nll, zloss = reduce_from_group(torch.stack([nll, zloss])
                                           / sp.size, sp.group,
                                           "all_reduce_loss")
        total = nll + zloss
        metrics = {"nll": nll, "z_loss": zloss}
        if "moe_aux_loss" in aux:
            total = total + MOE_AUX_WEIGHT * aux["moe_aux_loss"]
            metrics["moe_aux_loss"] = aux["moe_aux_loss"]
            metrics["moe_overflow"] = aux["moe_overflow"]
        metrics["loss"] = total
        return total, metrics

    def _logz_gold(self, logits, targets) -> tuple:
        """(log of the partition function, the target's logit) [B, T] in
        float32: over a vocabulary slice, an all_reduce of the max, of the
        sum of exps and of the gold logit (the latter two summing grads
        back to each rank's slice unchanged)."""
        V_l = logits.shape[-1]
        tp = model_axis() if V_l < self.cfg.vocab else None
        if tp is None:
            return (torch.logsumexp(logits, dim=-1),
                    torch.gather(logits, -1, targets[..., None].long())[..., 0])
        m = all_reduce(logits.detach().amax(dim=-1), tp.group,
                       "all_reduce_loss", torch.distributed.ReduceOp.MAX)
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        logz = torch.log(reduce_from_group(se, tp.group, "all_reduce_loss")) + m
        t = targets.long() - tp.rank * V_l
        mine = (t >= 0) & (t < V_l)
        gold = torch.gather(logits, -1, t.clamp(0, V_l - 1)[..., None])[..., 0]
        gold = reduce_from_group(gold * mine, tp.group, "all_reduce_loss")
        return logz, gold

    # --- serving --------------------------------------------------------------

    @torch.no_grad()
    def init_cache(self, batch: int, max_seq: int,
                   frames: Optional[torch.Tensor] = None, device=None):
        """Decode cache on the model's device (or ``device``); under a
        binding, this rank's shard of it (module docstring).  Whisper needs
        ``frames`` (this data rank's rows) for cross-KV."""
        from repro_torch.sharding.axes import cache_map
        cfg = self.cfg
        dev = device or self.device
        if cfg.is_encdec:
            assert frames is not None
            enc_out = ED.encode(self.encdec, frames, cfg)
            ck, cv = ED.cross_cache(self.encdec, enc_out, cfg)
        cache = cache_map(self.cache_shape(batch, max_seq), lambda path, t:
                          None if path.startswith("cross_") else
                          torch.zeros(t.shape, dtype=t.dtype, device=dev))
        if cfg.is_encdec:
            cache = cache._replace(cross_k=ck, cross_v=cv)
        return cache

    def cache_shape(self, batch: int, max_seq: int):
        """The cache as meta tensors: its shapes and dtypes, no memory.
        Under a binding, the shapes of this rank's shard."""
        cfg = self.cfg
        if cfg.is_encdec:
            enc = cfg.encoder
            n = cfg.n_layers
            kv = [L.init_kv_cache(cfg, batch, max_seq, "causal",
                                  device="meta") for _ in range(n)]
            cross = [torch.empty((batch, enc.n_frames, cfg.n_kv_heads,
                                  cfg.hd), dtype=L.COMPUTE_DTYPE,
                                 device="meta") for _ in range(n)]
            whole = ED.EncDecCache(kv, cross, list(cross))
        else:
            whole = TR.init_trunk_cache(cfg, batch,
                                        max_seq + cfg.num_img_tokens, "meta")
        bind = current_binding()
        if bind is None:
            return whole
        mesh, rules = bind
        cut = cache_sharding(whole, mesh, rules)
        return cut_cache(whole, cut, lambda path, t: torch.empty(
            local_shape(cut.specs[path], t.shape, mesh), dtype=t.dtype,
            device="meta"))

    @torch.no_grad()
    def decode_step(self, tokens, cache) -> tuple:
        """tokens int [B] -> (logits f32 [B, V], new cache).  Attention
        caches are updated in place (``layers.attention_decode``).  On a
        vocab-sharded model one all_gather puts the logits together."""
        cfg = self.cfg
        x = self._embed(tokens[:, None])                      # [B, 1, d]
        if cfg.is_encdec:
            pos = cache.self_kv[0].pos                        # [B]
            x = x + L.sinusoidal_embedding(pos[:, None],
                                           cfg.d_model).to(x.dtype)
            x, cache = ED.decode_step(self.encdec, x, cfg, cache)
        else:
            x, cache = TR.trunk_decode(self.trunk, x, cfg, cache)
        x = self._final_norm(x)
        logits = self._logits(x)[:, 0]
        if logits.shape[-1] < cfg.vocab:
            parts = all_gather(logits, current_binding()[0], "model")
            logits = torch.cat(list(parts), dim=-1)
        return logits, cache
