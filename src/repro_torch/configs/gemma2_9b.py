"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; local+global alternating, attn/logit softcaps, GeGLU,
post-sublayer norms [arXiv:2408.00118; hf]."""

from repro_torch.models.config import ArchConfig, _register

CONFIG = _register(ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab=256000, head_dim=256, mixer_pattern=("local", "attn"),
    ff_kind="geglu", window=4096, attn_softcap=50.0, logit_softcap=30.0,
    tie_embeddings=True, scale_embed=True, post_norms=True,
    attn_chunk=2048,  # flash-style softmax for >=4k sequences
))
