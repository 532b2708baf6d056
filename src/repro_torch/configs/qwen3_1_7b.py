"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936; qk_norm, GQA [hf:Qwen/Qwen3 family; hf]."""

from repro_torch.models.config import ArchConfig, _register

CONFIG = _register(ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, head_dim=128, qk_norm=True, tie_embeddings=True,
    rope_theta=1e6,
    attn_chunk=2048,  # flash-style softmax for >=4k sequences
))
