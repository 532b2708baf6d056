"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""

from repro_torch.models.config import ArchConfig, MoECfg, _register

CONFIG = _register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=151936, ff_kind="moe", qkv_bias=True,
    moe=MoECfg(num_experts=60, top_k=4, d_ff_expert=1408, num_shared=4),
    attn_chunk=2048,  # flash-style softmax for >=4k sequences
))
