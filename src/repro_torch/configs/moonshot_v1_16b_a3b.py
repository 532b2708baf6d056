"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 routed top-6 + 2 shared experts (kimi/moonlight)
[hf:moonshotai/Moonlight-16B-A3B; hf]."""

from repro_torch.models.config import ArchConfig, MoECfg, _register

CONFIG = _register(ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, ff_kind="moe",
    moe=MoECfg(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
    attn_chunk=2048,  # flash-style softmax for >=4k sequences
))
