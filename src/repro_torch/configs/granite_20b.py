"""granite-20b [dense] — 52L d_model=6144 48H (GQA kv=1, MQA) d_ff=24576
vocab=49152; llama-arch code model [arXiv:2405.04324; hf]."""

from repro_torch.models.config import ArchConfig, _register

CONFIG = _register(ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152,
    attn_chunk=2048,  # flash-style softmax for >=4k sequences
))
