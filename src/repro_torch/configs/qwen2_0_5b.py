"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936; GQA with QKV bias [arXiv:2407.10671; hf]."""

from repro_torch.models.config import ArchConfig, _register

CONFIG = _register(ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, qkv_bias=True, tie_embeddings=True,
    # 12/10/14 heads don't divide a 16-way model axis: attention projections
    # replicate (semantic-unit rule), so activations shard over SEQUENCE on
    # the model axis instead — context parallelism (EXPERIMENTS.md §Perf B)
    rules=(("seq", "model"),),
))
