"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention 1:2 (pattern rglru,rglru,local);
26 = 8 full patterns + a trailing (rglru, rglru) partial block, handled by
the trunk's tail support [arXiv:2402.19427; hf]."""

from repro_torch.models.config import ArchConfig, RGLRUCfg, _register

CONFIG = _register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, mixer_pattern=("rglru", "rglru", "local"),
    ff_kind="geglu", rglru=RGLRUCfg(lru_width=2560), window=2048,
    tie_embeddings=True, scale_embed=True,
    # 12/10/14 heads don't divide a 16-way model axis: attention projections
    # replicate (semantic-unit rule), so activations shard over SEQUENCE on
    # the model axis instead — context parallelism (EXPERIMENTS.md §Perf B)
    rules=(("seq", "model"),),
))
