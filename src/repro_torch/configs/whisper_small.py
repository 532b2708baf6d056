"""whisper-small [audio] — 12L d_model=768 12H (GQA kv=12) d_ff=3072
vocab=51865; enc-dec with conv frontend stubbed to precomputed frame
embeddings [arXiv:2212.04356; unverified]."""

from repro_torch.models.config import ArchConfig, EncoderCfg, _register

CONFIG = _register(ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, ff_kind="gelu", tie_embeddings=True,
    rope_theta=0.0,  # absolute sinusoidal positions, no rope
    encoder=EncoderCfg(n_layers=12, n_frames=1500, d_input=80),
    norm_eps=1e-5,
    # 12/10/14 heads don't divide a 16-way model axis: attention projections
    # replicate (semantic-unit rule), so activations shard over SEQUENCE on
    # the model axis instead — context parallelism (EXPERIMENTS.md §Perf B)
    rules=(("seq", "model"),),
))
