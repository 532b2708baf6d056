"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (GQA kv=32, MHA)
d_ff=8192 vocab=32064; phi3-mini backbone + CLIP stub (input_specs supplies
precomputed patch embeddings) [hf:microsoft/Phi-3-vision-128k-instruct; hf]."""

from repro_torch.models.config import ArchConfig, _register

CONFIG = _register(ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064, num_img_tokens=576,  # 24x24 patches per image (stub)
    norm_eps=1e-5,
    attn_chunk=2048,  # flash-style softmax for >=4k sequences
))
