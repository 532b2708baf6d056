"""falcon-mamba-7b [ssm] — 64L d_model=4096 attention-free, d_ff=0,
vocab=65024, ssm_state=16 (mamba1 arch) [arXiv:2410.05355; unverified]."""

from repro_torch.models.config import ArchConfig, SSMCfg, _register

CONFIG = _register(ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=65024, mixer_pattern=("mamba",), ff_kind="none",
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2), norm_eps=1e-5,
))
