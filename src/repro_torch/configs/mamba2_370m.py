"""mamba2-370m — [ssm] SSD (state-space duality) [arXiv:2405.21060]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48, d_model=1024, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    layer_pattern="ssm",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    tie_embeddings=True, norm_eps=1e-5,
)
