"""mixtral-8x22b — [moe] 8 experts top-2, SWA [arXiv:2401.04088]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    num_experts=8, experts_per_token=2,
    layer_pattern="swa", sliding_window=4096,
    rope_theta=1_000_000.0,
)
