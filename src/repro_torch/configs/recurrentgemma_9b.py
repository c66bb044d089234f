"""recurrentgemma-9b — [hybrid] RG-LRU + local attn, 1:2 [arXiv:2402.19427]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    layer_pattern="rg", sliding_window=2048,
    rglru_expand=1.0, rglru_conv_width=4,
    scale_embed=True, tie_embeddings=True, activation="gelu",
)
