"""gemma2-27b — [dense] local+global alternating, logit softcap [arXiv:2408.00118]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    arch_type="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
    d_ff=36864, vocab_size=256000, head_dim=128,
    layer_pattern="local_global", sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    attn_scale=144.0**-0.5,           # query_pre_attn_scalar = d_model/heads
    post_norm=True, scale_embed=True, tie_embeddings=True,
    activation="gelu",
)
