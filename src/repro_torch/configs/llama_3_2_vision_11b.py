"""llama-3.2-vision-11b — [vlm] cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    cross_attn_every=5,                 # 8 cross-attn layers of 40
    encoder_seq=6404, frontend_dim=4096,  # 4 tiles × 1601 patches, post-projector
    rope_theta=500_000.0,
)
