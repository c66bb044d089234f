"""qwen2-0.5b — [dense] GQA kv=2, QKV bias [arXiv:2407.10671]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
)
