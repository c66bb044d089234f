"""codeqwen1.5-7b — [dense] qwen1.5-arch (QKV bias, MHA) [hf:Qwen/CodeQwen1.5-7B]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    qkv_bias=True, rope_theta=1_000_000.0,
)
