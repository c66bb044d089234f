"""whisper-small — [audio] enc-dec, conv frontend STUB [arXiv:2212.04356]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, encoder_seq=1500, frontend_dim=768,
    activation="gelu_plain", norm="layernorm", pos_embed="learned",
    max_seq_len=32768,   # decode_32k support; real whisper caps at 448
)
