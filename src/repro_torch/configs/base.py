"""Architecture configuration schema.

One :class:`ArchConfig` instance fully describes a backbone in the model zoo
(dense GQA / MoE / SSM / hybrid / enc-dec / VLM). `layer_kinds()` expands the
per-layer block pattern the stack builder consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

LayerKind = Literal["attn", "attn_local", "ssm", "rglru"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None    # default d_model // num_heads

    # --- attention features -------------------------------------------------
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2 / codeqwen (qwen1.5 arch)
    attn_softcap: float | None = None    # gemma2: 50.0
    final_softcap: float | None = None   # gemma2: 30.0
    sliding_window: int | None = None    # window size for local layers
    # layer pattern: 'global' (all full attn), 'local_global' (gemma2
    # alternation), 'swa' (all sliding window — mixtral), 'rg' (recurrentgemma
    # 2×RG-LRU : 1×local-attn), 'ssm' (all mamba2 blocks)
    layer_pattern: str = "global"
    rope_theta: float = 10000.0
    attn_scale: float | None = None      # override 1/sqrt(head_dim)

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_shard_dispatch: bool = False   # §Perf: constrain dispatch buffers

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0             # N (state dim per head)
    ssm_head_dim: int = 64         # P
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_conv_width: int = 4
    ssm_chunk: int = 128           # SSD chunk length

    # --- RG-LRU (recurrentgemma) ----------------------------------------------
    rglru_expand: float = 1.5      # d_rnn ≈ expand * d_model (griffin uses 4/3·?; RG 9B: 4096→d_rnn 4096? use expand=1)
    rglru_conv_width: int = 4

    # --- enc-dec (whisper) / VLM (llama-3.2-vision) ----------------------------
    encoder_layers: int = 0        # >0 → encoder-decoder; encoder is non-causal
    encoder_seq: int = 0           # frames/patches provided by the stub frontend
    cross_attn_every: int = 0      # VLM: insert cross-attn layer every N layers
    frontend_dim: int = 0          # stub embedding dim (== d_model after projector)

    # --- misc ------------------------------------------------------------------
    activation: str = "silu"       # silu (SwiGLU) | gelu (GeGLU) | gelu_plain
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_seq_len: int = 8192
    post_norm: bool = False        # gemma2: extra norm after each sub-block
    scale_embed: bool = False      # gemma family: embed ·= sqrt(d_model)
    norm: str = "rmsnorm"          # rmsnorm | layernorm (whisper)
    pos_embed: str = "rope"        # rope | learned (whisper)

    # --- kernel backends --------------------------------------------------------
    # "reference" = pure-jnp paths; "pallas" routes self-causal attention
    # through kernels.flash_attention and SSD mixing through kernels.ssd_scan
    # (forward Pallas, backward via the reference VJP).
    attn_backend: str = "reference"
    ssm_backend: str = "reference"

    # --- numerics ---------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # scan layer groups (fast compile, O(1) HLO in depth) vs unroll (slower
    # compile; XLA cost_analysis then counts every layer — used by §Roofline)
    scan_layers: bool = True

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def d_rnn(self) -> int:
        # round to a multiple of 128 for TPU-friendly tiling
        d = int(self.rglru_expand * self.d_model)
        return (d + 127) // 128 * 128

    def layer_kinds(self) -> list[dict]:
        """Expand the pattern into per-layer block descriptors."""
        kinds: list[dict] = []
        for i in range(self.num_layers):
            if self.layer_pattern == "global":
                kind = {"kind": "attn", "window": None}
            elif self.layer_pattern == "swa":
                kind = {"kind": "attn", "window": self.sliding_window}
            elif self.layer_pattern == "local_global":
                # gemma2: even layers local (SW), odd layers global
                w = self.sliding_window if i % 2 == 0 else None
                kind = {"kind": "attn", "window": w}
            elif self.layer_pattern == "rg":
                # recurrentgemma: (RG-LRU, RG-LRU, local attn) repeating
                if i % 3 == 2:
                    kind = {"kind": "attn", "window": self.sliding_window}
                else:
                    kind = {"kind": "rglru", "window": None}
            elif self.layer_pattern == "ssm":
                kind = {"kind": "ssm", "window": None}
            else:
                raise ValueError(f"unknown layer_pattern {self.layer_pattern}")
            kind["moe"] = self.num_experts > 0
            kind["cross_attn"] = bool(
                self.cross_attn_every
                and (i % self.cross_attn_every == self.cross_attn_every - 1)
            ) or (self.is_encoder_decoder and kind["kind"].startswith("attn"))
            kinds.append(kind)
        return kinds

    def pattern_period(self) -> int:
        """Length of the repeating layer-kind period — the scan body covers
        one period (layers are stacked across period repetitions)."""
        import math

        base = {"global": 1, "swa": 1, "ssm": 1, "local_global": 2, "rg": 3}[
            self.layer_pattern
        ]
        if self.cross_attn_every:
            base = math.lcm(base, self.cross_attn_every)
        if self.is_encoder_decoder:
            base = 1  # enc-dec decoders are uniform (cross-attn every layer)
        return base

    def num_groups(self) -> int:
        return self.num_layers // self.pattern_period()

    def tail_layers(self) -> int:
        return self.num_layers % self.pattern_period()

    def validate(self) -> None:
        assert self.attn_backend in ("reference", "pallas"), self.attn_backend
        assert self.ssm_backend in ("reference", "pallas"), self.ssm_backend
        assert self.d_model % self.num_heads == 0 or self.head_dim
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.num_experts:
            assert 0 < self.experts_per_token <= self.num_experts
        if self.layer_pattern in ("swa", "local_global", "rg"):
            assert self.sliding_window
