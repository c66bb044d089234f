"""Wrapper of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``; port of
``repro.kernels.flash_attention.kernel``).

:func:`flash_attention` computes blockwise online-softmax attention on
``q`` (B, H, S, D) against ``k``, ``v`` (B, Kh, T, D): causal masking, a
sliding window, logit soft-capping and GQA (query head h reads KV head
h // (H / Kh)). Fully masked key tiles are skipped. The kernel masks keys
past T and writes no row past S, so it needs no padding; its tiles are
64 queries × 32 keys where the TPU kernel's are 512 × 512, which changes
which tiles are skipped but not the result. Its products run on TF32
tensor cores, each operand split into two TF32 terms (three products),
within 2e-5 of the plain version on unit-normal inputs. Head dims 64,
128 and 256 are compiled.

A CPU tensor goes to the plain version (:func:`.ref.attention_ref`); a
CUDA tensor launches the kernel or raises.

Examples
--------
Causal attention on the CPU is the plain version's:

>>> q = torch.randn(1, 2, 16, 8, generator=torch.Generator().manual_seed(0))
>>> out = flash_attention(q, q, q, causal=True)
>>> bool(torch.equal(out, attention_ref(q, q, q, causal=True)))
True
"""
from __future__ import annotations

import torch

from .. import _build
from .._build import F, I, P
from .ref import attention_ref

#: head dims the kernel is compiled for
HEAD_DIMS = (64, 128, 256)

FLASH = _build.Kernel(
    "flash_attention", "flash_attention.cu", "flash_attention_launch",
    [P, P, P, P, I, I, I, I, I, I, F, I, I, I, I, F, P])


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None, scale=None):
    """q: (B, H, S, D); k, v: (B, Kh, T, D), float32. Returns (B, H, S, D)."""
    if _build.on_cpu(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    if k.shape != (b, kh, t, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"flash_attention: {h} heads over {kh} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not compiled "
                         f"(supported: {HEAD_DIMS})")
    if s == 0 or t == 0 or not 0 < b * h <= 65535:
        raise ValueError(f"flash_attention: unsupported shape "
                         f"{tuple(q.shape)} x {tuple(k.shape)}")
    _build.check_cuda_f32("flash_attention", q, k, v)
    if not _build.aligned16(q, k, v):
        raise ValueError("flash_attention: operands must be 16-byte aligned")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    FLASH(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kh,
          s, t, d, float(scale), int(bool(causal)), int(window is not None),
          0 if window is None else int(window), int(softcap is not None),
          0.0 if softcap is None else float(softcap), _build.stream_of(q))
    return out
