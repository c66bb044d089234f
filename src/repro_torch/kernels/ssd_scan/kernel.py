"""Wrapper of the Mamba2 SSD chunked-scan CUDA kernel (``csrc/ssd_scan.cu``;
port of ``repro.kernels.ssd_scan.kernel``).

:func:`ssd_scan` computes the SSD scan chunk by chunk: within a chunk of
Q = min(chunk, L) rows, the lower-triangular C·Bᵀ product with its decay
against x·dt; across chunks, a (P, N) f32 state carried in sequence. The
kernel reads the model's (B, L, H, P) layout, and x, b and c through their
batch and row strides, so neither a transpose nor the split of the conv
output is copied. A block owns one (batch, head) and 16 of its P columns;
the chunk's B, C and scores sit in shared memory, so :func:`check_fits`
bounds the chunk for a given N (the path's 128 at N=128 takes 220 KB).

A CPU tensor goes to the plain version (:func:`.ref.ssd_scan_ref`, the
kernel's own arithmetic); a CUDA tensor launches the kernel or raises.

Examples
--------
On the CPU the wrapper is the plain version:

>>> g = torch.Generator().manual_seed(0)
>>> x = torch.randn(1, 16, 2, 4, generator=g)
>>> dt = torch.rand(1, 16, 2, generator=g)
>>> a = -torch.rand(2, generator=g)
>>> b, c = torch.randn(2, 1, 16, 8, generator=g)
>>> out = ssd_scan(x, dt, a, b, c, chunk=8)
>>> bool(torch.equal(out, ssd_scan_ref(x, dt, a, b, c, chunk=8)))
True
"""
from __future__ import annotations

import torch

from .. import _build
from .._build import I, I64, P
from .ref import ssd_scan_ref

#: head columns a block owns (``kPT`` in the source)
_COLS = 16
#: padded chunk rows the kernel's prefix sum holds (``kMaxQ``)
_MAX_ROWS = 256
#: Hopper's opt-in shared memory per block, where torch does not report it
_HOPPER_SMEM = 227 * 1024

SSD = _build.Kernel(
    "ssd_scan", "ssd_scan.cu", "ssd_scan_launch",
    [P, P, P, P, P, P, I, I, I, I, I, I, I64, I64, I64, I64, I64, I64, P])


def smem_bytes(q: int, n: int) -> int:
    """Dynamic shared memory of one block at chunk ``q`` and state size
    ``n`` (``smem_floats`` in the source): Cᵀ, Bᵀ and the score tile with
    rows padded to 32 (plus 4), then x·dt, Sᵀ and three per-row arrays."""
    qp = -(-q // 32) * 32
    ldq = qp + 4
    return 4 * (2 * n * ldq + qp * ldq + qp * _COLS + n * _COLS + 3 * qp)


def check_fits(q: int, n: int, limit: int) -> None:
    """Raise unless a block at chunk ``q`` and state size ``n`` fits in
    ``limit`` bytes of shared memory (and its padded chunk in the prefix
    sum's registers).

    >>> check_fits(128, 128, _HOPPER_SMEM)
    >>> check_fits(256, 128, _HOPPER_SMEM)
    Traceback (most recent call last):
    ...
    ValueError: ssd_scan: chunk 256 with N=128 needs 560128 bytes of shared memory per block, more than the card's 232448
    """
    need = smem_bytes(q, n)
    if -(-q // 32) * 32 > _MAX_ROWS or need > limit:
        raise ValueError(
            f"ssd_scan: chunk {q} with N={n} needs {need} bytes of shared "
            f"memory per block, more than the card's {limit}")


def _smem_limit(device) -> int:
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", _HOPPER_SMEM)


def _check_operands(x, dt, a, b, c) -> None:
    """dt and a contiguous; x, b and c any batch and row strides, packed
    within a row; all float32 on one CUDA device."""
    _build.check_cuda_f32("ssd_scan", dt, a)
    for name, t in (("x", x), ("b", b), ("c", c)):
        if not t.is_cuda or t.dtype != torch.float32 or t.device != dt.device:
            raise ValueError(f"ssd_scan: {name} must be float32 on "
                             f"{dt.device}, got {t.dtype} on {t.device}")
    h, p = x.shape[2:]
    if (x.stride(3) != 1 or (h > 1 and x.stride(2) != p)
            or b.stride(2) != 1 or c.stride(2) != 1):
        raise ValueError(
            f"ssd_scan: x strides {x.stride()}, b {b.stride()}, c "
            f"{c.stride()}: a row of x (H, P), b or c (N) must be packed")


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, N), float32.
    Returns y (B, L, H, P), contiguous. On a CUDA device x, b and c may be
    strided views along their batch and sequence axes."""
    if _build.on_cpu(x):
        return ssd_scan_ref(x, dt, a, b, c, chunk=chunk)
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if (dt.shape != (bsz, l, h) or a.shape != (h,)
            or b.shape != (bsz, l, n) or c.shape != b.shape):
        raise ValueError(
            f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)} "
            "do not match")
    q = min(chunk, l)
    if q <= 0 or l % q:
        raise ValueError(f"ssd_scan: sequence {l} is not a multiple of the "
                         f"chunk {q}")
    if min(bsz, h, p, n) == 0 or bsz * h > 2 ** 31 - 1:
        raise ValueError(f"ssd_scan: unsupported shape {tuple(x.shape)} "
                         f"with N={n}")
    _check_operands(x, dt, a, b, c)
    check_fits(q, n, _smem_limit(x.device))
    if not _build.aligned16(x, dt, a, b, c):
        raise ValueError("ssd_scan: operands must be 16-byte aligned")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    SSD(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), bsz, l, h, p, n, q, x.stride(0),
        x.stride(1), b.stride(0), b.stride(1), c.stride(0), c.stride(1),
        _build.stream_of(x))
    return y
