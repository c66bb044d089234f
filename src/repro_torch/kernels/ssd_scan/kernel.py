"""Wrapper of the Mamba2 SSD chunked-scan CUDA kernels (``csrc/ssd_scan.cu``;
port of ``repro.kernels.ssd_scan.kernel``).

:func:`ssd_scan` computes the SSD scan in the state-passing form, chunks of
Q = min(chunk, L) rows in parallel: the chunk's C·Bᵀ once for every head
(``cb``, with the prefix sums of dt·a), each chunk's own (P, N) state
(``chunk_state``), the states entering each chunk, sequential over chunks
only (``state_pass``), and each chunk's output from its C·Bᵀ block and its
entering state (``chunk_scan``). One entry point makes them three
launches (:data:`PHASES`: ``cb`` and ``chunk_state`` share one);
:data:`SSD` counts one launch per call. The kernels read the model's (B, L,
H, P) layout, and x, b and c through their batch and row strides, so
neither a transpose nor the split of the conv output is copied. Shared
memory is static (:data:`SMEM_BYTES`); :func:`check_fits` bounds the
chunk by the 256 rows the prefix sum holds.

A CPU tensor goes to the plain version (:func:`.ref.ssd_scan_ref`, the
Pallas kernel's chunk-by-chunk arithmetic); a CUDA tensor launches the
kernels or raises.

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

from typing import NamedTuple

import torch

from .. import _build
from .._build import I, I64, P
from .ref import ssd_scan_ref

#: output tile edge of the product kernels (``kTile`` in the source)
_TILE = 64
#: reduction depth of one staged operand tile (``kTK``)
_DEPTH = 32
#: chunk rows the prefix sum and the per-row arrays hold (``kMaxQ``)
_MAX_ROWS = 256
#: the mask of each launch, in launch order: cb with chunk_state, the
#: state pass, the chunk scan
PHASES = {"cb_state": 1, "state_pass": 2, "chunk_scan": 4}

SSD = _build.Kernel(
    "ssd_scan", "ssd_scan.cu", "ssd_scan_launch",
    [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I64, I64, I64, I64, I64,
     I64, I, P])


#: static shared memory of the largest block of the kernels (the chunk
#: scan's): two stages of two operand tiles of 64 × (32 + 4) floats, and
#: the chunk's prefix sums and dt at 256 rows; the products walk Q and N in
#: tiles, so it depends on neither, and it is under the 48 KB a block gets
#: without opt-in
SMEM_BYTES = 4 * (2 * 2 * _TILE * (_DEPTH + 4) + 2 * _MAX_ROWS)


def check_fits(q: int, n: int) -> None:
    """Raise unless a chunk of ``q`` rows at state size ``n`` fits: its
    rows, padded to 32, in the prefix sum's 256.

    >>> check_fits(128, 128)
    >>> check_fits(256, 128)
    >>> check_fits(512, 128)
    Traceback (most recent call last):
    ...
    ValueError: ssd_scan: chunk 512 with N=128 has 512 rows padded to 32, more than the 256 the prefix sum holds
    """
    rows = -(-q // 32) * 32
    if rows > _MAX_ROWS:
        raise ValueError(
            f"ssd_scan: chunk {q} with N={n} has {rows} rows padded to 32, "
            f"more than the {_MAX_ROWS} the prefix sum holds")


def _grids_fit(bsz: int, nc: int, q: int, h: int, p: int, n: int) -> bool:
    """True when the launches' grids are within CUDA's limits: the fused
    cb and chunk-state grid (1-D), the state pass's (B·H, N·Pp/1024) and
    the chunk scan's (B·H, L/Q, row tiles × column tiles)."""
    qt, pt, nt = -(-q // _TILE), -(-p // 4) * 4, -(-n // _TILE)
    fused = bsz * ((qt * (qt + 1) // 2 + -(-h // 4)) * nc
                   + h * (nc - 1) * nt * -(-pt // _TILE))
    return (fused < 2 ** 31 and bsz * h < 2 ** 31 and nc <= 65535
            and -(-n * pt // 1024) <= 65535
            and qt * -(-pt // _TILE) <= 65535)


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


class Scratch(NamedTuple):
    """What the phases write. ``g`` (B, L/Q, Qs, Qs): each chunk's C·Bᵀ,
    Qs = Q rounded up to 64 (tiles above the diagonal unwritten); ``cum``
    (B, L/Q, H, Q): the prefix sums of dt·a; ``states`` (B, max(L/Q − 1,
    1), H, N, Pp), Pp = P rounded up to 4: slot c holds chunk c's own
    state Sᵀ after ``cb_state`` and the state entering chunk c + 1
    after ``state_pass``; ``y``: the output."""

    g: torch.Tensor
    cum: torch.Tensor
    states: torch.Tensor
    y: torch.Tensor

    def gram(self, q: int) -> torch.Tensor:
        """C·Bᵀ per chunk, (B, L/Q, Q, Q), lower triangle (j ≤ i) kept."""
        return torch.tril(self.g[..., :q, :q])

    def state_slots(self, p: int) -> torch.Tensor:
        """The state slots as (B, L/Q − 1, H, P, N)."""
        return self.states[..., :p].transpose(-1, -2)


def scratch(x, b, *, chunk: int = 128) -> Scratch:
    """Uninitialised scratch for a call on ``x`` (B, L, H, P) and ``b``
    (B, L, N) at Q = min(chunk, L)."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, l)
    nc = l // q
    qs = -(-q // _TILE) * _TILE
    pp = -(-p // 4) * 4

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    return Scratch(empty(bsz, nc, qs, qs), empty(bsz, nc, h, q),
                   empty(bsz, max(nc - 1, 1), h, n, pp),
                   torch.empty(x.shape, dtype=x.dtype, device=x.device))


def ssd_scan_phases(x, dt, a, b, c, *, chunk: int = 128,
                    phases=tuple(PHASES), out: Scratch | None = None):
    """Make the named launches ``phases`` (a subset of :data:`PHASES`, in
    launch order) on ``out`` (default: new :func:`scratch`) and return it;
    each reads what the earlier ones wrote there. CUDA tensors only;
    :func:`ssd_scan` is the user's entry point."""
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
    if min(bsz, h, p, n) == 0 or not _grids_fit(bsz, l // q, q, h, p, n):
        raise ValueError(f"ssd_scan: unsupported shape {tuple(x.shape)} "
                         f"with N={n}")
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise ValueError(f"ssd_scan: unknown phases {sorted(unknown)}")
    _check_operands(x, dt, a, b, c)
    check_fits(q, n)
    out = scratch(x, b, chunk=q) if out is None else out
    SSD(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), out.y.data_ptr(), out.g.data_ptr(),
        out.states.data_ptr(), out.cum.data_ptr(), bsz, l, h, p, n, q,
        x.stride(0), x.stride(1), b.stride(0), b.stride(1), c.stride(0),
        c.stride(1), sum(PHASES[k] for k in set(phases)),
        _build.stream_of(x))
    return out


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, N), float32.
    Returns y (B, L, H, P), contiguous. On a CUDA device x, b and c may be
    strided views along their batch and sequence axes."""
    if _build.on_cpu(x):
        return ssd_scan_ref(x, dt, a, b, c, chunk=chunk)
    return ssd_scan_phases(x, dt, a, b, c, chunk=chunk).y
