"""Pytree checkpoints in the JAX package's byte layout, without ``msgpack``
(port of ``repro.checkpoint.serialize``).

A checkpoint is one msgpack map::

    {"treedef": str, "leaves": [{"dtype": str, "shape": [int, ...],
                                 "data": bin}, ...]}

with the leaves in ``jax.tree.flatten`` order: dict keys sorted, tuples and
lists in order, named tuples (``AdaSEGState``) in field order, ``None`` and
empty containers holding no leaf. ``data`` is the leaf's C-order bytes
(bfloat16 leaves are stored as float32 under the dtype name
``"bfloat16"``). The JAX loader ignores ``treedef``, so the port writes
its own name there (:data:`TREEDEF`).

The encoder and decoder below cover the msgpack types this layout uses
(map, str, array, bin, int, nil, plus bool and float64 when reading) and
choose the same encodings as ``msgpack.packb``, so the JAX package's
``load_pytree`` reads a port checkpoint and :func:`load_pytree` reads the
JAX package's.

Examples
--------
>>> import os, tempfile
>>> import numpy as np, torch
>>> path = os.path.join(tempfile.mkdtemp(), "ck.msgpack")
>>> tree = {"b": (torch.arange(3, dtype=torch.int32),), "a": np.uint32(7)}
>>> save_pytree(path, tree) > 0
True
>>> back = load_pytree(path, tree)
>>> back["b"][0].tolist(), int(back["a"])
([0, 1, 2], 7)
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

#: the ``treedef`` string of a port checkpoint (the loaders ignore it)
TREEDEF = "repro_torch"


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> list:
    """Leaves in ``jax.tree.flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_flatten(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """The structure of ``like`` with ``leaves`` (an iterator) in place."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(tree_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(tree_unflatten(v, leaves) for v in like)
    return next(leaves)


# ---------------------------------------------------------------------------
# msgpack, the subset the layout uses
# ---------------------------------------------------------------------------

def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out += b"\xc0"
    elif isinstance(obj, bool):
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, fix=(0xA0, 32), codes=(0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), out, fix=None, codes=(0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, fix=(0x90, 16), codes=(None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, fix=(0x80, 16), codes=(None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _pack_len(n: int, out: bytearray, *, fix, codes) -> None:
    """A length header: the fix form, then the 8-, 16- and 32-bit forms
    (None where the type has no such form)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"object of length {n} is too large")


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out += struct.pack(">b", x)
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if x < top:
                out += struct.pack(fmt, code, x)
                return
        raise ValueError(f"integer {x} is too large")
    else:
        for code, fmt, bot in ((0xD0, ">Bb", -(1 << 7)),
                               (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)),
                               (0xD3, ">Bq", -(1 << 63))):
            if x >= bot:
                out += struct.pack(fmt, code, x)
                return
        raise ValueError(f"integer {x} is too small")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for the types of the layout."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _unpack(buf: bytes, pos: int):
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x8F:
        return _unpack_map(buf, pos, code & 0x0F)
    if 0x90 <= code <= 0x9F:
        return _unpack_array(buf, pos, code & 0x0F)
    if 0xA0 <= code <= 0xBF:
        n = code & 0x1F
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if code in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[code], pos
    if code in _FIXED:
        fmt = _FIXED[code]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if code in _LENGTHS:
        fmt, kind = _LENGTHS[code]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if kind == "bin":
            return bytes(buf[pos:pos + n]), pos + n
        if kind == "str":
            return buf[pos:pos + n].decode("utf-8"), pos + n
        if kind == "array":
            return _unpack_array(buf, pos, n)
        return _unpack_map(buf, pos, n)
    raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")


def _unpack_array(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _unpack_map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for the types of the layout."""
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the object")
    return obj


# ---------------------------------------------------------------------------
# Leaves and files
# ---------------------------------------------------------------------------

def _pack_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(x.shape),
                    "data": x.float().numpy().tobytes()}
        x = x.numpy()
    arr = np.asarray(x)
    return {"dtype": arr.dtype.name, "shape": list(arr.shape),
            "data": arr.tobytes()}


def _unpack_leaf(d, like):
    """A stored leaf as the type of ``like``: a tensor on ``like``'s device,
    else a numpy array."""
    stored = "float32" if d["dtype"] == "bfloat16" else d["dtype"]
    arr = np.frombuffer(d["data"], np.dtype(stored)).reshape(d["shape"])
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch {arr.shape} vs {tuple(like.shape)}")
    if not isinstance(like, torch.Tensor):
        want = np.asarray(like).dtype
        if arr.dtype != want:
            raise ValueError(f"dtype mismatch {arr.dtype} vs {want}")
        return arr.copy()
    t = torch.from_numpy(arr.copy())
    if d["dtype"] == "bfloat16":
        t = t.to(torch.bfloat16)
    if t.dtype != like.dtype:
        raise ValueError(f"dtype mismatch {d['dtype']} vs {like.dtype}")
    return t.to(like.device)


def save_pytree(path: str, tree) -> int:
    """Write ``tree`` atomically; returns the bytes written."""
    blob = packb({"treedef": TREEDEF,
                  "leaves": [_pack_leaf(x) for x in tree_flatten(tree)]})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return len(blob)


def load_pytree(path: str, like):
    """Restore into the structure of ``like`` (leaf count, shapes and dtypes
    checked): tensors where ``like`` holds tensors, numpy arrays
    elsewhere."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    leaves_like = tree_flatten(like)
    stored = payload["leaves"]
    if len(stored) != len(leaves_like):
        raise ValueError(f"checkpoint has {len(stored)} leaves, expected "
                         f"{len(leaves_like)}")
    leaves = [_unpack_leaf(d, ref) for d, ref in zip(stored, leaves_like)]
    return tree_unflatten(like, iter(leaves))
