"""Carry state across from the JAX package as numpy arrays.

The port imports nothing of JAX: a caller turns the JAX objects into numpy
(``np.asarray`` on each array) and these functions build the port's
counterparts from them.

Examples
--------
>>> import numpy as np
>>> key_from_numpy(np.array([0, 7], dtype=np.uint32), device="cpu").tolist()
[0, 7]
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .checkpoint.serialize import tree_flatten, tree_unflatten
from .configs.base import ArchConfig
from .core.adaseg import AdaSEGState
from .problems.bilinear import BilinearGame, game_from_arrays


def key_from_numpy(key, *, device="cuda") -> torch.Tensor:
    """A uint32 ``(..., 2)`` JAX key array as the port's int64 key tensor."""
    arr = np.asarray(key)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"expected uint32 keys of shape (..., 2), got "
                         f"{arr.dtype} {arr.shape}")
    return torch.as_tensor(arr.astype(np.int64), device=resolve_device(device))


def game_from_numpy(a, b, c, sigma: float, *, device="cuda",
                    name: str = "bilinear") -> BilinearGame:
    """The bilinear game with the given coefficients (``a`` (n, n), ``b``
    and ``c`` (n,), float32)."""
    dev = resolve_device(device)

    def t(v):
        return torch.as_tensor(np.array(v, dtype=np.float32), device=dev)

    return game_from_arrays(t(a), t(b), t(c), float(sigma), name)


def ef_from_numpy(leaves, *, device="cuda") -> tuple:
    """A JAX engine's error-feedback residual tree (its ``_ef``: one
    worker-stacked float32 array per payload leaf, or ``()`` without error
    feedback) as the port's tuple of tensors.

    >>> ef = ef_from_numpy([np.zeros((2, 3)), np.ones((2, 4))], device="cpu")
    >>> [tuple(v.shape) for v in ef], ef[1].dtype
    ([(2, 3), (2, 4)], torch.float32)
    """
    dev = resolve_device(device)
    return tuple(torch.as_tensor(np.array(v, dtype=np.float32), device=dev)
                 for v in leaves)


def state_from_numpy(fields, *, device="cuda") -> AdaSEGState:
    """A worker-stacked :class:`AdaSEGState` from a mapping (or namedtuple)
    of numpy arrays with the JAX state's field names; the iterate fields
    are sequences of leaves."""
    dev = resolve_device(device)
    if not isinstance(fields, dict):
        fields = fields._asdict()

    def t(v, dtype):
        return torch.as_tensor(np.array(v, dtype=dtype), device=dev)

    return AdaSEGState(
        z_tilde=tuple(t(v, np.float32) for v in fields["z_tilde"]),
        sum_sq=t(fields["sum_sq"], np.float32),
        t=t(fields["t"], np.int32),
        z_bar=tuple(t(v, np.float32) for v in fields["z_bar"]),
        grad_sq_sum=t(fields["grad_sq_sum"], np.float32),
        worker_id=t(fields["worker_id"], np.int32),
    )


def srv_from_numpy(z, moments, t, *, device="cuda") -> tuple:
    """A JAX engine's outer-optimizer state (its ``_srv``: the server
    anchor's leaves, the moment trees as sequences of leaves, the int32
    round count) as the port's ``(z, moments, t)``.

    >>> z, mom, t = srv_from_numpy([np.zeros((1, 3))], [[np.ones((1, 3))]],
    ...                            np.int32(2), device="cpu")
    >>> tuple(z[0].shape), float(mom[0][0].sum()), t.dtype, int(t)
    ((1, 3), 3.0, torch.int32, 2)
    """
    dev = resolve_device(device)

    def leaves(vs):
        return tuple(torch.as_tensor(np.array(v, dtype=np.float32),
                                     device=dev) for v in vs)

    return (leaves(z), tuple(leaves(m) for m in moments),
            torch.as_tensor(np.array(t, dtype=np.int32), device=dev))


def params_from_numpy(tree, cfg: ArchConfig, *, device="cuda") -> tuple:
    """A JAX model's parameter dict (numpy leaves, with or without leading
    worker axes) as the port's tuple of leaves in ``jax.tree.leaves``
    order, float32. The tree must be ``cfg``'s: the leaf count and each
    leaf's trailing shape are checked against the port's template.

    >>> from repro_torch.models import tiny_lm_config
    >>> cfg = tiny_lm_config()
    >>> tree = params_to_numpy(
    ...     [torch.zeros(2, *t.shape) for t in _template_leaves(cfg)], cfg)
    >>> sorted(tree), len(params_from_numpy(tree, cfg, device="cpu"))
    (['embed', 'final_norm', 'lm_head', 'stages'], 12)
    """
    dev = resolve_device(device)
    leaves = tree_flatten(tree)
    template = _template_leaves(cfg)
    if len(leaves) != len(template):
        raise ValueError(f"{cfg.name}: {len(leaves)} leaves, expected "
                         f"{len(template)}")
    out = []
    for v, t in zip(leaves, template):
        arr = np.array(v, dtype=np.float32)
        if arr.shape[arr.ndim - t.ndim:] != tuple(t.shape):
            raise ValueError(f"{cfg.name}: leaf of shape {arr.shape} where "
                             f"{tuple(t.shape)} is expected")
        out.append(torch.as_tensor(arr, device=dev))
    return tuple(out)


def params_to_numpy(leaves, cfg: ArchConfig) -> dict:
    """The inverse of :func:`params_from_numpy`: the JAX package's nested
    parameter dict with numpy leaves."""
    return tree_unflatten(
        _template_dict(cfg),
        iter(np.asarray(v.detach().cpu()) for v in leaves))


def wgan_params_from_numpy(tree, *, device="cuda") -> tuple:
    """A JAX WGAN iterate ``(gen, disc)`` (each a list of ``{"b", "w"}``
    layers of numpy arrays, with or without leading worker axes) as the
    port's 12 leaves in ``jax.tree.leaves`` order (per network and layer
    ``b`` before ``w``), float32.

    >>> gen = [{"w": np.ones((8, 4)), "b": np.zeros(4)}] * 3
    >>> leaves = wgan_params_from_numpy((gen, gen), device="cpu")
    >>> len(leaves), tuple(leaves[0].shape), tuple(leaves[1].shape)
    (12, (4,), (8, 4))
    """
    dev = resolve_device(device)
    nets = tuple(tree)
    if len(nets) != 2:
        raise ValueError("a WGAN iterate is the pair (gen, disc)")
    out = []
    for net in nets:
        for layer in net:
            if sorted(layer) != ["b", "w"]:
                raise ValueError(f"a WGAN layer has the keys b and w, got "
                                 f"{sorted(layer)}")
            b = np.array(layer["b"], dtype=np.float32)
            w = np.array(layer["w"], dtype=np.float32)
            if w.ndim != b.ndim + 1 or w.shape[-1] != b.shape[-1]:
                raise ValueError(f"layer b {b.shape} does not match w "
                                 f"{w.shape}")
            out += [torch.as_tensor(b, device=dev),
                    torch.as_tensor(w, device=dev)]
    return tuple(out)


def wgan_params_to_numpy(leaves) -> tuple:
    """The inverse of :func:`wgan_params_from_numpy`: ``(gen, disc)``, each
    a list of ``{"b", "w"}`` layers of numpy arrays.

    >>> t = torch.zeros
    >>> gen, disc = wgan_params_to_numpy([t(4), t(8, 4)] * 6)
    >>> len(gen), sorted(disc[2]), disc[2]["w"].shape
    (3, ['b', 'w'], (8, 4))
    """
    leaves = [np.asarray(v.detach().cpu()) for v in leaves]
    if len(leaves) % 4 != 0:
        raise ValueError(f"{len(leaves)} leaves do not make two networks of "
                         "(b, w) layers")
    layers = [{"b": b, "w": w} for b, w in zip(leaves[::2], leaves[1::2])]
    half = len(layers) // 2
    return layers[:half], layers[half:]


def _template_dict(cfg: ArchConfig):
    from .models.transformer import param_template

    return param_template(cfg)


def _template_leaves(cfg: ArchConfig) -> list:
    return tree_flatten(_template_dict(cfg))
