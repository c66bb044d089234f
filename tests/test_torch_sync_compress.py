"""The port's server merge (plain twin and tree-level op) against the JAX
package's ``merge_ref`` and its Pallas ``merge_stacked`` in interpret mode,
on identical numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sync_weighted_stacked as jax_sync
from repro.kernels.sync_compress import kernel as jk
from repro.kernels.sync_compress import ref as jref
from repro_torch.core import sync_weighted_stacked
from repro_torch.kernels.sync_compress import kernel as tk
from repro_torch.kernels.sync_compress import ops as tops
from repro_torch.kernels.sync_compress import ref as tref

M, N, BLOCK = 4, 300, 128
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed, m=M, n=N):
    rng = np.random.default_rng(seed)
    return dict(
        z=rng.uniform(-1, 1, (m, n)).astype(np.float32),
        old=rng.uniform(-1, 1, (m, n)).astype(np.float32),
        w=rng.uniform(0.1, 2.0, (m,)).astype(np.float32),
        recv=np.arange(m) % 2 == 0,
    )


CASES = [
    dict(w=False, normalize=False, recv=False, old=False),
    dict(w=True, normalize=False, recv=False, old=False),
    dict(w=True, normalize=True, recv=False, old=False),
    dict(w=True, normalize=True, recv=True, old=False),
    dict(w=True, normalize=False, recv=True, old=True),
    dict(w=False, normalize=False, recv=True, old=True),
]


# (M, n): the tree leaf's shape and the tolerance. The default, and the
# shapes the CUDA kernel splits differently: one row; 63 rows, in uneven
# row slices; a ragged column count that is no multiple of 4. Unnormalised
# 63-term sums reach |17.6| here and are summed in another order than
# XLA's: a few ulps of 8 to 16 (9.5e-7 and 1.9e-6).
SHAPES = {(M, N): ((20, 15), TOL), (1, 1031): ((1031,), TOL),
          (63, 1031): ((1031,), dict(rtol=1e-6, atol=8e-6))}


def _case_id(shape, case):
    name = "-".join(k for k, v in case.items() if v) or "plain"
    return name if shape == (M, N) else f"M{shape[0]}-N{shape[1]}-{name}"


@pytest.mark.parametrize("shape,case", [
    pytest.param(shape, case, id=_case_id(shape, case))
    for shape in SHAPES for case in CASES])
def test_merge_matches_jax(shape, case):
    m, n = shape
    x = _inputs(1, m, n)
    w = x["w"] if case["w"] else None
    recv = x["recv"] if case["recv"] else None
    old = x["old"] if case["old"] else None

    want_ref = jref.merge_ref(
        jnp.asarray(x["z"]), None if w is None else jnp.asarray(w),
        normalize=case["normalize"],
        recv=None if recv is None else jnp.asarray(recv),
        old=None if old is None else jnp.asarray(old))
    want_ker = jk.merge_stacked(
        jnp.asarray(x["z"]), None if w is None else jnp.asarray(w),
        None if recv is None else jnp.asarray(recv, jnp.float32),
        None if old is None else jnp.asarray(old),
        normalize=case["normalize"], block=BLOCK, interpret=True)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    got_ref = tref.merge_ref(t(x["z"]), t(w), normalize=case["normalize"],
                             recv=t(recv), old=t(old))
    got_wrap = tk.merge_stacked(t(x["z"]), t(w), t(recv), t(old),
                                normalize=case["normalize"])
    leaf, tol = SHAPES[shape]
    leaf = (m, *leaf)
    (got_ops,) = tops.sync_merge_stacked(
        (t(x["z"]).reshape(leaf),), t(w), t(recv),
        None if old is None else (t(old).reshape(leaf),),
        normalize=case["normalize"])
    for got in (got_ref, got_wrap, got_ops.reshape(m, n)):
        for want in (want_ref, want_ker):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("normalize", [False, True])
def test_merge_past_12288_rows_matches_jax(normalize):
    """A fleet past the 12288 rows the card's merge once took: the wrapper,
    the tree op and (normalised) ``sync_weighted_stacked`` against the JAX
    reference. Sums of 12289 terms in another order than XLA's: normalised
    they stay under 0.02 (1.9e-9 apart); raw they reach |170|, where an ulp
    is 1.5e-5 (one apart), hence atol 3e-5 there."""
    m, n = 12289, 5
    x = _inputs(3, m, n)
    z, w = torch.from_numpy(x["z"]), torch.from_numpy(x["w"])
    want = np.asarray(jref.merge_ref(jnp.asarray(x["z"]), jnp.asarray(x["w"]),
                                     normalize=normalize))
    got = [tk.merge_stacked(z, w, normalize=normalize),
           tops.sync_merge_stacked((z,), w, normalize=normalize)[0]]
    if normalize:
        got.append(sync_weighted_stacked((z,), w)[0])
        np.testing.assert_allclose(
            np.asarray(jax_sync((jnp.asarray(x["z"]),),
                                jnp.asarray(x["w"]))[0]), want, **TOL)
    for g in got:
        assert g.shape == (m, n)
        np.testing.assert_allclose(g.numpy(), want,
                                   rtol=1e-6, atol=1e-6 if normalize else 3e-5)


def test_merge_weights_fit_the_opt_in_shared_memory():
    """The card's merge keeps the M weights beside 4 KB of slice partials in
    the opt-in shared memory up to 57088 rows; a larger fleet's weights are
    read from global memory."""
    def smem(rows):
        return 4 * 256 * 4 + 4 * rows

    assert tk.MAX_ROWS >= 16384
    assert smem(tk.MAX_ROWS) <= tk.SHARED_BYTES < smem(tk.MAX_ROWS + 1)


def test_merge_broadcasts_one_row_to_every_receiver():
    x = _inputs(2)
    out = tk.merge_stacked(torch.from_numpy(x["z"]),
                           torch.from_numpy(x["w"]), normalize=True)
    assert out.shape == (M, N) and out.is_contiguous()
    for m in range(1, M):
        torch.testing.assert_close(out[m], out[0], rtol=0, atol=0)


def test_robust_merges_wait_for_a_later_slice():
    """The robust merges have since been ported: a trimmed mean drops each
    coordinate's extremes, Krum the outlying worker (the JAX comparisons
    are in ``tests/test_torch_robust.py``)."""
    z = (torch.tensor([[1.0, 4.0], [9.0, 4.0], [2.0, -8.0], [3.0, 4.0]]),)
    out = tops.sync_merge_stacked(z, agg=("trimmed", 1))[0]
    assert out.tolist() == [[2.5, 4.0]] * 4
    out = tops.sync_merge_stacked(z, agg=("krum", 1, 3))[0]
    torch.testing.assert_close(out[0], (z[0][0] + z[0][1] + z[0][3]) / 3)


def test_wrapper_refuses_other_devices():
    z = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError):
        tk.merge_stacked(z)
