"""The port's server merge (plain twin and tree-level op) against the JAX
package's ``merge_ref`` and its Pallas ``merge_stacked`` in interpret mode,
on identical numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sync_compress import kernel as jk
from repro.kernels.sync_compress import ref as jref
from repro_torch.kernels.sync_compress import kernel as tk
from repro_torch.kernels.sync_compress import ops as tops
from repro_torch.kernels.sync_compress import ref as tref

M, N, BLOCK = 4, 300, 128
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        z=rng.uniform(-1, 1, (M, N)).astype(np.float32),
        old=rng.uniform(-1, 1, (M, N)).astype(np.float32),
        w=rng.uniform(0.1, 2.0, (M,)).astype(np.float32),
        recv=np.array([True, False, True, False]),
    )


CASES = [
    dict(w=False, normalize=False, recv=False, old=False),
    dict(w=True, normalize=False, recv=False, old=False),
    dict(w=True, normalize=True, recv=False, old=False),
    dict(w=True, normalize=True, recv=True, old=False),
    dict(w=True, normalize=False, recv=True, old=True),
    dict(w=False, normalize=False, recv=True, old=True),
]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "-".join(k for k, v in c.items() if v)
                         or "plain")
def test_merge_matches_jax(case):
    x = _inputs(1)
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
    (got_ops,) = tops.sync_merge_stacked(
        (t(x["z"]).reshape(M, 20, 15),), t(w), t(recv),
        None if old is None else (t(old).reshape(M, 20, 15),),
        normalize=case["normalize"])
    for got in (got_ref, got_wrap, got_ops.reshape(M, N)):
        for want in (want_ref, want_ker):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_merge_broadcasts_one_row_to_every_receiver():
    x = _inputs(2)
    out = tk.merge_stacked(torch.from_numpy(x["z"]),
                           torch.from_numpy(x["w"]), normalize=True)
    assert out.shape == (M, N) and out.is_contiguous()
    for m in range(1, M):
        torch.testing.assert_close(out[m], out[0], rtol=0, atol=0)


def test_robust_merges_wait_for_a_later_slice():
    with pytest.raises(NotImplementedError):
        tops.sync_merge_stacked((torch.zeros(2, 3),), agg=("trimmed", 1))


def test_wrapper_refuses_other_devices():
    z = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError):
        tk.merge_stacked(z)
