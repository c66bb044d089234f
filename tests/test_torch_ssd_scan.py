"""The port's SSD scan (B13's plain versions, their phases, its CPU wrapper,
the chunked reference and the kernel route's gradient) against the JAX
package, on identical numpy inputs. The Pallas kernel runs in interpret mode, as
``tests/test_kernels.py`` runs it.

Tolerances: port vs JAX for the same algorithm, a max abs difference of
5e-6 of the largest output (f32 sum order: matmul blocking and the prefix
sum differ; outputs reach ~90, so an elementwise rtol would be all noise
at the small ones); any chunked form against the sequential recurrence,
the JAX test's own bar, rtol 2e-4 / atol 2e-4; gradients, each leaf's max
abs difference within 1e-5 of its largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan.kernel import SMEM_BYTES, check_fits, ssd_scan
from repro_torch.kernels.ssd_scan.ref import (
    chunk_cum_ref,
    chunk_gram_ref,
    chunk_scan_ref,
    chunk_states_ref,
    ssd_ref,
    ssd_scan_phases_ref,
    ssd_scan_ref,
    state_pass_ref,
)
from repro_torch.models.ssm import _ssd_pallas, ssd_chunked

SAME = 5e-6
ORACLE = dict(rtol=2e-4, atol=2e-4)
GRAD = 1e-5
# the JAX kernel test's grid: (L, chunk) x (H, P, N)
GRID = [(lc, hpn) for lc in [(64, 8), (64, 16), (128, 64), (96, 32)]
        for hpn in [(2, 16, 32), (4, 32, 16)]]


def _ids(case):
    (l, chunk), (h, p, n) = case
    return f"L{l}-Q{chunk}-H{h}-P{p}-N{n}"


def _softplus(v):
    return np.logaddexp(v, 0.0).astype(np.float32)


def _inputs(seed, bsz, l, h, p, n, a_scale=1.0):
    """x, dt (softplus of a normal), a = −exp(normal)·a_scale, b, c."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bsz, l, h, p)).astype(np.float32),
            _softplus(rng.normal(size=(bsz, l, h))),
            (-np.exp(rng.normal(size=(h,))) * a_scale).astype(np.float32),
            rng.normal(size=(bsz, l, n)).astype(np.float32),
            rng.normal(size=(bsz, l, n)).astype(np.float32))


def _same(got, want, bar=SAME):
    """max |got − want| ≤ bar · max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= bar * scale, (err, scale)


def _t(args, grad=False):
    return tuple(torch.tensor(v, requires_grad=grad) for v in args)


def _j(args):
    return tuple(jnp.asarray(v) for v in args)


@pytest.mark.parametrize("case", GRID, ids=_ids)
def test_ssd_ref_matches_jax(case):
    (l, _), (h, p, n) = case
    args = _inputs(1, 2, l, h, p, n)
    got = ssd_ref(*_t(args))
    _same(got.numpy(), jax_ssd_ref(*_j(args)))


@pytest.mark.parametrize("case", GRID, ids=_ids)
def test_ssd_scan_ref_matches_the_pallas_kernel(case):
    """The kernel's arithmetic in the port against the Pallas kernel in
    interpret mode, and both against the recurrence at the JAX bar."""
    (l, chunk), (h, p, n) = case
    args = _inputs(2, 2, l, h, p, n)
    got = ssd_scan_ref(*_t(args), chunk=chunk).numpy()
    want = np.asarray(jax_ssd_scan(*_j(args), chunk=chunk, interpret=True))
    _same(got, want)
    np.testing.assert_allclose(got, jax_ssd_ref(*_j(args)), **ORACLE)


@pytest.mark.parametrize("case", GRID, ids=_ids)
def test_ssd_chunked_matches_jax(case):
    (l, chunk), (h, p, n) = case
    args = _inputs(3, 2, l, h, p, n)
    got = ssd_chunked(*_t(args), chunk).numpy()
    _same(got, jax_ssd_chunked(*_j(args), chunk))
    np.testing.assert_allclose(got, ssd_ref(*_t(args)).numpy(), **ORACLE)


def test_chunk_invariance():
    args = _t(_inputs(4, 1, 128, 2, 16, 8))
    outs = [ssd_scan_ref(*args, chunk=q) for q in (8, 16, 32, 128)]
    outs += [ssd_chunked(*args, q) for q in (8, 32)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("chunk", [8, 16])
def test_kernel_route_gradient_matches_jax_vjp(chunk):
    """``_ssd_pallas`` (the kernel's plain version forward, the chunked
    reference's gradient backward) against ``jax.vjp`` of the JAX
    package's ``ssd_chunked`` with the same cotangent."""
    args = _inputs(5, 2, 32, 3, 8, 12)
    cot = np.random.default_rng(6).normal(size=(2, 32, 3, 8)).astype(
        np.float32)
    targs = _t(args, grad=True)
    out = _ssd_pallas(*targs, chunk)
    grads = torch.autograd.grad(out, targs, torch.tensor(cot))
    jout, pull = jax.vjp(lambda *z: jax_ssd_chunked(*z, chunk), *_j(args))
    _same(out.detach().numpy(), jout)
    for g, w in zip(grads, pull(jnp.asarray(cot))):
        _same(g.numpy(), w, GRAD)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    args = _t(_inputs(7, 2, 64, 2, 16, 8))
    assert torch.equal(ssd_scan(*args, chunk=16),
                       ssd_scan_ref(*args, chunk=16))
    assert torch.equal(ssd_scan(*args, chunk=128),
                       ssd_scan_ref(*args, chunk=64))   # Q = min(chunk, L)


def test_large_decay_stays_finite():
    """|a| up to ~1e3·e: the exponent above the diagonal reaches ~1e5, so
    an ``exp`` taken before the mask would overflow; the values and every
    gradient stay finite and match the recurrence."""
    args = _inputs(8, 1, 64, 4, 8, 8, a_scale=1000.0)
    targs = _t(args, grad=True)
    for fn in (lambda *z: _ssd_pallas(*z, 16), lambda *z: ssd_chunked(*z, 16)):
        out = fn(*targs)
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.detach().numpy(),
                                   ssd_ref(*_t(args)).numpy(), **ORACLE)
        grads = torch.autograd.grad(out.sum(), targs)
        assert all(torch.isfinite(g).all() for g in grads)


def test_wrapper_refuses_other_devices_and_ragged_chunks():
    x = torch.empty(1, 16, 2, 4, device="meta")
    dt, a = torch.empty(1, 16, 2, device="meta"), torch.empty(2, device="meta")
    b = torch.empty(1, 16, 8, device="meta")
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, b, b, chunk=8)
    args = _t(_inputs(9, 1, 24, 2, 4, 8))
    with pytest.raises(ValueError):
        ssd_scan(*args, chunk=16)


@pytest.mark.parametrize("q,n,fits", [(128, 128, True), (64, 128, True),
                                      (8, 16, True), (256, 128, True),
                                      (192, 128, True), (256, 1, True),
                                      (512, 128, False), (264, 16, False)])
def test_shared_memory_bounds_the_chunk(q, n, fits):
    """The kernels' shared memory is static (two stages of two 64 × 36
    operand tiles, and 256 rows of prefix sums and dt): 38 KB whatever the
    chunk or N, under the 48 KB a block gets without opt-in. A chunk whose
    rows, padded to 32, pass the prefix sum's 256 is refused by name
    before any launch."""
    assert SMEM_BYTES == 4 * (2 * 2 * 64 * 36 + 2 * 256) == 38912 <= 48 * 1024
    if fits:
        check_fits(q, n)
    else:
        with pytest.raises(ValueError, match=f"chunk {q} with N={n}"):
            check_fits(q, n)


@pytest.mark.parametrize("case", GRID, ids=_ids)
def test_phases_compose_to_the_pallas_kernel(case):
    """The phases' plain versions, composed as the kernels launch them
    (cb, chunk_state, state_pass, chunk_scan), are ``ssd_scan_phases_ref``
    and match the chunk-by-chunk ``ssd_scan_ref``, the Pallas kernel in
    interpret mode and the JAX recurrence within 5e-6 of the largest
    |y|."""
    (l, chunk), (h, p, n) = case
    args = _inputs(10, 2, l, h, p, n)
    x, dt, a, b, c = _t(args)
    cum = chunk_cum_ref(dt, a, chunk)
    gram = chunk_gram_ref(b, c, chunk)
    states_in = state_pass_ref(chunk_states_ref(x, dt, b, cum), cum)
    got = chunk_scan_ref(x, dt, c, gram, cum, states_in)
    assert torch.equal(got, ssd_scan_phases_ref(x, dt, a, b, c, chunk=chunk))
    _same(got.numpy(), ssd_scan_ref(x, dt, a, b, c, chunk=chunk).numpy())
    _same(got.numpy(), jax_ssd_scan(*_j(args), chunk=chunk, interpret=True))
    _same(got.numpy(), jax_ssd_ref(*_j(args)))


def _f64_phases(args, q):
    """The phases in float64 numpy, written from their definitions: cum,
    C·Bᵀ (lower triangle), each chunk's own state, the entering states."""
    x, dt, a, b, c = (v.astype(np.float64) for v in args)
    bsz, l, h, p = x.shape
    nc = l // q
    cum = np.cumsum((dt * a).reshape(bsz, nc, q, h), axis=2)
    cum = cum.transpose(0, 1, 3, 2)                               # (B,C,H,Q)
    bq, cq = b.reshape(bsz, nc, q, -1), c.reshape(bsz, nc, q, -1)
    gram = np.tril(np.einsum("bcin,bcjn->bcij", cq, bq))
    xdt = (x * dt[..., None]).reshape(bsz, nc, q, h, p)
    dec = np.exp(cum[..., -1:] - cum)                             # (B,C,H,Q)
    states = np.einsum("bchj,bcjhp,bcjn->bchpn", dec, xdt, bq)
    entering = np.zeros_like(states)
    for ic in range(1, nc):
        entering[:, ic] = (np.exp(cum[:, ic - 1, :, -1])[..., None, None]
                           * entering[:, ic - 1] + states[:, ic - 1])
    return cum, gram, states, entering


@pytest.mark.parametrize("case", GRID, ids=_ids)
def test_phase_plain_versions_match_float64(case):
    """Each phase's plain version against its definition in float64, each
    within 1e-6 of its largest entry (f32 rounding over sums of at most
    128 terms)."""
    (l, chunk), (h, p, n) = case
    args = _inputs(11, 2, l, h, p, n)
    x, dt, a, b, c = _t(args)
    cum, gram, states, entering = _f64_phases(args, chunk)
    got_cum = chunk_cum_ref(dt, a, chunk)
    got_states = chunk_states_ref(x, dt, b, got_cum)
    _same(got_cum.numpy(), cum, 1e-6)
    _same(chunk_gram_ref(b, c, chunk).numpy(), gram, 1e-6)
    _same(got_states.numpy(), states, 1e-6)
    _same(state_pass_ref(torch.tensor(states, dtype=torch.float32),
                         torch.tensor(cum, dtype=torch.float32)).numpy(),
          entering, 1e-6)
