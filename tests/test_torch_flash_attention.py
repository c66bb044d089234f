"""The port's flash attention (B12) on the CPU, held against the JAX
package: its plain version against the Pallas kernel run in interpret
mode (as ``tests/test_kernels.py`` runs it) over causal masking, sliding
windows, logit soft-capping, GQA, a ragged sequence and head dim 256 over
one KV head (recurrentgemma's), and the model's self-attention (kernel
forward, plain-version gradient) against the JAX package's
``custom_vjp`` in value and gradient, and the reference
backend's long-sequence path (``_chunked_attention``) against the JAX
package's at a small block.

Tolerances: outputs at atol 2e-6 (the two sum the logits and the weighted
values in another order: ~5e-7 measured on unit-normal inputs); gradients
at rtol 1e-5 / atol 1e-6. On the CPU the wrapper runs its plain version, so
the kernel route is held against it exactly. The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py`` (phase
``flash_kernels``), within TOL_FLASH = 2e-5 on unit-normal inputs. Its
products run on TF32 tensor cores in a three-term split; the TF32 cases
below emulate that on the CPU (``_attention_tf32``) at the language-model
path's shape and show that the split meets TOL_FLASH against the JAX
package's ``attention_ref`` where one-term TF32 does not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash
from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.attention import _chunked_attention as jax_chunked
from repro.models.attention import _flash_self_attention as jax_self
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.attention import _chunked_attention, _flash_self_attention

OUT_ATOL = 2e-6
# chip_smoke.py's bar for the CUDA kernel against the plain version
TOL_FLASH = 2e-5
# the language-model path's shape: qwen2-0.5b's 14 query heads over 2 KV
# heads, head_dim 64, one causal sequence of 1024
PATH_SHAPE = dict(b=1, h=14, kh=2, s=1024, d=64)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)

# (B, H, Kh, S, D, options): the path's causal GQA, a window, a soft cap,
# grouped heads with both, plain multi-head, and a sequence that is not a
# multiple of the JAX kernel's block (padded there, masked here).
CASES = {
    "causal_gqa": (1, 4, 2, 64, 8, {}),
    "window": (2, 4, 1, 64, 16, dict(window=24)),
    "softcap": (1, 2, 2, 64, 8, dict(softcap=5.0)),
    "window_softcap_gqa": (1, 6, 2, 64, 16, dict(window=10, softcap=3.0)),
    "mha": (2, 3, 3, 32, 8, {}),
    "ragged": (1, 6, 2, 50, 8, {}),
    "ragged_window": (1, 4, 2, 37, 8, dict(window=9)),
    # recurrentgemma's attention: query heads over one KV head of 256,
    # under a window shorter than the sequence
    "d256_mqa_window": (1, 4, 1, 64, 256, dict(window=24)),
}


def _inputs(case, seed=0):
    b, h, kh, s, d, kw = CASES[case]
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, s, d).astype(np.float32)
    k = rs.randn(b, kh, s, d).astype(np.float32)
    v = rs.randn(b, kh, s, d).astype(np.float32)
    return q, k, v, kw


def _jax_kernel(q, k, v, kw):
    """The Pallas kernel in interpret mode, through the JAX wrapper (which
    pads) when S is not a multiple of the block."""
    if q.shape[2] % 16 == 0:
        out = jax_flash(q, k, v, causal=True, block_q=16, block_k=16,
                        interpret=True, **kw)
    else:
        out = jax_attention(q, k, v, causal=True, block_q=16, block_k=16,
                            **kw)
    return np.asarray(out)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_pallas_kernel(case):
    q, k, v, kw = _inputs(case)
    want = _jax_kernel(q, k, v, kw)
    got = attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        causal=True, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_ATOL)


@pytest.mark.parametrize("case", ["causal_gqa", "window_softcap_gqa",
                                  "ragged", "d256_mqa_window"])
def test_entry_point_runs_the_plain_version_on_the_cpu(case):
    q, k, v, kw = _inputs(case)
    q, k, v = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    before = fk.FLASH.launches
    got = fk.flash_attention(q, k, v, causal=True, **kw)
    want = attention_ref(q, k, v, causal=True, **kw)
    assert torch.equal(got, want)
    assert fk.FLASH.launches == before        # no launch on the CPU


def test_wrapper_refuses_other_devices():
    q = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError):
        fk.flash_attention(q, q, q)
    assert fk.HEAD_DIMS == (64, 128, 256)
    assert fk.FLASH in _build.KERNELS


@pytest.mark.parametrize("case", ["causal_gqa", "window_softcap_gqa",
                                  "ragged", "d256_mqa_window"])
def test_self_attention_value_and_gradient_match_jax(case):
    """The model's layout (B, S, H, D): forward through the kernel route,
    backward through the plain version, against the JAX package's
    ``custom_vjp`` (Pallas forward, reference VJP)."""
    q, k, v, kw = _inputs(case, seed=1)
    q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
    cap, window = kw.get("softcap"), kw.get("window")
    scale = q.shape[-1] ** -0.5
    cot = np.random.RandomState(2).randn(*q.shape).astype(np.float32)

    def jax_loss(q, k, v):
        out = jax_self(q, k, v, scale=scale, cap=cap, window=window)
        return jnp.sum(out * cot), out

    (_, j_out), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    t_out = _flash_self_attention(tq, tk, tv, scale=scale, cap=cap,
                                  window=window)
    t_grads = torch.autograd.grad((t_out * torch.tensor(cot)).sum(),
                                  (tq, tk, tv))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               rtol=0, atol=OUT_ATOL)
    for tg, jg in zip(t_grads, j_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD_TOL)


def test_self_attention_gradient_is_the_plain_versions():
    """Within the port: the custom backward equals autograd through the
    plain version, bit for bit (it is that computation)."""
    q, k, v, kw = _inputs("window_softcap_gqa", seed=3)
    args = [torch.tensor(a.transpose(0, 2, 1, 3).copy(), requires_grad=True)
            for a in (q, k, v)]
    out = _flash_self_attention(*args, scale=0.3, cap=kw["softcap"],
                                window=kw["window"])
    g1 = torch.autograd.grad(out.square().sum(), args)
    ref = attention_ref(*(a.transpose(1, 2) for a in args), causal=True,
                        window=kw["window"], softcap=kw["softcap"],
                        scale=0.3).transpose(1, 2)
    g2 = torch.autograd.grad(ref.square().sum(), args)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case,causal", [
    ("causal_gqa", True), ("window_softcap_gqa", True), ("mha", False),
    ("window", False)])
def test_chunked_attention_matches_jax(case, causal):
    """The reference backend's path for S >= 8192, here at block 16 over
    the model's (B, S, H, D) layout: atol 2e-6 (sum order)."""
    q, k, v, kw = _inputs(case, seed=4)
    q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
    opts = dict(scale=q.shape[-1] ** -0.5, cap=kw.get("softcap"),
                causal=causal, window=kw.get("window"), block=16)
    want = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **opts))
    got = _chunked_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), **opts)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_ATOL)


def _round_tf32(x):
    """Rounds float32 ``x`` to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest value with 10 explicit mantissa bits (the 13 low bits cleared),
    ties away from zero. Finite inputs."""
    bits = x.float().contiguous().view(torch.int32)
    # sign-magnitude: adding half the dropped range rounds the magnitude
    # half up, which is ties away from zero for either sign
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_einsum(eq, a, b, terms):
    """``torch.einsum`` of two operands as TF32 tensor cores take them,
    exact products summed in f32: ``terms=1`` is plain TF32 (a_hi·b_hi),
    ``terms=3`` the kernel's split a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with
    x_hi = tf32(x), x_lo = tf32(x − x_hi) (the dropped a_lo·b_lo is ~2⁻²²
    of a·b)."""
    a_hi, b_hi = _round_tf32(a), _round_tf32(b)
    if terms == 1:
        return torch.einsum(eq, a_hi, b_hi)
    a_lo, b_lo = _round_tf32(a - a_hi), _round_tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _attention_tf32(q, k, v, terms):
    """Causal GQA ``attention_ref`` with both products (Q·Kᵀ and P·V) taken
    by :func:`_tf32_einsum`; the softmax in f32, as the reference's."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    qg = q.reshape(b, kh, h // kh, s, d)
    logits = _tf32_einsum("bkgsd,bktd->bkgst", qg, k, terms) * d ** -0.5
    idx = torch.arange(s)
    logits = torch.where(idx[None, :] <= idx[:, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return _tf32_einsum("bkgst,bktd->bkgsd", probs, v, terms).reshape(
        b, h, s, d)


def test_round_tf32_is_nearest_ties_away():
    """``_round_tf32`` against float64 arithmetic: the nearest multiple of
    the value's TF32 ulp (2^(e - 11) for x = m·2^e, 1/2 <= |m| < 1), ties
    away from zero; on random values and on exact ties of both signs."""
    rs = np.random.RandomState(5)
    x = (rs.randn(4096) * 10.0 ** rs.uniform(-6, 6, 4096)).astype(np.float32)
    ulp = np.ldexp(1.0, np.frexp(x.astype(np.float64))[1] - 11)
    ties = (np.float32(rs.randint(1024, 2048, 64)) + np.float32(0.5)) * ulp[:64]
    x = np.concatenate([x, ties.astype(np.float32), -ties.astype(np.float32)])
    x64 = x.astype(np.float64)
    ulp = np.ldexp(1.0, np.frexp(x64)[1] - 11)
    want = np.sign(x64) * np.floor(np.abs(x64) / ulp + 0.5) * ulp
    got = _round_tf32(torch.tensor(x)).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def path_inputs():
    """Unit-normal q, k, v at the path's shape, and the JAX package's
    ``attention_ref`` on them (causal)."""
    b, h, kh, s, d = (PATH_SHAPE[k] for k in ("b", "h", "kh", "s", "d"))
    rs = np.random.RandomState(7)
    q = rs.randn(b, h, s, d).astype(np.float32)
    k = rs.randn(b, kh, s, d).astype(np.float32)
    v = rs.randn(b, kh, s, d).astype(np.float32)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True))
    return q, k, v, want


@pytest.mark.parametrize("terms,within", [(3, True), (1, False)],
                         ids=["split_3xtf32", "plain_tf32"])
def test_tf32_products_against_the_kernel_tolerance(path_inputs, terms,
                                                    within):
    """Attention with both products in TF32, emulated on the CPU: the
    kernel's three-term split stays within TOL_FLASH of the JAX package's
    ``attention_ref`` at the path's shape (~1.2e-6 measured); one-term TF32
    misses it by far (~1.2e-3), which is why the kernel splits."""
    q, k, v, want = path_inputs
    got = _attention_tf32(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          terms)
    err = float(np.abs(got.numpy() - want).max())
    assert np.isfinite(err)
    assert (err <= TOL_FLASH) == within, err
