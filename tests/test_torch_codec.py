"""The port's codec uplink (the codec stream, the four plain versions and
their wrappers, ``codec_uplink_stacked``, the compressors) against the JAX
package's refs, its Pallas kernels in interpret mode and its ops, on
identical numpy inputs.

Bars: everything is exact — the codec stream, the scale pass (B6), the
eff pass (B8), the mask pass (B9), identity and top-k, and stochastic
quantization (B7), whose rounding decisions are also checked as level
indices. That takes the port following two roundings XLA makes on the
CPU: the effective message ``w·z + ef`` is one FMA (the port rounds once
through float64), and ``scale / levels`` is ``scale`` times the float32
reciprocal of the constant ``levels``. The JAX refs therefore run under
``jit``, as the JAX package's ops and engines run them: run eagerly, they
round ``w·z`` and the sum separately and divide by ``levels``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sync_compress import kernel as jk
from repro.kernels.sync_compress import ops as jops
from repro.kernels.sync_compress import ref as jref
from repro.ps import StochasticQuantizeCompressor as JaxQuantize
from repro.ps import TopKCompressor as JaxTopK
from repro_torch import interop
from repro_torch import random as jr
from repro_torch.kernels.sync_compress import kernel as tk
from repro_torch.kernels.sync_compress import ops as tops
from repro_torch.kernels.sync_compress import ref as tref
from repro_torch.ps import StochasticQuantizeCompressor, TopKCompressor

M, N, BLOCK = 4, 333, 128
LEVELS = 255.0
ALIVE = np.array([1.0, 0.0, 1.0, 1.0], dtype=np.float32)
WEF = [(False, False), (True, False), (False, True), (True, True)]


def _inputs(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return dict(
        z=rng.standard_normal((M, n)).astype(np.float32),
        ef=(0.05 * rng.standard_normal((M, n))).astype(np.float32),
        w=rng.uniform(0.1, 1.0, M).astype(np.float32),
        mask=(rng.random((M, n)) < 0.3).astype(np.uint8),
        keys=np.asarray(jax.random.split(jax.random.PRNGKey(seed + 3), M)),
    )


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _tkeys(keys):
    return interop.key_from_numpy(keys, device="cpu")


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _same_levels(got, want, scale):
    """Identical rounding decisions: the same level index everywhere."""
    lvl = np.asarray(scale, np.float64).reshape(-1, 1) / LEVELS
    np.testing.assert_array_equal(
        np.rint(np.asarray(got, np.float64) / lvl).astype(np.int64),
        np.rint(np.asarray(want, np.float64) / lvl).astype(np.int64))


# ---------------------------------------------------------------------------
# The codec stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 11, 123456, -5])
@pytest.mark.parametrize("n", [1, 7, 333, 4101])
def test_threefry_uniform_bit_exact(seed, n):
    key = jax.random.PRNGKey(seed)
    _exact(tref.threefry_uniform(_tkeys(np.asarray(key)), n),
           jref.threefry_uniform(key, n))


def test_threefry_uniform_batched_keys_and_cipher():
    keys = jax.random.split(jax.random.PRNGKey(3), M)
    want = np.stack([np.asarray(jref.threefry_uniform(k, 50)) for k in keys])
    _exact(tref.threefry_uniform(_tkeys(np.asarray(keys)), 50), want)
    idx = np.arange(9, dtype=np.uint32)
    y0, y1 = jref.threefry2x32(np.uint32(5), np.uint32(9), idx, idx * 3)
    t0, t1 = jr.threefry2x32(torch.tensor(5), torch.tensor(9),
                             torch.from_numpy(idx.astype(np.int64)),
                             torch.from_numpy(idx.astype(np.int64) * 3))
    _exact(t0, np.asarray(y0).astype(np.int64))
    _exact(t1, np.asarray(y1).astype(np.int64))


def test_codec_stream_is_not_the_bits_stream():
    key = jr.PRNGKey(4, device="cpu")
    u = tref.threefry_uniform(key, 64)
    v = tref.bits_to_uniform(jr.bits(key, (64,)))
    assert not torch.equal(u, v)


# ---------------------------------------------------------------------------
# The four kernels' plain versions and wrappers (CPU tensors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("has_w,has_ef", WEF)
@pytest.mark.parametrize("n", [N, 35])
def test_uplink_stats_exact(has_w, has_ef, n):
    x = _inputs(1, n)
    w = x["w"] if has_w else None
    ef = x["ef"] if has_ef else None
    stats = jax.jit(lambda z, e, w: jref.uplink_stats_ref(z, ef=e, w=w))
    want_ref = [stats(_j(x["z"][m]), None if ef is None else _j(ef[m]),
                      None if w is None else w[m]) for m in range(M)]
    want_ker = jk.uplink_stats(_j(x["z"]), _j(w), _j(ef), block=BLOCK,
                               interpret=True)
    got_ref = tref.uplink_stats_ref(_t(x["z"]), _t(ef), _t(w))
    got_wrap = tk.uplink_stats(_t(x["z"]), _t(w), _t(ef))
    for got in (got_ref, got_wrap):
        _exact(got, np.array(want_ref))
        _exact(got, want_ker)


@pytest.mark.parametrize("has_w,has_ef", WEF)
def test_eff_uplink_exact(has_w, has_ef):
    x = _inputs(2)
    w = x["w"] if has_w else None
    ef = x["ef"] if has_ef else None
    want_ref = jax.jit(lambda z, e, w: jref.eff_uplink_ref(
        z, ef=e, w=None if w is None else w[:, None]))(_j(x["z"]), _j(ef),
                                                        _j(w))
    want_ker = jk.eff_uplink(_j(x["z"]), _j(w), _j(ef), block=BLOCK,
                             interpret=True)
    for got in (tref.eff_uplink_ref(_t(x["z"]), _t(ef), _t(w)),
                tk.eff_uplink(_t(x["z"]), _t(w), _t(ef))):
        _exact(got, want_ref)
        _exact(got, want_ker)


def test_effective_message_rounds_once_like_xla():
    """XLA fuses w·z + ef into one FMA; a two-step f32 sum differs from it
    in about a quarter of the elements, the port's single rounding in
    none."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((M, 20000)).astype(np.float32)
    ef = (0.05 * rng.standard_normal((M, 20000))).astype(np.float32)
    w = rng.uniform(0.1, 1.0, M).astype(np.float32)
    (want,), _ = jops.codec_uplink_stacked(
        (_j(z),), None, w=_j(w), ef=(_j(ef),), codec=("identity",))
    got = tref.effective_message(_t(z), _t(ef), _t(w))
    _exact(got, want)
    assert (np.asarray(want) != w[:, None] * z + ef).sum() > 0


@pytest.mark.parametrize("has_alive", [False, True])
@pytest.mark.parametrize("has_ef", [False, True])
def test_mask_uplink_exact(has_alive, has_ef):
    x = _inputs(3)
    eff, mask = x["z"], x["mask"]
    alive = ALIVE if has_alive else None
    ef = x["ef"] if has_ef else None
    want_s, want_e = jax.jit(lambda v, k, e, a: jref.mask_uplink_ref(
        v, k, ef=e, alive=None if a is None else a[:, None] > 0))(
        _j(eff), _j(mask), _j(ef), _j(alive))
    ker_s, ker_e = jk.mask_uplink(_j(eff), _j(mask.astype(np.float32)),
                                  _j(ef), _j(alive), want_ef=True,
                                  block=BLOCK, interpret=True)
    got_s, got_e = tref.mask_uplink_ref(_t(eff), _t(mask), ef=_t(ef),
                                        alive=_t(alive))
    wrap_s, wrap_e = tk.mask_uplink(_t(eff), _t(mask), _t(ef), _t(alive))
    for want in (want_s, ker_s):
        _exact(got_s, want)
        _exact(wrap_s, want)
    for want in (want_e, ker_e):
        _exact(got_e, want)
        if has_ef:
            _exact(wrap_e, want)
    if not has_ef:
        assert wrap_e is None          # no residual without one to carry


@pytest.mark.parametrize("has_w,has_ef", WEF)
@pytest.mark.parametrize("has_alive", [False, True])
def test_quantize_uplink_same_decisions_exact(has_w, has_ef, has_alive):
    x = _inputs(4)
    w = x["w"] if has_w else None
    ef = x["ef"] if has_ef else None
    alive = ALIVE if has_alive else None
    scale = np.maximum(np.asarray(jk.uplink_stats(
        _j(x["z"]), _j(w), _j(ef), block=BLOCK, interpret=True)), 1e-30)
    quantize = jax.jit(lambda z, k, s, e, w, a: jref.quantize_uplink_ref(
        z, k, s, levels=LEVELS, ef=e, w=w, alive=a))
    want = [quantize(_j(x["z"][m]), _j(x["keys"][m]), scale[m],
                     None if ef is None else _j(ef[m]),
                     None if w is None else w[m],
                     None if alive is None else alive[m] > 0)
            for m in range(M)]
    want_s = np.stack([np.asarray(o[0]) for o in want])
    want_e = np.stack([np.asarray(o[1]) for o in want])
    ker_s, ker_e = jk.quantize_uplink(
        _j(x["z"]), _j(x["keys"]), _j(scale), _j(w), _j(ef), _j(alive),
        levels=LEVELS, block=BLOCK, interpret=True)
    keys = _tkeys(x["keys"])
    got = [tref.quantize_uplink_ref(_t(x["z"]), keys, _t(scale),
                                    levels=LEVELS, ef=_t(ef), w=_t(w),
                                    alive=_t(alive)),
           tk.quantize_uplink(_t(x["z"]), keys, _t(scale), _t(w), _t(ef),
                              _t(alive), levels=LEVELS)]
    for s, e in got:
        for ws in (want_s, ker_s):
            _same_levels(s, ws, scale)
            _exact(s, ws)
        if has_ef:
            for we in (want_e, ker_e):
                _exact(e, we)
    assert (got[1][1] is None) == (ef is None)


def test_quantize_is_unbiased_on_the_grid():
    """Each element lands on one of the two levels around it, and the max-abs
    entry exactly on the top level."""
    x = _inputs(5)
    z = _t(x["z"])
    scale = z.abs().amax(dim=1)
    sent, _ = tk.quantize_uplink(z, _tkeys(x["keys"]), scale, levels=LEVELS)
    step = (scale / LEVELS)[:, None]
    assert bool(((sent - z).abs() <= step * (1 + 1e-6)).all())
    top = z.abs().argmax(dim=1)
    torch.testing.assert_close(sent.gather(1, top[:, None]),
                               z.gather(1, top[:, None]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("rows,n", [(64, 16384), (64, 16421), (4, 151936 * 896),
                                    (1, 100), (3, 5000), (700, 4100)])
@pytest.mark.parametrize("sms", [132, 114])
def test_stats_grid_is_one_wave_of_whole_passes(rows, n, sms):
    """The card's scale pass (B6) cuts each row into tiles of whole passes
    that cover it, at most ``STATS_BLOCKS_PER_SM`` blocks an SM in all
    (one wave), or one tile a row when the rows alone exceed that."""
    tile = tk.stats_tile(rows, n, sms)
    tiles = -(-n // tile)
    assert tile % tk.STATS_STEP == 0 and tiles * tile >= n
    assert (tiles - 1) * tile < n                   # no empty tile
    assert rows * tiles <= max(rows, sms * tk.STATS_BLOCKS_PER_SM)
    if rows * 2 <= sms * tk.STATS_BLOCKS_PER_SM and n > tk.STATS_STEP:
        assert tiles > 1                            # the wave is used


def test_tickets_are_made_once_at_zero():
    """The arrival counters a kernel finishes its reduction on: int32 zeros,
    the same buffer on every call, one per kernel and device."""
    a = tk.tickets("uplink_stats", tk.STATS_TICKETS, "cpu")
    assert a.dtype == torch.int32 and a.shape == (tk.STATS_TICKETS,)
    assert not bool(a.any())
    assert tk.tickets("uplink_stats", tk.STATS_TICKETS, "cpu") is a
    assert tk.tickets("outer_apply", 1, "cpu") is not a


def test_tickets_grow_with_the_fleet():
    """A fleet of more rows than the buffer holds gets a larger one at 0
    (the scale pass keeps a ticket a row); a smaller ask keeps it."""
    small = tk.tickets("grow_check", 10, "cpu")
    big = tk.tickets("grow_check", 70000, "cpu")
    assert small.shape == (10,) and big.shape == (70000,)
    assert not bool(big.any()) and big.dtype == torch.int32
    assert tk.tickets("grow_check", 12, "cpu") is big


def test_wrappers_refuse_other_devices():
    z = torch.empty(2, 8, device="meta")
    keys = torch.zeros(2, 2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tk.uplink_stats(z)
    with pytest.raises(ValueError):
        tk.quantize_uplink(z, keys, torch.ones(2), levels=LEVELS)
    with pytest.raises(ValueError):
        tk.eff_uplink(z)
    with pytest.raises(ValueError):
        tk.mask_uplink(z, torch.zeros(2, 8, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# codec_uplink_stacked on trees
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, 333)).astype(np.float32)
    b = rng.standard_normal((M, 7, 5)).astype(np.float32)
    return (a, b), (0.05 * a, 0.05 * b)


CODECS = [("identity",), ("topk", 0.25), ("quantize", 8)]


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: c[0])
@pytest.mark.parametrize("has_alive", [False, True])
@pytest.mark.parametrize("has_wef", [False, True])
def test_codec_uplink_stacked_matches_jax(codec, has_alive, has_wef):
    z, ef = _tree(1)
    w = np.array([0.1, 0.4, 0.2, 0.3], dtype=np.float32) if has_wef else None
    ef = ef if has_wef else None
    alive = ALIVE if has_alive else None
    rngs = jax.random.split(jax.random.PRNGKey(3), M)
    jz = {"a": _j(z[0]), "b": _j(z[1])}
    jef = None if ef is None else {"a": _j(ef[0]), "b": _j(ef[1])}
    tz = tuple(map(_t, z))
    tef = None if ef is None else tuple(map(_t, ef))
    trngs = _tkeys(np.asarray(rngs))
    wants = [jops.codec_uplink_stacked(jz, rngs, w=_j(w), ef=jef,
                                       alive=_j(alive), codec=codec,
                                       use_kernel=uk) for uk in (True, False)]
    for uk in (True, False):
        sent, ef_new = tops.codec_uplink_stacked(
            tz, trngs, w=_t(w), ef=tef, alive=_t(alive), codec=codec,
            use_kernel=uk)
        assert (ef_new is None) == (ef is None)
        for j_sent, j_ef in wants:
            pairs = list(zip(sent, (j_sent["a"], j_sent["b"])))
            if ef is not None:
                pairs += list(zip(ef_new, (j_ef["a"], j_ef["b"])))
            for got, want in pairs:
                assert got.shape == want.shape
                _exact(got, want)


@pytest.mark.parametrize("codec", [("topk", 0.25), ("quantize", 8)],
                         ids=lambda c: c[0])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_dead_worker_sends_zero_and_freezes_ef(codec, use_kernel):
    z, ef = _tree(2)
    sent, ef_new = tops.codec_uplink_stacked(
        tuple(map(_t, z)), jr.split(jr.PRNGKey(3, device="cpu"), M),
        ef=tuple(map(_t, ef)), alive=_t(ALIVE), codec=codec,
        use_kernel=use_kernel)
    for s, e_new, e_old in zip(sent, ef_new, ef):
        assert float(s[1].abs().max()) == 0.0
        _exact(e_new[1], e_old[1])
        assert float(s[0].abs().max()) > 0.0


def test_topk_ties_go_to_the_lowest_index():
    rows = np.array([[1.0, -1.0, 1.0, 0.5, -1.0, 1.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                     [2.0, -2.0, 2.0, -2.0, 3.0, 3.0, -3.0, 1.0]],
                    dtype=np.float32)
    for fraction in (0.25, 0.375, 0.5, 0.75):
        want = np.asarray(jops._topk_mask(jnp.asarray(rows), fraction))
        got = tops._topk_mask(torch.from_numpy(rows), fraction)
        _exact(got.numpy().astype(np.float32), want)


def test_topk_keeps_exactly_k_entries():
    z, _ = _tree(3)
    sent, _ = tops.codec_uplink_stacked(tuple(map(_t, z)), None,
                                        codec=("topk", 0.25))
    for s in sent:
        k = tops.topk_keep(s[0].numel(), 0.25)
        nz = (s.reshape(M, -1) != 0).sum(dim=1)
        assert bool((nz == k).all())


@pytest.mark.parametrize("codec", [("quantize", 4), ("topk", 0.25)],
                         ids=lambda c: c[0])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_error_feedback_telescopes(codec, use_kernel):
    """Σ_r sent_r + ef_R = Σ_r w·z_r: the compression error does not
    accumulate."""
    rng = np.random.default_rng(0)
    key = jr.PRNGKey(0, device="cpu")
    w = torch.tensor([0.25, 0.35, 0.4])
    ef = (torch.zeros(3, 101),)
    sent_sum = torch.zeros(3, 101)
    msg_sum = torch.zeros(3, 101)
    for _ in range(6):
        key, kc = jr.split(key, 2)
        z = (torch.from_numpy(rng.standard_normal((3, 101))
                              .astype(np.float32)),)
        (sent,), ef = tops.codec_uplink_stacked(
            z, jr.split(kc, 3), w=w, ef=ef, codec=codec,
            use_kernel=use_kernel)
        sent_sum += sent
        msg_sum += w[:, None] * z[0]
    torch.testing.assert_close(sent_sum + ef[0], msg_sum, rtol=1e-4,
                               atol=1e-5)
    assert float(ef[0].abs().max()) > 0.0


def test_codec_uplink_is_the_compressors_derivation():
    """The single-worker uplink without weight or residual reproduces the
    reference compressor, in the port and in the JAX package."""
    rng = np.random.default_rng(1)
    g = rng.standard_normal(257).astype(np.float32)
    key = jax.random.PRNGKey(9)
    tkey = _tkeys(np.asarray(key))
    (fused,), none = tops.codec_uplink((_t(g),), tkey, codec=("quantize", 8))
    assert none is None
    (ref,) = StochasticQuantizeCompressor(8).compress((_t(g)[None],),
                                                      tkey[None])
    _exact(fused, ref[0])
    jax_ref = jax.jit(JaxQuantize(bits=8).compress)({"g": _j(g)}, key)
    _exact(fused, jax_ref["g"])
    _same_levels(fused[None], np.asarray(jax_ref["g"])[None],
                 [max(np.abs(g).max(), 1e-30)])


@pytest.mark.parametrize("make", [
    (lambda: (StochasticQuantizeCompressor(bits=8), JaxQuantize(bits=8))),
    (lambda: (StochasticQuantizeCompressor(bits=3), JaxQuantize(bits=3))),
    (lambda: (TopKCompressor(fraction=0.1), JaxTopK(fraction=0.1))),
])
def test_compressors_match_jax(make):
    comp, jcomp = make()
    z, _ = _tree(4)
    rngs = jax.random.split(jax.random.PRNGKey(6), M)
    want = jax.jit(jax.vmap(jcomp.compress))({"a": _j(z[0]),
                                              "b": _j(z[1])}, rngs)
    got = comp.compress(tuple(map(_t, z)), _tkeys(np.asarray(rngs)))
    for g, wl in zip(got, (want["a"], want["b"])):
        _exact(g, wl)
    like = tuple(_t(v[0]) for v in z)
    assert comp.message_bytes(like) == jcomp.message_bytes(
        {"a": _j(z[0][0]), "b": _j(z[1][0])})
    assert (comp.name, comp.codec_spec, comp.error_feedback) == (
        jcomp.name, jcomp.codec_spec, jcomp.error_feedback)
