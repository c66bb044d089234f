"""The port's fused extragradient kernels (their wrappers, which run the
plain twins on the CPU, and the tree-level ops) against the JAX package's
references and its Pallas kernels in interpret mode, on identical numpy
inputs. f32 at rtol/atol 1e-6: both sides compute the same f32
expressions; only sum order differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.adaseg_update import kernel as jk
from repro.kernels.adaseg_update import ops as jops
from repro.kernels.adaseg_update import ref as jref
from repro_torch.kernels.adaseg_update import kernel as tk
from repro_torch.kernels.adaseg_update import ops as tops

M = 3
TOL = dict(rtol=1e-6, atol=1e-6)
# n=300 with block=128 leaves a ragged last Pallas block (padding masked).
N, BLOCK = 300, 128
BOXES = [(None, None), (-1.0, 1.0), (0.25, 1.0)]
G0, D_ALPHA = 1.5, 2.0


def _inputs(seed, n=N):
    rng = np.random.default_rng(seed)
    return dict(
        z=rng.uniform(-1, 1, (M, n)).astype(np.float32),
        m=rng.normal(0, 2, (M, n)).astype(np.float32),
        zt=rng.uniform(-1, 1, (M, n)).astype(np.float32),
        g=rng.normal(0, 2, (M, n)).astype(np.float32),
        sum_sq=rng.uniform(0.5, 20, (M,)).astype(np.float32),
        eta=rng.uniform(0.05, 0.5, (M,)).astype(np.float32),
        s_t=rng.uniform(0.3, 1.0, (M,)).astype(np.float32),
        s_l=rng.uniform(0.3, 1.0, (M,)).astype(np.float32),
    )


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _eta_kw(x, mode, m=None):
    """η given, or fused from sum_sq; per worker (m) for the JAX side."""
    key = "eta" if mode == "eta" else "sum_sq"
    if m is None:
        return {key: _t(x[key])}
    return {key: jnp.float32(x[key][m])}


@pytest.mark.parametrize("mode", ["eta", "sum_sq"])
@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("want_norm", [False, True])
def test_explore_matches_jax(mode, box, want_norm):
    x = _inputs(1)
    lo, hi = box
    got = tk.adaseg_explore(_t(x["z"]), _t(x["m"]), g0=G0, d_alpha=D_ALPHA,
                            lo=lo, hi=hi, want_norm=want_norm,
                            **_eta_kw(x, mode))
    for m in range(M):
        kw = dict(g0=G0, d_alpha=D_ALPHA, lo=lo, hi=hi, want_norm=want_norm,
                  **_eta_kw(x, mode, m))
        want_ref = jref.adaseg_explore_ref(x["z"][m], x["m"][m], **kw)
        want_ker = jk.adaseg_explore(jnp.asarray(x["z"][m]),
                                     jnp.asarray(x["m"][m]), block=BLOCK,
                                     interpret=True, **kw)
        wants = [want_ref, want_ker]
        if want_norm and lo is not None and lo > 0:
            # The Pallas explore leaves its ‖z_t‖² partial unmasked, so its
            # pad lanes add clip(0)² = lo² each. The JAX package never asks
            # for want_norm with a box (only the l2 path does), so this
            # case is held to ref.py alone; the port masks the pad.
            wants = [want_ref]
        for want in wants:
            _close(got[0][m], want[0])
            _close(got[1][m], want[1])
            _close(got[2][m], want[2])


@pytest.mark.parametrize("mode", ["eta", "sum_sq"])
@pytest.mark.parametrize("box", BOXES)
def test_anchor_matches_jax(mode, box):
    x = _inputs(2)
    lo, hi = box
    got = tk.adaseg_anchor(_t(x["z"]), _t(x["zt"]), _t(x["g"]), g0=G0,
                           d_alpha=D_ALPHA, lo=lo, hi=hi, **_eta_kw(x, mode))
    for m in range(M):
        kw = dict(g0=G0, d_alpha=D_ALPHA, lo=lo, hi=hi, **_eta_kw(x, mode, m))
        want_ref = jref.adaseg_anchor_ref(x["z"][m], x["zt"][m], x["g"][m],
                                          **kw)
        want_ker = jk.adaseg_anchor(jnp.asarray(x["z"][m]),
                                    jnp.asarray(x["zt"][m]),
                                    jnp.asarray(x["g"][m]), block=BLOCK,
                                    interpret=True, **kw)
        for want in (want_ref, want_ker):
            for a, b in zip(got, want):
                _close(a[m], b)


def test_finish_matches_jax():
    x = _inputs(3)
    got = tk.adaseg_finish(_t(x["z"]), _t(x["m"]), _t(x["g"]), _t(x["s_t"]),
                           _t(x["s_l"]))
    for m in range(M):
        args = (x["z"][m], x["m"][m], x["g"][m], x["s_t"][m], x["s_l"][m])
        want_ref = jref.adaseg_finish_ref(*args)
        want_ker = jk.adaseg_finish(*map(jnp.asarray, args), block=BLOCK,
                                    interpret=True)
        for want in (want_ref, want_ker):
            for a, b in zip(got, want):
                _close(a[m], b)


def test_masked_lanes_contribute_nothing():
    """box(0.25, 1): clip(0) = 0.25 ≠ 0, so a statistic that summed any
    lane past n would differ from the direct sum over the n real lanes."""
    x = _inputs(4, n=37)
    ztl, stat, gsq = tk.adaseg_anchor(_t(x["z"]), _t(x["zt"]), _t(x["g"]),
                                      eta=_t(x["eta"]), lo=0.25, hi=1.0)
    zt = x["zt"].astype(np.float64)
    ztl64 = ztl.numpy().astype(np.float64)
    want = ((zt - x["z"]) ** 2 + (zt - ztl64) ** 2).sum(axis=1)
    np.testing.assert_allclose(stat.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(gsq.numpy(),
                               (x["g"].astype(np.float64) ** 2).sum(1),
                               rtol=1e-6)


def _tree(x, *names):
    """Two leaves per worker: the first 200 and last 100 columns."""
    return {k: (x[k][:, :200], x[k][:, 200:]) for k in names}


SPECS = [("identity",), ("box", -1.0, 1.0), ("box", 0.25, 1.0), ("l2", 3.0)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("mode", ["eta", "sum_sq"])
def test_tree_ops_match_jax(spec, mode):
    x = _inputs(5)
    tr = _tree(x, "z", "m", "zt", "g")
    tt = {k: tuple(_t(v) for v in leaves) for k, leaves in tr.items()}
    ekw = _eta_kw(x, mode)
    z_t, m_sq = tops.adaseg_tree_explore(tt["z"], tt["m"], g0=G0,
                                         d_alpha=D_ALPHA, proj=spec, **ekw)
    ztl, stat, g_sq = tops.adaseg_tree_anchor(tt["z"], z_t, tt["g"], g0=G0,
                                              d_alpha=D_ALPHA, proj=spec,
                                              **ekw)
    for m in range(M):
        row = {k: tuple(jnp.asarray(v[m]) for v in leaves)
               for k, leaves in tr.items()}
        kw = dict(g0=G0, d_alpha=D_ALPHA, proj=spec, **_eta_kw(x, mode, m))
        jz_t, jm_sq = jops.adaseg_tree_explore(row["z"], row["m"], **kw)
        jztl, jstat, jg_sq = jops.adaseg_tree_anchor(row["z"], jz_t, row["g"],
                                                     **kw)
        for a, b in zip(z_t, jz_t):
            _close(a[m], b)
        for a, b in zip(ztl, jztl):
            _close(a[m], b)
        _close(m_sq[m], jm_sq)
        _close(stat[m], jstat)
        _close(g_sq[m], jg_sq)


def test_l2_tree_ops_project_onto_the_ball():
    """The per-worker ball covers the whole iterate (both leaves)."""
    x = _inputs(6)
    tt = {k: tuple(_t(v) for v in leaves)
          for k, leaves in _tree(x, "z", "m").items()}
    z_t, _ = tops.adaseg_tree_explore(tt["z"], tt["m"], eta=10.0,
                                      proj=("l2", 0.5))
    norms = torch.sqrt(sum(v.square().sum(1) for v in z_t))
    torch.testing.assert_close(norms, torch.full((M,), 0.5), rtol=1e-6,
                               atol=0)


def test_wrappers_refuse_other_devices_and_bad_specs():
    z = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError):
        tk.adaseg_explore(z, z, eta=0.1)
    with pytest.raises(ValueError):
        tk.adaseg_explore(torch.zeros(2, 4), torch.zeros(2, 4))
    with pytest.raises(ValueError):
        tops.adaseg_tree_explore((torch.zeros(2, 4),), (torch.zeros(2, 4),),
                                 eta=0.1, proj=("simplex",))


# ---------------------------------------------------------------------------
# B4: the one-shot double update
# ---------------------------------------------------------------------------

UPDATE_MODES = [(None, False), ((-1.0, 1.0), False), ((0.25, 1.0), False),
                (None, True)]


@pytest.mark.parametrize("mode", ["eta", "sum_sq"])
@pytest.mark.parametrize("box,raw_norms", UPDATE_MODES,
                         ids=["identity", "box", "box-above-zero", "raw"])
def test_update_matches_jax(mode, box, raw_norms):
    """Per worker against the JAX reference and the Pallas kernel (ragged
    n=300 at block 128); in raw_norms mode against the kernel alone, whose
    reference has no such mode, and the norms against a direct sum."""
    x = _inputs(7)
    lo, hi = box or (None, None)
    got = tk.adaseg_update(_t(x["z"]), _t(x["m"]), _t(x["g"]), g0=G0,
                           d_alpha=D_ALPHA, lo=lo, hi=hi,
                           raw_norms=raw_norms, **_eta_kw(x, mode))
    for m in range(M):
        kw = dict(g0=G0, d_alpha=D_ALPHA, lo=lo, hi=hi, **_eta_kw(x, mode, m))
        args = (jnp.asarray(x["z"][m]), jnp.asarray(x["m"][m]),
                jnp.asarray(x["g"][m]))
        want_ker = jk.adaseg_update(*args, block=BLOCK, interpret=True,
                                    raw_norms=raw_norms, **kw)
        wants = [want_ker]
        if not raw_norms:
            wants.append(jref.adaseg_update_ref(*args, **kw))
        for want in wants:
            _close(got[0][m], want[0])
            _close(got[1][m], want[1])
            if raw_norms:
                _close(got[2][0][m], want[2][0])
                _close(got[2][1][m], want[2][1])
            else:
                _close(got[2][m], want[2])
    if raw_norms:
        for v, s in zip(got[:2], got[2]):
            np.testing.assert_allclose(
                s.numpy(), (v.numpy().astype(np.float64) ** 2).sum(1),
                rtol=1e-6)


def test_update_pad_mask_box_above_zero():
    """The JAX package's pad-mask case (n=1000 pads 24 lanes at block 128,
    box(0.5, 1)): the (Z_t)² numerator is the direct sum over the n real
    lanes, as the Pallas kernel's masked one is."""
    x = _inputs(8, n=1000)
    z_t, ztl, stat = tk.adaseg_update(_t(x["z"]), _t(x["m"]), _t(x["g"]),
                                      eta=0.3, lo=0.5, hi=1.0)
    zt64, ztl64 = z_t.numpy().astype(np.float64), ztl.numpy().astype(np.float64)
    want = ((zt64 - x["z"]) ** 2 + (zt64 - ztl64) ** 2).sum(axis=1)
    np.testing.assert_allclose(stat.numpy(), want, rtol=1e-6)
    for m in range(M):
        args = (jnp.asarray(x["z"][m]), jnp.asarray(x["m"][m]),
                jnp.asarray(x["g"][m]))
        want_ker = jk.adaseg_update(*args, 0.3, lo=0.5, hi=1.0, block=128,
                                    interpret=True)
        _close(z_t[m], want_ker[0])
        _close(stat[m], want_ker[2])


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("mode", ["eta", "sum_sq"])
def test_tree_update_matches_jax(spec, mode):
    """``adaseg_tree_update`` per worker against the JAX package's (its
    kernels in interpret mode): the iterates at TOL, z_sq = stat / (5η²)
    at rtol 1e-5 (η formed on each side: C7)."""
    x = _inputs(9)
    tr = _tree(x, "z", "m", "g")
    tt = {k: tuple(_t(v) for v in leaves) for k, leaves in tr.items()}
    z_t, ztl, z_sq = tops.adaseg_tree_update(
        tt["z"], tt["m"], tt["g"], g0=G0, d_alpha=D_ALPHA, proj=spec,
        **_eta_kw(x, mode))
    for m in range(M):
        row = {k: tuple(jnp.asarray(v[m]) for v in leaves)
               for k, leaves in tr.items()}
        jz_t, jztl, jz_sq = jops.adaseg_tree_update(
            row["z"], row["m"], row["g"], g0=G0, d_alpha=D_ALPHA, proj=spec,
            **_eta_kw(x, mode, m))
        for a, b in zip(z_t, jz_t):
            _close(a[m], b)
        for a, b in zip(ztl, jztl):
            _close(a[m], b)
        np.testing.assert_allclose(float(z_sq[m]), float(jz_sq), rtol=1e-5)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(map(str, s)))
def test_one_shot_is_explore_then_anchor(spec):
    """On the same η the one-shot update gives the step path's explore then
    anchor: the same iterates and the same (Z_t)² numerator."""
    x = _inputs(10)
    tt = {k: tuple(_t(v) for v in leaves)
          for k, leaves in _tree(x, "z", "m", "g").items()}
    kw = dict(sum_sq=_t(x["sum_sq"]), g0=G0, d_alpha=D_ALPHA, proj=spec)
    z_t, ztl, z_sq = tops.adaseg_tree_update(tt["z"], tt["m"], tt["g"], **kw)
    e_t, _ = tops.adaseg_tree_explore(tt["z"], tt["m"], **kw)
    e_tl, stat, _ = tops.adaseg_tree_anchor(tt["z"], e_t, tt["g"], **kw)
    for a, b in zip(z_t + ztl, e_t + e_tl):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    eta = D_ALPHA / torch.sqrt(G0 ** 2 + _t(x["sum_sq"]))
    torch.testing.assert_close(z_sq, stat / (5.0 * eta ** 2), rtol=1e-5,
                               atol=0)
