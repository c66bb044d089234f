"""Engine checkpoints in the port: the msgpack-free serializer against the
JAX package's layout (``msgpack``, imported here in the test only, reads
both), JAX checkpoints restored into the port and port checkpoints into
the JAX package, bit-exact save and restore within the port (fleet state,
error feedback and the outer optimizer's state), the fingerprint checks,
the historical layout without an outer optimizer, and
``run(checkpoint_path=, checkpoint_every=)``.

Cross-package continuations agree at rtol 1e-5 / atol 1e-6 with the other
package's uninterrupted run (the two packages' steps differ in f32 sum
order and erfinv ulps, ROADMAP C3); within the port, a resumed run equals
an uninterrupted one bit for bit.
"""
import subprocess
import sys
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro import ps as jps
from repro.checkpoint.serialize import load_pytree as jax_load_pytree
from repro.core import AdaSEGConfig as JaxCfg
from repro.problems import make_bilinear_game as jax_game
from repro_torch import interop
from repro_torch import ps as tps
from repro_torch import random as jr
from repro_torch.checkpoint import serialize as ser
from repro_torch.core import AdaSEGConfig
from repro_torch.problems import make_bilinear_game

REPO = Path(__file__).resolve().parent.parent
M, R = 8, 4
CFG = dict(g0=1.0, diameter=2.0, alpha=1.0, k=4)
TOL = dict(rtol=1e-5, atol=1e-6)

CONFIGS = {
    "plain": lambda mod: {},
    "q8_ef": lambda mod: dict(
        compressor=mod.StochasticQuantizeCompressor(bits=8),
        faults=mod.BernoulliFaults(p=0.3, seed=5)),
    "robust": lambda mod: dict(
        byzantine=mod.SignFlipAttack(fraction=0.25, scale=8.0, seed=11),
        aggregator=mod.TrimmedMean(beta=0.25)),
    "server_opt": lambda mod: dict(server_opt=mod.ServerAdam(lr=0.5)),
    "stack": lambda mod: dict(
        byzantine=mod.SignFlipAttack(fraction=0.25, scale=8.0, seed=11),
        dp=mod.DPUplink(clip=2.0, sigma=1e-3),
        compressor=mod.StochasticQuantizeCompressor(bits=8),
        faults=mod.BernoulliFaults(p=0.3, seed=5),
        aggregator=mod.CoordinateMedian(),
        server_opt=mod.ServerNesterov(lr=1.0, beta=0.3)),
}


@pytest.fixture(scope="module")
def games():
    return (jax_game(jax.random.PRNGKey(0), n=8, sigma=0.1),
            make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=8, sigma=0.1,
                               device="cpu"))


def _jax_engine(jg, rounds=R, seed=2, **kw):
    return jps.PSEngine(jg.problem,
                        jps.PSConfig(adaseg=JaxCfg(**CFG), num_workers=M,
                                     rounds=rounds, **kw),
                        rng=jax.random.PRNGKey(seed), eval_fn=jg.residual)


def _port_engine(tg, rounds=R, seed=2, adaseg=None, **kw):
    return tps.PSEngine(tg.problem,
                        tps.PSConfig(adaseg=adaseg or AdaSEGConfig(**CFG),
                                     num_workers=M, rounds=rounds, **kw),
                        rng=jr.PRNGKey(seed, device="cpu"),
                        eval_fn=tg.residual, device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _port_leaves(eng):
    """Every tensor the port's checkpoint carries, in order."""
    return [x for x in ser.tree_flatten(eng._ckpt_tree())
            if isinstance(x, torch.Tensor)]


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The serializer
# ---------------------------------------------------------------------------

def _msgpack_objects():
    yield from (0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768, -32769,
                -2 ** 31, -2 ** 31 - 1, None)
    for n in (0, 31, 32, 255, 256, 65535, 65536):
        yield "s" * n
        yield b"b" * n
    for n in (0, 15, 16, 70000):
        yield list(range(n))
        yield {f"k{i}": i for i in range(min(n, 300))}
    yield {"treedef": "x", "leaves": [{"dtype": "float32", "shape": [2, 3],
                                       "data": bytes(24)}]}


def test_msgpack_encoding_matches_packb():
    for obj in _msgpack_objects():
        blob = msgpack.packb(obj)
        assert ser.packb(obj) == blob, repr(obj)[:60]
        assert ser.unpackb(blob) == msgpack.unpackb(blob)


def test_serializer_imports_with_msgpack_blocked(tmp_path):
    code = ("import sys; sys.modules['msgpack'] = None; "
            "sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import numpy as np; "
            "from repro_torch.checkpoint import save_pytree, load_pytree; "
            f"p = {str(tmp_path / 'ck')!r}; "
            "save_pytree(p, {'a': np.arange(3, dtype=np.int32)}); "
            "print(load_pytree(p, {'a': np.zeros(3, np.int32)})['a'].sum())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3"


@pytest.mark.parametrize("config", ["plain", "q8_ef", "stack"])
def test_layout_matches_jax_save_pytree(games, tmp_path, config):
    """The same engine state written by both packages: the same leaves in
    the same order, dtypes, shapes and bytes; with the JAX file's treedef
    swapped in, the port's file is byte for byte the JAX one."""
    jg, tg = games
    je = _jax_engine(jg, **CONFIGS[config](jps))
    je.run(until_round=2)
    te = _port_engine(tg, **CONFIGS[config](tps))
    te.restore(_save_jax(je, tmp_path / "jax.ckpt"))
    te.save(str(tmp_path / "port.ckpt"))
    jp = msgpack.unpackb((tmp_path / "jax.ckpt").read_bytes())
    tp = msgpack.unpackb((tmp_path / "port.ckpt").read_bytes())
    assert list(tp) == ["treedef", "leaves"]
    assert len(tp["leaves"]) == len(jp["leaves"])
    for a, b in zip(tp["leaves"], jp["leaves"]):
        assert list(a) == ["dtype", "shape", "data"]
        assert (a["dtype"], a["shape"], a["data"]) == (
            b["dtype"], b["shape"], b["data"])
    assert msgpack.packb({**jp, "treedef": tp["treedef"]}) == (
        tmp_path / "port.ckpt").read_bytes()


def test_load_refuses_a_mismatched_tree(tmp_path):
    path = str(tmp_path / "ck")
    ser.save_pytree(path, {"a": torch.zeros(3), "b": np.int32(1)})
    with pytest.raises(ValueError, match="leaves"):
        ser.load_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ser.load_pytree(path, {"a": torch.zeros(4), "b": np.int32(1)})
    with pytest.raises(ValueError, match="dtype"):
        ser.load_pytree(path, {"a": torch.zeros(3), "b": np.uint32(1)})


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def _save_jax(je, path):
    je.save(str(path))
    return str(path)


@pytest.mark.parametrize("config", ["plain", "q8_ef", "robust",
                                    "server_opt"])
def test_jax_checkpoint_restores_into_the_port(games, tmp_path, config):
    """A JAX engine saved at round 2 restores into the port, which then
    continues to the JAX engine's own uninterrupted end."""
    jg, tg = games
    whole = _jax_engine(jg, **CONFIGS[config](jps))
    whole.run()
    part = _jax_engine(jg, **CONFIGS[config](jps))
    part.run(until_round=2)
    te = _port_engine(tg, **CONFIGS[config](tps)).restore(
        _save_jax(part, tmp_path / "ck"))
    assert te.round == 2 and te.trace.rounds == []
    for a, b in zip(te.state.z_tilde, part.state.z_tilde):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    z_t = te.run()
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in whole.trace.rounds[2:]])
    for a, b in zip(z_t, whole.z_bar()):
        _close(a, b)
    if config == "server_opt":
        assert int(te._srv[2]) == int(whole._srv[2]) == R
        _close([r.delta_norm for r in te.trace.rounds],
               [r.delta_norm for r in whole.trace.rounds[2:]])


@pytest.mark.parametrize("config", ["plain", "stack"])
def test_port_checkpoint_loads_into_jax(games, tmp_path, config):
    """The JAX package's ``load_pytree`` and ``PSEngine.restore`` read a
    port checkpoint; the JAX engine then continues to the port's
    uninterrupted end."""
    jg, tg = games
    whole = _port_engine(tg, **CONFIGS[config](tps))
    whole.run()
    part = _port_engine(tg, **CONFIGS[config](tps))
    part.run(until_round=2)
    path = str(tmp_path / "ck")
    part.save(path)
    je = _jax_engine(jg, **CONFIGS[config](jps))
    raw = jax_load_pytree(path, je._ckpt_tree())
    assert int(raw["round"]) == 2
    je.restore(path)
    for a, b in zip(je.state.z_tilde, part.state.z_tilde):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    je.run()
    _close([r.residual for r in je.trace.rounds],
           [r.residual for r in whole.trace.rounds[2:]])


# ---------------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec_backend", ["reference", "fused"])
@pytest.mark.parametrize("config", ["q8_ef", "stack"])
def test_save_restore_is_bit_exact(games, tmp_path, config, codec_backend):
    _, tg = games
    kw = dict(codec_backend=codec_backend, **CONFIGS[config](tps))
    whole = _port_engine(tg, **kw)
    whole.run()
    first = _port_engine(tg, **kw)
    first.run(until_round=2)
    path = str(tmp_path / "ck")
    first.save(path)
    resumed = _port_engine(tg, **kw).restore(path)
    assert resumed.round == 2
    _bitwise(_port_leaves(resumed), _port_leaves(first))
    resumed.run()
    _bitwise(_port_leaves(resumed), _port_leaves(whole))
    assert ([r.residual for r in resumed.trace.rounds]
            == [r.residual for r in whole.trace.rounds[2:]])
    # a rewound engine keeps only the rounds before the restored one
    whole.restore(path)
    assert [r.round for r in whole.trace.rounds] == [0, 1]


REJECTS = {
    "seed": (dict(seed=3), "different seed"),
    "optimizer": (dict(adaseg=AdaSEGConfig(g0=2.0, diameter=2.0, alpha=1.0,
                                           k=4)), "different optimizer"),
    "aggregator": (dict(aggregator=tps.TrimmedMean(beta=0.25)),
                   "robust aggregator"),
    "server_opt": (dict(server_opt=tps.ServerNesterov(lr=1.0, beta=0.5)),
                   "outer optimizer"),
}


@pytest.mark.parametrize("what", list(REJECTS))
def test_restore_refuses_another_run(games, tmp_path, what):
    _, tg = games
    base = dict(CONFIGS["stack"](tps))
    eng = _port_engine(tg, rounds=2, **base)
    eng.run(until_round=1)
    path = str(tmp_path / "ck")
    eng.save(path)
    change, message = REJECTS[what]
    other = _port_engine(tg, rounds=2, **{**base, **change})
    with pytest.raises(ValueError, match=message):
        other.restore(path)


def test_restore_refuses_another_layout(games, tmp_path):
    """A checkpoint with an outer optimizer's state does not load into an
    engine without one (the leaf count differs), and vice versa."""
    _, tg = games
    path = str(tmp_path / "ck")
    _port_engine(tg, server_opt=tps.ServerNesterov()).save(path)
    with pytest.raises(ValueError, match="layout"):
        _port_engine(tg).restore(path)
    _port_engine(tg).save(path)
    with pytest.raises(ValueError, match="layout"):
        _port_engine(tg, server_opt=tps.ServerAdam()).restore(path)


def test_historical_layout_is_byte_identical(games, tmp_path):
    """``NoServerOpt`` and a zero-budget aggregator leave the checkpoint of
    a plain run byte for byte as it was: no ``server_opt``,
    ``server_opt_fp`` or ``aggregator_fp``."""
    _, tg = games
    blobs = []
    for kw in ({}, dict(server_opt=tps.NoServerOpt()),
               dict(aggregator=tps.TrimmedMean(beta=0.0))):
        eng = _port_engine(tg, rounds=2, **kw)
        eng.run()
        path = tmp_path / f"ck{len(blobs)}"
        eng.save(str(path))
        blobs.append(path.read_bytes())
        assert set(eng._ckpt_tree()) == {"worker_state", "ef", "round",
                                         "rng0", "worker_fp"}
    assert blobs[0] == blobs[1] == blobs[2]


def test_run_writes_checkpoints_and_resumes(games, tmp_path):
    _, tg = games
    kw = CONFIGS["stack"](tps)
    path = str(tmp_path / "ck")
    whole = _port_engine(tg, rounds=5, **kw)
    z_whole = whole.run(checkpoint_path=path, checkpoint_every=2)
    spans = [s for s in whole.tracer.spans if s.cat == "checkpoint"]
    assert [s.attrs["round"] for s in spans] == [2, 4, 5]
    assert all(s.attrs["bytes"] > 0 for s in spans)
    # the last write is the final state
    back = _port_engine(tg, rounds=5, **kw).restore(path)
    assert back.round == 5
    _bitwise(_port_leaves(back), _port_leaves(whole))
    # a run killed after round 2 resumes from its checkpoint
    killed = _port_engine(tg, rounds=5, **kw)
    killed.run(until_round=2, checkpoint_path=path, checkpoint_every=2)
    resumed = _port_engine(tg, rounds=5, **kw).restore(path)
    z_resumed = resumed.run(checkpoint_path=path, checkpoint_every=2)
    _bitwise(z_resumed, z_whole)
    assert ([r.residual for r in resumed.trace.rounds]
            == [r.residual for r in whole.trace.rounds[2:]])


def test_checkpoint_dtypes(games):
    """``round`` int32, ``rng0`` uint32 (2,), fingerprints uint32 scalars,
    the outer optimizer's ``t`` int32, as the JAX engine writes them."""
    _, tg = games
    tree = _port_engine(tg, **CONFIGS["stack"](tps))._ckpt_tree()
    assert tree["round"].dtype == np.int32 and tree["round"].shape == ()
    assert tree["rng0"].dtype == np.uint32 and tree["rng0"].shape == (2,)
    for key in ("worker_fp", "aggregator_fp", "server_opt_fp"):
        assert tree[key].dtype == np.uint32 and tree[key].shape == ()
    assert tree["server_opt"]["t"].dtype == torch.int32
    key = interop.key_from_numpy(tree["rng0"], device="cpu")
    assert key.dtype == torch.int64 and tuple(key.shape) == (2,)


# ---------------------------------------------------------------------------
# The async engine's checkpoints (the per-worker event machine, float64
# times as raw bytes), across packages and within the port
# ---------------------------------------------------------------------------

ASYNC_M, ASYNC_R = 4, 6
ASYNC_CONFIGS = {
    "plain": lambda mod: {},
    "stack": lambda mod: dict(
        schedule=mod.StragglerSchedule(k=4, min_frac=0.5, seed=2,
                                       slow_workers=(3,)),
        compressor=mod.StochasticQuantizeCompressor(bits=8),
        faults=mod.BernoulliFaults(p=0.1, seed=3),
        byzantine=mod.SignFlipAttack(fraction=0.25, scale=8.0, seed=11),
        aggregator=mod.TrimmedMean(beta=0.25),
        server_opt=mod.ServerNesterov(lr=1.0, beta=0.3)),
}


def _async_config(mod, cfg, config):
    return mod.AsyncPSConfig(
        adaseg=cfg(**CFG), num_workers=ASYNC_M, rounds=ASYNC_R,
        latency=mod.MarkovLatency(step_s=1.0, slow_factor=6.0, p_slow=0.2,
                                  p_recover=0.4, up_s=0.3, down_s=0.2,
                                  seed=5, start_slow=(1,)),
        staleness_bound=2.0, **ASYNC_CONFIGS[config](mod))


def _jax_async(jg, config):
    return jps.AsyncPSEngine(jg.problem, _async_config(jps, JaxCfg, config),
                             rng=jax.random.PRNGKey(2), eval_fn=jg.residual)


def _port_async(tg, config):
    return tps.AsyncPSEngine(
        tg.problem, _async_config(tps, AdaSEGConfig, config),
        rng=jr.PRNGKey(2, device="cpu"), eval_fn=tg.residual, device="cpu")


def _async_host(eng):
    return [(r.round, r.alive, r.local_steps, r.sim_time_s, r.staleness)
            for r in eng.trace.rounds]


@pytest.mark.parametrize("config", list(ASYNC_CONFIGS))
def test_async_layout_matches_jax_save_pytree(games, tmp_path, config):
    """A JAX async engine saved mid-event-queue, restored into the port and
    saved again: the same leaves, dtypes, shapes and bytes (the float64
    event times as the JAX package's ``_f64_bytes``)."""
    from repro.ps.async_engine import _f64_bytes as jax_f64_bytes
    from repro_torch.ps.async_engine import _f64_bytes

    jg, tg = games
    je = _jax_async(jg, config)
    je.run(until_admissions=4)
    assert not je.done
    jpath, tpath = tmp_path / "jax.ckpt", tmp_path / "port.ckpt"
    je.save(str(jpath))
    te = _port_async(tg, config).restore(str(jpath))
    assert te.n_admissions == 4 and te.now == je.now
    te.save(str(tpath))
    jp = msgpack.unpackb(jpath.read_bytes())
    tp = msgpack.unpackb(tpath.read_bytes())
    assert len(tp["leaves"]) == len(jp["leaves"])
    for a, b in zip(tp["leaves"], jp["leaves"]):
        assert (a["dtype"], a["shape"], a["data"]) == (
            b["dtype"], b["shape"], b["data"])
    assert msgpack.packb({**jp, "treedef": tp["treedef"]}) == \
        tpath.read_bytes()
    times = np.array([0.0, 1.5, 2.0 ** -40, 1e300, -3.25])
    np.testing.assert_array_equal(_f64_bytes(times),
                                  np.asarray(jax_f64_bytes(times)))


@pytest.mark.parametrize("config", list(ASYNC_CONFIGS))
def test_jax_async_checkpoint_restores_into_the_port(games, tmp_path,
                                                     config):
    """Killed at admission 4 in the JAX package, finished in the port: the
    host records equal the JAX engine's uninterrupted run, the residuals
    and z̄ agree at rtol 1e-5 / atol 1e-6."""
    jg, tg = games
    whole = _jax_async(jg, config)
    z_whole = whole.run()
    part = _jax_async(jg, config)
    part.run(until_admissions=4)
    path = str(tmp_path / "ck")
    part.save(path)
    te = _port_async(tg, config).restore(path)
    assert te.trace.rounds == []
    z_t = te.run()
    assert _async_host(te) == _async_host(whole)[4:]
    assert te.sim_time == whole.sim_time
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in whole.trace.rounds[4:]])
    for a, b in zip(z_t, jax.tree.leaves(z_whole)):
        _close(a, b)


@pytest.mark.parametrize("config", list(ASYNC_CONFIGS))
def test_port_async_checkpoint_loads_into_jax(games, tmp_path, config):
    jg, tg = games
    whole = _port_async(tg, config)
    z_whole = whole.run()
    part = _port_async(tg, config)
    part.run(until_admissions=4)
    path = str(tmp_path / "ck")
    part.save(path)
    je = _jax_async(jg, config).restore(path)
    assert je.n_admissions == 4
    for a, b in zip(je.state.z_tilde, part.state.z_tilde):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    z_j = je.run()
    assert _async_host(je) == _async_host(whole)[4:]
    _close([r.residual for r in je.trace.rounds],
           [r.residual for r in whole.trace.rounds[4:]])
    for a, b in zip(jax.tree.leaves(z_j), z_whole):
        _close(a, b)
