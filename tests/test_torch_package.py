"""Rules of the PyTorch package: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU, its ctypes
bindings match the C entry points of its CUDA sources, and the chip smoke
script refuses to run without a card."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.core import AdaSEGConfig, run_local_adaseg
from repro_torch.kernels import _build
from repro_torch.kernels.adaseg_update import kernel as _adaseg_kernels  # noqa: F401
from repro_torch.kernels.flash_attention import kernel as _flash_kernel  # noqa: F401
from repro_torch.kernels.ssd_scan import kernel as _ssd_kernel  # noqa: F401
from repro_torch.kernels.sync_compress import kernel as _merge_kernel  # noqa: F401
from repro_torch.problems import make_bilinear_game
from repro_torch.ps import PSConfig, PSEngine

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_reference_package_imports(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro", "msgpack"), (path,
                                                                  name)


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "examples/torch_wgan_train.py",
                                    "examples/torch_ps_simulate.py"])
def test_chip_smoke_imports_no_jax(script):
    names = set(_imports(REPO / script))
    assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")
                   for n in names), names


def test_package_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "sys.modules['msgpack'] = None; "
            "import repro_torch.ps, repro_torch.interop, "
            "repro_torch.ps.robust, repro_torch.ps.server_opt, "
            "repro_torch.checkpoint, "
            "repro_torch.kernels.adaseg_update.ops, "
            "repro_torch.kernels.sync_compress.ops, "
            "repro_torch.kernels.flash_attention.kernel, "
            "repro_torch.kernels.ssd_scan.kernel, repro_torch.configs, "
            "repro_torch.data, repro_torch.models, repro_torch.launch, "
            "repro_torch.optim, repro_torch.ps.partition, "
            "repro_torch.problems.quadratic, repro_torch.problems.robust, "
            "repro_torch.problems.wgan, repro_torch.obs.metrics, "
            "repro_torch.obs.export, repro_torch.hardware, "
            "repro_torch.core.metrics, repro_torch.ps.latency, "
            "repro_torch.ps.async_engine; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda_and_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    key = jr.PRNGKey(0, device="cpu")
    with pytest.raises(RuntimeError):
        jr.PRNGKey(0)
    with pytest.raises(RuntimeError):
        make_bilinear_game(key, n=4)
    game = make_bilinear_game(key, n=4, device="cpu")
    cfg = PSConfig(adaseg=AdaSEGConfig(g0=1.0, diameter=2.0, k=2),
                   num_workers=2, rounds=1)
    with pytest.raises(RuntimeError):
        PSEngine(game.problem, cfg, rng=key)
    with pytest.raises(RuntimeError):
        run_local_adaseg(game.problem, cfg.adaseg, num_workers=2, rounds=1,
                         rng=key)


def _c_params(source: str, symbol: str) -> int:
    text = (PKG / "csrc" / source).read_text()
    m = re.search(rf"\bint\s+{symbol}\s*\(([^)]*)\)", text)
    assert m, f"{symbol} not found in {source}"
    return len([p for p in m.group(1).split(",") if p.strip()])


def test_bindings_match_the_c_entry_points():
    """Each Kernel's argtypes has one entry per parameter of its extern "C"
    launcher (a missing one would shift every later argument)."""
    names = {k.name for k in _build.KERNELS}
    assert names == {"adaseg_explore", "adaseg_anchor", "adaseg_finish",
                     "adaseg_update", "merge_stacked", "uplink_stats",
                     "quantize_uplink", "eff_uplink", "mask_uplink",
                     "trimmed_merge_stacked", "outer_apply",
                     "flash_attention", "ssd_scan"}
    for k in _build.KERNELS:
        assert (PKG / "csrc" / k.source).is_file()
        assert _c_params(k.source, k.symbol) == len(k.argtypes), k.name
        assert k.launches == 0          # no launch without a card


def test_library_names_track_the_source():
    for src in _build.sources():
        path = _build.library_path(src)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(Path(src).stem + "-")
        assert path.suffix == ".so"
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast" in f for f in _build.NVCC_FLAGS)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if script.parent == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_interop_keys_round_trip():
    keys = np.array([[0, 1], [2**32 - 1, 7]], dtype=np.uint32)
    from repro_torch import interop

    got = interop.key_from_numpy(keys, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), keys)
    with pytest.raises(ValueError):
        interop.key_from_numpy(keys.astype(np.int32), device="cpu")


DOCTEST_MODULES = [
    "repro_torch.random", "repro_torch.interop", "repro_torch.core.worker",
    "repro_torch.kernels.adaseg_update.ops",
    "repro_torch.kernels.sync_compress.kernel",
    "repro_torch.kernels.sync_compress.ops",
    "repro_torch.kernels.sync_compress.ref", "repro_torch.obs.spans",
    "repro_torch.ps.compress", "repro_torch.ps.engine",
    "repro_torch.ps.faults", "repro_torch.ps.schedule", "repro_torch.ps.trace",
    "repro_torch.ps.robust.aggregators", "repro_torch.ps.robust.byzantine",
    "repro_torch.ps.robust.dp", "repro_torch.ps.server_opt",
    "repro_torch.checkpoint.serialize", "repro_torch.data.synthetic",
    "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.ssd_scan.kernel", "repro_torch.kernels.ssd_scan.ref",
    "repro_torch.models.ssm", "repro_torch.models.moe",
    "repro_torch.models.rglru",
    "repro_torch.models.transformer", "repro_torch.models.problem",
    "repro_torch.models.worker", "repro_torch.launch.train",
    "repro_torch.core.types", "repro_torch.core.projections",
    "repro_torch.core.metrics", "repro_torch.problems.quadratic",
    "repro_torch.problems.robust", "repro_torch.optim.base",
    "repro_torch.optim.methods", "repro_torch.ps.partition",
    "repro_torch.problems.wgan", "repro_torch.obs.metrics",
    "repro_torch.obs.export", "repro_torch.hardware",
    "repro_torch.ps.latency", "repro_torch.ps.async_engine",
    "repro_torch.ps.sampler",
]


@pytest.mark.parametrize("name", DOCTEST_MODULES)
def test_docstring_examples_run(name):
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(name),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0, result
