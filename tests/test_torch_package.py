"""Guards of the PyTorch port: what it imports, where it runs, and that a
CPU tensor never reaches a kernel."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.mule_cnn import smoke_config  # noqa: E402
from repro_torch.core.population import PopulationConfig, init_population  # noqa: E402
from repro_torch.experiment import cnn_model_fns  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mule_agg import mule_agg  # noqa: E402
from repro_torch.scenarios import get_scenario, run_population  # noqa: E402

torch.set_num_threads(1)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules
                if k in ("jax", "repro") or k.startswith(("jax.", "repro.")))
print(len(names), leaked)
"""


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20
    assert leaked.strip() == "[]"


def _tiny(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PopulationConfig(mode="mobile", n_fixed=8, n_mules=3)
    init_fn, train_fn, _ = cnn_model_fns(smoke_config(), 0.05)
    return cfg, init_fn, train_fn


def test_entry_points_raise_without_a_card(monkeypatch):
    cfg, init_fn, train_fn = _tiny(monkeypatch)
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_population(cfg, init_fn, gen)
    pop = init_population(cfg, init_fn, gen, device="cpu")
    co = get_scenario("commuter").colocation(0, 3, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_population(pop, co, lambda s, t: None, train_fn, cfg, 0)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    cfg, init_fn, train_fn = _tiny(monkeypatch)
    before = mule_agg.launches
    a, w = torch.rand(4, 6), torch.randn(6, 50)
    torch.testing.assert_close(mule_agg(a, w), a @ w)
    pop = init_population(cfg, init_fn, torch.Generator(), device="cpu")
    co = get_scenario("commuter").colocation(0, 3, 4)
    x = torch.randn(4, 3, 2, 16, 16, 3)
    y = torch.randint(0, 4, (4, 3, 2))
    run_population(pop, co, {"fixed": None, "mule": (x, y)}, train_fn, cfg,
                   0, device="cpu")
    assert mule_agg.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("mule_agg")
    assert not (tmp_path / "build").exists()


def test_edited_source_builds_a_new_library(monkeypatch, tmp_path):
    """The library's name hashes its source, so an edit rebuilds."""
    src = tmp_path / "k.cu"
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    monkeypatch.setattr(_build, "SOURCES", {"k": "k.cu"})
    src.write_text("extern \"C\" int f(void) { return 0; }\n")
    first = _build.library_path("k")
    src.write_text("extern \"C\" int f(void) { return 1; }\n")
    second = _build.library_path("k")
    assert first != second
    assert first.parent == second.parent == _build.BUILD_DIR
    assert first.name.startswith("k-") and first.suffix == ".so"
