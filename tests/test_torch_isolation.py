"""The PyTorch port stands alone: no file of ``src/repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package ``repro``, the whole
package imports with both blocked, and its entry points default to the
card and refuse to run on a machine without one."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib') and\n"
        "               sys.modules[k] is not None for k in sys.modules)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_entry_points_default_to_the_card():
    """Without ``device="cpu"`` every entry point asks for CUDA; on a
    machine without a card that raises instead of running on the CPU."""
    from repro_torch.api.session import ElasticSession, RunSpec
    from repro_torch.experiments.paper_repro import run_one

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticSession(RunSpec(rounds=1, n_data=64, n_test=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_one("DEAHES-O", 2, 1, rounds=1, n_data=64, n_test=8)


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with the build made to
    fail, the wrapper raises rather than falling back (checked without a
    card by handing the wrapper a tensor that claims to be on CUDA)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.elastic import ops

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(build, "library_path",
                        lambda src: ROOT / "build" / "absent" / "x.so")
    monkeypatch.setattr(ops.BATCHED_KERNEL, "_fn", None)
    monkeypatch.setattr(ops, "check_f32", lambda *a: torch.device("cuda"))
    w, m, h = torch.zeros(2, 3), torch.zeros(3), torch.zeros(2, 2)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.elastic_update_batched(w, m, h)
    assert torch.equal(w, torch.zeros(2, 3))


def test_flash_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """The same for the flash-attention wrapper: a tensor that claims to be
    on CUDA goes to the kernel, whose failed build raises; the plain
    version never runs."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(build, "library_path",
                        lambda src: ROOT / "build" / "absent" / "x.so")
    monkeypatch.setattr(ops.KERNEL, "_fn", None)
    monkeypatch.setattr(ops, "check_f32_or_bf16",
                        lambda *a: torch.device("cuda"))
    monkeypatch.setattr(ops, "flash_attention_plain", plain)
    q, kv = torch.zeros(1, 128, 4, 64), torch.zeros(1, 128, 2, 64)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.flash_attention_bshd(q, kv, kv)
