"""The port stands alone: it imports neither jax nor the JAX package,
and its entry points refuse to run on a CPU-only host unless asked to.

The import checks run in a fresh interpreter: pytest workers share
``sys.modules`` with test files that import jax."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)


def test_importing_the_port_loads_no_jax():
    res = _run(
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "print(bad)\n")
    assert res.returncode == 0, res.stderr
    n_mods, bad = res.stdout.strip().splitlines()
    assert int(n_mods) >= 20
    assert bad == "[]"


def _imported_names(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "examples" / "quickstart_torch.py",
                            ROOT / "examples" / "serve_concurrent_torch.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_default_device_raises_without_cuda():
    res = _run(
        "import sys\n"
        "from repro_torch.common import resolve_device\n"
        "from repro_torch.core.multistage import MultiStageRetriever\n"
        "from repro_torch.core.plaid import PLAIDSearcher\n"
        "from repro_torch.index.splade_device import SpladeDeviceCache\n"
        "assert resolve_device('cpu').type == 'cpu'\n"
        "for make in (lambda: resolve_device(),\n"
        "             lambda: PLAIDSearcher(object()),\n"
        "             lambda: SpladeDeviceCache(object()),\n"
        "             lambda: MultiStageRetriever(None, None)):\n"
        "    try:\n"
        "        make()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        sys.exit('constructed on a host without CUDA')\n")
    assert res.returncode == 0, res.stderr + res.stdout


def test_importing_the_worker_starts_nothing():
    """The shard worker and its client load torch and the shard only when
    run: importing them starts no thread, no process and no CUDA
    context."""
    res = _run(
        "import os, sys, threading\n"
        "import repro_torch.serving.worker\n"
        "import repro_torch.serving.transport.client\n"
        "kids = []\n"
        "for p in os.listdir('/proc'):\n"
        "    try:\n"
        "        stat = open(f'/proc/{p}/stat').read().split()\n"
        "    except (OSError, NotADirectoryError):\n"
        "        continue\n"
        "    if p.isdigit() and stat[3] == str(os.getpid()):\n"
        "        kids.append(p)\n"
        "torch = sys.modules.get('torch')\n"
        "print(threading.active_count(), len(kids),\n"
        "      torch is not None and torch.cuda.is_initialized())\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["1", "0", "False"]
