"""The port stands alone: no module of sentio_tpu_torch, and not
chip_smoke.py, imports JAX (or flax/optax) or anything of the JAX package,
nor an HTTP or metrics package the machine with the card lacks (aiohttp,
httpx, pydantic, prometheus_client) — checked statically on every file,
then by importing every module in a fresh interpreter where those imports
are blocked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "sentio_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sentio_tpu", "aiohttp", "httpx", "pydantic",
             "prometheus_client"}


def _port_files():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = list(path.relative_to(REPO).with_suffix("").parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    modules = list(_modules())
    assert len(modules) >= 20, modules
    assert {"sentio_tpu_torch.runtime.speculative",
            "sentio_tpu_torch.runtime.paged_spec", "sentio_tpu_torch.eval.runner",
            "sentio_tpu_torch.eval.baseline", "sentio_tpu_torch.eval.train_encoder",
            "sentio_tpu_torch.infra.flight", "sentio_tpu_torch.infra.http_client",
            "sentio_tpu_torch.ops.confidence"} <= set(modules)
    script = (
        "import sys, importlib\n"
        f"for name in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[name] = None\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r} and sys.modules[m] is not None)\n"
        "assert not leaked, leaked\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")
