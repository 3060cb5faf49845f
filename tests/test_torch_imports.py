"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` import
nothing of JAX and nothing of the JAX package ``repro``."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_exist():
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_rendered_kernel_modules_import_only_the_port():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import codegen
    from repro_torch.core.genome import SEED_LIBRARY, SEED_MONOLITH, SEED_MXU
    for g in (SEED_LIBRARY, SEED_MONOLITH, SEED_MXU):
        tree = ast.parse(codegen.render_source(g))
        roots = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)}
        assert not roots & set(FORBIDDEN), roots


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.core, repro_torch.kernels, "
            "repro_torch.launch.scientist, repro_torch.models, "
            "repro_torch.models.convert, repro_torch.serve, "
            "repro_torch.launch.serve, repro_torch.configs, "
            "repro_torch.core.eval_worker, repro_torch.models.rglru\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
