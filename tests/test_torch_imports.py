"""tpu_fhe_torch and chip_smoke.py import neither jax nor tpu_fhe."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "tpu_fhe_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|tpu_fhe)(\.|\s|$)", re.MULTILINE)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        yield ".".join(p for p in rel.parts if p != "__init__")


def test_sources_name_no_jax_or_reference():
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        text = path.read_text()
        assert not FORBIDDEN.search(text), f"{path} imports jax or tpu_fhe"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_fhe'] = None\n"
        "import importlib\n"
        f"for name in {list(_modules())!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'tpu_fhe.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
