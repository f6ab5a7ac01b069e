"""The port and its smoke script import with jax and flax absent: the machine
with the card has neither, and neither may reach for them. Nor do they load
the JAX package (raytrace_tpu) or the root bench.py, which imports nothing
but the standard library at module level."""
import os
import subprocess
import sys

import pytest

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import raytrace_tpu_torch
names = [m.name for m in pkgutil.walk_packages(raytrace_tpu_torch.__path__,
                                               "raytrace_tpu_torch.")]
if sys.argv[1] == "chip_smoke":
    names = ["chip_smoke"]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "flax"))
               for k, v in sys.modules.items() if v is not None)
assert not any(k in ("raytrace_tpu", "bench")
               or k.startswith("raytrace_tpu.") for k in sys.modules)
print(len(names))
"""


@pytest.mark.parametrize("what,min_modules", [("package", 50),
                                              ("chip_smoke", 1)])
def test_port_imports_without_jax_or_flax(what, min_modules):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _SCRIPT, what], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= min_modules  # all were imported
