"""The PyTorch port imports no JAX, directly or through the JAX package."""

import os
import subprocess
import sys

import pytest

pytest.importorskip('torch')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, pkgutil, sys
import align_anything_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               'align_anything_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'align_anything_tpu.')))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.split(maxsplit=1)
    assert bad.strip() == '[]', bad
    # every module of the slice was imported
    assert int(n) >= 26
