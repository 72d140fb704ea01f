"""Every example is a self-asserting end-to-end program (they raise on
numerical mismatch); these tests pin that they stay green. Marked slow —
each compiles several full op graphs on the CPU backend."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
@pytest.mark.parametrize("script", [
    "encrypted_dot_product.py",
    "encrypted_matvec_bsgs.py",
    "encrypted_logreg.py",
])
def test_example_runs(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script)],
        capture_output=True, text=True, timeout=900, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
