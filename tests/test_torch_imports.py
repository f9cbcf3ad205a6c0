"""The port stands alone: importing every repro_torch module loads neither
JAX nor any module of the `repro` package, and chip_smoke.py refuses to run
without a CUDA device."""

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return env


def test_port_imports_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(), capture_output=True,
                         text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    for mod in ("repro_torch.serving.engine", "repro_torch.kernels.attn",
                "repro_torch.launch.serve", "repro_torch.convert"):
        assert mod in got["modules"]


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        return  # on a card the script runs for real (README: chip_smoke.py)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
