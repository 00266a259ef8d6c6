"""The port stands alone: halo2_zkcert_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, not even its jax-free host modules."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "halo2_zkcert_tpu_torch")
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|halo2_zkcert_tpu)(\.|\s|$)", re.M)


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_no_forbidden_import_statements():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            for m in FORBIDDEN.finditer(f.read()):
                bad.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not bad, bad
    assert len(_port_sources()) > 20


def test_no_port_module_reads_the_jax_native_directory():
    """The port's host library is built from its own csrc/hostmath.cpp,
    never from the JAX package's native/ sources or library."""
    path_ref = re.compile(r"""["']native["']|native/(hostmath|lib)""")
    bad = []
    for path in _port_sources():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if path_ref.search(line):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{i}")
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    """In a fresh interpreter where importing jax or the JAX package fails,
    every module of the port and chip_smoke.py still import."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "halo2_zkcert_tpu"):
    sys.modules[name] = None          # any import of these now raises
import halo2_zkcert_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
          and sys.modules[m] is not None]
assert not loaded, loaded
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device, and where it stands alone without the package."""
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
