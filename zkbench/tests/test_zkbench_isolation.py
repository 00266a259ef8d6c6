"""No module that the command loads, nor any the reference loads, has the
top-level name of JAX or of the JAX package; the reference loads nothing of
the program either.  Names are compared whole, up to the first dot: the
program's package name begins with the JAX package's."""
import json
import os
import subprocess
import sys

from zkbench import harness

ROOT = harness.ROOT
JAXISH = {"jax", "jaxlib", "flax", "halo2_zkcert_tpu"}


def _top_levels(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_names_decide():
    fake = {"halo2_zkcert_tpu_torch.plonk": None, "jaxtyping": None,
            "halo2_zkcert_tpu.ops": None, "jaxlib.xla": None}
    saved = {k: sys.modules.get(k) for k in fake}
    try:
        sys.modules.update(fake)
        assert harness.forbidden_modules() == ["halo2_zkcert_tpu.ops",
                                               "jaxlib.xla"]
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_the_command_loads_no_jax():
    mods = _top_levels(
        "import zkbench.run, zkbench.harness, zkbench.loop, zkbench.trace, "
        "zkbench.judge, zkbench.breakdown, zkbench.reference\n"
        "import zkbench.drivers.rsa, zkbench.drivers.sha256_gate\n"
        "import halo2_zkcert_tpu_torch.circuits.rsa, "
        "halo2_zkcert_tpu_torch.circuits.sha256_gate, "
        "halo2_zkcert_tpu_torch.plonk, halo2_zkcert_tpu_torch.transcript, "
        "halo2_zkcert_tpu_torch.ops.kernels\n"
        "from zkbench.harness import reader, load_json, metric_entries\n"
        "b = load_json('BENCHMARK.json')\n"
        "for t in (0, 1):\n"
        "    for w in b['workloads']:\n"
        "        [reader(m['name']) for m in metric_entries(b, w['name'], t)]")
    assert "halo2_zkcert_tpu_torch" in mods
    assert not mods & JAXISH


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_levels(
        "import importlib, pkgutil, zkbench.reference as r\n"
        "for m in pkgutil.iter_modules(r.__path__):\n"
        "    importlib.import_module(f'zkbench.reference.{m.name}')")
    assert not mods & (JAXISH | {"halo2_zkcert_tpu_torch", "torch"})
