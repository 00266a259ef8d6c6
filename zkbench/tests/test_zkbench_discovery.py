"""A cell, a configuration, a circuit kind and a per-layer metric are files
the harness finds by the names BENCHMARK.json gives them: a throwaway tree
with one more workload file and one more metric file, or with a toy circuit
kind's six files, and no other change, is discovered whole."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from zkbench import harness


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    root = tmp_path
    shutil.copytree(os.path.join(harness.ROOT, "zkbench"), root / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.load_json(os.path.join(
        harness.ROOT, "zkbench", "workloads", "rsa2048_k17.solo.json"))
    cell.update(name="rsa2048_k17.long", tbs_bytes=[1800, 4000])
    (root / "zkbench" / "workloads" / "rsa2048_k17.long.json").write_text(
        json.dumps(cell))
    (root / "zkbench" / "metrics" / "proofs_in_window.py").write_text(
        "def read(run):\n    return len(run.completed)\n")
    bench["workloads"].append({"name": "rsa2048_k17.long",
                               "config": "rsa2048_k17", "traffic": "long",
                               "chips": 1, "why": "long TBS"})
    bench["per_layer"].append({"name": "proofs_in_window", "unit": "proofs",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "entry", "moves": "proofs_per_s",
                               "workloads": ["rsa2048_k17.long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    got, config, counts = harness.load_cell("rsa2048_k17.long", str(root))
    assert got["tbs_bytes"] == [1800, 4000]
    assert config["issuer_bits"] == 2048
    assert counts["quotient_products_per_row"] == 74
    names = [m["name"] for m in harness.metric_entries(
        bench, "rsa2048_k17.long", True)]
    assert "proofs_in_window" in names and "witness_ms" not in names
    assert "proofs_in_window" not in [m["name"] for m in
                                      harness.metric_entries(
                                          bench, "rsa2048_k17.solo", True)]
    read = harness.reader("proofs_in_window", str(root))
    assert callable(read)


TOY = {
    "configs/toy.json": json.dumps({"name": "toy", "circuit": "toy", "k": 4}),
    "workloads/toy.solo.json": json.dumps({
        "name": "toy.solo", "config": "toy", "traffic": "solo", "chips": 1,
        "jobs": 5, "sample": 4}),
    "traffic/toy.py": """
def make(config, cell, rng):
    return {"secret": rng.randbytes(16), "jobs": cell["jobs"]}
""",
    # a proof of job j: the digest of (an inner proof made in set-up, j),
    # then its blinding's digest; the inner proof is the secret's digest
    "drivers/toy.py": """
import hashlib


class Driver:
    def __init__(self, config, inputs, device):
        self.inputs = inputs

    def setup(self, params_dir):
        self.inner = hashlib.sha256(self.inputs["secret"]).digest()

    def prove(self, job, blinding, fault=None):
        stmt = hashlib.sha256(self.inner + bytes([job])).digest()
        return stmt + hashlib.sha256(blinding).digest(), None, {}

    def verifying_key(self):
        return [], []

    def artifacts(self):
        return {"inner": self.inner}

    def close(self):
        pass
""",
    "reference/toy.py": """
import hashlib


class Toy:
    def __init__(self, inputs, artifacts):
        inner = artifacts.get("inner")
        ok = inner == hashlib.sha256(inputs["secret"]).digest()
        self.inner = inner if ok else None

    def verify(self, job, proof):
        return self.inner is not None and proof[:32] == hashlib.sha256(
            self.inner + bytes([job])).digest()

    def random_commitment(self, proof):
        return proof[32:]

    def key_differences(self, fixed, permutation):
        return len(fixed) + len(permutation)


def reference(config, inputs, artifacts, tau):
    return Toy(inputs, artifacts)
""",
}

# run in a fresh interpreter on the throwaway tree, which it imports as
# `zkbench`: discovery by name, traffic, the toy driver through the closed
# loop, and the judge on its artifacts as handed over and as refused
SCRIPT = """
import json, sys, time
import zkbench
from zkbench import harness, judge, loop, traffic
from zkbench.reference import Reference
import zkbench.drivers.toy as toy_driver
cell, config, counts = harness.load_cell("toy.solo", sys.argv[1])
inputs = traffic.make(config, cell, 2 ** 31 + 5)
driver = toy_driver.Driver(config, inputs, None)
driver.setup(None)
jobs = list(range(inputs["jobs"]))
proofs = loop.window(driver, jobs, "toy", time.perf_counter() + 0.05)
vk, artifacts = driver.verifying_key(), driver.artifacts()
out = {"root": zkbench.__file__, "cell": cell["name"],
       "circuit": config["circuit"], "jobs": inputs["jobs"],
       "same_inputs": inputs == traffic.make(config, cell, 2 ** 31 + 5),
       "plain": harness.plain(artifacts)}
for name, arts in (("handed", artifacts), ("refused", {"inner": b"x" * 32}),
                   ("none", {})):
    v = judge.judge(Reference(config, inputs, arts), proofs, vk,
                    cell["sample"], 7)
    out[name] = dict(v["checks"], checked=v["checked"], correct=v["correct"])
print(json.dumps(out))
"""


def test_a_new_circuit_kind_is_new_files_only(tmp_path):
    shutil.copytree(os.path.join(harness.ROOT, "zkbench"),
                    tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel, text in TOY.items():
        path = tmp_path / "zkbench" / rel
        assert not path.exists()
        path.write_text(text)
    got = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert got.returncode == 0, got.stderr
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["root"].startswith(str(tmp_path))
    assert (out["cell"], out["circuit"], out["jobs"]) == ("toy.solo", "toy", 5)
    assert out["same_inputs"] and out["plain"]
    good = out["handed"]
    assert good["correct"] and good["checked"] == 4
    assert (good["rejected"], good["missing"], good["reused_blinding"],
            good["key_mismatch"]) == (0, 0, 0, 0)
    for refused in (out["refused"], out["none"]):
        assert not refused["correct"]
        assert refused["rejected"] == refused["checked"] == 4


@pytest.mark.parametrize("value,ok", [
    ({"inner": [b"p", 3, ["s", {"t": 1}]]}, True),
    ({"inner": (b"p", 2 ** 300)}, True),
    ({"inner": 1.5}, False),
    ({"inner": [b"p", object()]}, False),
    ({1: b"p"}, False)])
def test_artifacts_are_plain_data(value, ok):
    assert harness.plain(value) is ok


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.-]{1,16}"


def test_every_entry_of_the_benchmark_has_its_files():
    import importlib
    import re
    root = harness.ROOT
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert re.fullmatch(NAME, c["name"])
        assert os.path.exists(os.path.join(root, c["file"]))
        config = harness.load_json(os.path.join(root, c["file"]))
        assert config["name"] == c["name"]
        # the circuit kind's traffic generator and reference, by its name
        circuit = config["circuit"]
        assert callable(importlib.import_module(
            f"zkbench.traffic.{circuit}").make)
        assert callable(importlib.import_module(
            f"zkbench.reference.{circuit}").reference)
    for name, w in cells.items():
        assert re.fullmatch(NAME, name) and w["config"] in configs
        cell, config, counts = harness.load_cell(name)
        assert cell["name"] == name and cell["config"] == w["config"]
        assert cell["chips"] == w["chips"] == 1
        assert os.path.exists(os.path.join(
            root, "zkbench", "drivers", f"{config['circuit']}.py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.fullmatch(NAME, m["name"]) and re.fullmatch(UNIT, m["unit"])
        assert callable(harness.reader(m["name"]))
        assert set(m.get("workloads", cells)) <= set(cells)
    for cell in cells:
        assert harness.metric_entries(bench, cell, False)
        assert harness.metric_entries(bench, cell, True)
