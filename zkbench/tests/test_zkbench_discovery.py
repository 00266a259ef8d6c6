"""A cell, a configuration and a per-layer metric are files the harness
finds by the names BENCHMARK.json gives them: a throwaway tree with one
more workload file and one more metric file, and no other change, is
discovered whole."""
import json
import os
import shutil

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


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.-]{1,16}"


def test_every_entry_of_the_benchmark_has_its_files():
    import re
    root = harness.ROOT
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert re.fullmatch(NAME, c["name"])
        assert os.path.exists(os.path.join(root, c["file"]))
        assert harness.load_json(os.path.join(root, c["file"]))["name"] == \
            c["name"]
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
