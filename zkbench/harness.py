"""One run of one cell: inputs from the seed, the program's set-up, a
closed-loop window, the reference's judgement, and the result line.

Everything cell-specific is found by name under the benchmark's folder:
workloads/<cell>.json, configs/<config>.json, drivers/<circuit>.py,
traffic/<circuit>.py, reference/<circuit>.py, metrics/<metric>.py and
counts/<config>.json; the metrics a cell reports are the entries of
BENCHMARK.json that name it (or name no cells).  A new circuit kind is new
files only."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "halo2_zkcert_tpu")


def use_params_dir(root: str = ROOT) -> str:
    """The SRS and window-table cache: a fixed directory in the checkout."""
    path = os.path.join(root, "build", "zkbench_params")
    os.makedirs(path, exist_ok=True)
    os.environ["PARAMS_DIR"] = path
    return path


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> tuple:
    """(cell, config, counts) of a workload name."""
    here = os.path.join(root, "zkbench")
    cell = load_json(os.path.join(here, "workloads", f"{name}.json"))
    config = load_json(os.path.join(here, "configs",
                                    f"{cell['config']}.json"))
    counts_path = os.path.join(here, "counts", f"{cell['config']}.json")
    counts = load_json(counts_path) if os.path.exists(counts_path) else {}
    counts["peaks"] = load_json(os.path.join(here, "counts", "peaks.json"))
    return cell, config, counts


def metric_entries(bench: dict, cell: str, traced: bool) -> list:
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str, root: str = ROOT):
    path = os.path.join(root, "zkbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"zkbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def plain(value) -> bool:
    """Whether `value` is plain data: bytes, ints and strings in lists,
    tuples and dicts keyed by strings (what a driver's artifacts may be)."""
    if isinstance(value, (bytes, int, str)):
        return True
    if isinstance(value, (list, tuple)):
        return all(map(plain, value))
    if isinstance(value, dict):
        return all(isinstance(k, str) and plain(v) for k, v in value.items())
    return False


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Run:
    """What the metric readers read (metrics/<name>.py `read(run)`)."""
    cell: dict
    config: dict
    counts: dict
    t_open: float
    t_close: float
    proofs: list                 # loop.Proof, every one started in the window
    setup_s: float
    peak_bytes: int
    launches: dict               # program launch counters over the window
    trace: object = None         # trace.Trace of the traced stretch

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    @property
    def finished(self) -> list:
        return [p for p in self.proofs if p.proof is not None]

    @property
    def completed(self) -> list:
        """Proofs that returned inside the window."""
        return [p for p in self.finished if p.end <= self.t_close]

    @property
    def traced(self) -> list:
        """Proofs wholly inside the traced stretch."""
        tr = self.trace
        return [] if tr is None else [p for p in self.finished
                                      if tr.lo <= p.start and p.end <= tr.hi]


def log(msg: str) -> None:
    print(f"[zkbench] {msg}", file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, fault: str | None = None,
        root: str = ROOT) -> dict | None:
    """Run the cell once.  The result dict, or None where the run may not
    report (no card, a forbidden module loaded, or no proof traced)."""
    import torch
    torch.set_num_threads(1)
    t_torch = time.perf_counter()
    cell, config, counts = load_cell(workload, root)
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return None
    device = torch.device("cuda", 0)

    from . import traffic
    t = time.perf_counter()
    inputs = traffic.make(config, cell, seed)
    traffic_s = time.perf_counter() - t
    log(f"inputs from seed {seed}: {traffic_s:.3f} s")

    from halo2_zkcert_tpu_torch.ops import kernels
    t = time.perf_counter()
    build_s = kernels.build_all()
    t_built = time.perf_counter()
    driver = importlib.import_module(
        f"zkbench.drivers.{config['circuit']}").Driver(config, inputs, device)
    driver.setup(os.environ["PARAMS_DIR"])
    t_keyed = time.perf_counter()

    from . import loop
    jobs, tag = list(range(inputs["jobs"])), f"{workload}|{seed}"
    loop.warm(driver, jobs, tag)
    launches0 = dict(kernels.launches)
    t_open = time.perf_counter()
    setup_s = t_open - t_start - traffic_s
    log(f"window opens: set-up {setup_s:.3f} s: imports {t_torch - t_start:.3f}"
        f", kernels {t_built - t:.3f} (nvcc {build_s:.3f}), SRS, tables, "
        f"circuit and key {t_keyed - t_built:.3f}, warm-up proof "
        f"{t_open - t_keyed:.3f}")
    tracer = None
    if trace:
        from .trace import Tracer
        lead = min(cell["trace_lead_s"], seconds / 4)
        tracer = Tracer(t_open + lead, min(cell["trace_s"], seconds - lead))
    t_close = t_open + seconds
    proofs = loop.window(driver, jobs, tag, t_close, fault, tracer)
    peak = torch.cuda.max_memory_allocated(device)
    launches = {k: v - launches0.get(k, 0) for k, v in kernels.launches.items()}
    vk = driver.verifying_key()
    artifacts = driver.artifacts() if hasattr(driver, "artifacts") else {}
    if not isinstance(artifacts, dict) or not plain(artifacts):
        raise TypeError("a driver's artifacts are a dict of plain data")
    tr = tracer.read() if tracer is not None else None
    if tracer is not None:
        if tr is None:
            log("the traced stretch holds no whole proof")
            return None
        log(f"traced {tr.window_s:.3f} s from {tr.lo - t_open:.3f} s into "
            f"the window, read in {tr.read_s:.3f} s")
    lat = sorted(p.end - p.start for p in proofs)
    wit = sorted(p.witness_s for p in proofs if p.witness_s is not None)
    log(f"window closed: {len(proofs)} proofs started, "
        f"{sum(p.end <= t_close for p in proofs)} in the window; latency "
        f"min / median / max {lat[0] if lat else 0:.4f} / "
        f"{lat[len(lat) // 2] if lat else 0:.4f} / {lat[-1] if lat else 0:.4f}"
        f" s; witness median {wit[len(wit) // 2] if wit else 0:.4f} s")
    run_rec = Run(cell, config, counts, t_open, t_close, proofs, setup_s,
                  peak, launches, tr)
    driver.close()
    del driver, tracer
    gc.collect()
    torch.cuda.empty_cache()

    from . import judge as judge_mod
    from .reference import Reference
    t = time.perf_counter()
    ref = Reference(config, inputs, artifacts)
    log(f"reference key worked out in {time.perf_counter() - t:.3f} s")
    verdict = judge_mod.judge(ref, proofs, vk, cell["sample"], seed)
    log(f"reference checked {verdict['checked']} proofs in "
        f"{verdict['seconds']:.3f} s")

    metrics = {}
    for entry in metric_entries(bench, workload, trace):
        value = reader(entry["name"], root)(run_rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return None
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": verdict["correct"], "attempted": len(proofs),
           "failed": sum(p.proof is None for p in proofs),
           "metrics": metrics, "device": dev}
    if tr is not None:
        from .breakdown import breakdown
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = breakdown(run_rec)
    for p in proofs:
        if p.error:
            log(f"proof of job {p.job} raised:\n{p.error}")
            break
    checks = {k: {"value": v, "max": judge_mod.LIMITS[k]}
              for k, v in verdict["checks"].items()}
    checks["checked"] = {"value": verdict["checked"], "min": 1}
    for k, v in checks.items():
        bound = (f"max {v['max']}" if "max" in v else f"min {v['min']}")
        print(f"check {k} {v['value']} ({bound})", file=sys.stderr,
              flush=True)
    out["checks"] = checks
    return out
