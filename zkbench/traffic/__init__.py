"""Seeded inputs of a cell: traffic/<circuit>.py `make(config, cell, rng)`
gives the inputs the driver and the reference both take, with `jobs`, the
number of jobs the prover cycles through.  Every random choice comes from one
`random.Random(seed)`, so the same seed gives the same inputs."""
from __future__ import annotations

import importlib
import random


def make(config: dict, cell: dict, seed: int) -> dict:
    mod = importlib.import_module(f"zkbench.traffic.{config['circuit']}")
    return mod.make(config, cell, random.Random(seed))
