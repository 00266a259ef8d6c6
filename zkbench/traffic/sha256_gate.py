"""One TBS of the cell's `tbs_bytes` length, random bytes from the seed;
every job proves its digest again with a fresh blinding stream."""
from __future__ import annotations

import random


def make(config: dict, cell: dict, rng: random.Random) -> dict:
    return {"message": rng.randbytes(cell["tbs_bytes"]), "jobs": cell["jobs"]}
