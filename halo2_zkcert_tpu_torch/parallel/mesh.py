"""The sharded prover's process group, and a helper that spawns its ranks.

Counterpart of halo2_zkcert_tpu/parallel/mesh.py (a jax.sharding.Mesh
there).  A `Mesh` is this process's view of a torch.distributed group: its
rank, its size, its device, its backend, and the device its collectives take.
With `nccl` (a card a rank) the collectives move CUDA tensors; with `gloo`
(the CPU, or several ranks sharing one card, which NCCL refuses) they are
staged through CPU tensors, a property of the mesh and not a fallback.  Only
int32 and int64 tensors are exchanged.  Every collective adds to the mesh's
`bytes_sent` (what this rank sent to the others) and `seconds`.  A group of
one rank still calls its backend.

`run_ranks(fn, world_size, backend, devices)` spawns `world_size` processes
(start method `spawn`, as CUDA needs), initialises the group from a
`file://` store in a temporary directory, calls fn(mesh, *args) on each rank
and returns the results in rank order.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    rank: int
    size: int
    device: torch.device
    backend: str            # "nccl" or "gloo"
    bytes_sent: int = 0
    seconds: float = 0.0
    collectives: int = 0

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives' tensors live."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

    @property
    def staged(self) -> bool:
        """True when collectives copy CUDA tensors through the host."""
        return self.comm_device != self.device

    def _timed(self, fn, t: torch.Tensor, sent: int) -> torch.Tensor:
        if t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"mesh collectives take int32 or int64, got "
                             f"{t.dtype}")
        t0 = time.perf_counter()
        out = fn(t.to(self.comm_device).contiguous()).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds += time.perf_counter() - t0
        self.bytes_sent += sent
        self.collectives += 1
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size,) + t.shape: every rank's `t`, in rank order."""
        def gather(x):
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x)
            return torch.stack(parts)

        return self._timed(gather, t, t.numel() * t.element_size()
                           * (self.size - 1))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t (size, ...): t[i] goes to rank i; returns (size, ...) whose
        [i] came from rank i."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all: leading axis {t.shape[0]} is not "
                             f"the mesh size {self.size}")

        def exchange(x):
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
            return out

        return self._timed(exchange, t, t.numel() * t.element_size()
                           * (self.size - 1) // self.size)


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """This process's Mesh over the initialised default group.  `device`:
    this rank's device, default the current CUDA device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(run_ranks initialises it on each rank)")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the group has {size} ranks")
    return Mesh(dist.get_rank(), size, device, dist.get_backend())


def default_mesh(device=None) -> Mesh:
    return make_mesh(None, device)


def _rank_main(rank: int, fn, world_size: int, backend: str, devices, args,
               tmp: str) -> None:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(minutes=20))
    try:
        out = fn(make_mesh(world_size, device), *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str, devices, args=()) -> list:
    """Spawn `world_size` ranks, rank i on devices[i] (a list, or one device
    for all), each running fn(mesh, *args); fn must be importable by name
    (a module-level function).  Returns the results in rank order; raises
    if any rank raised."""
    import torch.multiprocessing as mp
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * world_size
    devices = [str(d) for d in devices]
    with tempfile.TemporaryDirectory(prefix="h2t_mesh_") as tmp:
        mp.start_processes(_rank_main, args=(fn, world_size, backend, devices,
                                             args, tmp),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
