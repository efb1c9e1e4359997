"""A launcher's world of ranks for `--devices N > 1`: N processes started
with `torch.multiprocessing` (spawn), joined into one `torch.distributed`
process group through a `file://` rendezvous in a fresh temporary
directory.

The backend: `--device cpu` runs gloo on the host; `--device cuda` runs
NCCL, one card a rank, when the machine has N cards, and otherwise gloo
with every rank on cuda:0 (several ranks share the card; NCCL does not
run two ranks on one GPU).  With `--device cuda` and no card it raises,
never dropping to the CPU.
"""
from __future__ import annotations

import os
import tempfile


def plan(devices: int, device: str):
    """(backend, [each rank's device]) of a world of `devices` ranks."""
    import torch
    from repro_torch.core.types import resolve_device
    dev = resolve_device(device)            # raises: cuda asked, none here
    if dev.type == "cpu":
        return "gloo", ["cpu"] * devices
    if torch.cuda.device_count() >= devices:
        return "nccl", [f"cuda:{r}" for r in range(devices)]
    return "gloo", ["cuda:0"] * devices


def describe(backend: str, rank_devices) -> str:
    """The banner's words for a world."""
    where = sorted(set(rank_devices))
    return (f"{len(rank_devices)} ranks over {backend} on "
            f"{', '.join(where)}")


def _rank_main(rank, world, tmp, backend, rank_devices, target, args):
    import torch
    import torch.distributed as dist
    dev = rank_devices[rank]
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    try:
        target(args, rank, world, dev, describe(backend, rank_devices))
    finally:
        dist.destroy_process_group()


def run(target, args, devices: int, device: str) -> None:
    """Run `target(args, rank, world, rank_device, banner)` on every rank
    of a world of `devices` ranks (`plan`), and wait for all of them; a
    rank that fails fails the run."""
    import torch.multiprocessing as mp
    backend, rank_devices = plan(devices, device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(devices, tmp, backend,
                                             rank_devices, target, args),
                           nprocs=devices, join=True, start_method="spawn")
