"""Device -> host sync counting for the host-sync budget (the JAX
package's R2, `repro/analysis/transfers.py`).

The port's device paths promise a fixed number of host syncs per
same-length query batch: their stop tests (one every `STOP_TEST_EVERY`
chunks, or one a sharded round) and one result readback, plus, for an
eps-range query whose hit buffer overflowed, one a chunk of its host
continuation.  Nothing marks a line as a sync, so the budget is counted
dynamically: run the search once to absorb first-use costs, then count
on an identical second call (`measure_steady_state`).

`count_transfers(device)` counts in one of two ways:

  * on the card (a CUDA device): `torch.cuda.set_sync_debug_mode("warn")`
    makes every synchronizing CUDA call warn (a blocking copy either way,
    `.item()`, a stream or device synchronize, and the implicit syncs of
    `nonzero` or boolean indexing that no patch sees); each warning is one
    sync, its site the Python line that made it;
  * on the CPU, where nothing synchronizes, the chokepoints through which
    a torch tensor becomes a host value are patched: `Tensor.item`,
    `.tolist`, `.numpy`, `__array__` (numpy's conversion), `__bool__`,
    `__int__`, `__float__`, `.cpu()` and `.to` with a CPU target off
    another device, and `torch.cuda.synchronize`.  A torch tensor plays
    the device array's part (as a jax array does on the reference's CPU
    backend); numpy arrays are host values.  A conversion inside another
    (`__array__` calling `.numpy()`) is one.

Patching and the sync debug mode are process-global and not reentrant:
use them around short sections that run on one thread.
"""
from __future__ import annotations

import collections
import contextlib
import sys
import threading
import warnings
from typing import Callable, Iterator

import torch

# the tensor methods that read a value back to the host
_METHODS = ("item", "tolist", "numpy", "__array__", "__bool__", "__int__",
            "__float__")


class TransferCounter:
    """Counts host syncs while installed: `syncs` in all, `sites`
    ("file:line" -> count) and `kinds` (the chokepoint, or "cuda" for a
    sync the debug mode reported)."""

    def __init__(self) -> None:
        self.syncs = 0
        self.sites: collections.Counter = collections.Counter()
        self.kinds: collections.Counter = collections.Counter()

    def add(self, kind: str, site: str) -> None:
        self.syncs += 1
        self.kinds[kind] += 1
        self.sites[site] += 1


def _caller(depth: int = 2) -> str:
    """The first frame outside this module and torch's own Python code."""
    f = sys._getframe(depth)
    while f is not None and (f.f_code.co_filename == __file__
                             or "/torch/" in f.f_code.co_filename):
        f = f.f_back
    return "?" if f is None else f"{f.f_code.co_filename}:{f.f_lineno}"


@contextlib.contextmanager
def _patched(counter: TransferCounter) -> Iterator[None]:
    """The CPU way: patch the chokepoints (see the module docstring)."""
    state = threading.local()

    def counted(kind, fn):
        def wrapper(self, *args, **kwargs):
            outer = not getattr(state, "inside", False)
            if outer:
                counter.add(kind, _caller())
                state.inside = True
            try:
                return fn(self, *args, **kwargs)
            finally:
                if outer:
                    state.inside = False
        return wrapper

    def moving(kind, fn, target):
        def wrapper(self, *args, **kwargs):
            dest = target(args, kwargs)
            if (dest is not None and dest.type == "cpu"
                    and self.device.type != "cpu"):
                return counted(kind, fn)(self, *args, **kwargs)
            return fn(self, *args, **kwargs)
        return wrapper

    def to_target(args, kwargs):
        dest = kwargs.get("device")
        for a in args:
            if isinstance(a, (str, torch.device)):
                dest = a
        return None if dest is None else torch.device(dest)

    saved = {m: getattr(torch.Tensor, m) for m in _METHODS + ("cpu", "to")}
    sync = torch.cuda.synchronize
    try:
        for m in _METHODS:
            setattr(torch.Tensor, m, counted(m, saved[m]))
        torch.Tensor.cpu = moving("cpu", saved["cpu"],
                                  lambda a, k: torch.device("cpu"))
        torch.Tensor.to = moving("to", saved["to"], to_target)

        def counting_sync(*args, **kwargs):
            counter.add("synchronize", _caller())
            return sync(*args, **kwargs)
        torch.cuda.synchronize = counting_sync
        yield
    finally:
        for m, fn in saved.items():
            setattr(torch.Tensor, m, fn)
        torch.cuda.synchronize = sync


@contextlib.contextmanager
def _debug_mode(counter: TransferCounter) -> Iterator[None]:
    """The card's way: every synchronizing CUDA call warns."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    for w in caught:
        if "synchroniz" in str(w.message):
            counter.add("cuda", f"{w.filename}:{w.lineno}")


@contextlib.contextmanager
def count_transfers(device="cpu") -> Iterator[TransferCounter]:
    """Count host syncs in the block: by the sync debug mode on a CUDA
    `device`, by the patched chokepoints elsewhere."""
    counter = TransferCounter()
    way = _debug_mode if torch.device(device).type == "cuda" else _patched
    with way(counter):
        yield counter


def measure_steady_state(fn: Callable[[], object], *, warmups: int = 1,
                         device="cpu") -> TransferCounter:
    """The syncs of `fn()` after `warmups` unmeasured calls: first-use
    costs (the kernels' build and load, the host copy of the collection
    the float64 polish reads) are excluded, as a steady serving workload
    sees them.  On a CUDA device the work in flight is finished first, so
    that only `fn`'s own syncs count."""
    for _ in range(warmups):
        fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    with count_transfers(device) as counter:
        fn()
    return counter
