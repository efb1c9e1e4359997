"""The scan's k-best pool merge: the `pool_merge` kernels.

The port's counterpart of `repro/core/executor.py::_pool_merge` (lax.top_k
over [pool | candidates], incumbents first on ties; not a Pallas kernel).
A (B, k) pool (d2, sid, off), sorted ascending by d2 as every merge
leaves it, is merged IN PLACE with a batch of candidates: the new pool is
the stable sort of [pool | candidates] by d2, truncated to k, with the
candidates in position order.  `pool_merge_partials` takes the ED chunk
entry's partials (`fused_gather_ed_chunk`); `pool_merge` a dense,
position-indexed (B, M) row (the DTW branch's DP output).  The kernels are
`csrc/pool_merge.cu`; the plain versions are `ref.pool_merge_partials_ref`
and `ref.pool_merge_ref` (the stable sort), which CPU tensors take.  Each
wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# dense positions a block of the dense entry selects from
DENSE_SLICE = 1024


def _check_pool(what, pool):
    pd2 = pool[0]
    b, k = pd2.shape
    _build.check_tensors(what, pd2.device, (
        ("pool d2", pd2, torch.float32, (b, k)),
        ("pool sid", pool[1], torch.int32, (b, k)),
        ("pool off", pool[2], torch.int32, (b, k))))
    return b, k


def _write(pool, new):
    for t, v in zip(pool, new):
        t.copy_(v)


def pool_merge_partials(pool, part: torch.Tensor) -> None:
    """Merge (4, B, P) int32 partials (d2 as float32 bits, sid, off,
    candidate position; empty entries +inf) into the (B, k) pool, in
    place.  Positions are unique within a query's row."""
    b, k = _check_pool("pool_merge_partials", pool)
    dev = pool[0].device
    if part.dim() != 3:
        raise ValueError("pool_merge_partials: partials must be (4, B, P)")
    _build.check_tensors("pool_merge_partials", dev, (
        ("partials", part, torch.int32, (4, b, part.shape[2])),))
    if dev.type == "cpu":
        _write(pool, ref.pool_merge_partials_ref(pool, part))
        return
    lib = _build.library("pool_merge")
    tmp = torch.empty((3, b, k), dtype=torch.int32, device=dev)
    code = lib.ulisse_pool_merge_partials(
        pool[0].data_ptr(), pool[1].data_ptr(), pool[2].data_ptr(),
        part.data_ptr(), tmp.data_ptr(), b, k, part.shape[2],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "pool_merge_partials")
    pool_merge_partials.launches += 1


pool_merge_partials.launches = 0


def pool_merge(pool, d2: torch.Tensor, sid: torch.Tensor,
               off: torch.Tensor) -> None:
    """Merge dense (B, M) candidates (d2 float32, sid/off int32; position
    = column) into the (B, k) pool, in place: on the card, each slice of
    DENSE_SLICE columns keeps its min(k, DENSE_SLICE) least candidates
    below the pool's k-th, then those partials are merged (one call, two
    kernels)."""
    b, k = _check_pool("pool_merge", pool)
    dev = pool[0].device
    m = d2.shape[-1]
    _build.check_tensors("pool_merge", dev, (
        ("d2", d2, torch.float32, (b, m)),
        ("sid", sid, torch.int32, (b, m)),
        ("off", off, torch.int32, (b, m))))
    if dev.type == "cpu":
        _write(pool, ref.pool_merge_ref(pool, d2, sid, off))
        return
    lib = _build.library("pool_merge")
    n_slices = -(-m // DENSE_SLICE)
    part = torch.empty((4, b, n_slices * min(k, DENSE_SLICE)),
                       dtype=torch.int32, device=dev)
    tmp = torch.empty((3, b, k), dtype=torch.int32, device=dev)
    code = lib.ulisse_pool_merge_dense(
        pool[0].data_ptr(), pool[1].data_ptr(), pool[2].data_ptr(),
        d2.data_ptr(), sid.data_ptr(), off.data_ptr(), part.data_ptr(),
        tmp.data_ptr(), b, k, m, DENSE_SLICE,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "pool_merge")
    pool_merge.launches += 1


pool_merge.launches = 0
