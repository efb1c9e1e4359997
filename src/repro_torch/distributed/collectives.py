"""Collectives of the sharded search over a `torch.distributed` process
group: the search half of the JAX package's
`repro/distributed/collectives.py`.

The JAX package runs these inside `shard_map`, one program over a mesh.
Here every rank is a process (SPMD): each calls the same function with
its own shard's tensors and gets the same result as every other rank.

Transport follows the group's backend, read with `dist.get_backend`:
under NCCL (one GPU a rank) device tensors go on the wire as they are;
under any other backend (gloo) a CUDA tensor is copied to the host
first, explicitly, and the result copied back to its device.  The
exchanged tensors are small (a (B, k) pool, a (B,) flag or bound), and
every caller reads the result on the host right away, so the copy sits
where the scan syncs anyway.

Tie order is the JAX package's: `jax.lax.top_k` keeps the lower index
on ties, and so does the stable ascending sort used here.
`ring_topk_merge` returns what the reference's replicated output reads:
shard 0's ring accumulation (its own pool, then shard P - 1's, P - 2's,
..., 1's), replayed locally from one all-gather instead of P - 1
point-to-point rounds, with the same bits.

Beside the search's collectives: `agree` (every rank's success flag,
one all-reduce: the distributed save's commit protocol), and
`broadcast_object` / `all_gather_object` (pickled Python objects: the
server's engine ops from its leader, the save's shard tables).

The training half: `ef_int8_allreduce` (the mean over the group of
int8-quantized values with a per-rank scale and error feedback),
`make_compressed_grad_transform` (it over every tensor of a gradient
pytree) and `ring_allgather_matmul` (all_gather(x) @ w as a ring of
point-to-point steps, each block's product overlapping the next block's
transfer).  They are the reference's `collectives.py:112-186`; no search
path uses them.

`STATS` counts this process's collective calls and the host seconds
spent inside them (the device work before a call is waited for first,
so the seconds are the exchange's own).
"""
from __future__ import annotations

import pickle
import time
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

STATS = {"calls": 0, "seconds": 0.0, "syncs": 0}


def world(group=None) -> Tuple[int, int]:
    """(world size, this rank) of `group` (None: the default group);
    raises unless a process group is initialized and `group` is one."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a distributed engine needs an initialized torch.distributed "
            "process group: call dist.init_process_group(...) on every "
            "rank first")
    if group is not None and not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"expected a torch.distributed process group, got "
                        f"{type(group).__name__}")
    return dist.get_world_size(group), dist.get_rank(group)


def _on_wire(t: torch.Tensor, group) -> torch.Tensor:
    """`t` as the group's backend takes it: as it is under NCCL, on the
    host otherwise; contiguous either way."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        if t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()
        return t.contiguous()
    return t.detach().to("cpu").contiguous()


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(P, *t.shape): every rank's `t`, in rank order, on t's device."""
    size, _ = world(group)
    src = _on_wire(t, group)
    out = [torch.empty_like(src) for _ in range(size)]
    t0 = time.perf_counter()
    dist.all_gather(out, src, group=group)
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    return torch.stack(out).to(t.device)


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """A reduced copy of `t` (op over every rank's), on t's device."""
    src = _on_wire(t, group).clone()
    t0 = time.perf_counter()
    dist.all_reduce(src, op=op, group=group)
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    return src.to(t.device)


def _wire_device(group, device=None) -> torch.device:
    """Where a collective's own tensors live: `device` (default the
    current CUDA device) under NCCL, the host otherwise."""
    if dist.get_backend(group) != dist.Backend.NCCL:
        return torch.device("cpu")
    if device is not None and torch.device(device).type == "cuda":
        return torch.device(device)
    return torch.device("cuda", torch.cuda.current_device())


def agree(ok: bool, group=None, device=None) -> bool:
    """True when `ok` holds on every rank: one all-reduce (MIN) of every
    rank's flag.  Every rank calls it at the same point, so it is also a
    barrier."""
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32,
                        device=_wire_device(group, device))
    return bool(all_reduce(flag, dist.ReduceOp.MIN, group).item())


def broadcast_object(obj=None, src: int = 0, group=None, device=None):
    """`src`'s picklable `obj`, on every rank (the others pass anything):
    its pickle's length, then its bytes, in two broadcasts.  Under NCCL
    the bytes ride a tensor on `device` (default the current CUDA
    device), otherwise the host."""
    dev = _wire_device(group, device)
    mine = dist.get_rank(group) == src
    data = pickle.dumps(obj) if mine else b""
    size = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    root = dist.get_global_rank(group, src) if group is not None else src
    t0 = time.perf_counter()
    dist.broadcast(size, root, group=group)
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
           if mine else torch.empty(int(size.item()), dtype=torch.uint8,
                                    device=dev))
    dist.broadcast(buf, root, group=group)
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 2
    return obj if mine else pickle.loads(buf.cpu().numpy().tobytes())


def all_gather_object(obj, group=None, device=None) -> list:
    """Every rank's picklable `obj`, in rank order (`all_gather_rows` of
    their pickles)."""
    dev = _wire_device(group, device)
    data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                            dtype=torch.uint8).to(dev)
    return [pickle.loads(x.cpu().numpy().tobytes())
            for x in all_gather_rows(data, group)]


def all_gather_rows(rows: torch.Tensor, group=None) -> list:
    """Every rank's (m_r, c) rows, m_r differing by rank: a list in rank
    order (one all-gather of the counts, one of the rows padded to the
    largest)."""
    m = torch.tensor([rows.shape[0]], dtype=torch.int64, device=rows.device)
    counts = all_gather(m, group).reshape(-1).tolist()
    top = max(counts)
    if top == 0:
        return [rows[:0] for _ in counts]
    padded = rows.new_zeros((top,) + tuple(rows.shape[1:]))
    padded[:rows.shape[0]] = rows
    allr = all_gather(padded, group)
    return [allr[r, :c] for r, c in enumerate(counts)]


def all_gather_host(x, group=None, device=None) -> np.ndarray:
    """(P, *x.shape): every rank's `x` (a tensor or a numpy array), in
    rank order, as a numpy array on the host: a sharded scan's exchange
    whose result the host reads.  Its host syncs are counted in
    STATS["syncs"]: under NCCL the wait for a device `x` (as `_on_wire`)
    and the gathered values' copy back; under gloo the copy of a device
    `x` to the host, or, where the engine's `device` is the CPU, the
    conversion of the gathered values (the CPU engine's readback; a card
    engine's host values cost no sync under gloo)."""
    size, _ = world(group)
    on_dev = isinstance(x, torch.Tensor) and x.device.type == "cuda"
    t0 = time.perf_counter()
    if dist.get_backend(group) == dist.Backend.NCCL:
        if on_dev:
            src = _on_wire(x, group)
            STATS["syncs"] += 1
        else:                           # a non-blocking upload: no sync
            src = (x.detach() if isinstance(x, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(x)))
            src = src.contiguous().to(_wire_device(group, device),
                                      non_blocking=True)
        out = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(out, src, group=group)
        host = torch.stack(out).cpu()
        STATS["syncs"] += 1
    else:
        if on_dev:
            STATS["syncs"] += 1
            src = x.detach().cpu().contiguous()
        elif isinstance(x, torch.Tensor):
            src = x.detach().contiguous()
        else:
            src = torch.from_numpy(np.ascontiguousarray(x))
        out = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(out, src, group=group)
        host = torch.stack(out)
        if device is not None and torch.device(device).type == "cpu":
            STATS["syncs"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    return host.numpy()


def all_gather_rows_host(rows: np.ndarray, group=None, device=None) -> list:
    """`all_gather_rows` of host (m_r, c) rows through `all_gather_host`
    (two exchanges: the counts, then the rows padded to the largest)."""
    counts = all_gather_host(np.array([len(rows)], np.int64), group,
                             device).reshape(-1)
    top = int(counts.max())
    if top == 0:
        return [rows[:0] for _ in counts]
    padded = np.zeros((top,) + rows.shape[1:], rows.dtype)
    padded[:len(rows)] = rows
    allr = all_gather_host(padded, group, device)
    return [allr[r, :c] for r, c in enumerate(counts)]


def smallest(values, k: int):
    """Indices of the k least entries along the last axis, ascending,
    the lower index first on ties (`jax.lax.top_k` of the negation); a
    tensor or a numpy array."""
    if isinstance(values, np.ndarray):
        return np.argsort(values, axis=-1, kind="stable")[..., :k]
    return torch.argsort(values, dim=-1, stable=True)[..., :k]


def tiled(x):
    """(P, B, m) gathered blocks -> (B, P * m), rank-major along axis 1:
    the reference's `all_gather(..., axis=1, tiled=True)`."""
    if isinstance(x, np.ndarray):
        return np.moveaxis(x, 0, 1).reshape(x.shape[1], -1)
    return x.permute(1, 0, *range(2, x.dim())).reshape(x.shape[1], -1)


def _take(x, idx):
    """x's entries at idx along axis 1 (a tensor or a numpy array)."""
    if isinstance(x, np.ndarray):
        return np.take_along_axis(x, idx, axis=1)
    return torch.gather(x, 1, idx)


def _cat(a, b):
    if isinstance(a, np.ndarray):
        return np.concatenate([a, b], axis=1)
    return torch.cat([a, b], dim=1)


def topk_merge(dists: torch.Tensor, ids: torch.Tensor, k: int,
               group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global k smallest (dist, id) of every rank's (k,) candidates."""
    all_d = all_gather(dists, group).reshape(-1)
    all_i = all_gather(ids, group).reshape(-1)
    sel = smallest(all_d, k)
    return all_d[sel], all_i[sel]


def bsf_allreduce(bsf: torch.Tensor, group=None) -> torch.Tensor:
    """The best-so-far's min over the group."""
    return all_reduce(bsf, dist.ReduceOp.MIN, group)


def kth_of_union(d2_pools, k: int):
    """(B,) the k-th smallest of the union of gathered (P, B, k) pools (a
    tensor or a numpy array)."""
    if isinstance(d2_pools, np.ndarray):
        return np.ascontiguousarray(np.sort(tiled(d2_pools), axis=1)[:, k - 1])
    return torch.sort(tiled(d2_pools), dim=1).values[:, k - 1].contiguous()


def global_kth(d2_pool: torch.Tensor, k: int, group=None) -> torch.Tensor:
    """The sharded scan's shared squared bsf: the k-th smallest d2 in the
    union of every rank's (B, k) pool (disjoint candidate sets, so the
    union has no duplicates and its k-th bounds the global k-NN radius)."""
    return kth_of_union(all_gather(d2_pool, group), k)


def allgather_topk_merge(d2, sid, off, k: int, group=None):
    """The global (B, k) pool of disjoint per-rank pools: all-gather and
    re-select, rank-major candidates, the lower position first on ties."""
    alld, alls, allo = (tiled(all_gather(t, group)) for t in (d2, sid, off))
    sel = smallest(alld, k)
    return tuple(torch.gather(t, 1, sel) for t in (alld, alls, allo))


def merge_pools(acc, new, k: int):
    """One ring step's merge: the k least of [acc | new] by their first
    member (d2), acc's entries first on ties.  Every member is (B, m)."""
    cat = [_cat(a, b) for a, b in zip(acc, new)]
    sel = smallest(cat[0], k)
    return tuple(_take(t, sel) for t in cat)


def ring_order_merge(pools, k: int):
    """Replay shard 0's ring accumulation over gathered pools: `pools` is
    a tuple of (P, B, k) members (d2 first); the result, a tuple of (B,
    k), merges shard 0's pool with shard P - 1's, then P - 2's, ..., 1's."""
    acc = tuple(t[0] for t in pools)
    for s in range(pools[0].shape[0] - 1, 0, -1):
        acc = merge_pools(acc, tuple(t[s] for t in pools), k)
    return acc


def ring_topk_merge(d2, sid, off, k: int, group=None):
    """The exact global top-k of disjoint per-rank (B, k) pools, as the
    reference's ppermute ring leaves it on shard 0 (its replicated
    output): one all-gather, then `ring_order_merge`."""
    return ring_order_merge(tuple(all_gather(t, group)
                                  for t in (d2, sid, off)), k)


# -- the training collectives -------------------------------------------------

def int8_quantize(y: torch.Tensor):
    """(codes, scale): y's symmetric int8 codes, round(y / scale) clipped
    to [-127, 127] (ties to even), with scale = max(max|y|, 1e-8) / 127
    (float32), the reference's quantizer."""
    scale = torch.clamp(y.abs().max(), min=1e-8) / 127.0
    codes = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return codes, scale


def ef_int8_allreduce(x: torch.Tensor, err: torch.Tensor, group=None):
    """All-reduce (mean) of x with int8 quantization and error feedback:
    y = x + err is quantized with this rank's scale (`int8_quantize`),
    the residual y - codes * scale is the new error (carried to the next
    step, EF-SGD), and the group's mean of the dequantized values (scales
    differ by rank, so the dequantized values are what is summed) is the
    result.  Returns (mean float32, new error), both on x's device."""
    y = x + err
    codes, scale = int8_quantize(y)
    deq = codes.to(torch.float32) * scale
    size, _ = world(group)
    return all_reduce(deq, dist.ReduceOp.SUM, group) / float(size), y - deq


def _leaves(tree, fn):
    """`tree` (dicts, lists and tuples of tensors) with fn on every
    tensor, its structure kept."""
    if isinstance(tree, dict):
        return {k: _leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_leaves(v, fn) for v in tree]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree)


def make_compressed_grad_transform(mesh_or_group=None, axes=("data",)):
    """The gradient hook of a data-parallel step: maps a pytree of
    tensors (dicts, lists, tuples) through `ef_int8_allreduce` with a
    zero error over the ranks of the first of `axes` (a DeviceMesh's dim
    group; a process group, or None for the default one, as it is).  The
    error state is the caller's, as in the reference."""
    from torch.distributed.device_mesh import DeviceMesh
    group = (mesh_or_group.get_group(axes[0])
             if isinstance(mesh_or_group, DeviceMesh) else mesh_or_group)

    def transform(grads):
        return _leaves(grads, lambda g: ef_int8_allreduce(
            g, torch.zeros_like(g), group)[0])

    return transform


def ring_allgather_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                          group=None) -> torch.Tensor:
    """y = all_gather(x) @ w as a ring: x_shard (m, k) is this rank's
    block of an (m P, k) matrix (rank order), w (k, n) the same on every
    rank.  P steps: each multiplies the block it holds into its rows of
    y while the block moves one rank down the ring (rank r sends to r -
    1 and receives from r + 1, one `dist.batch_isend_irecv` a step), so
    at step i rank r holds block (r + i) mod P.  Returns the full (m P,
    n) product on every rank, on x_shard's device."""
    size, rank = world(group)
    m = x_shard.shape[0]
    out = x_shard.new_zeros((m * size, w.shape[1]))
    nccl = dist.get_backend(group) == dist.Backend.NCCL
    block = x_shard.contiguous()

    def peer(r):
        r %= size
        return r if group is None else dist.get_global_rank(group, r)

    for i in range(size):
        reqs, recv = [], None
        if i < size - 1:
            wire = _on_wire(block, group)
            recv = torch.empty_like(wire)
            t0 = time.perf_counter()
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, wire, peer(rank - 1), group),
                dist.P2POp(dist.irecv, recv, peer(rank + 1), group)])
            STATS["seconds"] += time.perf_counter() - t0
            STATS["calls"] += 1
        at = (rank + i) % size * m
        out[at:at + m] = block @ w          # overlaps the transfer
        if reqs:
            t0 = time.perf_counter()
            for req in reqs:
                req.wait()
            STATS["seconds"] += time.perf_counter() - t0
            block = recv if nccl else recv.to(x_shard.device)
    return out
