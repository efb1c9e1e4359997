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

`STATS` counts this process's collective calls and the host seconds
spent inside them (the device work before a call is waited for first,
so the seconds are the exchange's own).
"""
from __future__ import annotations

import pickle
import time
from typing import Tuple

import torch
import torch.distributed as dist

STATS = {"calls": 0, "seconds": 0.0}


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


def smallest(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k least entries along the last axis, ascending,
    the lower index first on ties (`jax.lax.top_k` of the negation)."""
    return torch.argsort(values, dim=-1, stable=True)[..., :k]


def tiled(x: torch.Tensor) -> torch.Tensor:
    """(P, B, m) gathered blocks -> (B, P * m), rank-major along axis 1:
    the reference's `all_gather(..., axis=1, tiled=True)`."""
    return x.permute(1, 0, *range(2, x.dim())).reshape(x.shape[1], -1)


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


def kth_of_union(d2_pools: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) the k-th smallest of the union of gathered (P, B, k) pools."""
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
    cat = [torch.cat([a, b], dim=1) for a, b in zip(acc, new)]
    sel = smallest(cat[0], k)
    return tuple(torch.gather(t, 1, sel) for t in cat)


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
