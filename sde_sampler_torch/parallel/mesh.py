"""Data parallelism over `torch.distributed`: one process per rank.

Port of `sde_sampler_tpu/parallel/mesh.py` (`get_mesh`, `shard_batch`,
`replicate` over the 1-D batch axis "dp"). A run of `n_devices = W > 1`
is W processes (`spawn`), one rank each; parameters and optimizer state
are replicated, and a batch of n rows is split into W contiguous row
blocks, rank r holding block r, as the JAX package's `P("dp")` splits it.
Blocks are uneven when n % W != 0: the first n % W ranks hold one row
more (`block`). A block is never empty: fewer rows than ranks raise.

The semantics kept from the JAX package: one seed gives the same global
draws whatever W is. Every rank holds the same generator state and draws
each random tensor at the global shape, then keeps its rows (`Rows.take`),
so sharding changes only the order of reductions.

The backend follows from where the ranks sit: NCCL when every rank has a
card of its own, gloo when ranks share a card (NCCL refuses two ranks on
one device) or run on the CPU. Under gloo the collectives copy card
tensors to the host and back on every call; under NCCL they stay on the
card.

The ranks meet through a `FileStore` in the job's directory (or a
temporary one), so two jobs of one process-pool multirun, or two test
workers, never meet on a shared TCP port. Nothing here imports JAX.
"""
from __future__ import annotations

import logging
import os
import tempfile
import uuid
from pathlib import Path

import torch
import torch.distributed as dist

BATCH_AXIS = "dp"

# the device of this process's rank, set by `_rank_entry`
_RANK_DEVICE: str | None = None


def backend_for(device: str, world: int) -> str:
    """NCCL when each of the `world` ranks has a card of its own, else
    gloo (ranks sharing a card, or on the CPU)."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device: str) -> str:
    """Rank r's device: cuda:(r % cards) on the card, else the CPU."""
    if torch.device(device).type == "cuda":
        return f"cuda:{rank % torch.cuda.device_count()}"
    return "cpu"


def get_group(n_devices: int | None):
    """The process group of an `n_devices`-rank run: None for one device
    (as `get_mesh`), the default group for more. Raises unless a group of
    exactly that many ranks is up: a run never takes fewer devices than it
    asked for."""
    n = int(n_devices or 1)
    if n <= 1:
        return None
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"n_devices={n} needs a process group of {n} ranks, and none is up: "
            f"start the run through `python -m sde_sampler_torch.main ... n_devices={n}` "
            "(which spawns the ranks) or `sde_sampler_torch.parallel.mesh.spawn`"
        )
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"n_devices={n}, but the process group has {dist.get_world_size()} ranks"
        )
    return dist.group.WORLD


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def block(n: int, r: int, w: int) -> tuple[int, int]:
    """Rows [start, stop) of rank r's block of n rows over w ranks."""
    if w > 1 and n < w:
        raise ValueError(f"a batch of {n} rows cannot be split over {w} ranks")
    q, rem = divmod(n, w)
    start = r * q + min(r, rem)
    return start, start + q + (r < rem)


def block_sizes(n: int, w: int) -> list[int]:
    return [stop - start for start, stop in (block(n, r, w) for r in range(w))]


class Rows:
    """This rank's rows of a global batch of n samples repeated `repeat`
    times (copy j of sample i at row j·n + i, as the losses' `_repeat_traj`
    lays them out): the rank's block of samples, with all their copies."""

    def __init__(self, n: int, group, repeat: int = 1):
        self.n, self.repeat, self.group = n, repeat, group
        self.start, self.stop = block(n, rank(group), world(group))
        self.total = n * repeat  # rows of the repeated global batch

    def take(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of `t`, whose axis `dim` is the repeated global
        batch (a view)."""
        dim = dim % t.dim()
        length = self.stop - self.start
        if self.repeat == 1:
            return t.narrow(dim, self.start, length)
        t = t.unflatten(dim, (self.repeat, self.n)).narrow(dim + 1, self.start, length)
        return t.flatten(dim, dim + 1)


def shard_batch(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's row block of x along `dim` (x itself without a group)."""
    if group is None:
        return x
    return Rows(x.shape[dim], group).take(x, dim)


def _host(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective takes: a host copy of a card tensor under
    gloo, else t."""
    if t.device.type == "cuda" and dist.get_backend(group) == dist.Backend.GLOO:
        return t.detach().cpu()
    return t


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum or max of t over the ranks, a new tensor on t's device (t
    itself without a group). The same bits on every rank."""
    if group is None:
        return t
    buf = _host(t.detach(), group).clone()
    dist.all_reduce(buf, {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return buf.to(t.device)


def all_gather_rows(x: torch.Tensor, group, sizes: list[int], dim: int = 0) -> torch.Tensor:
    """The ranks' row blocks of x along `dim`, whose lengths are `sizes`
    (`block_sizes`), concatenated in rank order: each block is padded to
    the largest, gathered, and trimmed (x itself without a group)."""
    if group is None:
        return x
    width = max(sizes)
    src = _host(x.detach(), group)
    pad = list(src.shape)
    pad[dim] = width - src.shape[dim]
    if pad[dim]:
        src = torch.cat([src, src.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(src.contiguous()) for _ in sizes]
    dist.all_gather(parts, src.contiguous(), group=group)
    out = torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)
    return out.to(x.device)


def replicate(tensors, group) -> None:
    """Broadcast each tensor from rank 0, in place (`replicate` of the JAX
    package puts the replicated state on every device)."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        data = t.detach()
        buf = _host(data, group)
        dist.broadcast(buf, src, group=group)
        if buf is not data:
            data.copy_(buf)


def broadcast_object(obj, group):
    """Rank 0's `obj` on every rank."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def sync_generator(generator: torch.Generator, group) -> None:
    """Set every rank's generator to rank 0's state, after rank 0 alone
    drew from it (the plots)."""
    if group is not None:
        generator.set_state(broadcast_object(generator.get_state(), group))


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)


def describe(group) -> str:
    """The batch axis, the backend and the rank → device map of a group."""
    devices = [None] * world(group)
    dist.all_gather_object(devices, _RANK_DEVICE, group=group)
    return (f"batch axis {BATCH_AXIS!r} over {world(group)} ranks, {dist.get_backend(group)}; "
            "rank -> device: "
            + ", ".join(f"{r}: {d}" for r, d in enumerate(devices)))


def _rank_entry(r: int, fn, w: int, device: str, store: str, out: str, args: tuple) -> None:
    """One spawned rank: its device, the group over the file store, fn,
    and its result written for the parent."""
    global _RANK_DEVICE
    _RANK_DEVICE = rank_device(r, device)
    if _RANK_DEVICE == "cpu":
        torch.set_num_threads(1)  # W ranks share the host's cores
    else:
        torch.cuda.set_device(torch.device(_RANK_DEVICE))
    backend = backend_for(device, w)
    dist.init_process_group(backend, store=dist.FileStore(store, w), rank=r, world_size=w)
    try:
        result = fn(r, *args)
        torch.save(result, f"{out}.{r}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, n_devices: int, device: str = "cuda", args: tuple = (),
          store_dir: str | os.PathLike | None = None) -> list:
    """Run fn(rank, *args) in `n_devices` spawned processes, each a rank of
    one group on its device (`rank_device`; "cpu" puts every rank on the
    CPU, one thread each), and return the ranks' results in rank order. fn
    must be importable by its module path from a module that imports no
    JAX: the children import it. A rank that fails stops the others and
    raises here."""
    w = int(n_devices)
    if w < 2:
        raise ValueError(f"spawn needs two ranks or more, got n_devices={n_devices}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("No CUDA device is available for the ranks: pass device=cpu.")
    with tempfile.TemporaryDirectory(dir=store_dir, prefix=".dist_") as tmp:
        store = str(Path(tmp) / f"store_{uuid.uuid4().hex}")
        out = str(Path(tmp) / "result")
        logging.info("Spawning %d ranks on %s (%s).", w, device, backend_for(device, w))
        torch.multiprocessing.start_processes(
            _rank_entry, args=(fn, w, str(device), store, out, tuple(args)), nprocs=w,
            join=True, start_method="spawn")
        return [torch.load(f"{out}.{r}", weights_only=False) for r in range(w)]
