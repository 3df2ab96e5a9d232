"""Data parallelism over processes: training on several cards and striped
screening.

The counterpart of ``diffphore_tpu.parallel.mesh``.  DiffPhore's models are a
few M parameters with graphs of at most ~100 nodes, so the scale axis is
throughput (poses x complexes), not model size.  Here:

  * one process per card and one ``torch.distributed`` process group (NCCL
    between cards, gloo on the CPU or when asked); ``cli.train`` spawns the
    processes itself (:func:`launch`) or ``torchrun`` does;
  * parameters and optimizer state are replicated: every rank starts from
    the same weights and applies the same summed gradients;
  * the global batch is sharded along its rows: rank r of N takes rows
    [r B / N, (r + 1) B / N) (:func:`shard_rows`).  Noise and dropout masks
    are drawn for the global batch and then sliced, so N ranks compute what
    one process computes on the whole batch;
  * the collectives that XLA inserts into the JAX package's sharded step are
    explicit here, where a shard is not the whole: the batch norms'
    statistics, the loss's denominators, the gradient sum, the finite flag
    and the metrics (:class:`DataShard`).  ``train.state.make_train_step``,
    ``make_eval_step`` and ``train.ccsampler.make_ccsampler_train_step`` take
    a ``shard``: the steps they make with one take the place of the JAX
    package's ``shard_train_step`` and ``shard_eval_step``;
  * screens stripe the records over processes (:func:`shard_records`) and
    merge the per-rank journals on the host.

Tensor, pipeline and expert parallelism are absent on purpose: there is no
dimension to shard.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

#: how long a rank waits in a collective for the others, as long as rank 0
#: may spend alone on validation by inference or a checkpoint
TIMEOUT = datetime.timedelta(hours=2)


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This process's share of a data-parallel step: rank ``rank`` of
    ``world`` in ``group`` (None: the default group)."""

    rank: int
    world: int
    group: Optional[object] = None

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.world:
            raise ValueError(f"a batch of {n} rows does not split over {self.world} ranks")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, with autograd through the sum (the
        in-place ``dist.all_reduce`` would cut the gradient to the other
        ranks' rows); ``x`` itself on one rank, so that the autograd graph
        (and the order in which the backward adds gradients) stays that of
        one process."""
        return x if self.world == 1 else dist_nn.all_reduce(x, group=self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of every rank in rank order, ``x`` holding this rank's.
        A sum of zero-padded copies: gloo gathers no CUDA tensors."""
        out = x.new_zeros((x.shape[0] * self.world,) + tuple(x.shape[1:]))
        out[self.rows(out.shape[0])] = x
        dist.all_reduce(out, group=self.group)
        return out

    def sum_gradients(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each gradient summed over the ranks, in one collective."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        return [piece.view_as(g) for piece, g in zip(flat.split([g.numel() for g in grads]),
                                                      grads)]


def shard_rows(batch, rank: int, count: int):
    """Rows [rank B / count, (rank + 1) B / count) of a ``ComplexBatch``."""
    sl = DataShard(rank, count).rows(batch.batch_size)
    return batch.replace(names=tuple(batch.names)[sl], meta=tuple(batch.meta)[sl],
                         **{k: v[sl] for k, v in batch.tensors().items()})


def shard_records(records, process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """Striped screening: the work list of process ``process_index`` of
    ``process_count`` (this process's rank and the world size by default)."""
    pi = rank() if process_index is None else process_index
    pc = world() if process_count is None else process_count
    return records[pi::pc]


def world() -> int:
    """The number of ranks in the default process group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def launched() -> Tuple[int, int]:
    """(``RANK``, ``WORLD_SIZE``) of the ``torchrun`` environment, (0, 1)
    outside one."""
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))


def init_process_group(device: Optional[str] = None,
                       backend: Optional[str] = None) -> Tuple[DataShard, torch.device]:
    """Join the process group that the ``torchrun`` environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL when ``device`` is a card, gloo on the CPU or when
    ``backend`` says so.  Returns this process's shard and device (on cards
    ``cuda:LOCAL_RANK``)."""
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", local if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=size, timeout=TIMEOUT, **kw)
    return DataShard(rank, size), dev


def destroy_process_group() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn: Callable, world_size: int, port: int, args: tuple) -> None:
    if "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(1)       # torchrun's default: ranks share the host's cores
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    fn(*args)


def launch(fn: Callable, world_size: int, *args) -> None:
    """``fn(*args)`` in ``world_size`` spawn processes, one rank each, with
    the environment ``torchrun`` gives a rank (and, as it does, one host
    thread unless ``OMP_NUM_THREADS`` says otherwise).  Raises when a rank
    fails, after stopping the others."""
    torch.multiprocessing.start_processes(_rank_entry, (fn, world_size, free_port(), args),
                                          nprocs=world_size, join=True, start_method="spawn")
