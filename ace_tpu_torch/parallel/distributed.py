"""Multi-process execution over ``torch.distributed`` (port of
ace_tpu/parallel/distributed.py).

One process per GPU. ``initialize`` joins the process group when the
launch says there is one, with NCCL for CUDA tensors (gloo when the run is
on the CPU), and makes beside it a gloo group for host tensors, which NCCL
does not carry.
Launch modes, as ``ace_tpu``'s:

- explicit: ``ACE_TPU_COORDINATOR_ADDRESS`` (host:port),
  ``ACE_TPU_NUM_PROCESSES``, ``ACE_TPU_PROCESS_ID`` (and ``LOCAL_RANK``
  for the GPU; by default the process id);
- torchrun: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``;
- SLURM (``srun`` with more than one task): ``SLURM_NTASKS``,
  ``SLURM_PROCID``, ``SLURM_LOCALID``, with ``MASTER_ADDR`` and
  ``MASTER_PORT`` set by the job script (``ace_tpu`` leaves this to JAX's
  cluster detection, which the port has no counterpart of);
- a plain single-process launch: everything here is a no-op.

Every collective of the port goes through this module and is counted by
``parallel/comm_stats.py``. ``BatchPlacement`` gives each rank its rows of
a global batch, gathers the ranks' rows back into the global batch, and
averages gradients over the data axis; ``RowGenerator`` makes a random
draw over a batch the global batch's draw, so that a run's numbers do not
depend on the number of ranks.
"""

import dataclasses
import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from ace_tpu_torch.parallel import comm_stats

logger = logging.getLogger(__name__)

# the largest flat bucket of the gradient mean; a gradient at least this
# large is reduced in place, on its own
BUCKET_BYTES = 256 << 20


@dataclasses.dataclass
class DistributedConfig:
    """Multi-process wiring; ``from_env`` reads it from the launcher's
    variables. ``backend`` is not read from them: None picks NCCL for a
    CUDA run and gloo for a CPU one; a caller that builds the config may
    name gloo for CUDA tensors (two ranks on one GPU, which NCCL
    refuses)."""

    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    local_rank: int | None = None
    backend: str | None = None

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        env = os.environ

        def _int(*names):
            for name in names:
                if env.get(name) is not None:
                    return int(env[name])
            return None

        def _master():
            if env.get("MASTER_ADDR") is None:
                return None
            return f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"

        if env.get("ACE_TPU_COORDINATOR_ADDRESS") is not None:
            pid = _int("ACE_TPU_PROCESS_ID")
            local = _int("LOCAL_RANK", "SLURM_LOCALID")
            return cls(env["ACE_TPU_COORDINATOR_ADDRESS"],
                       _int("ACE_TPU_NUM_PROCESSES"), pid,
                       pid if local is None else local)
        if env.get("RANK") is not None and env.get("WORLD_SIZE") is not None:
            return cls(_master(), _int("WORLD_SIZE"), _int("RANK"),
                       _int("LOCAL_RANK") or 0)
        if _int("SLURM_NTASKS") not in (None, 1):
            if _master() is None:
                raise ValueError(
                    "a SLURM launch of several tasks needs MASTER_ADDR and "
                    "MASTER_PORT (the address of task 0)"
                )
            return cls(_master(), _int("SLURM_NTASKS"), _int("SLURM_PROCID"),
                       _int("SLURM_LOCALID") or 0)
        return cls()

    @property
    def explicit(self) -> bool:
        return self.coordinator_address is not None


@dataclasses.dataclass
class _Group:
    """What ``initialize`` made: the backend of the default group, the
    gloo group for host tensors, and this process's GPU."""

    backend: str
    host_group: object
    local_rank: int


# the process group is process-wide, as torch.distributed's own state is
_GROUP: _Group | None = None


def initialize(config: DistributedConfig | None = None,
               device: str | torch.device | None = None) -> None:
    """Join the process group (idempotent; a plain single-process launch
    is a no-op). ``device`` is the entry's ``--device``: the default (None)
    or a CUDA device runs on ``cuda:{LOCAL_RANK}``, made current before the
    NCCL group is made; ``"cpu"`` runs gloo on the CPU."""
    global _GROUP
    if _GROUP is not None:
        return
    config = DistributedConfig.from_env() if config is None else config
    if not config.explicit:
        return
    on_cuda = device is None or torch.device(device).type == "cuda"
    backend = config.backend or ("nccl" if on_cuda else "gloo")
    local = config.local_rank or 0
    kwargs = {}
    if on_cuda:
        check_visible_device(local)
        torch.cuda.set_device(local)
        if backend == "nccl":
            # eager: the communicator is made here, not inside a loop
            kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        backend, init_method=f"tcp://{config.coordinator_address}",
        world_size=config.num_processes, rank=config.process_id,
        timeout=datetime.timedelta(minutes=10), **kwargs,
    )
    _GROUP = _Group(backend, dist.new_group(backend="gloo"), local)
    logger.info("distributed initialized: process %d/%d (%s), local rank %d",
                dist.get_rank(), dist.get_world_size(), backend, local)


def check_visible_device(local: int) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} is not a visible CUDA device "
            f"({torch.cuda.device_count()} visible)"
        )


def shutdown() -> None:
    global _GROUP
    if _GROUP is not None:
        dist.destroy_process_group()
        _GROUP = None


def local_rank() -> int | None:
    """This process's GPU under an initialized group, else None."""
    return None if _GROUP is None else _GROUP.local_rank


def process_index() -> int:
    return dist.get_rank() if _GROUP is not None else 0


def process_count() -> int:
    return dist.get_world_size() if _GROUP is not None else 1


def is_root() -> bool:
    """True on the process that owns logging, checkpoints and writers."""
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (over the host
    group: it waits for no device)."""
    if _GROUP is not None:
        comm_stats.record("barrier", 0)
        dist.barrier(group=_GROUP.host_group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# no caller in the port until ROADMAP Queue 1 item 5b
def process_allgather(x) -> np.ndarray:
    """Host values of every process, stacked on a new leading axis."""
    x = np.asarray(x)
    if _GROUP is None:
        return x[None]
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(process_count())]
    comm_stats.record("all-gather", _nbytes(t) * len(out))
    dist.all_gather(out, t, group=_GROUP.host_group)
    return torch.stack(out).numpy()


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every process, in place (on the device for CUDA
    tensors)."""
    group = _GROUP.host_group if t.device.type == "cpu" else None
    comm_stats.record("all-reduce", _nbytes(t))
    dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` concatenated along the leading axis, on
    ``t``'s device. NCCL gathers on the device; gloo carries no CUDA
    gather, so there the rows go through the host group."""
    n = process_count()
    out_shape = (t.shape[0] * n, *t.shape[1:])
    comm_stats.record("all-gather", _nbytes(t) * n)
    if t.device.type == "cuda" and _GROUP.backend == "nccl":
        out = torch.empty(out_shape, dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous())
        return out
    host = t.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=_GROUP.host_group)
    return torch.cat(parts).to(t.device)


def _buckets(tensors: list[torch.Tensor], cap: int):
    """Consecutive runs of ``tensors`` of one dtype, each under ``cap``
    bytes; a tensor of ``cap`` bytes or more is a bucket of its own."""
    bucket, size = [], 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype
                       or size + _nbytes(t) > cap):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += _nbytes(t)
    if bucket:
        yield bucket


class RowGenerator(torch.Generator):
    """A ``torch.Generator`` that draws over a whole batch for the global
    batch: ``draw_rows`` draws for every rank's rows (``n_shards`` blocks
    of the local batch, in the global batch's row order) and keeps this
    rank's block (``shard``). Every rank draws the same numbers, so the
    ranks' generators stay in step, and a run on N ranks draws what one
    rank draws at the same global batch."""

    n_shards = 1
    shard = 0


def row_generator(device, seed: int, n_shards: int = 1,
                  shard: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded ``seed``; over more than one shard
    a ``RowGenerator``."""
    if n_shards == 1:
        return torch.Generator(device).manual_seed(seed)
    gen = RowGenerator(device)
    gen.manual_seed(seed)
    gen.n_shards, gen.shard = n_shards, shard
    return gen


def draw_rows(generator, batch: int, draw):
    """``draw(batch)``, a draw whose leading axis holds ``batch`` rows;
    under a ``RowGenerator``, this rank's rows of the global batch's
    draw."""
    n = getattr(generator, "n_shards", 1)
    if n == 1:
        return draw(batch)
    k = generator.shard
    return draw(batch * n)[k * batch:(k + 1) * batch]


def randn_rows(shape, generator, device) -> torch.Tensor:
    """``torch.randn(shape)``, its rows (``shape[0]``) drawn by
    ``draw_rows``."""
    return draw_rows(generator, shape[0], lambda n: torch.randn(
        (n, *shape[1:]), generator=generator, device=device))


def rand_rows(shape, generator, device) -> torch.Tensor:
    """``torch.rand(shape)``, its rows (``shape[0]``) drawn by
    ``draw_rows``."""
    return draw_rows(generator, shape[0], lambda n: torch.rand(
        (n, *shape[1:]), generator=generator, device=device))


class BatchPlacement:
    """A data-parallel mesh's rows (port of
    ace_tpu/parallel/distributed.py:153). Each rank loads and computes on
    one contiguous block of every global batch (``local_rows``), as
    ``ace_tpu``'s process owns one data coordinate; ``gather`` and
    ``fetch`` put the global batch back together, ``mean_`` averages over
    the data axis. Without a process group (one process) the placement
    moves no data between ranks and its reductions are the identity."""

    def __init__(self, mesh, device):
        self.mesh = mesh
        self.device = torch.device(device)
        self.n_data = mesh.n_data
        self.coord = mesh.coord

    @property
    def multiprocess(self) -> bool:
        return process_count() > 1

    @property
    def grouped(self) -> bool:
        """True where the ranks are joined by a process group (even a
        group of one): the reductions then run its collectives."""
        return _GROUP is not None

    def local_rows(self, global_batch: int) -> np.ndarray:
        """Global batch-row indices this process must load."""
        if global_batch % self.n_data != 0:
            raise ValueError(
                f"global batch {global_batch} not divisible by the data "
                f"mesh axis ({self.n_data})"
            )
        per = global_batch // self.n_data
        return np.arange(self.coord * per, (self.coord + 1) * per)

    # no caller in the port until ROADMAP Queue 1 item 5b
    def global_batch_of(self, local_batch: int) -> int:
        return local_batch * self.n_data

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the device, seeded ``seed``, whose batch draws
        are this rank's rows of the global batch's."""
        return row_generator(self.device, seed, self.n_data, self.coord)

    def put(self, v) -> torch.Tensor:
        """A host array of this rank's rows, on the device."""
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        if self.device.type == "cuda" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    # no caller in the port until ROADMAP Queue 1 item 5b
    def put_replicated(self, v) -> torch.Tensor:
        """A host array that every rank holds whole, on the device."""
        return self.put(v)

    def put_global(self, v) -> torch.Tensor:
        """A host array of the whole global batch: this rank's rows of it,
        on the device."""
        v = np.asarray(v)
        return self.put(v[self.local_rows(v.shape[0])])

    def gather(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This rank's rows of each tensor -> the global batch's, on the
        device, on every rank: one gather for the tensors of each dtype
        (their rows side by side)."""
        if not self.multiprocess:
            return dict(tree)
        out = dict.fromkeys(tree)
        by_dtype: dict[torch.dtype, list[str]] = {}
        for k, v in tree.items():
            by_dtype.setdefault(v.dtype, []).append(k)
        for keys in by_dtype.values():
            rows = [tree[k].reshape(tree[k].shape[0], -1) for k in keys]
            whole = all_gather_rows(torch.cat(rows, dim=1))
            parts = whole.split([r.shape[1] for r in rows], dim=1)
            for k, part in zip(keys, parts):
                out[k] = part.reshape(-1, *tree[k].shape[1:])
        return out

    def fetch(self, tree: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """This rank's rows of each tensor -> the global batch's as host
        arrays, on every rank (``multihost_utils.process_allgather`` with
        ``tiled=True`` in ``ace_tpu``)."""
        return {k: v.detach().cpu().numpy()
                for k, v in self.gather(tree).items()}

    def mean_(self, tensors: list[torch.Tensor]) -> None:
        """Average ``tensors`` (the same list on every rank) over the data
        axis, in place: summed in flat buckets of one dtype (a tensor of
        ``BUCKET_BYTES`` or more in place, alone), then divided by the
        number of ranks. Nothing here waits for the device."""
        if not self.grouped:
            return
        n = process_count()
        for bucket in _buckets(tensors, BUCKET_BYTES):
            if len(bucket) == 1 and bucket[0].is_contiguous():
                all_reduce_(bucket[0]).div_(n)
                continue
            flat = torch.cat([t.reshape(-1) for t in bucket])
            all_reduce_(flat).div_(n)
            for t, part in zip(bucket, flat.split([t.numel()
                                                   for t in bucket])):
                t.copy_(part.view_as(t))
