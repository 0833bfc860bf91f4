"""The data and net axes: one process a card, global-batch semantics over the ranks.

The counterpart of ``aide_tpu.core.mesh``. Where the JAX package drives
every device of a mesh from one controller and lets GSPMD insert the
collectives, the port runs one process a card (a rank), each holding its
block of each global batch, and calls the collectives itself through
``torch.distributed``: NCCL between cards, gloo between CPU ranks. A JAX
host with k local devices is k processes here.

The ranks form the JAX package's ``[data, net]`` mesh (``make_mesh``
reshapes the devices so, the net index minor): with a net axis of K
(``mesh.extra_axes = (("net", K),)``) rank r of a job of D*K ranks is data
shard d = r // K and net k = r % K. The data group of net k, {k, K + k,
...}, carries every collective of the data axis below (the global
BatchNorm, ``gather_rows``, ``fetch``, the gradient all-reduce, the sharded
cache); the pair group of shard d, {d*K, ..., d*K + K - 1}, carries
``pair_exchange`` alone. At K = 2 a dual run's rank holds net k of the
co-teaching pair (``engine.state.NetRankState``); a single-net run
replicates its net over the pair. ``setup_axes`` makes the groups on every
rank after ``init_process_group``; without a net axis there are none, and
every collective runs over the whole group as before.

- ``launch(fn, cfg, device)`` starts the ranks: ``mesh.num_devices = N > 1``
  spawns N local processes joined over a free 127.0.0.1 port;
  ``mesh.coordinator_address`` joins this process to a job as rank
  ``mesh.process_id`` of ``mesh.num_processes`` (one per card, on the
  hosts of the job). It shrinks N to the largest count that divides
  gcd(batch_size, eval_batch_size), as the JAX trainer does, and says so.
- ``shard_rows`` / ``local_rows``: rank r of N takes rows [r*B/N,
  (r+1)*B/N) of a global batch of B when N divides B; otherwise every rank
  keeps the whole batch (replicated), as ``shard_batch`` does.
- ``gather_rows`` (an all-gather whose backward is a reduce-scatter)
  carries gradients; ``fetch`` all-gathers rows without them, in one
  collective. The global BatchNorm (``models.blocks``) runs its own.
- ``all_reduce_grads`` sums every gradient through one flat f32 buffer.

Every data-axis helper is a no-op at data size 1, so a single process runs
exactly the single-card code. ``collectives`` and ``collective_bytes`` count what
the helpers ran since ``reset_collectives``.
"""

from __future__ import annotations

import math
import os
import socket
from typing import Any, Callable, Dict, Sequence

import torch
import torch.distributed as dist

# collectives run (and their payload bytes) since the last reset
collectives = 0
collective_bytes = 0

# what the space axis still needs (ROADMAP Queue 1 item 7)
_AXIS_TODO = {
    "space": "the space axis (spatial partitioning of the image rows with halo exchange)",
}

# the net axis of this process's group (setup_axes): its size, the data
# group of this rank's net and the pair group of its data shard (None: the
# whole group, as without a net axis)
_net = 1
_data_group = None
_pair_group = None


def reset_collectives() -> None:
    global collectives, collective_bytes
    collectives = 0
    collective_bytes = 0


def _count(t: torch.Tensor) -> None:
    global collectives, collective_bytes
    collectives += 1
    collective_bytes += t.numel() * t.element_size()


# The counted collectives (sum over ranks, in place or into ``out``), over
# ``group``: this rank's data group by default
def all_gather(out: torch.Tensor, x: torch.Tensor, group=None) -> None:
    _count(out)
    dist.all_gather_into_tensor(out, x, group=_data_group if group is None else group)


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group=None) -> None:
    _count(x)
    dist.reduce_scatter_tensor(out, x, group=_data_group if group is None else group)


def all_reduce(x: torch.Tensor, group=None) -> None:
    _count(x)
    dist.all_reduce(x, group=_data_group if group is None else group)


# ------------------------------- the group -------------------------------


def in_group() -> bool:
    """Whether this process is a rank of a process group (``launch``)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the job: the process group's size, 1 without one."""
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def net_size() -> int:
    """The net axis's size: 1 without one (or without a group)."""
    return _net if in_group() else 1


def net_rank() -> int:
    """This rank's index on the net axis: the net of the pair it holds."""
    return rank() % net_size()


def data_size() -> int:
    """Ranks on the data axis: the data shards of a global batch."""
    return world_size() // net_size()


def data_rank() -> int:
    """This rank's data shard."""
    return rank() // net_size()


def setup_axes(net: int) -> None:
    """Split the process group into the [data, net] mesh of a net axis of
    ``net``: every rank calls it right after ``init_process_group``, with
    the same ``net``, and makes every group in the same order (each pair
    group, then each net's data group), as ``torch.distributed.new_group``
    needs (``launch`` and ``init_distributed`` check that ``net`` divides
    the ranks). A net axis of 1 makes no group."""
    global _net, _data_group, _pair_group
    world, r = dist.get_world_size(), dist.get_rank()
    _net, _data_group, _pair_group = net, None, None
    if net == 1:
        return
    for d in range(world // net):
        group = dist.new_group(list(range(d * net, (d + 1) * net)))
        if r // net == d:
            _pair_group = group
    for k in range(net):
        group = dist.new_group(list(range(k, world, net)))
        if r % net == k:
            _data_group = group


def _leave() -> None:
    """Destroy the process group and forget its axes."""
    global _net, _data_group, _pair_group
    dist.destroy_process_group()
    _net, _data_group, _pair_group = 1, None, None


def is_primary() -> bool:
    """True on the rank that writes the run's files (checkpoints, history,
    logs, tempmasks), as process 0 does in the JAX package; a single
    process is always primary."""
    return rank() == 0


def backend_for(device) -> str:
    """The collectives' backend follows the rank's device: NCCL for a card,
    gloo for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collectives backend for device {device}")


def init_distributed(mesh_cfg, device) -> None:
    """Join this process to the job that ``mesh.coordinator_address``
    (host:port) names, as rank ``mesh.process_id`` of
    ``mesh.num_processes``, over the backend of ``device``. The
    counterpart of ``maybe_initialize_distributed``; a no-op when the group
    exists. Nothing is detected: both numbers must be set."""
    if dist.is_initialized():
        return
    world, r = mesh_cfg.num_processes, mesh_cfg.process_id
    if world < 1 or not 0 <= r < world:
        raise ValueError(
            f"mesh.coordinator_address={mesh_cfg.coordinator_address!r} needs "
            f"mesh.num_processes >= 1 and 0 <= mesh.process_id < num_processes, got "
            f"{world} and {r}"
        )
    net = axis_size(mesh_cfg, "net")
    if world % net:
        raise ValueError(
            f"mesh.num_processes={world} does not divide into the net axis of "
            f"mesh.extra_axes={tuple(mesh_cfg.extra_axes)}"
        )
    dist.init_process_group(
        backend_for(device), init_method=f"tcp://{mesh_cfg.coordinator_address}",
        world_size=world, rank=r,
    )
    setup_axes(net)


def refuse_axes(mesh_cfg) -> None:
    """Raise for the mesh axes beyond data and net that the port does not
    have yet."""
    asked = [(name, size) for name, size in mesh_cfg.extra_axes if size > 1 and name != "net"]
    if asked:
        todo = "; ".join(_AXIS_TODO.get(name, f"an axis {name!r}") for name, _ in asked)
        raise NotImplementedError(
            f"mesh.extra_axes={tuple(mesh_cfg.extra_axes)}: the port shards the data and net "
            f"axes only; not ported yet: {todo} (ROADMAP Queue 1 item 7)"
        )


def axis_size(mesh_cfg, name: str) -> int:
    """The size of the extra axis ``name`` of ``mesh.extra_axes`` (1 when
    absent)."""
    return math.prod(size for axis, size in mesh_cfg.extra_axes if axis == name)


def extra_devices(mesh_cfg) -> int:
    """The devices of one data shard: the product of the extra axes."""
    return math.prod(size for _, size in mesh_cfg.extra_axes)


# ------------------------------ sizes ------------------------------


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def fit_data_devices(batch_size: int, num_available: int) -> int:
    """Largest device count <= num_available that divides the global batch
    (a batch must shard evenly over the data axis)."""
    for d in range(min(batch_size, num_available), 0, -1):
        if batch_size % d == 0:
            return d
    return 1


def data_batch(cfg) -> int:
    """The batch the data axis must divide: gcd(batch_size, eval_batch_size)."""
    return math.gcd(cfg.data.batch_size, cfg.data.eval_batch_size)


def fit_ranks(cfg, n_avail: int) -> int:
    """The ranks a job of ``n_avail`` devices runs, as the JAX trainer sizes
    its mesh: the data axis ``fit_data_devices`` of gcd(batch_size,
    eval_batch_size) over n_avail / extra, times the extra axes' devices.
    Raises when the extra axes do not divide n_avail."""
    extra = extra_devices(cfg.mesh)
    if n_avail % extra:
        raise ValueError(
            f"{n_avail} devices not divisible by mesh.extra_axes {tuple(cfg.mesh.extra_axes)}")
    return fit_data_devices(data_batch(cfg), n_avail // extra) * extra


def shrunk_message(n_avail: int, cfg, n_fit: int) -> str:
    """The JAX trainer's warning when the data axis of ``n_fit`` shards
    (times the extra axes) leaves devices of ``n_avail`` unused."""
    return (
        "MESH SHRUNK: %d devices available but gcd(batch_size=%d, eval_batch_size=%d) only "
        "shards over %d (x%d extra-axis devices) — scale data.batch_size/eval_batch_size to "
        "use the full mesh" % (n_avail, cfg.data.batch_size, cfg.data.eval_batch_size, n_fit,
                               extra_devices(cfg.mesh))
    )


# ------------------------------ rows ------------------------------


def rows_sharded(b: int) -> bool:
    """Whether a global batch of ``b`` rows is split over the data axis (N
    shards divide b) rather than replicated on each."""
    n = data_size()
    return n > 1 and b % n == 0


def local_rows(b: int) -> slice:
    """This rank's rows of a global batch of ``b``: its data shard's
    contiguous block when the batch is sharded, all of them when it is
    replicated. Both ranks of a pair hold the same rows."""
    if not rows_sharded(b):
        return slice(None)
    per = b // data_size()
    d = data_rank()
    return slice(d * per, (d + 1) * per)


def shard_rows(batch):
    """This rank's rows (``local_rows``) of each leaf of a dict of
    row-major tensors or arrays of one global batch: the counterpart of
    ``shard_batch``."""
    b = next(iter(batch.values())).shape[0]
    rows = local_rows(b)
    return {k: v[rows] for k, v in batch.items()}


# --------------------------- collectives ---------------------------


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """(b, ...) of any dtype -> its (b, row bytes) uint8 view."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return t.reshape(t.shape[0], -1).view(torch.uint8)


def fetch(*tensors: torch.Tensor, group=None):
    """All-gather rank-sharded rows over ``group`` (the data group by
    default): every rank gets, for each (b, ...) tensor, the (N*b, ...)
    tensor of all the group's rows in rank order (the global row order).
    One collective for all of them, on their bytes. A collective: every
    rank of the group calls it. Without gradients; over a group of one the
    tensors come back as they are."""
    n = data_size() if group is None else dist.get_world_size(group)
    if n == 1:
        return tensors if len(tensors) > 1 else tensors[0]
    rows = [_as_bytes(t) for t in tensors]
    packed = torch.cat(rows, dim=1)
    out = packed.new_empty((n * packed.shape[0], packed.shape[1]))
    all_gather(out, packed, group)
    got, col = [], 0
    for t, r in zip(tensors, rows):
        chunk = out[:, col : col + r.shape[1]].contiguous()
        col += r.shape[1]
        dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
        got.append(chunk.view(dtype).reshape((n * t.shape[0],) + tuple(t.shape[1:])).to(t.dtype))
    return tuple(got) if len(got) > 1 else got[0]


def pair_exchange(*tensors: torch.Tensor):
    """Each tensor of this rank's net stacked with its partners': a
    (K, ...) tensor a tensor, in net order, over the pair group of a net
    axis of K. One byte-packed all-gather for all of them, without
    gradients (``fetch`` over the pair group); a collective of the pair."""
    if net_size() == 1:
        raise RuntimeError("pair_exchange needs a net axis (mesh.extra_axes net > 1)")
    got = fetch(*(t.detach()[None] for t in tensors), group=_pair_group)
    return got if len(tensors) > 1 else (got,)


class _GatherRows(torch.autograd.Function):
    """All-gather of rows; its backward reduce-scatters the gradient, so
    each rank receives the sum over ranks of the gradient of its own rows."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        out = x.new_empty((data_size() * x.shape[0],) + tuple(x.shape[1:]))
        all_gather(out, x)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // data_size(),) + tuple(g.shape[1:]))
        reduce_scatter(out, g)
        return out


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The (N*b, ...) rows of the data group, differentiable: with the loss
    of the gathered rows divided by N on every rank, each rank's backward
    gives exactly the gradient of the loss in its own rows. Identity at
    data size 1."""
    return x if data_size() == 1 else _GatherRows.apply(x)


def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Sum every gradient over the data group through one flat f32 buffer:
    one collective a step, after which every rank of a net holds the same
    gradients and so takes the same optimizer update. A no-op at data size
    1."""
    grads = [p.grad for p in params if p.grad is not None]
    if data_size() == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    all_reduce(flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset : offset + n].view(g.shape))
        offset += n


# ------------------------------ launch ------------------------------


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a job's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device_kind(device) -> str:
    """The ranks' device type: ``device``'s, the card's by default; a card
    that is not there raises, nothing falls back to the CPU."""
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (the CLI's --device cpu) "
            "to run on the CPU"
        )
    return kind


def _rank_device(kind: str, local_rank: int) -> torch.device:
    if kind != "cuda":
        return torch.device(kind)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device available for a rank on a card")
    dev = torch.device("cuda", local_rank % count)
    torch.cuda.set_device(dev)
    return dev


def resolve_ranks(cfg, device=None) -> int:
    """How many local ranks ``launch`` starts: ``mesh.num_devices`` (0: every
    visible card, one for the CPU), which the extra axes must divide,
    shrunk to ``fit_ranks`` (the trainer logs "MESH SHRUNK" when that drops
    any). A net axis never falls back to ranks on the CPU or to two ranks
    on one card: too few cards raise."""
    kind = _device_kind(device)
    visible = torch.cuda.device_count() if kind == "cuda" else 1
    asked = cfg.mesh.num_devices or visible
    if kind == "cuda" and asked > visible:
        raise ValueError(f"mesh.num_devices={asked} but only {visible} card(s) are visible")
    extra = extra_devices(cfg.mesh)
    if asked % extra:
        where = (f"{visible} card(s) visible, one rank a card" if kind == "cuda"
                 else "CPU ranks: set mesh.num_devices")
        raise ValueError(
            f"mesh.extra_axes={tuple(cfg.mesh.extra_axes)} needs a multiple of {extra} ranks, "
            f"got {asked} (mesh.num_devices={cfg.mesh.num_devices}; {where})")
    return fit_ranks(cfg, asked)


def _rank_main(local_rank, fn, args, world, net, port, kind, threads, results):
    """A spawned rank: one torch thread pool share, its card, the group and
    its axes, then ``fn(rank, device, *args)``; its result goes back
    through ``results``."""
    if threads:
        torch.set_num_threads(threads)
    device = _rank_device(kind, local_rank)
    dist.init_process_group(backend_for(device), init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=local_rank)
    try:
        setup_axes(net)
        results.put((local_rank, fn(local_rank, device, *args)))
    finally:
        _leave()


def launch(fn: Callable, cfg, device=None, args=()) -> Dict[int, Any]:
    """Run ``fn(rank, device, *args)`` on each rank of the data axis that
    ``cfg.mesh`` asks for, one process a card (``device='cpu'``: CPU ranks
    over gloo), and return {rank: fn's result} of the ranks this process
    ran. ``fn`` and ``args`` must pickle (a module-level function).

    - ``mesh.coordinator_address`` set: this process joins that job as rank
      ``mesh.process_id`` of ``mesh.num_processes``, on card process_id
      modulo the visible cards, and runs ``fn`` itself.
    - otherwise ``resolve_ranks`` ranks: one runs ``fn`` in this process
      with no group; N > 1 are spawned processes that join over a free
      127.0.0.1 port. CPU ranks share this process's torch threads
      (OMP_NUM_THREADS too). A rank that fails ends the others and raises
      here.

    Every rank of a net axis (``mesh.extra_axes``) makes the mesh's groups
    (``setup_axes``) before ``fn`` runs.
    """
    import torch.multiprocessing as mp

    refuse_axes(cfg.mesh)
    kind = _device_kind(device)
    if cfg.mesh.coordinator_address:
        dev = _rank_device(kind, max(cfg.mesh.process_id, 0))
        init_distributed(cfg.mesh, dev)
        try:
            return {rank(): fn(rank(), dev, *args)}
        finally:
            _leave()
    n = resolve_ranks(cfg, device)
    if n == 1:
        dev = torch.device(device) if device is not None else torch.device("cuda")
        return {0: fn(0, dev, *args)}
    threads = max(1, torch.get_num_threads() // n) if kind == "cpu" else 0
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    env_before = os.environ.get("OMP_NUM_THREADS")
    if threads:
        os.environ["OMP_NUM_THREADS"] = str(threads)
    try:
        procs = mp.start_processes(
            _rank_main, args=(fn, tuple(args), n, axis_size(cfg.mesh, "net"), free_port(), kind,
                              threads, results),
            nprocs=n, join=False, start_method="spawn",
        )
    finally:
        if threads:
            if env_before is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = env_before
    out: Dict[int, Any] = {}

    def drain():
        while not results.empty():
            r, value = results.get()
            out[r] = value

    # drain while the ranks run: a result larger than the pipe's buffer
    # blocks its rank until it is read
    while not procs.join(timeout=0.5):
        drain()
    drain()
    return out
