"""The data, net and space axes: one process a card, global-batch semantics over the ranks.

The counterpart of ``aide_tpu.core.mesh``. Where the JAX package drives
every device of a mesh from one controller and lets GSPMD insert the
collectives, the port runs one process a card (a rank), each holding its
block of each global batch, and calls the collectives itself through
``torch.distributed``: NCCL between cards, gloo between CPU ranks. A JAX
host with k local devices is k processes here.

The ranks form the JAX package's ``[data, net, space]`` mesh (``make_mesh``
reshapes the devices so, the space index minor): with a net axis of K and a
space axis of S (``mesh.extra_axes = (("net", K), ("space", S))``, either
alone) rank r = (d*K + k)*S + s of a job of D*K*S ranks is data shard d,
net k and space shard s. Four kinds of group carry the collectives:

- the data group of (k, s), the ranks of every shard d: the collectives of
  the data axis below (``gather_rows``, ``fetch``, the sharded cache) and,
  without a live space axis, the global BatchNorm and the gradient
  all-reduce;
- the pair group of (d, s), the K nets: ``pair_exchange`` alone. At K = 2
  a dual run's rank holds net k of the co-teaching pair
  (``engine.state.NetRankState``); a single-net run replicates its net
  over the pair;
- the space group of (d, k), the S row shards of one block of images: the
  halo exchange (``halo_rows``), ``gather_h`` / ``fetch_h`` and
  ``space_all_reduce``. A spatial batch holds rows [s*H/S, (s+1)*H/S) of
  each image (``shard_rows``); the models run on them inside
  ``models.blocks.space_partition``;
- the replica group of net k, every (d, s): the global BatchNorm and the
  gradient all-reduce of a spatial step, whose D*S ranks each hold one
  block of the net's activations (``replicas``).

``setup_axes`` makes the groups on every rank after ``init_process_group``,
in one fixed order; without extra axes there are none, and every collective
runs over the whole group as before. A space axis is pure layout, as in the
JAX package: a trainer whose images it cannot split turns it off
(``set_space_live``), and the space ranks then run as replicas on whole
images.

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
the helpers ran since ``reset_collectives``, and ``by_kind`` splits them by
what they carry (halo, bn, gather, grad, pair, cache, space_sum).
"""

from __future__ import annotations

import math
import os
import socket
from typing import Any, Callable, Dict, Sequence

import torch
import torch.distributed as dist

# collectives run (and their payload bytes) since the last reset, in all
# and by kind: {kind: [collectives, bytes]}
collectives = 0
collective_bytes = 0
by_kind: Dict[str, list] = {}

# the extra axes of this process's group (setup_axes): their sizes, the
# data group of this rank's (net, space shard), the pair group of its (data
# shard, space shard), the space group of its (data shard, net) and the
# replica group of its net (None: the whole group, as without extra axes)
_net = 1
_space = 1
_data_group = None
_pair_group = None
_space_group = None
_replica_group = None
# whether a space axis of more than 1 splits the images (set_space_live)
_space_live = True


def reset_collectives() -> None:
    global collectives, collective_bytes
    collectives = 0
    collective_bytes = 0
    by_kind.clear()


def _count(t: torch.Tensor, kind: str) -> None:
    global collectives, collective_bytes
    n = t.numel() * t.element_size()
    collectives += 1
    collective_bytes += n
    tally = by_kind.setdefault(kind, [0, 0])
    tally[0] += 1
    tally[1] += n


# The counted collectives (sum over ranks, in place or into ``out``), over
# ``group``: this rank's data group by default; ``kind`` names what they
# carry in ``by_kind``
def all_gather(out: torch.Tensor, x: torch.Tensor, group=None, kind: str = "gather") -> None:
    _count(out, kind)
    dist.all_gather_into_tensor(out, x, group=_data_group if group is None else group)


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group=None, kind: str = "gather") -> None:
    _count(x, kind)
    dist.reduce_scatter_tensor(out, x, group=_data_group if group is None else group)


def all_reduce(x: torch.Tensor, group=None, kind: str = "gather") -> None:
    _count(x, kind)
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
    return (rank() // space_size()) % net_size()


def space_size() -> int:
    """The space axis's size: 1 without one (or without a group)."""
    return _space if in_group() else 1


def space_rank() -> int:
    """This rank's row shard on the space axis."""
    return rank() % space_size()


def data_size() -> int:
    """Ranks on the data axis: the data shards of a global batch."""
    return world_size() // (net_size() * space_size())


def data_rank() -> int:
    """This rank's data shard."""
    return rank() // (net_size() * space_size())


def setup_axes(net: int, space: int = 1) -> None:
    """Split the process group into the [data, net, space] mesh of a net
    axis of ``net`` and a space axis of ``space``: every rank calls it right
    after ``init_process_group``, with the same sizes, and makes every group
    in the same order (each pair group, each data group, each space group,
    each net's replica group), as ``torch.distributed.new_group`` needs
    (``launch`` and ``init_distributed`` check that the axes divide the
    ranks). Axes of 1 make no group; at space 1 the groups are those of the
    [data, net] mesh."""
    global _net, _space, _data_group, _pair_group, _space_group, _replica_group, _space_live
    world, r = dist.get_world_size(), dist.get_rank()
    _net, _space, _space_live = net, space, True
    _data_group = _pair_group = _space_group = _replica_group = None
    if net == 1 and space == 1:
        return
    data = world // (net * space)
    d0, k0, s0 = r // (net * space), (r // space) % net, r % space

    def ranks(ds, ks, ss):
        return [(d * net + k) * space + s for d in ds for k in ks for s in ss]

    if net > 1:
        for d in range(data):
            for s in range(space):
                group = dist.new_group(ranks([d], range(net), [s]))
                if (d, s) == (d0, s0):
                    _pair_group = group
    for k in range(net):
        for s in range(space):
            group = dist.new_group(ranks(range(data), [k], [s]))
            if (k, s) == (k0, s0):
                _data_group = group
    if space == 1:
        return
    for d in range(data):
        for k in range(net):
            group = dist.new_group(ranks([d], [k], range(space)))
            if (d, k) == (d0, k0):
                _space_group = group
    if net == 1:
        _replica_group = dist.group.WORLD
        return
    for k in range(net):
        group = dist.new_group(ranks(range(data), [k], range(space)))
        if k == k0:
            _replica_group = group


def set_space_live(live: bool) -> None:
    """Whether the space axis splits the images (True after
    ``setup_axes``): a trainer whose images the axis cannot split turns it
    off, and its space ranks run as replicas on whole images."""
    global _space_live
    _space_live = live


def space_shards() -> int:
    """The row shards of a spatial batch: the space axis's size while it is
    live, else 1."""
    return space_size() if _space_live else 1


def replicas(spatial: bool):
    """(group, size) of the ranks that share a net's gradient and BatchNorm
    statistics: the replica group (data x space) of a spatial step, the data
    group otherwise."""
    if spatial and space_shards() > 1:
        return _replica_group, data_size() * space_size()
    return _data_group, data_size()


def _leave() -> None:
    """Destroy the process group and forget its axes."""
    global _net, _space, _data_group, _pair_group, _space_group, _replica_group, _space_live
    dist.destroy_process_group()
    _net, _space, _space_live = 1, 1, True
    _data_group = _pair_group = _space_group = _replica_group = None


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
    if world % extra_devices(mesh_cfg):
        raise ValueError(
            f"mesh.num_processes={world} does not divide into the net axis x space axis of "
            f"mesh.extra_axes={tuple(mesh_cfg.extra_axes)}"
        )
    dist.init_process_group(
        backend_for(device), init_method=f"tcp://{mesh_cfg.coordinator_address}",
        world_size=world, rank=r,
    )
    setup_axes(axis_size(mesh_cfg, "net"), axis_size(mesh_cfg, "space"))


def refuse_axes(mesh_cfg) -> None:
    """Raise for a mesh axis beyond data, net and space, which neither
    package has."""
    asked = [name for name, size in mesh_cfg.extra_axes
             if size > 1 and name not in ("net", "space")]
    if asked:
        raise NotImplementedError(
            f"mesh.extra_axes={tuple(mesh_cfg.extra_axes)}: unknown mesh axis "
            f"{', '.join(map(repr, asked))}; the axes are data, net and space"
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


def h_sharded(b: int) -> bool:
    """Whether a global batch of ``b`` rows splits its images' H over a
    live space axis: it does unless the data axis replicates it (a ragged
    batch never shards spatially, as in the JAX package)."""
    return space_shards() > 1 and (data_size() == 1 or b % data_size() == 0)


def local_h(h: int) -> slice:
    """This rank's rows of an image of H = ``h`` on a live space axis."""
    per = h // space_shards()
    s = space_rank() if space_shards() > 1 else 0
    return slice(s * per, (s + 1) * per)


def shard_h(batch):
    """This rank's H rows (``local_h``) of each image-like leaf (ndim >= 3,
    H divisible by the space axis) of a dict of tensors or arrays; the other
    leaves as they are."""
    k = space_shards()
    return {key: (v[:, local_h(v.shape[1])] if v.ndim >= 3 and v.shape[1] % k == 0 else v)
            for key, v in batch.items()}


def shard_rows(batch):
    """This rank's block of each leaf of a dict of row-major tensors or
    arrays of one global batch: its rows (``local_rows``), and its H rows
    of the image-like leaves when the batch is spatial (``h_sharded``). The
    counterpart of ``shard_batch``."""
    b = next(iter(batch.values())).shape[0]
    rows = local_rows(b)
    out = {k: v[rows] for k, v in batch.items()}
    return shard_h(out) if h_sharded(b) else out


# --------------------------- collectives ---------------------------


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """(b, ...) of any dtype -> its (b, row bytes) uint8 view."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return t.reshape(t.shape[0], -1).view(torch.uint8)


def fetch(*tensors: torch.Tensor, group=None, kind: str = "gather"):
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
    all_gather(out, packed, group, kind)
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
    got = fetch(*(t.detach()[None] for t in tensors), group=_pair_group, kind="pair")
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


# ------------------------- the space axis's collectives -------------------------
#
# Each is one all-gather (or its reduce-scatter backward) over the space
# group, on both backends. All-gathers move bytes, so their tensors travel
# as uint8 views: a bf16 halo under autocast crosses as it is.


def _gather_space(x: torch.Tensor, kind: str) -> torch.Tensor:
    """(k, *x.shape): every space shard's contiguous ``x``, in shard order."""
    x = x.contiguous()
    raw = x.view(torch.uint8) if x.dim() else x.reshape(1).view(torch.uint8)
    out = raw.new_empty((space_size(),) + tuple(raw.shape))
    all_gather(out.view((-1,) + tuple(raw.shape[1:])), raw, _space_group, kind)
    return out.view(x.dtype).view((space_size(),) + tuple(x.shape))


def _with_halo(top: torch.Tensor, x: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """x with the rows ``top`` above and ``bottom`` below it (dim 2), in
    x's memory format (a channels_last map, or a row slice of one, has C
    innermost): the conv or resize that reads it then takes its NHWC
    kernels."""
    fmt = (torch.channels_last if x.stride(1) == 1 or x.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format)
    r, h = top.shape[2], x.shape[2]
    out = torch.empty(x.shape[:2] + (h + 2 * r,) + x.shape[3:], dtype=x.dtype, device=x.device,
                      memory_format=fmt)
    out[:, :, :r] = top
    out[:, :, r:r + h] = x
    out[:, :, r + h:] = bottom
    return out


class _HaloRows(torch.autograd.Function):
    """(B, C, h, W) -> (B, C, h + 2r, W): r rows of each space neighbour
    above and below (dim 2). At the image's top and bottom edge the rows
    are zeros (``edge=False``: a conv's padding) or copies of the edge row
    (``edge=True``: a bilinear resize's clamp). Forward and backward are
    one all-gather each of every shard's 2r edge rows; the backward adds
    each halo's gradient into the rows it was copied from."""

    @staticmethod
    def forward(ctx, x, r, edge):
        h = x.shape[2]
        if r > h:
            raise ValueError(f"a halo of {r} rows is wider than the {h} rows a space shard holds")
        ctx.r, ctx.edge = r, edge
        k, s = space_size(), space_rank()
        got = _gather_space(torch.stack([x[:, :, :r], x[:, :, h - r:]]), "halo")

        def outside(row):
            return row.expand(-1, -1, r, -1) if edge else torch.zeros_like(x[:, :, :r])

        top = got[s - 1, 1] if s > 0 else outside(x[:, :, :1])
        bottom = got[s + 1, 0] if s < k - 1 else outside(x[:, :, h - 1:])
        return _with_halo(top, x, bottom)

    @staticmethod
    def backward(ctx, g):
        r, edge = ctx.r, ctx.edge
        k, s = space_size(), space_rank()
        h = g.shape[2] - 2 * r
        g_top, g_bottom = g[:, :, :r], g[:, :, r + h:]
        gx = g[:, :, r:r + h].clone()
        got = _gather_space(torch.stack([g_top, g_bottom]), "halo")
        if s > 0:
            gx[:, :, :r] += got[s - 1, 1]
        elif edge:
            gx[:, :, :1] += g_top.sum(dim=2, keepdim=True)
        if s < k - 1:
            gx[:, :, h - r:] += got[s + 1, 0]
        elif edge:
            gx[:, :, h - 1:] += g_bottom.sum(dim=2, keepdim=True)
        return gx, None, None


def halo_rows(x: torch.Tensor, r: int, edge: bool = False) -> torch.Tensor:
    """This space shard's (B, C, h, W) rows with r rows of each neighbour
    above and below, differentiable (``_HaloRows``); zeros (or, with
    ``edge``, the edge row) beyond the image. A collective of the space
    group."""
    return _HaloRows.apply(x, r, edge)


class _GatherH(torch.autograd.Function):
    """All-gather of dim ``dim`` over the space group; its backward
    reduce-scatters the gradient, so each shard receives the sum over
    shards of the gradient of its own rows."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((space_size() * xt.shape[0],) + tuple(xt.shape[1:]))
        all_gather(out, xt, _space_group, "gather")
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        gt = g.movedim(ctx.dim, 0).contiguous()
        out = gt.new_empty((gt.shape[0] // space_size(),) + tuple(gt.shape[1:]))
        reduce_scatter(out, gt, _space_group, "gather")
        return out.movedim(0, ctx.dim), None


def gather_h(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole images' rows (dim ``dim``) from every space shard,
    differentiable: with the loss of the whole images divided by the
    shards (``replicas``) on every rank, each rank's backward gives the
    gradient of the loss in its own rows. Identity at space size 1."""
    return x if space_size() == 1 else _GatherH.apply(x, dim)


def fetch_h(*tensors: torch.Tensor, dim: int = 1):
    """The whole images' rows (dim ``dim``) of each tensor from every space
    shard, without gradients: one byte-packed all-gather for all of them
    (``fetch`` over the space group)."""
    got = fetch(*(t.detach().movedim(dim, 0) for t in tensors), group=_space_group)
    got = got if len(tensors) > 1 else (got,)
    out = tuple(t.movedim(0, dim) for t in got)
    return out if len(out) > 1 else out[0]


class _SpaceAllReduce(torch.autograd.Function):
    """Sum over the space group; the backward sums the gradient likewise
    (every shard's output depends on every shard's input)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        all_reduce(y, _space_group, "space_sum")
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce(g, _space_group, "space_sum")
        return g


def space_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the space group, differentiable."""
    return x if space_size() == 1 else _SpaceAllReduce.apply(x)


def all_reduce_grads(params: Sequence[torch.Tensor], spatial: bool = False) -> None:
    """Sum every gradient over the ranks that share the net (``replicas``:
    its data group, or data x space for a ``spatial`` step) through one
    flat f32 buffer: one collective a step, after which every rank of a net
    holds the same gradients and so takes the same optimizer update. A
    no-op over one rank."""
    grads = [p.grad for p in params if p.grad is not None]
    group, n = replicas(spatial)
    if n == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    all_reduce(flat, group, "grad")
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
    any). A net or space axis never falls back to ranks on the CPU or to
    two ranks on one card: too few cards raise."""
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


def _rank_main(local_rank, fn, args, world, axes, port, kind, threads, results):
    """A spawned rank: one torch thread pool share, its card, the group and
    its axes, then ``fn(rank, device, *args)``; its result goes back
    through ``results``."""
    if threads:
        torch.set_num_threads(threads)
    device = _rank_device(kind, local_rank)
    dist.init_process_group(backend_for(device), init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=local_rank)
    try:
        setup_axes(*axes)
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

    Every rank of a net or space axis (``mesh.extra_axes``) makes the
    mesh's groups (``setup_axes``) before ``fn`` runs.
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
            _rank_main, args=(fn, tuple(args), n,
                              (axis_size(cfg.mesh, "net"), axis_size(cfg.mesh, "space")),
                              free_port(), kind, threads, results),
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
