"""Rank-side programs of the data, net and space axes' parity checks.

Each runs on every rank of a job and returns NumPy results that the
caller holds to one process (or to the JAX package) on the same inputs:

- ``unit_checks(rank, device, inputs)``, started by ``mesh.launch``:
  ``"layout"``, the rank's place on the [data, net] mesh and its groups'
  members; ``"bn"``, a train-mode ``BatchNorm`` forward and backward on the
  rank's rows with the global statistics; ``"step"`` (and ``"step_clip"``,
  another config), one co-teaching step on the rank's rows and view
  columns, of the pair or, on a net axis, of the rank's net; ``"cache"``,
  ``ShardedCache`` gathers (sharded and replicated) and a label scatter,
  and ``fetch`` of mixed dtypes; ``"init"``, the nets ``Trainer``
  initialises from a seed; ``"trainer"``, the state a ``Trainer`` builds
  on the rank (its initialisation, or a warm start from an export);
  ``"primitives"``, the space axis's halo exchange, ``gather_h`` and
  ``space_all_reduce`` on the rank's rows of given images, forward and
  gradient; ``"layers"`` and ``"models"``, layers and nets of the registry
  under ``space_partition`` on the rank's block (data rows, space rows),
  forward and backward, the parameter gradients summed over the replica
  group; ``"supervised"``, one supervised step on the rank's block;
  ``"augment"``, ``data.augment_main``'s warp of the rank's block;
  ``"sizing"``, the log lines and the live space axis of Trainers built
  from given configs.
- ``train_job(rank, device, inputs, workdir)``, started by ``mesh.launch``,
  and ``python -m aide_tpu_torch.core.rank_checks --coordinator HOST:PORT
  --num-processes N --process-id R [--net K] --inputs FILE --workdir DIR``:
  one rank of a job that runs ``Trainer.run`` on the synthetic task from
  given weights and view parameters (``--inputs``, written by the caller
  with ``numpy.savez`` and a JSON config), and writes its history, working
  labels, final state and the files it wrote to ``DIR/result.json`` and
  ``DIR/state.npz`` (``DIR/rank{R}`` under ``train_job``).

Each process uses one torch thread: several ranks share one host's cores.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from aide_tpu_torch.core import mesh
from aide_tpu_torch.core.config import TrainConfig


def _np(sd) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _bn_check(inp, device) -> Dict[str, np.ndarray]:
    from aide_tpu_torch.models.blocks import BatchNorm, global_batch_stats

    x_all, g_all = inp["x"], inp["g"]
    rows = mesh.local_rows(x_all.shape[0])
    bn = BatchNorm(x_all.shape[1]).to(device)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(inp[k]))
    bn.train()
    x = torch.from_numpy(x_all[rows]).to(device).requires_grad_()
    with global_batch_stats():
        y = bn(x)
        # this rank's share of sum(y * g) over the global batch: each rank's
        # backward reaches the others' rows through the statistics
        (y * torch.from_numpy(g_all[rows]).to(device)).sum().backward()
        mesh.all_reduce_grads(list(bn.parameters()))
        stats_before = bn.running_mean.clone()
        with torch.no_grad():
            bn(x.detach(), update_stats=False)
    with torch.no_grad():
        # outside global_batch_stats: this rank's own rows, no collective
        y_local = bn(x.detach(), update_stats=False)
    return {
        "y": y.detach().cpu().numpy(), "dx": x.grad.cpu().numpy(),
        "dweight": bn.weight.grad.cpu().numpy(), "dbias": bn.bias.grad.cpu().numpy(),
        "running_mean": bn.running_mean.cpu().numpy(), "running_var": bn.running_var.cpu().numpy(),
        "untouched_by_tta": bool(torch.equal(stats_before, bn.running_mean)),
        "y_local": y_local.cpu().numpy(),
    }


def _layout_check(inp, device):
    def members(group):
        return dist.get_process_group_ranks(group) if group is not None else None

    return {"data_rank": mesh.data_rank(), "net_rank": mesh.net_rank(),
            "data_size": mesh.data_size(), "net_size": mesh.net_size(),
            "space_rank": mesh.space_rank(), "space_size": mesh.space_size(),
            "data_group": members(mesh._data_group), "pair_group": members(mesh._pair_group),
            "space_group": members(mesh._space_group),
            "replica_group": members(mesh._replica_group),
            "rows": [mesh.local_rows(b) for b in inp["batches"]],
            "h_sharded": [mesh.h_sharded(b) for b in inp["batches"]]}


def _block(a: np.ndarray, h_dim: int, device) -> torch.Tensor:
    """This rank's block of a global array: its data rows, and its rows of
    dim ``h_dim`` on the space axis."""
    t = torch.from_numpy(a[mesh.local_rows(a.shape[0])])
    rows = mesh.local_h(t.shape[h_dim])
    return t.narrow(h_dim, rows.start, rows.stop - rows.start).contiguous().to(device)


def _primitives_check(inp, device):
    """The halo exchange (zero and edge rows, 1 and 2 rows), ``gather_h``
    and ``space_all_reduce`` on this rank's rows of (B, C, H, W) images,
    each with the gradient of sum(out * weights): the halos' weights given
    a space shard, the others over the whole output."""
    out = {}
    for name, r, edge in (("halo1", 1, False), ("halo2", 2, False), ("edge1", 1, True)):
        x = _block(inp["x"], 2, device).requires_grad_()
        y = mesh.halo_rows(x, r, edge)
        (y * torch.from_numpy(inp[f"w_{name}"][mesh.space_rank()]).to(device)).sum().backward()
        out[name] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    x = _block(inp["x"], 2, device).requires_grad_()
    y = mesh.gather_h(x, dim=2)
    (y * torch.from_numpy(inp["w_gather"]).to(device)).sum().backward()
    out["gather"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    x = _block(inp["x"], 2, device).requires_grad_()
    y = mesh.space_all_reduce(x.sum(dim=2))
    (y * torch.from_numpy(inp["w_sum"]).to(device)).sum().backward()
    out["sum"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    return out


def _layer(spec):
    from aide_tpu_torch.models import blocks

    kind, c = spec["kind"], spec["channels"]
    torch.manual_seed(0)
    return {
        "conv": lambda: blocks.Conv2d(c, c, 3, padding=1),
        "dilated": lambda: blocks.Conv2d(c, c, 3, padding=2, dilation=2),
        "upsample": blocks.Upsample2x,
        "pool": lambda: torch.nn.MaxPool2d(2),
        "bn": lambda: blocks.BatchNorm(c),
        "gn": lambda: blocks.GroupNorm(c, 2),
        "ca": lambda: blocks.ChannelAttention(c, 2),
    }[kind]().double()


def _layers_check(inp, device):
    """Each layer of ``inp["layers"]`` (f64, from seed 0) on this rank's
    block of x under ``space_partition`` and the global statistics: its
    output gathered over the space group, the input's gradient of
    sum(out * g) (every rank backpropagates its share, 1/replicas), and the
    parameter gradients summed over the replica group."""
    from aide_tpu_torch.models import blocks

    out = {}
    for spec in inp["layers"]:
        layer = _layer(spec).to(device).train()
        x = _block(inp["x"], 2, device).requires_grad_()
        with blocks.global_batch_stats(), blocks.space_partition():
            y = layer(x)
            if spec["kind"] != "ca":  # the channel gate's (B, C, 1, 1) is whole
                y = mesh.gather_h(y, dim=2)
            y = mesh.gather_rows(y)
            g = torch.from_numpy(inp[f"g_{spec['kind']}"]).to(device)
            (y * g).sum().div(mesh.replicas(True)[1]).backward()
        mesh.all_reduce_grads(list(layer.parameters()), spatial=True)
        out[spec["kind"]] = {
            "y": y.detach().cpu().numpy(), "dx": x.grad.cpu().numpy(),
            "grads": [p.grad.cpu().numpy() for p in layer.parameters()],
            "buffers": {k: v.cpu().numpy() for k, v in layer.named_buffers()},
        }
    return out


def _models_check(inp, device):
    """Each net of ``inp["models"]`` ({"cfg", "state"}), f64, on this rank's
    block of the global images in train mode under ``space_partition`` and
    the global statistics: the logits gathered to whole images and the
    global batch, the images' gradients of sum(logits * g), the parameter
    gradients summed over the replica group and the folded running
    statistics."""
    from aide_tpu_torch.models import blocks, build_model, is_two_modal

    out = []
    for spec in inp["models"]:
        cfg = TrainConfig.from_json(spec["cfg"])
        net = build_model(cfg.model)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state"].items()})
        net = net.double().to(device, memory_format=torch.channels_last).train()
        n_in = 2 if is_two_modal(cfg.model.name) else 1
        images = [_block(inp[f"image{m}"], 1, device).requires_grad_() for m in range(n_in)]
        with blocks.global_batch_stats(), blocks.space_partition():
            y = net(*images)
            y = mesh.gather_rows(mesh.gather_h(y))
            (y.double() * torch.from_numpy(inp["g"]).to(device)).sum().div(
                mesh.replicas(True)[1]).backward()
        mesh.all_reduce_grads(list(net.parameters()), spatial=True)
        out.append({
            "y": y.detach().cpu().numpy(), "dx": [x.grad.cpu().numpy() for x in images],
            "grads": {k: p.grad.cpu().numpy() for k, p in net.named_parameters()},
            "stats": {k: v.cpu().numpy() for k, v in net.named_buffers()},
        })
    return out


def _step_check(inp, device):
    """One co-teaching step from the given pair: of the pair on a data
    axis, of this rank's net of it on a net axis."""
    from aide_tpu_torch.engine import steps
    from aide_tpu_torch.engine.state import DualTrainState, NetRankState
    from aide_tpu_torch.models import build_model
    from aide_tpu_torch.ops.schedules import make_optimizer

    cfg = TrainConfig.from_json(inp["cfg"])
    pair = mesh.net_size() > 1
    given = [inp["nets"][mesh.net_rank()]] if pair else inp["nets"]
    nets = []
    for sd in given:
        net = build_model(cfg.model)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        nets.append(net.to(device, memory_format=torch.channels_last))
    params = [p for n in nets for p in n.parameters()]
    optimizer = make_optimizer(params, cfg.optim, 10, 10, pair=pair)
    state = (NetRankState(nets[0], mesh.net_rank(), optimizer) if pair
             else DualTrainState(nets[0], nets[1], optimizer))
    step = steps.make_coteach_train_step(True, cfg)
    b = inp["degrees"].shape[1]
    rows = mesh.local_rows(b)
    batch = {k: torch.from_numpy(v).to(device) for k, v in mesh.shard_rows(inp["batch"]).items()}
    for t in ("target1", "target2"):
        batch[t] = batch[t].long()
    m = step(state, batch, torch.from_numpy(inp["degrees"][:, rows]).to(device),
             torch.from_numpy(inp["hflip"][:, rows]).to(device), inp["rate"],
             mesh.rows_sharded(b), *((True,) if mesh.h_sharded(b) else ()))
    return {
        "metrics": {k: float(v) for k, v in m.items()},
        "nets": [_np(n.state_dict()) for n in nets],
        # AMSGrad's first moment after one step: (1 - b1) * the gradient
        "mu": [[state.optimizer.state[p]["mu"].cpu().numpy().copy() for p in n.parameters()]
               for n in nets],
    }


def _supervised_check(inp, device):
    """One supervised step of the given net on this rank's block of the
    batch: the metrics, the net after it and AMSGrad's first moment."""
    from aide_tpu_torch.engine import steps
    from aide_tpu_torch.engine.state import TrainState
    from aide_tpu_torch.models import build_model
    from aide_tpu_torch.ops.schedules import make_optimizer

    cfg = TrainConfig.from_json(inp["cfg"])
    net = build_model(cfg.model)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in inp["net"].items()}, strict=True)
    net = net.to(device, memory_format=torch.channels_last)
    state = TrainState(net, make_optimizer(list(net.parameters()), cfg.optim, 10, 10))
    b = inp["batch"]["target"].shape[0]
    batch = {k: torch.from_numpy(v).to(device) for k, v in mesh.shard_rows(inp["batch"]).items()}
    batch["target"] = batch["target"].long()
    m = steps.make_supervised_train_step(False, cfg)(state, batch, mesh.rows_sharded(b),
                                                     mesh.h_sharded(b))
    return {"metrics": {k: float(v) for k, v in m.items()}, "net": _np(net.state_dict()),
            "mu": [state.optimizer.state[p]["mu"].cpu().numpy().copy() for p in net.parameters()]}


def _augment_check(inp, device):
    """``data.augment_main``'s warp of this rank's block of a two-modal
    batch (``steps.make_augment_batch``): the rank's rows of every leaf."""
    from aide_tpu_torch.engine import steps

    cfg = TrainConfig.from_json(inp["cfg"])
    b = inp["degrees"].shape[0]
    rows = mesh.local_rows(b)
    batch = {k: torch.from_numpy(v).to(device) for k, v in mesh.shard_rows(inp["batch"]).items()}
    out = steps.make_augment_batch(cfg, True)(
        batch, torch.from_numpy(inp["degrees"][rows]).to(device),
        torch.from_numpy(inp["hflip"][rows]).to(device), *((True,) if mesh.h_sharded(b) else ()))
    return {k: v.cpu().numpy() for k, v in out.items()}


def _sizing_check(inp, device):
    """For each config of ``inp["cfgs"]``, a Trainer on the synthetic task
    of ``inp["task"]``: the messages it logged and whether the space axis
    splits the images after it."""
    import logging

    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append((record.levelname, record.getMessage()))

    out = []
    for i, text in enumerate(inp["cfgs"]):
        cfg = TrainConfig.from_json(text)
        work = os.path.join(inp["workdir"], f"rank{mesh.rank()}_{i}")
        cfg.checkpoint_dir, cfg.history_dir = (os.path.join(work, d) for d in ("ckpt", "hist"))
        keep = Keep()
        logger = logging.getLogger(f"sizing.{mesh.rank()}.{i}")
        logger.addHandler(keep)
        logger.setLevel(logging.INFO)
        Trainer(cfg, SyntheticTask(root=os.path.join(work, "data"), **inp["task"]),
                device=device, logger=logger)
        out.append({"lines": keep.lines, "live": mesh.space_shards() > 1})
    return out


def _cache_check(inp, device):
    from aide_tpu_torch.data.pipeline import ShardedCache

    cache = ShardedCache(inp["arrays"], device)
    out = {"gathers": [], "images_only": None}
    for idx in inp["gathers"]:
        out["gathers"].append({k: v.cpu().numpy() for k, v in cache.gather(idx).items()})
    out["images_only"] = sorted(cache.gather(inp["gathers"][0], images_only=True))
    idx, rows = inp["scatter"]
    cache.scatter("target1", idx, rows)
    out["block"] = cache.rows("target1").cpu().numpy()
    out["after"] = cache.gather(inp["gathers"][0])["target1"].cpu().numpy()
    b = inp["fetch"][0].shape[0]
    local = [torch.from_numpy(a[mesh.local_rows(b)]).to(device) for a in inp["fetch"]]
    out["fetch"] = [t.cpu().numpy() for t in mesh.fetch(*local)]
    return out


def _init_check(inp, device):
    from aide_tpu_torch.engine.trainer import init_net

    cfg = TrainConfig.from_json(inp["cfg"])
    return [_np(init_net(cfg.model, seed).state_dict()) for seed in (cfg.seed, cfg.seed + 1)]


def _trainer_check(inp, device):
    """The nets of the state a ``Trainer`` builds here, for each config of
    ``inp["cfgs"]`` on the synthetic task of ``inp["task"]`` (under this
    rank's own directory of ``inp["workdir"]``): {"index": the net of the
    pair this rank holds (None for the pair), "nets": their state dicts}."""
    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer

    out = []
    for i, text in enumerate(inp["cfgs"]):
        cfg = TrainConfig.from_json(text)
        work = os.path.join(inp["workdir"], f"rank{mesh.rank()}_{i}")
        cfg.checkpoint_dir, cfg.history_dir = (os.path.join(work, d) for d in ("ckpt", "hist"))
        tr = Trainer(cfg, SyntheticTask(root=os.path.join(work, "data"), **inp["task"]),
                     device=device)
        out.append({"index": getattr(tr.state, "index", None),
                    "nets": [_np(net.state_dict()) for net in tr.state.nets]})
    return out


def unit_checks(rank: int, device, inputs) -> Dict:
    """The checks of ``inputs`` (keys "layout", "bn", "step", "step_clip",
    "cache", "init", "trainer", "primitives", "layers", "models",
    "supervised", "sizing", "augment") on this rank; each rank uses one torch thread.
    Each check's collectives are counted, in all and by kind."""
    torch.set_num_threads(1)
    checks = {"layout": _layout_check, "bn": _bn_check, "step": _step_check,
              "step_clip": _step_check, "cache": _cache_check, "init": _init_check,
              "trainer": _trainer_check, "primitives": _primitives_check,
              "layers": _layers_check, "models": _models_check,
              "supervised": _supervised_check, "sizing": _sizing_check,
              "augment": _augment_check}
    out = {"world": mesh.world_size(), "rank": rank}
    for name, fn in checks.items():
        if name in inputs:
            mesh.reset_collectives()
            out[name] = fn(inputs[name], device)
            out[name + "_collectives"] = mesh.collectives
            out[name + "_by_kind"] = {k: list(v) for k, v in mesh.by_kind.items()}
    return out


# --------------------------- the trainer job ---------------------------


def _train_rank(rank: int, device, inputs: str, workdir: str) -> Dict:
    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer

    with np.load(inputs) as z:
        arrays = {k: z[k] for k in z.files}
    spec = json.loads(str(arrays.pop("spec")))
    cfg = TrainConfig.from_json(spec["cfg"])
    cfg.checkpoint_dir = os.path.join(workdir, "ckpt")
    cfg.history_dir = os.path.join(workdir, "hist")
    task = SyntheticTask(root=os.path.join(workdir, "data"), **spec["task"])
    tr = Trainer(cfg, task, device=device)
    tr.label_cases = set(task.clean_case_ids())
    # the nets of the pair this rank holds: both, or its own on a net axis
    held = [getattr(tr.state, "index", n) for n in range(len(tr.state.nets))]
    for n, net in zip(held, tr.state.nets):
        prefix = f"net{n}."
        net.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
                             if k.startswith(prefix)}, strict=True)
    degrees, hflip = arrays["degrees"], arrays["hflip"]  # (epochs, steps, V, B)
    tr.view_params = lambda epoch, step, b: (
        torch.from_numpy(degrees[epoch, step]).to(device),
        torch.from_numpy(hflip[epoch, step]).to(device))
    history = tr.run(spec["epochs"])
    files = sorted(os.path.relpath(os.path.join(d, f), workdir)
                   for d, _, fs in os.walk(workdir) for f in fs)
    state = {f"net{n}.{k}": v for n, net in zip(held, tr.state.nets)
             for k, v in _np(net.state_dict()).items()}
    state.update({f"labels{n}": tr.train_pipe.labels.get(n) for n in (1, 2)})
    pipe = tr.train_pipe
    if pipe._sharded is not None:
        state.update({f"device_labels{n}": pipe._sharded.rows(f"target{n}").cpu().numpy()
                      for n in (1, 2)})
    elif pipe._device_labels is not None:
        state.update({f"device_labels{n}": pipe._device_labels[f"target{n}"].cpu().numpy()
                      for n in (1, 2)})
    np.savez(os.path.join(workdir, "state.npz"), **state)
    return {
        "rank": rank, "world": mesh.world_size(), "net_size": mesh.net_size(),
        "space_size": mesh.space_size(), "space_live": mesh.space_shards() > 1, "held": held,
        "history": [{k: v for k, v in row.items() if not k.startswith("time")} for row in history],
        "refresh_log": [[e, n, list(sel), list(done)] for e, n, sel, done in tr.refresh_log],
        "files": files,
    }


def train_job(rank: int, device, inputs: str, workdir: str) -> Dict:
    """``_train_rank`` with one torch thread, in ``workdir/rank{rank}``: the
    program of each rank of ``mesh.launch``."""
    torch.set_num_threads(1)
    work = os.path.join(workdir, f"rank{rank}")
    os.makedirs(work, exist_ok=True)
    return _train_rank(rank, device, inputs, work)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one process of a data- or net-axis Trainer job")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--net", type=int, default=1, help="the net axis (mesh.extra_axes)")
    ap.add_argument("--inputs", required=True, help=".npz of the weights, views and spec")
    ap.add_argument("--workdir", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cfg = TrainConfig()
    cfg.mesh.coordinator_address = args.coordinator
    cfg.mesh.num_processes = args.num_processes
    cfg.mesh.process_id = args.process_id
    if args.net > 1:
        cfg.mesh.extra_axes = (("net", args.net),)
    os.makedirs(args.workdir, exist_ok=True)
    result = mesh.launch(_train_rank, cfg, "cpu", (args.inputs, args.workdir))[args.process_id]
    with open(os.path.join(args.workdir, "result.json"), "w") as fh:
        json.dump(result, fh, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
