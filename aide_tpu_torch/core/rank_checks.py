"""Rank-side programs of the data and net axes' parity checks.

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
  on the rank (its initialisation, or a warm start from an export).
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
            "data_group": members(mesh._data_group), "pair_group": members(mesh._pair_group),
            "rows": [mesh.local_rows(b) for b in inp["batches"]]}


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
             mesh.rows_sharded(b))
    return {
        "metrics": {k: float(v) for k, v in m.items()},
        "nets": [_np(n.state_dict()) for n in nets],
        # AMSGrad's first moment after one step: (1 - b1) * the gradient
        "mu": [[state.optimizer.state[p]["mu"].cpu().numpy().copy() for p in n.parameters()]
               for n in nets],
    }


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
    "cache", "init", "trainer") on this rank; each rank uses one torch
    thread."""
    torch.set_num_threads(1)
    checks = {"layout": _layout_check, "bn": _bn_check, "step": _step_check,
              "step_clip": _step_check, "cache": _cache_check, "init": _init_check,
              "trainer": _trainer_check}
    out = {"world": mesh.world_size(), "rank": rank}
    for name, fn in checks.items():
        if name in inputs:
            mesh.reset_collectives()
            out[name] = fn(inputs[name], device)
            out[name + "_collectives"] = mesh.collectives
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
        "rank": rank, "world": mesh.world_size(), "net_size": mesh.net_size(), "held": held,
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
