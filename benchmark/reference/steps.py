"""The reference's readings of a training cell's first steps: its losses,
its first gradient and each leaf's change over the steps, from the same
weights, rows and view draws as the port's warm-up epoch."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from benchmark.reference import data as ref_data
from benchmark.reference import nets as ref_nets
from benchmark.reference import train as ref_train


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and convolutions inside."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def readings(config: Dict, data: Dict, dual: bool, state_dicts: List[Dict[str, torch.Tensor]],
             seed: int, epoch: int, steps: int, device, precision: str = "float32",
             half: bool = False) -> Dict:
    """Run ``steps`` steps of epoch ``epoch`` from ``state_dicts``.
    ``half`` keeps the first half of each batch alone (a fault to plant).
    Returns {"losses", "grad", "change"} as ``checks.train_numbers`` reads
    them, leaves named net<k>.<parameter>."""
    nets = []
    for sd in state_dicts:
        net = ref_nets.build(config["model"]).to(device)
        net.load_state_dict(sd)
        nets.append(ref_nets.set_precision(net, precision))
    named = [(f"net{k}.{n}", p) for k, net in enumerate(nets) for n, p in net.named_parameters()]
    opt = ref_train.AMSGrad([p for _, p in named], config["lr"])
    start = [p.detach().clone() for _, p in named]
    b = config["batch_size"]
    order = ref_train.shuffle_order(seed, epoch, data["train_cases"] * data["slices_per_case"])
    rate = min((epoch / config["warmup_epochs"]) ** 2, 1.0)
    out = {"losses": []}
    with float32_exact():
        for step in range(steps):
            rows = order[step * b:(step + 1) * b]
            batch = ref_data.batch(data, ref_data.rows_to_slices(data, rows), True, device)
            keep = b // 2 if half else b
            batch = {k: (tuple(x[:keep] for x in v) if isinstance(v, tuple) else v[:keep])
                     for k, v in batch.items()}
            if dual:
                deg, flip = ref_train.view_params(device, seed, epoch, step,
                                                  config["num_tta_views"], b,
                                                  config["rotation_degree"])
                losses, grads = ref_train.coteach_step(nets, opt, batch, deg[:, :keep],
                                                       flip[:, :keep], rate)
            else:
                losses, grads = ref_train.supervised_step(nets, opt, batch)
            out["losses"].append(losses)
            if step == 0:
                out["grad"] = {n: float(g.norm()) for (n, _), g in zip(named, grads)}
    out["change"] = {n: float((p.detach() - p0).norm()) for (n, p), p0 in zip(named, start)}
    return out
