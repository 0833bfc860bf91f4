"""AIDE's kidney co-teaching step in plain float32 PyTorch, and the check's
readings of its first steps.

``trainkidney_proposed_mask1.py`` trains two UNets as the CHAOS script
does (``reference.train.coteach_step``), with three differences that this
module adds:
  1. the TTA views run with the nets in eval mode (the script's
     ``net.eval()`` around them): BatchNorm normalises them by its running
     statistics and leaves those as they are;
  2. the view average is sharpened as p^(1/T), renormalised
     (``sharpen_mode`` "pow_inv_t"; "pow_t" is p^T);
  3. the main forwards, in train mode, fold their batch statistics into
     the running ones, ``running = 0.9 * running + 0.1 * batch`` with the
     biased batch variance, so that each step's views read what the
     steps before it folded in.
Departures from the published description: the script's BatchNorm
(``nn.BatchNorm2d``) folds the unbiased variance; this one folds the
biased one, as the port does (``models/blocks.py``, after flax). The
labels, the loss, the small-loss split, the consistency term, AMSGrad
and the view draws are ``reference.train``'s; the networks are
``reference.nets``'; the case evaluation and the refresh, which skips
an empty prediction with ``refresh_skip_empty``, are
``reference.evaluate``'s.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import data as ref_data
from benchmark.reference import nets as ref_nets
from benchmark.reference import train as ref_train
from benchmark.reference.steps import float32_exact

MOMENTUM = 0.1


class FoldingBN(ref_nets.BN):
    """``reference.nets.BN`` whose train-mode forward folds the biased batch
    statistics into the running ones at ``MOMENTUM``."""

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(x.detach().float(), dim=(0, 2, 3), unbiased=False)
                self.running_mean.lerp_(mean, MOMENTUM)
                self.running_var.lerp_(var, MOMENTUM)
        return super().forward(x)


def build(model: Dict) -> torch.nn.Module:
    """``reference.nets.build(model)`` with every BatchNorm a ``FoldingBN``."""
    net = ref_nets.build(model)
    for m in net.modules():
        if isinstance(m, ref_nets.BN):
            m.__class__ = FoldingBN
    return net


def exponent(config: Dict) -> float:
    """The power the view average is raised to: 1/T ("pow_inv_t") or T."""
    t = float(config["temperature"])
    return 1.0 / t if config["sharpen_mode"] == "pow_inv_t" else t


def coteach_step(nets, opt: ref_train.AMSGrad, batch: Dict, degrees, hflip, rate: float,
                 config: Dict, clean_fraction: float = 0.5,
                 consistency_weight: float = 10.0):
    """One co-teaching step of the kidney protocol (module docstring);
    returns ([loss1, loss2], the gradients in ``opt``'s parameter order)
    and updates the nets, their running statistics among them."""
    images, fills, t = batch["images"], batch["fills"], batch["target"]
    for net in nets:
        net.train(config["tta_bn"] == "batch")
    pseudo, wmap = ref_train.pseudo_labels(nets, images, fills, degrees, hflip,
                                           exponent(config))
    for net in nets:
        net.train()
    out = [net(*images) for net in nets]
    pre = [ref_train.image_loss(o, t) for o in out]
    order = [torch.argsort(p.detach(), stable=True) for p in pre]
    loss = [ref_train._side(pre[k], out[k], order[1 - k], pseudo[1 - k], wmap[1 - k], rate,
                            clean_fraction, consistency_weight) for k in (0, 1)]
    grads = torch.autograd.grad(loss[0] + loss[1], opt.params)
    opt.step(grads)
    return [float(x.detach()) for x in loss], list(grads)


def readings(config: Dict, data: Dict, dual: bool, state_dicts: List[Dict[str, torch.Tensor]],
             seed: int, epoch: int, steps: int, device, precision: str = "float32",
             half: bool = False) -> Dict:
    """``reference.steps.readings`` for the kidney protocol: ``steps``
    co-teaching steps of epoch ``epoch`` from ``state_dicts`` (``half``
    keeps the first half of each batch, a fault to plant). Returns
    {"losses", "grad", "change", "running"}: the last the nets' running
    statistics after the steps, by name."""
    if not dual:
        raise ValueError("the kidney protocol's reference is the co-teaching pair's")
    nets = []
    for sd in state_dicts:
        net = build(config["model"]).to(device)
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
            deg, flip = ref_train.view_params(device, seed, epoch, step, config["num_tta_views"],
                                              b, config["rotation_degree"])
            losses, grads = coteach_step(nets, opt, batch, deg[:, :keep], flip[:, :keep], rate,
                                         config)
            out["losses"].append(losses)
            if step == 0:
                out["grad"] = {n: float(g.norm()) for (n, _), g in zip(named, grads)}
    out["change"] = {n: float((p.detach() - p0).norm()) for (n, p), p0 in zip(named, start)}
    out["running"] = {f"net{k}.{n}": v.detach().clone() for k, net in enumerate(nets)
                      for n, v in net.named_buffers()}
    return out
