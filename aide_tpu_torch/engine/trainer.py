"""The training engine's dual co-teaching epoch.

The counterpart of ``aide_tpu.engine.trainer.Trainer`` for what it runs
per epoch before case evaluation: ``__init__`` (pipelines on the device,
two nets initialised as flax does, one AMSGrad), ``_train_epoch`` (the
shuffled co-teaching steps) and ``_test_epoch`` (the dual test pass), with
the metric bookkeeping of ``_accumulate`` / ``_finalize``. The rest of
``run_epoch`` (case eval, label refresh, the guardrail, checkpoints),
``run``, the CLI and the supervised path are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from aide_tpu_torch.core import prng
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.data.pipeline import SlicePipeline
from aide_tpu_torch.engine import steps as steps_mod
from aide_tpu_torch.engine.state import DualTrainState
from aide_tpu_torch.models import build_model
from aide_tpu_torch.ops import tta
from aide_tpu_torch.ops.schedules import make_optimizer

# flax's lecun_normal: a normal truncated at ±2 std, rescaled by the std of
# the standard normal truncated there, so the variance stays 1/fan_in
_TRUNC_STD = 0.87962566103423978


def resolve_device(device=None) -> torch.device:
    """The device to run on: ``device`` when given, else the first CUDA
    card. Never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def init_net(model_cfg, seed: int) -> nn.Module:
    """A model with flax's default initialisation, drawn from ``seed``:
    conv kernels lecun_normal, conv biases 0, BN scale 1 and bias 0."""
    net = build_model(model_cfg)
    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            nn.init.zeros_(m.bias)
    return net


class Trainer:
    def __init__(self, cfg: TrainConfig, task, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.task = task
        self.two_modal = task.two_modal
        self.dual = cfg.data.variant == "proposed" and cfg.coteach.enabled
        if not self.dual:
            raise NotImplementedError("the supervised path is not ported yet")
        if not self.two_modal:
            raise NotImplementedError("the port trains the two-modal FuseUNet only")
        if cfg.data.augment_main:
            raise NotImplementedError("data.augment_main is not ported yet")

        train_specs = task.load_manifest(cfg.data.train_csv, train=True)
        test_specs = task.load_manifest(cfg.data.test_csv, train=False)
        self.train_pipe = SlicePipeline(
            task, train_specs, cfg.data.img_size, cfg.data.data_mean,
            cfg.data.data_std, working_labels=True,
        )
        self.test_pipe = SlicePipeline(
            task, test_specs, cfg.data.img_size, cfg.data.data_mean,
            cfg.data.data_std, working_labels=False,
        )
        self.device_resident = cfg.data.device_cache in ("on", "auto")
        if self.device_resident:
            self.train_pipe.to_device(self.device)
            self.test_pipe.to_device(self.device)

        nets = []
        for seed in (cfg.seed, cfg.seed + 1):
            net = init_net(cfg.model, seed)
            nets.append(net.to(self.device, memory_format=torch.channels_last))
        spe = self.train_pipe.steps_per_epoch(cfg.data.batch_size)
        params = [p for net in nets for p in net.parameters()]
        optimizer = make_optimizer(params, cfg.optim, spe, cfg.num_epochs)
        self.state = DualTrainState(nets[0], nets[1], optimizer)
        self.train_step = steps_mod.make_coteach_train_step(self.two_modal, cfg)
        self.eval_step = steps_mod.make_eval_step(self.two_modal, cfg)

    # ------------------------------------------------------------------

    def view_params(self, epoch: int, step: int, batch: int):
        """(V, B) TTA rotation angles and flip flags of one train step, from
        a generator seeded by (seed, epoch, step). Tests replace this method
        to inject another stream."""
        gen = prng.generator(self.device, self.cfg.seed, epoch, step)
        d = self.cfg.data
        return tta.sample_view_params(gen, d.num_tta_views, batch, d.rotation_degree, d.hflip_prob)

    def _on_device(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.device_resident:
            return batch
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    @staticmethod
    def _accumulate(totals, m):
        """Accumulate on the device: loss means weighted by the batch count,
        dice sums added directly. No host sync inside the epoch."""
        c = m["count"]
        weighted = {k: (v * c if k.startswith("loss") else v) for k, v in m.items()}
        if totals is None:
            return weighted
        return {k: totals[k] + weighted[k] for k in weighted}

    @staticmethod
    def _finalize(totals) -> Dict[str, float]:
        if totals is None:
            return {}
        keys = list(totals)
        host = dict(zip(keys, torch.stack([totals[k].float() for k in keys]).tolist()))
        count = max(float(host.pop("count")), 1.0)
        return {k: float(v) / count for k, v in host.items()}

    def _train_epoch(self, epoch: int, rate: float) -> Dict[str, float]:
        cfg = self.cfg
        shuffle_rng = np.random.default_rng(
            cfg.seed * 100003 + cfg.data.shuffle_seed * 1009 + epoch
        )
        totals: Optional[dict] = None
        for i, batch in enumerate(self.train_pipe.batches(cfg.data.batch_size, rng=shuffle_rng)):
            batch = self._on_device(batch)
            degrees, hflip = self.view_params(epoch, i, batch["target1"].shape[0])
            m = self.train_step(self.state, batch, degrees, hflip, rate)
            totals = self._accumulate(totals, m)
        return self._finalize(totals)

    def _test_epoch(self) -> Dict[str, float]:
        totals: Optional[dict] = None
        for batch in self.test_pipe.batches(
            self.cfg.data.eval_batch_size, shuffle=False, drop_last=False
        ):
            batch = self._on_device(batch)
            batch = dict(batch, target1=batch["target"], target2=batch["target"])
            totals = self._accumulate(totals, self.eval_step(self.state, batch))
        return self._finalize(totals)
