"""The training engine: the dual co-teaching and the supervised epoch and run.

The counterpart of ``aide_tpu.engine.trainer.Trainer`` (flagship reference:
the CHAOS proposed trainer). Per epoch of the dual co-teaching trainer,
``run_epoch``:

  rate        <- min((epoch/warmup)^2, 1)
  train       <- the shuffled co-teaching steps (engine/steps.py)
  test        <- the test pass fused with the test cases' labels
  train cases <- re-inference against each net's working labels
  case eval   <- largest-CC and 3D Dice per case on the host
  checkpoint  <- best mean train-case dice (optional ascending gate)
  refresh     <- the worst update_percent cases per net get the net's
                 prediction as working labels (labeled cases exempt), on
                 disk and on the device
  guardrail   <- the end-of-ramp engagement verdict

The supervised (comparison) trainer runs the same loop with one net, the
scalar criterion, no TTA, no refresh and no guardrail; its best export
embeds the epoch history. With ``data.augment_main`` both trainers warp the
main view's images and targets before each train step (one rotation and
flip per image, ``augment_params``; ``steps.make_augment_batch``).

``resume_file`` is either an exact resume or a warm start. A
``*_full.msgpack`` file (the best epoch's ``_full`` or the end of a run's
``_last_full``, of either package: ``engine.checkpoint``) restores the
parameters, BN statistics, optimizer moments and count, and its sidecar the
epoch clock, the best and changepoint gates and the history; the working
labels come back through the tempmask folder, and the view, augment and
shuffle streams depend only on (seed, epoch, step), so ``run`` goes on
from ``start_epoch`` as the uninterrupted run would have. Any other file (a
``.pkl`` or a JAX ``.msgpack`` net export) warm-starts both nets of the pair
from one net's export with symmetry-breaking noise, or loads a supervised
net's weights.

``Trainer(cfg)`` builds the task that ``cfg.data.task`` names
(``data.tasks.build_task``: CHAOS, prostate, kidney, breast or synthetic)
and decodes its manifests once, through ``data.decode_cache_dir``'s npz
cache when set; a task object passed in is used as it is.
``log_every_steps`` logs the step losses every N steps. The set-up, each
epoch's phases and the train feed open spans of ``core.trace``; the
history row's ``time_*`` keys are their host seconds (``run_epoch``).

``run`` loops over the epochs and writes the history and the best-epoch
files even when an epoch fails, and ``{experiment_name}_last_full.msgpack``
when the run ends; a warm-started dual run first probes the bootstrap skill
on the labeled cases. The CLI (``aide_tpu_torch.cli``) drives this class.

Over a data axis of N ranks (one process a card, started by
``core.mesh.launch``) every rank builds the same trainer from the same
seeds and computes what the JAX trainer computes on an N-device mesh: each
step takes the rank's rows of the global batch with the global view
parameters' columns (``engine/steps.py`` keeps the global semantics), the
test pass and case evaluation take their rows and ``mesh.fetch`` the rest,
so that every rank takes the same host decisions (gate, refresh,
guardrail) from the same bytes; the primary rank alone writes files. N
must divide gcd(batch_size, eval_batch_size); ``predict_all`` and the
fused test pass are off at N > 1, as in the JAX package. A trainer built
in a process that ``launch`` did not start runs as one rank; it raises
when the config asks for more.

With a net axis (``mesh.extra_axes = (("net", 2),)``, 2*N ranks) the rank
of data shard d and net k holds net k of the pair alone
(``engine.state.NetRankState``), initialised from ``seed + k`` as one
process initialises it, and trains it on shard d's rows; the step, the
test pass, case evaluation, the probe and refresh exchange what the other
net needs or both nets' results over the pair (``mesh.pair_exchange``), so
every rank takes the same decisions, and the primary rank gathers its
partner's net for the files, which stay the pair's. A single-net run
replicates its net over the axis and says so, as the JAX trainer does.

With a space axis (``mesh.extra_axes = (("space", S),)``, alone or after a
net axis; S ranks more each) the S ranks of a block of images each hold
its rows [s*H/S, (s+1)*H/S) and train on them (``engine/steps.py``,
``models.blocks.space_partition``): the axis is layout only, so the
numbers are the one-process run's up to reduction order. Case evaluation,
the probe and refresh gather the labels' rows, so every rank takes the
same decisions from whole images; the parameters are replicated over the
axis and rank 0 writes the files. Where the images cannot be split (S does
not divide ``img_size``, as the JAX trainer checks, or, in the port, a
level of the model holds fewer rows a rank than its pools or its widest
halo need) the trainer says so and turns the axis off: the space ranks run
as replicas on whole images. The TTA warps stay on the CUDA kernel on a
card: each fetches the whole source rows and writes its shard's rows (the
JAX trainer pins them to its 3-shear path instead, which GSPMD can split).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from aide_tpu_torch.core import mesh, prng, trace
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.core.logging import record_params, setup_logging
from aide_tpu_torch.data.pipeline import SlicePipeline
from aide_tpu_torch.data.tasks import build_task
from aide_tpu_torch.engine import checkpoint as ckpt
from aide_tpu_torch.engine import steps as steps_mod
from aide_tpu_torch.engine.state import DualTrainState, NetRankState, TrainState
from aide_tpu_torch.evaluation.case_eval import (
    _postprocess_case,
    dice3d_np,
    pack_case_stream,
    score_case_volumes,
    start_case_evaluation,
    start_host_copy,
)
from aide_tpu_torch.models import build_model, space_needs
from aide_tpu_torch.ops import tta
from aide_tpu_torch.ops.schedules import make_optimizer, rate_schedule

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
            "no CUDA device available; pass device='cpu' (the CLI's --device cpu) "
            "to run on the CPU"
        )
    return torch.device("cuda")


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """flax's default initialisation of ``module`` in place, drawn from
    ``seed``: conv, transposed-conv and dense kernels lecun_normal over
    flax's fan-in (input channels times the kernel's taps), their biases 0;
    norm scales 1 and biases 0 as the norms are built."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
        elif isinstance(m, nn.Linear):
            fan_in = m.in_features
        else:
            continue
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        nn.init.zeros_(m.bias)
    return module


def init_net(model_cfg, seed: int) -> nn.Module:
    """The model a ModelConfig names, with flax's default initialisation
    drawn from ``seed`` (``init_weights``)."""
    return init_weights(build_model(model_cfg), seed)


def check_mesh(cfg: TrainConfig) -> int:
    """The ranks this process trains with: its process group's (1 without
    one). Raises where the config asks for more than the process was
    started with, for an axis neither package has, for a net axis of a
    dual run whose size is not 2 (as ``place_state`` does), for a group
    whose net or space axis is not the config's, and for a data axis whose
    size does not divide gcd(batch_size, eval_batch_size)."""
    mesh.refuse_axes(cfg.mesh)
    net = mesh.axis_size(cfg.mesh, "net")
    space = mesh.axis_size(cfg.mesh, "space")
    if net > 1 and net != 2 and cfg.data.variant == "proposed" and cfg.coteach.enabled:
        raise ValueError(
            f"mesh axis 'net' must have size 2 (the dual co-teaching pair), got {net}")
    world = mesh.world_size()
    launched = mesh.fit_data_devices(mesh.data_batch(cfg), cfg.mesh.num_devices)
    if not mesh.in_group() and (launched > 1 or net > 1 or space > 1
                                or cfg.mesh.coordinator_address):
        raise ValueError(
            f"mesh.num_devices={cfg.mesh.num_devices}, mesh.extra_axes="
            f"{tuple(cfg.mesh.extra_axes)}, mesh.coordinator_address="
            f"{cfg.mesh.coordinator_address!r}: more than one rank runs one process a card, "
            "which aide_tpu_torch.core.mesh.launch starts (the CLI's train does); this process "
            "was not started by launch"
        )
    if mesh.in_group() and (mesh.net_size(), mesh.space_size()) != (net, space):
        raise ValueError(
            f"the process group has a net axis of {mesh.net_size()} and a space axis of "
            f"{mesh.space_size()}, mesh.extra_axes={tuple(cfg.mesh.extra_axes)} asks for "
            f"{net} and {space}")
    data = mesh.data_size()
    if data > 1 and mesh.fit_data_devices(mesh.data_batch(cfg), data) != data:
        raise ValueError(
            f"{data} data shards do not divide gcd(batch_size={cfg.data.batch_size}, "
            f"eval_batch_size={cfg.data.eval_batch_size})"
        )
    return world


class Trainer:
    def __init__(self, cfg: TrainConfig, task=None, device=None, logger=None):
        self.world = check_mesh(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dual = cfg.data.variant == "proposed" and cfg.coteach.enabled
        self.logger = logger or setup_logging(
            cfg.history_dir, cfg.experiment_name, primary=mesh.is_primary())
        record_params(self.logger, cfg)
        self._warn_mesh()
        self._size_space_axis()

        self.task = task = task if task is not None else build_task(cfg)
        self.two_modal = task.two_modal
        cache_dir = cfg.data.decode_cache_dir or None
        with trace.span("setup.decode"):
            train_specs = task.load_manifest(cfg.data.train_csv, train=True)
            test_specs = task.load_manifest(cfg.data.test_csv, train=False)
            self.train_pipe = SlicePipeline(
                task, train_specs, cfg.data.img_size, cfg.data.data_mean,
                cfg.data.data_std, working_labels=self.dual, cache_dir=cache_dir,
            )
            self.test_pipe = SlicePipeline(
                task, test_specs, cfg.data.img_size, cfg.data.data_mean,
                cfg.data.data_std, working_labels=False, cache_dir=cache_dir,
            )
        d = cfg.data
        self.train_cases = (
            task.load_case_list(d.traincase_csv) if d.traincase_csv else list(self.train_pipe.cases)
        )
        self.test_cases = (
            task.load_case_list(d.testcase_csv) if d.testcase_csv else list(self.test_pipe.cases)
        )
        self.label_cases = set(task.load_case_list(d.labelcase_csv) if d.labelcase_csv else [])
        # an observation hook, on_refresh(epoch), called after each label
        # refresh (_refresh_labels)
        self.on_refresh = None
        # every refresh decision in order: (epoch, net, worst-k selection,
        # the subset actually rewritten)
        self.refresh_log: list = []
        # the end-of-ramp engagement verdict (coteach.engagement_check),
        # None before the ramp ends
        self.engagement = None
        # the bootstrap skill probe {"bootstrap_skill1", "bootstrap_skill2"}:
        # a warm-started dual run measures it before its first step; a
        # caller may set it before run(), which suppresses the measurement;
        # None otherwise
        self.engagement_probe = None
        self._label_fg_cache = None
        # the working labels as the first refresh found them: the reference
        # of the retention and foreground signals
        self._bootstrap_labels = None
        self._structural_warned = False

        self.device_resident = cfg.data.device_cache in ("on", "auto")
        if self.device_resident:
            with trace.span("setup.upload"):
                self.train_pipe.to_device(self.device)
                self.test_pipe.to_device(self.device)

        # what both packages read as an exact resume
        self.exact_resume = cfg.resume_file.endswith("_full.msgpack")
        seeds = (cfg.seed, cfg.seed + 1) if self.dual else (cfg.seed,)
        # on a net axis this rank holds net k of the pair, from its seed
        pair_rank = self.dual and mesh.net_size() > 1
        if pair_rank:
            seeds = (seeds[mesh.net_rank()],)
        with trace.span("setup.nets"):
            nets = [
                # an exact resume overwrites every weight: no initialisation draw
                (build_model(cfg.model) if self.exact_resume else init_net(cfg.model, seed)).to(
                    self.device, memory_format=torch.channels_last)
                for seed in seeds
            ]
            spe = self.train_pipe.steps_per_epoch(cfg.data.batch_size)
            params = [p for net in nets for p in net.parameters()]
            optimizer = make_optimizer(params, cfg.optim, spe, cfg.num_epochs, pair=pair_rank)
        warm_start = cfg.resume_file and not self.exact_resume
        if self.dual:
            self.state = (NetRankState(nets[0], mesh.net_rank(), optimizer) if pair_rank
                          else DualTrainState(nets[0], nets[1], optimizer))
            if warm_start:
                # the kidney warm start from one net's export
                ckpt.warm_start_dual(
                    self.state, cfg.resume_file, cfg.coteach.warm_start_noise, cfg.seed
                )
            self.train_step = steps_mod.make_coteach_train_step(self.two_modal, cfg)
        else:
            self.state = TrainState(nets[0], optimizer)
            if warm_start:
                # weights only: the optimizer starts afresh
                nets[0].load_state_dict(ckpt.load_net(cfg.resume_file, nets[0]), strict=True)
            self.train_step = steps_mod.make_supervised_train_step(self.two_modal, cfg)
        if self.exact_resume:
            ckpt.load_train_state(cfg.resume_file, self.state)
        self.augment_batch = (
            steps_mod.make_augment_batch(cfg, self.two_modal) if cfg.data.augment_main else None
        )
        self.eval_step = steps_mod.make_eval_step(self.two_modal, cfg, dual=self.dual)
        self.predict_step = steps_mod.make_predict_step(self.two_modal, dual=self.dual)
        # whole-set inference and the fused test tail gather on the device,
        # so they need the device-resident data of one rank (a data axis
        # takes the per-batch paths, as in the JAX package); the fused tail
        # is the dual trainer's, whose per-image criterion masks the ragged
        # last batch
        single = self.device_resident and self.world == 1
        self.predict_all = steps_mod.make_predict_all(self.two_modal, self.dual) if single else None
        self.eval_predict_all = (
            steps_mod.make_eval_predict_all(self.two_modal, cfg) if single and self.dual else None
        )

        self.best_dice = 0.0
        # checkpoint_flush other than 'best' (the JAX trainer reads every
        # other value as 'end'): the best epoch's state (nets and
        # optimizer), cloned on the device, and its (meta, full_meta);
        # flush_checkpoints writes them
        self._best_snapshot: Optional[Dict] = None
        self._best_meta: Optional[tuple] = None
        # the kidney-style changepoint gate
        self.ascending = not cfg.ascending_checkpoint_gate
        self.changepoint_dice = 0.0
        self.history: List[Dict] = []
        self.start_epoch = 0
        if self.exact_resume:
            # the bookkeeping of the _full file's sidecar, as the JAX
            # trainer reads it
            meta = ckpt.read_meta(cfg.resume_file)
            self.start_epoch = int(meta.get("next_epoch", 0))
            self.best_dice = float(meta.get("best_dice", 0.0))
            self.ascending = bool(meta.get("ascending", self.ascending))
            self.changepoint_dice = float(meta.get("changepoint_dice", 0.0))
            self.history = list(meta.get("history", []))

    def _warn_mesh(self) -> None:
        """Say when a net axis replicates a single net (as the JAX trainer
        does), and when the ranks are fewer than the cards the config asks
        for (0: every visible card): launch shrank the data axis to divide
        the batches ("MESH SHRUNK", as the JAX trainer logs it), or this
        process runs one rank beside other visible cards."""
        net = mesh.net_size()
        if net > 1 and not self.dual:
            # a net axis only parallelizes the dual co-teaching pair
            self.logger.warning(
                "mesh 'net' axis (%d) configured but this is a single-net (%s) run — the state "
                "replicates over it; drop the axis or grow data/space instead",
                net, self.cfg.data.variant,
            )
        if self.cfg.mesh.coordinator_address:
            return
        visible = torch.cuda.device_count() if self.device.type == "cuda" else 1
        asked = self.cfg.mesh.num_devices or visible
        if asked <= self.world:
            return
        if self.world == 1 and mesh.fit_data_devices(mesh.data_batch(self.cfg), asked) > 1:
            self.logger.warning(
                "%d cards visible but this trainer runs as one rank on %s: a process that "
                "aide_tpu_torch.core.mesh.launch did not start trains on one card (the CLI's "
                "train runs one rank a card; mesh.num_devices=1 pins one)",
                asked, self.device,
            )
        else:
            self.logger.warning(mesh.shrunk_message(asked, self.cfg, mesh.data_size()))

    def _size_space_axis(self) -> None:
        """Turn a space axis off where it cannot split the images, with a
        warning: S not dividing img_size (the JAX trainer's check and
        words), or a level of the model whose rows a rank, img_size / (S *
        2^level), are not whole down to the last pool, or fewer than its
        widest halo (a dilated gate's dilation, else 1). Otherwise say how
        the TTA warps run: on the gathered source rows, into this shard's
        rows; an explicit 'gather' gets the JAX trainer's warning."""
        k = mesh.space_size()
        if k == 1:
            return
        size = self.cfg.data.img_size
        live = size % k == 0
        if not live:
            self.logger.warning(
                "mesh 'space' axis (%d) does not divide img_size=%d — spatial partitioning "
                "disabled", k, size)
        else:
            pools, halo = space_needs(self.cfg.model)
            rows = size // k
            deepest = rows >> pools
            if rows % (1 << pools) or deepest < halo:
                live = False
                self.logger.warning(
                    "mesh 'space' axis (%d): img_size=%d leaves %s rows a rank at level %d of "
                    "%s, whose pools need whole rows and whose widest halo is %d rows — "
                    "spatial partitioning disabled; the space ranks run as replicas",
                    k, size, f"{rows / (1 << pools):g}", pools + 1, self.cfg.model.name, halo)
        mesh.set_space_live(live)
        if not live:
            return
        wm = self.cfg.data.warp_method
        if wm == "gather":
            self.logger.warning(
                f"data.warp_method={wm!r} with an active space axis: the partitioner will "
                "all-gather the batch around it — expect degraded scaling; use 'auto'/'shear'")
        else:
            self.logger.info(
                "space axis active: each TTA warp all-gathers its source rows over the space "
                "group and writes this rank's %d output rows (data.warp_method=%r)",
                size // k, wm)

    # ------------------------------------------------------------------

    def view_params(self, epoch: int, step: int, batch: int):
        """(V, B) TTA rotation angles and flip flags of one train step of a
        global batch of B, from a generator seeded by (seed, epoch, step):
        the same on every rank, which takes its columns. Tests replace this
        method to inject another stream."""
        gen = prng.generator(self.device, self.cfg.seed, epoch, step)
        d = self.cfg.data
        return tta.sample_view_params(gen, d.num_tta_views, batch, d.rotation_degree, d.hflip_prob)

    def augment_params(self, epoch: int, step: int, batch: int):
        """(B,) rotation angles and flip flags of one train step's main-view
        augmentation (data.augment_main), from a generator seeded by (seed,
        epoch, 1_000_000 + step): the JAX package's key offset, a stream
        apart from the step's views. Tests replace this method to inject
        another stream."""
        gen = prng.generator(self.device, self.cfg.seed, epoch, 1_000_000 + step)
        d = self.cfg.data
        degrees, hflip = tta.sample_view_params(gen, 1, batch, d.rotation_degree, d.hflip_prob)
        return degrees[0], hflip[0]

    def _on_device(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.device_resident:
            return batch
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    def _predict_batch(self, state, batch) -> torch.Tensor:
        """predict_step on a case-evaluation batch, moved to the device
        first when the pipe serves host batches. Over a data axis the batch
        is this rank's rows of a full eval batch (N divides it), and the
        labels of all ranks' rows are fetched; on a live space axis its H
        rows, and the labels' rows are fetched first."""
        spatial = mesh.h_sharded(self.cfg.data.eval_batch_size)
        labels = self.predict_step(state, self._on_device(batch), *((True,) if spatial else ()))
        if spatial:
            labels = mesh.fetch_h(labels, dim=2 if self.dual else 1)
        if mesh.data_size() == 1:
            return labels
        if not self.dual:
            return mesh.fetch(labels)
        return mesh.fetch(labels.transpose(0, 1)).transpose(0, 1)

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
        # every train batch is a full global batch (drop_last); a rank holds
        # its rows of it and takes its columns of the global view draws
        b = cfg.data.batch_size
        rows, sharded, spatial = mesh.local_rows(b), mesh.rows_sharded(b), mesh.h_sharded(b)
        batches = iter(self.train_pipe.batches(b, rng=shuffle_rng))
        for i in itertools.count():
            # the feed: the next batch (the last call finds none), its move
            # to the device, the augment and view draws
            with trace.span("train.data"):
                batch = next(batches, None)
                if batch is None:
                    break
                batch = self._on_device(batch)
                if self.augment_batch is not None:
                    degrees, hflip = self.augment_params(epoch, i, b)
                    batch = self.augment_batch(batch, degrees[rows], hflip[rows],
                                               *((True,) if spatial else ()))
                if self.dual:
                    degrees, hflip = self.view_params(epoch, i, b)
                    args = (batch, degrees[:, rows], hflip[:, rows], rate)
                else:
                    args = (batch,)
            # ``sharded`` (and ``spatial``) only over a data (space) axis: a
            # step wrapped with positional arguments sees the single-card call
            m = self.train_step(self.state, *args, *self._flags(sharded, spatial))
            totals = self._accumulate(totals, m)
            if cfg.log_every_steps and (i + 1) % cfg.log_every_steps == 0:
                # opt-in mid-epoch visibility; each line costs a host sync
                vals = " ".join(
                    "%s: %.3f" % (k, float(v)) for k, v in sorted(m.items()) if k.startswith("loss")
                )
                self.logger.info("epoch %d step %d | %s", epoch + 1, i + 1, vals)
        return self._finalize(totals)

    @staticmethod
    def _flags(sharded: bool, spatial: bool) -> tuple:
        """The steps' trailing (sharded, spatial) arguments, as far as they
        are needed."""
        if spatial:
            return sharded, True
        return (sharded,) if mesh.data_size() > 1 else ()

    def _test_epoch(self) -> Dict[str, float]:
        totals: Optional[dict] = None
        eb, n = self.cfg.data.eval_batch_size, len(self.test_pipe)
        batches = self.test_pipe.batches(eb, shuffle=False, drop_last=False)
        for start, batch in zip(range(0, n, eb), batches):
            batch = self._on_device(batch)
            if self.dual:
                batch = dict(batch, target1=batch["target"], target2=batch["target"])
            # the ragged last batch of a data axis runs replicated, on whole
            # images: the metrics are the whole batch's on every rank,
            # counted once
            rows = min(eb, n - start)
            flags = self._flags(mesh.rows_sharded(rows), mesh.h_sharded(rows))
            totals = self._accumulate(totals, self.eval_step(self.state, batch, *flags))
        return self._finalize(totals)

    def _dispatch_fused_test(self):
        """Queue the fused test pass (metrics and test-case labels in one
        loop); return a closure giving (test_metrics, testcase_results), or
        None where it does not apply: data that is not on the device, or a
        test-case list that does not cover the test pipe once (the metrics
        come from the same packed stream, so partial cover would change
        them)."""
        if self.eval_predict_all is None:
            return None
        pipe = self.test_pipe
        eb = self.cfg.data.eval_batch_size
        case_ids, counts, n, padded = pack_case_stream(pipe, self.test_cases, eb)
        if n != len(pipe) or len(set(padded[:n].tolist())) != n:
            return None
        with trace.span("cases.dispatch"):
            idx_mat = padded.reshape(-1, eb)
            valid = (np.arange(idx_mat.size) < n).astype(np.float32).reshape(idx_mat.shape)
            totals, labels = self.eval_predict_all(self.state, pipe._device_data, idx_mat, valid)
            keys = list(totals)
            wait_totals = start_host_copy(torch.stack([totals[k].float() for k in keys]))
            wait_labels = start_host_copy(labels)
        keep_cc = self.cfg.eval.keep_largest_cc

        def finish():
            with trace.span("cases.fetch"):
                host = dict(zip(keys, wait_totals().tolist()))
                out = wait_labels()  # (N, 2, B, H, W)
            with trace.span("cases.cc"):
                count = max(float(host.pop("count")), 1.0)
                test_m = {k: float(v) / count for k, v in host.items()}
                preds = np.moveaxis(out, 1, 0).reshape(2, -1, *out.shape[3:])[:, :n]
                volumes, offset = [], 0
                for cnt in counts:
                    volumes.append(_postprocess_case(preds[:, offset : offset + cnt], keep_cc))
                    offset += cnt
            testcase = score_case_volumes(pipe, case_ids, volumes, target_net=None)
            return test_m, testcase

        return finish

    def _start_cases(self, pipe, cases, target_net, keep_volumes=False):
        """Queue the nets' case evaluation of ``cases`` of ``pipe``; return
        the closure that scores them (case_eval.start_case_evaluation)."""
        return start_case_evaluation(
            self._predict_batch, self.state, pipe, cases, self.cfg.data.eval_batch_size,
            target_net=target_net, keep_largest_cc=self.cfg.eval.keep_largest_cc,
            keep_volumes=keep_volumes, predict_all=self.predict_all, dual=self.dual,
        )

    # ------------------------------ refresh ------------------------------

    def _refresh_labels(self, epoch: int, traincase_results) -> None:
        """Overwrite the working labels of the worst update_percent cases
        per net with the net's post-CC prediction, sync them to the device,
        then call ``on_refresh(epoch)`` when it is set. Every rank of a
        data, net or space axis calls it with the same labels, so a hook
        that prints must print on the primary rank alone."""
        cfg = self.cfg
        k = int(cfg.coteach.update_percent * len(self.train_cases))
        if cfg.coteach.engagement_check and self._bootstrap_labels is None:
            # snapshot the pre-refresh (bootstrap) labels + structural check
            self._bootstrap_labels = {n: self.train_pipe.labels.get(n).copy() for n in (1, 2)}
            self._structural_refresh_check(k)
        for net_idx in range(2):
            results = traincase_results[net_idx]
            # on the host, as the JAX package sorts, so ties break alike
            order = np.argsort([r.dice for r in results])
            selected, refreshed = [], []
            for sel in order[:k]:
                r = results[sel]
                selected.append(r.case_id)
                if r.case_id in self.label_cases:
                    continue  # labeled cases are never rewritten
                vol = r.pred_volume
                if cfg.coteach.refresh_skip_empty and vol.sum() == 0:
                    trace.add("refresh.skipped_empty", len(vol))
                    continue  # the kidney convention
                idxs = self.train_pipe.case_indices(r.case_id)
                trace.add("refresh.images", len(idxs))
                # every rank updates its labels, the primary writes the files
                self.train_pipe.labels.refresh_case(net_idx + 1, idxs, vol,
                                                    mirror=mesh.is_primary())
                refreshed.append(r.case_id)
            # the FULL worst-k selection, labeled and skipped cases included,
            # as the reference prints it; the rewritten subset where it differs
            self.logger.info("Mask {} modify for net{}".format(selected, net_idx + 1))
            self.refresh_log.append((epoch, net_idx + 1, tuple(selected), tuple(refreshed)))
            if refreshed != selected:
                self.logger.info(
                    "  (rewritten for net{}: {} — labeled/empty cases "
                    "skipped)".format(net_idx + 1, refreshed)
                )
        with trace.span("refresh.sync"):
            self.train_pipe.sync_labels_to_device()
        if self.on_refresh is not None:
            self.on_refresh(epoch)

    def _is_refresh_epoch(self, epoch: int) -> bool:
        e1 = epoch + 1
        return e1 <= self.cfg.coteach.warmup_epochs or (
            e1 % self.cfg.coteach.refresh_interval == 0
        )

    # --------------------------- engagement ---------------------------

    def _structural_refresh_check(self, k: int) -> bool:
        """Label half-life check, once, at the first refresh: with
        ``n_refreshable`` rewritable cases and the worst ``k`` rewritten per
        warmup epoch, a case's bootstrap labels survive ``n_refreshable / k``
        epochs on average. Under ~3 the bootstrap label information is gone
        before the nets can learn it, and fresh-init co-teaching trains on
        its own early noise (the reference's flagship has 30/7 ~ 4.3)."""
        n_refreshable = sum(1 for c in self.train_cases if str(c) not in self.label_cases)
        half_life = n_refreshable / max(k, 1)
        ok = half_life >= 3.0 or k == 0
        if not ok and not self._structural_warned:
            self._structural_warned = True
            self.logger.warning(
                "STRUCTURAL REFRESH CHECK FAILED: %d refreshable cases with "
                "worst-%d rewritten per refresh epoch — label half-life "
                "%.1f epochs (< 3). Bootstrap label information will not "
                "survive the warmup ramp; fresh-init co-teaching degrades "
                "into self-training on early noise. Mitigate with more "
                "unlabeled cases, a smaller coteach.update_percent, a "
                "larger refresh_interval, or a pretrain warm start "
                "(resume_file).",
                n_refreshable, k, half_life,
            )
        return ok

    def _bootstrap_skill_probe(self) -> None:
        """Layer 0 of the engagement guardrail: before the first train step,
        score the warm-started nets on the labeled (clean) cases. In the
        transfer protocol the bootstrap working labels are the same source
        model's predictions, so this dice reads the bootstrap label quality
        without an oracle: the axis of the ~0.2 engagement cliff. After even
        one epoch the nets have fit the labeled cases and the reading is
        contaminated upward."""
        cases = sorted(self.label_cases)
        finish = start_case_evaluation(
            self._predict_batch, self.state, self.train_pipe, cases,
            self.cfg.data.eval_batch_size, target_net="self" if self.dual else None,
            keep_largest_cc=self.cfg.eval.keep_largest_cc, dual=self.dual,
        )
        res = finish()
        self.engagement_probe = {
            f"bootstrap_skill{n + 1}": float(np.mean([r.dice for r in res[n]])) for n in res
        }
        ms = self.cfg.coteach.engagement_min_bootstrap_skill
        vals = tuple(self.engagement_probe.values())
        if min(vals) < ms:
            self.logger.warning(
                "BOOTSTRAP SKILL PROBE below the engagement cliff: "
                "warm-started nets score %.3f/%.3f case dice on the "
                "labeled clean cases (threshold %.2f). In the transfer "
                "protocol this is the bootstrap label quality — below the "
                "~0.2 cliff the refresh loop cannot mine real quality and "
                "the end state lands under its own pretrain "
                "(experiments/RESULTS.md transfer table). RECOMMENDATION: "
                "abstain — deploy the pretrain/bootstrap weights. The "
                "end-of-ramp verdict will record engaged=false.",
                *(list(vals) + [ms]),
            )
        else:
            self.logger.info(
                "bootstrap skill probe: %.3f/%.3f case dice on labeled "
                "cases (cliff threshold %.2f)", *(list(vals) + [ms]),
            )

    def _engagement_signals(self, traincase) -> Dict[str, float]:
        """Whether the refresh is engaging: cross-net agreement Dice over the
        train-case predictions, and each net's predicted over bootstrap
        label foreground volume. Host counts over volumes the epoch already
        has."""
        inter = 0
        fg = [0, 0]
        for r1, r2 in zip(traincase[0], traincase[1]):
            v1 = r1.pred_volume > 0
            v2 = r2.pred_volume > 0
            inter += int(np.count_nonzero(v1 & v2))
            fg[0] += int(np.count_nonzero(v1))
            fg[1] += int(np.count_nonzero(v2))
        denom = fg[0] + fg[1]
        crossnet = 1.0 if denom == 0 else 2.0 * inter / denom
        if self._label_fg_cache is None:
            # the bootstrap labels once snapshotted (a refresh rewrites the
            # current labels to the nets' own predictions, which would make
            # the ratio ~1 even in a collapsed run); before any refresh the
            # current labels are the bootstrap. Counted once.
            src = self._bootstrap_labels or {n: self.train_pipe.labels.get(n) for n in (1, 2)}
            self._label_fg_cache = [max(int(np.count_nonzero(src[n])), 1) for n in (1, 2)]
        label_fg = self._label_fg_cache
        return {
            "crossnet_dice": crossnet,
            "fg_ratio1": fg[0] / label_fg[0],
            "fg_ratio2": fg[1] / label_fg[1],
        }

    def _engagement_verdict(self, eng: Dict[str, float]) -> bool:
        """The end-of-ramp verdict (epoch == coteach.warmup_epochs): True
        when the run looks engaged; otherwise it logs the ABSTAIN
        recommendation, to fall back to the pretrain/bootstrap weights."""
        ct = self.cfg.coteach
        lo, hi = ct.engagement_fg_band
        ok = (
            eng["crossnet_dice"] >= ct.engagement_min_agreement
            and lo <= eng["fg_ratio1"] <= hi
            and lo <= eng["fg_ratio2"] <= hi
        )
        # bootstrap retention (Dice of current vs bootstrap labels): logged
        # and recorded, not thresholded
        if self._bootstrap_labels is not None:
            eng = dict(
                eng,
                bootstrap_retention1=dice3d_np(
                    self.train_pipe.labels.get(1), self._bootstrap_labels[1]
                ),
                bootstrap_retention2=dice3d_np(
                    self.train_pipe.labels.get(2), self._bootstrap_labels[2]
                ),
            )
        if self._structural_warned:
            # the half-life check failed at the first refresh
            ok = False
        probe_ok = True
        band = None
        if self.engagement_probe is not None:
            eng = dict(eng, **self.engagement_probe)
            q = min(self.engagement_probe.values())
            if q < ct.engagement_min_bootstrap_skill:
                # below the cliff the ramp-end signals are self-consistent
                # but vacuous; the probe is the signal that sees it
                band, probe_ok, ok = "below_cliff", False, False
            elif q < ct.engagement_clear_skill:
                band = "transition"
                self.logger.warning(
                    "bootstrap quality %.3f is in the transition band "
                    "[%.2f, %.2f): the margin over pretrain is an inverted "
                    "U here and can be negative (a->m seed 23: +0.073 over "
                    "naive, -0.049 vs its own pretrain). CAUTION: validate "
                    "the deployed checkpoint against the pretrain weights "
                    "on target validation data before shipping.",
                    q, ct.engagement_min_bootstrap_skill, ct.engagement_clear_skill,
                )
            else:
                band = "clear"
        self.engagement = {
            **eng, "engaged": ok, "structural_ok": not self._structural_warned,
            "bootstrap_skill_ok": probe_ok,
            **({"bootstrap_band": band} if band else {}),
        }
        if ok:
            self.logger.info(
                "engagement check OK at end of ramp: cross-net agreement "
                "%.3f, fg ratios %.2f/%.2f",
                eng["crossnet_dice"], eng["fg_ratio1"], eng["fg_ratio2"],
            )
        else:
            self.logger.warning(
                "ENGAGEMENT CHECK FAILED at end of warmup ramp: cross-net "
                "agreement %.3f (min %.3f), predicted-vs-bootstrap-label "
                "foreground ratios %.2f/%.2f (band %.2f-%.2f), structural "
                "half-life check %s. The co-teaching refresh is not "
                "engaging — typical causes: bootstrap working labels below "
                "the ~0.2-quality cliff, a collapsed net, or too few "
                "refreshable cases per rewrite. RECOMMENDATION: abstain — "
                "deploy the pretrain/bootstrap weights instead of this "
                "run's checkpoints (experiments/RESULTS.md, transfer "
                "ladder).",
                eng["crossnet_dice"], ct.engagement_min_agreement,
                eng["fg_ratio1"], eng["fg_ratio2"], lo, hi,
                "failed" if self._structural_warned else "passed",
            )
        return ok

    # ---------------------------- checkpoint ----------------------------

    def _bookkeeping_meta(self, next_epoch: int) -> Dict:
        """The resume bookkeeping of a _full file's sidecar."""
        return {
            "next_epoch": int(next_epoch),
            "best_dice": float(self.best_dice),
            "ascending": bool(self.ascending),
            "changepoint_dice": float(self.changepoint_dice),
            "history": list(self.history),
        }

    def _maybe_checkpoint(self, epoch: int, avg_dice: float, test_metrics, epoch_row) -> bool:
        """The best-checkpoint gate on the mean train-case dice, behind the
        optional ascending (changepoint) gate. The supervised export embeds
        the history: the earlier rows without their time keys, and this
        epoch's ``epoch_row``."""
        cfg = self.cfg
        if cfg.ascending_checkpoint_gate and not self.ascending:
            if epoch > 0 and self.changepoint_dice < avg_dice:
                self.ascending = True
                self.best_dice = self.changepoint_dice
            else:
                self.changepoint_dice = avg_dice
                trace.add("ckpt.gate_closed")
                return False
        if avg_dice <= self.best_dice:
            return False
        self.best_dice = avg_dice
        self.logger.info("Best Checkpoint {} Saving...".format(epoch + 1))
        meta = {
            "epoch": epoch + 1,
            "traincase_dice": avg_dice,
            **{k: float(v) for k, v in test_metrics.items()},
        }
        if not self.dual:
            hist = [{k: v for k, v in r.items() if not k.startswith("time")} for r in self.history]
            meta["history"] = hist + [epoch_row]
        # the _full file's bookkeeping replays this epoch on resume (its
        # refresh and history row come after this save); _last_full is the
        # exact continuation
        full_meta = dict(meta, **self._bookkeeping_meta(epoch))
        snap = self._file_snapshot(clone=cfg.checkpoint_flush != "best")
        if snap is None:
            # the primary rank writes the files; the others keep no snapshot
            return True
        if cfg.checkpoint_flush == "best":
            ckpt.save_best(cfg.checkpoint_dir, cfg.experiment_name, snap, meta, full_meta)
        else:
            self._best_snapshot = snap
            self._best_meta = (meta, full_meta)
        # back up the best epoch's tempmask folder, as the prostate trainers
        # do; gate and path read the same field, so an empty folder name
        # never copies the dataset root
        if self.dual and self.task.tempmask_folder:
            src = os.path.join(self.task.root, self.task.tempmask_folder)
            if os.path.isdir(src):
                with trace.span("ckpt.backup"):
                    shutil.copytree(src, src.rstrip("/") + "_best", dirs_exist_ok=True)
        return True

    def _file_snapshot(self, clone: bool) -> Optional[Dict]:
        """The state's snapshot for the files on the primary rank, None on
        the others. On a net axis the primary's partner sends its net (a
        collective of their pair)."""
        partner = (isinstance(self.state, NetRankState) and mesh.data_rank() == 0
                   and mesh.space_rank() == 0)
        if not (mesh.is_primary() or partner):
            return None
        with trace.span("ckpt.snapshot"):
            snap = ckpt.snapshot(self.state, clone=clone)
        return snap if mesh.is_primary() else None

    def flush_checkpoints(self) -> None:
        """Write the best epoch's snapshot (any checkpoint_flush but
        'best'); a no-op when the files were written at once or no epoch
        was best."""
        if self._best_snapshot is None:
            return
        ckpt.save_best(
            self.cfg.checkpoint_dir, self.cfg.experiment_name,
            self._best_snapshot, *self._best_meta,
        )

    # ------------------------------- run -------------------------------

    def run_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch (the module's docstring); returns its history row, whose
        keys are the JAX trainer's. Its ``time_*`` keys are host seconds of
        the epoch's spans (``core.trace``), rounded to 10 ms: the phases
        ``time_train``, ``time_test``, ``time_cases``, ``time_ckpt``,
        ``time_refresh``, and within the case phases ``time_cases_fetch``
        (case dispatch and the wait for the labels) and ``time_cases_host``
        (largest component and scoring); ``time`` is the whole epoch. The
        end of the epoch is marked ``("epoch", row["epoch"])`` for readers
        of the other spans (``trace.mark``)."""
        cfg = self.cfg
        before = trace.totals()
        rate = rate_schedule(epoch, cfg.coteach.warmup_epochs) if self.dual else 0.0
        with trace.span("epoch"):
            with trace.span("epoch.train"):
                train_m = self._train_epoch(epoch, rate)
            with trace.span("epoch.test"):
                fused_finish = self._dispatch_fused_test()
                if fused_finish is None:
                    test_m = self._test_epoch()
                else:
                    # the train-case re-inference is queued behind the fused
                    # test pass, so the host's CC of the test cases overlaps it
                    finish_traincase = self._start_cases(
                        self.train_pipe, self.train_cases, "self", keep_volumes=True)
                    test_m, testcase = fused_finish()
            with trace.span("epoch.cases"):
                if fused_finish is None:
                    finish_testcase = self._start_cases(self.test_pipe, self.test_cases, None)
                    finish_traincase = self._start_cases(
                        self.train_pipe, self.train_cases, "self" if self.dual else None,
                        keep_volumes=self.dual,
                    )
                    testcase = finish_testcase()
                traincase = finish_traincase()

            with trace.span("epoch.ckpt"):
                case_means = {
                    f"traincase_dice{n + 1}": float(np.mean([r.dice for r in traincase[n]]))
                    for n in traincase
                }
                case_means.update({
                    f"testcase_dice{n + 1}": float(np.mean([r.dice for r in testcase[n]]))
                    for n in testcase
                })
                if self.dual:
                    avg_dice = (case_means["traincase_dice1"]
                                + case_means["traincase_dice2"]) / 2.0
                else:
                    avg_dice = case_means["traincase_dice1"]

                row_metrics = {
                    "epoch": epoch + 1,
                    **{f"train_{k}": v for k, v in train_m.items()},
                    **{f"test_{k}": v for k, v in test_m.items()},
                    **case_means,
                }
                if self.dual and cfg.coteach.engagement_check:
                    eng = self._engagement_signals(traincase)
                    row_metrics["crossnet_dice"] = eng["crossnet_dice"]
                    if epoch + 1 == cfg.coteach.warmup_epochs:
                        self._engagement_verdict(eng)
                self._maybe_checkpoint(epoch, avg_dice, test_m, row_metrics)
            with trace.span("epoch.refresh"):
                if self.dual and self._is_refresh_epoch(epoch):
                    self._refresh_labels(epoch, traincase)

        trace.mark(("epoch", epoch + 1))
        spent = trace.delta(before)
        row = {
            **row_metrics,
            **{f"time_{p}": round(trace.seconds(spent, f"epoch.{p}"), 2)
               for p in ("train", "test", "cases", "ckpt", "refresh")},
            "time_cases_fetch": round(trace.seconds(spent, "cases.dispatch", "cases.fetch"), 2),
            "time_cases_host": round(trace.seconds(spent, "cases.cc", "cases.score"), 2),
            "time": trace.seconds(spent, "epoch"),
        }
        self.history.append(row)
        self._log_epoch(row)
        return row

    def _log_epoch(self, row: Dict[str, float]) -> None:
        e = row["epoch"]
        if not self.dual:
            self.logger.info(
                "epoch[%d/%d]: train_loss: %.3f | test_loss: %.3f | "
                "train_dice: %.3f | test_dice: %.3f || traincase_dice: %.3f || "
                "testcase_dice: %.3f || time: %.1f"
                % (
                    e, self.cfg.num_epochs, row.get("train_loss", 0.0),
                    row.get("test_loss", 0.0), row.get("train_dice_sum", 0.0),
                    row.get("test_dice_sum", 0.0),
                    row.get("traincase_dice1", 0.0),
                    row.get("testcase_dice1", 0.0), row["time"],
                )
            )
            return
        for n in (1, 2):
            self.logger.info(
                "epoch[%d/%d]: train_loss%d: %.3f | test_loss%d: %.3f | "
                "train_dice%d: %.3f | test_dice%d: %.3f || "
                "traincase_dice%d: %.3f || testcase_dice%d: %.3f || time: %.1f"
                % (
                    e, self.cfg.num_epochs, n, row.get(f"train_loss{n}", 0.0),
                    n, row.get(f"test_loss{n}", 0.0),
                    n, row.get(f"train_dice{n}_sum", 0.0),
                    n, row.get(f"test_dice{n}_sum", 0.0),
                    n, row.get(f"traincase_dice{n}", 0.0),
                    n, row.get(f"testcase_dice{n}", 0.0),
                    row["time"],
                )
            )

    def run(self, num_epochs: Optional[int] = None) -> List[Dict]:
        # explicit None check: run(0) is a no-op, not the full run
        n = self.cfg.num_epochs if num_epochs is None else num_epochs
        self.logger.info("Start Training ({})".format(self.cfg.data.task))
        if self.start_epoch:
            self.logger.info("Resuming at epoch %d", self.start_epoch + 1)
        if (
            self.dual
            and self.cfg.coteach.engagement_check
            and self.engagement_probe is None
            and self.start_epoch == 0
            and n > 0
            and self.cfg.resume_file
            and not self.exact_resume
            and self.label_cases
        ):
            # a warm-started dual run: the bootstrap skill before the first
            # train step (see _bootstrap_skill_probe)
            self._bootstrap_skill_probe()
        try:
            for epoch in range(self.start_epoch, n):
                self.run_epoch(epoch)
            unwinding = False
        except BaseException:
            unwinding = True
            raise
        finally:
            # a failure mid-run must not lose the best epoch's snapshot or
            # the history; a flush failure while unwinding is logged so that
            # the original error propagates
            try:
                self._save_history()
                self.flush_checkpoints()
            except Exception:
                if not unwinding:
                    raise
                self.logger.exception("failure-path checkpoint/history flush failed")
        # the exact continuation: the state at the end of epoch n, with the
        # epoch clock, the gates and the history in the sidecar
        snap = self._file_snapshot(clone=False)
        if snap is not None:
            ckpt.save_train_state(
                ckpt.full_path(self.cfg.checkpoint_dir, self.cfg.experiment_name, last=True),
                snap, self._bookkeeping_meta(n),
            )
        return self.history

    def _save_history(self) -> None:
        """The epoch rows, as JSON, to {history_dir}/{experiment_name}_history.json
        (the primary rank's)."""
        if not mesh.is_primary():
            return
        os.makedirs(self.cfg.history_dir, exist_ok=True)
        path = os.path.join(self.cfg.history_dir, f"{self.cfg.experiment_name}_history.json")
        with open(path, "w") as fh:
            json.dump(self.history, fh, indent=2)
