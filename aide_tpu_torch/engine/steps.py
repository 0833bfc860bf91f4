"""The train steps (co-teaching and supervised), the eval steps and the
predict programs.

``make_coteach_train_step`` is the counterpart of
``aide_tpu.engine.steps.make_coteach_train_step``, in this order: TTA views
of both modalities (one warp each) -> both nets' view forwards (views folded
into the batch; train-mode BN that leaves the running stats alone) -> one
inverse warp over both nets' views -> f32 softmax average, sharpen,
weightmap -> the main forwards -> per-image loss ranking -> cross small-loss
split -> seg + confidence-weighted consistency losses -> one backward over
both nets -> one AMSGrad update. The cross terms (pseudo-labels, weightmaps,
ranking order) are detached, so one backward of loss1 + loss2 gives each
net exactly its own gradient.

The view parameters come in as arguments (the trainer draws them), so a
test can hand the step the JAX package's stream.

Each train step opens the span ``train.step`` (``core.trace``) around
``step.views`` (co-teaching), ``step.forward``, ``step.backward``,
``step.optimizer`` and ``step.metrics``: inside any wrapper that a caller
puts on ``Trainer.train_step``. Inside ``train.step`` the step's device
work runs through ``engine.graphs.StepGraphs``: on one card as a replayed
CUDA graph, whose steps close no ``step.*`` span, elsewhere eagerly. The
per-step host numbers (the co-teaching rate's ``1 - rate`` and
``consistency_weight * rate``, the optimizer's ``hyper()``) reach the
device work as one f32 vector, with the values the Python floats had.

``make_supervised_train_step`` is the comparison trainer's step: one
forward in train-mode BN that updates the running stats, the scalar
criterion (``make_criterion``), one backward and one AMSGrad update.

Over a data axis of N > 1 shards (``core.mesh``) each step takes its
rank's rows of the global batch (``sharded=True``) and keeps the JAX step's
global semantics: BatchNorm statistics over the global batch
(``models.blocks.global_batch_stats``, around the forwards and the
backward), and the losses, the small-loss ranking, its
clean count and the metrics computed on the rows of every rank, gathered
(the logits through ``mesh.gather_rows``, whose reduce-scatter backward
gives each rank the gradient of its own rows when every rank backpropagates
L/N). The gradients are then summed over the ranks in one all-reduce, so
every rank takes the same update. A replicated batch (``sharded=False``)
is the whole batch on every rank, computed as one rank would.

On a net axis (``engine.state.NetRankState``) a rank runs net k of the
pair alone, in the same order: its view forwards, its inverse warp (V*b
views, not 2*V*b), its main forward, its loss and backward; the collectives
of the data axis run over its net's data group, and what the other net's
loss needs (pseudo-labels, weight map, the per-image losses that rank the
rows) crosses the pair without gradient in ``mesh.pair_exchange``. The
clipping norm spans the pair (``ops.schedules``). Every rank returns the
pair's metrics, as one process does.

On a space axis of S > 1 shards a step of a spatial batch
(``spatial=True``: every image-like leaf holds this rank's rows
[s*H/S, (s+1)*H/S), ``mesh.shard_rows``) runs the nets on those rows
inside ``models.blocks.space_partition``. Each TTA warp first fetches the
whole source images over the space group (one collective) and writes this
rank's output rows alone (``rows``: the kernel's row window); the TTA
epilogue is per pixel and stays local. The main logits are gathered to
whole images with ``mesh.gather_h`` (and the pseudo-labels, weight maps
and targets with ``mesh.fetch_h``) before the data axis's gathers, so the
losses, the ranking and the metrics run on whole images as one process
does; every rank backpropagates L / (data x space), and the gradients and
BatchNorm statistics are summed over the replica group (``mesh.replicas``).
The eval and predict steps take the same flag; their callers gather the
labels' rows.

``make_augment_batch`` is the main-view augmentation of ``data.augment_main``
(``aide_tpu.engine.steps.make_augment_batch``): one rotation and flip per
image, shared by the images and the targets of the batch.

The eval steps and predict programs (``make_eval_step``,
``make_predict_step``, ``make_predict_all``, ``make_eval_predict_all``) run
the nets without gradients in eval-mode BN under the model's own autocast,
and give argmax labels as uint8; ``dual`` selects the pair or the single
net, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aide_tpu_torch.core import mesh, trace
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.engine.graphs import StepGraphs
from aide_tpu_torch.engine.state import DualTrainState, NetRankState, TrainState
from aide_tpu_torch.models import blocks
from aide_tpu_torch.ops import losses, metrics, tta, warp


def batch_images(batch: Dict[str, torch.Tensor], two_modal: bool) -> Tuple[torch.Tensor, ...]:
    """Batch images, normalized on the device when shipped as uint8:
    u8 * scale + fill per image and channel. Float images pass unchanged."""
    names = ("modal1", "modal2") if two_modal else ("image",)
    suffixes = ("1", "2") if two_modal else ("",)
    out = []
    for name, suf in zip(names, suffixes):
        img = batch[name]
        if img.dtype == torch.uint8:
            img = (
                img.to(torch.float32) * batch[f"scale{suf}"][:, None, None, :]
                + batch[f"fill{suf}"][:, None, None, :]
            )
        out.append(img)
    return tuple(out)


def batch_fills(batch: Dict[str, torch.Tensor], two_modal: bool) -> Tuple[torch.Tensor, ...]:
    if two_modal:
        return (batch["fill1"], batch["fill2"])
    return (batch["fill"],)


def make_criterion(cfg: TrainConfig):
    """Scalar criterion of supervised training (optim.loss ce | dice |
    cedice) with the coteach section's class weights."""
    ct = cfg.coteach
    if cfg.optim.loss == "ce":
        return lambda logits, t: losses.cross_entropy_2d(logits, t, class_weight=ct.ceclass_weight)
    if cfg.optim.loss == "dice":
        return lambda logits, t: losses.multiclass_dice_loss(
            logits, t, class_weight=ct.diceclass_weight
        )
    if cfg.optim.loss == "cedice":
        return lambda logits, t: losses.cem_dice_loss(
            logits,
            t,
            cedice_weight=ct.cedice_weight,
            ceclass_weight=ct.ceclass_weight,
            diceclass_weight=ct.diceclass_weight,
        )
    raise ValueError(f"unknown loss {cfg.optim.loss!r}")


def make_image_criterion(cfg: TrainConfig):
    """Per-image loss vector (CE + Dice) used for ranking."""
    ct = cfg.coteach
    return lambda logits, t: losses.cem_dice_loss_image(
        logits,
        t,
        cedice_weight=ct.cedice_weight,
        ceclass_weight=ct.ceclass_weight,
        diceclass_weight=ct.diceclass_weight,
    )


TARGETS = ("target", "target1", "target2")


@functools.lru_cache(maxsize=None)
def batch_count(b: int, device: torch.device) -> torch.Tensor:
    """The ``count`` metric of a train step over b images: one f32
    constant a batch size and device, filled on the device once (no copy
    from the host, no wait). Read only: callers add it, never into it."""
    return torch.full((), float(b), dtype=torch.float32, device=device)


def _window(local: torch.Tensor):
    """(row0, R): this space shard's output rows of a warp, from its (B, R,
    W, C) local rows."""
    h = local.shape[1]
    return mesh.space_rank() * h, h


def _whole(spatial: bool, *tensors, dim: int = 1):
    """The tensors' whole images (``mesh.fetch_h``) on a spatial batch; as
    they are otherwise."""
    if not spatial:
        return tensors if len(tensors) > 1 else tensors[0]
    return mesh.fetch_h(*tensors, dim=dim)


def make_augment_batch(cfg: TrainConfig, two_modal: bool):
    """augment(batch, degrees, hflip) -> the batch with its main view
    warped: each image rotated by its (B,) ``degrees`` then flipped where
    ``hflip``, normalised first and filled with its own per-image fill;
    each target in the batch (``target``, and ``target1``, ``target2`` of a
    dual batch) warped as a one-hot map with fill 0 and taken back to its
    dtype by argmax, so that pixels from outside the source are background.

    The warps of a step share one launch per kind: both modalities (the
    same C) in one, all targets in another, so two launches a step on the
    card whatever the batch holds; each image's warp is its own, so this
    equals a launch per tensor. A ``spatial`` batch (this rank's rows of a
    space axis) fetches the whole images and targets over the space group
    in one collective and keeps its own output rows."""
    num_classes = cfg.model.num_classes
    wm = cfg.data.warp_method
    names = ("modal1", "modal2") if two_modal else ("image",)

    @torch.no_grad()
    def augment(batch, degrees, hflip, spatial: bool = False) -> Dict[str, torch.Tensor]:
        images = torch.cat(batch_images(batch, two_modal))
        tnames = [t for t in TARGETS if t in batch]
        targets = torch.cat([batch[t] for t in tnames])
        window = _window(images) if spatial else None
        if spatial:
            images, targets = mesh.fetch_h(images, targets)
        b = batch[tnames[0]].shape[0]
        out = dict(batch)
        k = len(names)
        warped = warp.augment(images, degrees.repeat(k), hflip.repeat(k),
                              torch.cat(batch_fills(batch, two_modal)), method=wm, rows=window)
        out.update(zip(names, warped.split(b)))
        k = len(tnames)
        onehot = F.one_hot(targets.long(), num_classes).float()
        maps = warp.augment(onehot, degrees.repeat(k), hflip.repeat(k), 0.0, method=wm,
                            rows=window)
        for t, m in zip(tnames, maps.split(b)):
            out[t] = m.argmax(dim=-1).to(batch[t].dtype)
        return out

    return augment


def make_supervised_train_step(two_modal: bool, cfg: TrainConfig):
    """step(state, batch, sharded=False, spatial=False) -> metrics {loss, dice_sum, count}
    of the global batch; updates ``state`` in place (parameters, BN running
    stats, optimizer moments)."""
    criterion = make_criterion(cfg)
    thr = cfg.eval.threshold
    graphs = StepGraphs()

    def body(state: TrainState, batch, hyper, sharded: bool, spatial: bool):
        with blocks.global_batch_stats(sharded or spatial), blocks.space_partition(spatial):
            with trace.span("step.forward"):
                images = batch_images(batch, two_modal)
                target = batch["target"]
                state.train(True)
                logits = state.net(*images)
                if spatial:
                    logits, target = mesh.gather_h(logits), mesh.fetch_h(target)
                if sharded:
                    logits, target = mesh.gather_rows(logits), mesh.fetch(target)
                loss = criterion(logits, target)
            with trace.span("step.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                (loss / mesh.replicas(spatial)[1]).backward()
            with trace.span("step.optimizer"):
                mesh.all_reduce_grads(state.optimizer.params(), spatial)
                state.optimizer.given = hyper
                state.optimizer.step()
            with trace.span("step.metrics"), torch.no_grad():
                return {
                    "loss": loss.detach(),
                    "dice_sum": metrics.dice_fn(logits, target, threshold=thr),
                    "count": batch_count(target.shape[0], loss.device),
                }

    def step(state: TrainState, batch, sharded: bool = False,
             spatial: bool = False) -> Dict[str, torch.Tensor]:
        with trace.span("train.step"):
            return graphs(lambda st, bt, hyper: body(st, bt, hyper, sharded, spatial),
                          state, batch, (), state.optimizer.hyper())

    return step


def make_coteach_train_step(two_modal: bool, cfg: TrainConfig):
    """step(state, batch, degrees, hflip, rate, sharded=False, spatial=False) -> metrics
    of the global batch; updates ``state`` in place (parameters, BN running
    stats, optimizer moments). degrees/hflip are the (V, b) view
    parameters of this rank's b rows, on the batch's device. A
    ``NetRankState`` takes the net axis's step (``net_rank_step``)."""
    image_criterion = make_image_criterion(cfg)
    ct = cfg.coteach
    if ct.tta_bn not in ("batch", "running"):
        raise ValueError(f"unknown coteach.tta_bn {ct.tta_bn!r}")
    num_views = cfg.data.num_tta_views
    thr = cfg.eval.threshold
    wm = cfg.data.warp_method

    @torch.no_grad()
    def pseudo_labels(state, images, fills, degrees, hflip, b, spatial):
        """(n, b, H, W, C) sharpened view averages and their weight maps of
        the state's n nets: the TTA views of both modalities (one warp each),
        the nets' view forwards (views folded into the batch; train-mode BN
        that leaves the running stats alone), one inverse warp over all
        their views, then the f32 softmax average. On a ``spatial`` batch
        each warp reads the whole images and writes this shard's rows."""
        nets = state.nets
        n = len(nets)
        window = _window(images[0]) if spatial else None
        if spatial:
            # both modalities' whole images in one collective
            images = mesh.fetch_h(*images)
            images = images if isinstance(images, tuple) else (images,)
        flat_views = tuple(
            tta.make_views(img, degrees, hflip, fill, method=wm, rows=window).flatten(0, 1)
            for img, fill in zip(images, fills)
        )
        state.train(ct.tta_bn == "batch")
        view_logits = torch.cat(
            [net(*flat_views, update_stats=False) for net in nets]
        )  # (n*V*B, H, W, C): net-major, then view, then image
        flat = view_logits.reshape((n * num_views, b) + tuple(view_logits.shape[1:]))
        inv = tta.invert_views(_whole(spatial, flat, dim=2), torch.cat([degrees] * n),
                               torch.cat([hflip] * n), method=wm, rows=window)
        probs = torch.softmax(inv.to(torch.float32), dim=-1)
        avg = probs.reshape((n, num_views, b) + tuple(probs.shape[2:])).mean(dim=1)
        pseudo = tta.sharpen(avg, ct.temperature, ct.sharpen_mode)
        return pseudo, tta.confidence_weightmap(pseudo)

    def side(pre, out, order_other, pseudo_other, wmap_other, terms):
        """One net's loss: its seg loss on the partner's clean rows (and the
        suspect ones down-weighted by ``1 - rate``) plus the consistency with
        the partner's pseudo-labels on the suspect rows, weighted by
        ``consistency_weight * rate``: ``terms`` holds the two 0-dim
        factors."""
        keep, weight = terms
        b = pre.shape[0]
        k_clean = max(1, min(b - 1, int(round(ct.clean_fraction * b))))
        clean = order_other[:k_clean]
        seg = pre[clean].mean()
        if k_clean < b:
            # b and k_clean are fixed per batch size: with b == 1 there
            # is no suspect share (its mean would be NaN)
            suspect = order_other[k_clean:]
            seg = seg + keep * pre[suspect].mean()
            cons_map = wmap_other * losses.multiclass_mse_loss(
                out, pseudo_other, reduction="none"
            )
            cons = cons_map.mean(dim=(1, 2, 3))[suspect].mean()
        else:
            cons = torch.zeros((), dtype=seg.dtype, device=seg.device)
        return ct.seg_weight * seg + weight * cons

    def check_views(degrees, b):
        if tuple(degrees.shape) != (num_views, b):
            raise ValueError(f"view params must be ({num_views}, {b}), got {tuple(degrees.shape)}")

    def pair_step(state: DualTrainState, batch, degrees, hflip, scalars, sharded, spatial):
        with blocks.global_batch_stats(sharded or spatial), blocks.space_partition(spatial):
            images = batch_images(batch, two_modal)
            t1, t2 = batch["target1"], batch["target2"]
            b = t1.shape[0]
            check_views(degrees, b)
            net1, net2 = state.nets
            with trace.span("step.views"):
                pseudo, wmap = pseudo_labels(state, images, batch_fills(batch, two_modal),
                                             degrees, hflip, b, spatial)

            # ---- coupled main forwards, one backward over both nets ----
            with trace.span("step.forward"):
                state.train(True)
                out1 = net1(*images)
                out2 = net2(*images)
                if sharded or spatial:
                    # the global batch's whole images, in global row order:
                    # the ranking and its ties, the clean count and every
                    # mean are the global ones
                    out = torch.stack([out1, out2], dim=1)
                    c = pseudo.shape[-1]
                    pw = torch.cat([pseudo, wmap], dim=-1).transpose(0, 1)
                    tt = torch.stack([t1, t2], dim=1)
                    if spatial:
                        out = mesh.gather_h(out, dim=2)
                        pw, tt = mesh.fetch_h(pw, tt, dim=2)
                    if sharded:
                        out = mesh.gather_rows(out)
                        pw, tt = mesh.fetch(pw, tt)
                    out1, out2 = out[:, 0], out[:, 1]
                    pseudo, wmap = pw[..., :c].transpose(0, 1), pw[..., c:].transpose(0, 1)
                    t1, t2 = tt[:, 0], tt[:, 1]
                    b = t1.shape[0]
                # net k scored against the OTHER net's working labels
                pre1 = image_criterion(out1, t2)
                pre2 = image_criterion(out2, t1)
                order1 = torch.argsort(pre1.detach(), stable=True)
                order2 = torch.argsort(pre2.detach(), stable=True)
                loss1 = side(pre1, out1, order2, pseudo[1], wmap[1], scalars[:2])
                loss2 = side(pre2, out2, order1, pseudo[0], wmap[0], scalars[:2])
            with trace.span("step.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                ((loss1 + loss2) / mesh.replicas(spatial)[1]).backward()
            with trace.span("step.optimizer"):
                mesh.all_reduce_grads(state.optimizer.params(), spatial)
                state.optimizer.given = scalars[2:]
                state.optimizer.step()
            with trace.span("step.metrics"), torch.no_grad():
                return {
                    "loss1": loss1.detach(),
                    "loss2": loss2.detach(),
                    "dice1_sum": metrics.dice_fn(out1, t2, threshold=thr),
                    "dice2_sum": metrics.dice_fn(out2, t1, threshold=thr),
                    "count": batch_count(b, loss1.device),
                }

    def net_rank_step(state: NetRankState, batch, degrees, hflip, scalars, sharded, spatial):
        """Net k = ``state.index`` of the pair on its rank: its own views'
        forwards and inverse warp, its main forward and its loss alone, its
        gradients summed over its data group. What crosses the pair needs no
        gradient: one ``pair_exchange`` of the per-image losses (the
        partner's ranking), the pseudo-labels, the weight maps and the dice
        before the losses, and one of the loss values after them."""
        with blocks.global_batch_stats(sharded or spatial), blocks.space_partition(spatial):
            images = batch_images(batch, two_modal)
            k = state.index
            targets = (batch["target1"], batch["target2"])
            b = targets[0].shape[0]
            check_views(degrees, b)
            with trace.span("step.views"):
                pseudo, wmap = pseudo_labels(state, images, batch_fills(batch, two_modal),
                                             degrees, hflip, b, spatial)
            with trace.span("step.forward"):
                pw = torch.cat([pseudo[0], wmap[0]], dim=-1)
                state.train(True)
                out = state.net(*images)
                if sharded or spatial:
                    tt = torch.stack(targets, dim=-1)
                    if spatial:
                        out = mesh.gather_h(out)
                        pw, tt = mesh.fetch_h(pw, tt)
                    if sharded:
                        out = mesh.gather_rows(out)
                        pw, tt = mesh.fetch(pw, tt)
                    targets = (tt[..., 0], tt[..., 1])
                    b = tt.shape[0]
                # net k scored against the OTHER net's working labels
                pre = image_criterion(out, targets[1 - k])
                with torch.no_grad():
                    dice = metrics.dice_fn(out, targets[1 - k], threshold=thr)
                pres, pws, dices = mesh.pair_exchange(pre, pw, dice)
                order_other = torch.argsort(pres[1 - k], stable=True)
                c = pseudo.shape[-1]
                loss = side(pre, out, order_other, pws[1 - k][..., :c], pws[1 - k][..., c:],
                            scalars[:2])
            with trace.span("step.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                (loss / mesh.replicas(spatial)[1]).backward()
            with trace.span("step.optimizer"):
                mesh.all_reduce_grads(state.optimizer.params(), spatial)
                state.optimizer.given = scalars[2:]
                state.optimizer.step()
            with trace.span("step.metrics"):
                (both,) = mesh.pair_exchange(loss)
                return {
                    "loss1": both[0],
                    "loss2": both[1],
                    "dice1_sum": dices[0],
                    "dice2_sum": dices[1],
                    "count": batch_count(b, both.device),
                }

    graphs = StepGraphs()

    def step(state, batch, degrees, hflip, rate, sharded: bool = False,
             spatial: bool = False) -> Dict[str, torch.Tensor]:
        run = net_rank_step if isinstance(state, NetRankState) else pair_step
        with trace.span("train.step"):
            # [1 - rate, consistency_weight * rate, *hyper()]: the floats
            # the eager step multiplied by, rounded to f32 as it rounded them
            host = (1.0 - rate, ct.consistency_weight * rate) + state.optimizer.hyper()
            return graphs(
                lambda st, bt, d, h, scalars: run(st, bt, d, h, scalars, sharded, spatial),
                state, batch, (degrees, hflip), host)

    return step


def make_eval_step(two_modal: bool, cfg: TrainConfig, dual: bool = True):
    """Test-batch loss/dice without gradients, eval-mode BN. Dual: net k
    against the other's working labels, per-image criterion. Single net:
    the scalar criterion against the batch's ``target``. With
    ``sharded``, of the global batch whose rows this rank holds; with
    ``spatial``, of the whole images whose rows this space shard holds."""
    thr = cfg.eval.threshold
    if not dual:
        criterion = make_criterion(cfg)

        @torch.no_grad()
        def single(state: TrainState, batch, sharded: bool = False,
                   spatial: bool = False) -> Dict[str, torch.Tensor]:
            images = batch_images(batch, two_modal)
            state.train(False)
            with blocks.space_partition(spatial):
                logits = state.net(*images)
            logits, target = _whole(spatial, logits, batch["target"])
            if sharded:
                logits, target = mesh.fetch(logits, target)
            return {
                "loss": criterion(logits, target),
                "dice_sum": metrics.dice_fn(logits, target, threshold=thr),
                "count": torch.tensor(float(target.shape[0]), device=logits.device),
            }

        return single
    image_criterion = make_image_criterion(cfg)

    @torch.no_grad()
    def step(state: DualTrainState, batch, sharded: bool = False,
             spatial: bool = False) -> Dict[str, torch.Tensor]:
        images = batch_images(batch, two_modal)
        t1, t2 = batch["target1"], batch["target2"]
        state.train(False)
        if isinstance(state, NetRankState):
            # net k's metrics against the other's labels, then the pair's
            with blocks.space_partition(spatial):
                out = state.net(*images)
            out, t1, t2 = _whole(spatial, out, t1, t2)
            if sharded:
                out, t1, t2 = mesh.fetch(out, t1, t2)
            other = (t1, t2)[1 - state.index]
            loss, dice = mesh.pair_exchange(image_criterion(out, other).mean(),
                                            metrics.dice_fn(out, other, threshold=thr))
            return {"loss1": loss[0], "loss2": loss[1], "dice1_sum": dice[0],
                    "dice2_sum": dice[1],
                    "count": torch.tensor(float(t1.shape[0]), device=out.device)}
        with blocks.space_partition(spatial):
            out1, out2 = (net(*images) for net in state.nets)
        out1, out2, t1, t2 = _whole(spatial, out1, out2, t1, t2)
        if sharded:
            out1, out2, t1, t2 = mesh.fetch(out1, out2, t1, t2)
        return {
            "loss1": image_criterion(out1, t2).mean(),
            "loss2": image_criterion(out2, t1).mean(),
            "dice1_sum": metrics.dice_fn(out1, t2, threshold=thr),
            "dice2_sum": metrics.dice_fn(out2, t1, threshold=thr),
            "count": torch.tensor(float(t1.shape[0]), device=out1.device),
        }

    return step


def _labels(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.uint8)


def _gather(data: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v.index_select(0, idx) for k, v in data.items()}


def _index_matrix(data: Dict[str, torch.Tensor], mat, dtype=torch.int64) -> torch.Tensor:
    """An index or mask matrix from the host, on the data's device."""
    device = next(iter(data.values())).device
    return torch.from_numpy(np.asarray(mat)).to(device=device, dtype=dtype)


def make_predict_step(two_modal: bool, dual: bool = True):
    """predict(state, batch, spatial=False) -> uint8 labels, (2, B, H, W)
    of the pair or (B, H, W) of the single net; of this space shard's rows
    of a ``spatial`` batch. On a net axis each rank predicts with its net
    and the pair exchanges the labels."""

    @torch.no_grad()
    def predict(state: TrainState, batch, spatial: bool = False) -> torch.Tensor:
        images = batch_images(batch, two_modal)
        state.train(False)
        with blocks.space_partition(spatial):
            if not dual:
                return _labels(state.net(*images))
            if isinstance(state, NetRankState):
                return mesh.pair_exchange(_labels(state.net(*images)))[0]
            return torch.stack([_labels(net(*images)) for net in state.nets])

    return predict


def make_predict_all(two_modal: bool, dual: bool = True):
    """run(state, data, idx_mat) -> (N, 2, B, H, W) uint8 labels of the pair
    or (N, B, H, W) of the single net: one predict per row of the (N, B)
    index matrix, each batch gathered on the device from ``data``
    (``SlicePipeline.device_image_data``)."""
    predict = make_predict_step(two_modal, dual)

    @torch.no_grad()
    def run(state: TrainState, data, idx_mat) -> torch.Tensor:
        rows = _index_matrix(data, idx_mat)
        return torch.stack([predict(state, _gather(data, row)) for row in rows])

    return run


def make_eval_predict_all(two_modal: bool, cfg: TrainConfig):
    """The test pass fused with the test cases' labels.

    run(state, data, idx_mat, valid_mat) -> (totals, labels): per row of
    the (N, B) index matrix into ``data`` (the pipe's device arrays, ground
    truth included), the per-image loss and dice of each net against the
    ground truth, summed over the images that ``valid_mat`` marks (the
    padded tail of the last row is 0), and the (2, B, H, W) uint8 labels.
    totals has the keys of ``make_eval_step`` with loss sums weighted per
    image (Trainer._accumulate's bookkeeping); labels are (N, 2, B, H, W).
    """
    image_criterion = make_image_criterion(cfg)
    thr = cfg.eval.threshold

    @torch.no_grad()
    def run(state: DualTrainState, data, idx_mat, valid_mat):
        rows = _index_matrix(data, idx_mat)
        valid_rows = _index_matrix(data, valid_mat, torch.float32)
        state.train(False)
        totals, labels = None, []
        for row, valid in zip(rows, valid_rows):
            batch = _gather(data, row)
            target = batch.pop("target").to(torch.int64)
            images = batch_images(batch, two_modal)
            out1, out2 = (net(*images) for net in state.nets)
            d1, _ = metrics._dice_vector(out1, target, thr)
            d2, _ = metrics._dice_vector(out2, target, thr)
            m = {
                "loss1": (image_criterion(out1, target) * valid).sum(),
                "loss2": (image_criterion(out2, target) * valid).sum(),
                "dice1_sum": (d1 * valid).sum(),
                "dice2_sum": (d2 * valid).sum(),
                "count": valid.sum(),
            }
            totals = m if totals is None else {k: totals[k] + m[k] for k in m}
            labels.append(torch.stack([_labels(out1), _labels(out2)]))
        return totals, torch.stack(labels)

    return run
