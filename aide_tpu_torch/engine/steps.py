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

``make_supervised_train_step`` is the comparison trainer's step: one
forward in train-mode BN that updates the running stats, the scalar
criterion (``make_criterion``), one backward and one AMSGrad update.

Over a data axis of N > 1 ranks (``core.mesh``) each step takes its
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

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aide_tpu_torch.core import mesh
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.engine.state import DualTrainState, TrainState
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
    equals a launch per tensor."""
    num_classes = cfg.model.num_classes
    wm = cfg.data.warp_method
    names = ("modal1", "modal2") if two_modal else ("image",)

    @torch.no_grad()
    def augment(batch, degrees, hflip) -> Dict[str, torch.Tensor]:
        images = batch_images(batch, two_modal)
        b = images[0].shape[0]
        out = dict(batch)
        k = len(images)
        warped = warp.augment(torch.cat(images), degrees.repeat(k), hflip.repeat(k),
                              torch.cat(batch_fills(batch, two_modal)), method=wm)
        out.update(zip(names, warped.split(b)))
        tnames = [t for t in TARGETS if t in batch]
        k = len(tnames)
        onehot = torch.cat([F.one_hot(batch[t].long(), num_classes).float() for t in tnames])
        maps = warp.augment(onehot, degrees.repeat(k), hflip.repeat(k), 0.0, method=wm)
        for t, m in zip(tnames, maps.split(b)):
            out[t] = m.argmax(dim=-1).to(batch[t].dtype)
        return out

    return augment


def make_supervised_train_step(two_modal: bool, cfg: TrainConfig):
    """step(state, batch, sharded=False) -> metrics {loss, dice_sum, count}
    of the global batch; updates ``state`` in place (parameters, BN running
    stats, optimizer moments)."""
    criterion = make_criterion(cfg)
    thr = cfg.eval.threshold

    def step(state: TrainState, batch, sharded: bool = False) -> Dict[str, torch.Tensor]:
        with blocks.global_batch_stats(sharded):
            images = batch_images(batch, two_modal)
            target = batch["target"]
            state.train(True)
            logits = state.net(*images)
            if sharded:
                logits, target = mesh.gather_rows(logits), mesh.fetch(target)
            loss = criterion(logits, target)
            state.optimizer.zero_grad(set_to_none=True)
            (loss / mesh.world_size()).backward()
            mesh.all_reduce_grads(state.optimizer.params())
            state.optimizer.step()
            with torch.no_grad():
                return {
                    "loss": loss.detach(),
                    "dice_sum": metrics.dice_fn(logits, target, threshold=thr),
                    "count": torch.tensor(float(target.shape[0]), device=loss.device),
                }

    return step


def make_coteach_train_step(two_modal: bool, cfg: TrainConfig):
    """step(state, batch, degrees, hflip, rate, sharded=False) -> metrics
    of the global batch; updates ``state`` in place (parameters, BN running
    stats, optimizer moments). degrees/hflip are the (V, b) view
    parameters of this rank's b rows, on the batch's device."""
    image_criterion = make_image_criterion(cfg)
    ct = cfg.coteach
    if ct.tta_bn not in ("batch", "running"):
        raise ValueError(f"unknown coteach.tta_bn {ct.tta_bn!r}")
    num_views = cfg.data.num_tta_views
    thr = cfg.eval.threshold
    wm = cfg.data.warp_method

    def step(state: DualTrainState, batch, degrees, hflip, rate,
             sharded: bool = False) -> Dict[str, torch.Tensor]:
        with blocks.global_batch_stats(sharded):
            images = batch_images(batch, two_modal)
            fills = batch_fills(batch, two_modal)
            t1, t2 = batch["target1"], batch["target2"]
            b = t1.shape[0]
            if tuple(degrees.shape) != (num_views, b):
                raise ValueError(f"view params must be ({num_views}, {b}), got {tuple(degrees.shape)}")
            net1, net2 = state.nets

            # ---- TTA pseudo-labels: both nets, all views, no gradient ----
            with torch.no_grad():
                flat_views = tuple(
                    tta.make_views(img, degrees, hflip, fill, method=wm).reshape(
                        (num_views * b,) + tuple(img.shape[1:])
                    )
                    for img, fill in zip(images, fills)
                )
                state.train(ct.tta_bn == "batch")
                view_logits = torch.cat(
                    [net(*flat_views, update_stats=False) for net in state.nets]
                )  # (2*V*B, H, W, C): net-major, then view, then image
                flat = view_logits.reshape((2 * num_views, b) + tuple(view_logits.shape[1:]))
                inv = tta.invert_views(
                    flat, torch.cat([degrees, degrees]), torch.cat([hflip, hflip]), method=wm
                )
                probs = torch.softmax(inv.to(torch.float32), dim=-1)
                avg = probs.reshape((2, num_views, b) + tuple(probs.shape[2:])).mean(dim=1)
                pseudo = tta.sharpen(avg, ct.temperature, ct.sharpen_mode)
                wmap = tta.confidence_weightmap(pseudo)

            # ---- coupled main forwards, one backward over both nets ----
            state.train(True)
            out1 = net1(*images)
            out2 = net2(*images)
            if sharded:
                # the global batch's rows, in global row order: the ranking
                # and its ties, the clean count and every mean are the global ones
                out = mesh.gather_rows(torch.stack([out1, out2], dim=1))
                out1, out2 = out[:, 0], out[:, 1]
                c = pseudo.shape[-1]
                pw, tt = mesh.fetch(torch.cat([pseudo, wmap], dim=-1).transpose(0, 1),
                                    torch.stack([t1, t2], dim=1))
                pseudo, wmap = pw[..., :c].transpose(0, 1), pw[..., c:].transpose(0, 1)
                t1, t2 = tt[:, 0], tt[:, 1]
                b = t1.shape[0]
            k_clean = max(1, min(b - 1, int(round(ct.clean_fraction * b))))
            # net k scored against the OTHER net's working labels
            pre1 = image_criterion(out1, t2)
            pre2 = image_criterion(out2, t1)
            order1 = torch.argsort(pre1.detach(), stable=True)
            order2 = torch.argsort(pre2.detach(), stable=True)

            def side(pre, out, order_other, pseudo_other, wmap_other):
                clean = order_other[:k_clean]
                seg = pre[clean].mean()
                if k_clean < b:
                    # b and k_clean are fixed per batch size: with b == 1 there
                    # is no suspect share (its mean would be NaN)
                    suspect = order_other[k_clean:]
                    seg = seg + (1.0 - rate) * pre[suspect].mean()
                    cons_map = wmap_other * losses.multiclass_mse_loss(
                        out, pseudo_other, reduction="none"
                    )
                    cons = cons_map.mean(dim=(1, 2, 3))[suspect].mean()
                else:
                    cons = torch.zeros((), dtype=seg.dtype, device=seg.device)
                return ct.seg_weight * seg + ct.consistency_weight * rate * cons

            loss1 = side(pre1, out1, order2, pseudo[1], wmap[1])
            loss2 = side(pre2, out2, order1, pseudo[0], wmap[0])
            state.optimizer.zero_grad(set_to_none=True)
            ((loss1 + loss2) / mesh.world_size()).backward()
            mesh.all_reduce_grads(state.optimizer.params())
            state.optimizer.step()
            with torch.no_grad():
                return {
                    "loss1": loss1.detach(),
                    "loss2": loss2.detach(),
                    "dice1_sum": metrics.dice_fn(out1, t2, threshold=thr),
                    "dice2_sum": metrics.dice_fn(out2, t1, threshold=thr),
                    "count": torch.tensor(float(b), device=loss1.device),
                }

    return step


def make_eval_step(two_modal: bool, cfg: TrainConfig, dual: bool = True):
    """Test-batch loss/dice without gradients, eval-mode BN. Dual: net k
    against the other's working labels, per-image criterion. Single net:
    the scalar criterion against the batch's ``target``. With
    ``sharded``, of the global batch whose rows this rank holds."""
    thr = cfg.eval.threshold
    if not dual:
        criterion = make_criterion(cfg)

        @torch.no_grad()
        def single(state: TrainState, batch, sharded: bool = False) -> Dict[str, torch.Tensor]:
            images = batch_images(batch, two_modal)
            target = batch["target"]
            state.train(False)
            logits = state.net(*images)
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
    def step(state: DualTrainState, batch, sharded: bool = False) -> Dict[str, torch.Tensor]:
        images = batch_images(batch, two_modal)
        t1, t2 = batch["target1"], batch["target2"]
        state.train(False)
        out1, out2 = (net(*images) for net in state.nets)
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
    """predict(state, batch) -> uint8 labels, (2, B, H, W) of the pair or
    (B, H, W) of the single net."""

    @torch.no_grad()
    def predict(state: TrainState, batch) -> torch.Tensor:
        images = batch_images(batch, two_modal)
        state.train(False)
        if not dual:
            return _labels(state.net(*images))
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
