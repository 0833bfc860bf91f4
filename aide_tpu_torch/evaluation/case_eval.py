"""Case-wise 3D inference and metrics.

An own copy of ``aide_tpu.evaluation.case_eval``: all cases' slices go
through the predict program as one packed stream of fixed-size batches,
then each case's (S, H, W) volume is post-processed on the host (largest
connected component) and scored (3D Dice, optionally IoU and confusion
counts). Labels come back from the device as uint8; the JAX package's
width bit-packing, which only saved a TPU link's transfer, is not carried.

``dual`` selects the pair or the single net: a single net's predictions
get a net axis of 1, and its results are keyed ``{0: [...]}``.
``start_case_inference`` queues the device work and its copy to pinned
host memory before it returns, so the host can run CC on another pass while
the device computes this one. ``infer_cases`` and ``evaluate_cases`` run
them to their end: the CLI's ``predict`` and ``eval``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from aide_tpu_torch.core import trace
from aide_tpu_torch.data.pipeline import SlicePipeline
from aide_tpu_torch.ops.cc import keep_largest_connected_components

# Host-side NumPy 3D metrics: foreground > 0, an empty union scores 1.


def dice3d_np(pred: np.ndarray, target: np.ndarray) -> float:
    """Whole-volume Dice (foreground > 0; empty union = 1.0)."""
    p = pred > 0
    t = target > 0
    union = np.count_nonzero(p) + np.count_nonzero(t)
    if union == 0:
        return 1.0
    return 2.0 * np.count_nonzero(p & t) / union


def _iou3d_np(pred: np.ndarray, target: np.ndarray) -> float:
    p = pred > 0
    t = target > 0
    inter = np.count_nonzero(p & t)
    union = np.count_nonzero(p) + np.count_nonzero(t) - inter
    if union == 0:
        return 1.0
    return inter / union


def _tp_tn_fp_fn_3d_np(pred: np.ndarray, target: np.ndarray):
    p = pred > 0
    t = target > 0
    tp = float(np.count_nonzero(p & t))
    fp = float(np.count_nonzero(p) - tp)
    fn = float(np.count_nonzero(t) - tp)
    tn = float(p.size - tp - fp - fn)
    return tp, tn, fp, fn


@dataclass
class CaseResult:
    case_id: str
    dice: float
    iou: float = 0.0
    tp: float = 0.0
    tn: float = 0.0
    fp: float = 0.0
    fn: float = 0.0
    pred_volume: Optional[np.ndarray] = None  # (S, H, W) uint8 post-CC


def pack_case_stream(pipe: SlicePipeline, cases: Sequence[str], batch_size: int):
    """All cases' slice indices as one contiguous padded stream.

    Returns (case_ids, counts, n, padded): the stream concatenates each
    case's sorted indices, then repeats the last index up to a multiple of
    ``batch_size``: one pad at the very end instead of one per case."""
    case_ids = [str(c) for c in cases]
    all_idx: List[int] = []
    counts: List[int] = []
    for case in case_ids:
        idxs = pipe.case_indices(case)
        all_idx.extend(idxs)
        counts.append(len(idxs))
    n = len(all_idx)
    pad = (-n) % batch_size if n else 0
    padded = np.asarray(all_idx + all_idx[-1:] * pad if n else [], np.int64)
    return case_ids, counts, n, padded


def _postprocess_case(preds: np.ndarray, keep_largest_cc: bool):
    """(n_nets, S, H, W) prediction stack -> {net: (S, H, W) uint8}."""
    vols = {}
    for net in range(preds.shape[0]):
        vol = preds[net].astype(np.uint8)
        if keep_largest_cc:
            vol = keep_largest_connected_components(vol)
        vols[net] = vol
    return vols


def start_host_copy(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """Queue the copy of ``t`` to the host behind the work that makes it;
    the returned callable waits for that copy alone and gives a NumPy array.
    On the CPU the tensor is there already."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return wait


def start_case_inference(
    predict_step: Callable,
    state,
    pipe: SlicePipeline,
    cases: Sequence[str],
    batch_size: int,
    keep_largest_cc: bool = True,
    predict_all: Optional[Callable] = None,
    dual: bool = True,
) -> Callable[[], List[Dict[int, np.ndarray]]]:
    """Queue the nets' case inference now; return a closure that finishes it.

    With ``predict_all`` and a device-resident pipe, the whole (N, B) index
    matrix goes through ``predict_all``; otherwise each batch goes through
    ``predict_step``. Either way one copy to the host is queued behind the
    forwards. The closure returns a list aligned with ``cases`` of
    {net_index: (S, H, W) uint8} volumes (net_index 0 for a single net).
    Spans (``core.trace``): ``cases.dispatch`` (queueing), ``cases.fetch``
    (the wait for the labels on the host), ``cases.cc`` (the largest
    component of each volume).
    """
    case_ids, counts, n, padded = pack_case_stream(pipe, cases, batch_size)
    if n == 0:
        return lambda: []

    with trace.span("cases.dispatch"):
        if predict_all is not None and pipe.device_image_data is not None:
            out = predict_all(state, pipe.device_image_data, padded.reshape(-1, batch_size))
            if not dual:
                out = out.unsqueeze(1)
            out = out.transpose(0, 1).reshape(out.shape[1], -1, *out.shape[3:])  # (nets, N*B, ..)
        else:
            # per-batch dispatch (host-batch pipelines)
            out = [
                predict_step(state, pipe.batch_at(padded[s : s + batch_size], images_only=True))
                for s in range(0, len(padded), batch_size)
            ]  # each (2, B, H, W) of the pair or (B, H, W) of a single net
            out = torch.cat(out, dim=1) if dual else torch.cat(out)[None]
        wait = start_host_copy(out)

    def finish() -> List[Dict[int, np.ndarray]]:
        with trace.span("cases.fetch"):
            stream = wait()[:, :n]  # the final pad dropped
        with trace.span("cases.cc"):
            volumes, offset = [], 0
            for cnt in counts:
                volumes.append(
                    _postprocess_case(stream[:, offset : offset + cnt], keep_largest_cc))
                offset += cnt
        return volumes

    return finish


def score_case_volumes(
    pipe: SlicePipeline,
    cases: Sequence[str],
    volumes: List[Dict[int, np.ndarray]],
    target_net: Union[int, str, None] = None,
    full_metrics: bool = False,
    keep_volumes: bool = False,
    dual: bool = True,
) -> Dict[int, List[CaseResult]]:
    """Score the nets' predicted case volumes into per-net CaseResult lists
    (both nets', or net 0's for a single net), in the span ``cases.score``.

    ``target_net``: None scores against ground truth, 1/2 against that
    net's working labels, "self" each net against its own working labels
    (ground truth when the pipe carries none)."""
    with trace.span("cases.score"):
        results: Dict[int, List[CaseResult]] = {}
        for net in range(2 if dual else 1):
            per_case = []
            for case, vols in zip(cases, volumes):
                pred = vols[net]
                if target_net == "self":
                    net_sel = (net + 1) if pipe.labels is not None else None
                    target = pipe.case_targets(str(case), net=net_sel)
                else:
                    target = pipe.case_targets(str(case), net=target_net)
                r = CaseResult(case_id=str(case), dice=dice3d_np(pred, target))
                if full_metrics:
                    r.iou = _iou3d_np(pred, target)
                    r.tp, r.tn, r.fp, r.fn = _tp_tn_fp_fn_3d_np(pred, target)
                if keep_volumes:
                    r.pred_volume = pred
                per_case.append(r)
            results[net] = per_case
        return results


def start_case_evaluation(
    predict_step: Callable,
    state,
    pipe: SlicePipeline,
    cases: Sequence[str],
    batch_size: int,
    target_net: Union[int, str, None] = None,
    keep_largest_cc: bool = True,
    full_metrics: bool = False,
    keep_volumes: bool = False,
    predict_all: Optional[Callable] = None,
    dual: bool = True,
) -> Callable[[], Dict[int, List[CaseResult]]]:
    """Queue the case inference now; return a closure that fetches,
    post-processes and scores: per-case 3D Dice (optionally IoU and
    confusion counts) for each net, ``target_net`` as in
    ``score_case_volumes``."""
    finish_infer = start_case_inference(
        predict_step, state, pipe, cases, batch_size, keep_largest_cc,
        predict_all=predict_all, dual=dual,
    )

    def finish() -> Dict[int, List[CaseResult]]:
        return score_case_volumes(
            pipe, cases, finish_infer(), target_net=target_net,
            full_metrics=full_metrics, keep_volumes=keep_volumes, dual=dual,
        )

    return finish


def infer_cases(
    predict_step: Callable,
    state,
    pipe: SlicePipeline,
    cases: Sequence[str],
    batch_size: int,
    dual: bool,
    keep_largest_cc: bool = True,
    predict_all: Optional[Callable] = None,
) -> List[Dict[int, np.ndarray]]:
    """Predicted volumes per case, post-processed: a list aligned with
    ``cases`` of {net_index: (S, H, W) uint8} (net_index 0 for a single
    net). ``start_case_inference`` run to its end."""
    return start_case_inference(
        predict_step, state, pipe, cases, batch_size, keep_largest_cc,
        predict_all=predict_all, dual=dual,
    )()


def evaluate_cases(
    predict_step: Callable,
    state,
    pipe: SlicePipeline,
    cases: Sequence[str],
    batch_size: int,
    dual: bool,
    target_net: Union[int, str, None] = None,
    keep_largest_cc: bool = True,
    full_metrics: bool = False,
    keep_volumes: bool = False,
    predict_all: Optional[Callable] = None,
) -> Dict[int, List[CaseResult]]:
    """Per-case 3D Dice (with ``full_metrics`` also IoU and the confusion
    counts) for each net, the volumes kept on the results with
    ``keep_volumes``; ``target_net`` as in ``score_case_volumes``.
    ``start_case_evaluation`` run to its end."""
    return start_case_evaluation(
        predict_step, state, pipe, cases, batch_size, target_net=target_net,
        keep_largest_cc=keep_largest_cc, full_metrics=full_metrics,
        keep_volumes=keep_volumes, predict_all=predict_all, dual=dual,
    )()
