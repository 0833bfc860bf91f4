"""Case evaluation and the label refresh in plain float32 PyTorch and NumPy.

A net's labels of a volume are the logits' argmax under eval-mode
BatchNorm; its largest face-connected 3D component is kept
(``scipy.ndimage.label``; of components of equal size the one whose last
voxel in raster order comes first), and scored by the 3D Dice (an empty
union scores 1). An epoch evaluates each net on every test case against
its truth and on every train case against the net's working labels; the
refresh then gives each net's ``k`` worst train cases by that Dice the
net's own labels, except the labeled cases (and, with ``skip_empty``, an
empty prediction).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage

from benchmark.reference import data as ref_data
from benchmark.reference import nets as ref_nets


@torch.no_grad()
def logits(net, images, block: int = 8) -> np.ndarray:
    """(S, H, W, C) f32 logits of a volume's slices, ``block`` slices a
    forward (the label is their argmax)."""
    net.eval()
    out = [net(*(x[i:i + block] for x in images)).cpu() for i in range(0, len(images[0]), block)]
    return torch.cat(out).numpy()


def largest_component(mask: np.ndarray) -> np.ndarray:
    labels, num = ndimage.label(mask > 0)
    out = np.zeros(mask.shape, np.uint8)
    if num == 0:
        return out
    flat = labels.ravel()
    sizes = np.bincount(flat, minlength=num + 1)
    sizes[0] = 0
    tied = np.flatnonzero(sizes == sizes.max())
    keep = tied[0]
    if len(tied) > 1:
        last = np.zeros(num + 1, np.int64)
        fg = np.flatnonzero(flat)
        np.maximum.at(last, flat[fg], fg)
        keep = tied[np.argmin(last[tied])]
    out[labels == keep] = 1
    return out


def dice(pred: np.ndarray, target: np.ndarray) -> float:
    p, t = pred > 0, target > 0
    union = np.count_nonzero(p) + np.count_nonzero(t)
    return 1.0 if union == 0 else 2.0 * np.count_nonzero(p & t) / union


def case_ids(data: Dict) -> Tuple[List[str], List[str]]:
    """The train and the test cases' names, as the synthetic task names them."""
    train = [f"case{c:02d}" for c in range(data["train_cases"])]
    off = data["test_case_offset"]
    return train, [f"case{c:02d}" for c in range(off, off + data["test_cases"])]


def _volume(data: Dict, case: str, train: bool, device):
    idx = int(case[len("case"):])
    return ref_data.batch(data, [(idx, s) for s in range(data["slices_per_case"])], train,
                          device)


def answers(config: Dict, data: Dict, state_dicts: Sequence[Dict[str, torch.Tensor]], device,
            precision: str = "float32") -> Dict:
    """An epoch's case evaluation from ``state_dicts`` (one a net), before
    its refresh, when the working labels are still the train cases' first
    labels: ``raw`` {(kind, net, case): (S, H, W) uint8 labels before the
    largest component}, kind "test" or "train"; ``dice`` {(kind, net,
    case): 3D Dice}; ``pred`` {net: {train case: (S, H, W) uint8 labels}};
    ``target`` {(kind, case): what a case is scored against}; ``initial``
    {train case: its first working labels}."""
    from benchmark.reference.steps import float32_exact

    train, test = case_ids(data)
    out = {"raw": {}, "dice": {}, "pred": {}, "target": {}, "initial": {}}
    vols = {}
    for kind, cases in (("train", train), ("test", test)):
        for case in cases:
            v = _volume(data, case, kind == "train", device)
            vols[kind, case] = (v["images"], v["target"].cpu().numpy().astype(np.uint8))
            out["target"][kind, case] = vols[kind, case][1]
            if kind == "train":
                out["initial"][case] = vols[kind, case][1]
    with float32_exact():
        for k, sd in enumerate(state_dicts):
            net = ref_nets.set_precision(ref_nets.build(config["model"]).to(device), precision)
            net.load_state_dict(sd)
            out["pred"][k] = {}
            for (kind, case), (images, target) in vols.items():
                logit = logits(net, images)
                raw = (logit[..., 1] > logit[..., 0]).astype(np.uint8)
                out["raw"][kind, k, case] = raw
                pred = largest_component(raw)
                out["dice"][kind, k, case] = dice(pred, target)
                if kind == "train":
                    out["pred"][k][case] = pred
            del net
    return out


def refresh(dice_of: Dict[str, float], pred: Dict[str, np.ndarray],
            initial: Dict[str, np.ndarray], k: int, label_cases: Sequence[str],
            skip_empty: bool) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """One net's refresh: its ``k`` worst train cases by ``dice_of`` (ties
    in case order) and the working labels after it."""
    selected = sorted(dice_of, key=lambda c: (dice_of[c], c))[:k]
    labels = {}
    for case, first in initial.items():
        write = (case in selected and case not in label_cases
                 and not (skip_empty and not pred[case].any()))
        labels[case] = pred[case] if write else first
    return selected, labels
