"""Best-epoch exports, loading a net's weights back, and the dual warm start.

The port's counterpart of the per-net files that
``aide_tpu.engine.checkpoint.save_best_bundle`` writes at a best epoch, in
the original AIDE layout: ``torch.save({'net': state_dict, **meta})`` to
``{checkpoint_dir}/{experiment_name}_net{n}_besttraincasedice.pkl`` for
net n of the co-teaching pair, or ``{experiment_name}_besttraincasedice.pkl``
for the single supervised net (tensors on the CPU, so the file loads on a
machine without a card), and beside it ``<file>.json`` with ``meta`` (and
the net's number for the pair). The meta holds plain types only (numbers,
strings, lists of dicts of numbers), so ``torch.load(weights_only=True)``
reads the files. The JAX package's
``aide_tpu.interop.import_reference_checkpoint`` reads them too.

``load_net`` reads such a file, or an original AIDE ``.pkl``, back into a
state_dict; ``warm_start_dual`` loads one into both nets of the pair with
symmetry-breaking noise (``aide_tpu.engine.checkpoint.warm_start_dual``).

Not carried yet (ROADMAP Queue 1 item 14): the ``_full`` and
``_last_full`` exact-resume files with their bookkeeping sidecar, exact
resume, and the ``.msgpack`` format.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch

from aide_tpu_torch.engine.state import DualTrainState, TrainState

StateDicts = List[Dict[str, torch.Tensor]]


def best_net_path(dir_path: str, prefix: str, net: Optional[int] = None) -> str:
    """The best-epoch export of net ``net`` of the pair, or of the single
    net for None."""
    name = f"{prefix}_besttraincasedice.pkl" if net is None else (
        f"{prefix}_net{net}_besttraincasedice.pkl"
    )
    return os.path.join(dir_path, name)


def snapshot(state: TrainState) -> StateDicts:
    """The nets' state dicts cloned where they live (on the card: no copy
    to the host until the files are written)."""
    return [
        {k: v.detach().clone() for k, v in net.state_dict().items()} for net in state.nets
    ]


def save_best(dir_path: str, prefix: str, state_dicts: Sequence[Dict[str, torch.Tensor]],
              meta: Dict) -> None:
    """Write one ``.pkl`` export and its ``.json`` sidecar per net: two
    state dicts are the pair's (``_net{n}`` files), one the single net's."""
    os.makedirs(dir_path, exist_ok=True)
    dual = len(state_dicts) == 2
    for net, sd in enumerate(state_dicts, start=1):
        path = best_net_path(dir_path, prefix, net if dual else None)
        host = OrderedDict((k, v.detach().cpu()) for k, v in sd.items())
        torch.save({"net": host, **meta}, path)
        with open(path + ".json", "w") as fh:
            json.dump(dict(meta, net=net) if dual else meta, fh, indent=2)


def load_net(path: str) -> Dict[str, torch.Tensor]:
    """A net's state_dict from a ``.pkl``: the port's exports and the
    original AIDE trainers' ``{'net': state_dict, ...}`` files, or a bare
    state_dict. ``num_batches_tracked``, which the port's BatchNorm does not
    carry, is dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("net"), dict):
        obj = obj["net"]
    if not isinstance(obj, dict) or not obj or not all(
        isinstance(v, torch.Tensor) for v in obj.values()
    ):
        raise ValueError(f"{path!r} does not hold a state_dict")
    return OrderedDict(
        (k, v) for k, v in obj.items() if not k.endswith("num_batches_tracked")
    )


@torch.no_grad()
def warm_start_dual(state: DualTrainState, path: str, noise: float = 1e-3, seed: int = 0) -> None:
    """Load one net's export (``load_net``) into BOTH nets of the pair, in
    place, as the kidney trainers' --resumefile warm start does.

    With ``noise``, each parameter of each net gets independent Gaussian
    noise of std ``noise * (std(leaf) + 1e-8)``, the leaf's population std,
    drawn on the CPU from a generator seeded by ``seed`` (the same numbers
    on any device). Without it two identical nets on identical batches get
    identical gradients forever and co-teaching degenerates into
    self-training. BatchNorm running statistics are copied without noise."""
    sd = load_net(path)
    for net in state.nets:
        net.load_state_dict(sd, strict=True)
    if not noise:
        return
    gen = torch.Generator().manual_seed(seed)
    for name, _ in state.nets[0].named_parameters():
        leaf = sd[name].to(torch.float32)
        scale = noise * (float(leaf.std(correction=0)) + 1e-8)
        draws = torch.randn((len(state.nets),) + tuple(leaf.shape), generator=gen) * scale
        for net, draw in zip(state.nets, draws):
            p = net.get_parameter(name)
            p.add_(draw.to(device=p.device, dtype=p.dtype))
