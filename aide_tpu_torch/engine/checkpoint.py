"""Best-epoch exports of the dual co-teaching pair.

The port's counterpart of the per-net files that
``aide_tpu.engine.checkpoint.save_best_bundle`` writes at a best epoch, in
the original AIDE layout: for net n, ``torch.save({'net': state_dict,
**meta})`` to ``{checkpoint_dir}/{experiment_name}_net{n}_besttraincasedice.pkl``
(tensors on the CPU, so the file loads on a machine without a card), and
beside it ``<file>.json`` with ``meta`` and the net's number. The JAX
package's ``aide_tpu.interop.import_reference_checkpoint`` reads these
files.

Not carried yet (ROADMAP Queue 1 item 14): the ``_full`` and
``_last_full`` exact-resume files with their bookkeeping sidecar, warm
start from one net's weights, resume, and the ``.msgpack`` format.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, List, Sequence

import torch

from aide_tpu_torch.engine.state import DualTrainState

StateDicts = List[Dict[str, torch.Tensor]]


def best_net_path(dir_path: str, prefix: str, net: int) -> str:
    return os.path.join(dir_path, f"{prefix}_net{net}_besttraincasedice.pkl")


def snapshot(state: DualTrainState) -> StateDicts:
    """Both nets' state dicts cloned where they live (on the card: no copy
    to the host until the files are written)."""
    return [
        {k: v.detach().clone() for k, v in net.state_dict().items()} for net in state.nets
    ]


def save_best(dir_path: str, prefix: str, state_dicts: Sequence[Dict[str, torch.Tensor]],
              meta: Dict) -> None:
    """Write one ``.pkl`` export and its ``.json`` sidecar per net."""
    os.makedirs(dir_path, exist_ok=True)
    for net, sd in enumerate(state_dicts, start=1):
        path = best_net_path(dir_path, prefix, net)
        host = OrderedDict((k, v.detach().cpu()) for k, v in sd.items())
        torch.save({"net": host, **meta}, path)
        with open(path + ".json", "w") as fh:
            json.dump(dict(meta, net=net), fh, indent=2)
