"""Load the JAX package's FuseUNet and UNet variables into a port model.

``variables`` is the JAX package's ``{'params': ..., 'batch_stats': ...}``
tree as nested dicts of NumPy arrays. Names map from the Flax module paths
(``modal1_block3/Conv_0``, ``down_block2/ConvBlock_0/Conv_0``) to the
original PyTorch code's attribute paths (``modal1_downblock3.block.conv1``,
``down_block2.block.conv1``), which the port's modules carry; layouts move
HWIO -> OIHW for convs and scale/bias/mean/var -> weight/bias/running_mean/
running_var for BatchNorm. An own copy of the fuseunet and unet parts of
``aide_tpu.interop.torch_import``'s name map and
``aide_tpu.interop.torch_export``'s layout moves.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from aide_tpu_torch.models.unet import UNet

# ConvBlock (Flax) <-> basic_block (original code)
_CONV_BLOCK = {
    ("Conv_0",): ("conv1", "conv"),
    ("Norm_0", "BatchNorm_0"): ("bn1", "bn"),
    ("Conv_1",): ("conv2", "conv"),
    ("Norm_1", "BatchNorm_0"): ("bn2", "bn"),
}

# UpsampleConv (Flax) <-> [Upsample, Conv2d, BN, ReLU] Sequential
_UPSAMPLE_CONV = {
    ("Conv_0",): ("1", "conv"),
    ("Norm_0", "BatchNorm_0"): ("2", "bn"),
}


def name_map(model_name: str = "fuseunet") -> Dict[Tuple[str, ...], Tuple[str, str]]:
    """{Flax module path: (port module name, kind)} of the plain FuseUNet
    (``fuseunet``) or the UNet family (``unet``, ``unet2`` ... ``unet128``).
    The JAX UNet's encoder blocks hold their ConvBlock one level deeper
    (``down_block{k}/ConvBlock_0``) than FuseUNet's (``modal{m}_block{k}``)."""
    table: Dict[Tuple[str, ...], Tuple[str, str]] = {}
    if model_name == "fuseunet":
        for k in range(1, 6):
            for m in (1, 2):
                for sub, (t, kind) in _CONV_BLOCK.items():
                    table[(f"modal{m}_block{k}",) + sub] = (f"modal{m}_downblock{k}.block.{t}", kind)
    elif model_name.startswith("unet") and model_name != "unetsa":
        for k in range(1, 6):
            for sub, (t, kind) in _CONV_BLOCK.items():
                table[(f"down_block{k}", "ConvBlock_0") + sub] = (f"down_block{k}.block.{t}", kind)
    else:
        raise ValueError(f"no weight mapping for model {model_name!r}")
    for j in range(1, 5):
        for sub, (t, kind) in _UPSAMPLE_CONV.items():
            table[(f"up_block{j}", "UpsampleConv_0") + sub] = (f"up_block{j}.bilinear_up.{t}", kind)
        for sub, (t, kind) in _CONV_BLOCK.items():
            table[(f"up_block{j}", "ConvBlock_0") + sub] = (f"up_block{j}.block.{t}", kind)
    table[("Conv_0",)] = ("last_conv1", "conv")
    return table


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def variables_to_state_dict(
    variables: Mapping[str, Any], model_name: str = "fuseunet"
) -> Dict[str, np.ndarray]:
    """JAX variables of ``model_name`` -> the port's state_dict (NumPy
    arrays). Raises if a JAX leaf is missing or left over."""
    params = dict(_leaves(variables["params"]))
    stats = dict(_leaves(variables.get("batch_stats", {})))
    used = set()

    def take(tree, path, tag):
        if path not in tree:
            raise KeyError(f"JAX variables have no {tag}/{'/'.join(path)}")
        used.add((tag, path))
        return np.array(tree[path], dtype=np.float32)  # a writable copy

    sd: Dict[str, np.ndarray] = {}
    for path, (ours, kind) in name_map(model_name).items():
        if kind == "conv":
            sd[f"{ours}.weight"] = np.ascontiguousarray(
                np.transpose(take(params, path + ("kernel",), "params"), (3, 2, 0, 1))
            )
            sd[f"{ours}.bias"] = take(params, path + ("bias",), "params")
        else:
            sd[f"{ours}.weight"] = take(params, path + ("scale",), "params")
            sd[f"{ours}.bias"] = take(params, path + ("bias",), "params")
            sd[f"{ours}.running_mean"] = take(stats, path + ("mean",), "batch_stats")
            sd[f"{ours}.running_var"] = take(stats, path + ("var",), "batch_stats")
    left = [("params", p) for p in params if ("params", p) not in used]
    left += [("batch_stats", p) for p in stats if ("batch_stats", p) not in used]
    if left:
        raise ValueError(f"unmapped JAX leaves: {['/'.join((t,) + p) for t, p in left][:8]}")
    return sd


def load_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy JAX variables into ``model`` in place (strict: every port
    parameter and buffer must be covered, and nothing else), with the name
    map of ``model``'s family."""
    sd = variables_to_state_dict(variables, "unet" if isinstance(model, UNet) else "fuseunet")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
