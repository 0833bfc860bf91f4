"""Map the JAX package's model variables to a port model's state_dict, both ways.

``variables`` is the JAX package's ``{'params': ..., 'batch_stats': ...}``
tree as nested dicts of NumPy arrays (``batch_stats`` absent or empty for
GroupNorm models). Names map from the Flax module paths
(``modal1_block3/Conv_0``, ``down_block2/ConvBlock_0/Norm_1/GroupNorm_0``,
``SpatialAttention_2/Conv_3``) to the original PyTorch code's attribute
paths (``modal1_downblock3.block.conv1``, ``down_block2.block.bn2``,
``sa3.conv4``), which the port's modules carry. Layouts move HWIO <-> OIHW
for convs, (kh, kw, in, out) with flipped taps <-> (in, out, kh, kw) for the
learned upsample's ConvTranspose (flax correlates where torch convolves),
(in, out) <-> (out, in) for dense layers, and scale/bias/mean/var <->
weight/bias/running_mean/running_var for norms. An own copy of
``aide_tpu.interop.torch_import``'s name map and
``aide_tpu.interop.torch_export``'s layout moves, with GroupNorm leaves
(scale and bias only) added.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

Table = Dict[Tuple[str, ...], Tuple[str, str]]

# ConvBlock (Flax) <-> basic_block (original code); "norm" rows take the
# norm's own Flax leaf (BatchNorm_0 or GroupNorm_0) from _norm_rows
_CONV_BLOCK = {
    ("Conv_0",): ("conv1", "conv"),
    ("Norm_0",): ("bn1", "norm"),
    ("Conv_1",): ("conv2", "conv"),
    ("Norm_1",): ("bn2", "norm"),
}

# SpatialAttention (Flax) <-> Spatial_Attention (original code)
_SA_BLOCK = {
    ("Conv_0",): ("conv1", "conv"),
    ("Conv_1",): ("conv2", "conv"),
    ("Conv_2",): ("conv3", "conv"),
    ("Conv_3",): ("conv4", "conv"),
    ("Norm_0",): ("bn", "norm"),
}

# ChannelAttention (Flax) <-> the port's ChannelAttention
_CA_BLOCK = {
    ("Dense_0",): ("fc1", "dense"),
    ("Dense_1",): ("fc2", "dense"),
}


def _upsample_conv(learned_bilinear: bool) -> Table:
    # UpsampleConv (Flax) <-> the bilinear_up Sequential: [Upsample, Conv2d,
    # norm, ReLU], or [ConvTranspose2d, norm, ReLU] when learned
    if learned_bilinear:
        return {("ConvTranspose_0",): ("0", "convT"), ("Norm_0",): ("1", "norm")}
    return {("Conv_0",): ("1", "conv"), ("Norm_0",): ("2", "norm")}


def _prefix(table: Table, flax: Tuple[str, ...], ours: str) -> Table:
    return {flax + sub: (f"{ours}.{t}", kind) for sub, (t, kind) in table.items()}


def _up_block(learned_bilinear: bool) -> Table:
    return {
        **_prefix(_upsample_conv(learned_bilinear), ("UpsampleConv_0",), "bilinear_up"),
        **_prefix(_CONV_BLOCK, ("ConvBlock_0",), "block"),
    }


# the standalone blocks of models/blocks.py, for their tests
BLOCK_TABLES: Dict[str, Table] = {
    "FeatureRefine": _CONV_BLOCK,
    "ChannelAttention": _CA_BLOCK,
    "SpatialAttention": _SA_BLOCK,
    "BottleneckAttention": {
        **_prefix(_CA_BLOCK, ("ChannelAttention_0",), "ca"),
        **_SA_BLOCK,
    },
    "CAUpBlock": {
        **_prefix(_upsample_conv(False), ("UpsampleConv_0",), "bilinear_up"),
        **_prefix(_CA_BLOCK, ("ChannelAttention_0",), "ca"),
        **_prefix(_CONV_BLOCK, ("ConvBlock_0",), "block"),
    },
}


def _norm_rows(table: Table, norm: str) -> Table:
    """Resolve each "norm" row to the Flax leaf and kind of ``norm``."""
    leaf, kind = {"batch": ("BatchNorm_0", "bn"), "group": ("GroupNorm_0", "gn")}[norm]
    return {
        (path + (leaf,) if k == "norm" else path): (ours, kind if k == "norm" else k)
        for path, (ours, k) in table.items()
    }


def block_name_map(block: str, norm: str = "batch") -> Table:
    """{Flax module path: (port module name, kind)} of one block of
    ``models/blocks.py`` (``CAUpBlock`` with the bilinear upsample)."""
    return _norm_rows(BLOCK_TABLES[block], norm)


def name_map(model_name: str = "fuseunet", learned_bilinear: bool = False,
             norm: str = "batch") -> Table:
    """{Flax module path: (port module name, kind)} of a model of the JAX
    registry: the FuseUNet variants (``fuseunet``, ``fuseunetsa``,
    ``fuseunetsaseparate``) or the UNet family (``unet``, ``unetsa``,
    ``unet2`` ... ``unet128``). The JAX UNet's encoder blocks hold their
    ConvBlock one level deeper (``down_block{k}/ConvBlock_0``) than
    FuseUNet's (``modal{m}_block{k}``), and its gates are auto-named
    (``SpatialAttention_{k-1}``)."""
    table: Table = {}
    if model_name in ("fuseunet", "fuseunetsa", "fuseunetsaseparate"):
        for k in range(1, 6):
            for m in (1, 2):
                table.update(_prefix(_CONV_BLOCK, (f"modal{m}_block{k}",),
                                     f"modal{m}_downblock{k}.block"))
                if model_name != "fuseunet":
                    table.update(_prefix(_SA_BLOCK, (f"modal{m}_sa{k}",), f"modal{m}_sa{k}"))
    elif model_name.startswith("unet"):
        for k in range(1, 6):
            table.update(_prefix(_CONV_BLOCK, (f"down_block{k}", "ConvBlock_0"),
                                 f"down_block{k}.block"))
            if model_name == "unetsa":
                table.update(_prefix(_SA_BLOCK, (f"SpatialAttention_{k - 1}",), f"sa{k}"))
    else:
        raise ValueError(f"no weight mapping for model {model_name!r}")
    for j in range(1, 5):
        table.update(_prefix(_up_block(learned_bilinear), (f"up_block{j}",), f"up_block{j}"))
    table[("Conv_0",)] = ("last_conv1", "conv")
    return _norm_rows(table, norm)


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def leaf_paths(variables: Mapping[str, Any]) -> Dict[str, Tuple[int, ...]]:
    """{'collection/module/.../leaf': shape} of a variables tree."""
    return {"/".join(p): tuple(np.shape(v)) for p, v in _leaves(variables)}


def tables_to_state_dict(variables: Mapping[str, Any], table: Table,
                         stats: bool = True) -> Dict[str, np.ndarray]:
    """JAX variables -> the port's state_dict (NumPy float32 arrays) through
    ``table``. Raises if a JAX leaf is missing or left over. ``stats=False``
    maps a tree of ``params`` alone (an optimizer moment, elementwise in
    the parameters) to the parameters' names."""
    params = dict(_leaves(variables["params"]))
    bn_stats = dict(_leaves(variables.get("batch_stats", {})))
    used = set()

    def take(tree, path, tag):
        if path not in tree:
            raise KeyError(f"JAX variables have no {tag}/{'/'.join(path)}")
        used.add((tag, path))
        return np.array(tree[path], dtype=np.float32)  # a writable copy

    sd: Dict[str, np.ndarray] = {}
    for path, (ours, kind) in table.items():
        if kind in ("bn", "gn"):
            sd[f"{ours}.weight"] = take(params, path + ("scale",), "params")
            sd[f"{ours}.bias"] = take(params, path + ("bias",), "params")
            if kind == "bn" and stats:
                sd[f"{ours}.running_mean"] = take(bn_stats, path + ("mean",), "batch_stats")
                sd[f"{ours}.running_var"] = take(bn_stats, path + ("var",), "batch_stats")
            continue
        k = take(params, path + ("kernel",), "params")
        if kind == "conv":
            k = np.transpose(k, (3, 2, 0, 1))  # HWIO -> OIHW
        elif kind == "convT":
            k = np.transpose(k[::-1, ::-1], (2, 3, 0, 1))  # unflip, then (in, out, kh, kw)
        else:  # dense
            k = k.T
        sd[f"{ours}.weight"] = np.ascontiguousarray(k)
        sd[f"{ours}.bias"] = take(params, path + ("bias",), "params")
    left = [("params", p) for p in params if ("params", p) not in used]
    left += [("batch_stats", p) for p in bn_stats if ("batch_stats", p) not in used]
    if left:
        raise ValueError(f"unmapped JAX leaves: {['/'.join((t,) + p) for t, p in left][:8]}")
    return sd


def state_dict_to_tables(state_dict: Mapping[str, Any], table: Table,
                         stats: bool = True) -> Dict[str, Any]:
    """The inverse: a port state_dict -> JAX ``{'params', 'batch_stats'}``
    (``batch_stats`` only where the table has BatchNorm rows and ``stats``
    is set; without it, ``state_dict`` may hold the parameters alone)."""
    def arr(name):
        v = state_dict[name]
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    params: Dict[str, Any] = {}
    bn_stats: Dict[str, Any] = {}

    def put(tree, path, leaf, value):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value

    for path, (ours, kind) in table.items():
        if kind in ("bn", "gn"):
            put(params, path, "scale", arr(f"{ours}.weight"))
            if kind == "bn" and stats:
                put(bn_stats, path, "mean", arr(f"{ours}.running_mean"))
                put(bn_stats, path, "var", arr(f"{ours}.running_var"))
        else:
            k = arr(f"{ours}.weight")
            if kind == "conv":
                k = np.transpose(k, (2, 3, 1, 0))
            elif kind == "convT":
                k = np.transpose(k, (2, 3, 0, 1))[::-1, ::-1]
            else:
                k = k.T
            put(params, path, "kernel", k)
        put(params, path, "bias", arr(f"{ours}.bias"))
    return {"params": params, **({"batch_stats": bn_stats} if bn_stats else {})}


def variables_to_state_dict(
    variables: Mapping[str, Any], model_name: str = "fuseunet",
    learned_bilinear: bool = False, norm: str = "batch",
) -> Dict[str, np.ndarray]:
    """JAX variables of ``model_name`` (with its upsample and norm options)
    -> the port's state_dict (NumPy arrays). Raises if a JAX leaf is
    missing or left over."""
    return tables_to_state_dict(variables, name_map(model_name, learned_bilinear, norm))


def state_dict_to_variables(
    state_dict: Mapping[str, Any], model_name: str = "fuseunet",
    learned_bilinear: bool = False, norm: str = "batch",
) -> Dict[str, Any]:
    """A port state_dict of ``model_name`` -> the JAX package's variables."""
    return state_dict_to_tables(state_dict, name_map(model_name, learned_bilinear, norm))


def load_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy JAX variables into ``model`` in place (strict: every port
    parameter and buffer must be covered, and nothing else), with the name
    map of ``model``'s architecture (its ``arch``: name, upsample, norm)."""
    sd = variables_to_state_dict(variables, **model.arch)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
