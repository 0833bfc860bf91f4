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

``load_net`` reads such a file, an original AIDE ``.pkl``, or the JAX
package's ``.msgpack`` net export (``msgpack_restore``, a decoder of what
``flax.serialization.to_bytes`` writes, on the standard library and numpy)
back into a state_dict; ``warm_start_dual`` loads one into both nets of the
pair with symmetry-breaking noise (``aide_tpu.engine.checkpoint.
warm_start_dual``); ``export_net`` writes the reference's
``{'net', 'loss', 'epoch'}`` file.

Not carried yet (ROADMAP Queue 1 item 3): the ``_full`` and ``_last_full``
exact-resume files with their bookkeeping sidecar, and exact resume.
"""

from __future__ import annotations

import json
import os
import struct
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from aide_tpu_torch.engine.state import DualTrainState, TrainState
from aide_tpu_torch.interop import weights

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


def read_meta(path: str) -> Dict:
    """The ``.json`` sidecar of a checkpoint."""
    with open(path + ".json") as fh:
        return json.load(fh)


def export_net(path: str, state_dict: Dict[str, torch.Tensor], meta: Dict) -> None:
    """Write ``{'net': state_dict, **meta}`` in the reference's layout:
    contiguous tensors, and the BatchNorms' ``num_batches_tracked`` (a 0-d
    0, as ``nn.BatchNorm2d`` holds it) beside their running statistics."""
    sd = OrderedDict()
    for k, v in state_dict.items():
        sd[k] = v.detach().cpu().contiguous()
        if k.endswith(".running_var"):
            sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"net": sd, **meta}, path)


# ---------------------------- flax msgpack ----------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# fixed-width scalars: first byte -> (struct format, size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# sized types: first byte -> (kind, width of the length field)
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray record: msgpack (shape, dtype name, C-order bytes);
    bfloat16 is widened to float32 through its bits."""
    (shape, dtype, buf), _ = _unpack(memoryview(data), 0)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).copy().reshape(shape)


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        (re, im), _ = _unpack(memoryview(data), 0)
        return complex(re, im)
    raise ValueError(f"unknown msgpack ext type {code}")


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    """One msgpack object at ``buf[i:]``: (value, index after it)."""
    b = buf[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, i, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, i, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(buf[i : i + n], "utf-8"), i + n
    if b == 0xC0:
        return None, i
    if b in (0xC2, 0xC3):
        return b == 0xC3, i
    if b in _FIXED:
        fmt, size = _FIXED[b]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if b in _FIXEXT:
        n = _FIXEXT[b]
        code = struct.unpack_from(">b", buf, i)[0]
        return _ext(code, bytes(buf[i + 1 : i + 1 + n])), i + 1 + n
    if b not in _SIZED:
        raise ValueError(f"invalid msgpack byte 0x{b:02x} at {i - 1}")
    kind, width = _SIZED[b]
    n = int.from_bytes(buf[i : i + width], "big")
    i += width
    if kind == "map":
        return _unpack_map(buf, i, n)
    if kind == "array":
        return _unpack_array(buf, i, n)
    if kind == "ext":
        code = struct.unpack_from(">b", buf, i)[0]
        return _ext(code, bytes(buf[i + 1 : i + 1 + n])), i + 1 + n
    raw = bytes(buf[i : i + n])
    return (raw.decode("utf-8") if kind == "str" else raw), i + n


def _unpack_map(buf: memoryview, i: int, n: int):
    out = {}
    for _ in range(n):
        key, i = _unpack(buf, i)
        out[key], i = _unpack(buf, i)
    return out, i


def _unpack_array(buf: memoryview, i: int, n: int):
    out = []
    for _ in range(n):
        item, i = _unpack(buf, i)
        out.append(item)
    return out, i


def _unchunk(tree):
    """flax's chunked leaves (arrays over its MAX_CHUNK_SIZE, written as
    ``{'__msgpack_chunked_array__': True, 'shape': {"0": ...}, 'chunks':
    {"0": ...}}``) back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``
    (maps, lists, str/bin, ints, floats, None, bools, numpy arrays and
    scalars), with bfloat16 arrays widened to float32."""
    tree, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the msgpack object")
    return _unchunk(tree)


# ------------------------------- loading -------------------------------


def _mismatch(what: str, want: Dict[str, Tuple], got: Dict[str, Tuple]) -> None:
    """Raise a readable error when two {name: shape} maps differ."""
    if want == got:
        return
    missing = sorted(set(want) - set(got))[:4]
    extra = sorted(set(got) - set(want))[:4]
    shapes = [f"{k}: file{got[k]} != model{want[k]}"
              for k in sorted(set(want) & set(got)) if want[k] != got[k]][:4]
    raise ValueError(f"{what} (missing={missing}, extra={extra}, shape_mismatches={shapes})")


def load_net(path: str, net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """A net's state_dict from a checkpoint file.

    ``.pkl``: the port's exports and the original AIDE trainers'
    ``{'net': state_dict, ...}`` files, or a bare state_dict;
    ``num_batches_tracked``, which the port's BatchNorm does not carry, is
    dropped. ``.msgpack``: the JAX package's net export
    (``{'params', 'batch_stats'}``), mapped through ``interop.weights`` with
    the name map of ``net``'s architecture, which it needs. With ``net``,
    names and shapes must fit it; a mismatch raises naming the missing,
    extra and misshapen entries."""
    if path.endswith(".msgpack"):
        if net is None:
            raise ValueError(f"{path!r}: a .msgpack export needs the model it belongs to")
        with open(path, "rb") as fh:
            variables = msgpack_restore(fh.read())
        # the model's own tree, from its shapes alone (no copy of its weights)
        template = weights.state_dict_to_variables(
            {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in net.state_dict().items()},
            **net.arch,
        )
        _mismatch(f"{path!r} does not fit model {net.arch['model_name']!r}",
                  weights.leaf_paths(template), weights.leaf_paths(variables))
        sd = weights.variables_to_state_dict(variables, **net.arch)
        return OrderedDict((k, torch.from_numpy(v)) for k, v in sd.items())
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("net"), dict):
        obj = obj["net"]
    if not isinstance(obj, dict) or not obj or not all(
        isinstance(v, torch.Tensor) for v in obj.values()
    ):
        raise ValueError(f"{path!r} does not hold a state_dict")
    sd = OrderedDict((k, v) for k, v in obj.items() if not k.endswith("num_batches_tracked"))
    if net is not None:
        _mismatch(f"{path!r} does not fit the model",
                  {k: tuple(v.shape) for k, v in net.state_dict().items()},
                  {k: tuple(v.shape) for k, v in sd.items()})
    return sd


@torch.no_grad()
def warm_start_dual(state: DualTrainState, path: str, noise: float = 1e-3, seed: int = 0) -> None:
    """Load one net's export (``load_net``: a ``.pkl`` or a JAX ``.msgpack``
    net export) into BOTH nets of the pair, in place, as the kidney
    trainers' --resumefile warm start does.

    With ``noise``, each parameter of each net gets independent Gaussian
    noise of std ``noise * (std(leaf) + 1e-8)``, the leaf's population std,
    drawn on the CPU from a generator seeded by ``seed`` (the same numbers
    on any device). Without it two identical nets on identical batches get
    identical gradients forever and co-teaching degenerates into
    self-training. BatchNorm running statistics are copied without noise."""
    sd = load_net(path, state.nets[0])
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
