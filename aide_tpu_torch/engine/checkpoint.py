"""Best-epoch exports, the exact-resume files, loading a net's weights back,
and the dual warm start.

The port's counterpart of ``aide_tpu.engine.checkpoint``. At a best epoch
``save_best`` writes, as ``save_best_bundle`` does:

* per net, ``torch.save({'net': state_dict, **meta})`` to
  ``{checkpoint_dir}/{experiment_name}_net{n}_besttraincasedice.pkl`` for net
  n of the co-teaching pair, or ``{experiment_name}_besttraincasedice.pkl``
  for the single supervised net (tensors on the CPU, so the file loads on a
  machine without a card), and beside it ``<file>.json`` with ``meta`` (and
  the net's number for the pair). The meta holds plain types only, so
  ``torch.load(weights_only=True)`` reads the files, and the JAX package's
  ``aide_tpu.interop.import_reference_checkpoint`` too;
* ``{experiment_name}_full.msgpack``, the whole train state in the JAX
  package's format, with its bookkeeping sidecar ``<file>.json``.

The ``_full`` files (and the trainer's ``_last_full`` one) hold
``state_tree``: ``{"step", "params", "batch_stats", "opt_state"}`` as
``flax.serialization.to_bytes`` writes the JAX package's ``state_tree``:
the parameters and BN statistics under the Flax names with the Flax layouts
(``interop.weights``; a network registered outside the zoo, which has no
Flax counterpart, keeps its state-dict names and layouts), both nets
stacked on a leading axis of 2 for the pair, and ``opt_state`` the optax
chain of ``ops.schedules.make_optimizer``:

* ``amsgrad_adam``: ``{"0": {count, mu, nu, nu_max}, "1": {count}}``;
* ``adam``: ``{"0": {count, mu, nu}, "1": {count}}``;
* ``sgd``: ``{"0": {trace}, "1": {count}}``;
* behind clipping and decay, ``{"0": {}, "1": {}, "2": <the above>}``, and
  behind one of them ``{"0": {}, "1": <the above>}``.

Each moment is elementwise in its parameter, so it takes the parameter's
name and layout move; the counts are 0-d int32. So a JAX ``_full`` file
resumes in the port and a port one in the JAX package
(``load_train_state``). ``msgpack_pack`` and ``msgpack_restore`` are an
encoder and a decoder of flax's msgpack on the standard library and NumPy.

``load_net`` reads a ``.pkl`` export, an original AIDE ``.pkl``, or the
JAX package's ``.msgpack`` net export back into a state_dict;
``warm_start_dual`` loads one into both nets of the pair with
symmetry-breaking noise (``aide_tpu.engine.checkpoint.warm_start_dual``);
``export_net`` writes the reference's ``{'net', 'loss', 'epoch'}`` file.

Over a data axis every rank holds the same state; the trainer calls the
writers on the primary rank only, as in the JAX package, and every rank
reads a resume file. On a net axis a rank holds one net of the pair
(``NetRankState``): ``snapshot`` of such a state is a collective of its pair
group that gathers both nets (the primary's partner sends its net, moments
and BN statistics), so the files stay the pair's, byte for byte the JAX
package's format; a resume file gives each rank its net's half, and the
warm start draws both nets' noise and keeps its own.
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

from aide_tpu_torch.core import mesh
from aide_tpu_torch.engine.state import DualTrainState, NetRankState, TrainState
from aide_tpu_torch.interop import weights


def best_net_path(dir_path: str, prefix: str, net: Optional[int] = None) -> str:
    """The best-epoch export of net ``net`` of the pair, or of the single
    net for None."""
    name = f"{prefix}_besttraincasedice.pkl" if net is None else (
        f"{prefix}_net{net}_besttraincasedice.pkl"
    )
    return os.path.join(dir_path, name)


def full_path(dir_path: str, prefix: str, last: bool = False) -> str:
    """The best epoch's ``_full`` file, or the end of a run's ``_last_full``."""
    return os.path.join(dir_path, f"{prefix}_{'last_full' if last else 'full'}.msgpack")


def _local_snapshot(state: TrainState, take) -> Dict[str, Any]:
    """``snapshot`` of the nets this process holds, each tensor through
    ``take``."""
    opt = state.optimizer
    return {
        "nets": [{k: take(v) for k, v in net.state_dict().items()} for net in state.nets],
        "moments": [
            {name: {m: take(opt.state[p][m]) for m in opt.MOMENTS}
             for name, p in net.named_parameters()}
            for net in state.nets
        ],
        "count": int(opt.count),
        "arch": dict(getattr(state.nets[0], "arch", {})),
        "chain": chain_of(opt),
    }


def _gather_pair(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A net axis rank's snapshot of its one net -> the pair's, both nets
    in net order: one ``mesh.pair_exchange`` of every tensor."""
    sd, named = snap["nets"][0], snap["moments"][0]
    keys = [(k, None) for k in sd] + [(name, m) for name in named for m in named[name]]
    tensors = [sd[k] if m is None else named[k][m] for k, m in keys]
    got = mesh.pair_exchange(*tensors)
    nets = [{} for _ in range(2)]
    moments = [{name: {} for name in named} for _ in range(2)]
    for (k, m), both in zip(keys, got):
        for n in range(2):
            if m is None:
                nets[n][k] = both[n]
            else:
                moments[n][k][m] = both[n]
    return dict(snap, nets=nets, moments=moments)


def snapshot(state: TrainState, clone: bool = True) -> Dict[str, Any]:
    """The train state's tensors where they live: each net's state dict,
    each net's optimizer moments ``{parameter name: {moment: tensor}}``,
    the step count, the nets' architecture and the optimizer's chain.
    ``clone`` copies the tensors on their device (the best epoch's state
    for ``checkpoint_flush='end'``: no copy to the host until the files are
    written); without it they are the live tensors. A ``NetRankState``'s
    snapshot is the pair's, gathered over its pair group (a collective of
    both ranks; the gathered tensors are copies)."""
    if isinstance(state, NetRankState):
        return _gather_pair(_local_snapshot(state, lambda t: t.detach()))
    take = (lambda t: t.detach().clone()) if clone else (lambda t: t.detach())
    return _local_snapshot(state, take)


def chain_of(opt) -> Tuple[str, Tuple[str, ...], int]:
    """(optimizer name, its moments, the number of transforms before it:
    clipping and decay) of an optimizer of ``ops.schedules``."""
    return opt.NAME, tuple(opt.MOMENTS), bool(opt.grad_clip_norm) + bool(opt.weight_decay)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sorted(tree):
    """Maps with their keys sorted at every level, as the JAX package's
    state tree is when it writes it (jax.device_get maps it), so that the
    file's bytes are the JAX package's."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _stack(trees: List[Any], stack=np.stack):
    """One tree of the nets' trees, each leaf stacked on a leading net axis
    (one net's tree as it is)."""
    if len(trees) == 1:
        return trees[0]
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)


def _unstack(tree, n: Optional[int]):
    if isinstance(tree, dict):
        return {k: _unstack(v, n) for k, v in tree.items()}
    return tree if n is None else tree[n]


def _opt_state(chain, moments: Dict[str, Any], count: int) -> Dict[str, Any]:
    """The serialised optax chain of ``chain`` (module docstring)."""
    name, names, depth = chain
    c = np.asarray(count, np.int32)
    inner = {m: moments[m] for m in names}
    core = ({"0": inner, "1": {"count": c}} if name == "sgd"
            else {"0": {"count": c, **inner}, "1": {"count": c}})
    if not depth:
        return core
    return {**{str(i): {} for i in range(depth)}, str(depth): core}


def _opt_core(opt_state: Dict[str, Any], chain) -> Dict[str, Any]:
    depth = chain[2]
    return opt_state[str(depth)] if depth else opt_state


def _tree(snap: Dict[str, Any], host, stack) -> Dict[str, Any]:
    """``state_tree`` of a snapshot, each tensor taken to the host by
    ``host`` and the pair's leaves joined by ``stack``."""
    arch = snap["arch"]
    if arch:
        table = weights.name_map(**arch)
        per_net = [weights.state_dict_to_variables({k: host(v) for k, v in sd.items()}, **arch)
                   for sd in snap["nets"]]
        moments = {
            m: _stack([
                weights.state_dict_to_tables(
                    {k: host(v[m]) for k, v in named.items()}, table, stats=False)["params"]
                for named in snap["moments"]
            ], stack)
            for m in snap["chain"][1]
        }
    else:
        # a registered network outside the zoo has no Flax layout: its
        # parameters and buffers by their state-dict names
        per_net = [{"params": {k: host(v) for k, v in sd.items() if k in named},
                    "batch_stats": {k: host(v) for k, v in sd.items() if k not in named}}
                   for sd, named in zip(snap["nets"], snap["moments"])]
        moments = {m: _stack([{k: host(v[m]) for k, v in named.items()}
                              for named in snap["moments"]], stack)
                   for m in snap["chain"][1]}
    return _sorted({
        "step": np.asarray(snap["count"], np.int32),
        "params": _stack([v["params"] for v in per_net], stack),
        "batch_stats": _stack([v.get("batch_stats", {}) for v in per_net], stack),
        "opt_state": _opt_state(snap["chain"], moments, snap["count"]),
    })


def state_tree(state) -> Dict[str, Any]:
    """The JAX package's ``state_tree`` of a train state or of a
    ``snapshot``, as NumPy arrays on the host (module docstring)."""
    snap = state if isinstance(state, dict) else snapshot(state, clone=False)
    return _tree(snap, _host, np.stack)


def _spec_tree(state: TrainState) -> Dict[str, Any]:
    """``state_tree``'s layout, shapes and dtypes without its values: every
    leaf a zero-stride array, so nothing is copied from the device."""
    def host(t: torch.Tensor) -> np.ndarray:
        return np.broadcast_to(torch.empty((), dtype=t.dtype).numpy(), tuple(t.shape))

    def stack(arrays: List[np.ndarray]) -> np.ndarray:
        return np.broadcast_to(arrays[0], (len(arrays),) + arrays[0].shape)

    snap = _local_snapshot(state, lambda t: t)
    if isinstance(state, NetRankState):
        # the pair's layout: both nets have this one's shapes
        snap.update(nets=snap["nets"] * 2, moments=snap["moments"] * 2)
    return _tree(snap, host, stack)


def _leaf_specs(tree, prefix: str = "") -> Dict[str, Tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_specs(v, f"{prefix}{k}/"))
            if not v:
                out[f"{prefix}{k}/"] = ("{}",)  # an empty map is part of the layout
        else:
            out[f"{prefix}{k}"] = (tuple(np.shape(v)), np.asarray(v).dtype.name)
    return out


@torch.no_grad()
def restore_state_tree(state: TrainState, tree: Dict[str, Any], what: str = "the tree") -> None:
    """The inverse of ``state_tree``, in place: the nets' parameters and BN
    statistics, the optimizer's moments and its count (a ``NetRankState``
    its net's half of the pair's tree). The tree must have the state's
    layout leaf for leaf (names, shapes, dtypes, the optimizer chain); a
    mismatch raises naming the differing leaves."""
    opt = state.optimizer
    chain = chain_of(opt)
    model = getattr(state.nets[0], "arch", {}).get("model_name", type(state.nets[0]).__name__)
    _mismatch(f"{what} does not fit this train state (model {model!r}, "
              f"optimizer {chain[0]!r} behind {chain[2]} transforms)",
              _leaf_specs(_spec_tree(state)), _leaf_specs(tree))
    count = int(tree["step"])
    core = _opt_core(tree["opt_state"], chain)
    counts = [int(d["count"]) for d in core.values() if "count" in d]
    if any(c != count for c in counts):
        raise ValueError(f"{what}: the optimizer counts {counts} differ from the step {count}")
    if isinstance(state, NetRankState):
        picks = [state.index]
    else:
        picks = [0, 1] if len(state.nets) == 2 else [None]
    for pick, net in zip(picks, state.nets):
        variables = {"params": _unstack(tree["params"], pick),
                     "batch_stats": _unstack(tree["batch_stats"], pick)}
        arch = getattr(net, "arch", None)
        if arch:
            sd = weights.variables_to_state_dict(variables, **arch)
        else:  # the tree's own (read-only) arrays, copied
            sd = {k: np.array(v) for k, v in {**variables["params"],
                                              **variables["batch_stats"]}.items()}
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        for m in opt.MOMENTS:
            if arch:
                named = weights.tables_to_state_dict(
                    {"params": _unstack(core["0"][m], pick)}, weights.name_map(**arch),
                    stats=False)
            else:
                named = {k: np.array(v) for k, v in _unstack(core["0"][m], pick).items()}
            for name, p in net.named_parameters():
                opt.state[p][m].copy_(torch.from_numpy(named[name]))
    opt.count = count


def _write(path: str, tree: Dict[str, Any], meta: Dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.writelines(msgpack_chunks(tree))
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh, indent=2)


def save_train_state(path: str, state, meta: Dict) -> None:
    """The whole train state (a state or a ``snapshot``) in the JAX
    package's ``_full`` format, and ``meta`` (the bookkeeping) beside it."""
    _write(path, state_tree(state), meta)


def load_train_state(path: str, state: TrainState) -> TrainState:
    """Restore ``state`` in place from a ``_full`` file of either package."""
    with open(path, "rb") as fh:
        tree = msgpack_restore(fh.read())
    restore_state_tree(state, tree, repr(path))
    return state


def save_best(dir_path: str, prefix: str, snap: Dict[str, Any], meta: Dict,
              full_meta: Dict) -> None:
    """All best-epoch files of a ``snapshot``: one ``.pkl`` export and its
    ``.json`` sidecar per net (two nets are the pair's ``_net{n}`` files,
    one the single net's), then ``{prefix}_full.msgpack`` with
    ``full_meta``."""
    os.makedirs(dir_path, exist_ok=True)
    dual = len(snap["nets"]) == 2
    for net, sd in enumerate(snap["nets"], start=1):
        path = best_net_path(dir_path, prefix, net if dual else None)
        host = OrderedDict((k, v.detach().cpu()) for k, v in sd.items())
        torch.save({"net": host, **meta}, path)
        with open(path + ".json", "w") as fh:
            json.dump(dict(meta, net=net) if dual else meta, fh, indent=2)
    save_train_state(full_path(dir_path, prefix), snap, full_meta)


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


def _ndarray(data: memoryview) -> np.ndarray:
    """flax's ndarray record: msgpack (shape, dtype name, C-order bytes),
    read as flax reads it, a read-only view of the bytes; bfloat16 is
    widened to float32 through its bits."""
    if data[0] != 0x93:
        raise ValueError("an ndarray record is not a 3-element msgpack array")
    shape, i = _unpack(data, 1)
    dtype, i = _unpack(data, i)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    kind, width = _SIZED.get(data[i], (None, 0))
    if kind not in ("bin", "str"):
        raise ValueError(f"an ndarray record holds {kind or hex(data[i])}, not its bytes")
    n = int.from_bytes(data[i + 1 : i + 1 + width], "big")
    buf = data[i + 1 + width : i + 1 + width + n]
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _ext(code: int, data: memoryview):
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
        return _ext(code, buf[i + 1 : i + 1 + n]), i + 1 + n
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
        return _ext(code, buf[i + 1 : i + 1 + n]), i + 1 + n
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


_MAX_CHUNK = 2 ** 30 - 2 ** 15  # flax's MAX_CHUNK_SIZE: larger leaves are chunked


class _Chunks:
    """msgpack output as a list of chunks: small items gather in a buffer,
    array payloads go in as views of the arrays, so a large state is
    written to its file without being copied into one bytes object."""

    def __init__(self):
        self.chunks: List[Any] = []
        self.buf = bytearray()

    def raw(self, view) -> None:
        if self.buf:
            self.chunks.append(bytes(self.buf))
            self.buf = bytearray()
        self.chunks.append(view)

    def done(self) -> List[Any]:
        self.raw(b"")
        return self.chunks


def _pack_header(out: bytearray, n: int, fix: Tuple[int, int], codes: Sequence[Tuple[int, int]]) -> None:
    """A msgpack length header: the fix form (first byte, limit) below its
    limit, else the first (code, width) whose width holds ``n``."""
    if fix[1] and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, width in codes:
        if n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"msgpack object of length {n} is too long")


_BIN = ((0xC4, 1), (0xC5, 2), (0xC6, 4))


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b", v) if v < 0 else bytes((v,))
    elif v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= hi:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -(2 ** 7)), (0xD1, ">h", -(2 ** 15)),
                              (0xD2, ">i", -(2 ** 31)), (0xD3, ">q", -(2 ** 63))):
            if v >= lo:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext_header(out: bytearray, code: int, n: int) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_header(out, n, (0, 0), ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
    out += struct.pack(">b", code)


def _pack_ndarray(w: _Chunks, x: np.ndarray, code: int) -> None:
    """flax's ndarray record, msgpack (shape, dtype name, C-order bytes), as
    ext ``code``; the bytes go in as a view of the array."""
    if not x.flags.c_contiguous:
        x = x.copy(order="C")  # (np.ascontiguousarray would make a 0-d array 1-d)
    if x.nbytes > _MAX_CHUNK:
        raise ValueError(f"an array of {x.nbytes} bytes needs flax's chunked form")
    head = _Chunks()
    head.buf.append(0x93)
    _pack(head, list(x.shape))
    _pack(head, x.dtype.name)
    _pack_header(head.buf, x.nbytes, (0, 0), _BIN)
    _pack_ext_header(w.buf, code, len(head.buf) + x.nbytes)
    w.buf += head.buf
    w.raw(memoryview(x.reshape(-1).view(np.uint8)))


def _pack(w: _Chunks, obj) -> None:
    """One object in msgpack-python's encoding (``use_bin_type``), with
    NumPy arrays and scalars as flax's ext types."""
    out = w.buf
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ndarray(w, obj, _EXT_NDARRAY)
    elif isinstance(obj, np.generic):
        _pack_ndarray(w, np.asarray(obj), _EXT_NPSCALAR)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_header(out, len(raw), (0xA0, 32), ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_header(out, len(obj), (0, 0), _BIN)
        out += obj
    elif isinstance(obj, dict):
        _pack_header(out, len(obj), (0x80, 16), ((0xDE, 2), (0xDF, 4)))
        for k, v in obj.items():
            _pack(w, k)
            _pack(w, v)
    elif isinstance(obj, (list, tuple)):
        _pack_header(out, len(obj), (0x90, 16), ((0xDC, 2), (0xDD, 4)))
        for v in obj:
            _pack(w, v)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def msgpack_chunks(tree) -> List[Any]:
    """``msgpack_pack(tree)`` as a list of chunks to write in order."""
    w = _Chunks()
    _pack(w, tree)
    return w.done()


def msgpack_pack(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for a state dict:
    maps with string keys in their order, lists, scalars, NumPy arrays
    (ext 1) and NumPy scalars (ext 3)."""
    return b"".join(msgpack_chunks(tree))


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
    trainers' --resumefile warm start does (a ``NetRankState`` into its
    net, with that net's noise: each rank draws both and keeps its own).

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
    rows = [state.index] if isinstance(state, NetRankState) else [0, 1]
    gen = torch.Generator().manual_seed(seed)
    for name, _ in state.nets[0].named_parameters():
        leaf = sd[name].to(torch.float32)
        scale = noise * (float(leaf.std(correction=0)) + 1e-8)
        draws = torch.randn((2,) + tuple(leaf.shape), generator=gen) * scale
        for net, row in zip(state.nets, rows):
            p = net.get_parameter(name)
            p.add_(draws[row].to(device=p.device, dtype=p.dtype))
