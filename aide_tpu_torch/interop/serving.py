"""Self-contained serving artifacts via ``torch.export``.

The counterpart of ``aide_tpu.interop.serving``: one network's weights are
BAKED INTO an exported program (symbolic batch dimension, fixed image
size), so that any later PyTorch process, a serving binary among them, runs
it with ``torch.export.load`` alone, without aide_tpu_torch or the model
code. The program maps normalized NHWC float32 images (one or two
modalities, each ``(b, img_size, img_size, 3)``) to float32 softmax
probabilities ``(b, H, W, C)``, computing in the model's own compute dtype.

An exported program keeps the autocast region of the device it was traced
on: a program traced on the host and run on the card would compute in
float32 without a word. So the artifact holds one program for each platform
it was traced on (the counterpart of ``jax.export``'s multi-platform
lowering), and the loader refuses a device whose platform it lacks.

The file layout, which a reader needs only the standard library and
``torch.export.load`` for::

    b"AIDETRC1"                     8 bytes, the magic
    header length n                 u64, little-endian
    header                          n bytes of UTF-8 JSON
    payloads                        concatenated

    import io, json, torch
    with open(path, "rb") as fh:
        blob = fh.read()
    assert blob[:8] == b"AIDETRC1"
    n = int.from_bytes(blob[8:16], "little")
    header = json.loads(blob[16:16 + n])
    start, size = header["payloads"]["cuda"]  # or "cpu"
    begin = 16 + n + start
    program = torch.export.load(io.BytesIO(blob[begin:begin + size])).module()
    with torch.no_grad():
        probs = program(images)  # program(modal1, modal2) when two_modal

The header holds the JAX artifact's keys (``img_size``, ``two_modal``,
``input_dtype``, ``weights_dtype``, ``platforms``, ``output`` and the
caller's ``meta``), ``torch_version`` in place of ``jax_version``, and
``payloads``: for each platform ``[offset, length]`` of its program,
counted from the first byte after the header. Each payload is a
``torch.export.save`` archive whose records other than the weights are
deflated (the graph's JSON is most of a small net's program).
"""

from __future__ import annotations

import copy
import io
import json
import os
import zipfile
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
from torch import nn

MAGIC = b"AIDETRC1"
# the JAX package's StableHLO artifacts (aide_tpu.interop.serving.MAGIC)
JAX_MAGIC = b"AIDETPU1"
WEIGHTS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PLATFORMS = ("cuda", "cpu")


class _Serve(nn.Module):
    """``softmax(net(*images), -1)`` in float32. The net's bfloat16 leaves
    are widened to float32 before the net runs, so that they meet the net
    (and its own autocast) as the float32 model with bf16-rounded weights,
    BatchNorm statistics included. A float32 leaf is left alone: its cast
    would change nothing and slow the trace."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, *images: torch.Tensor) -> torch.Tensor:
        leaves = {name: t.float()
                  for name, t in [*self.net.named_parameters(), *self.net.named_buffers()]
                  if t.dtype == torch.bfloat16}
        logits = torch.func.functional_call(self.net, leaves, images)
        return torch.softmax(logits.float(), dim=-1)


def _deflated(archive: bytes) -> bytes:
    """``archive`` (a torch.export.save zip) with every record but the
    weights deflated; torch.export.load reads either."""
    out = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(archive)) as src, zipfile.ZipFile(out, "w") as dst:
        for info in src.infolist():
            weights = "/data/weights/weight_" in info.filename
            dst.writestr(info.filename, src.read(info.filename),
                         compress_type=zipfile.ZIP_STORED if weights else zipfile.ZIP_DEFLATED)
    return out.getvalue()


def _export_program(net: nn.Module, img_size: int, two_modal: bool, weights_dtype: torch.dtype,
                    platform: str) -> bytes:
    """One platform's program: a copy of ``net`` on that platform's device,
    its floating leaves rounded once to ``weights_dtype``, traced in eval
    mode under no_grad from a batch of 2 (an example of 1 would specialise
    the batch to 1)."""
    device = torch.device(platform)
    # contiguous leaves: torch.export.save takes a channels_last leaf for a
    # partial view of its storage and rebuilds it with a warning
    serve = _Serve(copy.deepcopy(net)).to(device, memory_format=torch.contiguous_format)
    serve.eval().requires_grad_(False)
    serve.net.to(dtype=weights_dtype)  # floating parameters and buffers only
    images = tuple(torch.zeros(2, img_size, img_size, 3, device=device)
                   for _ in range(2 if two_modal else 1))
    batch = torch.export.Dim("b")
    with torch.no_grad():
        program = torch.export.export(
            serve, images, dynamic_shapes=(tuple({0: batch} for _ in images),))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return _deflated(buf.getvalue())


def export_serving_artifact(
    path: str,
    net: nn.Module,
    img_size: int,
    two_modal: bool,
    meta: Dict | None = None,
    weights_dtype: str = "float32",
    platforms: Sequence[str] | None = None,
) -> None:
    """Write ``net``'s serving artifact to ``path`` (the layout is in the
    module docstring); ``net`` itself is left as it was.

    ``weights_dtype="bfloat16"`` rounds every floating leaf (parameters and
    BatchNorm statistics) once to bf16 and stores it so, halving the
    artifact; the program widens the leaves back to float32 before the
    model's own autocast, so it equals the float32 model evaluated with the
    rounded weights. ``platforms`` names the devices to trace a program on,
    out of "cuda" (the card) and "cpu"; by default both when a card is
    present, else "cpu"."""
    if weights_dtype not in WEIGHTS_DTYPES:
        raise ValueError(f"weights_dtype must be float32 or bfloat16, got {weights_dtype!r}")
    if platforms is None:
        platforms = PLATFORMS if torch.cuda.is_available() else ("cpu",)
    platforms = tuple(platforms)
    if not platforms or not set(platforms) <= set(PLATFORMS) or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms must be distinct names out of {PLATFORMS}, got {platforms!r}")
    payloads, offsets, offset = [], {}, 0
    for platform in platforms:
        payload = _export_program(net, img_size, two_modal, WEIGHTS_DTYPES[weights_dtype], platform)
        payloads.append(payload)
        offsets[platform] = [offset, len(payload)]
        offset += len(payload)

    header = dict(meta or {})
    header.update(
        img_size=int(img_size),
        two_modal=bool(two_modal),
        input_dtype="float32",
        weights_dtype=weights_dtype,
        platforms=list(platforms),
        output="softmax probabilities (B, H, W, C), float32",
        torch_version=torch.__version__,
        payloads=offsets,
    )
    hdr = json.dumps(header).encode()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(MAGIC)
        fh.write(len(hdr).to_bytes(8, "little"))
        fh.write(hdr)
        for payload in payloads:
            fh.write(payload)
    os.replace(tmp, path)


def load_serving_artifact(path: str, device=None) -> Tuple[Callable[..., torch.Tensor], Dict]:
    """(callable, header). The callable takes the NHWC float32 image
    tensor(s), or numpy arrays, moves them to ``device`` (default: the CUDA
    card) and returns float32 probabilities there, from the program traced
    for ``device``'s platform; no aide_tpu_torch model code is involved.
    Raises ValueError when the artifact holds no program for that
    platform."""
    from aide_tpu_torch.engine.trainer import resolve_device

    device = resolve_device(device)
    with open(path, "rb") as fh:
        magic = fh.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                f"{path!r} is a StableHLO serving artifact of the JAX package (aide_tpu); "
                "load it with aide_tpu.interop.serving, not torch.export")
        if magic != MAGIC:
            raise ValueError(f"{path!r} is not an aide_tpu_torch serving artifact")
        n = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(n).decode())
        start = len(MAGIC) + 8 + n
        if device.type not in header["payloads"]:
            raise ValueError(
                f"{path!r} holds no program for {device.type!r}: it was traced for "
                f"{header['platforms']}; export it again with that platform")
        offset, size = header["payloads"][device.type]
        fh.seek(start + offset)
        program = torch.export.load(io.BytesIO(fh.read(size))).module()

    def serve(*images: Any) -> torch.Tensor:
        with torch.no_grad():
            return program(*(torch.as_tensor(x, dtype=torch.float32, device=device)
                             for x in images))

    return serve, header
