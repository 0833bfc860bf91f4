"""A train step replayed as one CUDA graph.

``StepGraphs`` runs a train step's device work, ``body(state, batch,
*extras, scalars)``: the batch (a dict of tensors), the step's other
tensors (the view parameters), and ``scalars``, the step's per-step host
numbers (the co-teaching rate's terms, the optimizer's ``hyper()``) as one
f32 vector on the batch's device. Where ``replayable`` holds, the first
``WARM_STEPS`` steps of a state and input shapes run eagerly on a side
stream (the warp kernel's library, cuDNN's and cuBLAS's handles and
workspaces, every kernel's module come to exist), the next one is
captured once as a ``torch.cuda.CUDAGraph`` and replayed, and so is every
later step: the batch, the extras and the scalars are copied into the
graph's input buffers in stream order, the graph replays on the current
stream, and its outputs are cloned, so a later replay overwrites nothing
a caller holds. The optimizer's host step count advances as the captured
``step`` advanced it. A replay calls no Python of the step: the step's
own spans (``step.*``) close only on eager steps, and the kernels the
graph holds (the warp kernel's among them) launch without their host
calls, so ``warp.launches`` counts only the eager and captured steps'
launches; a device trace shows the replayed ones.

The rule reads only what the code can observe: a CUDA batch, one process
(no data, net or space axis, whose collectives stay eager), a
``DualTrainState`` or ``TrainState`` (not a ``NetRankState``), no
``TorchDispatchMode`` active (a FLOP counter sees every op) and no stream
capture running. Otherwise the step runs eagerly on the current stream,
with the same scalars as a device vector. Each step adds one to one of
the counters ``train.graph_replays``, ``train.graph_captures`` and
``train.graph_eager`` (``core.trace``).

A graph is kept per (state, its optimizer, the inputs' names, shapes and
dtypes, the scalars' count) and lives as long as the ``StepGraphs`` that
holds it, which is the step function of one ``Trainer``. A capture that
fails leaves the state as it was, warns, and runs that key eagerly from
then on.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _python_dispatch

from aide_tpu_torch.core import mesh, trace
from aide_tpu_torch.engine.state import NetRankState, TrainState

WARM_STEPS = 2


def device_scalars(values: Sequence[float], device: torch.device) -> torch.Tensor:
    """``values`` as an f32 vector on ``device``; to a card from pinned host
    memory, without waiting for the card."""
    src = torch.tensor(values, dtype=torch.float32, pin_memory=device.type == "cuda")
    return src.to(device, non_blocking=True)


def replayable(state, device: torch.device) -> bool:
    """Whether a step of ``state`` on ``device`` may run as a CUDA graph."""
    return (device.type == "cuda" and mesh.world_size() == 1
            and isinstance(state, TrainState) and not isinstance(state, NetRankState)
            and _python_dispatch._get_current_dispatch_mode() is None
            and not torch.cuda.is_current_stream_capturing())


class _Graph:
    """One key's graph: the eager steps taken so far, then the graph, its
    input buffers and outputs, and what a replay repeats on the host."""

    def __init__(self, state):
        # held, so that their ids in the key are not reused
        self.state, self.optimizer = state, state.optimizer
        self.warm = self.replays = 0
        self.failed = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: List[torch.Tensor] = []
        self.scalars: Optional[torch.Tensor] = None
        self.outputs: Dict[str, torch.Tensor] = {}
        self.advance = 0
        self.modes: List[bool] = []


class StepGraphs:
    """The graphs of one train step function (module docstring)."""

    def __init__(self):
        self._graphs: Dict[tuple, _Graph] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def __call__(self, body: Callable, state, batch: Dict[str, torch.Tensor],
                 extras: Sequence[torch.Tensor], host: Sequence[float]
                 ) -> Dict[str, torch.Tensor]:
        names = tuple(batch)
        leaves = [batch[k] for k in names] + list(extras)
        device = leaves[0].device
        if not replayable(state, device):
            trace.add("train.graph_eager")
            return body(state, batch, *extras, device_scalars(host, device))
        key = (id(state), id(state.optimizer), names, len(host)) + tuple(
            (tuple(t.shape), t.dtype) for t in leaves)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _Graph(state)
        if not g.failed and g.warm < WARM_STEPS:
            g.warm += 1
            trace.add("train.graph_eager")
            return self._on_side_stream(body, state, batch, extras, host, device)
        if g.failed or (g.graph is None
                        and not self._capture(g, body, state, names, leaves, host, device)):
            trace.add("train.graph_eager")
            return body(state, batch, *extras, device_scalars(host, device))
        if g.replays:
            state.optimizer.count += g.advance
        trace.add("train.graph_replays" if g.replays else "train.graph_captures")
        g.replays += 1
        for dst, src in zip(g.inputs, leaves):
            dst.copy_(src, non_blocking=True)
        g.scalars.copy_(torch.tensor(host, dtype=torch.float32, pin_memory=True),
                        non_blocking=True)
        g.graph.replay()
        for net, mode in zip(state.nets, g.modes):
            if net.training != mode:
                net.train(mode)
        return {k: v.clone() for k, v in g.outputs.items()}

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _on_side_stream(self, body, state, batch, extras, host, device):
        """An eager step on the stream that captures, ordered after the
        current stream's work and before its later work."""
        scalars = device_scalars(host, device)
        current, side = torch.cuda.current_stream(device), self._side_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = body(state, batch, *extras, scalars)
        current.wait_stream(side)
        return out

    def _capture(self, g: _Graph, body, state, names, leaves, host, device) -> bool:
        """Capture ``body`` on the key's input buffers; False, with the
        state's host step count restored and a warning, where it fails."""
        g.inputs = [torch.empty_like(t, device=device) for t in leaves]
        g.scalars = torch.empty(len(host), dtype=torch.float32, device=device)
        count = state.optimizer.count
        n = len(names)
        batch = dict(zip(names, g.inputs[:n]))
        graph = torch.cuda.CUDAGraph()
        side = self._side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                outputs = body(state, batch, *g.inputs[n:], g.scalars)
        except Exception as exc:  # noqa: BLE001 - any op the capture refuses
            state.optimizer.count, state.optimizer.given = count, None
            g.failed, g.inputs, g.scalars = True, [], None
            warnings.warn(f"the train step could not be captured as a CUDA graph ({exc}); "
                          "it runs eagerly", RuntimeWarning, stacklevel=3)
            return False
        g.graph, g.outputs = graph, outputs
        g.advance = state.optimizer.count - count
        g.modes = [net.training for net in state.nets]
        return True
