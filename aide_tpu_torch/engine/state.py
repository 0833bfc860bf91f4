"""Train states: the dual co-teaching pair and the single supervised net.

The counterparts of ``aide_tpu.engine.state.DualTrainState`` and
``TrainState``. Where the JAX package stacks both nets on a leading axis and
vmaps them, the port holds two ``nn.Module``s and ONE optimizer over both
nets' parameters (the optimizers are elementwise, so one optimizer over the union
equals one per net). On a rank of a net axis (``core.mesh``) a
``NetRankState`` holds one net of the pair and its optimizer. Every state
offers ``.nets`` and ``.train(mode)``, so the predict programs and
``checkpoint.snapshot`` take any.
"""

from __future__ import annotations

from typing import Tuple

from torch import nn

from aide_tpu_torch.ops.schedules import OptaxOptimizer


class TrainState:
    """One net and its optimizer (the supervised comparison trainer)."""

    def __init__(self, net: nn.Module, optimizer: OptaxOptimizer):
        self.nets: Tuple[nn.Module, ...] = (net,)
        self.optimizer = optimizer

    @property
    def net(self) -> nn.Module:
        return self.nets[0]

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return self.optimizer.count

    def train(self, mode: bool = True) -> None:
        for net in self.nets:
            net.train(mode)


class DualTrainState(TrainState):
    """The co-teaching pair and one optimizer over both nets."""

    def __init__(self, net1: nn.Module, net2: nn.Module, optimizer: OptaxOptimizer):
        super().__init__(net1, optimizer)
        self.nets = (net1, net2)


class NetRankState(TrainState):
    """Net ``index`` (0 or 1) of the co-teaching pair on one rank of a net
    axis: the net and an optimizer over its parameters and moments alone
    (``pair=True``: its clipping norm spans the pair). The partner rank of
    its pair group holds the other net; ``index`` keeps the step, the
    checkpoints and the history in the pair's terms."""

    def __init__(self, net: nn.Module, index: int, optimizer: OptaxOptimizer):
        super().__init__(net, optimizer)
        self.index = index
