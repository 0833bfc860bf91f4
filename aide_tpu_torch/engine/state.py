"""Train state of the dual-network co-teaching pair.

The counterpart of ``aide_tpu.engine.state.DualTrainState``: where the JAX
package stacks both nets on a leading axis and vmaps them, the port holds
two ``nn.Module``s and ONE optimizer over both nets' parameters (AMSGrad is
elementwise, so one optimizer over the union equals one per net).
"""

from __future__ import annotations

from typing import Tuple

from torch import nn

from aide_tpu_torch.ops.schedules import AMSGrad


class DualTrainState:
    def __init__(self, net1: nn.Module, net2: nn.Module, optimizer: AMSGrad):
        self.nets: Tuple[nn.Module, nn.Module] = (net1, net2)
        self.optimizer = optimizer

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return self.optimizer.count

    def train(self, mode: bool = True) -> None:
        for net in self.nets:
            net.train(mode)
