"""Network weights made from the run's seed on the card.

Every convolution's weight is He-normal (std sqrt(2 / fan_in)), drawn for
a whole net in one call of a generator on the device; biases are 0,
BatchNorm scales 1 and shifts 0, running means 0 and variances 1. Both the
port and the reference load the same tensors by the port's names.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import nets as ref_nets


def make(model: Dict, seed: int, device, count: int) -> List[Dict[str, torch.Tensor]]:
    """``count`` state dicts of the network ``model`` names, f32 on
    ``device``, from ``seed``."""
    template = ref_nets.build(model).state_dict()
    convs = [(k, v.shape) for k, v in template.items() if k.endswith("weight") and v.ndim == 4]
    total = sum(math.prod(shape) for _, shape in convs)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for _ in range(count):
        flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
        sd, at = {}, 0
        for k, shape in convs:
            n = math.prod(shape)
            fan_in = shape[1] * shape[2] * shape[3]
            sd[k] = flat[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)
            at += n
        for k, v in template.items():
            if k not in sd:
                sd[k] = v.to(device=device, dtype=torch.float32)
        out.append(sd)
    return out
