"""Name -> factory registries for models, tasks and losses.

The port's own copy of ``aide_tpu.core.registry``: every network registers
a factory that takes a ``ModelConfig`` under its name, every task its class
under its name, and ``models.build_model`` / ``data.tasks.build_task`` look
the names up here. A user adds a network or a dataset without editing the
port::

    from aide_tpu_torch.core import MODELS

    @MODELS.register("mynet")
    def mynet(model_cfg):
        return MyNet(num_classes=model_cfg.num_classes)

and names it in a config (``model.name=mynet``). A model's forward takes
(B, H, W, 3) images (two of them when its name starts with "fuseunet") and
returns (B, H, W, num_classes) float32 logits, as the built-in ones do.
"""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Callable] = {}

    def register(self, name: str):
        def deco(fn):
            if name in self._items:
                raise KeyError(f"{self.kind} {name!r} already registered")
            self._items[name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        if name not in self._items:
            raise KeyError(
                f"unknown {self.kind} {name!r}; available: {sorted(self._items)}"
            )
        return self._items[name]

    def names(self):
        return sorted(self._items)

    def __contains__(self, name):
        return name in self._items


MODELS = Registry("model")
TASKS = Registry("task")
LOSSES = Registry("loss")
