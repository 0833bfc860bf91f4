"""aide_tpu_torch.data.tasks: the tasks, each registered under its name in
``core.registry.TASKS`` as its module is imported, and the factory the
Trainer uses."""

from aide_tpu_torch.core.registry import TASKS
from aide_tpu_torch.data.tasks.base import SliceSpec, Task  # noqa: F401
from aide_tpu_torch.data.tasks.breast import BreastTask  # noqa: F401
from aide_tpu_torch.data.tasks.chaos import ChaosTask  # noqa: F401
from aide_tpu_torch.data.tasks.kidney import KidneyTask  # noqa: F401
from aide_tpu_torch.data.tasks.prostate import ProstateTask  # noqa: F401
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask


def build_task(cfg) -> Task:
    """The task a TrainConfig names, as ``aide_tpu.data.tasks.build_task``
    builds it: ``synthetic`` gets its generator defaults from the config;
    every task takes ``data.task_options`` verbatim (they win over the
    defaults), and every other task, a user's registered one too, takes
    ``data.mask_identity``."""
    d = cfg.data
    if d.task == "synthetic":
        kw = dict(
            root=d.root or "./synthetic_data",
            tempmask_folder=d.tempmask_folder or "tempmasks",
            noisy_fraction=0.5,
            num_classes=cfg.model.num_classes,
            seed=cfg.seed,
        )
        kw.update(d.task_options)
        return SyntheticTask(**kw)
    return TASKS.get(d.task)(
        root=d.root, tempmask_folder=d.tempmask_folder, mask_identity=d.mask_identity,
        **d.task_options,
    )
