"""What the window drivers share: the run's context, the port's config
from a cell's files, the profiled stretch, and the card's memory."""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from typing import Dict, Optional

from benchmark import trace


@dataclasses.dataclass
class Context:
    cell: str
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    workdir: str
    t_process: float

    def log(self, msg: str) -> None:
        print(f"# {msg}", file=sys.stderr, flush=True)


def data_spec(config: Dict, seed: int) -> Dict:
    """The synthetic dataset's parameters (``benchmark.reference.data``)."""
    keys = ("img_size", "two_modal", "train_cases", "slices_per_case", "test_cases",
            "test_case_offset", "clean_cases", "noisy_fraction")
    return {**{k: config[k] for k in keys}, "seed": seed}


def task_options(data: Dict) -> Dict:
    """The port's SyntheticTask arguments for ``data``."""
    return dict(two_modal=data["two_modal"], num_cases=data["train_cases"],
                slices_per_case=data["slices_per_case"], size=data["img_size"],
                noisy_fraction=data["noisy_fraction"], clean_cases=data["clean_cases"],
                num_test_cases=data["test_cases"], test_case_offset=data["test_case_offset"],
                seed=data["seed"])


def train_config(config: Dict, variant: str, seed: int, workdir: str, eval_batch: int = 0):
    """The port's TrainConfig of a cell: the configuration's network,
    sizes and schedule; its files under ``workdir``."""
    from aide_tpu_torch.core.config import ModelConfig, TrainConfig

    m = config["model"]
    cfg = TrainConfig()
    cfg.model = ModelConfig(name=m["name"], base_width=m["base_width"],
                            num_classes=m["num_classes"], compute_dtype=m["compute_dtype"],
                            norm=m["norm"])
    cfg.seed = seed
    d = cfg.data
    d.task = "synthetic"
    d.variant = variant
    d.root = os.path.join(workdir, "data")
    d.tempmask_folder = "tempmasks"
    d.img_size = config["img_size"]
    d.batch_size = config["batch_size"]
    d.eval_batch_size = eval_batch or config["eval_batch_size"]
    d.num_tta_views = config["num_tta_views"]
    d.rotation_degree = float(config["rotation_degree"])
    cfg.optim.lr = config["lr"]
    cfg.coteach.warmup_epochs = config["warmup_epochs"]
    cfg.coteach.update_percent = config["update_percent"]
    cfg.coteach.refresh_skip_empty = config["refresh_skip_empty"]
    cfg.num_epochs = config["num_epochs"]
    cfg.checkpoint_dir = os.path.join(workdir, "checkpoints")
    cfg.history_dir = os.path.join(workdir, "history")
    return cfg


def sync(device) -> None:
    import torch

    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)


class Profiled:
    """A stretch of the program under torch.profiler, started and stopped
    with the device idle, its host wall time on the side."""

    def __init__(self, device):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device = device
        self.prof = torch.profiler.profile(activities=acts)
        self.wall_s: Optional[float] = None
        self._t0 = 0.0

    def start(self) -> None:
        sync(self.device)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()

    def summary(self, units: int, kind: str) -> Dict:
        """Kernels, host ops, wall and busy time of the stretch, which ran
        ``units`` steps."""
        kernels, host = trace.from_profiler(self.prof)
        events = kernels + host
        start = min((a for _, a, _ in events), default=0.0)
        end = max((z for _, _, z in events), default=0.0)
        return {"kind": kind, "units": units, "kernels": kernels, "wall_s": self.wall_s,
                "busy_s": trace.busy_us(kernels) / 1e6,
                "breakdown": {"device_ops": trace.top_ops(kernels),
                              "idle_gaps": trace.idle_gaps(kernels, host, start, end)}}


def free_device(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
