"""Configuration tree for the aide_tpu_torch engine.

An own copy of ``aide_tpu.core.config``: the same dataclasses, the same
fields and defaults, the same dotted ``.override``, so a config written for
one package builds in the other. The TPU layout knobs ``model.packed*`` are
accepted and ignored: the packed layout computes the same network as the
plain one. The mesh settings are read by ``core.mesh.launch`` and
``Trainer``: the data axis (``mesh.num_devices``, and a job of processes
through ``mesh.coordinator_address``, ``num_processes``, ``process_id``) is
one process a card, and a ``("net", 2)`` entry of ``mesh.extra_axes`` puts
one net of the co-teaching pair on each card of a pair, and a
``("space", k)`` entry splits each image's rows over k cards.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass
class ModelConfig:
    """Network architecture selection (``models.build_model`` says which
    names and variants the port has)."""

    name: str = "fuseunet"
    num_classes: int = 2
    # encoder level-1 channels; 0 = model default (32 for FuseUNet)
    base_width: int = 0
    learned_bilinear: bool = False
    attention_reduction: int = 16
    attention_dilation: int = 4
    norm: str = "batch"
    group_norm_groups: int = 8
    # bfloat16 compute (autocast) with float32 params and statistics
    compute_dtype: str = "bfloat16"
    # accepted and ignored, as the JAX package does: params are float32
    param_dtype: str = "float32"
    remat: bool = False
    # TPU lane-layout knobs of the JAX package; no-ops here
    packed: bool = False
    packed_block_barrier: bool = True
    packed_block_barrier_scope: str = "encoder"


@dataclass
class DataConfig:
    """Dataset + augmentation."""

    task: str = "chaos"
    variant: str = "proposed"     # proposed (dual working labels) | comparison
    root: str = ""
    train_csv: str = ""
    test_csv: str = ""
    traincase_csv: str = ""
    testcase_csv: str = ""
    labelcase_csv: str = ""
    tempmask_folder: str = ""
    img_size: int = 256
    batch_size: int = 4
    eval_batch_size: int = 8
    rotation_degree: float = 60.0   # TTA rotation bound (±)
    hflip_prob: float = 0.5
    # None => per-image mean/std normalization; otherwise fixed stats
    data_mean: Optional[Tuple[float, ...]] = None
    data_std: Optional[Tuple[float, ...]] = None
    num_tta_views: int = 4
    mask_identity: int = 1
    shuffle_seed: int = 0
    augment_main: bool = False
    # TTA warp: 'auto' (the CUDA kernel for CUDA tensors, the plain shear
    # path for CPU tensors) or an explicit 'cuda' | 'shear' | 'gather'
    warp_method: str = "auto"
    device_cache: str = "auto"
    decode_cache_dir: str = ""
    task_options: dict = field(default_factory=dict)


@dataclass
class OptimConfig:
    """Adam(amsgrad) + StepLR/PolyLR."""

    lr: float = 1e-4
    loss: str = "cedice"
    optimizer: str = "amsgrad_adam"
    lr_policy: str = "StepLR"
    step_size: int = 30
    step_gamma: float = 0.5
    poly_power: float = 0.9
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None


@dataclass
class CoteachConfig:
    """Dual-network cross co-teaching knobs (meanings as in aide_tpu)."""

    enabled: bool = True
    warmup_epochs: int = 20           # rate = min((e/warmup)^2, 1)
    temperature: float = 1.0
    sharpen_mode: str = "pow_t"       # pow_t | pow_inv_t
    seg_weight: float = 1.0
    consistency_weight: float = 10.0
    cedice_weight: Tuple[float, float] = (1.0, 1.0)
    ceclass_weight: Tuple[float, ...] = (1.0, 1.0)
    diceclass_weight: Tuple[float, ...] = (1.0, 1.0)
    clean_fraction: float = 0.5
    update_percent: float = 0.25
    refresh_interval: int = 10
    refresh_skip_empty: bool = False
    warm_start_noise: float = 1e-3
    # BN statistics of the TTA forwards: 'batch' (train-mode BN, stats not
    # updated) or 'running' (eval-mode BN)
    tta_bn: str = "batch"
    engagement_check: bool = True
    engagement_min_agreement: float = 0.5
    engagement_fg_band: Tuple[float, float] = (0.2, 5.0)
    engagement_min_bootstrap_skill: float = 0.2
    engagement_clear_skill: float = 0.35


@dataclass
class EvalConfig:
    keep_largest_cc: bool = True
    threshold: float = 0.5
    save_png: bool = True
    png_scale: int = 63
    output_dir: str = "segmentation_results"


@dataclass
class MeshConfig:
    data_axis: str = "data"
    # ranks of the job, one a card: 0 = every visible card (one CPU rank)
    num_devices: int = 0
    # (axis, size) pairs after the data axis, the net index minor in the
    # ranks (core/mesh.py): ("net", 2) puts net k of the dual pair on
    # rank k of each pair of ranks (a single-net run replicates over it);
    # ("space", k) is not ported yet
    extra_axes: Tuple[Tuple[str, int], ...] = ()
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1


@dataclass
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    coteach: CoteachConfig = field(default_factory=CoteachConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    num_epochs: int = 100
    seed: int = 2
    repetition: int = 200
    checkpoint_dir: str = "checkpoints"
    checkpoint_flush: str = "end"
    history_dir: str = "history"
    resume_file: str = ""
    log_every_steps: int = 0
    ascending_checkpoint_gate: bool = False

    @property
    def experiment_name(self) -> str:
        return "{}_temp{}_r{}".format(
            self.model.name, self.coteach.temperature, self.repetition
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        return _build(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        return cls.from_dict(json.loads(s))

    def override(self, pairs: Sequence[str]) -> "TrainConfig":
        """Apply CLI-style dotted overrides, e.g. ``optim.lr=3e-4``."""
        d = self.to_dict()
        for pair in pairs:
            if "=" not in pair:
                raise ValueError(f"override must be key=value, got {pair!r}")
            key, raw = pair.split("=", 1)
            node = d
            parts = key.strip().split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"unknown config section {p!r} in {key!r}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"unknown config key {key!r}")
            node[leaf] = _coerce(raw, node[leaf])
        return TrainConfig.from_dict(d)


def _coerce(raw: str, prev: Any) -> Any:
    raw = raw.strip()
    if isinstance(prev, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if prev is None or raw.lower() in ("none", "null"):
        try:
            return json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            return None if raw.lower() in ("none", "null") else raw
    if isinstance(prev, (list, tuple)):
        val = json.loads(raw)
        return tuple(val) if isinstance(prev, tuple) else val
    if isinstance(prev, dict):
        return json.loads(raw)
    if isinstance(prev, int) and not isinstance(prev, bool):
        return int(raw)
    if isinstance(prev, float):
        return float(raw)
    return raw


# Knobs of earlier revisions that saved configs may still carry.
REMOVED_KEYS = frozenset({"slice_bucket"})


def _build(cls, d: dict):
    """Recursively build nested dataclasses from a plain dict; unknown keys
    raise (REMOVED_KEYS excepted)."""
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)} - REMOVED_KEYS
    if unknown:
        raise KeyError(f"{cls.__name__}: unknown config keys {sorted(unknown)}")
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[f.name] = _build(ftype, v)
        elif isinstance(v, (list, tuple)):
            kwargs[f.name] = tuple(
                tuple(x) if isinstance(x, (list, tuple)) else x for x in v
            )
        else:
            kwargs[f.name] = v
    return cls(**kwargs)
