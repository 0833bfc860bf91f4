"""Config presets reproducing each reference trainer script's setup.

An own copy of ``aide_tpu.cli.presets`` with the port's ``TrainConfig``:
every preset, field for field. One preset per reference entry point (CSV
paths from the scripts' ``__main__`` blocks, e.g.
trainchaos_proposed_30cases1labeled.py:606-617); ``python -m
aide_tpu_torch.cli ... --preset NAME`` runs one.
``data_root`` is the directory containing the dataset folders
(inputs_chaos/, inputs_prostatemr/, inputs_qubiq/,
inputs_breastMR_Henan_372cases/).
"""

from __future__ import annotations

import os
from typing import Callable, Dict

from aide_tpu_torch.core.config import TrainConfig

PRESETS: Dict[str, Callable[[str], TrainConfig]] = {}


def preset(name: str):
    def deco(fn):
        PRESETS[name] = fn
        return fn

    return deco


def _base(model: str, task: str, variant: str) -> TrainConfig:
    cfg = TrainConfig()
    cfg.model.name = model
    cfg.data.task = task
    cfg.data.variant = variant
    cfg.coteach.enabled = variant == "proposed"
    return cfg


# ------------------------------- CHAOS -------------------------------


def _chaos(cfg: TrainConfig, root: str) -> TrainConfig:
    split = os.path.join(root, "inputs_chaos", "All_Sets_split")
    cfg.data.root = os.path.join(root, "inputs_chaos", "All_Sets")
    cfg.data.test_csv = os.path.join(split, "splitimages_cleanlabel/val_data_10cases.csv")
    cfg.data.testcase_csv = os.path.join(split, "splitcases/val_data_10cases.csv")
    return cfg


@preset("chaos_comparison_1case")
def chaos_comparison_1case(root: str) -> TrainConfig:
    cfg = _chaos(_base("fuseunet", "chaos", "comparison"), root)
    split = os.path.join(root, "inputs_chaos", "All_Sets_split")
    cfg.data.train_csv = os.path.join(split, "splitimages_cleanlabel/train_data_1cases.csv")
    cfg.data.traincase_csv = os.path.join(split, "splitcases/train_data_1cases.csv")
    cfg.repetition = 2
    return cfg


@preset("chaos_comparison_30cases1labeled")
def chaos_comparison_30cases1labeled(root: str) -> TrainConfig:
    cfg = _chaos(_base("fuseunet", "chaos", "comparison"), root)
    split = os.path.join(root, "inputs_chaos", "All_Sets_split")
    cfg.data.train_csv = os.path.join(
        split, "splitimages_pseudolabels_1pretrain/train_data_30cases.csv"
    )
    cfg.data.traincase_csv = os.path.join(split, "splitcases/train_data_30cases.csv")
    cfg.data.labelcase_csv = os.path.join(split, "splitcases/train_data_1cases.csv")
    cfg.repetition = 300
    return cfg


@preset("chaos_proposed_30cases1labeled")
def chaos_proposed_30cases1labeled(root: str) -> TrainConfig:
    """The flagship AIDE config (30 cases / 1 labeled, dual FuseUNet)."""
    cfg = _chaos(_base("fuseunet", "chaos", "proposed"), root)
    split = os.path.join(root, "inputs_chaos", "All_Sets_split")
    cfg.data.train_csv = os.path.join(
        split, "splitimages_pseudolabels_1pretrain/train_data_30cases.csv"
    )
    cfg.data.traincase_csv = os.path.join(split, "splitcases/train_data_30cases.csv")
    cfg.data.labelcase_csv = os.path.join(split, "splitcases/train_data_1cases.csv")
    cfg.data.tempmask_folder = "generated_masks_1casepretrain/besttraincasedice_fuseunet_200"
    return cfg


# ------------------------------ prostate ------------------------------


def _prostate_crossdomain(root: str, direction: str, variant: str) -> TrainConfig:
    """direction: 'train3tgeneratedx' (3T source -> DX target) or
    'traindxgenerate3t' (DX source -> 3T target)."""
    cfg = _base("unet", "prostate", variant)
    base = os.path.join(
        root, "inputs_prostatemr", "Prostate_split2D_crossdomain",
        "ISBI2013_nrrd_combineall",
    )
    cfg.data.root = os.path.join(root, "inputs_prostatemr")
    cfg.data.train_csv = os.path.join(base, f"{direction}_train.csv")
    cfg.data.test_csv = os.path.join(base, f"{direction}_testall.csv")
    cfg.data.traincase_csv = os.path.join(base, f"{direction}_casetrain.csv")
    cfg.data.testcase_csv = os.path.join(base, f"{direction}_casetestall.csv")
    cfg.repetition = 100
    if variant == "proposed":
        cfg.data.labelcase_csv = os.path.join(
            base, f"{direction}_labeledcasetrain.csv"
        )
        cfg.data.tempmask_folder = f"generated_masks_{direction}/unet_100"
    return cfg


@preset("prostate_proposed_isbi3t_transfer_isbidx")
def prostate_proposed_3t_dx(root: str) -> TrainConfig:
    return _prostate_crossdomain(root, "train3tgeneratedx", "proposed")


@preset("prostate_proposed_isbidx_transfer_isbi3t")
def prostate_proposed_dx_3t(root: str) -> TrainConfig:
    return _prostate_crossdomain(root, "traindxgenerate3t", "proposed")


@preset("prostate_comparison_isbi3t_transfer_isbidx")
def prostate_comparison_3t_dx(root: str) -> TrainConfig:
    return _prostate_crossdomain(root, "train3tgeneratedx", "comparison")


@preset("prostate_comparison_isbidx_transfer_isbi3t")
def prostate_comparison_dx_3t(root: str) -> TrainConfig:
    return _prostate_crossdomain(root, "traindxgenerate3t", "comparison")


def _prostate_singledomain(root: str, domain: str) -> TrainConfig:
    cfg = _base("unet", "prostate", "comparison")
    base = os.path.join(root, "inputs_prostatemr", "Prostate_split2D", "ISBI2013_nrrd")
    cfg.data.root = os.path.join(root, "inputs_prostatemr")
    cfg.data.train_csv = os.path.join(base, f"{domain}_train.csv")
    cfg.data.test_csv = os.path.join(base, f"{domain}_testall.csv")
    cfg.data.traincase_csv = os.path.join(base, f"{domain}_casetrain.csv")
    cfg.data.testcase_csv = os.path.join(base, f"{domain}_casetestall.csv")
    cfg.data.batch_size = 8      # singledomain scripts default to bs 8
    cfg.repetition = 1
    return cfg


@preset("prostate_comparison_isbi3t_singledomain")
def prostate_3t_single(root: str) -> TrainConfig:
    return _prostate_singledomain(root, "prostate3t")


@preset("prostate_comparison_isbidx_singledomain")
def prostate_dx_single(root: str) -> TrainConfig:
    return _prostate_singledomain(root, "prostatedx")


# ------------------------------- kidney -------------------------------


def _kidney(root: str, mask: int, variant: str) -> TrainConfig:
    cfg = _base("unet", "kidney", variant)
    cfg.data.root = os.path.join(root, "inputs_qubiq")
    cfg.data.train_csv = os.path.join(
        root, "inputs_qubiq/csv_files/kidney/task1_training.csv"
    )
    cfg.data.test_csv = os.path.join(
        root, "inputs_qubiq/csv_files/kidney/task1_validation.csv"
    )
    cfg.data.mask_identity = mask
    cfg.data.img_size = 512      # kidney scripts run at 512 px
    cfg.repetition = 1
    if variant == "proposed":
        cfg.optim.lr = 1e-5      # trainkidney_proposed_mask1.py:39
        cfg.repetition = 100
        cfg.data.tempmask_folder = (
            f"generated_masks_kidney/Task1Mask{mask}_unet_warmup20_temp1.0_r100"
        )
        cfg.coteach.refresh_skip_empty = True
        cfg.ascending_checkpoint_gate = True
        # kidney/breast use the probs**(1/T) sharpening convention
        cfg.coteach.sharpen_mode = "pow_inv_t"
        # warm start from a pretrained supervised checkpoint
        # (trainkidney_proposed_mask1.py:51) — set resume_file at launch.
    return cfg


for _m in (1, 2, 3):
    PRESETS[f"kidney_comparison_mask{_m}"] = (
        lambda root, m=_m: _kidney(root, m, "comparison")
    )
    PRESETS[f"kidney_proposed_mask{_m}"] = (
        lambda root, m=_m: _kidney(root, m, "proposed")
    )


# ------------------------------- breast -------------------------------


def _breast(root: str, train_csv: str, variant: str) -> TrainConfig:
    cfg = _base("unet", "breast", variant)
    base = os.path.join(root, "inputs_breastMR_Henan_372cases")
    cfg.data.root = base
    cfg.data.train_csv = os.path.join(base, "BreastMR_csvfiles", train_csv)
    cfg.data.test_csv = os.path.join(
        base, "BreastMR_csvfiles/splitcleanlabels/val_data_100cases_imgs.csv"
    )
    cfg.data.img_size = 384      # breast scripts run at 384 px
    cfg.repetition = 1
    if variant == "proposed":
        cfg.optim.lr = 1e-5      # trainbreast_dataset3_proposed...: lr default
        cfg.data.labelcase_csv = os.path.join(
            base, "BreastMR_csvfiles/splitcleanlabels/train_data_25cases_cases.csv"
        )
        cfg.data.tempmask_folder = "generated_masks_25labels/unet_warmup20_temp1.0_r1"
        cfg.coteach.sharpen_mode = "pow_inv_t"
    else:
        cfg.data.batch_size = 1  # breast comparison scripts default to bs 1
    return cfg


@preset("breast_comparison_25cases")
def breast_comparison_25(root: str) -> TrainConfig:
    return _breast(root, "splitcleanlabels/train_data_25cases_imgs.csv", "comparison")


@preset("breast_comparison_272cases25labeled")
def breast_comparison_272(root: str) -> TrainConfig:
    return _breast(root, "splitnoisylabels/train_data_25cases_imgs.csv", "comparison")


@preset("breast_proposed_272cases25labeled")
def breast_proposed_272(root: str) -> TrainConfig:
    return _breast(root, "splitnoisylabels/train_data_25cases_imgs.csv", "proposed")


# ------------------------------ synthetic ------------------------------


@preset("synthetic_smoke")
def synthetic_smoke(root: str) -> TrainConfig:
    """Small self-contained run (no data needed): dual-net co-teaching on
    the generated ellipse task."""
    cfg = _base("unet8", "synthetic", "proposed")
    cfg.model.compute_dtype = "float32"
    cfg.model.norm = "group"
    cfg.data.img_size = 64
    cfg.data.batch_size = 4
    cfg.data.num_tta_views = 2
    cfg.data.tempmask_folder = "tempmasks"
    cfg.num_epochs = 3
    cfg.coteach.warmup_epochs = 2
    cfg.coteach.consistency_weight = 1.0
    return cfg


@preset("synthetic_supervised")
def synthetic_supervised(root: str) -> TrainConfig:
    cfg = _base("unet8", "synthetic", "comparison")
    cfg.model.compute_dtype = "float32"
    cfg.model.norm = "group"
    cfg.data.img_size = 64
    cfg.data.batch_size = 4
    cfg.num_epochs = 3
    return cfg


def get_preset(name: str, data_root: str = ".") -> TrainConfig:
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name](data_root)
