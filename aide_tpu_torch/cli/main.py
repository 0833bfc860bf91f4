"""Command-line interface: ``python -m aide_tpu_torch.cli {train,eval,predict,export,presets}``.

The counterpart of ``aide_tpu.cli.main`` with the same commands and
options: pick a preset (or a config JSON), override any field with dotted
``--set key=value`` pairs (repeatable; every occurrence applies). ``train``,
``eval``, ``predict`` and ``export --format serve`` run on the CUDA card
(the serving export traces a program for the card and one for the host),
and raise without one unless ``--device cpu`` asks for the CPU. ``eval``,
``predict`` and ``export`` take a net checkpoint: the port's ``.pkl``
exports (or an original AIDE ``.pkl``) or the JAX package's ``.msgpack``
net exports. ``train --set
resume_file=<checkpoint_dir>/<experiment>_last_full.msgpack`` goes on with a
stopped run exactly (a ``_full`` file of either package); any other
``resume_file`` warm-starts.

``train`` runs one process a card through ``core.mesh.launch``:
``mesh.num_devices`` 0 (the default) trains on every visible card (at the
presets' batch currently slower per epoch than one card), N on N
of them (shrunk to divide gcd(batch_size, eval_batch_size)), and with
``--device cpu`` 0 means one CPU rank and N that many CPU ranks over
gloo; ``mesh.coordinator_address`` with ``mesh.num_processes`` and
``mesh.process_id`` makes this process one rank of a job. ``--set
'mesh.extra_axes=[["net",2]]'`` adds the net axis: the ranks come in
pairs, one net of the co-teaching pair each (on one card it raises);
``'mesh.extra_axes=[["space",2]]'`` (or ``[["net",2],["space",2]]``) splits
each image's rows over 2 ranks (layout only: the numbers are one card's up
to reduction order). ``eval``,
``predict`` and ``export`` run on one device, as the JAX CLI's do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from aide_tpu_torch.cli.presets import PRESETS, get_preset
from aide_tpu_torch.core.config import TrainConfig


def _build_config(args) -> TrainConfig:
    if args.config:
        with open(args.config) as fh:
            cfg = TrainConfig.from_json(fh.read())
    elif args.preset:
        cfg = get_preset(args.preset, args.data_root)
    else:
        cfg = TrainConfig()
    if args.set:
        # --set is repeatable (action="append" + nargs="*" gives a list of
        # lists): every occurrence applies, not only the last
        cfg = cfg.override([kv for group in args.set for kv in group])
    return cfg


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", help="named preset (see `presets`)")
    p.add_argument("--config", help="path to a TrainConfig JSON file")
    p.add_argument("--data-root", default=".", help="directory containing the dataset folders")
    p.add_argument(
        "--set", nargs="*", action="append", default=[], metavar="KEY=VALUE",
        help="dotted config overrides, e.g. optim.lr=3e-4 data.batch_size=8 "
        "(repeatable; all occurrences apply)",
    )
    p.add_argument("--device", help="torch device (default: the CUDA card; 'cpu' runs on "
                                    "the CPU; export --format pkl always runs on the host)")


def _train_rank(rank: int, device, cfg: TrainConfig, epochs: int, profile_dir) -> None:
    """One rank of ``train``: its trainer on its device, run to the end."""
    from aide_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    if not profile_dir:
        trainer.run(epochs)
        return
    # a torch.profiler trace of the run (use --epochs 1 for a readable trace
    # of one epoch), written as a Chrome trace a rank under DIR
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
        trainer.run(epochs)


def cmd_train(args) -> int:
    cfg = _build_config(args)
    from aide_tpu_torch.core.mesh import launch

    epochs = args.epochs or cfg.num_epochs
    launch(_train_rank, cfg, args.device, (cfg, epochs, args.profile))
    if args.profile:
        print(json.dumps({"profile_dir": os.path.abspath(args.profile)}))
    return 0


def _load_net(cfg: TrainConfig, checkpoint: str, device):
    """The configured model (forward-only twin) with the checkpoint's
    weights, in eval mode on ``device``."""
    import torch

    from aide_tpu_torch.engine import checkpoint as ckpt
    from aide_tpu_torch.models import build_eval_model

    net = build_eval_model(cfg.model)
    net.load_state_dict(ckpt.load_net(checkpoint, net), strict=True)
    return net.to(device, memory_format=torch.channels_last).eval()


def _setup_inference(cfg: TrainConfig, checkpoint: str, device):
    """Shared eval/predict setup: the task, its test pipeline (on the device
    as the Trainer's device_cache policy says), the net with the
    checkpoint's weights, and the predict programs. Returns (task, pipe,
    state, predict, predict_all)."""
    from aide_tpu_torch.data.pipeline import SlicePipeline
    from aide_tpu_torch.data.tasks import build_task
    from aide_tpu_torch.engine import steps as steps_mod
    from aide_tpu_torch.engine.state import TrainState
    from aide_tpu_torch.engine.trainer import resolve_device

    device = resolve_device(device)
    task = build_task(cfg)
    specs = task.load_manifest(cfg.data.test_csv, train=False)
    pipe = SlicePipeline(task, specs, cfg.data.img_size, cfg.data.data_mean, cfg.data.data_std)
    if cfg.data.device_cache in ("on", "auto"):
        pipe.to_device(device)
    state = TrainState(_load_net(cfg, checkpoint, device), optimizer=None)
    predict_step = steps_mod.make_predict_step(task.two_modal, dual=False)

    def predict(state, batch):
        return predict_step(state, {k: v.to(device, non_blocking=True) for k, v in batch.items()})

    predict_all = (
        steps_mod.make_predict_all(task.two_modal, dual=False)
        if pipe.device_image_data is not None
        else None
    )
    return task, pipe, state, predict, predict_all


def cmd_eval(args) -> int:
    """Offline eval: load a checkpoint, run case-wise 3D inference, write
    the reference's per-case CSV, the PNG masks and a summary."""
    cfg = _build_config(args)
    from aide_tpu_torch.evaluation.case_eval import evaluate_cases
    from aide_tpu_torch.evaluation.report import summarize, write_case_csv, write_case_masks

    if not args.checkpoint:
        print("error: --checkpoint is required for eval", file=sys.stderr)
        return 2
    task, pipe, state, predict, predict_all = _setup_inference(cfg, args.checkpoint, args.device)
    cases = (
        task.load_case_list(cfg.data.testcase_csv) if cfg.data.testcase_csv else list(pipe.cases)
    )
    results = evaluate_cases(
        predict, state, pipe, cases, cfg.data.eval_batch_size, dual=False,
        target_net=None, keep_largest_cc=cfg.eval.keep_largest_cc,
        full_metrics=True, keep_volumes=cfg.eval.save_png, predict_all=predict_all,
    )[0]

    out_dir = args.output or cfg.eval.output_dir
    name = os.path.basename(args.checkpoint).split(".")[0]
    write_case_csv(os.path.join(out_dir, f"{name}.csv"), results)
    if cfg.eval.save_png:
        for r in results:
            idxs = pipe.case_indices(r.case_id)
            names = [os.path.basename(pipe.specs[i].mask_path).split(".")[0] for i in idxs]
            if len(set(names)) != len(names):  # synthetic-style paths
                names = [f"{n}_{j:03d}" for j, n in enumerate(names)]
            write_case_masks(os.path.join(out_dir, "generated_masks"), r.case_id,
                             r.pred_volume, names, scale=cfg.eval.png_scale)
    print(json.dumps(summarize(results), indent=2))
    return 0


def cmd_predict(args) -> int:
    """Label-free inference: run a checkpoint over the test manifest (masks
    optional) and write the predicted masks in the task's own convention.
    No metrics are computed."""
    cfg = _build_config(args)
    from aide_tpu_torch.evaluation.case_eval import infer_cases

    if not args.checkpoint:
        print("error: --checkpoint is required for predict", file=sys.stderr)
        return 2
    task, pipe, state, predict, predict_all = _setup_inference(cfg, args.checkpoint, args.device)
    out_dir = args.output or cfg.eval.output_dir
    volumes = infer_cases(
        predict, state, pipe, pipe.cases, cfg.data.eval_batch_size, dual=False,
        keep_largest_cc=cfg.eval.keep_largest_cc, predict_all=predict_all,
    )
    count = 0
    for case, vols in zip(pipe.cases, volumes):
        idxs = pipe.case_indices(case)
        task.write_case_predictions(out_dir, case, [pipe.specs[i] for i in idxs], vols[0],
                                    png_scale=cfg.eval.png_scale)
        count += len(idxs)
    print(json.dumps({"cases": len(pipe.cases), "slices": count, "output": out_dir}))
    return 0


def cmd_export(args) -> int:
    """Convert a net checkpoint (a JAX ``.msgpack`` net export or a
    ``.pkl``) into either the reference-loadable torch ``.pkl``
    (``{'net': state_dict, 'loss', 'epoch'}``, written on the host) or a
    framework-free ``torch.export`` serving artifact (``--format serve``,
    ``aide_tpu_torch/interop/serving.py``), traced on the card and the host,
    or on the host alone with ``--device cpu``."""
    cfg = _build_config(args)
    from aide_tpu_torch.engine import checkpoint as ckpt

    if not args.checkpoint or not args.output:
        print("error: export needs --checkpoint and --output", file=sys.stderr)
        return 2
    if args.format == "serve":
        from aide_tpu_torch.engine.trainer import resolve_device

        # the card's and the host's programs, or the host's alone; raises
        # without a card unless --device cpu
        device = resolve_device(args.device)
        platforms = None if device.type == "cuda" else (device.type,)
    elif cfg.model.norm != "batch":
        raise ValueError(
            f"model.norm={cfg.model.norm!r}: only norm='batch' models map onto the "
            "reference's BatchNorm checkpoints"
        )
    net = _load_net(cfg, args.checkpoint, "cpu")
    try:
        # the sidecar may be absent when only the checkpoint was copied
        meta = ckpt.read_meta(args.checkpoint)
    except FileNotFoundError:
        meta = {}
    if args.format == "serve":
        from aide_tpu_torch.interop.serving import export_serving_artifact
        from aide_tpu_torch.models import is_two_modal

        export_serving_artifact(
            args.output, net, cfg.data.img_size, is_two_modal(cfg.model.name),
            meta={"model": cfg.model.name, "epoch": int(meta.get("epoch", 0))},
            weights_dtype=args.weights_dtype,
            platforms=platforms,
        )
    else:
        # the sidecar stores the test metrics unprefixed ('loss1' for a net of
        # the pair, 'loss' for a single net)
        ckpt.export_net(args.output, net.state_dict(), {
            "loss": float(meta.get("loss1", meta.get("loss", 0.0))),
            "epoch": int(meta.get("epoch", 0)),
        })
    print(json.dumps({"output": os.path.abspath(args.output)}))
    return 0


def cmd_presets(args) -> int:
    for name in sorted(PRESETS):
        print(name)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="aide-tpu-torch",
        description="annotation-efficient segmentation on a CUDA card (PyTorch port of aide_tpu)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser(
        "train", help="run a training config",
        description="Run a training config, one process a card. mesh.num_devices=0 (the "
                    "default) trains on every visible card; at the presets' batch sizes more "
                    "than one card is currently slower per epoch than one (the epoch has the "
                    "same steps and each takes longer; PERF.md), so pass --set "
                    "mesh.num_devices=1 to train on one card. --set "
                    "'mesh.extra_axes=[[\"net\",2]]' puts one net of the co-teaching pair "
                    "on each card of a pair; [[\"space\",2]] splits each image's rows over "
                    "2 cards.",
    )
    _add_common(p_train)
    p_train.add_argument("--epochs", type=int, help="override epoch count")
    p_train.add_argument(
        "--profile", metavar="DIR",
        help="wrap the run in torch.profiler and write its trace to DIR",
    )
    p_train.set_defaults(fn=cmd_train)

    p_eval = sub.add_parser("eval", help="offline case-wise evaluation")
    _add_common(p_eval)
    p_eval.add_argument("--checkpoint", help="net checkpoint (.pkl, or a JAX .msgpack net export)")
    p_eval.add_argument("--output", help="output directory")
    p_eval.set_defaults(fn=cmd_eval)

    p_pred = sub.add_parser("predict", help="label-free mask inference")
    _add_common(p_pred)
    p_pred.add_argument("--checkpoint", help="net checkpoint (.pkl, or a JAX .msgpack net export)")
    p_pred.add_argument("--output", help="output directory")
    p_pred.set_defaults(fn=cmd_predict)

    p_exp = sub.add_parser(
        "export",
        help="convert a net checkpoint to a reference torch .pkl or a torch.export "
             "serving artifact",
    )
    _add_common(p_exp)
    p_exp.add_argument("--checkpoint", help="net checkpoint (a JAX .msgpack net export or a .pkl)")
    p_exp.add_argument("--output", help="output path")
    p_exp.add_argument(
        "--format", choices=("pkl", "serve"), default="pkl",
        help="pkl: reference torch checkpoint; serve: framework-free torch.export "
             "program with baked-in weights",
    )
    p_exp.add_argument(
        "--weights-dtype", choices=("float32", "bfloat16"), default="float32",
        dest="weights_dtype",
        help="(serve only) precision of the baked-in weights; bfloat16 "
             "halves the artifact and serving weight memory",
    )
    p_exp.set_defaults(fn=cmd_export)

    p_ls = sub.add_parser("presets", help="list available presets")
    p_ls.set_defaults(fn=cmd_presets)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
