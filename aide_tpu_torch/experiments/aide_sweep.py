"""Sweep the AIDE stage's co-teaching settings over one shared pretrain export.

The counterpart of the JAX package's ``experiments/aide_sweep.py``: each
variant runs the AIDE stage of the synthetic ladder
(``aide_tpu_torch.experiments.synthetic_aide.run``) from the same pretrain
export, a ``.pkl`` of the port or a JAX ``.msgpack``, and reports its best
test-case Dice and final working-label quality against the clean GT. The
``@resume`` token warm-starts the pair from that export instead of fresh
nets.

Usage: python -m aide_tpu_torch.experiments.aide_sweep <pretrain_ckpt>
       [--epochs N] [--only a,b] [--out results.json] [--device cpu] ...
It runs on the first CUDA card and raises without one, unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from aide_tpu_torch.engine.trainer import resolve_device
from aide_tpu_torch.experiments import synthetic_aide as SA

VARIANTS = {
    "flagship": [],
    "cons1": ["coteach.consistency_weight=1.0"],
    "warmstart": ["@resume"],
    "warmstart_cons1": ["@resume", "coteach.consistency_weight=1.0"],
    "update50": ["coteach.update_percent=0.5"],
    "sharpen": ["coteach.temperature=0.5"],
    # the shift-regime recipe on pseudo labels: a clean-anchored fine-tune
    # instead of the flagship's fresh nets
    "kidney": ["@resume", "coteach.consistency_weight=1.0", "optim.lr=1e-5"],
    # post-warmup levers: a longer improving window, a denser cadence
    "warmup40": ["coteach.warmup_epochs=40"],
    "warmup60": ["coteach.warmup_epochs=60"],
    "warmup40_update50": [
        "coteach.warmup_epochs=40", "coteach.update_percent=0.5"
    ],
    "warmup40_interval2": [
        "coteach.warmup_epochs=40", "coteach.refresh_interval=2"
    ],
    "warmup40_skipempty": [
        "coteach.warmup_epochs=40", "coteach.refresh_skip_empty=true"
    ],
    "warmup80": ["coteach.warmup_epochs=80"],
    "warmup100": ["coteach.warmup_epochs=100"],
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pretrain_ckpt")
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--style", default="hard")
    ap.add_argument("--protocol", default="pseudo")
    ap.add_argument("--only", default="", help="comma-separated variant names")
    ap.add_argument("--workroot", default=os.path.join(tempfile.gettempdir(),
                                                       "aide_torch_sweep"))
    ap.add_argument("--num-cases", type=int, default=SA.NUM_CASES)
    ap.add_argument("--clean-cases", type=int, default=SA.CLEAN_CASES)
    ap.add_argument("--slices-per-case", type=int, default=SA.SLICES_PER_CASE)
    ap.add_argument("--model", default=SA.MODEL)
    ap.add_argument("--img-size", type=int, default=SA.IMG_SIZE)
    ap.add_argument("--seed", type=int, default=SA.SEED)
    ap.add_argument("--out", default="", help="write results json here")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the first CUDA card; "
                         "'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    SA.DEVICE = resolve_device(args.device)
    SA.STYLE = args.style
    SA.PROTOCOL = args.protocol
    SA.NUM_CASES = args.num_cases
    SA.CLEAN_CASES = args.clean_cases
    SA.SLICES_PER_CASE = args.slices_per_case
    SA.MODEL = args.model
    SA.IMG_SIZE = args.img_size
    SA.SEED = args.seed
    names = args.only.split(",") if args.only else list(VARIANTS)

    results = {}
    for name in names:
        overrides = list(VARIANTS[name])
        resume = args.pretrain_ckpt if "@resume" in overrides else ""
        overrides = [o for o in overrides if o != "@resume"]
        SA.AIDE_OVERRIDES = overrides
        workdir = os.path.join(args.workroot, name)
        os.makedirs(workdir, exist_ok=True)
        r = SA.run("aide", workdir, args.epochs, resume=resume, pseudo_from=args.pretrain_ckpt)
        r["overrides"] = overrides + (["resume"] if resume else [])
        results[name] = r
        print(json.dumps({name: r}), flush=True)

    print(json.dumps(results, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
