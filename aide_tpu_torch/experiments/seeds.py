"""Run the synthetic ladder for several anatomy seeds side by side.

One ``python -m aide_tpu_torch.experiments.synthetic_aide`` process a seed,
started together, each with its own ``--workdir``, ``--out`` and log:
all on one card (the co-teaching step waits on the host, so the card has
room for more than one), or with ``--one-card-each`` seed i on card i of
the machine (``CUDA_VISIBLE_DEVICES``). Prints one JSON line a seed as it
ends ({"seed", "returncode", "seconds", "out", "log"}), then one with the
whole run's seconds; exits non-zero when a seed's process failed.

Usage: python -m aide_tpu_torch.experiments.seeds --seeds 11,23,31
       --outdir DIR [--one-card-each] [--timeout S] -- <synthetic_aide flags>
The ladder's own flags follow ``--``; ``--seed``, ``--workdir`` and
``--out`` are set here.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True, help="comma-separated anatomy seeds")
    ap.add_argument("--outdir", required=True,
                    help="each seed's result (seed{S}.json), log (seed{S}.log) and work "
                         "directory (work_seed{S}) go here")
    ap.add_argument("--one-card-each", action="store_true",
                    help="seed i on card i (CUDA_VISIBLE_DEVICES=i)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds after which a seed's process is stopped")
    ap.add_argument("ladder", nargs=argparse.REMAINDER,
                    help="-- then the flags of aide_tpu_torch.experiments.synthetic_aide")
    args = ap.parse_args(argv)
    if args.ladder and args.ladder[0] == "--":
        args.ladder = args.ladder[1:]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    os.makedirs(args.outdir, exist_ok=True)
    t0 = time.time()
    procs = []
    for i, seed in enumerate(seeds):
        stem = os.path.join(args.outdir, f"seed{seed}")
        env = dict(os.environ, **({"CUDA_VISIBLE_DEVICES": str(i)} if args.one_card_each else {}))
        cmd = [sys.executable, "-m", "aide_tpu_torch.experiments.synthetic_aide", *args.ladder,
               "--seed", str(seed), "--workdir", os.path.join(args.outdir, f"work_seed{seed}"),
               "--out", stem + ".json"]
        with open(stem + ".log", "w") as log:
            procs.append((seed, stem, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                       env=env)))
    running, failed = list(procs), False
    while running:
        time.sleep(1.0)
        late = args.timeout is not None and time.time() - t0 > args.timeout
        for item in list(running):
            seed, stem, proc = item
            if late and proc.poll() is None:
                proc.kill()
            rc = proc.poll()
            if rc is None:
                continue
            running.remove(item)
            failed |= rc != 0
            print(json.dumps({"seed": seed, "returncode": rc, "seconds": time.time() - t0,
                              "out": stem + ".json", "log": stem + ".log"}), flush=True)
    print(json.dumps({"seeds": seeds, "seconds": time.time() - t0}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
