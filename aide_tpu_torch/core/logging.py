"""Console and file logging, and the parameter dump at the start of a run.

Own copies of ``aide_tpu.core.logging.setup_logging`` and ``record_params``,
under the logger name ``aide_tpu_torch``: lines go, unprefixed, to the
console and to ``{history_dir}/{experiment_name}.log``. Over a data axis
only the primary rank writes them (``primary=False`` gives a logger that
writes nowhere), as the JAX package's files come from process 0 alone.
"""

from __future__ import annotations

import logging
import os
import time


def setup_logging(history_dir: str, experiment_name: str, primary: bool = True) -> logging.Logger:
    logger = logging.getLogger("aide_tpu_torch")
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        # close before dropping: a process that builds several trainers
        # must not keep a file handle open per run
        h.close()
    logger.handlers.clear()
    logger.propagate = False
    if not primary:
        logger.addHandler(logging.NullHandler())
        return logger
    os.makedirs(history_dir, exist_ok=True)
    log_path = os.path.join(history_dir, f"{experiment_name}.log")
    fmt = logging.Formatter("%(message)s")
    for h in (logging.StreamHandler(), logging.FileHandler(log_path)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def record_params(logger: logging.Logger, config) -> None:
    logger.info("aide_tpu_torch run ({})".format(time.asctime()))
    logger.info("**************Parameters***************")
    for line in config.to_json(indent=2).splitlines():
        logger.info(line)
    logger.info("**************Parameters***************\n")
