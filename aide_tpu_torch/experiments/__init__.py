"""The algorithm-validation programs of the port.

``synthetic_aide`` runs the pretrain -> naive -> AIDE ladder (with an
optional supervised-on-clean-GT ceiling) on the synthetic task under the
shift, pseudo and transfer protocols, and ``aide_sweep`` sweeps the AIDE
stage's co-teaching settings over one shared pretrain checkpoint. Both are
the counterparts of the JAX package's ``experiments/synthetic_aide.py`` and
``experiments/aide_sweep.py``: the same settings, flags and JSON lines, run
on the card unless ``--device cpu`` is given.
"""
