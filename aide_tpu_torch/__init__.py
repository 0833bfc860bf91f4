"""aide_tpu_torch: the PyTorch/CUDA port of aide_tpu.

Same layout and module names as ``aide_tpu`` (core, data, models, ops,
engine, interop); images and logits are (B, H, W, C) at every public
function, labels (B, H, W). The package imports torch, numpy and the
standard library, never JAX or anything of ``aide_tpu``.
"""
