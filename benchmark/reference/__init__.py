"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy in float32 (TF32 off), written apart from the port:
it imports neither ``jax``, ``aide_tpu`` nor ``aide_tpu_torch``, and it
takes none of the port's outputs but the ones it judges. Frozen copies of
the port's arithmetic where the function itself is the port's definition
(the synthetic data's generator, the 3-shear TTA warp, the view draws).
"""
