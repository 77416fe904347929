"""The plain reference of the benchmark's configurations.

Plain PyTorch, independent of the program under test: it imports nothing
of the port, nor JAX. It reads a configuration's JSON file (the settings
the deployment runs with), the encoder's ``.mat`` file and the inputs the
harness draws, and works out again whatever the program derives from
them: the training snapshots, the lift and its normalizer, the EDMD fit,
the estimator's prior, and each control step (the online update, the
terminal certificate, the condensed QP and its 60 ADMM iterations, the
plant step).

The plant, the integrator, the lift's dictionary and the estimator are
each a module of their own, found by the name the configuration gives
(:mod:`.parts`).

It computes in float64 (:data:`F64`) or, as the control, in float32 with
every matrix product's operands rounded to TF32's 10-bit mantissa
(:data:`TF32`).
"""
from .loop import F64, TF32, Prec, Reference
from .parts import plant_function

__all__ = ["F64", "TF32", "Prec", "Reference", "plant_function"]
