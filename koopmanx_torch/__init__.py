"""koopmanx_torch — the PyTorch/CUDA port of koopmanx for an NVIDIA H100.

The JAX package ``koopmanx`` stays the reference; this package mirrors its
module names so that each function's counterpart is easy to find. It
imports ``torch`` (and numpy/scipy), never ``jax`` and nothing of
``koopmanx``.

Idiom: plain functions on tensors with a leading scenario axis where JAX
had ``vmap``, Python loops where JAX had ``scan``, ``nn.Module`` for the
lift, an explicit ``device`` and explicit ``torch.Generator``s. Entry
points take ``device=None``, meaning ``"cuda"``, and raise when no CUDA
device is present; tests pass ``device="cpu"``.

Precision: the estimator and the KKT build run in full float32. The entry
points set ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` (:func:`device.resolve_device`).
"""
