"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device that is not present raises:
    the port never carries on silently on the CPU; callers that want the
    CPU (the tests) ask for it.

    Also pins full float32 matmuls (TF32 off) for cuBLAS and cuDNN: the
    estimator and the KKT inverse are precision-critical, like
    ``koopmanx.edmd.rls.full_precision`` on the TPU side.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def default_qp_backend(device: DeviceLike = None) -> str:
    """The box QP's route on ``device`` (None: the card): the box-ADMM
    kernel (``'pallas'``) on the card, the plain version (``'xla'``) on
    the CPU."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    return "xla" if on_cpu else "pallas"


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; use {sorted(_DTYPES)}")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
