"""KMAE training (counterpart of ``koopmanx/train``)."""
from .kmae import (
    KMAEConfig,
    KMAEParams,
    KMAEState,
    differentiable_edmd,
    init_state,
    kmae_loss,
    make_train_step,
    make_windows,
)
from .trainer import (
    evaluate,
    export_weights,
    fit,
    load_checkpoint,
    save_checkpoint,
)
