"""KMAE training (counterpart of ``koopmanx/train``)."""
from .kmae import (
    KMAEConfig,
    KMAEParams,
    KMAEState,
    cosine_adam,
    cosine_decay,
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
