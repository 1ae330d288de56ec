"""Training on torch tensors (port of ``repro.training``): AdamW with
int8 error-feedback gradient compression, grad accumulation, activation
recomputation, a deterministic token pipeline and crash-safe
checkpoints."""
from .optimizer import AdamWState, init_adamw, adamw_update
from .train import make_train_step, make_loss_fn, softmax_cross_entropy
from .data import TokenPipeline
from .checkpoint import CheckpointManager

__all__ = ["AdamWState", "init_adamw", "adamw_update", "make_train_step",
           "make_loss_fn", "softmax_cross_entropy", "TokenPipeline",
           "CheckpointManager"]
