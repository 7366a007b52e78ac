"""Training and serving steps of the port, losses and the optimizer."""

from phc_gnn_torch.train.loss import (
    masked_bce_with_logits,
    masked_cross_entropy,
    masked_l1,
    masked_mse,
)
from phc_gnn_torch.train.optim import Adam, ReduceLROnPlateau, make_optimizer
from phc_gnn_torch.train.state import (
    make_accum_train_step,
    make_eval_step,
    make_loss_and_grads,
    make_scan_eval_steps,
    make_scan_train_steps,
    make_train_step,
)

__all__ = ["Adam", "ReduceLROnPlateau", "make_accum_train_step",
           "make_eval_step", "make_loss_and_grads",
           "make_optimizer", "make_scan_eval_steps", "make_scan_train_steps",
           "make_train_step", "masked_bce_with_logits",
           "masked_cross_entropy", "masked_l1", "masked_mse"]
