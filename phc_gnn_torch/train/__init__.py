"""Training and serving steps of the port, losses, the optimizer, the
evaluators, checkpoints and the Trainer."""

from phc_gnn_torch.train.checkpoint import CheckpointManager
from phc_gnn_torch.train.config import DATASET_DEFAULTS, ExperimentConfig
from phc_gnn_torch.train.evaluators import get_evaluator
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
from phc_gnn_torch.train.trainer import Trainer, build_loss, build_model

__all__ = ["Adam", "CheckpointManager", "DATASET_DEFAULTS",
           "ExperimentConfig", "ReduceLROnPlateau", "Trainer", "build_loss",
           "build_model", "get_evaluator", "make_accum_train_step",
           "make_eval_step", "make_loss_and_grads",
           "make_optimizer", "make_scan_eval_steps", "make_scan_train_steps",
           "make_train_step", "masked_bce_with_logits",
           "masked_cross_entropy", "masked_l1", "masked_mse"]
