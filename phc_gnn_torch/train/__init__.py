"""Training and serving steps of the port (eval step in this slice)."""

from phc_gnn_torch.train.state import make_eval_step

__all__ = ["make_eval_step"]
