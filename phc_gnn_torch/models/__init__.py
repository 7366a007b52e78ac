"""Models of the port."""

from phc_gnn_torch.models.phc_gnn import PHCGNN

__all__ = ["PHCGNN"]
