"""Data layer of the port: feature vocabularies and the synthetic generator."""

from phc_gnn_torch.data.features import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
    ZINC_ATOM_DIMS,
    ZINC_BOND_DIMS,
)
from phc_gnn_torch.data.synthetic import random_graph, synthetic_batch

__all__ = ["ATOM_FEATURE_DIMS", "BOND_FEATURE_DIMS", "ZINC_ATOM_DIMS",
           "ZINC_BOND_DIMS", "random_graph", "synthetic_batch"]
