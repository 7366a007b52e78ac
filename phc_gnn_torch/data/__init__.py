"""Data layer of the port: feature vocabularies, the synthetic generator and
the PNA degree statistics."""

from phc_gnn_torch.data.datasets import avg_deg_from_histogram, degree_histogram
from phc_gnn_torch.data.features import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
    ZINC_ATOM_DIMS,
    ZINC_BOND_DIMS,
)
from phc_gnn_torch.data.synthetic import (random_graph, synthetic_batch,
                                          synthetic_graphs)

__all__ = ["ATOM_FEATURE_DIMS", "BOND_FEATURE_DIMS", "ZINC_ATOM_DIMS",
           "ZINC_BOND_DIMS", "avg_deg_from_histogram", "degree_histogram",
           "random_graph", "synthetic_batch", "synthetic_graphs"]
