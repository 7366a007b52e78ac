"""Categorical feature vocabulary sizes (copied from phc_gnn_tpu/data/features.py).

OGB molecular atom/bond vocabularies (ogb.utils.features allowable_features
lengths) and the ZINC-subset atom and bond types (reference train_zinc.py).
"""

from __future__ import annotations

__all__ = ["ATOM_FEATURE_DIMS", "BOND_FEATURE_DIMS", "ZINC_ATOM_DIMS",
           "ZINC_BOND_DIMS"]

ATOM_FEATURE_DIMS = [119, 5, 12, 12, 10, 6, 6, 2, 2]
BOND_FEATURE_DIMS = [5, 6, 2]

# ZINC-subset: atom types 28 (categorical), bond types 4 (categorical)
ZINC_ATOM_DIMS = [28]
ZINC_BOND_DIMS = [4]
