"""Feature vocabulary sizes and widths (copied from phc_gnn_tpu/data/features.py).

OGB molecular atom/bond vocabularies (ogb.utils.features allowable_features
lengths), the ZINC-subset atom and bond types, and the widths of the
superpixel and ogbg-ppa features (reference train_zinc.py:512-514,
train_mnist.py:519-520, train_cifar10.py:525-531, train_ppa.py).
"""

from __future__ import annotations

__all__ = ["ATOM_FEATURE_DIMS", "BOND_FEATURE_DIMS", "ZINC_ATOM_DIMS",
           "ZINC_BOND_DIMS", "MNIST_ATOM_DIM", "MNIST_BOND_DIM",
           "CIFAR10_ATOM_DIM", "CIFAR10_BOND_DIM", "PPA_EDGE_DIM",
           "PPA_NUM_CLASSES"]

ATOM_FEATURE_DIMS = [119, 5, 12, 12, 10, 6, 6, 2, 2]
BOND_FEATURE_DIMS = [5, 6, 2]

# ZINC-subset: atom types 28 (categorical), bond types 4 (categorical)
ZINC_ATOM_DIMS = [28]
ZINC_BOND_DIMS = [4]

# MNIST superpixels: x = intensity(1) + pos(2) continuous; edge feature 1 (dist)
MNIST_ATOM_DIM = 3
MNIST_BOND_DIM = 1

# CIFAR10 superpixels: RGB(3) + pos(2) continuous; edge feature 1
CIFAR10_ATOM_DIM = 5
CIFAR10_BOND_DIM = 1

# ogbg-ppa: no node features (encoded as single all-zero categorical), 7-dim
# continuous edge features, 37 classes
PPA_EDGE_DIM = 7
PPA_NUM_CLASSES = 37
