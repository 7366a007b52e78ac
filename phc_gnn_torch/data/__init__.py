"""Data layer of the port: feature vocabularies, dataset readers and
transforms, the bucketed padded loader with its native packer, background
prefetch to the card, the synthetic and parity generators, and the PNA
degree statistics."""

from phc_gnn_torch.data.datasets import (
    avg_deg_from_histogram,
    dataset_stats,
    degree_histogram,
    load_npz_dataset,
    load_ogb_graphproppred,
)
from phc_gnn_torch.data.features import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
    ZINC_ATOM_DIMS,
    ZINC_BOND_DIMS,
)
from phc_gnn_torch.data.loader import BucketSpec, PaddedLoader, compute_bucket_spec
from phc_gnn_torch.data.prefetch import PrefetchIterator, prefetch
from phc_gnn_torch.data.synthetic import (random_graph, synthetic_batch,
                                          synthetic_graphs)
from phc_gnn_torch.data.transforms import (
    add_zeros,
    concat_x_pos,
    extract_node_feature,
    remove_isolated_nodes,
)

__all__ = ["ATOM_FEATURE_DIMS", "BOND_FEATURE_DIMS", "BucketSpec",
           "PaddedLoader", "PrefetchIterator", "ZINC_ATOM_DIMS",
           "ZINC_BOND_DIMS", "add_zeros", "avg_deg_from_histogram",
           "compute_bucket_spec", "concat_x_pos", "dataset_stats",
           "degree_histogram", "extract_node_feature", "load_npz_dataset",
           "load_ogb_graphproppred", "prefetch", "random_graph",
           "remove_isolated_nodes", "synthetic_batch", "synthetic_graphs"]
