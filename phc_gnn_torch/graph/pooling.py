"""Graph readout pooling: global sum and soft-attention.

Counterpart of phc_gnn_tpu/graph/pooling.py (reference:
phc/hypercomplex/pooling.py:10-77).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from phc_gnn_torch.graph import segment as seg
from phc_gnn_torch.nn.phm_linear import PHMLinear, RealTransformer

__all__ = ["PHMGlobalSumPooling", "PHMSoftAttentionPooling"]


class PHMGlobalSumPooling(nn.Module):
    """Masked segment-sum of node embeddings over graph ids."""

    def __init__(self, phm_dim: int):
        super().__init__()
        self.phm_dim = phm_dim

    def forward(self, x, graph_ids, num_graphs: int, node_mask=None):
        return seg.segment_sum(x, graph_ids, num_graphs, node_mask)


class PHMSoftAttentionPooling(nn.Module):
    """sigmoid(RealTransformer(PHMLinear(x))) gate [N, d], broadcast over the
    n components, then the masked global sum."""

    def __init__(self, embed_dim: int, phm_dim: int, learn_phm: bool = True,
                 bias: bool = True, w_init: str = "phm",
                 c_init: str = "standard", real_trafo: str = "linear",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.phm_dim = phm_dim
        self.linear = PHMLinear(embed_dim, embed_dim, phm_dim, bias, w_init,
                                c_init, learn_phm, generator)
        self.real_trafo = RealTransformer(real_trafo, embed_dim, phm_dim,
                                          bias=True, generator=generator)

    def forward(self, x, graph_ids, num_graphs: int, node_mask=None):
        n = self.phm_dim
        gate = torch.sigmoid(self.real_trafo(self.linear(x)))
        xs = x.reshape(x.shape[0], n, self.embed_dim // n)
        gated = (gate[:, None, :] * xs).reshape(x.shape[0], self.embed_dim)
        return seg.segment_sum(gated, graph_ids, num_graphs, node_mask)
