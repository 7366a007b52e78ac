"""Graph readout pooling: global sum and soft-attention.

Counterpart of phc_gnn_tpu/graph/pooling.py (reference:
phc/hypercomplex/pooling.py:10-77).  With ``axis_name`` (a node-sharded
model's ``node_axis``) each shard sums its own nodes and the ``[G, d]``
partial sums are ``psum``-ed over the shards (pooling.py:27-60), so every
shard holds the whole batch's pooled rows.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from phc_gnn_torch.graph import segment as seg
from phc_gnn_torch.nn.phm_linear import PHMLinear, RealTransformer
from phc_gnn_torch.parallel import mesh

__all__ = ["PHMGlobalSumPooling", "PHMSoftAttentionPooling"]


class PHMGlobalSumPooling(nn.Module):
    """Masked segment-sum of node embeddings over graph ids."""

    def __init__(self, phm_dim: int):
        super().__init__()
        self.phm_dim = phm_dim

    def forward(self, x, graph_ids, num_graphs: int, node_mask=None,
                axis_name: Optional[str] = None):
        return _graph_sum(x, graph_ids, num_graphs, node_mask, axis_name)


def _graph_sum(x, graph_ids, num_graphs: int, node_mask, axis_name):
    """The masked sum of ``x`` per graph, over the node shards of
    ``axis_name`` where it is set."""
    out = seg.segment_sum(x, graph_ids, num_graphs, node_mask)
    return out if axis_name is None else mesh.psum(out, mesh.axis(axis_name))


class PHMSoftAttentionPooling(nn.Module):
    """sigmoid(RealTransformer(PHMLinear(x))) gate [N, d], broadcast over the
    n components, then the masked global sum.  Under a bf16 ``dtype`` the
    gate's ``PHMLinear`` runs in bf16 and its 'linear' real transformer in
    its float32 parameters, so the gate, the gated product and the sum are
    float32, as in JAX (pooling.py:44-60)."""

    def __init__(self, embed_dim: int, phm_dim: int, learn_phm: bool = True,
                 bias: bool = True, w_init: str = "phm",
                 c_init: str = "standard", real_trafo: str = "linear",
                 generator: Optional[torch.Generator] = None,
                 shared_rule: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.phm_dim = phm_dim
        self.linear = PHMLinear(embed_dim, embed_dim, phm_dim, bias, w_init,
                                c_init, learn_phm, generator, shared_rule,
                                dtype)
        self.real_trafo = RealTransformer(real_trafo, embed_dim, phm_dim,
                                          bias=True, generator=generator)

    def forward(self, x, graph_ids, num_graphs: int, node_mask=None,
                phm_rule=None, axis_name: Optional[str] = None):
        """``phm_rule``: the network's shared rule (``shared_rule``); the
        gate is per node, so only the final sum crosses the shards."""
        n = self.phm_dim
        gate = torch.sigmoid(self.real_trafo(self.linear(x, phm_rule)))
        xs = x.reshape(x.shape[0], n, self.embed_dim // n)
        gated = (gate[:, None, :] * xs).reshape(x.shape[0], self.embed_dim)
        return _graph_sum(gated, graph_ids, num_graphs, node_mask, axis_name)
