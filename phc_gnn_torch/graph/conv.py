"""PHM graph convolution on padded edge lists.

Counterpart of phc_gnn_tpu/graph/conv.py for the ported variant: messages
``msg_encoder(x[senders] + edge_attr)``, softmax aggregation with a learnable
beta, ``aggr + x``, then a 2-layer PHM MLP with its norm
(``PHMGINEConvSoftmax``, conv.py:243-285).  The aggregation runs the segment
kernels (ops/segment_softmax.py) over the batch's CSR plan; a CPU batch
without a plan takes the plain composite, a CUDA batch without one raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from phc_gnn_torch.graph.aggregators import softmax_aggregate
from phc_gnn_torch.nn.activations import get_activation
from phc_gnn_torch.nn.phm_linear import PHMMLP
from phc_gnn_torch.ops.segment_softmax import segment_softmax

__all__ = ["PHMGINEConvSoftmax", "PHMMessagePassing"]


def _messages(x, senders, edge_attr, msg_encoder: str):
    """Edge messages: msg_encoder(x[senders] + edge_attr)."""
    return get_activation(msg_encoder)(x.index_select(0, senders) + edge_attr)


def _softmax_aggr(msgs, receivers, num_nodes: int, beta, edge_mask,
                  rowptr: Optional[torch.Tensor] = None):
    """Softmax aggregation through the segment kernels over the CSR plan
    (their plain versions for CPU tensors).  Without a plan only CPU tensors
    are served, by the plain composite; a CUDA batch without one raises."""
    if rowptr is None:
        if msgs.device.type != "cpu":
            raise ValueError(
                f"softmax aggregation on {msgs.device} runs the segment "
                f"kernels, which walk the batch's CSR plan: build the batch "
                f"with graph.attach_csr_plan")
        return softmax_aggregate(msgs, receivers, num_nodes, beta, edge_mask)
    if msgs.device.type == "cuda" and torch.is_grad_enabled() and (
            msgs.requires_grad or beta.requires_grad):
        raise NotImplementedError(
            "the segment softmax kernels have no backward yet; it lands in "
            "the training slice (ROADMAP.md, section 2, kernel B): run the "
            "forward under torch.inference_mode() or train.make_eval_step")
    if edge_mask is None:
        edge_mask = torch.ones(msgs.shape[0], dtype=torch.bool,
                               device=msgs.device)
    return segment_softmax(msgs, edge_mask, beta, rowptr)


class PHMGINEConvSoftmax(nn.Module):
    """GIN-E conv with softmax aggregation: aggregate -> +self -> PHM MLP
    (reference: messagepassing.py:248-327)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, norm: Optional[str] = None,
                 activation: str = "relu", w_init: str = "phm",
                 c_init: str = "standard", msg_encoder: str = "identity",
                 initial_beta: float = 1.0, learn_beta: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.add_self_loops = add_self_loops
        self.msg_encoder = msg_encoder
        self.beta = nn.Parameter(torch.tensor(float(initial_beta)),
                                 requires_grad=learn_beta)
        self.transform = PHMMLP(in_features, out_features, phm_dim, bias,
                                learn_phm, activation, norm, w_init, c_init,
                                factor=1.0, generator=generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None):
        msgs = _messages(x, senders, edge_attr, self.msg_encoder)
        aggr = _softmax_aggr(msgs, receivers, x.shape[0], self.beta,
                             edge_mask, rowptr)
        if self.add_self_loops:
            aggr = aggr + x
        return self.transform(aggr, training=training, mask=node_mask)


class PHMMessagePassing(nn.Module):
    """Facade dispatching on (aggr, mlp) to a conv variant held as ``conv``
    (reference: messagepassing.py:456-518).  Ported: aggr="softmax" with
    mlp=True."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, norm: Optional[str] = None,
                 activation: str = "relu", w_init: str = "phm",
                 c_init: str = "standard", aggr: str = "sum", mlp: bool = True,
                 msg_encoder: str = "identity", initial_beta: float = 1.0,
                 learn_beta: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        aggr = "sum" if aggr == "add" else aggr
        if aggr != "softmax" or not mlp:
            raise NotImplementedError(
                f"conv variant aggr={aggr!r}, mlp={mlp} is not ported yet "
                f"(ROADMAP.md, section 1, item 9)")
        self.conv = PHMGINEConvSoftmax(
            in_features, out_features, phm_dim, learn_phm, bias,
            add_self_loops, norm, activation, w_init, c_init, msg_encoder,
            initial_beta, learn_beta, generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None):
        return self.conv(x, senders, receivers, edge_attr, edge_mask,
                         training=training, node_mask=node_mask,
                         rowptr=rowptr)
