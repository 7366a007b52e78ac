"""PHM graph convolution on padded edge lists.

Counterpart of phc_gnn_tpu/graph/conv.py for the ported variants, all on the
messages ``msg_encoder(x[senders] + edge_attr)``:

- ``PHMConv`` (conv.py:112-152): sum aggregation and a PHM linear
  ``transform``; with ``same_dim`` (the add-skip family) the self loop is
  added after it, ``transform(aggr) + x``, else (the concat-skip family,
  whose layers change width) before it, ``transform(aggr + x)``;
- ``PHMGINEConv`` (:155-193): sum aggregation, ``aggr + x``, then a 2-layer
  PHM MLP with its norm;
- ``PHMConvSoftmax`` (:196-240): softmax aggregation with a learnable beta
  and the linear ``transform``, the self loop placed by ``same_dim`` as in
  ``PHMConv``;
- ``PHMGINEConvSoftmax`` (:243-285): softmax aggregation with a learnable
  beta, ``aggr + x``, then the MLP.

The aggregations run the segment kernels over the batch's receiver CSR plan
(ops/segment_softmax.py, and kernel C's forward role in ops/segment_sum.py),
and the message gather's backward runs kernel C over its sender plan; a CPU
batch without a plan takes the plain composites and autograd's own gather
backward, a CUDA batch without one raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from phc_gnn_torch.graph.aggregators import AGGREGATORS, softmax_aggregate
from phc_gnn_torch.nn.activations import get_activation
from phc_gnn_torch.nn.phm_linear import PHMLinear, PHMMLP
from phc_gnn_torch.ops.segment_softmax import segment_softmax
from phc_gnn_torch.ops.segment_sum import gather_nodes, segment_sum_aggregate

__all__ = ["PHMConv", "PHMGINEConv", "PHMConvSoftmax", "PHMGINEConvSoftmax",
           "PHMMessagePassing"]


def _messages(x, senders, edge_attr, msg_encoder: str, snd_perm=None,
              snd_rowptr=None):
    """Edge messages: msg_encoder(x[senders] + edge_attr) (conv.py:49-76).
    With the batch's sender plan the gather's backward is kernel C; a CUDA
    gather that needs a gradient and has no plan raises."""
    if snd_rowptr is not None:
        gathered = gather_nodes(x, senders, snd_perm, snd_rowptr)
    elif (x.device.type != "cpu" and torch.is_grad_enabled()
            and x.requires_grad):
        raise ValueError(
            f"the message gather's backward on {x.device} runs kernel C over "
            f"the batch's sender plan: build the batch with "
            f"graph.attach_csr_plan")
    else:
        gathered = x.index_select(0, senders)
    return get_activation(msg_encoder)(gathered + edge_attr)


def _softmax_aggr(msgs, receivers, num_nodes: int, beta, edge_mask,
                  rowptr: Optional[torch.Tensor] = None):
    """Softmax aggregation through the segment kernels over the CSR plan
    (their plain versions for CPU tensors), differentiable in ``msgs`` and
    ``beta`` (conv.py:79-93).  Without a plan only CPU tensors are served, by
    the plain composite; a CUDA batch without one raises."""
    if rowptr is None:
        if msgs.device.type != "cpu":
            raise ValueError(
                f"softmax aggregation on {msgs.device} runs the segment "
                f"kernels, which walk the batch's CSR plan: build the batch "
                f"with graph.attach_csr_plan")
        return softmax_aggregate(msgs, receivers, num_nodes, beta, edge_mask)
    if edge_mask is None:
        edge_mask = torch.ones(msgs.shape[0], dtype=torch.bool,
                               device=msgs.device)
    return segment_softmax(msgs, edge_mask, beta, rowptr, receivers)


def _fixed_aggr(msgs, receivers, num_nodes: int, edge_mask, aggr: str,
                rowptr: Optional[torch.Tensor] = None):
    """Fixed-reduce aggregation (conv.py:96-109): the sum through kernel C
    over the CSR plan (its plain version for CPU tensors), differentiable in
    ``msgs``.  Without a plan only CPU tensors are served, by the plain
    composite; a CUDA batch without one raises."""
    if rowptr is None:
        if msgs.device.type != "cpu":
            raise ValueError(
                f"{aggr} aggregation on {msgs.device} runs kernel C, which "
                f"walks the batch's CSR plan: build the batch with "
                f"graph.attach_csr_plan")
        return AGGREGATORS[aggr](msgs, receivers, num_nodes, edge_mask)
    if edge_mask is None:
        edge_mask = torch.ones(msgs.shape[0], dtype=torch.bool,
                               device=msgs.device)
    return segment_sum_aggregate(msgs, receivers, edge_mask, rowptr)


def _check_fixed_aggr(aggr: str) -> None:
    if aggr not in AGGREGATORS:
        raise NotImplementedError(
            f"aggregation {aggr!r} is not ported yet (ROADMAP.md, section 1, "
            f"item 9)")


def _linear_out(transform, aggr, x, add_self_loops: bool, same_dim: bool):
    """``transform(aggr) + x`` with ``same_dim``, else ``transform(aggr +
    x)``; without self loops ``transform(aggr)`` (conv.py:144-151)."""
    if not add_self_loops:
        return transform(aggr)
    if same_dim:
        return transform(aggr) + x
    return transform(aggr + x)


class PHMConv(nn.Module):
    """Fixed-reduce conv with a PHM linear ``transform``; ``same_dim``
    places the self loop after it or before it (reference:
    messagepassing.py:19-88)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, w_init: str = "phm",
                 c_init: str = "standard", aggr: str = "sum",
                 same_dim: bool = True, msg_encoder: str = "identity",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_fixed_aggr(aggr)
        self.add_self_loops = add_self_loops
        self.same_dim = same_dim
        self.aggr = aggr
        self.msg_encoder = msg_encoder
        self.transform = PHMLinear(in_features, out_features, phm_dim, bias,
                                   w_init, c_init, learn_phm, generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None):
        msgs = _messages(x, senders, edge_attr, self.msg_encoder, snd_perm,
                         snd_rowptr)
        aggr = _fixed_aggr(msgs, receivers, x.shape[0], edge_mask, self.aggr,
                           rowptr)
        return _linear_out(self.transform, aggr, x, self.add_self_loops,
                           self.same_dim)


class PHMGINEConv(nn.Module):
    """GIN-E conv with a fixed aggregation: aggregate -> +self -> PHM MLP
    (reference: messagepassing.py:91-161)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, norm: Optional[str] = None,
                 activation: str = "relu", w_init: str = "phm",
                 c_init: str = "standard", aggr: str = "sum",
                 msg_encoder: str = "identity",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_fixed_aggr(aggr)
        self.add_self_loops = add_self_loops
        self.aggr = aggr
        self.msg_encoder = msg_encoder
        self.transform = PHMMLP(in_features, out_features, phm_dim, bias,
                                learn_phm, activation, norm, w_init, c_init,
                                factor=1.0, generator=generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None):
        msgs = _messages(x, senders, edge_attr, self.msg_encoder, snd_perm,
                         snd_rowptr)
        aggr = _fixed_aggr(msgs, receivers, x.shape[0], edge_mask, self.aggr,
                           rowptr)
        if self.add_self_loops:
            aggr = aggr + x
        return self.transform(aggr, training=training, mask=node_mask)


class PHMConvSoftmax(nn.Module):
    """Softmax aggregation with a learnable beta and a PHM linear
    ``transform``; ``same_dim`` places the self loop as in ``PHMConv``
    (reference: messagepassing.py:164-245)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, w_init: str = "phm",
                 c_init: str = "standard", same_dim: bool = True,
                 msg_encoder: str = "identity", initial_beta: float = 1.0,
                 learn_beta: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.add_self_loops = add_self_loops
        self.same_dim = same_dim
        self.msg_encoder = msg_encoder
        self.beta = nn.Parameter(torch.tensor(float(initial_beta)),
                                 requires_grad=learn_beta)
        self.transform = PHMLinear(in_features, out_features, phm_dim, bias,
                                   w_init, c_init, learn_phm, generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None):
        msgs = _messages(x, senders, edge_attr, self.msg_encoder, snd_perm,
                         snd_rowptr)
        aggr = _softmax_aggr(msgs, receivers, x.shape[0], self.beta,
                             edge_mask, rowptr)
        return _linear_out(self.transform, aggr, x, self.add_self_loops,
                           self.same_dim)


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
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None):
        msgs = _messages(x, senders, edge_attr, self.msg_encoder, snd_perm,
                         snd_rowptr)
        aggr = _softmax_aggr(msgs, receivers, x.shape[0], self.beta,
                             edge_mask, rowptr)
        if self.add_self_loops:
            aggr = aggr + x
        return self.transform(aggr, training=training, mask=node_mask)


class PHMMessagePassing(nn.Module):
    """Facade dispatching on (aggr, mlp) to a conv variant held as ``conv``
    (reference: messagepassing.py:456-518; conv.py:382-420).  Ported:
    aggr="softmax" and aggr="sum" (or "add"), each with mlp False or True;
    ``same_dim`` reaches the variants without an MLP."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, norm: Optional[str] = None,
                 activation: str = "relu", w_init: str = "phm",
                 c_init: str = "standard", aggr: str = "sum", mlp: bool = True,
                 same_dim: bool = True, msg_encoder: str = "identity",
                 initial_beta: float = 1.0, learn_beta: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        aggr = "sum" if aggr == "add" else aggr
        if aggr == "softmax" and not mlp:
            self.conv = PHMConvSoftmax(
                in_features, out_features, phm_dim, learn_phm, bias,
                add_self_loops, w_init, c_init, same_dim, msg_encoder,
                initial_beta, learn_beta, generator)
        elif aggr == "softmax":
            self.conv = PHMGINEConvSoftmax(
                in_features, out_features, phm_dim, learn_phm, bias,
                add_self_loops, norm, activation, w_init, c_init, msg_encoder,
                initial_beta, learn_beta, generator)
        elif mlp:
            self.conv = PHMGINEConv(
                in_features, out_features, phm_dim, learn_phm, bias,
                add_self_loops, norm, activation, w_init, c_init, aggr,
                msg_encoder, generator)
        else:
            self.conv = PHMConv(
                in_features, out_features, phm_dim, learn_phm, bias,
                add_self_loops, w_init, c_init, aggr, same_dim, msg_encoder,
                generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None):
        return self.conv(x, senders, receivers, edge_attr, edge_mask,
                         training=training, node_mask=node_mask,
                         rowptr=rowptr, snd_perm=snd_perm,
                         snd_rowptr=snd_rowptr)
