"""PHM graph convolution on padded edge lists.

Counterpart of phc_gnn_tpu/graph/conv.py, all on the messages
``msg_encoder(x[senders] + edge_attr)``:

- ``PHMConv`` (conv.py:112-152): a fixed aggregation (sum, mean, min, max,
  var or std) and a PHM linear ``transform``; with ``same_dim`` (the
  add-skip family) the self loop is added after it, ``transform(aggr) +
  x``, else (the concat-skip family, whose layers change width) before it,
  ``transform(aggr + x)``;
- ``PHMGINEConv`` (:155-193): a fixed aggregation, ``aggr + x``, then a
  2-layer PHM MLP with its norm;
- ``PHMConvSoftmax`` (:196-240): softmax aggregation with a learnable beta
  and the linear ``transform``, the self loop placed by ``same_dim`` as in
  ``PHMConv``;
- ``PHMGINEConvSoftmax`` (:243-285): softmax aggregation with a learnable
  beta, ``aggr + x``, then the MLP;
- ``PHMPNAConvSimple`` (:288-348): several fixed aggregations (mean, min,
  max, std by default) joined by ``phm_cat``, each degree scaler applied to
  the join, joined again, then a stack of PHM linears (``post_0`` ...),
  the later ones behind a hardcoded naive batch norm and the activation.

The aggregations run the segment kernels over the batch's receiver CSR plan
(ops/segment_softmax.py; kernel C's forward role in ops/segment_sum.py for
sum and mean; kernels H and I in ops/segment_reduce.py for min, max, var and
std), and the message gather's backward runs kernel C over its sender plan;
a CPU batch without a plan takes the plain composites and autograd's own
gather backward, a CUDA batch without one raises.  A conv on the composite
route (``composite``, which ``PHCGNN`` sets from ``agg_kernel="xla"``, or
``edge_axis``) takes the composites of graph/aggregators.py on any device
and reads no plan, as JAX's XLA route does (conv.py:79-109); the gather's
backward is then autograd's ``index_add_``.  ``edge_axis`` names the mesh
axis of an edge partition (parallel/edge_partition.py): the composites and
PNA's degree count reduce over it.  The two routes differ at ties: over the
plan every edge that attains a min or max gets the whole cotangent (JAX's
streamed VJP), the composite splits it (JAX's XLA ``segment_max``).

``dtype`` is the compute dtype of every PHM linear of a conv (the model's
``compute_dtype``, None for float32).  Under bf16 the node features, edge
embeddings and messages are bf16, the plan's aggregations read the bf16
messages and return float32 (ops/), so ``aggr + x`` promotes to float32
as JAX's does, and each linear casts its input back to bf16.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from phc_gnn_torch.graph.aggregators import (AGGREGATORS, SCALERS,
                                             node_degrees, phm_cat,
                                             softmax_aggregate)
from phc_gnn_torch.graph.segment import segment_count
from phc_gnn_torch.nn.activations import get_activation
from phc_gnn_torch.nn.norm import PHMNorm
from phc_gnn_torch.nn.phm_linear import PHMLinear, PHMMLP
from phc_gnn_torch.ops.segment_reduce import (segment_extreme_aggregate,
                                              segment_mean_aggregate,
                                              segment_std_aggregate,
                                              segment_var_aggregate)
from phc_gnn_torch.ops.segment_softmax import segment_softmax
from phc_gnn_torch.ops.segment_sum import (gather_nodes, halo_gather_split,
                                           segment_sum_aggregate)

__all__ = ["PHMConv", "PHMGINEConv", "PHMConvSoftmax", "PHMGINEConvSoftmax",
           "PHMPNAConvSimple", "PHMMessagePassing"]


def _messages(x, senders, edge_attr, msg_encoder: str, snd_perm=None,
              snd_rowptr=None, x_remote=None, composite: bool = False):
    """Edge messages: msg_encoder(x[senders] + edge_attr) (conv.py:49-76).
    With the batch's sender plan the gather's backward is kernel C; a CUDA
    gather that needs a gradient and has no plan raises, unless the conv
    is on the ``composite`` route, which reads no plan.  ``x_remote``
    [S*H, d] holds the halo rows of a node shard (parallel/halo.py):
    ``senders`` then index ``concat([x, x_remote])``, and the backward is C's
    halo role over the shard's augmented sender plan."""
    if composite:
        snd_perm = snd_rowptr = None
    elif (snd_rowptr is None and x.device.type != "cpu"
            and torch.is_grad_enabled()
            and (x.requires_grad
                 or (x_remote is not None and x_remote.requires_grad))):
        raise ValueError(
            f"the message gather's backward on {x.device} runs kernel C over "
            f"the batch's sender plan: build the batch with "
            f"graph.attach_csr_plan (a node shard with "
            f"parallel.partition_nodes), or take the composite route "
            f"(agg_kernel='xla')")
    if x_remote is not None:
        gathered = (halo_gather_split(x, x_remote, senders, snd_perm,
                                      snd_rowptr)
                    if snd_rowptr is not None
                    else torch.cat([x, x_remote]).index_select(0, senders))
    elif snd_rowptr is not None:
        gathered = gather_nodes(x, senders, snd_perm, snd_rowptr)
    else:
        gathered = x.index_select(0, senders)
    return get_activation(msg_encoder)(gathered + edge_attr)


def _softmax_aggr(msgs, receivers, num_nodes: int, beta, edge_mask,
                  rowptr: Optional[torch.Tensor] = None,
                  composite: bool = False, edge_axis: Optional[str] = None):
    """Softmax aggregation through the segment kernels over the CSR plan
    (their plain versions for CPU tensors), differentiable in ``msgs`` and
    ``beta`` (conv.py:79-93).  On the ``composite`` route, and for a CPU
    batch without a plan, the plain composite, over ``edge_axis`` where it
    is set; a CUDA batch without a plan off that route raises."""
    if composite or rowptr is None:
        if not composite and msgs.device.type != "cpu":
            raise ValueError(
                f"softmax aggregation on {msgs.device} runs the segment "
                f"kernels, which walk the batch's CSR plan: build the batch "
                f"with graph.attach_csr_plan, or take the composite route "
                f"(agg_kernel='xla')")
        return softmax_aggregate(msgs, receivers, num_nodes, beta, edge_mask,
                                 axis_name=edge_axis)
    if edge_mask is None:
        edge_mask = torch.ones(msgs.shape[0], dtype=torch.bool,
                               device=msgs.device)
    return segment_softmax(msgs, edge_mask, beta, rowptr, receivers)


def _fixed_aggr(msgs, receivers, num_nodes: int, edge_mask, aggr: str,
                rowptr: Optional[torch.Tensor] = None,
                counts: Optional[torch.Tensor] = None,
                composite: bool = False, edge_axis: Optional[str] = None):
    """Fixed-reduce aggregation (conv.py:96-109) over the CSR plan, through
    kernel C (sum, mean) and kernels H (min, max) and I (var, std), their
    plain versions for CPU tensors; differentiable in ``msgs``.  ``counts``
    [N], the real edges of each receiver, serves mean, var and std (computed
    here if not given).  On the ``composite`` route, and for a CPU batch
    without a plan, the plain composites, over ``edge_axis`` where it is
    set; a CUDA batch without a plan off that route raises."""
    if composite or rowptr is None:
        if not composite and msgs.device.type != "cpu":
            raise ValueError(
                f"{aggr} aggregation on {msgs.device} runs the segment "
                f"kernels, which walk the batch's CSR plan: build the batch "
                f"with graph.attach_csr_plan, or take the composite route "
                f"(agg_kernel='xla')")
        return AGGREGATORS[aggr](msgs, receivers, num_nodes, edge_mask,
                                 axis_name=edge_axis)
    if edge_mask is None:
        edge_mask = torch.ones(msgs.shape[0], dtype=torch.bool,
                               device=msgs.device)
    if aggr == "sum":
        return segment_sum_aggregate(msgs, receivers, edge_mask, rowptr)
    if aggr in ("min", "max"):
        return segment_extreme_aggregate(msgs, receivers, edge_mask, rowptr,
                                         minimum=aggr == "min")
    if counts is None:
        counts = segment_count(receivers, num_nodes, edge_mask)
    if aggr == "mean":
        return segment_mean_aggregate(msgs, receivers, edge_mask, rowptr,
                                      counts)
    if aggr == "var":
        return segment_var_aggregate(msgs, receivers, edge_mask, rowptr,
                                     counts)
    return segment_std_aggregate(msgs, receivers, edge_mask, rowptr, counts)


def _check_fixed_aggr(aggr: str) -> None:
    if aggr not in AGGREGATORS:
        raise ValueError(f"unknown aggregation {aggr!r}: one of "
                         f"{sorted(AGGREGATORS)}, softmax or pna")


class _Conv(nn.Module):
    """What every conv shares: its aggregation route.  ``edge_axis`` is
    the mesh axis of an edge partition, or None; ``composite`` takes the
    composites on every device (``agg_kernel="xla"``), and so does
    ``edge_axis``, as JAX reads no plan under it (conv.py:85, :101).  A
    model sets both on its convs (``PHCGNN.set_edge_axis``,
    ``set_composite``)."""

    def __init__(self, edge_axis: Optional[str] = None,
                 composite: bool = False):
        super().__init__()
        self.edge_axis = edge_axis
        self.composite = composite

    @property
    def composite_route(self) -> bool:
        return self.composite or self.edge_axis is not None

    def messages(self, x, senders, edge_attr, snd_perm, snd_rowptr,
                 x_remote):
        return _messages(x, senders, edge_attr, self.msg_encoder, snd_perm,
                         snd_rowptr, x_remote, self.composite_route)

    def fixed_aggr(self, msgs, receivers, num_nodes, edge_mask, aggr, rowptr,
                   counts=None):
        return _fixed_aggr(msgs, receivers, num_nodes, edge_mask, aggr,
                           rowptr, counts, self.composite_route,
                           self.edge_axis)

    def softmax_aggr(self, msgs, receivers, num_nodes, edge_mask, rowptr):
        return _softmax_aggr(msgs, receivers, num_nodes, self.beta, edge_mask,
                             rowptr, self.composite_route, self.edge_axis)


def _linear_out(transform, aggr, x, add_self_loops: bool, same_dim: bool,
                phm_rule=None):
    """``transform(aggr) + x`` with ``same_dim``, else ``transform(aggr +
    x)``; without self loops ``transform(aggr)`` (conv.py:144-151)."""
    if not add_self_loops:
        return transform(aggr, phm_rule)
    if same_dim:
        return transform(aggr, phm_rule) + x
    return transform(aggr + x, phm_rule)


class PHMConv(_Conv):
    """Fixed-reduce conv with a PHM linear ``transform``; ``same_dim``
    places the self loop after it or before it (reference:
    messagepassing.py:19-88)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, w_init: str = "phm",
                 c_init: str = "standard", aggr: str = "sum",
                 same_dim: bool = True, msg_encoder: str = "identity",
                 generator: Optional[torch.Generator] = None,
                 shared_rule: bool = False, dtype: Optional[torch.dtype] = None,
                 edge_axis: Optional[str] = None, composite: bool = False):
        super().__init__(edge_axis, composite)
        _check_fixed_aggr(aggr)
        self.add_self_loops = add_self_loops
        self.same_dim = same_dim
        self.aggr = aggr
        self.msg_encoder = msg_encoder
        self.transform = PHMLinear(in_features, out_features, phm_dim, bias,
                                   w_init, c_init, learn_phm, generator,
                                   shared_rule, dtype)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None, phm_rule=None, x_remote=None):
        msgs = self.messages(x, senders, edge_attr, snd_perm, snd_rowptr,
                             x_remote)
        aggr = self.fixed_aggr(msgs, receivers, x.shape[0], edge_mask,
                               self.aggr, rowptr)
        return _linear_out(self.transform, aggr, x, self.add_self_loops,
                           self.same_dim, phm_rule)


class PHMGINEConv(_Conv):
    """GIN-E conv with a fixed aggregation: aggregate -> +self -> PHM MLP
    (reference: messagepassing.py:91-161)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, norm: Optional[str] = None,
                 activation: str = "relu", w_init: str = "phm",
                 c_init: str = "standard", aggr: str = "sum",
                 msg_encoder: str = "identity",
                 generator: Optional[torch.Generator] = None,
                 shared_rule: bool = False, dtype: Optional[torch.dtype] = None,
                 edge_axis: Optional[str] = None, composite: bool = False):
        super().__init__(edge_axis, composite)
        _check_fixed_aggr(aggr)
        self.add_self_loops = add_self_loops
        self.aggr = aggr
        self.msg_encoder = msg_encoder
        self.transform = PHMMLP(in_features, out_features, phm_dim, bias,
                                learn_phm, activation, norm, w_init, c_init,
                                factor=1.0, generator=generator,
                                shared_rule=shared_rule, dtype=dtype)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None, phm_rule=None, x_remote=None):
        msgs = self.messages(x, senders, edge_attr, snd_perm, snd_rowptr,
                             x_remote)
        aggr = self.fixed_aggr(msgs, receivers, x.shape[0], edge_mask,
                               self.aggr, rowptr)
        if self.add_self_loops:
            aggr = aggr + x
        return self.transform(aggr, training=training, mask=node_mask,
                              phm_rule=phm_rule)


class PHMConvSoftmax(_Conv):
    """Softmax aggregation with a learnable beta and a PHM linear
    ``transform``; ``same_dim`` places the self loop as in ``PHMConv``
    (reference: messagepassing.py:164-245)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, w_init: str = "phm",
                 c_init: str = "standard", same_dim: bool = True,
                 msg_encoder: str = "identity", initial_beta: float = 1.0,
                 learn_beta: bool = True,
                 generator: Optional[torch.Generator] = None,
                 shared_rule: bool = False, dtype: Optional[torch.dtype] = None,
                 edge_axis: Optional[str] = None, composite: bool = False):
        super().__init__(edge_axis, composite)
        self.add_self_loops = add_self_loops
        self.same_dim = same_dim
        self.msg_encoder = msg_encoder
        self.beta = nn.Parameter(torch.tensor(float(initial_beta)),
                                 requires_grad=learn_beta)
        self.transform = PHMLinear(in_features, out_features, phm_dim, bias,
                                   w_init, c_init, learn_phm, generator,
                                   shared_rule, dtype)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None, phm_rule=None, x_remote=None):
        msgs = self.messages(x, senders, edge_attr, snd_perm, snd_rowptr,
                             x_remote)
        aggr = self.softmax_aggr(msgs, receivers, x.shape[0], edge_mask,
                                 rowptr)
        return _linear_out(self.transform, aggr, x, self.add_self_loops,
                           self.same_dim, phm_rule)


class PHMGINEConvSoftmax(_Conv):
    """GIN-E conv with softmax aggregation: aggregate -> +self -> PHM MLP
    (reference: messagepassing.py:248-327)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, norm: Optional[str] = None,
                 activation: str = "relu", w_init: str = "phm",
                 c_init: str = "standard", msg_encoder: str = "identity",
                 initial_beta: float = 1.0, learn_beta: bool = True,
                 generator: Optional[torch.Generator] = None,
                 shared_rule: bool = False, dtype: Optional[torch.dtype] = None,
                 edge_axis: Optional[str] = None, composite: bool = False):
        super().__init__(edge_axis, composite)
        self.add_self_loops = add_self_loops
        self.msg_encoder = msg_encoder
        self.beta = nn.Parameter(torch.tensor(float(initial_beta)),
                                 requires_grad=learn_beta)
        self.transform = PHMMLP(in_features, out_features, phm_dim, bias,
                                learn_phm, activation, norm, w_init, c_init,
                                factor=1.0, generator=generator,
                                shared_rule=shared_rule, dtype=dtype)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None, phm_rule=None, x_remote=None):
        msgs = self.messages(x, senders, edge_attr, snd_perm, snd_rowptr,
                             x_remote)
        aggr = self.softmax_aggr(msgs, receivers, x.shape[0], edge_mask,
                                 rowptr)
        if self.add_self_loops:
            aggr = aggr + x
        return self.transform(aggr, training=training, mask=node_mask,
                              phm_rule=phm_rule)


class PHMPNAConvSimple(_Conv):
    """Simplified principal-neighbourhood-aggregation conv: multi-aggregate
    -> phm_cat -> degree scalers -> phm_cat -> PHM linear stack (reference:
    messagepassing.py:339-453).  ``avg_deg`` holds the dataset's degree
    statistics (``data.datasets.avg_deg_from_histogram``).  It has no self
    loop.  For ``post_layers`` > 1 each later PHM linear ``post_i`` follows
    the activation and, where ``norm`` is set, a naive batch norm
    ``post_norm_i`` whatever ``norm`` names, as the reference hardcodes."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 avg_deg: Dict[str, float], learn_phm: bool = True,
                 bias: bool = True, activation: str = "relu",
                 norm: Optional[str] = None, w_init: str = "phm",
                 c_init: str = "standard",
                 aggregators: Sequence[str] = ("mean", "min", "max", "std"),
                 scalers: Sequence[str] = ("identity", "amplification",
                                           "attenuation"),
                 post_layers: int = 1, msg_encoder: str = "relu",
                 generator: Optional[torch.Generator] = None,
                 shared_rule: bool = False, dtype: Optional[torch.dtype] = None,
                 edge_axis: Optional[str] = None, composite: bool = False):
        super().__init__(edge_axis, composite)
        if avg_deg is None:
            raise ValueError("the PNA conv needs avg_deg, the dataset's "
                             "degree statistics")
        for aggr in aggregators:
            _check_fixed_aggr(aggr)
        unknown = [s for s in scalers if s not in SCALERS]
        if unknown:
            raise ValueError(f"unknown scalers {unknown}: one of "
                             f"{sorted(SCALERS)}")
        if post_layers < 1:
            raise ValueError(f"post_layers must be >= 1, got {post_layers}")
        self.phm_dim = phm_dim
        self.avg_deg = dict(avg_deg)
        self.aggregators = tuple(aggregators)
        self.scalers = tuple(scalers)
        self.post_layers = post_layers
        self.msg_encoder = msg_encoder
        self.has_norm = norm not in (None, "None")
        self.act = get_activation(activation)
        in_dim = len(self.aggregators) * len(self.scalers) * in_features
        self.post_0 = PHMLinear(in_dim, out_features, phm_dim, bias, w_init,
                                c_init, learn_phm, generator, shared_rule,
                                dtype)
        for i in range(1, post_layers):
            if self.has_norm:
                self.add_module(f"post_norm_{i}", PHMNorm(
                    out_features, phm_dim, "naive-batch-norm"))
            self.add_module(f"post_{i}", PHMLinear(
                out_features, out_features, phm_dim, bias, w_init, c_init,
                learn_phm, generator, shared_rule, dtype))

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None, phm_rule=None, x_remote=None):
        num_nodes = x.shape[0]
        msgs = self.messages(x, senders, edge_attr, snd_perm, snd_rowptr,
                             x_remote)
        deg = node_degrees(receivers, num_nodes, edge_mask,
                           axis_name=self.edge_axis)
        out = phm_cat([self.fixed_aggr(msgs, receivers, num_nodes, edge_mask,
                                       a, rowptr, deg[:, 0])
                       for a in self.aggregators], self.phm_dim)
        out = phm_cat([SCALERS[s](out, deg, self.avg_deg)
                       for s in self.scalers], self.phm_dim)
        out = self.post_0(out, phm_rule)
        for i in range(1, self.post_layers):
            if self.has_norm:
                out = getattr(self, f"post_norm_{i}")(out, training=training,
                                                      mask=node_mask)
            out = getattr(self, f"post_{i}")(self.act(out), phm_rule)
        return out


class PHMMessagePassing(nn.Module):
    """Facade dispatching on (aggr, mlp) to a conv variant held as ``conv``
    (reference: messagepassing.py:456-518; conv.py:382-440): "softmax" and
    the fixed aggregations ("add" aliases "sum"), each with mlp False or
    True, ``same_dim`` reaching the variants without an MLP; "pna" builds
    ``PHMPNAConvSimple`` from ``avg_deg``, ``aggregators``, ``scalers`` and
    ``post_layers`` with the message encoder "relu", whatever
    ``msg_encoder``, ``mlp``, ``add_self_loops`` and ``same_dim`` say, as
    flax's does.  With ``shared_rule`` the conv's PHM layers own no rule and
    ``forward`` takes the network's as ``phm_rule``.  ``edge_axis`` and
    ``composite`` set the conv's aggregation route (``_Conv``)."""

    def __init__(self, in_features: int, out_features: int, phm_dim: int,
                 learn_phm: bool = True, bias: bool = True,
                 add_self_loops: bool = True, norm: Optional[str] = None,
                 activation: str = "relu", w_init: str = "phm",
                 c_init: str = "standard", aggr: str = "sum", mlp: bool = True,
                 same_dim: bool = True, msg_encoder: str = "identity",
                 initial_beta: float = 1.0, learn_beta: bool = True,
                 generator: Optional[torch.Generator] = None,
                 avg_deg: Optional[Dict[str, float]] = None,
                 aggregators: Sequence[str] = ("mean", "min", "max", "std"),
                 scalers: Sequence[str] = ("identity", "amplification",
                                           "attenuation"),
                 post_layers: int = 1, shared_rule: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 edge_axis: Optional[str] = None, composite: bool = False):
        super().__init__()
        aggr = "sum" if aggr == "add" else aggr
        route = dict(edge_axis=edge_axis, composite=composite)
        if aggr == "pna":
            self.conv = PHMPNAConvSimple(
                in_features, out_features, phm_dim, avg_deg, learn_phm, bias,
                activation, norm, w_init, c_init, aggregators, scalers,
                post_layers, msg_encoder="relu", generator=generator,
                shared_rule=shared_rule, dtype=dtype, **route)
        elif aggr == "softmax" and not mlp:
            self.conv = PHMConvSoftmax(
                in_features, out_features, phm_dim, learn_phm, bias,
                add_self_loops, w_init, c_init, same_dim, msg_encoder,
                initial_beta, learn_beta, generator, shared_rule, dtype,
                **route)
        elif aggr == "softmax":
            self.conv = PHMGINEConvSoftmax(
                in_features, out_features, phm_dim, learn_phm, bias,
                add_self_loops, norm, activation, w_init, c_init, msg_encoder,
                initial_beta, learn_beta, generator, shared_rule, dtype,
                **route)
        elif mlp:
            self.conv = PHMGINEConv(
                in_features, out_features, phm_dim, learn_phm, bias,
                add_self_loops, norm, activation, w_init, c_init, aggr,
                msg_encoder, generator, shared_rule, dtype, **route)
        else:
            self.conv = PHMConv(
                in_features, out_features, phm_dim, learn_phm, bias,
                add_self_loops, w_init, c_init, aggr, same_dim, msg_encoder,
                generator, shared_rule, dtype, **route)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                training: bool = False, node_mask=None, rowptr=None,
                snd_perm=None, snd_rowptr=None, phm_rule=None, x_remote=None):
        return self.conv(x, senders, receivers, edge_attr, edge_mask,
                         training=training, node_mask=node_mask,
                         rowptr=rowptr, snd_perm=snd_perm,
                         snd_rowptr=snd_rowptr, phm_rule=phm_rule,
                         x_remote=x_remote)
