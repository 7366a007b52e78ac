"""End-to-end PHC-GNN: the add-skip and the concat-skip families.

Counterpart of phc_gnn_tpu/models/phc_gnn.py: atom-encode -> flatten
[N, n*d] -> L x (bond-encode, conv, norm, act, dropout, skip) -> pool ->
downstream head.  ``skip_connect="add"`` adds the skip, whose source
``sc_type`` selects: "first" = the initial embedding, "last" = the previous
layer's output.  ``skip_connect="concat"`` concatenates the initial
embedding to every layer's output, so the widths grow (phc_gnn.py:104-121,
:162-163, :253-256): layer i takes ``mp_layers[i-1] + embed`` features, its
bond encoder emits that width, its conv (``same_dim=False``) adds the self
loop before the transform, and pooling and head take ``mp_layers[-1] +
embed``.  Module names follow the flax tree (``atomencoder``,
``bondencoder_<i>``, ``conv_<i>``, ``norm_<i>``, ``pooling``,
``downstream``; a PNA conv's ``conv_<i>.conv.post_<j>`` and
``post_norm_<j>``), so ``convert.from_flax_variables`` maps paths one to
one.  ``msg_aggr="pna"`` takes ``avg_deg`` (the training split's degree
statistics, ``data.datasets.avg_deg_from_histogram``) and the
``pna_aggregators``, ``pna_scalers`` and ``pna_post_layers`` of every conv.
``unique_phm`` shares one contribution tensor, ``phm_rule_shared`` (n, n,
n), across the network (phc_gnn.py:123-132): every PHM layer of the convs,
the pooling and the head takes it as its rule and owns none; it is drawn
U(-1, 1) for ``c_init="random"``, else it is the fixed rule, and without
``learn_phm`` no gradient reaches it.  As in JAX, the rule regularization
(``nn/regularization.py``, parameters named ``phm_rule``) does not count it.

The model is initialised from ``seed`` on a CPU ``torch.Generator`` and then
moved to ``device`` (default "cuda"; without CUDA it raises unless
``device="cpu"``).  The training forward (phc_gnn.py:202-266) takes a
``torch.Generator`` on that device for its dropout masks; it updates the
batch-norm running stats in place.

``node_axis="ep"`` (``set_node_axis``) is the node-sharded halo path
(phc_gnn.py:208-264) for batches cut by ``parallel.partition_nodes``,
inside a step of parallel/halo.py: before each conv the shard sends the
boundary rows of ``x`` that other shards' edges read and receives theirs
(``parallel.halo.halo_exchange``), the conv gathers from both
(``ops.segment_sum.halo_gather_split``), the layers' norms take their
statistics over all shards, the node dropout of each shard draws its own
masks while the head's is shared, and the pooling sums over the shards.

``composite=True`` (``set_composite``; ``train.trainer.build_model`` sets it
from ``agg_kernel="xla"``) runs every aggregation through the composites of
graph/aggregators.py on any device, as JAX's XLA route does, and reads no
CSR plan: the batches need none.  ``edge_axis="ep"`` (``set_edge_axis``) is
the replicated scheme (parallel/edge_partition.py, phc_gnn.py:184-191): each
rank holds an edge shard of the batch (``parallel.edge_shard``) and every
node; the convs take the composite route, their reductions combined over the
axis, and ignore the batch's plans, while the norms, the dropout and the
pooling stay local, as the nodes are replicated.

``compute_dtype=torch.bfloat16`` runs the activations in bf16 from the
encoders' outputs on (phc_gnn.py:199-200, :225-226) while the parameters,
and so the gradients and Adam's state, stay float32: every PHM linear
computes in bf16, the norms in float32 cast back, the aggregation kernels
read bf16 messages and return float32, and the head's real transformer
takes float32 (``nn/``, ``graph/``, ``ops/`` say where).  The output is
float32.  ``remat=True`` rematerializes each conv as ``nn.remat`` does
(phc_gnn.py:233-240): ``torch.utils.checkpoint`` (non-reentrant) keeps its
inputs and recomputes the rest, the softmax weights ``w`` included, in the
backward; the recompute leaves the running stats as the forward left them
(``nn.norm.frozen_running_stats``) and draws no random numbers, so it does
not touch the RNG state, which a CUDA graph's capture could not read.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from phc_gnn_torch.data.features import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS
from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.graph.batch import GraphsTuple
from phc_gnn_torch.graph.conv import PHMMessagePassing
from phc_gnn_torch.graph.pooling import PHMGlobalSumPooling, PHMSoftAttentionPooling
from phc_gnn_torch.nn.activations import get_activation
from phc_gnn_torch.nn.downstream import PHMDownstreamNet
from phc_gnn_torch.nn.dropout import phm_dropout
from phc_gnn_torch.nn.encoder import NaivePHMEncoder, PHMEncoder
from phc_gnn_torch.nn.norm import PHMNorm, frozen_running_stats
from phc_gnn_torch.nn.phm_linear import init_rule
from phc_gnn_torch.parallel import mesh
from phc_gnn_torch.parallel.halo import halo_exchange

__all__ = ["PHCGNN"]

COMPUTE_DTYPES = (None, torch.float32, torch.bfloat16)


def _remat_contexts():
    """``checkpoint``'s contexts: none around the forward, the running
    stats frozen around the recompute."""
    return contextlib.nullcontext(), frozen_running_stats()


class PHCGNN(nn.Module):
    """Generic PHC-GNN for graph-level prediction on padded batches; the
    arguments and their defaults are those of the flax module."""

    def __init__(self, phm_dim: int = 4, learn_phm: bool = True,
                 unique_phm: bool = False,
                 atom_input_dims: Union[int, Sequence[int]] = tuple(ATOM_FEATURE_DIMS),
                 atom_encoded_dim: int = 196,
                 bond_input_dims: Union[int, Sequence[int]] = tuple(BOND_FEATURE_DIMS),
                 naive_encoder: bool = False, w_init: str = "phm",
                 c_init: str = "standard", same_dropout: bool = False,
                 mp_layers: Sequence[int] = (196, 196, 196), bias: bool = True,
                 dropout_mpnn: Sequence[float] = (0.0, 0.0, 0.0),
                 norm_mp: Optional[str] = "naive-batch-norm",
                 add_self_loops: bool = True, msg_aggr: str = "add",
                 mlp_mp: bool = False, pooling: str = "softattention",
                 activation: str = "relu", real_trafo: str = "linear",
                 downstream_layers: Sequence[int] = (256, 128),
                 target_dim: int = 1,
                 dropout_dn: Union[float, Sequence[float]] = (0.2, 0.1),
                 norm_dn: Optional[str] = "naive-batch-norm",
                 msg_encoder: str = "identity", sc_type: str = "first",
                 skip_connect: str = "add", initial_beta: float = 1.0,
                 learn_beta: bool = True, edge_axis: Optional[str] = None,
                 node_axis: Optional[str] = None, compute_dtype=None,
                 remat: bool = False, composite: bool = False,
                 avg_deg: Optional[Dict[str, float]] = None,
                 pna_aggregators: Sequence[str] = ("mean", "min", "max", "std"),
                 pna_scalers: Sequence[str] = ("identity", "amplification",
                                               "attenuation"),
                 pna_post_layers: int = 1, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        if skip_connect not in ("add", "concat"):
            raise ValueError(f"skip_connect must be 'add' or 'concat', got "
                             f"{skip_connect!r}")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be None, torch.float32 or "
                             f"torch.bfloat16, got {compute_dtype!r}")
        if sc_type not in ("first", "last"):
            raise ValueError(f"sc_type must be 'first' or 'last', got {sc_type!r}")
        if pooling not in ("globalsum", "softattention"):
            raise ValueError(f"unknown pooling {pooling!r}")
        if skip_connect == "add" and not all(d == atom_encoded_dim
                                             for d in mp_layers):
            raise ValueError("the add-skip model needs equal dims "
                             "(reference models.py:46)")
        if len(dropout_mpnn) != len(mp_layers):
            raise ValueError("dropout_mpnn needs one rate per layer")
        n = phm_dim
        gen = torch.Generator().manual_seed(seed)
        # float32 computes as None does: the casts would change nothing
        dtype = None if compute_dtype == torch.float32 else compute_dtype
        self.compute_dtype = dtype
        self.remat = remat
        self.phm_dim = n
        self.sc_type = sc_type
        self.concat = skip_connect == "concat"
        self.same_dropout = same_dropout
        self.dropout_mpnn = tuple(float(p) for p in dropout_mpnn)
        self.num_layers = len(mp_layers)
        self.act = get_activation(activation)
        embed = atom_encoded_dim
        self.learn_phm = learn_phm
        # one rule for the whole network (phc_gnn.py:123-132); the layers
        # then own none
        self.phm_rule_shared = (nn.Parameter(init_rule(gen, c_init, n),
                                             requires_grad=learn_phm)
                                if unique_phm else None)

        encoder = NaivePHMEncoder if naive_encoder else PHMEncoder
        self.atomencoder = encoder(embed // n, atom_input_dims, n,
                                   generator=gen)
        for i, d in enumerate(mp_layers):
            # the input width (in the add-skip family every width is the
            # embedding's), which the bond encoder emits too
            in_dim = embed if i == 0 else mp_layers[i - 1] + (
                embed if self.concat else 0)
            self.add_module(f"bondencoder_{i}", encoder(
                in_dim // n, bond_input_dims, n, generator=gen))
            self.add_module(f"conv_{i}", PHMMessagePassing(
                in_dim, d, n, learn_phm, bias, add_self_loops, norm_mp,
                activation, w_init, c_init, aggr=msg_aggr, mlp=mlp_mp,
                same_dim=not self.concat, msg_encoder=msg_encoder,
                initial_beta=initial_beta, learn_beta=learn_beta,
                generator=gen, avg_deg=avg_deg, aggregators=pna_aggregators,
                scalers=pna_scalers, post_layers=pna_post_layers,
                shared_rule=unique_phm, dtype=dtype))
            if norm_mp not in (None, "None"):
                self.add_module(f"norm_{i}", PHMNorm(d, n, norm_mp))
        self.has_norm = norm_mp not in (None, "None")

        final_dim = mp_layers[-1] + (embed if self.concat else 0)
        if pooling == "globalsum":
            self.pooling = PHMGlobalSumPooling(n)
        else:
            self.pooling = PHMSoftAttentionPooling(
                final_dim, n, learn_phm, bias, w_init, c_init, real_trafo,
                generator=gen, shared_rule=unique_phm, dtype=dtype)
        self.downstream = PHMDownstreamNet(
            final_dim, tuple(downstream_layers), target_dim, n, activation,
            bias, norm_dn, w_init, c_init, learn_phm, real_trafo,
            dropout=dropout_dn, same_dropout=same_dropout, generator=gen,
            shared_rule=unique_phm, dtype=dtype)
        self.set_node_axis(node_axis)
        self.set_composite(composite)
        self.set_edge_axis(edge_axis)
        self.to(dev)

    def set_node_axis(self, node_axis: Optional[str]) -> "PHCGNN":
        """Shard the nodes over the mesh axis ``node_axis`` ("ep"), or not
        (None), in place, as JAX's ``model.clone(node_axis=...)``: the norms
        of the message-passing layers take their statistics over the shards
        (``stat_axis``); the head's norms, on the replicated ``[G, d]``
        rows, do not.  A batch that carries ``halo_send``
        (``parallel.partition_nodes``) then runs the halo path in a step of
        ``parallel/halo.py``, which binds the axis."""
        self.node_axis = node_axis
        for i in range(self.num_layers):
            layers = [getattr(self, f"conv_{i}")]
            if self.has_norm:
                layers.append(getattr(self, f"norm_{i}"))
            for layer in layers:
                for m in layer.modules():
                    if hasattr(m, "stat_axis"):
                        m.stat_axis = node_axis
        return self

    def _convs(self):
        return [getattr(self, f"conv_{i}").conv
                for i in range(self.num_layers)]

    def set_edge_axis(self, edge_axis: Optional[str]) -> "PHCGNN":
        """Partition the edges over the mesh axis ``edge_axis`` ("ep"), or
        not (None), in place, as JAX's ``model.clone(edge_axis=...)``: every
        conv reduces its aggregations over the axis and takes the composite
        route, which it keeps while ``edge_axis`` is set.  A step of
        parallel/edge_partition.py binds the axis."""
        self.edge_axis = edge_axis
        for conv in self._convs():
            conv.edge_axis = edge_axis
        return self

    def set_composite(self, composite: bool) -> "PHCGNN":
        """Take the composite route (``agg_kernel="xla"``) or the plan
        route, in place.  Under ``edge_axis`` the convs take the composites
        either way."""
        self.composite = composite
        for conv in self._convs():
            conv.composite = composite
        return self

    def forward(self, graphs: GraphsTuple, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[G, target_dim] predictions; in training, ``generator`` draws the
        dropout masks and the batch-norm running stats are updated."""
        rule = self.phm_rule_shared
        if rule is not None and not self.learn_phm:
            rule = rule.detach()
        dtype = self.compute_dtype
        atom = self.atomencoder(graphs.nodes)
        atom = atom.reshape(atom.shape[0], -1)  # flat [N, n*d]
        if dtype is not None:
            atom = atom.to(dtype)
        x = atom
        remat = self.remat and torch.is_grad_enabled()
        halo = self.node_axis is not None and graphs.halo_send is not None
        ax = mesh.axis(self.node_axis) if halo else None
        # each node shard keeps its own rows' dropout masks from draws that
        # every shard makes alike, so the shards' generators stay in step
        # and a CUDA graph replays their draws (phc_gnn.py:210-218 folds the
        # shard into the key)
        node_block = (ax.index, ax.size) if halo else None
        for i in range(self.num_layers):
            skip = atom if (self.concat or self.sc_type == "first"
                            or i == 0) else x
            edge_emb = getattr(self, f"bondencoder_{i}")(graphs.edges)
            edge_emb = edge_emb.reshape(edge_emb.shape[0], -1)
            if dtype is not None:
                edge_emb = edge_emb.to(dtype)
            conv = getattr(self, f"conv_{i}")
            args = (x, graphs.senders, graphs.receivers, edge_emb,
                    graphs.edge_mask)
            kw = dict(training=training, node_mask=graphs.node_mask,
                      rowptr=graphs.rowptr, snd_perm=graphs.snd_perm,
                      snd_rowptr=graphs.snd_rowptr, phm_rule=rule)
            if halo:
                # the boundary rows of x that the other shards' edges read
                kw["x_remote"] = halo_exchange(x, graphs.halo_send, ax)
            if remat:
                h = checkpoint(conv, *args, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=_remat_contexts, **kw)
            else:
                h = conv(*args, **kw)
            if self.has_norm:
                h = getattr(self, f"norm_{i}")(h, training=training,
                                               mask=graphs.node_mask)
            h = phm_dropout(self.act(h), self.dropout_mpnn[i], self.phm_dim,
                            generator, training=training,
                            same=self.same_dropout, block=node_block)
            x = torch.cat([h, skip], dim=-1) if self.concat else h + skip
        pool_axis = self.node_axis if halo else None
        if isinstance(self.pooling, PHMGlobalSumPooling):
            pooled = self.pooling(x, graphs.graph_ids, graphs.num_graphs,
                                  graphs.node_mask, axis_name=pool_axis)
        else:
            pooled = self.pooling(x, graphs.graph_ids, graphs.num_graphs,
                                  graphs.node_mask, phm_rule=rule,
                                  axis_name=pool_axis)
        return self.downstream(pooled, training=training,
                               mask=graphs.graph_mask, generator=generator,
                               phm_rule=rule)
