"""End-to-end PHC-GNN, add-skip family.

Counterpart of phc_gnn_tpu/models/phc_gnn.py:182-266 for
``skip_connect="add"``: atom-encode -> flatten [N, n*d] -> L x (bond-encode,
conv, norm, act, add-skip) -> pool -> downstream head.  ``sc_type`` selects
the skip source: "first" = the initial embedding, "last" = the previous
layer's output.  Module names follow the flax tree (``atomencoder``,
``bondencoder_<i>``, ``conv_<i>``, ``norm_<i>``, ``pooling``,
``downstream``), so ``convert.from_flax_variables`` maps paths one to one.

The model is initialised from ``seed`` on a CPU ``torch.Generator`` and then
moved to ``device`` (default "cuda"; without CUDA it raises unless
``device="cpu"``).  Eval mode only in this slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from phc_gnn_torch.data.features import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS
from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.graph.batch import GraphsTuple
from phc_gnn_torch.graph.conv import PHMMessagePassing
from phc_gnn_torch.graph.pooling import PHMGlobalSumPooling, PHMSoftAttentionPooling
from phc_gnn_torch.nn.activations import get_activation
from phc_gnn_torch.nn.downstream import PHMDownstreamNet
from phc_gnn_torch.nn.encoder import PHMEncoder
from phc_gnn_torch.nn.norm import PHMNorm

__all__ = ["PHCGNN"]


class PHCGNN(nn.Module):
    """Generic PHC-GNN for graph-level prediction on padded batches; the
    arguments and their defaults are those of the flax module."""

    def __init__(self, phm_dim: int = 4, learn_phm: bool = True,
                 unique_phm: bool = False,
                 atom_input_dims: Union[int, Sequence[int]] = tuple(ATOM_FEATURE_DIMS),
                 atom_encoded_dim: int = 196,
                 bond_input_dims: Union[int, Sequence[int]] = tuple(BOND_FEATURE_DIMS),
                 naive_encoder: bool = False, w_init: str = "phm",
                 c_init: str = "standard",
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
                 remat: bool = False, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        if skip_connect != "add":
            raise NotImplementedError(
                "the concat-skip family is not ported yet "
                "(ROADMAP.md, section 1, item 10)")
        if edge_axis is not None or node_axis is not None:
            raise NotImplementedError(
                "edge partitioning and the node-sharded halo path are not "
                "ported yet (ROADMAP.md, section 1, item 14)")
        if compute_dtype is not None or remat:
            raise NotImplementedError(
                "compute_dtype and remat are not ported yet "
                "(ROADMAP.md, section 1, item 11)")
        if unique_phm or naive_encoder:
            raise NotImplementedError(
                "unique_phm and naive_encoder are not ported yet: they come "
                "with the model presets (ROADMAP.md, section 1, item 7)")
        if sc_type not in ("first", "last"):
            raise ValueError(f"sc_type must be 'first' or 'last', got {sc_type!r}")
        if pooling not in ("globalsum", "softattention"):
            raise ValueError(f"unknown pooling {pooling!r}")
        if not all(d == atom_encoded_dim for d in mp_layers):
            raise ValueError("the add-skip model needs equal dims "
                             "(reference models.py:46)")
        if len(dropout_mpnn) != len(mp_layers):
            raise ValueError("dropout_mpnn needs one rate per layer")
        n = phm_dim
        gen = torch.Generator().manual_seed(seed)
        self.phm_dim = n
        self.sc_type = sc_type
        self.num_layers = len(mp_layers)
        self.act = get_activation(activation)
        embed = atom_encoded_dim

        self.atomencoder = PHMEncoder(embed // n, atom_input_dims, n, gen)
        for i, d in enumerate(mp_layers):
            self.add_module(f"bondencoder_{i}", PHMEncoder(
                d // n, bond_input_dims, n, gen))
            self.add_module(f"conv_{i}", PHMMessagePassing(
                embed, d, n, learn_phm, bias, add_self_loops, norm_mp,
                activation, w_init, c_init, aggr=msg_aggr, mlp=mlp_mp,
                msg_encoder=msg_encoder, initial_beta=initial_beta,
                learn_beta=learn_beta, generator=gen))
            if norm_mp not in (None, "None"):
                self.add_module(f"norm_{i}", PHMNorm(d, n, norm_mp))
        self.has_norm = norm_mp not in (None, "None")

        final_dim = mp_layers[-1]
        if pooling == "globalsum":
            self.pooling = PHMGlobalSumPooling(n)
        else:
            self.pooling = PHMSoftAttentionPooling(
                final_dim, n, learn_phm, bias, w_init, c_init, real_trafo,
                generator=gen)
        self.downstream = PHMDownstreamNet(
            final_dim, tuple(downstream_layers), target_dim, n, activation,
            bias, norm_dn, w_init, c_init, learn_phm, real_trafo,
            generator=gen)
        self.to(dev)

    def forward(self, graphs: GraphsTuple, training: bool = False) -> torch.Tensor:
        if training:
            raise NotImplementedError(
                "the training forward is not ported yet: it is the next slice "
                "(ROADMAP.md, section 1, items 6-8)")
        atom = self.atomencoder(graphs.nodes)
        atom = atom.reshape(atom.shape[0], -1)  # flat [N, n*d]
        x = atom
        for i in range(self.num_layers):
            skip = atom if (self.sc_type == "first" or i == 0) else x
            edge_emb = getattr(self, f"bondencoder_{i}")(graphs.edges)
            edge_emb = edge_emb.reshape(edge_emb.shape[0], -1)
            h = getattr(self, f"conv_{i}")(
                x, graphs.senders, graphs.receivers, edge_emb,
                graphs.edge_mask, training=False,
                node_mask=graphs.node_mask, rowptr=graphs.rowptr)
            if self.has_norm:
                h = getattr(self, f"norm_{i}")(h, training=False,
                                               mask=graphs.node_mask)
            x = self.act(h) + skip
        pooled = self.pooling(x, graphs.graph_ids, graphs.num_graphs,
                              graphs.node_mask)
        return self.downstream(pooled, training=False, mask=graphs.graph_mask)
