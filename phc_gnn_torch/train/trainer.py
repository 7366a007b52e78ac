"""Model and loss from an experiment configuration, and the grouping of
batches into scanned chunks.

Counterparts of ``build_model``, ``build_loss`` and ``iter_scan_chunks`` in
phc_gnn_tpu/train/trainer.py:47-98, so that a configuration builds the
port's model by name as the CLI builds the JAX one, and a loader's batches
go to ``make_scan_train_steps`` and ``make_scan_eval_steps`` as JAX's
trainer sends them.  The rest of the trainer (epoch loops, evaluation,
checkpoints) waits for ROADMAP.md, section 1, items 4 and 5.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from phc_gnn_torch.models.phc_gnn import PHCGNN
from phc_gnn_torch.train.config import ExperimentConfig
from phc_gnn_torch.train.loss import (
    masked_bce_with_logits,
    masked_cross_entropy,
    masked_l1,
    masked_mse,
)

__all__ = ["build_model", "build_loss", "iter_scan_chunks"]


def build_model(cfg: ExperimentConfig, atom_input_dims, bond_input_dims,
                avg_deg: Optional[Dict[str, float]] = None, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> PHCGNN:
    """``PHCGNN`` from ``cfg`` (reference main():566-579), its weights drawn
    from ``seed`` and moved to ``device``.  A length-1 ``dropout_mpnn``
    broadcasts over all message-passing layers.  ``avg_deg`` is the PNA
    conv's degree statistics (``cfg.aggr_msg == "pna"``), which the CLI
    takes from the training split's in-degree histogram
    (``data.datasets.avg_deg_from_histogram(degree_histogram(graphs))``).
    ``cfg.aggr_node`` is not read, as in JAX."""
    dropout_mpnn = tuple(cfg.dropout_mpnn)
    if len(dropout_mpnn) == 1 and len(cfg.mp_units) > 1:
        dropout_mpnn = dropout_mpnn * len(cfg.mp_units)
    return PHCGNN(
        phm_dim=cfg.phm_dim, learn_phm=cfg.learn_phm, unique_phm=cfg.unique_phm,
        atom_input_dims=atom_input_dims, atom_encoded_dim=cfg.input_embed_dim,
        bond_input_dims=bond_input_dims, naive_encoder=cfg.naive_encoder,
        w_init=cfg.w_init, c_init=cfg.c_init, same_dropout=cfg.same_dropout,
        mp_layers=tuple(cfg.mp_units), bias=True,
        dropout_mpnn=dropout_mpnn, norm_mp=cfg.norm_mp,
        add_self_loops=True, msg_aggr=cfg.aggr_msg,
        mlp_mp=cfg.mlp_mp, pooling=cfg.pooling, activation=cfg.activation,
        real_trafo=cfg.real_trafo, downstream_layers=tuple(cfg.d_units),
        target_dim=cfg.target_dim, dropout_dn=tuple(cfg.dropout_dn),
        norm_dn=cfg.norm_dn, msg_encoder=cfg.msg_encoder, sc_type=cfg.sc_type,
        skip_connect=cfg.model_type, initial_beta=cfg.initial_beta,
        learn_beta=cfg.learn_beta, avg_deg=avg_deg,
        compute_dtype=(torch.bfloat16
                       if str(getattr(cfg, "compute_dtype", "f32")) == "bf16"
                       else None),
        seed=seed, device=device)


def build_loss(cfg: ExperimentConfig) -> Callable:
    """``loss_fn(out, batch)`` for ``cfg.loss`` in bce | l1 | mse | ce."""
    if cfg.loss == "bce":
        return lambda out, batch: masked_bce_with_logits(out, batch.y)
    if cfg.loss == "l1":
        return lambda out, batch: masked_l1(out, batch.y)
    if cfg.loss == "mse":
        return lambda out, batch: masked_mse(out, batch.y)
    if cfg.loss == "ce":
        return lambda out, batch: masked_cross_entropy(
            out, batch.y[:, 0].to(torch.int32), batch.graph_mask)
    raise ValueError(f"unknown loss {cfg.loss!r}")


def iter_scan_chunks(batches, chunk_size: int):
    """Group an iterable of GraphsTuples into same-shape chunks of at most
    ``chunk_size``: consecutive batches of one ``(num_nodes, num_edges,
    num_graphs)`` bucket, a new chunk at each change of bucket (shared by the
    scanned train and eval loops)."""
    chunk, shape_key = [], None
    for batch in batches:
        key = (batch.num_nodes, batch.num_edges, batch.num_graphs)
        if chunk and (key != shape_key or len(chunk) >= chunk_size):
            yield chunk
            chunk = []
        shape_key = key
        chunk.append(batch)
    if chunk:
        yield chunk
