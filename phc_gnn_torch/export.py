"""Export the flagship's eval forward with ``torch.export``: the port's
counterpart of ``scripts/export_model.py``, which serialises JAX's jitted
forward as StableHLO with ``jax.export``.

    python -m phc_gnn_torch.export [out.pt2] [--device cuda|cpu]

exports the forward of ``entry()``, writes the ``.pt2`` file and prints its
byte count, loads it back, calls it and prints the output's shape.  The
device is ``cuda`` unless ``--device cpu`` is given; without a card ``cuda``
raises.

The batch is taken apart at the boundary into plain tensors, as JAX's is
(export_model.py:30-40), in the order of ``ARG_NAMES``: the eight arrays of
a ``GraphsTuple`` and the receiver CSR ``rowptr`` of
``graph.attach_csr_plan``, the port's counterpart of the scan plan that
``__graft_entry__.entry()`` attaches on the TPU.  An eval forward reads
neither ``y`` nor the sender plan, so they are not arguments.  Shapes are
static: a program serves the one bucket it was exported at.

The kernels of the eval forward are ``torch.library`` ops
(``torch.ops.phc_gnn.*``, ``phc_gnn_torch/ops/``): the exported graph holds
them as calls, which launch the kernels on CUDA tensors and run their plain
versions on CPU tensors.  A batch without ``rowptr`` would export the plain
composites instead, so ``export_forward`` refuses it.

The artifact holds the weights: ``torch.export`` keeps the parameters and
buffers (the running statistics) in the program's state, where JAX's
artifact takes ``variables`` as an argument.  Loading it (``load``) needs
the op modules, which register the ``phc_gnn::`` ops, and nothing of
``phc_gnn_torch.models``: this module imports the models inside ``entry()``
only.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence, Union

import torch

from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.graph.batch import GraphsTuple
# the modules that register the phc_gnn:: ops an exported eval forward calls
from phc_gnn_torch.ops import (fused_whitening, segment_reduce,  # noqa: F401
                               segment_softmax, segment_sum)

__all__ = ["ARG_NAMES", "forward_args", "export_forward", "save", "load",
           "flagship_config", "entry", "main"]

ARG_NAMES = ("nodes", "edges", "senders", "receivers", "graph_ids",
             "node_mask", "edge_mask", "graph_mask", "rowptr")


class _EvalForward(torch.nn.Module):
    """``model(batch, training=False)`` over the batch's tensors in the
    order of ``ARG_NAMES``."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, nodes, edges, senders, receivers, graph_ids, node_mask,
                edge_mask, graph_mask, rowptr):
        batch = GraphsTuple(nodes=nodes, edges=edges, senders=senders,
                            receivers=receivers, graph_ids=graph_ids,
                            node_mask=node_mask, edge_mask=edge_mask,
                            graph_mask=graph_mask, rowptr=rowptr)
        return self.model(batch, training=False)


def forward_args(batch: GraphsTuple) -> tuple:
    """The tensors of ``batch`` that an exported forward takes, in the order
    of ``ARG_NAMES``; raises ``ValueError`` without the CSR plan."""
    if batch.rowptr is None:
        raise ValueError("the exported forward walks the receiver CSR with "
                         "the segment kernels: build the batch with "
                         "graph.attach_csr_plan")
    return tuple(getattr(batch, name) for name in ARG_NAMES)


def export_forward(model: torch.nn.Module, batch: GraphsTuple
                   ) -> torch.export.ExportedProgram:
    """``model(batch, training=False)`` exported under ``torch.no_grad()``
    with the model in eval mode, at ``batch``'s shapes (on the model's
    device); the program takes ``forward_args(batch)``."""
    from phc_gnn_torch.nn import IntegerEncoder

    args = forward_args(batch)
    model.eval()
    # the encoders make their index bounds on a device's first call and
    # keep them: made before the trace, the program holds them as
    # constants; made inside it, it would fill and stack them anew on
    # every call, two kernels an encoder
    for module in model.modules():
        if isinstance(module, IntegerEncoder):
            module.bounds(batch.nodes.device)
    with torch.no_grad():
        return torch.export.export(_EvalForward(model), args, strict=False)


def save(program: torch.export.ExportedProgram,
         path: Union[str, os.PathLike]) -> int:
    """Write ``program`` to ``path`` (``torch.export.save``); returns the
    file's byte count."""
    torch.export.save(program, path)
    return os.path.getsize(path)


def load(path: Union[str, os.PathLike]) -> torch.export.ExportedProgram:
    """The program saved at ``path`` (``torch.export.load``), its
    ``phc_gnn::`` ops registered by this module's imports; call it as
    ``program.module()(*forward_args(batch))``."""
    return torch.export.load(path)


def flagship_config(dim: int = 200, layers: int = 4,
                    dropout: bool = True) -> dict:
    """The flagship's ``PHCGNN`` arguments (bench.py:140-146,
    ``__graft_entry__._flagship``) at width ``dim`` with ``layers`` convs;
    with ``dropout=False`` every rate is 0."""
    from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS

    return dict(phm_dim=4, atom_input_dims=ZINC_ATOM_DIMS,
                bond_input_dims=ZINC_BOND_DIMS, atom_encoded_dim=dim,
                mp_layers=(dim,) * layers,
                dropout_mpnn=(0.1 if dropout else 0.0,) * layers,
                downstream_layers=(dim, dim // 2), target_dim=1,
                dropout_dn=(0.2, 0.1) if dropout else (0.0, 0.0),
                msg_aggr="softmax", mlp_mp=True, sc_type="last")


def entry(device: Union[str, torch.device] = "cuda"):
    """``(model, batch)`` of ``__graft_entry__.entry()``: the flagship at
    full width, its weights drawn from a ``torch.Generator`` seeded with 0
    (JAX's key 0 there), and ``synthetic_batch(64, 2048, 4096, seed=0)``
    with its CSR plan, both on ``device`` (default "cuda"; without CUDA
    this raises unless ``device="cpu"``)."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.models import PHCGNN

    dev = resolve_device(device)
    model = PHCGNN(**flagship_config(), seed=0, device=dev)
    batch = attach_csr_plan(synthetic_batch(64, 2048, 4096, seed=0))
    return model, batch.to(dev)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m phc_gnn_torch.export",
        description="Export the flagship's eval forward (torch.export), "
                    "write it, load it back and call it.")
    parser.add_argument("out", nargs="?",
                        default=os.path.join(tempfile.gettempdir(),
                                             "phc_gnn_fwd.pt2"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    model, batch = entry(args.device)
    nbytes = save(export_forward(model, batch), args.out)
    print(f"wrote {args.out}: {nbytes} bytes")
    with torch.inference_mode():
        out = load(args.out).module()(*forward_args(batch))
    print("round-trip call ok:", tuple(out.shape))


if __name__ == "__main__":
    main()
