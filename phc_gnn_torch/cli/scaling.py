"""The flagship's train step over bucket sizes: the counterpart of
scripts/bench_scaling.py.

    python -m phc_gnn_torch.cli.scaling [--device cuda|cpu]

The model is the flagship of ``phc_gnn_torch.bench`` (bench.py:140-146:
``phm_dim=4``, ZINC encoders, width 200, 4 x ``PHMGINEConvSoftmax`` with its
MLP, dropout 0.1 / (0.2, 0.1), ``sc_type="last"``, a (200, 100) -> 1 head),
trained with masked L1, weight decay 0.1, a global-norm clip of 2.0 and
Adam at lr 1e-3.  For each bucket of ``BUCKETS`` (the script's :47-50), a
fresh model and optimizer from seed 0, and ``synthetic_batch(graphs,
nodes, edges, seed=0)`` with its CSR plans.  From the 2x bucket on, a conv
norm's input passes ``ops.fused_bn.FUSED_BN_VMEM_LIMIT`` and the norms run
the row-blocked kernels F and G.

The step is the graphed one users train with (``make_scan_train_steps``:
one CUDA graph a bucket shape, the batch copied in and the graph replayed a
step).  Its ms is the slope of the host clock, around a final
``torch.cuda.synchronize``, between ``max(n2 // 10, 3)`` and ``n2`` steps,
each count run once to warm up and then the least of 3 timed runs, as the
script's ``slope`` (:24-30) times its ``lax.scan``.

One JSON line a bucket with the script's keys (``batch_size``, ``nodes``,
``edges``, ``ms``, ``real_edges``, ``edges_per_s``,
``edges_per_s_padded``), ``roofline_fraction`` (``bench._roofline_ms`` at
the bucket's shape over ``ms``) and the card's name and power limit.
``run(device, dim, layers, buckets)`` takes the widths and buckets, so a
test can run it small on the CPU, where it times the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence, Tuple, Union

import torch

from phc_gnn_torch import bench
from phc_gnn_torch.data import synthetic_batch
from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.graph import GraphsTuple, attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.train import make_optimizer, make_scan_train_steps

__all__ = ["BUCKETS", "REPS", "graphed_slope", "run", "main"]

# (graphs, nodes, edges, n2): scripts/bench_scaling.py:47-50
BUCKETS = ((128, 4096, 8192, 110),
           (256, 8192, 16384, 60),
           (512, 16384, 32768, 40),
           (1024, 32768, 65536, 25))
REPS = 3  # timed runs a step count, the least taken (the script's slope)


def graphed_slope(model: PHCGNN, batch: GraphsTuple, dev: torch.device,
                  k1: int, k2: int, reps: int = REPS) -> float:
    """Seconds a graphed train step of ``model`` on ``batch``, the
    flagship's training setup: the slope between ``k1`` and ``k2`` steps
    (``bench._slope``).  On the CPU the steps run eagerly."""
    opt = make_optimizer(dict(model.named_parameters()),
                         grad_clip=bench.GRAD_CLIP)
    steps = make_scan_train_steps(model, opt, bench._l1,
                                  weight_decay=bench.WEIGHT_DECAY, seed=0,
                                  device=dev)
    on_dev = batch.to(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    per_step, _ = bench._slope(lambda k: steps([on_dev] * k, bench.LR), k1,
                               k2, sync, reps)
    return per_step


def run(device: Union[str, torch.device] = "cuda", dim: Optional[int] = None,
        layers: Optional[int] = None,
        buckets: Optional[Sequence[Tuple[int, int, int, int]]] = None
        ) -> list:
    """One line a bucket, each printed as it is measured, on ``device``
    (default "cuda"; without CUDA it raises unless ``device="cpu"``), the
    flagship at width ``dim`` (200) with ``layers`` convs (4) over
    ``buckets`` (``BUCKETS``: graphs, nodes, edges, n2)."""
    dev = resolve_device(device)
    dim, layers = dim or 200, layers or 4
    card = bench.host_card(dev)
    lines = []
    for size, nodes, edges, n2 in buckets or BUCKETS:
        batch = attach_csr_plan(synthetic_batch(size, nodes, edges, seed=0))
        model = PHCGNN(**bench.flagship_kwargs(dim, layers), seed=0,
                       device=dev)
        t = graphed_slope(model, batch, dev, max(n2 // 10, 3), n2)
        real_edges = batch.count_edges()
        line = {"batch_size": size, "nodes": nodes, "edges": edges,
                "ms": t * 1e3, "real_edges": real_edges,
                "edges_per_s": real_edges / t,
                "edges_per_s_padded": edges / t,
                "roofline_fraction": bench._roofline_ms(
                    dim, layers, nodes, edges) / (t * 1e3),
                **card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del model
    return lines


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Time the flagship's graphed train step at the 1x-8x "
                    "buckets: one JSON line a bucket.")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(args.device)


if __name__ == "__main__":
    main()
