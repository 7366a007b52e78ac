"""Where the flagship train step's time goes: the counterpart of
scripts/bench_ablation.py.

    python -m phc_gnn_torch.cli.ablation [main|buckets|all] [--device cuda|cpu]

Each variant of ``VARIANTS`` (the script's :79-100, names and overrides
letter for letter) is the flagship of ``phc_gnn_torch.bench`` with some of
its ``PHCGNN`` arguments replaced, trained as the flagship trains (masked
L1, weight decay 0.1, clip 2.0, Adam at lr 1e-3) on
``synthetic_batch(128 * s, 4096 * s, 8192 * s, seed=0)`` for its batch
scale ``s``, on one of two routes:

- ``plan``: the batch with its CSR plans (``graph.attach_csr_plan``), the
  aggregations on the port's kernels, as the script's ``scan=True`` runs
  the streamed Pallas kernels;
- ``xla``: ``PHCGNN(composite=True)`` on the batch without plans, the
  composites of ``graph/aggregators.py``: the port's ``agg_kernel="xla"``,
  as the script's ``scan=False`` runs XLA's.

A variant that changes the conv count (``mp_layers``) resizes
``dropout_mpnn`` to match (:52-53); each conv keeps the run's width.
``model_kwargs`` gives a variant's arguments (JAX's ``PHCGNN`` takes the
same), ``step_launches`` the port's kernel launches one train step implies,
as the wrappers' ``.launches`` counters read them: the fused softmax and
its backward a softmax conv, C's masked role a sum conv, C's gather
backward a conv on the plan route, none of these on the composite route,
and each batch norm (two a conv with its MLP, one without, one a hidden
layer of the head) on D and E, or on F and G where its input passes
``ops.fused_bn.FUSED_BN_VMEM_LIMIT`` (the conv norms of the 4x bucket).

Each variant's step is the graphed one (``make_scan_train_steps``), its
ms the slope of the host clock between 5 and 55 steps, each count the
least of 3 timed runs (:24-30, ``scaling.graphed_slope``).  One JSON line
a variant, ``{"variant", "ms", "steps_per_s"}`` with the card's name and
power limit; after ``main`` the derived line ``{"derived": "per_conv_ms",
"ms", "fixed_ms"}``: the conv's cost ``(t8 - t2) / 6`` from ``layers_8``
and ``layers_2``, and the rest of the baseline, ``t_base - 4 *
per_conv`` (:90-94).  ``run(which, device, dim, shrink, ...)`` takes the
width and divides the buckets, so a test can run it small on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
from typing import Dict, NamedTuple, Optional, Sequence, Union

import torch

from phc_gnn_torch import bench
from phc_gnn_torch.cli.scaling import graphed_slope
from phc_gnn_torch.data import synthetic_batch
from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.graph import GraphsTuple, attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.ops import fused_bn

__all__ = ["Variant", "VARIANTS", "MAIN", "BUCKETS", "DIM", "LAYERS",
           "BASE_BUCKET", "K1", "K2", "model_kwargs", "build", "batch",
           "bucket", "step_launches", "variant_launches", "run", "main"]

DIM = 200
LAYERS = 4
BASE_BUCKET = (128, 4096, 8192)  # graphs, nodes, edges at batch scale 1
K1, K2 = 5, 55                   # the script's slope (:24)


class Variant(NamedTuple):
    """A variant's ``PHCGNN`` overrides, its batch scale and its route
    ("plan": the CSR plans and the port's kernels; "xla": the
    composites)."""
    overrides: dict
    batch_scale: int = 1
    route: str = "plan"


VARIANTS: Dict[str, Variant] = {
    "baseline_softmax_scan": Variant({}),
    "baseline_softmax_xla": Variant({}, route="xla"),
    "sum_aggr_scan": Variant({"msg_aggr": "sum"}),
    "no_norm": Variant({"norm_mp": None, "norm_dn": None}),
    "no_dropout": Variant({"dropout_mpnn": (0.0,) * 4,
                           "dropout_dn": (0.0, 0.0)}),
    "no_pool_attn": Variant({"pooling": "globalsum"}),
    "no_mlp_mp": Variant({"mlp_mp": False}),
    "layers_2": Variant({"mp_layers": (200,) * 2}),
    "layers_8": Variant({"mp_layers": (200,) * 8}),
    "4x_bucket_scan": Variant({}, 4),
    "4x_bucket_xla": Variant({}, 4, "xla"),
    "4x_bucket_sum": Variant({"msg_aggr": "sum"}, 4),
    "4x_bucket_no_norm": Variant({"norm_mp": None, "norm_dn": None}, 4),
}
MAIN = tuple(VARIANTS)[:9]
BUCKETS = tuple(VARIANTS)[9:]


def model_kwargs(name: str, dim: int = DIM, layers: int = LAYERS,
                 dropout: bool = True) -> dict:
    """The ``PHCGNN`` arguments of variant ``name``: the flagship's
    (``bench.flagship_kwargs``) at width ``dim`` with ``layers`` convs, then
    the variant's overrides; an ``mp_layers`` override sets the conv count
    (each conv at ``dim``) and ``dropout_mpnn`` with it.  With
    ``dropout=False`` every rate is 0."""
    over = dict(VARIANTS[name].overrides)
    if "mp_layers" in over:
        layers = len(over.pop("mp_layers"))
    if "dropout_mpnn" in over:  # one rate for every conv
        over["dropout_mpnn"] = over["dropout_mpnn"][:1] * layers
    kwargs = bench.flagship_kwargs(dim, layers, dropout=dropout, **over)
    if not dropout:
        kwargs.update(dropout_mpnn=(0.0,) * layers, dropout_dn=(0.0, 0.0))
    return kwargs


def build(name: str, dev: Union[str, torch.device], dim: int = DIM,
          layers: int = LAYERS, dropout: bool = True) -> PHCGNN:
    """Variant ``name``'s model from seed 0 on ``dev``, on its route."""
    return PHCGNN(**model_kwargs(name, dim, layers, dropout),
                  composite=VARIANTS[name].route == "xla", seed=0,
                  device=dev)


def bucket(name: str, shrink: int = 1) -> tuple:
    """(graphs, nodes, edges) of variant ``name``'s batch, divided by
    ``shrink``."""
    scale = VARIANTS[name].batch_scale
    return tuple(n * scale // shrink for n in BASE_BUCKET)


def batch(name: str, shrink: int = 1) -> GraphsTuple:
    """Variant ``name``'s batch on the CPU, with its CSR plans on the plan
    route and without them on the composite route."""
    out = synthetic_batch(*bucket(name, shrink), seed=0)
    return attach_csr_plan(out) if VARIANTS[name].route == "plan" else out


def step_launches(kwargs: dict, route: str, nodes: int,
                  graphs: int) -> Dict[str, int]:
    """The port's kernel launches one train step of ``PHCGNN(**kwargs)``
    implies on ``route`` over a batch of ``nodes`` nodes and ``graphs``
    graphs (padding included), by wrapper name, as the wrappers' counters
    read them (kernels with no launch left out)."""
    layers = len(kwargs["mp_layers"])
    out: Dict[str, int] = collections.Counter()
    if route == "plan":
        if kwargs["msg_aggr"] == "softmax":
            out["segment_softmax_fused"] += layers
            out["segment_softmax_backward"] += layers
        else:
            out["segment_sum_masked"] += layers
        out["segment_sum_perm"] += layers  # the message gather's backward
    shapes = []
    if kwargs.get("norm_mp", "naive-batch-norm") not in (None, "None"):
        per_conv = 2 if kwargs["mlp_mp"] else 1  # the MLP's, the layer's
        shapes += [(nodes, d) for d in kwargs["mp_layers"]] * per_conv
    if kwargs.get("norm_dn", "naive-batch-norm") not in (None, "None"):
        shapes += [(graphs, d) for d in kwargs["downstream_layers"]]
    for n, d in shapes:
        blocked = ("_blocked" if n * d * 4 > fused_bn.FUSED_BN_VMEM_LIMIT
                   else "")
        out[f"bn_forward{blocked}"] += 1
        out[f"bn_backward{blocked}"] += 1
    return dict(out)


def variant_launches(name: str, dim: int = DIM, layers: int = LAYERS,
                     shrink: int = 1) -> Dict[str, int]:
    """``step_launches`` of variant ``name`` on its own route and batch
    (``synthetic_batch`` pads ``graphs + 1`` graphs)."""
    size, nodes, _ = bucket(name, shrink)
    return step_launches(model_kwargs(name, dim, layers), VARIANTS[name].route,
                         nodes, size + 1)


def run(which: str = "all", device: Union[str, torch.device] = "cuda",
        dim: Optional[int] = None, shrink: int = 1, k1: int = K1,
        k2: int = K2, reps: int = 3) -> list:
    """The lines of ``which`` ("main", "buckets" or "all"), each printed as
    it is measured, on ``device`` (default "cuda"; without CUDA it raises
    unless ``device="cpu"``), the variants at width ``dim`` (200) on their
    buckets divided by ``shrink``."""
    if which not in ("main", "buckets", "all"):
        raise ValueError(f"unknown ablation group {which!r}: main, buckets "
                         f"or all")
    dev = resolve_device(device)
    dim = dim or DIM
    card = bench.host_card(dev)
    names = {"main": MAIN, "buckets": BUCKETS, "all": MAIN + BUCKETS}[which]
    lines, ms = [], {}
    for name in names:
        t = graphed_slope(build(name, dev, dim), batch(name, shrink), dev, k1,
                          k2, reps)
        ms[name] = t * 1e3
        line = {"variant": name, "ms": t * 1e3, "steps_per_s": 1.0 / t,
                **card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        if name == MAIN[-1]:
            per_conv = (ms["layers_8"] - ms["layers_2"]) / 6
            line = {"derived": "per_conv_ms", "ms": per_conv,
                    "fixed_ms": (ms["baseline_softmax_scan"]
                                 - LAYERS * per_conv),
                    **card}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Time the flagship's graphed train step with each of its "
                    "parts varied: one JSON line a variant.")
    parser.add_argument("which", nargs="?", default="all",
                        choices=("main", "buckets", "all"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(args.which, args.device)


if __name__ == "__main__":
    main()
