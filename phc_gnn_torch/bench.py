"""Throughput of the port's train steps and eval forwards on one GPU, for the
JAX package's bench configurations.

    python -m phc_gnn_torch.bench                      # the flagship
    python -m phc_gnn_torch.bench --config pcba --config concat
    python -m phc_gnn_torch.bench --config all

One JSON line a configuration, each at its published widths, uncut:

- ``flagship``: ``inner()`` of the JAX package's bench.py (:140-291):
  ``phm_dim=4``, ZINC encoders, width 200, 4 x ``PHMGINEConvSoftmax`` with
  its MLP, dropout 0.1 / (0.2, 0.1), ``sc_type="last"``, a (200, 100) -> 1
  head, masked L1, weight decay 0.1, a global-norm clip of 2.0, Adam at lr
  1e-3, on ``synthetic_batch(128, 4096, 8192, seed=0)`` with its CSR plans;
- ``flagship-bf16``: the flagship with ``compute_dtype=torch.bfloat16``
  (parameters and Adam float32, activations bf16, the aggregation kernels
  fed bf16 messages), as scripts/bench_bf16_streams.py times JAX's;
- ``concat`` and ``quat-wbn``: ``build("concat", "naive-batch-norm")`` and
  ``build("add", "q-batch-norm")`` of scripts/bench_presets.py:29-47 (the
  concat skip with ``sc_type="first"``; the quaternion whitening at the 8
  conv sites), the flagship's training setup and batch;
- ``pna``: benchmarks/run_script_zinc_phm4.sh with ``--aggr_msg pna`` over
  ``DATASET_DEFAULTS["zinc"]`` (mean, min, max, std; three scalers; L1, no
  weight decay), its ``avg_deg`` from the degree histogram of the batch's
  128 graphs, on the flagship's batch;
- ``pcba``: benchmarks/run_script_pcba_phm2.sh over
  ``DATASET_DEFAULTS["pcba"]`` (``phm_dim=2``, 7 x ``PHMConv`` with sum
  aggregation at width 512, ``sc_type="first"``, a (768, 256) -> 128 head,
  masked BCE, dropout 0.3 / (0.4, 0.2), lr 1e-3), recipe C of
  scripts/bench_pcba_recipe.py: the accumulated step over K = 4
  sub-batches ``synthetic_batch(128, 4096, 8192, seed=0..3)`` (9 atom, 3
  bond features, 0/1 labels of 128 tasks, ~40 % missing), one call a
  logical 512-graph batch; eval on ``synthetic_batch(512, 16384, 32768)``
  (the script's ``--eval_batch_size 512``);
- ``pcba-16k`` (recipe A): the same model trained on one 16384n/32768e
  bucket of 512 graphs by the scanned step; no eval;
- ``pcba-k2`` (recipe B): the accumulated step over K = 2 sub-batches of
  256 graphs in 8192n/16384e buckets; no eval.

The pcba configurations take the run script's weight decay, 0.0, and its lr
(scripts/bench_pcba_recipe.py uses 1e-4 and 5e-4).

Step ms is the slope between 10 and 110 calls, each count run once to warm
up and once timed, with the host clock around the calls and a final
``torch.cuda.synchronize``, as bench.py times its ``lax.scan``: the
scanned configurations through ``make_scan_train_steps`` (one CUDA graph
replayed a step), the accumulated ones through ``make_accum_train_step``
(one CUDA graph replayed a call); eval ms likewise through
``make_scan_eval_steps``.  ``eager_step_ms`` and ``eager_eval_ms`` are the
same slopes over ``make_train_step`` (or the accumulated step's eager body)
and ``make_eval_step``.  ``value`` is the real edges of a train call over
step ms; ``peak_mem_bytes`` the most device memory the configuration's run
held at once (``torch.cuda.max_memory_allocated``: the graphs' pools and the
eager steps').  Only the flagship's line carries ``roofline_fraction``:
bench.py's FLOP and byte counts are the flagship's (:258-262), and no count
for the others is defined.  Each line names the card and its power limit
(nvidia-smi).

``run(config, device, ...)`` takes the widths, so a test can run every
configuration small on the CPU; a CPU run times the CPU, not a device.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from phc_gnn_torch.data import (ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS,
                                ZINC_ATOM_DIMS, ZINC_BOND_DIMS,
                                avg_deg_from_histogram, degree_histogram,
                                synthetic_batch, synthetic_graphs)
from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.export import flagship_config
from phc_gnn_torch.graph import GraphsTuple, attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.train import (make_accum_train_step, make_eval_step,
                                 make_optimizer, make_scan_eval_steps,
                                 make_scan_train_steps, make_train_step,
                                 masked_l1)
from phc_gnn_torch.train.config import DATASET_DEFAULTS, ExperimentConfig
from phc_gnn_torch.train.state import _eager_accum_train_step
from phc_gnn_torch.train.trainer import build_loss, build_model

__all__ = ["CONFIGS", "flagship_kwargs", "run", "card", "host_card", "main"]

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit: float32
# outside the tensor cores (TF32 is off in the port, so no tensor-core peak
# applies to its GEMMs) and the HBM3 rate
H100_FP32_FLOP_PER_S = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
# bench.py's training setup: masked L1, weight decay, global-norm clip, lr
WEIGHT_DECAY = 0.1
GRAD_CLIP = 2.0
LR = 1e-3
# the flagship's bucket (bench.py:148-149)
FLAGSHIP_BATCH = (128, 4096, 8192)
PCBA_FEATS = dict(num_node_feats=9, num_edge_feats=3, target_dim=128)


class Setup(NamedTuple):
    """What a configuration trains and serves: the model, its loss and
    training setup, the batches of one train call (one for a scanned step,
    K for an accumulated one) and the eval batch (None: no eval)."""
    model: nn.Module
    loss_fn: Callable
    loss_name: str
    weight_decay: float
    lr: float
    grad_clip: float
    train: List[GraphsTuple]
    accumulate: bool
    eval: Optional[GraphsTuple]
    description: str


class Widths(NamedTuple):
    """A configuration's widths and batch scale: ``shrink`` divides every
    batch's graphs, nodes and edges (1 at the published size)."""
    dim: int
    layers: int
    head: Sequence[int]
    shrink: int


def _batch(size, nodes, edges, w: Widths, seed: int = 0, **feats):
    return attach_csr_plan(synthetic_batch(
        size // w.shrink, nodes // w.shrink, edges // w.shrink, seed=seed,
        **feats))


def _pcba_labels(batch: GraphsTuple, seed: int) -> GraphsTuple:
    """0/1 labels of the 128 tasks, ~40 % of them missing (NaN) as molpcba's
    are, NaN on the padding graphs; drawn with numpy from ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    y = (rng.random(tuple(batch.y.shape)) < 0.3).astype(np.float32)
    y[rng.random(y.shape) < 0.4] = np.nan
    y[~batch.graph_mask.numpy()] = np.nan
    return batch.replace(y=torch.from_numpy(y))


def _l1(out, b):
    return masked_l1(out, b.y)


def flagship_kwargs(dim: int = 200, layers: int = 4,
                    head: Optional[Sequence[int]] = None,
                    dropout: bool = True, **overrides) -> dict:
    """The flagship's ``PHCGNN`` arguments (bench.py:140-146) at width
    ``dim`` with ``layers`` convs and the head ``head`` (``(dim, dim //
    2)``, the published (200, 100), without it); with ``dropout=False``
    every rate is 0; then ``overrides`` replace any of them."""
    kwargs = flagship_config(dim, layers, dropout)
    if head is not None:
        kwargs["downstream_layers"] = tuple(head)
    kwargs.update(overrides)
    return kwargs


def _preset(skip: str, norm: str, description: str,
            compute_dtype: Optional[torch.dtype] = None):
    """scripts/bench_presets.py's ``build(sc, norm)`` (``add`` with
    naive-batch-norm is the flagship), in ``compute_dtype``."""
    def build(w: Widths, dev) -> Setup:
        model = PHCGNN(**flagship_kwargs(
            w.dim, w.layers, w.head,
            sc_type="last" if skip == "add" else "first", skip_connect=skip,
            norm_mp=norm, norm_dn="naive-batch-norm",
            compute_dtype=compute_dtype), seed=0, device=dev)
        batch = _batch(*FLAGSHIP_BATCH, w)
        return Setup(model, _l1, "l1", WEIGHT_DECAY, LR, GRAD_CLIP, [batch],
                     False, batch, description)
    return build


def _pna(w: Widths, dev) -> Setup:
    """run_script_zinc_phm4.sh --aggr_msg pna over DATASET_DEFAULTS["zinc"]."""
    cfg = ExperimentConfig(**{
        **DATASET_DEFAULTS["zinc"], "dataset": "zinc", "phm_dim": 4,
        "model_type": "add", "sc_type": "last", "aggr_msg": "pna",
        "mlp_mp": True, "input_embed_dim": w.dim,
        "mp_units": (w.dim,) * w.layers, "d_units": tuple(w.head),
        "dropout_mpnn": (0.0,) * w.layers, "dropout_dn": (0.2, 0.1),
        "batch_size": 128, "lr": 1e-3, "patience": 20, "factor": 0.5,
        "min_lr": 1e-7, "epochs": 1000, "weightdecay": 0.0})
    size = FLAGSHIP_BATCH[0] // w.shrink
    avg_deg = avg_deg_from_histogram(degree_histogram(
        synthetic_graphs(size, seed=0)))
    model = build_model(cfg, ZINC_ATOM_DIMS, ZINC_BOND_DIMS, avg_deg=avg_deg,
                        seed=0, device=dev)
    batch = _batch(*FLAGSHIP_BATCH, w)
    return Setup(model, build_loss(cfg), cfg.loss, cfg.weightdecay, cfg.lr,
                 cfg.grad_clipping, [batch], False, batch,
                 "PHC-GNN n=4 PNA train step, ZINC config")


def _pcba(k: int, size: int, nodes: int, edges: int, serve: bool,
          description: str):
    """run_script_pcba_phm2.sh over DATASET_DEFAULTS["pcba"], its logical
    512-graph batch as ``k`` sub-batches of ``size`` graphs (k = 1: the
    scanned step), with the 512-graph eval batch if ``serve``."""
    def build(w: Widths, dev) -> Setup:
        cfg = ExperimentConfig(**{
            **DATASET_DEFAULTS["pcba"], "dataset": "pcba", "phm_dim": 2,
            "model_type": "add", "aggr_msg": "sum", "mlp_mp": False,
            "input_embed_dim": w.dim, "mp_units": (w.dim,) * w.layers,
            "d_units": tuple(w.head), "dropout_mpnn": (0.3,) * w.layers,
            "dropout_dn": (0.4, 0.2), "batch_size": 128, "grad_accum": 4,
            "max_nodes": 4096, "max_edges": 8192, "eval_batch_size": 512,
            "lr": 1e-3, "patience": 5, "factor": 0.75, "epochs": 150,
            "weightdecay": 0.0})
        model = build_model(cfg, ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS,
                            seed=0, device=dev)
        train = [_pcba_labels(_batch(size, nodes, edges, w, seed=s,
                                     **PCBA_FEATS), s) for s in range(k)]
        held = (_pcba_labels(_batch(512, 16384, 32768, w, **PCBA_FEATS), 0)
                if serve else None)
        return Setup(model, build_loss(cfg), cfg.loss, cfg.weightdecay,
                     cfg.lr, cfg.grad_clipping, train, k > 1, held,
                     description)
    return build


# name -> (builder, default widths: dim, layers, head)
CONFIGS = {
    "flagship": (_preset("add", "naive-batch-norm",
                         "PHC-GNN n=4 train step, ZINC config"),
                 (200, 4, (200, 100))),
    "flagship-bf16": (_preset("add", "naive-batch-norm",
                              "PHC-GNN n=4 train step, ZINC config, bf16 "
                              "activations", torch.bfloat16),
                      (200, 4, (200, 100))),
    "concat": (_preset("concat", "naive-batch-norm",
                       "PHC-GNN n=4 concat-skip train step, ZINC config"),
               (200, 4, (200, 100))),
    "quat-wbn": (_preset("add", "q-batch-norm",
                         "PHC-GNN n=4 whitening-BN train step, ZINC config"),
                 (200, 4, (200, 100))),
    "pna": (_pna, (200, 4, (128, 64))),
    "pcba": (_pcba(4, 128, 4096, 8192, True,
                   "PHC-GNN n=2 accumulated step, 4 x 128 graphs, molpcba "
                   "config"), (512, 7, (768, 256))),
    "pcba-16k": (_pcba(1, 512, 16384, 32768, False,
                       "PHC-GNN n=2 train step, one 512-graph bucket, "
                       "molpcba config"), (512, 7, (768, 256))),
    "pcba-k2": (_pcba(2, 256, 8192, 16384, False,
                      "PHC-GNN n=2 accumulated step, 2 x 256 graphs, "
                      "molpcba config"), (512, 7, (768, 256))),
}


def card() -> dict:
    """The first card's name and power limit (W) as nvidia-smi reports
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"device": name.strip(), "power_limit_w": float(limit)}


def host_card(dev: torch.device) -> dict:
    """``card()`` on a CUDA device; on the CPU its stand-in, no card."""
    return (card() if dev.type == "cuda"
            else {"device": "cpu", "power_limit_w": None})


def _slope(fn, k1: int, k2: int, sync, reps: int = 1) -> tuple:
    """(seconds a call, seconds of ``fn(k1)``): ``fn(k)`` runs k calls;
    each count runs once to warm up, then ``reps`` times timed, the least
    taken, with the host clock around the calls and a final ``sync``."""
    def once(k):
        t0 = time.perf_counter()
        fn(k)
        sync()
        return time.perf_counter() - t0

    def timed(k):
        fn(k)
        sync()
        return min(once(k) for _ in range(reps))

    t1, t2 = timed(k1), timed(k2)
    return (t2 - t1) / (k2 - k1), t1


def _repeat(call):
    def calls(k):
        for _ in range(k):
            call()
    return calls


def _roofline_ms(dim: int, layers: int, num_nodes: int,
                 num_edges: int) -> float:
    """bench.py's crude roofline (:258-262): the PHM GEMMs' FLOPs forward
    and backward, and the activation traffic of the edge and node passes,
    priced at the H100's float32 and HBM peaks."""
    gemm_flops = 3 * 2 * layers * 2 * num_nodes * dim * dim
    edge_bytes = 2 * layers * 8 * num_edges * dim * 4
    node_bytes = 2 * layers * 6 * num_nodes * dim * 4
    return (gemm_flops / H100_FP32_FLOP_PER_S
            + (edge_bytes + node_bytes) / H100_HBM_BYTES_PER_S) * 1e3


def run(config: str = "flagship", device: Union[str, torch.device] = "cuda",
        dim: Optional[int] = None, layers: Optional[int] = None,
        head: Optional[Sequence[int]] = None, shrink: int = 1,
        k1: int = 10, k2: int = 110) -> dict:
    """The bench's line for ``config`` (a key of ``CONFIGS``) on ``device``
    (default "cuda"; without CUDA it raises unless ``device="cpu"``), at the
    configuration's widths unless ``dim``, ``layers`` or ``head`` is
    given, its batches' graphs, nodes and edges divided by ``shrink``."""
    if config not in CONFIGS:
        raise ValueError(f"unknown bench configuration {config!r}: one of "
                         f"{sorted(CONFIGS)}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        gc.collect()  # an earlier configuration's graphs and models
        torch.cuda.reset_peak_memory_stats(dev)
    build, (d0, l0, h0) = CONFIGS[config]
    w = Widths(dim or d0, layers or l0, tuple(head or h0), shrink)
    s = build(w, dev)
    real_edges = sum(b.count_edges() for b in s.train)
    train = [b.to(dev) for b in s.train]
    opt = make_optimizer(dict(s.model.named_parameters()),
                         grad_clip=s.grad_clip)
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    if s.accumulate:
        args = dict(weight_decay=s.weight_decay, loss_name=s.loss_name,
                    seed=0, device=dev)
        graphed = make_accum_train_step(s.model, opt, s.loss_fn, **args)
        eager = _eager_accum_train_step(s.model, opt, s.loss_fn, **args)
        graphed_calls = _repeat(lambda: graphed(train, s.lr))
        eager_calls = _repeat(lambda: eager(train, s.lr))
    else:
        args = dict(weight_decay=s.weight_decay, seed=0, device=dev)
        scan = make_scan_train_steps(s.model, opt, s.loss_fn, **args)
        eager = make_train_step(s.model, opt, s.loss_fn, **args)

        def graphed_calls(k):
            scan(train * k, s.lr)

        eager_calls = _repeat(lambda: eager(train[0], s.lr))
    per_step, t1 = _slope(graphed_calls, k1, k2, sync)
    eager_step, _ = _slope(eager_calls, k1, k2, sync)

    detail = {"config": config, "steps_per_s": 1.0 / per_step,
              "step_ms": per_step * 1e3, "eager_step_ms": eager_step * 1e3,
              "real_edges_per_batch": real_edges,
              "sub_batches": len(train),
              "padded_nodes": train[0].num_nodes,
              "padded_edges": train[0].num_edges,
              "dispatch_overhead_ms": (t1 - k1 * per_step) * 1e3}
    if s.eval is not None:
        # replays of a CUDA graph are not merged the way XLA folds a
        # loop-invariant call, so the eval needs none of bench.py's
        # runtime-zero inputs: each of the k forwards runs
        held = s.eval.to(dev)
        scan_eval = make_scan_eval_steps(s.model, device=dev)
        eval_step = make_eval_step(s.model, device=dev)
        per_eval, _ = _slope(lambda k: scan_eval([held] * k), k1, k2, sync)
        eager_eval, _ = _slope(_repeat(lambda: eval_step(held)), k1, k2,
                               sync)
        detail.update(eval_ms=per_eval * 1e3,
                      eval_edges_per_s=s.eval.count_edges() / per_eval,
                      eager_eval_ms=eager_eval * 1e3)
    if config == "flagship":
        roofline_ms = _roofline_ms(w.dim, w.layers, train[0].num_nodes,
                                   train[0].num_edges)
        detail.update(roofline_ms=roofline_ms,
                      roofline_fraction=roofline_ms / (per_step * 1e3))
    sync()
    detail["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda else None)
    detail["backend"] = dev.type
    detail.update(host_card(dev))
    how = "CUDA graphs" if cuda else "eager, CPU"
    return {"metric": f"edges/s ({s.description}, {how})",
            "value": real_edges / per_step, "unit": "edges/s",
            "detail": detail}


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Time the port's train steps and eval forwards on the "
                    "GPU: one JSON line a configuration.")
    parser.add_argument("--config", action="append",
                        choices=sorted(CONFIGS) + ["all"],
                        help="a configuration (repeatable), or all; the "
                             "flagship without it")
    names = parser.parse_args(argv).config or ["flagship"]
    if "all" in names:
        names = list(CONFIGS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in names:
        print(json.dumps(run(name, "cuda")), flush=True)


if __name__ == "__main__":
    main()
