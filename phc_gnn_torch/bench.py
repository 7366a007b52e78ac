"""Throughput of the port's flagship train step and eval forward on one GPU.

    python -m phc_gnn_torch.bench

The counterpart of ``inner()`` in the JAX package's bench.py (:140-291),
with no JAX: the same model (``phm_dim=4``, ZINC encoders, width 200, 4 x
``PHMGINEConvSoftmax`` with its MLP, dropout 0.1 / (0.2, 0.1),
``sc_type="last"``, a (200, 100) -> 1 head), the same batch
(``synthetic_batch(128, 4096, 8192, seed=0)``, here with its CSR plans) and
the same training setup (masked L1, weight decay 0.1, a global-norm clip of
2.0, Adam at lr 1e-3).

Step ms is the slope between 10 and 110 steps, each count run through
``make_scan_train_steps`` (one CUDA graph replayed a step) with the host
clock around the call and a final ``torch.cuda.synchronize``, as bench.py
times its ``lax.scan``; eval ms likewise through ``make_scan_eval_steps``.
``eager_step_ms`` and ``eager_eval_ms`` are the same slopes over the eager
``make_train_step`` and ``make_eval_step``, so the graph's effect is on one
line.  It prints one JSON line, with the card's name and power limit from
nvidia-smi.  ``run`` takes the device and the widths, so a test can run it
small on the CPU; a CPU run times the CPU, not a device.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Sequence, Union

import torch

from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.graph import attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.train import (make_eval_step, make_optimizer,
                                 make_scan_eval_steps, make_scan_train_steps,
                                 make_train_step, masked_l1)

__all__ = ["run", "card", "main"]

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit: float32
# outside the tensor cores (TF32 is off in the port, so no tensor-core peak
# applies to its GEMMs) and the HBM3 rate
H100_FP32_FLOP_PER_S = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
# bench.py's training setup: masked L1, weight decay, global-norm clip, lr
WEIGHT_DECAY = 0.1
GRAD_CLIP = 2.0
LR = 1e-3


def card() -> dict:
    """The first card's name and power limit (W) as nvidia-smi reports
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"device": name.strip(), "power_limit_w": float(limit)}


def _slope(fn, k1: int, k2: int, sync) -> tuple:
    """(seconds a step, seconds of ``fn(k1)``): ``fn(k)`` runs k steps; each
    count runs once to warm up and once timed, with the host clock around
    the call and a final ``sync``."""
    def timed(k):
        fn(k)
        sync()
        t0 = time.perf_counter()
        fn(k)
        sync()
        return time.perf_counter() - t0

    t1, t2 = timed(k1), timed(k2)
    return (t2 - t1) / (k2 - k1), t1


def run(device: Union[str, torch.device] = "cuda", dim: int = 200,
        layers: int = 4, head: Sequence[int] = (200, 100),
        batch_size: int = 128, num_nodes: int = 4096, num_edges: int = 8192,
        k1: int = 10, k2: int = 110) -> dict:
    """The bench's result for the flagship at these widths on ``device``
    (default "cuda"; without CUDA it raises unless ``device="cpu"``)."""
    dev = resolve_device(device)
    model = PHCGNN(phm_dim=4, atom_input_dims=ZINC_ATOM_DIMS,
                   bond_input_dims=ZINC_BOND_DIMS, atom_encoded_dim=dim,
                   mp_layers=(dim,) * layers, dropout_mpnn=(0.1,) * layers,
                   downstream_layers=tuple(head), target_dim=1,
                   dropout_dn=(0.2, 0.1), msg_aggr="softmax", mlp_mp=True,
                   sc_type="last", seed=0, device=dev)
    host = attach_csr_plan(synthetic_batch(batch_size, num_nodes, num_edges,
                                           seed=0))
    real_edges = host.count_edges()
    batch = host.to(dev)
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=GRAD_CLIP)

    def loss_fn(out, b):
        return masked_l1(out, b.y)

    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    scan = make_scan_train_steps(model, opt, loss_fn,
                                 weight_decay=WEIGHT_DECAY, seed=0, device=dev)
    eager = make_train_step(model, opt, loss_fn, weight_decay=WEIGHT_DECAY,
                            seed=0, device=dev)
    per_step, t1 = _slope(lambda k: scan([batch] * k, LR), k1, k2, sync)

    def eager_steps(k):
        for _ in range(k):
            eager(batch, LR)

    eager_step, _ = _slope(eager_steps, k1, k2, sync)

    # replays of a CUDA graph are not merged the way XLA folds a
    # loop-invariant call, so the eval needs none of bench.py's
    # runtime-zero inputs: each of the k forwards runs
    scan_eval = make_scan_eval_steps(model, device=dev)
    eval_step = make_eval_step(model, device=dev)
    per_eval, _ = _slope(lambda k: scan_eval([batch] * k), k1, k2, sync)

    def eager_evals(k):
        for _ in range(k):
            eval_step(batch)

    eager_eval, _ = _slope(eager_evals, k1, k2, sync)

    # bench.py's crude roofline (:258-262): the PHM GEMMs' FLOPs forward and
    # backward, and the activation traffic of the edge and node passes,
    # priced at the H100's float32 and HBM peaks
    gemm_flops = 3 * 2 * layers * 2 * num_nodes * dim * dim
    edge_bytes = 2 * layers * 8 * num_edges * dim * 4
    node_bytes = 2 * layers * 6 * num_nodes * dim * 4
    roofline_ms = (gemm_flops / H100_FP32_FLOP_PER_S
                   + (edge_bytes + node_bytes) / H100_HBM_BYTES_PER_S) * 1e3
    card_info = (card() if dev.type == "cuda"
                 else {"device": "cpu", "power_limit_w": None})
    return {
        "metric": "edges/s (PHC-GNN n=4 train step, ZINC config, "
                  + ("CUDA graphs)" if dev.type == "cuda" else "eager, CPU)"),
        "value": real_edges / per_step,
        "unit": "edges/s",
        "detail": {
            "steps_per_s": 1.0 / per_step,
            "step_ms": per_step * 1e3,
            "eval_ms": per_eval * 1e3,
            "eval_edges_per_s": real_edges / per_eval,
            "eager_step_ms": eager_step * 1e3,
            "eager_eval_ms": eager_eval * 1e3,
            "real_edges_per_batch": real_edges,
            "padded_nodes": num_nodes,
            "padded_edges": num_edges,
            "dispatch_overhead_ms": (t1 - k1 * per_step) * 1e3,
            "roofline_ms": roofline_ms,
            "roofline_fraction": roofline_ms / (per_step * 1e3),
            "backend": dev.type,
            **card_info,
        },
    }


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run("cuda")), flush=True)


if __name__ == "__main__":
    main()
