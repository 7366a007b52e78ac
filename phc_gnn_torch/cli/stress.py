"""Exactness of the two multi-rank schemes at 8, 16 and 32 ranks: the
counterpart of scripts/dryrun_stress.py with __graft_entry__.py's
``exactness_check``.

    python -m phc_gnn_torch.cli.stress [--worlds 8 16 32] \\
        [--device cuda|cpu] [--out FILE]

For each world of ``n`` ranks, one start of ``n`` gloo rank processes
(``spawn``): on ``--device cuda`` (the default) every rank on cuda:0, the
card's tensors through gloo, as one card holds no more ranks over NCCL
than it holds contexts; on ``--device cpu`` on the CPU.  For each
``ep`` in {2, 4} that divides ``n``, ``dp = n / ep`` (JAX's six shapes at
8, 16 and 32), the tiny flagship with dropout off (``phm_dim`` 4, width
32, 2 softmax convs, head (32, 16) -> 1; ``_flagship(tiny=True,
nodrop=True)``), weights from seed 0, takes one train step from one state
under each scheme: the halo scheme on ``partition_nodes(batch, ep,
edge_slots=384, halo_slots=64)`` and the replicated scheme on
``edge_shard``; dp row ``d`` holds ``synthetic_batch(4, 128, 256,
seed=d)``.  Each is held to the single-device oracle, the port's
``make_accum_train_step`` over the same dp batches (on the composite route
for the replicated scheme, as its ranks run), weight decay 0.1 and 0.01
as JAX's check.

JAX takes one SGD step so that a parameter delta is lr times a gradient
delta; the port's optimizer is Adam, so it compares the loss and the
reduced gradients that reach the optimizer (rank 0's), and records
``max_param_delta = 1e-3 * max_grad_delta``, the SGD step's delta that
JAX records.  It holds JAX's bounds, loss < 1e-5 and parameters < 1e-4,
and exits non-zero past them, after writing ``--out`` (a JSON object:
the device with the card's name and power limit, torch's version and a
record a world, each with its ``wall_s`` and one entry a (scheme, dp,
ep)).  The card's and the CPU's records are committed under
``phc_gnn_torch/stress_records/``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import queue
import socket
import sys
import time
import traceback

import numpy as np
import torch

__all__ = ["WORLDS", "SCHEMES", "LR", "LOSS_BOUND", "PARAM_BOUND",
           "EDGE_SLOTS", "HALO_SLOTS", "BATCH", "shapes", "tiny_flagship",
           "dp_batches", "rank_steps", "oracle", "hold", "within_bounds",
           "run_world", "main"]

WORLDS = (8, 16, 32)
SCHEMES = ("halo", "replicated")
LR = 1e-3                   # JAX's optax.sgd(1e-3)
WEIGHT_DECAY, WEIGHT_DECAY2 = 0.1, 0.01
LOSS_BOUND = 1e-5           # exactness_check's bounds
PARAM_BOUND = 1e-4
EDGE_SLOTS, HALO_SLOTS = 384, 64   # __graft_entry__.py:154
BATCH = dict(batch_size=4, num_nodes=128, num_edges=256)
RANK_TIMEOUT_S = 900


def shapes(world: int) -> list:
    """The ``(dp, ep)`` meshes of ``world`` ranks: ``ep`` in {2, 4}
    dividing it."""
    return [(world // ep, ep) for ep in (2, 4) if world % ep == 0]


def tiny_flagship() -> "torch.nn.Module":
    """The tiny flagship with dropout off, weights from seed 0 (built on
    the CPU wherever it runs, so every rank and the oracle start alike)."""
    from phc_gnn_torch.export import flagship_config
    from phc_gnn_torch.models import PHCGNN

    return PHCGNN(**flagship_config(32, 2, dropout=False), seed=0,
                  device="cpu")


def dp_batches(dp: int) -> list:
    """``synthetic_batch(4, 128, 256, seed=d)`` with its CSR plans for each
    dp row ``d``, on the host."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan

    return [attach_csr_plan(synthetic_batch(**BATCH, seed=d))
            for d in range(dp)]


def _loss_fn(out, batch):
    from phc_gnn_torch.train.loss import masked_l1

    return masked_l1(out, batch.y)


def _recording_optimizer(model):
    """Adam on ``model`` that keeps the gradients it is handed in
    ``opt.seen``."""
    from phc_gnn_torch.train import make_optimizer

    opt = make_optimizer(dict(model.named_parameters()))
    adam_step = opt.step

    def step(grads, lr):
        opt.seen = [g.detach().clone() for g in grads]
        adam_step(grads, lr)

    opt.step = step
    return opt


def rank_steps(rank: int, world: int, device: str = "cpu") -> list:
    """On one rank of a process group of ``world`` gloo ranks: for each
    mesh of ``shapes(world)`` and each scheme, one train step of the tiny
    flagship from seed 0's state on this rank's shard of its dp batch.
    Returns ``(scheme, dp, ep, loss, grads)`` a step, the gradients (as
    numpy, by name) on rank 0 alone."""
    from phc_gnn_torch import parallel as P

    dev = torch.device(device)
    out = []
    for dp, ep in shapes(world):
        mesh = P.make_mesh(dp, ep, "gloo")
        d, e = divmod(rank, ep)
        batch = dp_batches(dp)[d]
        for scheme in SCHEMES:
            model = tiny_flagship()
            if scheme == "halo":
                model.set_node_axis("ep")
                mine = P.partition_nodes(batch, ep, edge_slots=EDGE_SLOTS,
                                         halo_slots=HALO_SLOTS)[e]
                make = P.make_dp_np_train_step
            else:
                model.set_edge_axis("ep")
                mine = P.edge_shard(batch, ep, e)
                make = P.make_dp_ep_train_step
            opt = _recording_optimizer(model)
            step = make(model, opt, _loss_fn, mesh,
                        weight_decay=WEIGHT_DECAY,
                        weight_decay2=WEIGHT_DECAY2, loss_name="l1",
                        device=dev)
            loss, _ = step(mine, LR)
            grads = ({k: g.cpu().numpy() for k, g in zip(opt.params,
                                                          opt.seen)}
                     if rank == 0 else None)
            out.append((scheme, dp, ep, float(loss), grads))
    return out


def oracle(dp: int, scheme: str, device) -> tuple:
    """The single-device ``make_accum_train_step`` over the ``dp`` batches
    from seed 0's state (the composite route for the replicated scheme):
    ``(loss, grads)``, the gradients that reached the optimizer."""
    from phc_gnn_torch.train import make_accum_train_step

    model = tiny_flagship().set_composite(scheme == "replicated")
    opt = _recording_optimizer(model)
    step = make_accum_train_step(model, opt, _loss_fn,
                                 weight_decay=WEIGHT_DECAY,
                                 weight_decay2=WEIGHT_DECAY2,
                                 loss_name="l1", device=device)
    loss, _ = step(dp_batches(dp), LR)
    return float(loss), {k: g.cpu().numpy()
                         for k, g in zip(opt.params, opt.seen)}


def hold(results: list, device) -> list:
    """Rank 0's steps of ``rank_steps`` (``results`` in rank order)
    against ``oracle``: an entry a (scheme, dp, ep) with ``loss_delta``,
    ``max_grad_delta`` and ``max_param_delta``; every rank's loss equal."""
    entries = []
    for i, (scheme, dp, ep, loss, grads) in enumerate(results[0]):
        losses = {r[i][3] for r in results}
        if len(losses) != 1:
            raise AssertionError(f"{scheme} dp={dp} ep={ep}: the ranks' "
                                 f"losses differ: {sorted(losses)}")
        want_loss, want = oracle(dp, scheme, device)
        grad = max(float(np.abs(grads[k] - w).max()) for k, w in
                   want.items())
        entries.append({"scheme": scheme, "dp": dp, "ep": ep,
                        "loss_delta": abs(loss - want_loss),
                        "max_grad_delta": grad,
                        "max_param_delta": LR * grad})
    return entries


def within_bounds(entry: dict) -> bool:
    """JAX's bounds: loss < 1e-5, parameters < 1e-4."""
    return (entry["loss_delta"] < LOSS_BOUND
            and entry["max_param_delta"] < PARAM_BOUND)


def _rank_main(rank, world, port, device, out):
    try:
        torch.set_num_threads(1)
        torch.use_deterministic_algorithms(True, warn_only=True)
        import torch.distributed as dist

        from phc_gnn_torch.parallel import initialize

        initialize("gloo", f"tcp://localhost:{port}", world, rank)
        try:
            out.put((rank, rank_steps(rank, world, device), None))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported by the parent
        out.put((rank, None, traceback.format_exc()))


def _run_ranks(world: int, device: str) -> list:
    """``rank_steps`` on ``world`` fresh gloo rank processes, in rank
    order; raises with a rank's traceback.  Every process is joined or
    killed before it returns."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, device, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, err = {}, None
    try:
        for _ in procs:
            rank, res, tb = out.get(timeout=RANK_TIMEOUT_S)
            if tb is not None:
                err = f"rank {rank} of {world} failed:\n{tb}"
                break
            results[rank] = res
    except queue.Empty:
        err = f"a rank of {world} gave no result in {RANK_TIMEOUT_S} s"
    finally:
        for p in procs:
            p.join(timeout=60 if err is None else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if err is not None:
        raise RuntimeError(err)
    return [results[r] for r in range(world)]


def run_world(world: int, device) -> dict:
    """One start of ``world`` ranks on ``device``, held to the oracle: the
    world's record."""
    t = time.perf_counter()
    results = _run_ranks(world, str(device))
    entries = hold(results, device)
    return {"n_ranks": world, "backend": "gloo",
            "ok": all(within_bounds(e) for e in entries),
            "wall_s": time.perf_counter() - t, "exactness": entries}


def main(argv=None) -> dict:
    from phc_gnn_torch.cli.parity import card_name
    from phc_gnn_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        description="The multi-rank schemes against the single-device "
                    "accumulated step at 8, 16 and 32 ranks")
    ap.add_argument("--worlds", type=int, nargs="+", default=list(WORLDS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # the ranks load what the parent built: builds in several ranks at
        # once would race
        from phc_gnn_torch.ops import _build

        _build.load_all()
    record = {"device": card_name(dev), "torch": torch.__version__,
              "lr": LR, "loss_bound": LOSS_BOUND,
              "param_bound": PARAM_BOUND, "worlds": []}
    for world in args.worlds:
        rec = run_world(world, dev)
        record["worlds"].append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    if not all(w["ok"] for w in record["worlds"]):
        sys.exit(f"a scheme drifts past JAX's bounds: {record['worlds']}")
    return record


if __name__ == "__main__":
    main()
