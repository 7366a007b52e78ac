"""Training harness: the model and loss from a configuration, epoch loops,
evaluation, plateau scheduling, checkpoints and resume, and the n_runs
loop with its mean and std summary.

Counterparts of ``build_model``, ``build_loss``, ``iter_scan_chunks`` and
``Trainer`` in phc_gnn_tpu/train/trainer.py:47-98, 127-770: the
single-device paths of JAX's trainer over padded batch streams (a
redesign of the reference's train scripts' shared machinery,
train_hiv.py:165-629).  Artifacts per run, under JAX's names:
``scalars.jsonl`` (a row an epoch), ``val_test.json`` (best_val, the test
at best-val and at last), ``trainer_state.json`` (the scheduler),
``arrays.npy``, checkpoints and the best-validation export under
``ckpt/``; ``params.json`` and ``summary.json`` per experiment.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import pickle
import time
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Union)

import numpy as np
import torch
from torch import nn

from phc_gnn_torch.convert import from_flax_params
from phc_gnn_torch.data.prefetch import prefetch
from phc_gnn_torch.device import resolve_device
from phc_gnn_torch.graph.batch import GraphsTuple
from phc_gnn_torch.models.phc_gnn import PHCGNN
from phc_gnn_torch.parallel.dp import (fold_seed, grid_eval_step,
                                       grid_train_step, make_dummy_batch)
from phc_gnn_torch.parallel.edge_partition import edge_shard
from phc_gnn_torch.parallel.halo import SlotOverflow, partition_nodes
from phc_gnn_torch.parallel.mesh import make_mesh
from phc_gnn_torch.train.checkpoint import CheckpointManager
from phc_gnn_torch.train.config import ExperimentConfig
from phc_gnn_torch.train.evaluators import get_evaluator
from phc_gnn_torch.train.loss import (
    masked_bce_with_logits,
    masked_cross_entropy,
    masked_l1,
    masked_mse,
)
from phc_gnn_torch.train.optim import ReduceLROnPlateau, make_optimizer
from phc_gnn_torch.train.state import (
    make_accum_train_step,
    make_scan_eval_steps,
    make_scan_train_steps,
    make_train_step,
)
from phc_gnn_torch.utils.profiling import trace_context

__all__ = ["Trainer", "build_model", "build_loss", "iter_scan_chunks"]

log = logging.getLogger("phc_gnn_torch")


def build_model(cfg: ExperimentConfig, atom_input_dims, bond_input_dims,
                avg_deg: Optional[Dict[str, float]] = None, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> PHCGNN:
    """``PHCGNN`` from ``cfg`` (reference main():566-579), its weights drawn
    from ``seed`` and moved to ``device``.  A length-1 ``dropout_mpnn``
    broadcasts over all message-passing layers.  ``avg_deg`` is the PNA
    conv's degree statistics (``cfg.aggr_msg == "pna"``), which the CLI
    takes from the training split's in-degree histogram
    (``data.datasets.avg_deg_from_histogram(degree_histogram(graphs))``).
    ``cfg.agg_kernel == "xla"`` puts the model on the composite route
    (``PHCGNN(composite=True)``: no CSR plan read, on any device); "auto"
    and "stream" keep the plan route.  ``cfg.aggr_node`` is not read, as in
    JAX."""
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
        composite=str(getattr(cfg, "agg_kernel", "auto")) == "xla",
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


def _trim_jsonl(path: str, start_epoch: int):
    """Drop rows with epoch >= start_epoch (resume) or the whole file
    (fresh run) so re-runs never leave duplicate epoch rows."""
    if not os.path.exists(path):
        return
    if start_epoch == 0:
        os.remove(path)
        return
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # truncated trailing line from a killed process
    with open(path, "w") as f:
        for r in rows:
            if r.get("epoch", -1) < start_epoch:
                f.write(json.dumps(r) + "\n")


def _host_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """CPU copies of the model's parameters and buffers (its state_dict)."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


class Trainer:
    """One experiment: ``cfg.n_runs`` independent (re-seeded) trainings of
    one model, on ``device`` (default "cuda"; without CUDA this raises
    unless ``device="cpu"``).

    ``train_batches(seed)``, ``valid_batches()`` and ``test_batches()``
    return fresh iterables of CPU batches, carrying their CSR plans
    (``data.PaddedLoader(..., csr_plan=True)``) where the model reads them:
    on one rank or dp ranks, and not on the composite route (``PHCGNN(
    composite=True)``, ``agg_kernel="xla"``); the train loader shuffles
    with the epoch's seed.  The model's weights when given are run 1's
    start; run i > 1 starts from ``init_state(cfg.seed + i - 1)``, a
    state_dict (the CLI passes ``build_model``'s at that seed), or, without
    ``init_state``, from run 1's start again.

    With ``cfg.dp`` or ``cfg.ep`` > 1 (``num_devices`` is an alias of dp)
    the Trainer runs on every rank of a ``(dp, ep)`` mesh
    (``parallel.make_mesh`` over the default process group, which the
    caller sets up: ``cli.train`` does), the multi-rank paths of JAX's
    trainer (:164-250, :300-442): each rank reads the same batches, takes
    member ``d`` of each group of ``dp`` batches of one bucket shape (the
    last group padded with ``make_dummy_batch``) and, with ep > 1, its
    node shard of it (``ep_scheme="halo"``) or its edge shard
    (``"replicated"``: ``parallel.edge_shard``, the model's edges over ep,
    one step a batch as in JAX; ``_partition``), and steps with
    ``parallel.dp.grid_train_step``; the
    outputs of a group reach every rank, so every rank computes the same
    metrics, and only the primary (rank 0) writes files.  ``grad_accum``
    and ``profile_steps`` are single-device there, as JAX keeps
    ``grad_accum``.

    Paths on one device (JAX's): with ``cfg.grad_accum`` K > 1 each
    group of K same-shape batches takes one step of
    ``make_accum_train_step`` (one CUDA graph a (K, bucket)), the epoch's
    last partial group padded with ``make_dummy_batch``; otherwise the
    batches go to ``make_scan_train_steps`` in chunks of
    ``max(cfg.scan_chunk, 1)`` (``iter_scan_chunks``), one graph replay a
    batch.  Evaluation goes through ``make_scan_eval_steps`` the same way.
    With ``cfg.prefetch_depth`` > 0 a background thread packs the batches
    and moves them to the device.  Losses, outputs and labels stay on the
    device until an epoch ends, then are fetched once.

    Everything that loads weights (a run's start, ``init_from``, a resume,
    the best-validation state) copies into the model's and the optimizer's
    existing tensors, which the captured graphs read; the scheduler's lr
    reaches them through ``Adam.set_lr``.  ``cfg.rng_impl`` (JAX's choice
    of PRNG) is not read: the dropout masks come from one
    ``torch.Generator`` on the device, seeded with the run's seed.
    ``epoch_log`` holds, per epoch trained, its train loop's seconds,
    steps and real edges, and where its host time went: a batch's ms
    packing (``loader_ms``, plans included) and of them on the plans
    (``plan_ms``), timed in the thread that packs; moving it to the device
    (``move_ms``, in the prefetch thread) and waiting for it
    (``wait_ms``, in the loop); a step's ms in the step's call
    (``step_host_ms``: the copies into the graph's buffers, the replay's
    launch)."""

    def __init__(self, cfg: ExperimentConfig, model: PHCGNN,
                 train_batches: Callable[[int], Iterable[GraphsTuple]],
                 valid_batches: Callable[[], Iterable[GraphsTuple]],
                 test_batches: Optional[Callable[[], Iterable[GraphsTuple]]] = None,
                 device: Union[str, torch.device] = "cuda",
                 init_state: Optional[Callable[[int], Mapping[str, torch.Tensor]]] = None):
        self.dp = int(getattr(cfg, "dp", 1) or 1)
        self.ep = int(getattr(cfg, "ep", 1) or 1)
        # the deprecated num_devices alias maps onto dp
        nd = int(getattr(cfg, "num_devices", 1) or 1)
        if nd > 1 and self.dp == 1:
            log.warning("num_devices=%d is deprecated; using it as dp", nd)
            self.dp = nd
        self.ep_scheme = str(getattr(cfg, "ep_scheme", "halo") or "halo")
        if self.ep_scheme not in ("halo", "replicated"):
            raise ValueError(f"ep_scheme must be 'halo' or 'replicated', "
                             f"got {self.ep_scheme!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.train_batches = train_batches
        self.valid_batches = valid_batches
        self.test_batches = test_batches
        self.init_state = init_state
        self.evaluator = get_evaluator(cfg.metric)
        self.loss_fn = build_loss(cfg)
        self.opt = make_optimizer(dict(model.named_parameters()),
                                  cfg.grad_clipping)
        self.chunk = max(int(getattr(cfg, "scan_chunk", 0) or 0), 1)
        self.accum = int(getattr(cfg, "grad_accum", 1) or 1)
        self.mesh = None
        self._np_slots = (None, None)  # the halo partition's rungs
        self.epoch_log: List[dict] = []
        kw = dict(weight_decay=cfg.weightdecay,
                  weight_decay2=cfg.weightdecay2, reg_p=cfg.regularization,
                  seed=cfg.seed, device=self.device)
        if self.dp * self.ep > 1:
            self._parallel_steps(model, kw)
            return
        if self.accum > 1:
            if getattr(cfg, "scan_chunk", 0):
                log.info("scan_chunk is ignored under grad_accum")
            self.train_step = make_accum_train_step(
                model, self.opt, self.loss_fn, loss_name=cfg.loss, **kw)
        else:
            self.train_step = make_scan_train_steps(model, self.opt,
                                                    self.loss_fn, **kw)
        self.eval_steps = make_scan_eval_steps(model, device=self.device)
        self._start = _host_state(model)

    @property
    def primary(self) -> bool:
        """True on the rank that writes the run's files (rank 0), and on
        one device."""
        return self.mesh is None or self.mesh.rank == 0

    def _parallel_steps(self, model: PHCGNN, kw: dict) -> None:
        """The multi-rank paths (JAX's trainer.py:164-250): this rank's
        ``(dp, ep)`` mesh over the default process group (``cli.train``
        sets it up), the model's nodes sharded over ``ep``
        (``set_node_axis``) or, under the replicated scheme, its edges
        (``set_edge_axis``), one train step a batch (the scanned chunks of
        JAX are the same steps one after another) and the eval forward on
        the same shards; ``grad_accum`` stays single-device, as in JAX."""
        if self.accum > 1:
            log.info("grad_accum is single-device; ignored under dp/ep")
            self.accum = 1
        self.mesh = make_mesh(self.dp, self.ep)
        if self.ep > 1 and self.ep_scheme == "halo":
            model.set_node_axis("ep")
        elif self.ep > 1:
            model.set_edge_axis("ep")
        self.train_step = grid_train_step(
            model, self.opt, self.loss_fn, self.mesh, loss_name=self.cfg.loss,
            **kw)
        self.eval_step = grid_eval_step(model, self.mesh, self.device)
        self._start = _host_state(model)

    # -- helpers ------------------------------------------------------------
    def _batches(self, batches):
        depth = int(getattr(self.cfg, "prefetch_depth", 0) or 0)
        return prefetch(batches, depth=depth, device=self.device) if depth \
            else batches

    def _groups(self, batches: Iterable[GraphsTuple], size: int):
        """Group batches into groups of ``size`` of one bucket shape (a
        bucket ladder's shapes queue apart, each flushed when full); each
        shape's last partial group is padded with fully masked dummies
        (zero loss weight: exact, no data dropped).  Yields
        ``(real_batches, group)``."""
        queues: dict = {}  # shape key -> pending batches (insertion ordered)
        for batch in batches:
            group = queues.setdefault(batch.shape_key(), [])
            group.append(batch)
            if len(group) == size:
                full = list(group)
                group.clear()
                yield full, full
        for group in queues.values():
            if group:
                full = group + [make_dummy_batch(group[0])] * (
                    size - len(group))
                yield group, full

    def _partition(self, batch: GraphsTuple) -> GraphsTuple:
        """This rank's shard of ``batch`` (JAX's trainer.py:331-360): under
        the replicated scheme its edge shard; under the halo scheme its
        node shard, with its CSR plans unless the model is on the
        composite route, the per-shard edge and halo widths on coarse rungs
        (multiples of 512 and 64), grown when a batch needs more, so
        consecutive batches share their shapes.  Every rank of a dp row
        partitions the same batches, so their rungs move together."""
        if self.ep_scheme == "replicated":
            return edge_shard(batch, self.ep, self.mesh.ep.index)
        plan = not self.model.composite
        es, h = self._np_slots
        if es is not None:
            try:
                return partition_nodes(batch, self.ep, edge_slots=es,
                                       halo_slots=h, csr_plan=plan)[
                    self.mesh.ep.index]
            except SlotOverflow as o:
                need_es, need_h = o.needed_edge_slots, o.needed_halo_slots
        else:
            nat = partition_nodes(batch, self.ep, csr_plan=False)
            need_es, need_h = nat[0].num_edges, nat[0].halo_send.shape[1]
        es = -(-max(need_es, es or 0) // 512) * 512
        h = -(-max(need_h, h or 0) // 64) * 64
        self._np_slots = (es, h)
        log.info("halo partition rungs -> edge_slots=%d halo_slots=%d", es, h)
        return partition_nodes(batch, self.ep, edge_slots=es, halo_slots=h,
                               csr_plan=plan)[self.mesh.ep.index]

    def _dp_groups(self, batches: Iterable[GraphsTuple]):
        """``(real batches, this rank's batch or node shard)`` per step
        (JAX's ``_dp_groups`` and ``_prep_dp_group``, :322-390): groups of
        ``dp`` batches of one bucket shape, the last padded with
        ``make_dummy_batch``; this rank takes member ``d`` and, with
        ep > 1, its shard of it."""
        groups = (self._groups(batches, self.dp) if self.dp > 1
                  else (([b], [b]) for b in batches))
        for real, group in groups:
            mine = group[self.mesh.dp.index]
            yield real, (self._partition(mine) if self.ep > 1 else mine)

    def _parallel_items(self, batches: Iterable[GraphsTuple]):
        """``_dp_groups`` with the partitioning in the prefetch thread
        (JAX's ``_parallel_train_epoch``, :392-441: it costs about a step's
        time a batch); the step moves each shard to the device."""
        depth = int(getattr(self.cfg, "prefetch_depth", 0) or 0)
        items = self._dp_groups(batches)
        return prefetch(items, depth=depth) if depth else items

    @contextlib.contextmanager
    def _weights(self, state: Mapping[str, torch.Tensor]):
        """The model holds ``state`` inside the block and its own weights
        again after it."""
        own = _host_state(self.model)
        self.model.load_state_dict(state)
        try:
            yield
        finally:
            self.model.load_state_dict(own)

    def _reset(self, run_idx: int, seed: int) -> None:
        """The run's start: its initial weights, Adam's state zeroed and
        the dropout generator seeded."""
        state = (self.init_state(seed)
                 if run_idx > 1 and self.init_state is not None
                 else self._start)
        self.model.load_state_dict(state)
        zeros = {k: torch.zeros_like(p) for k, p in self.opt.params.items()}
        self.opt.load_state(0, zeros, zeros)
        self.train_step.generator.manual_seed(
            seed if self.mesh is None else fold_seed(seed, self.mesh.dp.index))

    def _full_state(self, epoch: int) -> dict:
        """What a checkpoint holds: the model's state_dict, Adam's count,
        moments and lr, the dropout generator's state, torch's default CPU
        and CUDA generators' states, and the epoch."""
        opt = self.opt
        cpu = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        adam = {"count": opt.count, "lr": cpu(opt.lr),
                "mu": {k: cpu(opt.adam.state[p]["exp_avg"])
                       for k, p in opt.params.items()},
                "nu": {k: cpu(opt.adam.state[p]["exp_avg_sq"])
                       for k, p in opt.params.items()}}
        rng = {"cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        return {"epoch": epoch, "model": _host_state(self.model),
                "adam": adam, "generator": self.train_step.generator.get_state(),
                "rng": rng}

    def _restore(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        adam = state["adam"]
        self.opt.load_state(adam["count"], adam["mu"], adam["nu"])
        self.opt.set_lr(adam["lr"].to(self.opt.lr.device))
        self.train_step.generator.set_state(state["generator"])
        torch.set_rng_state(state["rng"]["cpu"])
        if "cuda" in state["rng"] and self.device.type == "cuda":
            torch.cuda.set_rng_state(state["rng"]["cuda"], self.device)

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, batches: Iterable[GraphsTuple]) -> dict:
        """The loss and the metric of the model's current weights over
        ``batches``; everything stays on the device until one fetch at the
        end."""
        y_true, y_pred, masks, losses, weights = [], [], [], [], []
        if self.mesh is not None:
            # every rank evaluates its batch or shard; the outputs of the
            # dp batches come back to every rank, a dummy's dropped
            groups = (
                (real, outs if self.dp > 1 else outs[None])
                for real, outs in ((real, self.eval_step(mine)) for real, mine
                                   in self._parallel_items(batches)))
        else:
            groups = ((chunk, self.eval_steps(chunk)) for chunk in
                      iter_scan_chunks(self._batches(batches), self.chunk))
        for chunk, outs in groups:
            for i, b in enumerate(chunk):
                out = outs[i]
                # the fields a loss reads, where the output is
                b = b.replace(y=b.y.to(out.device),
                              graph_mask=b.graph_mask.to(out.device))
                w = b.graph_mask.sum(dtype=torch.float32)
                losses.append(self.loss_fn(out, b) * w)
                weights.append(w)
                y_true.append(b.y)
                y_pred.append(out)
                masks.append(b.graph_mask)
        mask = torch.cat(masks).cpu().numpy()
        metric = self.evaluator(torch.cat(y_true).cpu().numpy()[mask],
                                torch.cat(y_pred).cpu().numpy()[mask])
        loss = float(torch.stack(losses).sum()
                     / torch.stack(weights).sum().clamp_min(1))
        return {"loss": loss, self.cfg.metric: metric}

    # -- one epoch ----------------------------------------------------------
    def _train_epoch(self, epoch_seed: int, lr: float) -> dict:
        """One pass over the train split at ``lr``: the mean train loss
        (weighted by real graphs), the metric, the steps, the real edges,
        the seconds until the losses were on the host, and the host ms of
        ``epoch_log``."""
        t0 = time.time()
        loader = self.train_batches(epoch_seed)
        losses, y_true, y_pred, masks, emasks = [], [], [], [], []

        def consume(batch, loss, out):
            losses.append(loss)
            y_true.append(batch.y)
            y_pred.append(out)
            masks.append(batch.graph_mask)
            emasks.append(batch.edge_mask)

        batches = (self._parallel_items(loader) if self.mesh is not None
                   else self._batches(loader))
        step_s = 0.0
        if self.mesh is not None:
            # one step a dp group; every rank gets the group's outputs
            for real, mine in batches:
                t = time.perf_counter()
                loss, outs = self.train_step(mine, lr)
                step_s += time.perf_counter() - t
                outs = outs if self.dp > 1 else outs[None]
                for i, b in enumerate(real):
                    consume(b, loss, outs[i])
        elif self.accum > 1:
            # gradient accumulation: one optimizer step a group of K
            # (exact weighted-mean grads; dummy pads contribute nothing)
            for real, group in self._groups(batches, self.accum):
                t = time.perf_counter()
                loss, outs = self.train_step(group, lr)
                step_s += time.perf_counter() - t
                for i, b in enumerate(real):
                    consume(b, loss, outs[i])
        else:
            for chunk in iter_scan_chunks(batches, self.chunk):
                t = time.perf_counter()
                step_losses, outs = self.train_step(chunk, lr)
                step_s += time.perf_counter() - t
                for i, b in enumerate(chunk):
                    consume(b, step_losses[i], outs[i])
        dev = losses[0].device
        g = torch.stack(masks).to(dev).sum(1, dtype=torch.float32)
        loss = (torch.stack(losses) * g).sum() / g.sum().clamp_min(1)
        edges = torch.cat(emasks).sum()
        train_loss, edges = float(loss), int(edges)  # the epoch's one sync
        seconds = max(time.time() - t0, 1e-9)
        mask = torch.cat(masks).cpu().numpy()
        metric = self.evaluator(torch.cat(y_true).cpu().numpy()[mask],
                                torch.cat(y_pred).cpu().numpy()[mask])
        n = max(getattr(loader, "batches", 0), 1)
        return {"train_loss": train_loss, "train_metric": metric,
                "steps": len(losses), "edges": edges, "seconds": seconds,
                "loader_ms": 1e3 * getattr(loader, "pack_s", 0.0) / n,
                "plan_ms": 1e3 * getattr(loader, "plan_s", 0.0) / n,
                "move_ms": 1e3 * getattr(batches, "move_s", 0.0) / n,
                "wait_ms": 1e3 * getattr(batches, "wait_s", 0.0) / n,
                "step_host_ms": 1e3 * step_s / len(losses)}

    # -- single run ---------------------------------------------------------
    def _profile(self, run_dir: str, seed: int) -> None:
        """``torch.profiler`` trace of ``cfg.profile_steps`` train steps
        (one warm-up first) on a throwaway copy of the model and a fresh
        optimizer, written to ``run_dir/profile``; the run's own model,
        optimizer and generator are untouched."""
        cfg = self.cfg
        logdir = os.path.join(run_dir, "profile")
        model = copy.deepcopy(self.model)
        opt = make_optimizer(dict(model.named_parameters()),
                             cfg.grad_clipping)
        step = make_train_step(model, opt, self.loss_fn, cfg.weightdecay,
                               cfg.weightdecay2, cfg.regularization,
                               seed=seed, device=self.device)
        sample = next(iter(self.train_batches(seed)))
        step(sample, cfg.lr)
        with trace_context(logdir):
            for _ in range(cfg.profile_steps):
                step(sample, cfg.lr)
        log.info("profiler trace (%d steps) -> %s", cfg.profile_steps, logdir)

    def do_run(self, run_idx: int, resume: bool = False) -> dict:
        cfg = self.cfg
        run_dir = os.path.join(cfg.save_dir, f"run_{run_idx}")
        os.makedirs(run_dir, exist_ok=True)
        seed = cfg.seed + run_idx - 1
        self._reset(run_idx, seed)
        if getattr(cfg, "init_from", ""):
            # warm start from a pickled flax params tree (numpy leaves); the
            # fresh running stats and optimizer state stay
            with open(cfg.init_from, "rb") as f:
                loaded = pickle.load(f)
            self.model.load_state_dict(from_flax_params(loaded, self.model))
            log.info("warm-started params from %s", cfg.init_from)
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("run %d: %d params, seed %d", run_idx, n_params, seed)
        if int(getattr(cfg, "profile_steps", 0) or 0) > 0:
            if self.mesh is None:
                self._profile(run_dir, seed)
            else:
                log.info("profile_steps is single-device; ignored under "
                         "dp/ep")

        ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
        scheduler = ReduceLROnPlateau(
            lr=cfg.lr, mode=cfg.scheduler_mode, factor=cfg.factor,
            patience=cfg.patience, min_lr=cfg.min_lr)
        sched_path = os.path.join(run_dir, "trainer_state.json")
        start_epoch = 0
        mode = cfg.scheduler_mode
        best_val = -np.inf if mode == "max" else np.inf
        best_state = None
        if resume and ckpt.latest_step() is not None:
            self._restore(ckpt.restore())
            start_epoch = int(ckpt.latest_step())
            if os.path.exists(sched_path):
                # exact resume: scheduler lr/best/patience + best-val metric
                with open(sched_path) as f:
                    saved = json.load(f)
                scheduler.lr = saved["lr"]
                scheduler.best = saved["sched_best"]
                scheduler.num_bad = saved["num_bad"]
                best_val = saved["best_val"]
            log.info("resumed run %d at epoch %d (lr %.2e, best_val %.4f)",
                     run_idx, start_epoch, scheduler.lr, best_val)
        # one rank (the primary) writes the run's files
        write = self.primary
        if write:
            _trim_jsonl(os.path.join(run_dir, "scalars.jsonl"), start_epoch)
            _trim_jsonl(os.path.join(run_dir, "weights.jsonl"), start_epoch)
        if resume and ckpt.has_best():
            # test@bestval must use the best export's weights, not the latest
            best_state = ckpt.restore_best()
            if not np.isfinite(best_val):
                # a checkpoint without scheduler state: recover the best
                # metric so the first resumed epoch cannot overwrite a
                # better export
                with self._weights(best_state):
                    best_val = self.evaluate(self.valid_batches())[cfg.metric]
                log.info("recovered best_val %.4f from best export", best_val)
        scalars_path = os.path.join(run_dir, "scalars.jsonl")
        t_start = time.time()
        lr = scheduler.lr
        history = {"lr": [], "train_loss": [], "train_metric": [],
                   "valid_loss": [], "valid_metric": []}

        for epoch in range(start_epoch, cfg.epochs):
            tr = self._train_epoch(seed * 10007 + epoch, lr)
            self.epoch_log.append({"run": run_idx, "epoch": epoch, **{
                k: v for k, v in tr.items()
                if k not in ("train_loss", "train_metric")}})
            val = self.evaluate(self.valid_batches())
            val_metric = val[cfg.metric]

            improved = ((val_metric > best_val) if mode == "max"
                        else (val_metric < best_val))
            if improved and np.isfinite(val_metric):
                best_val = val_metric
                # slim export: parameters and running stats only
                best_state = _host_state(self.model)
                if write:
                    ckpt.export_best(best_state)
            lr = scheduler.step(val_metric)
            if write:
                ckpt.save(epoch + 1, self._full_state(epoch + 1))
                with open(sched_path, "w") as f:
                    json.dump({"lr": scheduler.lr,
                               "sched_best": scheduler.best,
                               "num_bad": scheduler.num_bad,
                               "best_val": float(best_val)}, f)

            if cfg.log_weights and write:
                # the reference's TensorBoard weight histograms analogue
                # (train_hiv.py:313-323): per-parameter summary stats
                stats = {}
                for name, p in self.model.named_parameters():
                    a = p.detach().cpu().numpy()
                    stats[name.replace(".", "/")] = {
                        "mean": float(np.mean(a)), "std": float(np.std(a)),
                        "min": float(np.min(a)), "max": float(np.max(a))}
                with open(os.path.join(run_dir, "weights.jsonl"), "a") as f:
                    f.write(json.dumps({"epoch": epoch, "params": stats})
                            + "\n")

            row = {"epoch": epoch, "lr": lr, "train_loss": tr["train_loss"],
                   "train_metric": tr["train_metric"],
                   "valid_loss": val["loss"], "valid_metric": val_metric,
                   "wall_s": round(time.time() - t_start, 1),
                   "steps_per_s": round(tr["steps"] / tr["seconds"], 2),
                   "edges_per_s": round(tr["edges"] / tr["seconds"], 1)}
            if write:
                with open(scalars_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
            for k in history:
                history[k].append(row[k])
            log.info("run %d epoch %d: train %.4f/%.4f valid %.4f/%.4f lr "
                     "%.2e", run_idx, epoch, tr["train_loss"],
                     tr["train_metric"], val["loss"], val_metric, lr)

            # Benchmarking-GNNs stopping rules (train_zinc.py:366-381)
            if lr < cfg.min_lr * (1 + 1e-9) and cfg.scheduler_mode == "min":
                log.info("stopping: lr below min_lr")
                break
            if (cfg.max_time_hours
                    and time.time() - t_start > cfg.max_time_hours * 3600):
                log.info("stopping: max_time reached")
                break

        if not np.isfinite(best_val):
            # no epoch ran (e.g. resume at completion): score the weights
            best_val = self.evaluate(self.valid_batches())[cfg.metric]
            best_state = _host_state(self.model)

        # the test at the last weights, then at the best-validation ones
        # (copied in for the evaluation and the last put back after)
        result = {"best_val": float(best_val)}
        if self.test_batches is not None:
            test_last = self.evaluate(self.test_batches())
            with self._weights(best_state):
                test_best = self.evaluate(self.test_batches())
            result["test_bestval"] = float(test_best[cfg.metric])
            result["test_last"] = float(test_last[cfg.metric])
        if write:
            with open(os.path.join(run_dir, "val_test.json"), "w") as f:
                json.dump(result, f, indent=2)
            np.save(os.path.join(run_dir, "arrays.npy"), history,
                    allow_pickle=True)
        return result

    # -- n_runs ---------------------------------------------------------------
    def run(self, resume: bool = False) -> dict:
        """n_runs independent trainings; KeyboardInterrupt finishes the
        current run's bookkeeping (checkpoints are saved every epoch, so a
        resumed invocation continues exactly)."""
        os.makedirs(self.cfg.save_dir, exist_ok=True)
        if self.primary:
            with open(os.path.join(self.cfg.save_dir, "params.json"),
                      "w") as f:
                f.write(self.cfg.to_json())
        results: List[dict] = []
        for i in range(1, self.cfg.n_runs + 1):
            try:
                results.append(self.do_run(i, resume=resume))
            except KeyboardInterrupt:
                log.info("interrupted during run %d; checkpoints are saved "
                         "per epoch: rerun with resume=True to continue", i)
                break
        if not results:
            log.info("no completed runs; nothing to summarize")
            return {}
        summary = {}
        for key in results[0]:
            vals = [r[key] for r in results]
            summary[key] = {"mean": float(np.mean(vals)),
                            "std": float(np.std(vals)), "runs": vals}
        if self.primary:
            with open(os.path.join(self.cfg.save_dir, "summary.json"),
                      "w") as f:
                json.dump(summary, f, indent=2)
        return summary
