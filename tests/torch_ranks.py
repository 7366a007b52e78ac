"""Rank processes of the port's multi-rank tests on the CPU.

``run_ranks(case, world, spec)`` starts ``world`` processes with the start
method ``spawn``, joins them into one gloo process group over
``tcp://localhost:<free port>``, runs ``case(rank, world, spec)`` (a
function of this module, by name) in each, and returns each rank's
result.  This module imports no JAX: the ranks run the port alone, and
the test process compares their results with JAX.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 120
# a shared start's wait: the first caller builds the spec (JAX's inits),
# then the ranks run every case
SHARED_TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _entry(rank, world, port, case, spec, out):
    try:
        torch.set_num_threads(1)
        torch.use_deterministic_algorithms(True)
        from phc_gnn_torch.parallel import initialize
        initialize("gloo", f"tcp://localhost:{port}", world, rank)
        try:
            out.put((rank, globals()[case](rank, world, spec), None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the test process
        out.put((rank, None, traceback.format_exc()))


def run_ranks(case: str, world: int, spec: dict) -> list:
    """Each rank's ``case(rank, world, spec)``, in rank order; raises with
    a rank's traceback if one failed."""
    return start_ranks(case, world, spec)()


def start_ranks(case: str, world: int, spec: dict):
    """Start the ranks of ``run_ranks`` and return a function that waits
    for their results: the test process works on while they run."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(r, world, port, case, spec, out))
             for r in range(world)]
    for p in procs:
        p.start()
    return lambda: _results(case, procs, out)


def shared_ranks(base: str, name: str, case: str, world: int, make_spec):
    """One start of ``world`` ranks running ``case`` for every test of a
    pytest run that asks for ``name``, on whichever xdist worker each
    runs: the first caller builds the spec (``make_spec()``) and starts the
    ranks, a thread of its process writes their results (or the error) to
    ``base/<name>.pkl``; each caller gets a function that waits for that
    file.  ``base`` is a directory that the run's workers share."""
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, f"{name}.pkl")

    def publish(payload):
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)

    try:
        fd = os.open(f"{path}.started", os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        pass
    else:
        os.close(fd)
        try:
            wait = start_ranks(case, world, make_spec())
        except BaseException as err:
            publish(("error", f"{name}: the spec or the start failed: "
                              f"{err!r}"))
            raise

        def collect():
            try:
                publish(("ok", wait()))
            except Exception as err:  # noqa: BLE001 - for the waiters
                publish(("error", str(err)))

        threading.Thread(target=collect, daemon=True).start()

    def result() -> list:
        deadline = time.monotonic() + SHARED_TIMEOUT_S
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise RuntimeError(f"{name}: no result in "
                                   f"{SHARED_TIMEOUT_S} s")
            time.sleep(0.1)
        with open(path, "rb") as f:
            kind, value = pickle.load(f)
        if kind == "error":
            raise RuntimeError(value)
        return value

    return result


def _results(case, procs, out) -> list:
    results = {}
    try:
        for _ in procs:
            rank, res, err = out.get(timeout=RANK_TIMEOUT_S)
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            results[rank] = res
    except queue.Empty:
        raise RuntimeError(f"{case}: a rank gave no result in "
                           f"{RANK_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(len(procs))]


# --------------------------------------------------------------- the cases

class Sgd:
    """``p -= lr * g``: optax's ``scale(-1.0)`` of JAX's halo tests, whose
    update JAX's step scales by the lr, with the optimizer interface the
    port's steps call."""

    def __init__(self, params):
        self.params = dict(params)
        self.lr = torch.zeros(())
        self.count = 0

    def follow_params(self):
        pass

    def set_lr(self, lr):
        self.lr.fill_(float(lr))

    @torch.no_grad()
    def step(self, grads, lr):
        self.set_lr(lr)
        for p, g in zip(self.params.values(), grads):
            p.sub_(self.lr * g)
        self.count += 1


def build(spec):
    """The model, its optimizer and the loss of ``spec``: the flagship's
    layout at the spec's width, the state ``spec["state"]`` loaded."""
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_optimizer
    from phc_gnn_torch.train.loss import masked_l1
    model = PHCGNN(**spec["model"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["state"].items()})
    params = dict(model.named_parameters())
    opt = (Sgd(params) if spec.get("opt", "sgd") == "sgd"
           else make_optimizer(params, grad_clip=spec.get("clip", 0.0)))
    return model, opt, lambda out, b: masked_l1(out, b.y)


def batches(spec):
    """The dp batches of ``spec``: ``synthetic_batch(*shape, seed)`` for
    each seed, with their CSR plans; None stands for a fully masked
    dummy of the first."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.parallel import make_dummy_batch
    real = {s: attach_csr_plan(synthetic_batch(*spec["shape"], seed=s))
            for s in spec["seeds"] if s is not None}
    first = next(iter(real.values()))
    return [make_dummy_batch(first) if s is None else real[s]
            for s in spec["seeds"]]


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def grid_steps(rank, world, spec):
    """``spec["steps"]`` train steps of the ``(dp, ep)`` mesh, then the eval
    forward; rank (d, e) holds shard e of dp batch d.  Returns the losses,
    the train outputs, the eval output and the state after the steps."""
    from phc_gnn_torch import parallel as P
    dp, ep = spec["mesh"]
    mesh = P.make_mesh(dp, ep, "gloo")
    model, opt, loss_fn = build(spec)
    if ep > 1:
        model.set_node_axis("ep")
    d, e = divmod(rank, ep)
    mine = batches(spec)[d]
    if ep > 1:
        mine = P.partition_nodes(mine, ep)[e]
    scan = spec.get("scan", False)
    if dp > 1 and ep > 1:
        make = (P.make_scan_dp_np_train_steps if scan
                else P.make_dp_np_train_step)
    elif dp > 1:
        make = P.make_scan_dp_train_steps if scan else P.make_dp_train_step
    else:
        make = P.make_scan_np_train_steps if scan else P.make_np_train_step
    kw = {"loss_name": "l1"} if dp > 1 else {}
    step = make(model, opt, loss_fn, mesh, weight_decay=spec.get("wd", 0.0),
                device="cpu", **kw)
    steps = spec.get("steps", 1)
    if scan:
        losses, outs = step([mine] * steps, spec["lr"])
    else:
        losses, outs = zip(*(step(mine, spec["lr"]) for _ in range(steps)))
    losses = [float(x) for x in losses]
    outs = [o.numpy().copy() for o in outs]
    state = _state(model)
    evaluate = (P.make_np_eval_step if dp == 1 else
                P.make_dp_np_eval_step if ep > 1 else P.make_dp_eval_step)
    out_eval = evaluate(model, mesh, device="cpu")(mine)
    return dict(losses=losses, outs=outs, state=state,
                eval=out_eval.numpy().copy())


def cases(rank, world, spec):
    """Each case of ``spec["cases"]``, ``(case name, its spec)``, in turn on
    the same ranks: one start of the processes for several checks."""
    return [globals()[name](rank, world, sub) for name, sub in spec["cases"]]


def halo_roundtrip(rank, world, spec):
    """``halo_exchange`` over ``world`` shards of one batch and its
    backward, against the gather it stands for: returns this shard's
    received rows and the gradient of ``sum(received * weights)``."""
    from phc_gnn_torch import parallel as P
    mesh = P.make_mesh(1, world, "gloo")
    from phc_gnn_torch.data import synthetic_batch
    shard = P.partition_nodes(synthetic_batch(*spec["shape"], seed=0),
                              world)[rank]
    rng = np.random.default_rng(rank)
    x = torch.tensor(rng.normal(size=(shard.num_nodes, 5)),
                     dtype=torch.float32, requires_grad=True)
    got = P.halo_exchange(x, shard.halo_send, mesh.ep)
    w = torch.tensor(np.random.default_rng(100 + rank).normal(
        size=tuple(got.shape)), dtype=torch.float32)
    (got * w).sum().backward()
    return dict(x=x.detach().numpy(), halo_send=shard.halo_send.numpy(),
                got=got.detach().numpy(), w=w.numpy(), dx=x.grad.numpy())


def composite_inputs(spec):
    """The composites' inputs of ``spec``, whole, as numpy: messages
    [E, D], logits, receivers over ``N`` nodes, an edge mask and the
    cotangent of the softmax aggregate, from ``spec["seed"]``."""
    rng = np.random.default_rng(spec["seed"])
    e, n, d = spec["edges"], spec["nodes"], spec["dim"]
    return dict(m=rng.normal(size=(e, d)).astype(np.float32),
                logits=rng.normal(size=(e, d)).astype(np.float32),
                recv=np.sort(rng.integers(0, n, size=e)).astype(np.int32),
                mask=rng.random(e) > 0.2,
                w=rng.normal(size=(n, d)).astype(np.float32))


def composites(rank, world, spec):
    """graph/segment.py's and graph/aggregators.py's composites over the
    ``ep`` axis of a ``(1, world)`` mesh, this rank holding edge slice
    ``rank``: the six aggregations, the degrees, the softmax weights and
    the softmax aggregate with its gradients in the messages and beta (of
    ``sum(out * w)``), in float32, and the sum and the softmax aggregate on
    bfloat16 messages; and whether the max's backward raises (pmax has no
    derivative)."""
    from phc_gnn_torch import parallel as P
    from phc_gnn_torch.graph import aggregators as agg
    from phc_gnn_torch.graph import segment as seg
    from phc_gnn_torch.parallel import mesh as mesh_lib
    grid = P.make_mesh(1, world, "gloo")
    data = composite_inputs(spec)
    n = spec["nodes"]
    per = spec["edges"] // world
    cut = slice(rank * per, (rank + 1) * per)
    recv = torch.from_numpy(data["recv"][cut])
    mask = torch.from_numpy(data["mask"][cut])
    out = {}
    beta = torch.tensor(0.7)
    with mesh_lib.bind(grid):
        for dt in ("float32", "bfloat16"):
            m = torch.from_numpy(data["m"][cut]).to(getattr(torch, dt))
            names = (agg.AGGREGATORS if dt == "float32" else ("sum",))
            for name in names:
                out[f"{name}/{dt}"] = agg.AGGREGATORS[name](
                    m, recv, n, mask, axis_name="ep")
            out[f"softmax_aggregate/{dt}"] = agg.softmax_aggregate(
                m, recv, n, beta, mask, axis_name="ep")
        m = torch.from_numpy(data["m"][cut]).requires_grad_()
        beta.requires_grad_()
        y = agg.softmax_aggregate(m, recv, n, beta, mask, axis_name="ep")
        (y * torch.from_numpy(data["w"])).sum().backward()
        out["softmax_dm"] = m.grad
        out["softmax_dbeta"] = beta.grad
        logits = torch.from_numpy(data["logits"][cut])
        out["softmax_weights"] = seg.segment_softmax_weights(
            logits, recv, n, mask, axis_name="ep")
        out["degrees"] = agg.node_degrees(recv, n, mask, axis_name="ep")
        x = torch.from_numpy(data["m"][cut]).requires_grad_()
        try:
            seg.segment_max(x, recv, n, mask, axis_name="ep").sum().backward()
            out["max_backward"] = "ran"
        except NotImplementedError as err:
            out["max_backward"] = str(err)
    return {k: v if isinstance(v, str) else v.detach().float().numpy()
            for k, v in out.items()}


def replicated(rank, world, spec):
    """The replicated scheme on the ``(dp, ep)`` mesh of ``spec``: rank
    (d, e) holds ``edge_shard(batch_d, ep, e)``, the model's edges over
    ep.  Without ``spec["eval_only"]``: this rank's raw gradient (before
    the mean over ep, from a copy of the model), one train step, then the
    eval; with it, the eval of the state alone."""
    import copy

    from phc_gnn_torch import parallel as P
    from phc_gnn_torch.parallel import mesh as mesh_lib
    from phc_gnn_torch.train.state import make_loss_and_grads
    dp, ep = spec["mesh"]
    grid = P.make_mesh(dp, ep, "gloo")
    model, opt, loss_fn = build(spec)
    model.set_edge_axis("ep")
    d, e = divmod(rank, ep)
    mine = P.edge_shard(batches(spec)[d], ep, e)
    evaluate = P.make_ep_eval_step if dp == 1 else P.make_dp_ep_eval_step
    if spec.get("eval_only"):
        return dict(eval=evaluate(model, grid, device="cpu")(mine).numpy())
    twin = copy.deepcopy(model)
    with mesh_lib.bind(grid):
        _, _, raw = make_loss_and_grads(twin, loss_fn, spec["wd"])(
            mine, spec["lr"])
    kw = {"loss_name": "l1"} if dp > 1 else {}
    make = P.make_ep_train_step if dp == 1 else P.make_dp_ep_train_step
    step = make(model, opt, loss_fn, grid, weight_decay=spec["wd"],
                device="cpu", **kw)
    loss, out = step(mine, spec["lr"])
    return dict(losses=[float(loss)], out=out.numpy().copy(),
                raw={k: g.numpy().copy() for k, g in raw.items()},
                state=_state(model),
                eval=evaluate(model, grid, device="cpu")(mine).numpy())


def count_np_step(rank, world, spec):
    """One np step of the halo scheme (2 layers of the flagship's layout)
    with ``torch.distributed``'s ``all_reduce`` and ``all_to_all_single``
    wrapped to record each call's bytes: returns the calls in order, the
    model's parameter count and the widths of its norms that reduce over
    the shards."""
    from phc_gnn_torch import parallel as P
    grid = P.make_mesh(1, world, "gloo")
    model, opt, loss_fn = build(spec)
    model.set_node_axis("ep")
    shard = P.partition_nodes(batches(spec)[0], world)[rank]
    step = P.make_np_train_step(model, opt, loss_fn, grid,
                                weight_decay=spec["wd"], device="cpu")
    calls = []
    real = {"all_reduce": dist.all_reduce,
            "all_to_all_single": dist.all_to_all_single}

    def wrap(name):
        def collective(t, *args, **kw):
            calls.append((name, t.numel() * t.element_size()))
            return real[name](t, *args, **kw)
        return collective

    try:
        for name in real:
            setattr(dist, name, wrap(name))
        step(shard, spec["lr"])
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    norms = [m.mean.numel() for m in model.modules()
             if type(m).__name__ == "_BatchNorm" and m.stat_axis == "ep"]
    return dict(calls=calls, params=sum(p.numel() for p in
                                        model.parameters()),
                norms=norms, num_graphs=shard.num_graphs)


def stress_steps(rank, world, spec):
    """``cli.stress.rank_steps`` on this rank: one step of each scheme on
    each mesh of ``world`` ranks that the stress command runs."""
    from phc_gnn_torch.cli import stress
    return stress.rank_steps(rank, world, "cpu")
