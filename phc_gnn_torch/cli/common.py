"""Shared command line of the port's training and inference entry points:
the counterpart of benchmarks/common.py:52-309.

The same flags, names and defaults as the JAX package's CLI for the seven
datasets (the reference's per-script argparse surface,
benchmarks/train_hiv.py:43-159), plus ``--device`` (default ``cuda``).
Datasets are read by the port's dependency-free readers from
``--data_root``; the buckets are sized as JAX sizes them; a batch carries
its CSR plans where the model's kernels read them (``use_csr_plan``): not
under ``--agg_kernel xla``, the composite route, nor under ``--ep``.
``run_benchmark`` writes ``run.log``, ``params.json``, ``summary.json``
and, per run, ``scalars.jsonl``, ``val_test.json`` and the checkpoints
under ``--save_dir``.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

from phc_gnn_torch.data import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
    ZINC_ATOM_DIMS,
    ZINC_BOND_DIMS,
    PaddedLoader,
    add_zeros,
    avg_deg_from_histogram,
    compute_bucket_spec,
    concat_x_pos,
    dataset_stats,
    degree_histogram,
    extract_node_feature,
    load_npz_dataset,
    load_ogb_graphproppred,
    random_graph,
    remove_isolated_nodes,
)
from phc_gnn_torch.data.features import (
    CIFAR10_ATOM_DIM,
    CIFAR10_BOND_DIM,
    MNIST_ATOM_DIM,
    MNIST_BOND_DIM,
    PPA_EDGE_DIM,
)
from phc_gnn_torch.data.transforms import (add_virtual_node,
                                           grow_vocab_for_virtual_node)
from phc_gnn_torch.parallel.multihost import (initialize, is_primary,
                                              world_from_env)
from phc_gnn_torch.train.config import DATASET_DEFAULTS, ExperimentConfig
from phc_gnn_torch.train.trainer import Trainer, build_model
from phc_gnn_torch.utils.logging import set_logging

__all__ = ["DATASETS", "RANK_BACKENDS", "get_parser", "str2bool", "config_from_args",
           "label_dim", "load_splits", "prepare", "use_csr_plan",
           "build_trainer", "run_benchmark"]

log = logging.getLogger("phc_gnn_torch")

DATASETS = tuple(DATASET_DEFAULTS)
# the process group's backend of the ranks of --dp x --ep > 1, by --device
RANK_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def str2bool(v) -> bool:
    """(reference: benchmarks/utils.py:29-35)"""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def _int_list(s: str):
    return tuple(int(x) for x in str(s).split(",") if x != "")


def _float_list(s: str):
    return tuple(float(x) for x in str(s).split(",") if x != "")


def get_parser(dataset: str) -> argparse.ArgumentParser:
    d = DATASET_DEFAULTS[dataset]
    cfg = ExperimentConfig(dataset=dataset, **d)
    p = argparse.ArgumentParser(
        description=f"phc_gnn_torch: train on {dataset}")
    # data / bookkeeping
    p.add_argument("--data_root", type=str, default=os.environ.get(
        "PHC_DATA_ROOT", "data"))
    p.add_argument("--save_dir", type=str, default=f"experiments/{dataset}")
    p.add_argument("--n_runs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_weights", type=str2bool, default=False)
    p.add_argument("--init_from", type=str, default="",
                   help="warm-start params from a pickled flax params "
                        "tree of numpy arrays (the running stats stay fresh)")
    p.add_argument("--batch_size", type=int, default=cfg.batch_size)
    p.add_argument("--eval_batch_size", type=int,
                   default=cfg.eval_batch_size)
    p.add_argument("--max_nodes", type=int, default=cfg.max_nodes)
    p.add_argument("--max_edges", type=int, default=cfg.max_edges)
    p.add_argument("--sub_buckets", type=int, default=1,
                   help="bucket-ladder depth: keep this many halving bucket "
                   "sizes and emit each batch at the smallest that fits "
                   "(cuts padding waste)")
    # model topology
    p.add_argument("--type", dest="model_type", type=str,
                   default=cfg.model_type, choices=["add", "concat"])
    p.add_argument("--phm_dim", type=int, default=cfg.phm_dim)
    p.add_argument("--learn_phm", type=str2bool, default=cfg.learn_phm)
    p.add_argument("--unique_phm", type=str2bool, default=cfg.unique_phm)
    p.add_argument("--input_embed_dim", type=int, default=cfg.input_embed_dim)
    p.add_argument("--mp_units", type=_int_list, default=tuple(cfg.mp_units))
    p.add_argument("--d_units", type=_int_list, default=tuple(cfg.d_units))
    p.add_argument("--mlp_mp", type=str2bool, default=cfg.mlp_mp)
    p.add_argument("--sc_type", type=str, default=cfg.sc_type,
                   choices=["first", "last"])
    p.add_argument("--pooling", type=str, default=cfg.pooling,
                   choices=["globalsum", "softattention"])
    p.add_argument("--real_trafo", type=str, default=cfg.real_trafo,
                   choices=["linear", "sum", "mean", "norm"])
    p.add_argument("--naive_encoder", type=str2bool, default=cfg.naive_encoder)
    p.add_argument("--target_dim", type=int, default=cfg.target_dim)
    p.add_argument("--virtual_node", type=str2bool, default=False)
    # init
    p.add_argument("--w_init", type=str, default=cfg.w_init,
                   choices=["phm", "glorot-normal", "glorot-uniform"])
    p.add_argument("--c_init", type=str, default=cfg.c_init,
                   choices=["standard", "random"])
    # regularization
    p.add_argument("--dropout_mpnn", type=_float_list,
                   default=tuple(cfg.dropout_mpnn))
    p.add_argument("--dropout_dn", type=_float_list,
                   default=tuple(cfg.dropout_dn))
    p.add_argument("--same_dropout", type=str2bool, default=cfg.same_dropout)
    p.add_argument("--weightdecay", type=float, default=cfg.weightdecay)
    p.add_argument("--weightdecay2", type=float, default=cfg.weightdecay2)
    p.add_argument("--regularization", type=int, default=cfg.regularization,
                   choices=[1, 2])
    p.add_argument("--grad_clipping", type=float, default=cfg.grad_clipping)
    p.add_argument("--norm_mp", type=str, default=cfg.norm_mp or "None")
    p.add_argument("--norm_dn", type=str, default=cfg.norm_dn or "None")
    # aggregation
    p.add_argument("--aggr_msg", type=str, default=cfg.aggr_msg,
                   choices=["add", "sum", "mean", "min", "max", "softmax", "pna"])
    p.add_argument("--aggr_node", type=str, default=cfg.aggr_node)
    p.add_argument("--msg_encoder", type=str, default=cfg.msg_encoder)
    p.add_argument("--initial_beta", type=float, default=cfg.initial_beta)
    p.add_argument("--learn_beta", type=str2bool, default=cfg.learn_beta)
    # optimization
    p.add_argument("--epochs", type=int, default=cfg.epochs)
    p.add_argument("--lr", type=float, default=cfg.lr)
    p.add_argument("--patience", type=int, default=cfg.patience)
    p.add_argument("--factor", type=float, default=cfg.factor)
    p.add_argument("--min_lr", type=float, default=cfg.min_lr)
    p.add_argument("--max_time", dest="max_time_hours", type=float,
                   default=cfg.max_time_hours)
    p.add_argument("--scan_chunk", type=int, default=getattr(cfg, "scan_chunk", 0))
    p.add_argument("--grad_accum", type=int,
                   default=getattr(cfg, "grad_accum", 1),
                   help="accumulate exact weighted grads over K same-shape "
                        "sub-batches before one optimizer step")
    # multi-rank (no reference counterpart): one process a rank
    p.add_argument("--dp", type=int, default=cfg.dp,
                   help="data-parallel mesh axis (ranks)")
    p.add_argument("--ep", type=int, default=cfg.ep,
                   help="graph-parallel mesh axis (ranks)")
    p.add_argument("--ep_scheme", type=str, default=cfg.ep_scheme,
                   choices=["halo", "replicated"],
                   help="graph-parallel design: node-sharded halo exchange "
                        "(north star) or replicated-node edge partitioning")
    p.add_argument("--resume", action="store_true",
                   help="resume each run from its latest checkpoint")
    p.add_argument("--agg_kernel", type=str, default=cfg.agg_kernel,
                   choices=["auto", "stream", "xla"],
                   help="segment aggregation: auto and stream run the CUDA "
                        "kernels over the CSR plans; xla the plain PyTorch "
                        "composites, with no plan")
    p.add_argument("--profile_steps", type=int, default=cfg.profile_steps,
                   help=">0: torch.profiler trace of K train steps written "
                        "to run_dir/profile")
    p.add_argument("--compute_dtype", type=str, default=cfg.compute_dtype,
                   choices=["f32", "bf16"],
                   help="activation compute dtype; parameters and the "
                        "optimizer state stay f32")
    p.add_argument("--rng_impl", type=str, default=cfg.rng_impl,
                   choices=["threefry2x32", "rbg"],
                   help="JAX's dropout PRNG; not read by the port")
    # activation
    p.add_argument("--activation", type=str, default=cfg.activation,
                   choices=["relu", "lrelu", "elu", "selu", "swish"])
    # the port's additions
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="where to train: cuda (raises without a card; with "
                        "dp*ep > 1 one GPU a rank, cuda:<local rank>, over "
                        "NCCL) or cpu (with dp*ep > 1 over gloo)")
    return p


def label_dim(cfg: ExperimentConfig) -> int:
    """Stored label width per graph: CE keeps a single integer class id while
    the model emits cfg.target_dim logits."""
    return 1 if cfg.loss == "ce" else cfg.target_dim


def config_from_args(dataset: str, args) -> ExperimentConfig:
    """``DATASET_DEFAULTS[dataset]`` over ``ExperimentConfig``'s defaults,
    then every parsed flag that names a field."""
    d = dict(DATASET_DEFAULTS[dataset])
    cfg = ExperimentConfig(dataset=dataset, **d)
    for f in vars(args):
        if hasattr(cfg, f) and getattr(args, f) is not None:
            setattr(cfg, f, getattr(args, f))
    cfg.norm_mp = None if cfg.norm_mp in ("None", None) else cfg.norm_mp
    cfg.norm_dn = None if cfg.norm_dn in ("None", None) else cfg.norm_dn
    return cfg


# ---------------- dataset wiring ----------------

_OGB_DIRS = {"hiv": "ogbg_molhiv", "pcba": "ogbg_molpcba", "ppa": "ogbg_ppa"}
_OGB_SPLITS = {"hiv": "scaffold", "pcba": "scaffold", "ppa": "species"}


def load_splits(dataset: str, data_root: str, ppa_mode: str = "zeros"):
    """Return (splits dict, atom_input_dims, bond_input_dims, transform)."""
    if dataset in _OGB_DIRS:
        root = os.path.join(data_root, _OGB_DIRS[dataset])
        splits = load_ogb_graphproppred(root, _OGB_SPLITS[dataset])
        if dataset == "ppa":
            tf = (add_zeros if ppa_mode == "zeros"
                  else functools.partial(extract_node_feature, reduce="add"))
            splits = {k: [tf(g) for g in v] for k, v in splits.items()}
            atom_dims = [1] if ppa_mode == "zeros" else PPA_EDGE_DIM
            return splits, atom_dims, PPA_EDGE_DIM, remove_isolated_nodes
        return splits, ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS, remove_isolated_nodes
    if dataset == "zinc":
        splits = load_npz_dataset(data_root, "zinc")
        return splits, ZINC_ATOM_DIMS, ZINC_BOND_DIMS, None
    if dataset == "synthetic":
        rng = np.random.default_rng(0)
        splits = {
            "train": [random_graph(rng, target_dim=1) for _ in range(4096)],
            "valid": [random_graph(rng, target_dim=1) for _ in range(512)],
            "test": [random_graph(rng, target_dim=1) for _ in range(512)],
        }
        return splits, ZINC_ATOM_DIMS, ZINC_BOND_DIMS, None
    if dataset in ("mnist", "cifar10"):
        splits = load_npz_dataset(data_root, dataset)
        splits = {k: [concat_x_pos(g) for g in v] for k, v in splits.items()}
        atom = MNIST_ATOM_DIM if dataset == "mnist" else CIFAR10_ATOM_DIM
        bond = MNIST_BOND_DIM if dataset == "mnist" else CIFAR10_BOND_DIM
        return splits, atom, bond, None
    raise ValueError(f"unknown dataset {dataset!r}")


def prepare(dataset: str, args, cfg: ExperimentConfig) -> dict:
    """Everything a run reads besides the model: the splits (with the
    virtual node where asked), the encoders' input dims, the per-graph
    transform, PNA's ``avg_deg``, and the train and eval buckets, sized as
    benchmarks/common.py sizes them."""
    splits, atom_dims, bond_dims, transform = load_splits(
        dataset, args.data_root)
    if getattr(args, "virtual_node", False):
        vt = functools.partial(
            add_virtual_node,
            atom_vocab_sizes=(list(atom_dims)
                              if not isinstance(atom_dims, int) else None),
            bond_vocab_sizes=(list(bond_dims)
                              if not isinstance(bond_dims, int) else None))
        splits = {k: [vt(g) for g in v] for k, v in splits.items()}
        atom_dims = grow_vocab_for_virtual_node(atom_dims)
        bond_dims = grow_vocab_for_virtual_node(bond_dims)
    log.info("train stats: %s", dataset_stats(splits["train"]))
    avg_deg = None
    if cfg.aggr_msg == "pna":
        avg_deg = avg_deg_from_histogram(degree_histogram(splits["train"]))
        log.info("pna avg_deg: %s", avg_deg)
    ld = label_dim(cfg)
    bucket = compute_bucket_spec(splits["train"], cfg.batch_size,
                                 target_dim=ld)
    if cfg.max_nodes:
        bucket.num_nodes = cfg.max_nodes
    if cfg.max_edges:
        bucket.num_edges = cfg.max_edges
    log.info("bucket: %s", bucket)
    eval_bs = cfg.eval_batch_size or cfg.batch_size
    eval_bucket = compute_bucket_spec(
        splits["valid"] + splits["test"], eval_bs, target_dim=ld)
    return dict(splits=splits, atom_dims=atom_dims, bond_dims=bond_dims,
                transform=transform, avg_deg=avg_deg, bucket=bucket,
                eval_bucket=eval_bucket)


def use_csr_plan(cfg) -> bool:
    """Whether the loaders attach the CSR plans: where the model reads them,
    on the plan route (``agg_kernel`` "auto" or "stream") without ep, as
    JAX attaches its scan plans (benchmarks/common.py:283-290); the ep
    schemes cut their shards from the raw batch."""
    return cfg.agg_kernel != "xla" and cfg.ep == 1


def build_trainer(dataset: str, args, device=None) -> Trainer:
    """The ``Trainer`` of the parsed ``args`` on ``device`` (default
    ``--device``): the splits' loaders, run 1's model and the per-run
    re-seeded starts; ``save_dir`` and its ``run.log`` are made.  ``trainer.evaluate(
    trainer.valid_batches())`` scores the model's current weights as a
    run's epochs do."""
    cfg = config_from_args(dataset, args)
    os.makedirs(cfg.save_dir, exist_ok=True)
    # the primary rank alone keeps run.log; the others log to stdout
    set_logging(os.path.join(cfg.save_dir, "run.log") if is_primary()
                else None, logging.INFO if is_primary() else logging.WARNING)
    log.info("config: %s", cfg.to_json())
    d = prepare(dataset, args, cfg)
    splits, transform = d["splits"], d["transform"]
    plan = use_csr_plan(cfg)

    def train_batches(seed):
        return PaddedLoader(splits["train"], d["bucket"], shuffle=True,
                            seed=seed, transform=transform, csr_plan=plan,
                            sub_buckets=cfg.sub_buckets)

    def valid_batches():
        return PaddedLoader(splits["valid"], d["eval_bucket"],
                            transform=transform, csr_plan=plan)

    def test_batches():
        return PaddedLoader(splits["test"], d["eval_bucket"],
                            transform=transform, csr_plan=plan)

    def build(seed):
        return build_model(cfg, d["atom_dims"], d["bond_dims"],
                           avg_deg=d["avg_deg"], seed=seed, device="cpu")

    return Trainer(cfg, build(cfg.seed), train_batches, valid_batches,
                   test_batches, device=device or args.device,
                   init_state=lambda seed: build(seed).state_dict())


def run_benchmark(dataset: str, argv=None) -> dict:
    """Parse ``argv`` (default: the process's), train ``cfg.n_runs`` runs
    on ``--device`` and return the summary.

    With ``--dp`` x ``--ep`` > 1 the training runs on that many ranks, one
    process each, over the backend that ``--device`` names
    (``RANK_BACKENDS``: NCCL for one GPU a rank, gloo for CPU tensors):
    under ``torch.distributed.run`` (its
    environment names the rank) this process is one of them; where no
    process group exists this process starts them (``torch.multiprocessing``,
    start method ``spawn``), waits for them and returns the summary that
    rank 0 wrote.  With ``--device cuda`` rank r trains on ``cuda:<local
    rank>``, so the host needs a card a rank; the kernels are built in
    this process before the ranks start."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_parser(dataset).parse_args(argv)
    world = args.dp * args.ep
    if world > 1 and not dist.is_initialized():
        env = world_from_env()
        if env is None:
            return _spawn_ranks(dataset, args, argv, world)
        if env[1] != world:
            raise ValueError(f"torch.distributed.run started {env[1]} ranks "
                             f"for --dp {args.dp} --ep {args.ep}")
        _check_cards(args, world)
        initialize(RANK_BACKENDS[args.device])
    return _train(dataset, args)


def _rank_device(args) -> str:
    """``cuda:<local rank>`` for ``--device cuda`` under a process group,
    else ``--device``."""
    if args.device != "cuda" or not dist.is_initialized():
        return args.device
    return f"cuda:{int(os.environ.get('LOCAL_RANK', dist.get_rank()))}"


def _train(dataset: str, args) -> dict:
    trainer = build_trainer(dataset, args, device=_rank_device(args))
    summary = trainer.run(resume=args.resume)
    log.info("summary: %s", summary)
    return summary


def _check_cards(args, world: int) -> None:
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise RuntimeError(
                f"--device cuda runs one rank a GPU: {world} ranks "
                f"(--dp {args.dp} --ep {args.ep}) need {world} GPUs, this "
                f"host has {have}")


def _rank_main(rank: int, dataset: str, argv, world: int, port: int,
               backend: str) -> None:
    initialize(backend, f"tcp://localhost:{port}", world, rank)
    try:
        _train(dataset, get_parser(dataset).parse_args(argv))
    finally:
        dist.destroy_process_group()


def _spawn_ranks(dataset: str, args, argv, world: int) -> dict:
    """Start ``world`` rank processes of this command and return rank 0's
    summary (``summary.json`` under ``--save_dir``)."""
    _check_cards(args, world)
    if args.device == "cuda":
        # one build, before the ranks: their first launches would race to it
        from phc_gnn_torch.ops import _build
        _build.load_all()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    backend = RANK_BACKENDS[args.device]
    log.info("starting %d ranks (dp %d x ep %d) on %s over %s", world,
             args.dp, args.ep, args.device, backend)
    torch.multiprocessing.start_processes(
        _rank_main, args=(dataset, argv, world, port, backend),
        nprocs=world, join=True, start_method="spawn")
    cfg = config_from_args(dataset, args)
    with open(os.path.join(cfg.save_dir, "summary.json")) as f:
        return json.load(f)
