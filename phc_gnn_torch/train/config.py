"""Structured experiment configuration: a copy of
phc_gnn_tpu/train/config.py (``ExperimentConfig`` with the reference's ~40
argparse flags under the same names and defaults, and ``DATASET_DEFAULTS``),
so that a configuration names the same model in both packages.  The port
reads what its counterparts do: ``train.trainer.build_model`` the model's
fields and ``agg_kernel`` ("xla" puts the model on the composite route,
"auto" and "stream" on the plan route, the port's counterpart of
"stream"); the Trainer ``scan_chunk``, ``grad_accum``, ``prefetch_depth``,
``dp``, ``ep`` and ``ep_scheme``; the CLI the data fields.  ``rng_impl``
(JAX's choice of PRNG) is kept for the copy's sake and not read.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

__all__ = ["ExperimentConfig", "DATASET_DEFAULTS"]


@dataclass
class ExperimentConfig:
    # bookkeeping
    dataset: str = "zinc"          # zinc|hiv|pcba|ppa|mnist|cifar10|synthetic
    save_dir: str = "experiments/run"
    n_runs: int = 1
    seed: int = 0
    log_weights: bool = False
    init_from: str = ""            # warm-start: path to a pickled params
                                   # pytree (e.g. weights transplanted from
                                   # the torch reference for convergence
                                   # parity, scripts/run_convergence_parity.py)

    # device/data
    batch_size: int = 128
    eval_batch_size: Optional[int] = None
    # padding bucket sizes (TPU-specific; None = auto from dataset stats)
    max_nodes: Optional[int] = None
    max_edges: Optional[int] = None
    sub_buckets: int = 1  # bucket-ladder depth (data/loader.py): halving
    # node/edge budgets, each batch emitted at the smallest bucket it fits

    # model topology
    model_type: str = "add"        # add | concat  (PHMSkipConnect*)
    phm_dim: int = 4
    learn_phm: bool = True
    unique_phm: bool = False
    input_embed_dim: int = 200     # atom_encoded_dim (flat)
    mp_units: Sequence[int] = (200, 200)
    d_units: Sequence[int] = (128, 64)   # downstream layers
    mlp_mp: bool = True
    sc_type: str = "first"
    pooling: str = "softattention"
    real_trafo: str = "linear"
    naive_encoder: bool = False
    target_dim: int = 1

    # init
    w_init: str = "phm"
    c_init: str = "standard"

    # regularization
    dropout_mpnn: Sequence[float] = (0.1, 0.1)
    dropout_dn: Sequence[float] = (0.2, 0.1)
    same_dropout: bool = False
    weightdecay: float = 0.0       # PHM weight reg coefficient
    weightdecay2: float = 0.0      # rule reg coefficient
    regularization: int = 2        # p-norm for weight reg
    grad_clipping: float = 2.0
    norm_mp: Optional[str] = "naive-batch-norm"
    norm_dn: Optional[str] = "naive-batch-norm"

    # aggregation
    aggr_msg: str = "softmax"      # add|sum|mean|min|max|softmax|pna
    aggr_node: str = "sum"
    msg_encoder: str = "identity"
    initial_beta: float = 1.0
    learn_beta: bool = True

    # optimization
    epochs: int = 50
    lr: float = 5e-4
    patience: int = 10
    factor: float = 0.75
    min_lr: float = 1e-6
    max_time_hours: float = 0.0    # 0 = unlimited (BGNN stopping rule)
    scheduler_mode: str = "max"    # max (auc/ap/acc) | min (mae)
    metric: str = "mae"            # rocauc|ap|acc|mae
    loss: str = "l1"               # bce|ce|l1|mse

    # activation
    activation: str = "relu"

    # parallelism / dispatch
    dp: int = 1                    # data-parallel mesh axis (devices)
    ep: int = 1                    # graph-parallel mesh axis (devices)
    ep_scheme: str = "halo"        # graph-parallel design: halo (node-sharded
                                   # + boundary exchange) | replicated
    agg_kernel: str = "auto"       # segment aggregation kernel: auto (JAX:
                                   # stream on TPU, xla elsewhere; the port:
                                   # the plan route) | stream | xla
    compute_dtype: str = "f32"     # activation compute dtype: f32 | bf16
                                   # (params/BN stats stay f32; measured
                                   # -3.5% step time on TPU v5e, KERNELS.md)
    rng_impl: str = "rbg"          # dropout PRNG: rbg (TPU hardware RNG —
                                   # measured 0.2 ms/step faster mask
                                   # generation, same Bernoulli statistics;
                                   # param-init keys always stay threefry)
                                   # | threefry2x32 (jax default)
    num_devices: int = 1           # deprecated alias; use dp
    grad_accum: int = 1            # >1: accumulate exact weighted grads over
                                   # K same-shape sub-batches, one optimizer
                                   # step (dp over time — keeps big logical
                                   # batches, e.g. pcba's 512 graphs, inside
                                   # VMEM-sized gather tables; KERNELS.md
                                   # round-3 cliff analysis)
    scan_chunk: int = 0            # >0: scan this many same-shape train steps
                                   # inside one jit call (kills dispatch overhead)
    prefetch_depth: int = 2        # background-prefetched batches (0 = off)
    profile_steps: int = 0         # >0: write a jax.profiler trace of the
                                   # first K train steps to run_dir/profile

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        return cls(**json.loads(text))


# Canonical per-dataset defaults (reference: benchmarks/run_script_*_phm4.sh and
# parser defaults per script; SURVEY.md section 2.3).
DATASET_DEFAULTS = {
    # Faithful to the reference scripts' parser defaults
    # (reference: benchmarks/train_*.py get_parser; SURVEY.md section 2.3).
    "zinc": dict(metric="mae", loss="l1", scheduler_mode="min", target_dim=1,
                 aggr_msg="sum", sc_type="last", batch_size=256,
                 input_embed_dim=180, mp_units=(180, 180, 180, 180),
                 dropout_mpnn=(0.0, 0.0, 0.0, 0.0), dropout_dn=(0.2, 0.1),
                 d_units=(180, 80), weightdecay=0.01, lr=1e-3, epochs=1000,
                 patience=10, factor=0.5, max_time_hours=72.0),
    "hiv": dict(metric="rocauc", loss="bce", scheduler_mode="max", target_dim=1,
                aggr_msg="softmax", input_embed_dim=200, mp_units=(200, 200),
                dropout_mpnn=(0.3, 0.1), dropout_dn=(0.3, 0.1),
                d_units=(128, 32), weightdecay=0.001, lr=5e-4, epochs=50,
                patience=10, factor=0.75, batch_size=128),
    # logical batch 512 graphs as grad_accum 4 x 128-graph 4096n/8192e
    # sub-batches: the measured-fastest single-chip recipe (KERNELS.md
    # round-4 pcba table, 2.18 M vs 1.24 M edges/s for one 16384n bucket);
    # eval keeps the 512-graph bucket (no accumulation on that path)
    "pcba": dict(metric="ap", loss="bce", scheduler_mode="max", target_dim=128,
                 aggr_msg="sum", phm_dim=2, batch_size=128, grad_accum=4,
                 max_nodes=4096, max_edges=8192, eval_batch_size=512,
                 input_embed_dim=512,
                 mp_units=(512, 512, 512, 512, 512, 512, 512), mlp_mp=False,
                 dropout_mpnn=(0.1,) * 7, dropout_dn=(0.3, 0.1),
                 d_units=(768, 256), weightdecay=1e-4, lr=5e-4, epochs=150,
                 patience=5, factor=0.75),
    "ppa": dict(metric="acc", loss="ce", scheduler_mode="max", target_dim=37,
                aggr_msg="softmax", batch_size=64, input_embed_dim=500,
                mp_units=(500, 500, 500, 500, 500),
                dropout_mpnn=(0.2,) * 5, dropout_dn=(0.2, 0.1),
                d_units=(512, 256), weightdecay=0.001, lr=1e-3, epochs=200,
                patience=10, factor=0.75),
    "mnist": dict(metric="acc", loss="ce", scheduler_mode="max", target_dim=10,
                  aggr_msg="sum", sc_type="last", batch_size=128,
                  input_embed_dim=224, mp_units=(224, 224, 224, 224),
                  dropout_mpnn=(0.1,) * 4, dropout_dn=(0.2, 0.1),
                  d_units=(256, 128), weightdecay=0.001, lr=1e-3, epochs=1000,
                  patience=10, factor=0.5, max_time_hours=72.0),
    "cifar10": dict(metric="acc", loss="ce", scheduler_mode="max", target_dim=10,
                    aggr_msg="sum", sc_type="last", batch_size=128,
                    input_embed_dim=224, mp_units=(224, 224, 224, 224),
                    dropout_mpnn=(0.1,) * 4, dropout_dn=(0.2, 0.1),
                    d_units=(256, 128), weightdecay=0.001, lr=1e-3,
                    epochs=1000, patience=10, factor=0.5,
                    max_time_hours=72.0),
    "synthetic": dict(metric="mae", loss="l1", scheduler_mode="min", target_dim=1,
                      aggr_msg="softmax", input_embed_dim=200,
                      mp_units=(200, 200, 200, 200),
                      dropout_mpnn=(0.1, 0.1, 0.1, 0.1), scan_chunk=16),
}
