"""The port's sweeps (``phc_gnn_torch.cli.scaling`` and
``phc_gnn_torch.cli.ablation``, the counterparts of scripts/bench_scaling.py
and scripts/bench_ablation.py) against the JAX reference, on the CPU.

- Each ablation variant that changes the model (its overrides from the
  port's ``VARIANTS``, applied to both sides) takes one train step at
  ``tests/test_torch_train.py``'s width (32), conv count (2) and batch
  (``synthetic_batch(8, 256, 512, seed=3)``), dropout 0, from JAX's
  randomised variables carried over by ``convert.from_flax_variables``.
  The JAX side runs its XLA composites (no ``attach_scan_plan``) and its
  two-pass batch norm, the loss of ``make_train_step``
  (``make_loss_and_aux``) differentiated by ``jax.value_and_grad``: the
  same function as its Pallas route, which ``tests/test_torch_train.py``
  holds.  The port runs each variant on its own route: the plan route's
  kernels in their plain versions over ``attach_csr_plan``'s CSRs, or, for
  ``baseline_softmax_xla``, the composites on a batch without plans.
  Tolerances are ``tests/test_torch_train.py``'s: ``REL_OUT`` 1e-5
  normwise on the loss and the output, ``REL_GRAD`` 2e-5 per leaf of the
  leaf's max; a bias that a batch norm follows has a zero gradient in
  exact arithmetic, so both sides' are held to 1e-5 of the largest
  gradient instead.  A softmax ``beta``'s gradient is one sum over every
  edge and feature whose terms cancel, so each side's f32 rounding shows
  in it: at 8 convs the last conv's parts by 6.9e-5 of its value, JAX's
  own f32 run 6.4e-5 from JAX run in float64 and the port 4.5e-6.  Where
  a ``beta`` leaf exceeds ``REL_GRAD``, it may differ by ``COND_GRAD``
  (10) times JAX's own f32 error on it against JAX run in float64
  (``jax.enable_x64``), the rule by which ``chip_smoke.py`` holds the
  card's gradients to the CPU's.
- The scaling sweep's four buckets: the port's ``synthetic_batch`` equals
  JAX's array for array, and its real edges JAX's ``count_edges()``.
- Both sweeps' ``run`` at a tiny width on the CPU print lines with the
  scripts' keys, the ablation its derived line; the variant names are the
  script's; both default to the card and load no JAX;
  ``ablation.step_launches`` equals the kernel wrappers' calls
  in one CPU step of each variant (the wrappers counted by stand-ins, the
  size gate lowered so the row-blocked norms run).
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.train import loss as jloss
from phc_gnn_tpu.train.state import make_loss_and_aux
from phc_gnn_torch.cli import ablation, scaling
from phc_gnn_torch.convert import from_flax_variables
from phc_gnn_torch.data import synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.ops import fused_bn
from phc_gnn_torch.ops import segment_softmax as ss
from phc_gnn_torch.ops import segment_sum as ssum
from phc_gnn_torch.train import loss as tloss
from phc_gnn_torch.train import make_loss_and_grads
from torch_parity import assert_close, assert_leaf_close, numpy_tree, randomize
from torch_threads import one_torch_thread  # noqa: F401

REL_OUT = 1e-5
REL_GRAD = 2e-5
NOISE = 1e-5
COND_GRAD = 10.0
NORM = "naive-batch-norm"  # PHCGNN's norm_mp and norm_dn by default
LR = 1e-3
WD = 0.1
SHAPE = (8, 256, 512)
DIM, LAYERS = 32, 2
# the ablation variants that change the model or its route
MODEL_VARIANTS = ("sum_aggr_scan", "no_norm", "no_pool_attn", "no_mlp_mp",
                  "layers_2", "layers_8", "baseline_softmax_xla")
# scripts/bench_ablation.py:79-100, in its order
SCRIPT_MAIN = ["baseline_softmax_scan", "baseline_softmax_xla",
               "sum_aggr_scan", "no_norm", "no_dropout", "no_pool_attn",
               "no_mlp_mp", "layers_2", "layers_8"]
SCRIPT_BUCKETS = ["4x_bucket_scan", "4x_bucket_xla", "4x_bucket_sum",
                  "4x_bucket_no_norm"]
# scripts/bench_scaling.py's keys a bucket
SCALING_KEYS = ("batch_size", "nodes", "edges", "ms", "real_edges",
                "edges_per_s", "edges_per_s_padded")
FIELDS = ("nodes", "edges", "senders", "receivers", "graph_ids", "node_mask",
          "edge_mask", "graph_mask", "y")


def _shift_invariant(key: str, kw: dict) -> bool:
    """Biases of the PHM layers that a batch norm follows: with the convs'
    norms the MLP's ``linear1`` and ``linear2`` (or the one ``transform``
    without the MLP), with the head's the hidden layers'."""
    conv = (kw.get("norm_mp", NORM) is not None and key.endswith(
        ("transform.linear1.b", "transform.linear2.b", "conv.transform.b")))
    head = (kw.get("norm_dn", NORM) is not None
            and key.startswith("downstream.affine_") and key.endswith(".b")
            and key != f"downstream.affine_{len(kw['downstream_layers'])}.b")
    return conv or head


@pytest.mark.parametrize("name", MODEL_VARIANTS)
def test_variant_train_step_matches_jax(name):
    """One train step of the variant: the loss, the output and every
    parameter's gradient against JAX's."""
    kw = ablation.model_kwargs(name, DIM, LAYERS, dropout=False)
    jm = JaxPHCGNN(**kw)
    jb = jax_synthetic_batch(*SHAPE, seed=3)
    v = randomize(jm.init(jax.random.key(0), jb, training=False), seed=3)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, v.get("batch_stats", {}))
    f = make_loss_and_aux(jm, lambda out, b: jloss.masked_l1(out, b.y), WD,
                          0.0, 2, stats, jb, jax.random.key(1),
                          jnp.float32(LR))
    (j_loss, (j_out, _)), j_grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)

    model = PHCGNN(**kw, composite=ablation.VARIANTS[name].route == "xla",
                   device="cpu")
    model.load_state_dict(from_flax_variables(v, model))
    batch = synthetic_batch(*SHAPE, seed=3)
    if ablation.VARIANTS[name].route == "plan":
        batch = attach_csr_plan(batch)
    loss, out, grads = make_loss_and_grads(
        model, lambda o, b: tloss.masked_l1(o, b.y), WD, 0.0, 2)(batch, LR)
    assert_close(loss, np.float32(j_loss), REL_OUT)
    assert_close(out, np.asarray(j_out), REL_OUT)
    want = _port_keys(j_grads)
    assert set(grads) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    betas = []
    for key, g in grads.items():
        if _shift_invariant(key, kw):
            assert float(g.abs().max()) <= NOISE * top, key
            assert float(np.abs(want[key]).max()) <= NOISE * top, key
        elif key.endswith(".conv.beta") and (
                abs(float(g) - float(want[key]))
                > REL_GRAD * abs(float(want[key]))):
            betas.append(key)
        else:
            assert_leaf_close(g, want[key], REL_GRAD, key)
    if betas:
        exact = _port_keys(_jax_f64_grads(jm, v, jb))
        for key in betas:
            own = abs(float(want[key]) - float(exact[key]))
            rel = max(REL_GRAD, COND_GRAD * own / abs(float(want[key])))
            assert_leaf_close(grads[key], want[key], rel, key)


def _port_keys(tree) -> dict:
    """A flax gradient tree as numpy arrays under the port's keys."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            numpy_tree(tree))[0]:
        key = ".".join(p.key for p in path)
        if key.endswith(".kernel"):  # nn.Dense (in, out) -> Linear (out, in)
            key, leaf = key[:-len("kernel")] + "weight", leaf.T
        out[key] = leaf
    return out


def _jax_f64_grads(jm, v, jb):
    """JAX's gradients of the same loss with its variables, labels and lr
    in float64."""
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        f = make_loss_and_aux(
            jm, lambda out, b: jloss.masked_l1(out, b.y), WD, 0.0, 2,
            f64(v.get("batch_stats", {})),
            jb.replace(y=jnp.asarray(jb.y, jnp.float64)), jax.random.key(1),
            jnp.float64(LR))
        return jax.jit(jax.grad(lambda p: f(p)[0]))(f64(v["params"]))


def test_scaling_buckets_match_jax_batches():
    """Each bucket of ``scaling.BUCKETS`` at full size: the port's batch
    equals JAX's array for array, and its real edges JAX's count."""
    assert scaling.BUCKETS == ((128, 4096, 8192, 110), (256, 8192, 16384, 60),
                               (512, 16384, 32768, 40),
                               (1024, 32768, 65536, 25))
    for size, nodes, edges, _ in scaling.BUCKETS:
        got = synthetic_batch(size, nodes, edges, seed=0)
        want = jax_synthetic_batch(size, nodes, edges, seed=0)
        for field in FIELDS:
            a = getattr(got, field).numpy()
            b = np.asarray(getattr(want, field))
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert got.count_edges() == int(want.count_edges())


def test_scaling_runs_small_on_the_cpu(capsys):
    """``scaling.run`` at width 16 on two tiny buckets prints a line a
    bucket with the script's keys, the roofline and the host; the rates
    follow from the ms."""
    lines = scaling.run("cpu", dim=16, layers=2,
                        buckets=((4, 128, 256, 6), (8, 256, 512, 6)))
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines and len(lines) == 2
    for line, (size, nodes, edges) in zip(lines, ((4, 128, 256),
                                                  (8, 256, 512))):
        for key in SCALING_KEYS + ("roofline_fraction", "device",
                                   "power_limit_w"):
            assert key in line, key
        assert (line["batch_size"], line["nodes"], line["edges"]) == (
            size, nodes, edges)
        assert line["real_edges"] == synthetic_batch(
            size, nodes, edges, seed=0).count_edges()
        assert line["edges_per_s"] == pytest.approx(
            line["real_edges"] / line["ms"] * 1e3)
        assert line["edges_per_s_padded"] == pytest.approx(
            edges / line["ms"] * 1e3)
        assert line["device"] == "cpu" and line["power_limit_w"] is None


def test_ablation_runs_small_on_the_cpu(capsys):
    """``ablation.run("all")`` at width 16 on buckets cut by 32 prints a line
    a variant in the script's order, the derived line after ``layers_8``
    with the script's formulas, and the 4x variants; an unknown group
    raises."""
    assert list(ablation.MAIN) == SCRIPT_MAIN
    assert list(ablation.BUCKETS) == SCRIPT_BUCKETS
    assert list(ablation.VARIANTS) == SCRIPT_MAIN + SCRIPT_BUCKETS
    lines = ablation.run("all", "cpu", dim=16, shrink=32, k1=2, k2=4, reps=1)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines
    names = [x.get("variant", x.get("derived")) for x in lines]
    assert names == SCRIPT_MAIN + ["per_conv_ms"] + SCRIPT_BUCKETS
    ms = {x["variant"]: x["ms"] for x in lines if "variant" in x}
    for line in lines:
        assert line["device"] == "cpu" and line["power_limit_w"] is None
        if "variant" in line:
            assert line["steps_per_s"] == pytest.approx(1e3 / line["ms"])
    derived = lines[len(SCRIPT_MAIN)]
    assert derived["ms"] == pytest.approx(
        (ms["layers_8"] - ms["layers_2"]) / 6)
    assert derived["fixed_ms"] == pytest.approx(
        ms["baseline_softmax_scan"] - 4 * derived["ms"])
    with pytest.raises(ValueError, match="unknown ablation group"):
        ablation.run("nope", "cpu")


def test_variant_overrides_are_the_scripts():
    """The overrides (scripts/bench_ablation.py:79-100) reach the model's
    arguments: the conv count resizes ``dropout_mpnn`` (:52-53), every conv
    at the run's width, and the 4x variants' batch is the script's."""
    base = ablation.model_kwargs("baseline_softmax_scan")
    assert base["mp_layers"] == (200,) * 4
    assert base["dropout_mpnn"] == (0.1,) * 4
    assert base["downstream_layers"] == (200, 100)
    assert ablation.model_kwargs("layers_8")["dropout_mpnn"] == (0.1,) * 8
    assert ablation.model_kwargs("layers_2", dim=16)["mp_layers"] == (16, 16)
    assert ablation.model_kwargs("no_dropout")["dropout_mpnn"] == (0.0,) * 4
    assert ablation.model_kwargs("no_norm")["norm_dn"] is None
    assert ablation.model_kwargs("no_pool_attn")["pooling"] == "globalsum"
    assert ablation.bucket("4x_bucket_sum") == (512, 16384, 32768)
    assert ablation.batch("4x_bucket_xla", shrink=32).rowptr is None
    assert ablation.batch("4x_bucket_scan", shrink=32).rowptr is not None


def test_sweeps_default_to_the_card_and_load_no_jax():
    """Both commands default to ``--device cuda`` and, without a card,
    raise unless the caller asks for the CPU; the two modules load no
    JAX."""
    if not torch.cuda.is_available():
        for module in (scaling, ablation):
            with pytest.raises(RuntimeError, match="CUDA device"):
                module.main([])
    code = ("import sys, phc_gnn_torch.cli.scaling, "
            "phc_gnn_torch.cli.ablation; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'optax', 'phc_gnn_tpu'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_step_launches_count_the_wrappers(monkeypatch):
    """``ablation.variant_launches`` of every variant equals the kernel
    wrappers' calls in one eager CPU step at width 16 on buckets cut by 32,
    with the size gate lowered to put the 4x buckets' conv norms (and not
    the 1x ones) on the row-blocked pair, as width 200 does on the card."""
    counts = {}

    def counting(module, name):
        inner = getattr(module, name)

        def wrapper(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return inner(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    for module, names in (
            (ss, ("segment_softmax_fused", "segment_softmax_backward")),
            (ssum, ("segment_sum_masked", "segment_sum_perm")),
            (fused_bn, ("bn_forward", "bn_backward", "bn_forward_blocked",
                        "bn_backward_blocked"))):
        for name in names:
            counting(module, name)
    # 1x conv norms [128, 16] stay under it, the 4x ones [512, 16] pass it
    monkeypatch.setattr(fused_bn, "FUSED_BN_VMEM_LIMIT", 128 * 16 * 4)
    for name in ablation.VARIANTS:
        counts.clear()
        model = ablation.build(name, "cpu", dim=16, dropout=False)
        make_loss_and_grads(model, lambda o, b: tloss.masked_l1(o, b.y),
                            WD, 0.0, 2)(ablation.batch(name, shrink=32), LR)
        assert counts == ablation.variant_launches(name, dim=16, shrink=32), \
            name
