"""The port's bench entry point (``python -m phc_gnn_torch.bench``) on the
CPU: every configuration of ``bench.CONFIGS`` runs small (width 16, 2
layers, its batches' graphs, nodes and edges divided by 32) and returns its
line's keys; the flagship's line keeps bench.py's keys and its roofline at
the published widths; ``main`` prints one line a configuration; the module
loads no JAX.  A CPU run times the CPU: these tests hold the keys, the
counts and how the numbers derive from each other, not the times (those
come from the card, PERF.md).
"""

import json
import subprocess
import sys

import pytest

from phc_gnn_torch import bench
from torch_threads import one_torch_thread  # noqa: F401

# the slope between 2 and 12 calls: on a CPU shared with other test
# workers, a slope over fewer calls can come out negative
SMALL = dict(dim=16, layers=2, head=(16, 8), shrink=32, k1=2, k2=12)
# every line's keys; the eval's where the configuration serves
KEYS = ("config", "steps_per_s", "step_ms", "eager_step_ms",
        "real_edges_per_batch", "sub_batches", "padded_nodes",
        "padded_edges", "dispatch_overhead_ms", "peak_mem_bytes", "backend",
        "device", "power_limit_w")
EVAL_KEYS = ("eval_ms", "eval_edges_per_s", "eager_eval_ms")
# (sub-batches of a train call, padded nodes of one, serves an eval)
SHAPES = {"flagship": (1, 128, True), "flagship-bf16": (1, 128, True),
          "concat": (1, 128, True),
          "quat-wbn": (1, 128, True), "pna": (1, 128, True),
          "pcba": (4, 128, True), "pcba-16k": (1, 512, False),
          "pcba-k2": (2, 256, False)}


def test_bench_runs_small_on_the_cpu():
    """``phc_gnn_torch.bench.run`` of the flagship at a tiny size on the
    CPU returns bench.py's keys, and the graphed and eager step and eval
    ms."""
    out = bench.run("flagship", "cpu", **SMALL)
    assert out["unit"] == "edges/s" and out["value"] > 0
    assert out["metric"] == ("edges/s (PHC-GNN n=4 train step, ZINC config, "
                             "eager, CPU)")
    detail = out["detail"]
    for key in ("steps_per_s", "step_ms", "eval_ms", "eval_edges_per_s",
                "real_edges_per_batch", "padded_nodes", "padded_edges",
                "dispatch_overhead_ms", "roofline_ms", "roofline_fraction",
                "eager_step_ms", "eager_eval_ms", "device", "power_limit_w"):
        assert key in detail, key
    assert detail["device"] == "cpu" and detail["power_limit_w"] is None
    assert (detail["padded_nodes"], detail["padded_edges"]) == (128, 256)
    assert 0 < detail["real_edges_per_batch"] <= 256
    assert detail["roofline_ms"] > 0


@pytest.mark.parametrize("name", sorted(set(bench.CONFIGS) - {"flagship"}))
def test_bench_config_runs_small_on_the_cpu(name):
    """Each other configuration at a tiny size: its train call's
    sub-batches and bucket, every line key, the eval's keys where it
    serves, and no roofline (its count is the flagship's alone)."""
    out = bench.run(name, "cpu", **SMALL)
    detail = out["detail"]
    k, nodes, serves = SHAPES[name]
    assert detail["config"] == name
    assert (detail["sub_batches"], detail["padded_nodes"]) == (k, nodes)
    assert detail["padded_edges"] == 2 * nodes
    for key in KEYS:
        assert key in detail, key
    assert all((key in detail) == serves for key in EVAL_KEYS)
    assert "roofline_fraction" not in detail and "roofline_ms" not in detail
    assert 0 < detail["real_edges_per_batch"] <= k * 2 * nodes
    assert out["value"] == pytest.approx(
        detail["real_edges_per_batch"] / detail["step_ms"] * 1e3)
    assert detail["steps_per_s"] == pytest.approx(1e3 / detail["step_ms"])


def test_flagship_roofline_at_the_published_widths():
    """The flagship's roofline is bench.py's count (:258-262) at width 200,
    4 layers, 4096 nodes and 8192 edges: 7.864e9 GEMM FLOPs and 576.7 MB of
    activation traffic, priced at 67 TFLOP/s and 3.35 TB/s."""
    want = (3 * 2 * 4 * 2 * 4096 * 200 * 200 / 67e12
            + (2 * 4 * 8 * 8192 * 200 * 4 + 2 * 4 * 6 * 4096 * 200 * 4)
            / 3.35e12) * 1e3
    assert bench._roofline_ms(200, 4, 4096, 8192) == pytest.approx(want)
    assert want == pytest.approx(0.28953, rel=1e-4)


def test_main_prints_one_line_a_configuration(monkeypatch, capsys):
    """Without ``--config`` the flagship's line alone; repeated
    ``--config`` in the order given; ``all`` every configuration.  An
    unknown name raises."""
    with pytest.raises(ValueError, match="unknown bench configuration"):
        bench.run("nope", "cpu")
    monkeypatch.setattr(bench, "run", lambda name, device: {
        "config": name, "device": device})

    def lines(argv):
        bench.main(argv)
        return [json.loads(x) for x in capsys.readouterr().out.splitlines()]

    assert lines([]) == [{"config": "flagship", "device": "cuda"}]
    assert [x["config"] for x in lines(["--config", "pcba", "--config",
                                        "concat"])] == ["pcba", "concat"]
    assert [x["config"] for x in lines(["--config", "all"])] == list(
        bench.CONFIGS)
    with pytest.raises(SystemExit):
        bench.main(["--config", "nope"])


def test_bench_imports_no_jax():
    """The bench module, and with it the port's training path, loads no
    JAX."""
    code = ("import sys, phc_gnn_torch.bench, phc_gnn_torch.train; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'phc_gnn_tpu'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
