"""The port's whole model and serving entry point against the JAX reference.

``PHCGNN.apply(training=False)`` with the scan plan (Pallas kernels A and B in
interpret mode) vs the port's ``make_eval_step`` on ``device="cpu"`` with the
CSR plan (the kernels' plain versions), on the same converted weights, with
non-trivial running stats and betas.  Tolerance: 1e-4 normwise relative for
the whole model (four layers of f32 matmuls in different orders).
"""

import jax
import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.models import PHCGNN as JaxPHCGNN
from phc_gnn_tpu.ops.stream_scan import attach_scan_plan
from phc_gnn_torch import resolve_device
from phc_gnn_torch.convert import from_flax_params, from_flax_variables
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.graph import attach_csr_plan
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.train import make_eval_step
from torch_parity import (assert_close, load_flax, numpy_tree, port_flat,
                          randomize)

REL = 1e-4


def _config(dim, layers, **over):
    """The flagship configuration (bench.py:140-146) at width ``dim``."""
    cfg = dict(phm_dim=4, atom_input_dims=ZINC_ATOM_DIMS,
               bond_input_dims=ZINC_BOND_DIMS, atom_encoded_dim=dim,
               mp_layers=(dim,) * layers, dropout_mpnn=(0.1,) * layers,
               downstream_layers=(dim, dim // 2), target_dim=1,
               dropout_dn=(0.2, 0.1), msg_aggr="softmax", mlp_mp=True,
               sc_type="last")
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("sc_type,plan,pooling", [
    ("last", True, "softattention"), ("first", True, "softattention"),
    ("last", False, "softattention"), ("last", True, "globalsum")])
def test_eval_forward_matches_jax(sc_type, plan, pooling):
    cfg = _config(32, 2, sc_type=sc_type, pooling=pooling)
    jm = JaxPHCGNN(**cfg)
    jb = jax_synthetic_batch(8, 256, 512, seed=3)
    tb = synthetic_batch(8, 256, 512, seed=3)
    if plan:
        jb, tb = attach_scan_plan(jb), attach_csr_plan(tb)
    v = randomize(jm.init(jax.random.key(0), jb, training=False), seed=3)
    want = np.asarray(jm.apply(v, jb, training=False))
    model = load_flax(PHCGNN(**cfg, device="cpu"), v)
    got = make_eval_step(model, device="cpu")(tb)
    assert got.shape == want.shape == (9, 1)
    assert_close(got, want, REL)


def test_converter_maps_every_flagship_key():
    """Width 200, 4 layers, the flagship config: every flax leaf lands on a
    port entry of the same shape; a missing, extra or mis-shaped leaf
    raises."""
    cfg = _config(200, 4)
    jb = attach_scan_plan(jax_synthetic_batch(4, 128, 256, seed=0))
    v = numpy_tree(JaxPHCGNN(**cfg).init(jax.random.key(0), jb, training=False))
    model = PHCGNN(**cfg, device="cpu")
    sd = from_flax_variables(v, model)
    n_leaves = sum(len(jax.tree_util.tree_leaves(v[c])) for c in v)
    assert len(sd) == n_leaves == len(model.state_dict())
    for key, ref in model.state_dict().items():
        assert sd[key].shape == ref.shape, key
    np.testing.assert_array_equal(sd["pooling.real_trafo.affine.weight"].numpy(),
                                  v["params"]["pooling"]["real_trafo"]["affine"]["kernel"].T)
    model.load_state_dict(sd)

    missing = randomize(v)
    del missing["params"]["conv_2"]["conv"]["beta"]
    with pytest.raises(KeyError, match="conv_2.conv.beta"):
        from_flax_variables(missing, model)
    extra = randomize(v)
    extra["params"]["conv_0"]["conv"]["gamma"] = np.float32(1.0)
    with pytest.raises(KeyError, match="conv_0.conv.gamma"):
        from_flax_variables(extra, model)
    wrong = randomize(v)
    wrong["batch_stats"]["norm_1"]["bn"]["var"] = np.ones((4, 49), np.float32)
    with pytest.raises(ValueError, match="norm_1.bn.var"):
        from_flax_variables(wrong, model)


def test_converter_params_only_keeps_buffers():
    """``from_flax_params`` (the trainer's ``init_from``): a flax params
    tree without ``batch_stats`` fills every parameter and keeps the
    model's own running stats, as JAX's warm start keeps its fresh ones;
    the model's forward then equals JAX's at those params and stats.  A
    missing or mis-shaped parameter raises."""
    cfg = _config(32, 2)
    jm = JaxPHCGNN(**cfg)
    jb = jax_synthetic_batch(8, 256, 512, seed=3)
    v = randomize(jm.init(jax.random.key(0), jb, training=False), seed=5)
    model = PHCGNN(**cfg, device="cpu")
    with torch.no_grad():
        for b in model.buffers():
            b.uniform_(0.5, 1.5)
    own = {k: b.clone() for k, b in model.named_buffers()}
    with pytest.raises(KeyError):
        from_flax_variables({"params": v["params"]}, model)
    sd = from_flax_params(v["params"], model)
    assert list(sd) == list(model.state_dict())
    for k, b in own.items():
        assert torch.equal(sd[k], b), k
    flat = port_flat(v["params"])
    assert sorted(flat) == sorted(k for k, _ in model.named_parameters())
    for k, leaf in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), leaf, err_msg=k)
    model.load_state_dict(sd)
    stats = {}
    for k, b in own.items():
        *path, leaf = k.split(".")
        node = stats
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = b.numpy()
    want = np.asarray(jm.apply({"params": v["params"], "batch_stats": stats},
                               jb, training=False))
    assert_close(make_eval_step(model, device="cpu")(synthetic_batch(
        8, 256, 512, seed=3)), want, REL)
    missing = randomize(v)["params"]
    del missing["conv_1"]["conv"]["beta"]
    with pytest.raises(KeyError, match="conv_1.conv.beta"):
        from_flax_params(missing, model)
    wrong = randomize(v)["params"]
    wrong["pooling"]["real_trafo"]["affine"]["kernel"] = np.ones((3, 3),
                                                                 np.float32)
    with pytest.raises(ValueError, match="pooling.real_trafo.affine.weight"):
        from_flax_params(wrong, model)


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(32, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PHCGNN(**cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    model = PHCGNN(**cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_step(model)
    out = make_eval_step(model, device="cpu")(synthetic_batch(4, 128, 256))
    assert out.device.type == "cpu" and torch.isfinite(out).all()


def test_training_and_later_slice_configs_raise():
    """Every configuration of a later slice raises; the training forward,
    which raised before the training slice, now runs (its parity with JAX is
    in tests/test_torch_train.py), and so does the mean aggregation since
    the PNA slice (tests/test_torch_pna.py)."""
    model = PHCGNN(**_config(32, 2), device="cpu")
    out = model(attach_csr_plan(synthetic_batch(4, 128, 256)), training=True,
                generator=torch.Generator().manual_seed(0))
    assert out.shape == (5, 1) and torch.isfinite(out).all()
    out.sum().backward()
    assert all(p.grad is not None for p in model.parameters()
               if p.requires_grad)
    for over in (dict(edge_axis="ep"),
                 dict(node_axis="dp"), dict(remat=True),
                 dict(compute_dtype=torch.bfloat16)):
        with pytest.raises(NotImplementedError):
            PHCGNN(**_config(32, 2, **over), device="cpu")
    # unique_phm and the real transformer's sum, mean and norm came with the
    # twelfth slice (tests/test_torch_options.py holds them to JAX)
    shared = PHCGNN(**_config(32, 2, unique_phm=True, real_trafo="norm"),
                    device="cpu")
    assert shared.phm_rule_shared.shape == (4, 4, 4)
    assert not any(k.endswith(".phm_rule") for k, _ in
                   shared.named_parameters())
    # the naive encoder came with the encoder slice
    # (tests/test_torch_encoder.py holds it to JAX)
    naive = PHCGNN(**_config(32, 2, naive_encoder=True), device="cpu")
    assert hasattr(naive.atomencoder, "encoder")
    mean = PHCGNN(**_config(32, 2, msg_aggr="mean"), device="cpu")
    assert mean.conv_0.conv.aggr == "mean"
