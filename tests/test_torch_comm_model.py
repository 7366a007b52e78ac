"""The port's communication model of the halo scheme
(parallel/comm_model.py) against the JAX package's, and against the bytes
that the port's collectives send.

- On the same batches (2, 4 and 8 shards, the sizes of JAX's own
  tests/test_comm_model.py), every function gives JAX's numbers exactly:
  the cut matrix, the halo volume, the step volume and the predicted
  efficiency.
- Over one np train step of the halo scheme on 2 and 4 gloo ranks
  (tests/torch_ranks.py; the pytest run's one start of each size, which
  tests/test_torch_edge_partition.py's cases share; width 16, 2 layers of
  the flagship's layout, naive BN, ``synthetic_batch(6, 160, 384)``),
  ``torch.distributed``'s ``all_to_all_single`` and ``all_reduce`` are
  wrapped and each call's bytes recorded.  The gradient's ``all_reduce``
  (the parameters' bytes) is counted apart, as the model leaves it out.
  The halo exchanges equal ``padded_bytes`` and the pooling's psums
  ``pooling_psum_bytes``, exactly.  The norms send 3 ``all_reduce``s
  forward (the count, the mean's sum, the sum of squares) and 2 backward
  (the two sums' transposes): the count has no gradient, in JAX as here,
  so its transpose is never sent, while JAX's model counts ``2 * (2d + 1)``
  elements a norm.  The counted bytes are therefore ``total_bytes`` less
  4 bytes a norm (``COUNT_TRANSPOSE_BYTES``), and the test holds them to
  that, exactly.
"""

import numpy as np
import pytest

from phc_gnn_tpu.data import synthetic_batch as jax_synthetic_batch
from phc_gnn_tpu.parallel import comm_model as jcm
from phc_gnn_torch.data import ZINC_ATOM_DIMS, ZINC_BOND_DIMS, synthetic_batch
from phc_gnn_torch.models import PHCGNN
from phc_gnn_torch.parallel import comm_model as tcm
from test_torch_edge_partition import _ranks, shared_dir  # noqa: F401

DIM = 16
MODEL = dict(phm_dim=4, atom_encoded_dim=DIM, mp_layers=(DIM, DIM),
             dropout_mpnn=(0.0, 0.0), downstream_layers=(DIM, 8),
             target_dim=1, dropout_dn=(0.0, 0.0), msg_aggr="softmax",
             mlp_mp=True, atom_input_dims=tuple(ZINC_ATOM_DIMS),
             bond_input_dims=tuple(ZINC_BOND_DIMS))
SHAPE = (6, 160, 384)
COUNT_TRANSPOSE_BYTES = 4  # the f32 count's transpose, which no one sends
F32 = 4


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_comm_model_matches_jax(shards):
    """``boundary_cuts``, ``halo_volume``, ``step_comm_volume`` and
    ``predict_scaling_efficiency`` give JAX's numbers, exactly, on the
    batches of JAX's tests/test_comm_model.py and the flagship's bucket."""
    for shape, seed in (((8, 256, 512), shards), ((6, 160, 384), 1),
                        ((128, 4096, 8192), 3)):
        jb = jax_synthetic_batch(*shape, seed=seed)
        tb = synthetic_batch(*shape, seed=seed)
        np.testing.assert_array_equal(tcm.boundary_cuts(tb, shards),
                                      jcm.boundary_cuts(jb, shards))
        for dims, pooled, bn, align in (([DIM], DIM, (), 8),
                                        ([200] * 4, 200, [200] * 4, 8),
                                        ([16, 32], 24, [16, 8, 32], 16)):
            assert tcm.halo_volume(tb, shards, dims, 4, align) == \
                jcm.halo_volume(jb, shards, dims, 4, align)
            got = tcm.step_comm_volume(tb, shards, dims, pooled, bn,
                                       halo_align=align)
            want = jcm.step_comm_volume(jb, shards, dims, pooled, bn,
                                        halo_align=align)
            assert got == want
            for overlap in (0.0, 0.5):
                assert tcm.predict_scaling_efficiency(
                    1.91e-3, got["total_bytes"], shards, overlap=overlap) == \
                    jcm.predict_scaling_efficiency(
                        1.91e-3, want["total_bytes"], shards, overlap=overlap)


def count_spec():
    """The spec of the np step whose bytes are counted: the test model
    from seed 0, SGD, ``synthetic_batch(6, 160, 384, seed=1)``."""
    model = PHCGNN(**MODEL, device="cpu")
    return dict(model=MODEL, state={k: v.numpy() for k, v in
                                    model.state_dict().items()},
                opt="sgd", wd=0.1, lr=1e-3, shape=SHAPE, seeds=[1])


def test_np_step_bytes_match_the_model(shared_dir):
    """One np step on 2 and on 4 gloo ranks: each rank's bytes through
    ``all_to_all_single`` and ``all_reduce``, the gradient's apart, against
    ``step_comm_volume`` of the batch (module docstring)."""
    runs = {s: _ranks(shared_dir, s) for s in (2, 4)}
    batch = synthetic_batch(*SHAPE, seed=1)
    for shards, wait in runs.items():
        for rank, res in enumerate(r[-1] for r in wait()):
            what = f"{shards} shards, rank {rank}"
            norms = res["norms"]
            vol = tcm.step_comm_volume(batch, shards, [DIM] * 2, DIM, norms)
            a2a = [b for name, b in res["calls"]
                   if name == "all_to_all_single"]
            reduce = [b for name, b in res["calls"] if name == "all_reduce"]
            grad = res["params"] * F32
            assert reduce[-1] == grad and grad not in reduce[:-1], what
            reduce = reduce[:-1]
            pool = [b for b in reduce if b == res["num_graphs"] * DIM * F32]
            counts = [b for b in reduce if b == F32]
            sums = [b for b in reduce if b not in pool and b not in counts]
            assert len(a2a) == 2 * len(MODEL["mp_layers"]), what
            assert sum(a2a) == vol["padded_bytes"], what
            assert len(pool) == 2, what
            assert sum(pool) == vol["pooling_psum_bytes"], what
            assert len(counts) == len(norms), what
            assert len(sums) == 4 * len(norms), what
            assert sum(counts) + sum(sums) == (
                vol["bn_psum_bytes"] - COUNT_TRANSPOSE_BYTES * len(norms)), what
            assert sum(a2a) + sum(reduce) == (
                vol["total_bytes"] - COUNT_TRANSPOSE_BYTES * len(norms)), what
