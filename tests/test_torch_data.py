"""The port's data layer against the JAX package's, on the same inputs.

Readers, transforms, bucket sizing, the padded loader (batch for batch,
every array bit-equal, NaN positions included, with the native and the
numpy packers), the native binding, ``pad_graph_batch``, the parity
generator (the graphs and the written files' contents byte-equal) and the
prefetch iterator.  Everything here is exact: both sides run the same
numpy code on the same arrays, so no tolerance is stated.
"""

import gzip
import os
import zipfile

import numpy as np
import pytest
import torch

from phc_gnn_tpu.data import datasets as jds
from phc_gnn_tpu.data import loader as jloader
from phc_gnn_tpu.data import native as jnative
from phc_gnn_tpu.data import parity as jparity
from phc_gnn_tpu.data import random_graph as j_random_graph
from phc_gnn_tpu.data import transforms as jtf
from phc_gnn_tpu.graph import batch as jbatch
from phc_gnn_torch.data import datasets as tds
from phc_gnn_torch.data import loader as tloader
from phc_gnn_torch.data import native as tnative
from phc_gnn_torch.data import parity as tparity
from phc_gnn_torch.data import transforms as ttf
from phc_gnn_torch.data.prefetch import prefetch
from phc_gnn_torch.data.synthetic import random_graph as t_random_graph
from phc_gnn_torch.graph import (GraphsTuple, attach_csr_plan, batch_graphs,
                                 pad_graph_batch)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FIELDS = ("nodes", "edges", "senders", "receivers", "graph_ids", "node_mask",
          "edge_mask", "graph_mask", "y")
READERS = {
    "hiv": lambda m: m.load_ogb_graphproppred(os.path.join(FIX, "ogbg_molhiv")),
    "pcba": lambda m: m.load_ogb_graphproppred(os.path.join(FIX, "ogbg_molpcba")),
    "ppa": lambda m: m.load_ogb_graphproppred(os.path.join(FIX, "ogbg_ppa"),
                                              "species"),
    "zinc": lambda m: m.load_npz_dataset(FIX, "zinc"),
    "cifar10": lambda m: m.load_npz_dataset(FIX, "cifar10"),
}


def _same_array(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f"), what


def _same_graphs(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for k in w:
            _same_array(g[k], w[k], f"graph {i} {k}")


def _same_batch(got: GraphsTuple, want):
    for f in FIELDS:
        w = getattr(want, f)
        if w is None:
            assert getattr(got, f) is None, f
            continue
        _same_array(getattr(got, f).numpy(), np.asarray(w), f)


def _jax_as_torch(batch) -> GraphsTuple:
    return GraphsTuple(**{f: (torch.from_numpy(np.array(getattr(batch, f)))
                              if getattr(batch, f) is not None else None)
                          for f in FIELDS})


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_match_jax(name):
    got, want = READERS[name](tds), READERS[name](jds)
    assert sorted(got) == sorted(want) == ["test", "train", "valid"]
    for part in want:
        _same_graphs(got[part], want[part])
    assert tds.dataset_stats(got["train"]) == jds.dataset_stats(want["train"])


def _isolated():
    g = READERS["hiv"](jds)["train"][0]
    x = np.concatenate([g["x"], g["x"][:2]])  # two nodes without an edge
    return dict(g, x=x, pos=np.arange(2 * x.shape[0], dtype=np.float32)
                .reshape(-1, 2))


TRANSFORMS = {
    "remove_isolated_nodes": (lambda m: m.remove_isolated_nodes, _isolated),
    "concat_x_pos": (lambda m: m.concat_x_pos,
                     lambda: READERS["cifar10"](jds)["train"][3]),
    "add_zeros": (lambda m: m.add_zeros,
                  lambda: READERS["ppa"](jds)["train"][1]),
    "extract_add": (lambda m: m.extract_node_feature,
                    lambda: READERS["ppa"](jds)["train"][2]),
    "extract_mean": (lambda m: (lambda g: m.extract_node_feature(g, "mean")),
                     lambda: READERS["ppa"](jds)["train"][2]),
    "extract_max": (lambda m: (lambda g: m.extract_node_feature(g, "max")),
                    lambda: READERS["ppa"](jds)["train"][2]),
    "virtual_node": (lambda m: (lambda g: m.add_virtual_node(g, [119] * 9,
                                                             [5, 6, 2])),
                     lambda: READERS["hiv"](jds)["train"][4]),
    "virtual_node_float": (
        lambda m: (lambda g: m.add_virtual_node(m.concat_x_pos(g))),
        lambda: READERS["cifar10"](jds)["valid"][0]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    fn, graph = TRANSFORMS[name]
    _same_graphs([fn(ttf)(graph())], [fn(jtf)(graph())])
    assert (ttf.grow_vocab_for_virtual_node([3, 4])
            == jtf.grow_vocab_for_virtual_node([3, 4]))


def _synthetic(module, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [module(rng, target_dim=1) for _ in range(n)]


@pytest.mark.parametrize("case", [("zinc", 3, None), ("pcba", 4, 128),
                                  ("synthetic", 16, 1), ("cifar10", 5, 1)])
def test_bucket_spec_matches_jax(case):
    name, bs, td = case
    graphs = (_synthetic(j_random_graph, 200, 0) if name == "synthetic"
              else READERS[name](jds)["train"])
    got = tloader.compute_bucket_spec(graphs, bs, target_dim=td)
    want = jloader.compute_bucket_spec(graphs, bs, target_dim=td)
    assert ((got.num_nodes, got.num_edges, got.num_graphs, got.target_dim)
            == (want.num_nodes, want.num_edges, want.num_graphs,
                want.target_dim))


# name -> (dataset, batch size, target dim, loader kwargs, JAX's native
# packer: where False, JAX packs integer features with numpy, the port with
# its native packer, and the batches must still be equal)
LOADER_CASES = {
    "zinc-shuffle0": ("zinc", 3, 1, dict(shuffle=True, seed=0), True),
    "zinc-shuffle7-drop_last": ("zinc", 3, 1,
                                dict(shuffle=True, seed=7, drop_last=True),
                                True),
    "synthetic-sub_buckets2": ("synthetic", 16, 1,
                               dict(shuffle=True, seed=3, sub_buckets=2), True),
    "synthetic-numpy": ("synthetic", 16, 1, dict(shuffle=True, seed=3), False),
    "pcba-nan-labels": ("pcba", 3, 128, dict(
        transform=jtf.remove_isolated_nodes), True),
    "cifar10-float": ("cifar10", 3, 1, dict(shuffle=True, seed=1), True),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_matches_jax(case, monkeypatch):
    """Batch for batch, all nine arrays bit-equal; each batch's CSR plans
    are ``attach_csr_plan`` of JAX's arrays."""
    name, bs, td, kw, use_native = LOADER_CASES[case]
    if name == "synthetic":
        # 290 graphs: the last batch holds a few and fits the lower rung
        graphs = _synthetic(j_random_graph, 290, 5)
        assert all(np.array_equal(a["x"], b["x"]) for a, b in
                   zip(graphs, _synthetic(t_random_graph, 290, 5)))
    elif name == "cifar10":
        graphs = [jtf.concat_x_pos(g) for g in READERS[name](jds)["train"]]
    else:
        graphs = READERS[name](jds)["train"]
    bucket = jloader.compute_bucket_spec(graphs, bs, target_dim=td)
    tb = tloader.BucketSpec(bucket.num_nodes, bucket.num_edges,
                            bucket.num_graphs, td)
    if not use_native:
        monkeypatch.setattr(jnative, "native_available", lambda: False)
    want = list(jloader.PaddedLoader(graphs, bucket, **kw))
    got = list(tloader.PaddedLoader(graphs, tb, csr_plan=True, **kw))
    assert len(got) == len(want) >= 2
    if "sub_buckets" in kw:
        assert len({b.num_nodes for b in got}) == 2  # both rungs emitted
    for g, w in zip(got, want):
        _same_batch(g, w)
        plan = attach_csr_plan(_jax_as_torch(w))
        for f in ("rowptr", "snd_perm", "snd_rowptr"):
            assert torch.equal(getattr(g, f), getattr(plan, f)), f


@pytest.mark.parametrize("case", ["fits", "overflow", "build_fails"])
def test_native_binding(case, monkeypatch, tmp_path):
    """The native packer against ``batch_graphs`` (the port's numpy packer)
    and JAX's binding; a batch that does not fit raises ``ValueError``; a
    failed build raises, in the loader too, with no numpy fallback."""
    graphs = _synthetic(t_random_graph, 12, 2)
    if case == "build_fails":
        broken = tmp_path / "batcher.cpp"
        broken.write_text("this is not C++\n")
        monkeypatch.setattr(tnative, "SOURCE", broken)
        monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
        monkeypatch.setattr(tnative, "_LIB", None)
        bucket = tloader.compute_bucket_spec(graphs, 4, target_dim=1)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            list(tloader.PaddedLoader(graphs, bucket))
        return
    fits = case == "fits"
    nodes = sum(g["x"].shape[0] for g in graphs)
    edges = sum(g["edge_index"].shape[1] for g in graphs)
    n_pad, e_pad = (nodes + 5, edges + 7) if fits else (nodes + 5, edges - 1)
    args = (np.concatenate([g["x"] for g in graphs]),
            np.concatenate([g["edge_attr"] for g in graphs]),
            np.concatenate([g["edge_index"][0] for g in graphs]),
            np.concatenate([g["edge_index"][1] for g in graphs]),
            np.cumsum([0] + [g["x"].shape[0] for g in graphs]),
            np.cumsum([0] + [g["edge_index"].shape[1] for g in graphs]),
            n_pad, e_pad, 13)
    if not fits:
        with pytest.raises(ValueError, match="does not fit"):
            tnative.pack_batch_native(*args)
        return
    got = tnative.pack_batch_native(*args)
    want = jnative.pack_batch_native(*args)
    ref = batch_graphs(graphs, n_pad, e_pad, 13)
    for k, v in got.items():
        _same_array(v, want[k], k)
        _same_array(v.astype(bool) if k.endswith("mask") else v,
                    getattr(ref, k).numpy(), k)
    recv = np.sort(args[3])
    _same_array(tnative.sort_edges_by_receiver(args[3], nodes),
                jnative.sort_edges_by_receiver(args[3], nodes))
    _same_array(tnative.build_csr_rowptr(recv, nodes),
                jnative.build_csr_rowptr(recv, nodes))


def test_pad_graph_batch_matches_jax():
    graphs = _synthetic(j_random_graph, 5, 4)
    jb = jbatch.batch_graphs(graphs, 160, 320, 6, y_shape=(1,))
    tb = attach_csr_plan(batch_graphs(graphs, 160, 320, 6, y_shape=(1,)))
    got = pad_graph_batch(tb, 256, 512, 9)
    _same_batch(got, jbatch.pad_graph_batch(jb, 256, 512, 9))
    assert got.rowptr is None and got.snd_perm is None


def _file_contents(path):
    """A written file's contents: each array's bytes of an npz (the zip's
    own timestamps aside), the decompressed text of a csv.gz."""
    if path.endswith(".npz"):
        with zipfile.ZipFile(path) as z:
            return {n: z.read(n) for n in sorted(z.namelist())}
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("task", ["zinc", "hiv", "pcba"])
def test_parity_graphs_match_jax(task, tmp_path):
    splits = {"train": 30, "valid": 7, "test": 5}
    got = tparity.make_parity_graphs(task, seed=3, splits=splits)
    want = jparity.make_parity_graphs(task, seed=3, splits=splits)
    for part in want:
        _same_graphs(got[part], want[part])
    troot = tparity.generate_parity_dataset(task, str(tmp_path / "t"), seed=3,
                                            splits=splits)
    jroot = jparity.generate_parity_dataset(task, str(tmp_path / "j"), seed=3,
                                            splits=splits)
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), troot)
                           for d, _, fs in os.walk(troot) for f in fs)
    for rel in files:
        assert (_file_contents(os.path.join(troot, rel))
                == _file_contents(os.path.join(jroot, rel))), rel


@pytest.mark.parametrize("case", ["order", "raise", "single_pass"])
def test_prefetch(case):
    """The source's order, its exception raised at the consumer after the
    items before it, and a single pass; batches stay on the CPU."""
    batches = [batch_graphs(_synthetic(t_random_graph, 2, s), 64, 128, 3)
               for s in range(5)]

    def source():
        yield from batches[:3]
        if case == "raise":
            raise RuntimeError("loader failed")
        yield from batches[3:]

    it = prefetch(source(), depth=2, device="cpu")
    if case == "raise":
        got = [next(it) for _ in range(3)]
        with pytest.raises(RuntimeError, match="loader failed"):
            next(it)
    else:
        got = list(it)
        assert len(got) == 5
    for g, w in zip(got, batches):
        for f in FIELDS[:-1]:
            assert torch.equal(getattr(g, f), getattr(w, f))
        assert g.nodes.device.type == "cpu"
    if case == "single_pass":
        assert list(it) == []
        with pytest.raises(StopIteration):
            next(it)
