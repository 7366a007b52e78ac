#!/usr/bin/env python3
"""Trace where the bf16 flagship on a CUDA device parts from the same model
on the CPU, op by op.

    python3 tools/trace_bf16_rounding.py [--dim 200] [--device cuda]

``chip_smoke.py``'s flagship (dropout off, one random state, its batch) in
``compute_dtype=torch.bfloat16``, one training forward, under a
``TorchDispatchMode``.  Two readings:

- ``replay``: every aten op of the device's forward (and of the backward
  ops the mode sees) run again on the CPU on copies of the device's own
  inputs; per op, the entries whose output differs.  It tells whether any
  op computes differently on the device given the same inputs.  Run twice,
  with cuBLAS's reduced-precision bf16 reduction allowed (torch's default)
  and forbidden.
- ``align``: the aten op sequences of the device's and the CPU's forwards
  (each from the same state and batch), aligned by op, shape and dtype,
  and the relative 2-norm distance and share of differing entries of
  every aligned output; the device's kernels (ctypes launches) do not
  pass the dispatcher, so the sequences part around them.  Printed: every
  aligned output that differs by more than 1e-3 (bf16) or 1e-5 (f32), or
  on more than 1 % of its entries.

The kernels themselves are held to their plain versions by
``chip_smoke.py``.  Prints the card's name and power limit first where
there is one.
"""

from __future__ import annotations

import argparse
import difflib
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SKIP_REPLAY = ("copy", "empty", "_to_copy", "lift", "detach", "view",
               "alias", "_local_scalar_dense", "record_stream", "set_",
               "resize")
SKIP_ALIGN = ("detach", "view", "alias", "_local_scalar_dense",
              "record_stream")


def flagship(torch, cs, dev, bf16: bool):
    from phc_gnn_torch.models import PHCGNN

    base = PHCGNN(**cs.flagship_config(False), seed=0, device="cpu")
    cs.randomize_eval_state(torch, base)
    m = PHCGNN(**cs.flagship_config(False), seed=0, device=dev,
               compute_dtype=torch.bfloat16 if bf16 else None)
    m.load_state_dict(base.state_dict())
    return m


def replay(torch, cs, dev, batch) -> None:
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map
    from phc_gnn_torch.train import masked_l1

    stats: dict = {}

    def cpu(t):
        return t.detach().cpu().clone() if isinstance(t, torch.Tensor) else t

    class Replay(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func)
            skip = any(s in name for s in SKIP_REPLAY)
            if not skip:
                cargs, ckw = tree_map(cpu, args), tree_map(cpu, kwargs)
                if "device" in ckw:
                    ckw["device"] = torch.device("cpu")
            out = func(*args, **kwargs)
            if skip:
                return out
            with torch.no_grad():
                ref = func(*cargs, **ckw)
            outs = out if isinstance(out, (tuple, list)) else [out]
            refs = ref if isinstance(ref, (tuple, list)) else [ref]
            for o, r in zip(outs, refs):
                if not (isinstance(o, torch.Tensor) and o.is_floating_point()
                        and o.shape == r.shape):
                    continue
                o = o.detach().cpu()
                fin = torch.isfinite(o) & torch.isfinite(r)
                s = stats.setdefault(f"{name} {tuple(o.shape)} {o.dtype}",
                                     [0, 0])
                s[0] += o.numel()
                s[1] += int(((o != r) & fin).sum())
            return out

    m = flagship(torch, cs, dev, True)
    with Replay():
        out = m(batch, training=True)
        torch.autograd.grad(masked_l1(out, batch.y), list(m.parameters()))
    print(f"replay (reduced-precision bf16 reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
          f"): {len(stats)} ops; those with differing entries "
          f"(entries, differing, share):", flush=True)
    for k, (n, bad) in stats.items():
        if bad:
            print(f"  {k}: {n} {bad} {bad / n:.3e}", flush=True)


def align(torch, cs, dev, host) -> None:
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seq = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            o = out[0] if isinstance(out, (tuple, list)) and out else out
            if (isinstance(o, torch.Tensor)
                    and not any(s in name for s in SKIP_ALIGN)):
                self.seq.append((name, tuple(o.shape),
                                 str(o.dtype).replace("torch.", ""),
                                 o.detach().cpu().clone()))
            return out

    seqs = {}
    for where, d, b in (("device", dev, host.to(dev)), ("cpu", "cpu", host)):
        m = flagship(torch, cs, d, True)
        rec = Record()
        with rec, torch.no_grad():
            m(b, training=True)
        seqs[where] = rec.seq
    a, b = seqs["device"], seqs["cpu"]
    match = difflib.SequenceMatcher(a=[x[:3] for x in a],
                                    b=[x[:3] for x in b], autojunk=False)
    print(f"align: device {len(a)} ops, CPU {len(b)} ops; aligned outputs "
          f"that differ (index, op, shape, dtype, relative 2-norm, share):",
          flush=True)
    for tag, i1, i2, j1, j2 in match.get_opcodes():
        if tag != "equal":
            continue
        for i, j in zip(range(i1, i2), range(j1, j2)):
            x, y = a[i][3], b[j][3]
            if not x.is_floating_point() or not x.numel():
                continue
            fin = torch.isfinite(x) & torch.isfinite(y)
            xd, yd = x[fin].double(), y[fin].double()
            rel = float((xd - yd).norm() / max(float(yd.norm()), 1e-300))
            share = float((x != y).double().mean())
            if rel > (1e-3 if x.dtype == torch.bfloat16 else 1e-5) \
                    or share > 0.01:
                print(f"  [{i}] {a[i][0]} {a[i][1]} {a[i][2]} {rel:.3e} "
                      f"{share:.3e}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    import chip_smoke as cs
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan

    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    cs.DIM = args.dim
    host = attach_csr_plan(synthetic_batch(seed=0, **cs.FLAGSHIP))
    batch = host.to(args.device)
    for allowed in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            allowed
        replay(torch, cs, args.device, batch)
    align(torch, cs, args.device, host)


if __name__ == "__main__":
    main()
