"""PyTorch/CUDA port of phc_gnn_tpu for NVIDIA Hopper (H100).

The JAX package ``phc_gnn_tpu`` is the reference.  This package keeps its
module names and its public layouts (flat component-block ``[N, n*d]``
activations, PHM weights ``(n, in/n, out/n)``, rules ``(n, n, n)``), and
every Pallas kernel on the ported path has a hand-written CUDA kernel in
``csrc/`` with a plain PyTorch version beside it (``ops/``).

It imports torch and numpy only, never JAX or the JAX package.
"""

from phc_gnn_torch.device import resolve_device

__all__ = ["resolve_device"]
