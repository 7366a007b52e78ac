"""Hypercomplex algebra of the port: rules, Kronecker and PHM products,
inits, the quaternion helpers, the quaternion QR and the layout bijection
(phc_gnn_tpu/hypercomplex)."""

from phc_gnn_torch.hypercomplex.inits import (
    glorot_normal,
    glorot_uniform,
    orthogonal_init,
    phm_init,
    quaternion_init,
    unitary_init,
)
from phc_gnn_torch.hypercomplex.kron import (
    batched_kron,
    kron,
    phm_matmul,
    phm_weight_matrix,
)
from phc_gnn_torch.hypercomplex.layout import to_flat, to_stacked
from phc_gnn_torch.hypercomplex.quaternion import (
    complex_matrix_representation,
    conjugate,
    hamilton_product,
    inverse,
    normalize,
    qnorm,
    quaternion_dot,
    quaternion_matmul,
    real_matrix_representation,
)
from phc_gnn_torch.hypercomplex.rules import get_multiplication_rule

__all__ = ["get_multiplication_rule", "kron", "batched_kron",
           "phm_weight_matrix", "phm_matmul", "phm_init", "unitary_init",
           "glorot_uniform", "glorot_normal", "quaternion_init",
           "orthogonal_init", "hamilton_product",
           "real_matrix_representation", "complex_matrix_representation",
           "quaternion_matmul", "conjugate", "qnorm", "inverse", "normalize",
           "quaternion_dot", "to_flat", "to_stacked"]
