"""Hypercomplex algebra of the port: rules, the PHM product and inits."""

from phc_gnn_torch.hypercomplex.inits import (
    glorot_normal,
    glorot_uniform,
    phm_init,
    unitary_init,
)
from phc_gnn_torch.hypercomplex.kron import phm_matmul, phm_weight_matrix
from phc_gnn_torch.hypercomplex.rules import get_multiplication_rule

__all__ = ["get_multiplication_rule", "phm_weight_matrix", "phm_matmul",
           "phm_init", "unitary_init", "glorot_uniform", "glorot_normal"]
