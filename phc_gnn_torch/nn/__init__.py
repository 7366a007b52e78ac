"""Layers of the port: PHM linear/MLP, encoders, norms, dropout, the
downstream head and the PHM regularization terms."""

from phc_gnn_torch.nn.activations import get_activation
from phc_gnn_torch.nn.downstream import PHMDownstreamNet
from phc_gnn_torch.nn.dropout import phm_dropout
from phc_gnn_torch.nn.encoder import IntegerEncoder, NaivePHMEncoder, PHMEncoder
from phc_gnn_torch.nn.norm import PHMNorm
from phc_gnn_torch.nn.phm_linear import PHMLinear, PHMMLP, RealTransformer
from phc_gnn_torch.nn.regularization import (
    multiplication_rule_regularization,
    phm_weight_regularization,
)

__all__ = ["get_activation", "PHMDownstreamNet", "IntegerEncoder",
           "NaivePHMEncoder", "PHMEncoder", "PHMNorm", "PHMLinear", "PHMMLP",
           "RealTransformer", "phm_dropout", "phm_weight_regularization",
           "multiplication_rule_regularization"]
