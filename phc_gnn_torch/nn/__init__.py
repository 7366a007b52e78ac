"""Layers of the port: PHM linear/MLP, encoders, norms, the downstream head."""

from phc_gnn_torch.nn.activations import get_activation
from phc_gnn_torch.nn.downstream import PHMDownstreamNet
from phc_gnn_torch.nn.encoder import IntegerEncoder, PHMEncoder
from phc_gnn_torch.nn.norm import PHMNorm
from phc_gnn_torch.nn.phm_linear import PHMLinear, PHMMLP, RealTransformer

__all__ = ["get_activation", "PHMDownstreamNet", "IntegerEncoder", "PHMEncoder",
           "PHMNorm", "PHMLinear", "PHMMLP", "RealTransformer"]
