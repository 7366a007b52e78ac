"""Models of the port: ``PHCGNN`` and the four reference classes as
configurations of it (``presets``)."""

from phc_gnn_torch.models.phc_gnn import PHCGNN
from phc_gnn_torch.models.presets import (
    PHMSkipConnectAdd,
    PHMSkipConnectConcat,
    QuaternionSkipConnectAdd,
    QuaternionSkipConnectConcat,
)

__all__ = ["PHCGNN", "PHMSkipConnectAdd", "PHMSkipConnectConcat",
           "QuaternionSkipConnectAdd", "QuaternionSkipConnectConcat"]
