"""Command line of the port: ``python -m phc_gnn_torch.cli.train <dataset>``
and ``python -m phc_gnn_torch.cli.inference <dataset>``."""
