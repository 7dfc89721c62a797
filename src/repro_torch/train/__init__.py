"""Training of the port (counterpart of ``repro.train``, the GNN part)."""
