"""Deprecated alias of ``repro_torch.launch.serve_lm`` (the LM decode demo),
as ``repro.launch.serve`` is of ``repro.launch.serve_lm``.

GNN serving is ``repro_torch.serve`` and its launcher
``repro_torch.launch.serve_gnn``.  This shim keeps ``python -m
repro_torch.launch.serve`` working with a warning.
"""
import warnings

from repro_torch.launch.serve_lm import main, prefill_cache  # noqa: F401

warnings.warn(
    "repro_torch.launch.serve is deprecated; the LM decode demo moved to "
    "repro_torch.launch.serve_lm (GNN serving lives in "
    "repro_torch.launch.serve_gnn / repro_torch.serve)",
    DeprecationWarning, stacklevel=2)

if __name__ == "__main__":
    main()
