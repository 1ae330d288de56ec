"""Runnable examples of the port (counterparts of the repository's
``examples/`` scripts that build JAX engines or use ``repro.sim``):
``python -m repro_torch.examples.quickstart``, ``.serve_cluster`` and
``.shared_prefix``; ``--smoke --device cpu`` runs each on the CPU."""
