"""Plain fp32 references: one module per model family, named by the
``reference`` key of a configuration file and loaded from the cell's
checkout.  Each exports ``logits(spec, weights, tokens, rows)``.  Nothing
here imports the program, JAX or the JAX package."""
