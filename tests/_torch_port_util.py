"""Shared helpers of the PyTorch-port parity tests: JAX reference
parameters with perturbed biases and norm scales, as numpy trees."""
import jax
import numpy as np

from repro.models import init_params as jax_init_params


def perturbed_numpy_params(cfg, seed: int = 0) -> dict:
    """JAX ``init_params`` converted to numpy, with numpy noise added to
    every bias (initialised to 0) and norm scale (initialised to 1), so
    the parity tests really exercise those paths."""
    tree = jax.tree.map(np.asarray, jax_init_params(cfg,
                                                    jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def visit(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = visit(v, path + (k,))
            elif k.startswith("b") or k in ("scale", "q_norm", "k_norm"):
                out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
            else:
                out[k] = np.array(v, np.float32)
        return out

    return visit(tree, ())


def jax_tree(tree: dict):
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)
