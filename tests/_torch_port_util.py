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


def greedy_oracle(cfg, tree: dict, pad: int = 128):
    """Greedy decoding by the JAX package's full-sequence ``forward`` on
    the numpy parameter ``tree``: ``oracle(prompt, n)`` -> n tokens.  One
    jit shape (prompts padded to ``pad``; causal attention ignores the
    padding); results are memoised per prompt."""
    import jax.numpy as jnp
    from repro.models import forward

    params = jax_tree(tree)

    @jax.jit
    def last_logits(tokens, n):
        logits, _ = forward(cfg, params, tokens)
        return jax.lax.dynamic_index_in_dim(logits[0], n - 1,
                                            keepdims=False)

    memo: dict = {}

    def oracle(prompt, n: int) -> list:
        key = (np.asarray(prompt, np.int32).tobytes(), n)
        if key not in memo:
            seq = np.zeros((1, pad), np.int32)
            seq[0, :len(prompt)] = prompt
            cur, out = len(prompt), []
            for _ in range(n):
                nxt = int(jnp.argmax(last_logits(jnp.asarray(seq), cur)))
                out.append(nxt)
                seq[0, cur] = nxt
                cur += 1
            memo[key] = out
        return memo[key]

    return oracle
