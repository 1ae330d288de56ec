"""The port's MoE layer and MoE serving against the JAX package on the
CPU: ``moe_forward`` equals JAX's at atol 2e-5 with the same kept-slot
mask at the dropless and the published capacity factors, ``moe_ref``
likewise, ties route as ``lax.top_k`` does, the reference's two MoE
scenarios of ``test_models.py``; and the port's ``Engine`` on the MoE
SMOKE configs gives the JAX ``Engine``'s token streams (at capacity
factors below E / k the capacity drops make the JAX engine, not greedy
``forward``, the oracle)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core import SLO as JSLO
from repro.core import EngineConfig as JEngineConfig
from repro.core import Request as JRequest
from repro.core import make_policy
from repro.core.estimator import BatchLatencyEstimator as JEstimator
from repro.models import moe as JM
from repro.serving import Engine as JEngine
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import SLO, EngineConfig, Request, SlideBatching
from repro_torch.core.estimator import BatchLatencyEstimator
from repro_torch.models import moe as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Engine

from _torch_port_util import (DropCount, greedy_oracle, jax_tree,
                              perturbed_numpy_params)

ATOL = 2e-5          # fp32, moe_forward and moe_ref against JAX
KEY = jax.random.PRNGKey(0)


def moe_params(d=32, f=16, n_exp=8, n_shared=1, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), d, f, n_exp, n_shared)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def inputs(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5
            ).astype(np.float32)


def jax_keep(x, p, top_k, cf):
    """The reference ``moe_forward``'s kept-slot mask, by its own lines."""
    B, S, _ = x.shape
    E = p["router"].shape[1]
    logits = jnp.einsum("bsd,de->bse", x, p["router"])
    _, idx = jax.lax.top_k(logits, top_k)
    cap = TM.capacity(top_k, S, E, cf)
    e_flat = idx.reshape(B, S * top_k)
    pos = jnp.cumsum(jax.nn.one_hot(e_flat, E, dtype=jnp.int32), axis=1) - 1
    pos_in_e = jnp.take_along_axis(pos, e_flat[..., None], axis=2)[..., 0]
    return np.asarray(pos_in_e < cap), np.asarray(idx)


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("cf", [4.0, 1.25, 1.0])
def test_moe_forward_matches_jax(cf, n_shared):
    jp, tp = moe_params(n_shared=n_shared)
    x = inputs((3, 40, 32))
    want = JM.moe_forward(jnp.asarray(x), jp, 2, cf)
    got = TM.moe_forward(torch.as_tensor(x), tp, 2, cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    keep, idx = jax_keep(jnp.asarray(x), jp, 2, cf)
    r = TM.route(torch.as_tensor(x), tp, 2, cf)
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.capacity == max(int(np.ceil(2 * 40 / 8 * cf)), 1)
    # cf = E / k is dropless; below it this input drops slots
    assert keep.all() == (cf == 4.0)


def test_moe_ref_matches_jax():
    jp, tp = moe_params()
    x = inputs((2, 9, 32), seed=1)
    want = JM.moe_ref(jnp.asarray(x), jp, top_k=2)
    got = TM.moe_ref(torch.as_tensor(x), tp, top_k=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_ties_route_as_lax_top_k():
    """Tied router logits: the lower expert index first, as lax.top_k
    orders them; the slot order then decides which slot a full expert
    drops, so the outputs and masks agree at cf 1.0 too."""
    logits = inputs((4, 6, 8), seed=2)
    logits[..., 3] = logits[..., 0]
    vals, idx = TM.sorted_top_k(torch.as_tensor(logits), 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(logits), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    # experts 2 and 5 get one bit-identical, dominant logit column: every
    # token whose logit there is positive routes to (2, 5) in that order
    jp, _ = moe_params()
    tree = jax.tree.map(np.array, jp)
    tree["router"][:, 2] *= 10.0
    tree["router"][:, 5] = tree["router"][:, 2]
    jp, tp = jax_tree(tree), params_from_numpy(tree, device="cpu")
    x = inputs((2, 24, 32), seed=3)
    for cf in (4.0, 1.0):
        keep, jidx = jax_keep(jnp.asarray(x), jp, 2, cf)
        r = TM.route(torch.as_tensor(x), tp, 2, cf)
        np.testing.assert_array_equal(r.idx.numpy(), jidx)
        np.testing.assert_array_equal(r.keep.numpy(), keep)
        np.testing.assert_allclose(
            TM.moe_forward(torch.as_tensor(x), tp, 2, cf).numpy(),
            np.asarray(JM.moe_forward(jnp.asarray(x), jp, 2, cf)),
            atol=ATOL)
    tied = (r.idx[..., 0] == 2) & (r.idx[..., 1] == 5)
    assert int(tied.sum()) > r.capacity and not bool(r.keep.all())


def test_moe_dispatch_matches_dropless_ref():
    """``test_models.py``'s scenario on the port, and each side against
    JAX on the same arrays."""
    jp, tp = moe_params(d=32, f=16, n_exp=8, n_shared=1)
    x = inputs((3, 10, 32), seed=4)
    y = TM.moe_forward(torch.as_tensor(x), tp, top_k=2, capacity_factor=4.0)
    ref = TM.moe_ref(torch.as_tensor(x), tp, top_k=2)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=ATOL)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(JM.moe_forward(jnp.asarray(x), jp, 2, 4.0)),
        atol=ATOL)


def test_moe_capacity_drops_are_bounded():
    """With cf < E/k some slots drop: the output stays finite and equals
    the JAX layer's; most tokens keep both of their slots."""
    jp, tp = moe_params(d=32, f=16, n_exp=8, n_shared=0)
    x = inputs((2, 64, 32), seed=5)
    y = TM.moe_forward(torch.as_tensor(x), tp, top_k=2, capacity_factor=1.0)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(
        y.numpy(), np.asarray(JM.moe_forward(jnp.asarray(x), jp, 2, 1.0)),
        atol=ATOL)
    keep = TM.route(torch.as_tensor(x), tp, 2, 1.0).keep
    assert 0 < int((~keep).sum()) < keep.numel() // 2


def test_dropped_slots_add_exact_zeros():
    """A token whose every routed slot is dropped gets exactly the shared
    experts' output (here none: exact zeros)."""
    _, tp = moe_params(n_shared=0)
    x = torch.as_tensor(np.repeat(inputs((1, 1, 32), seed=6), 30, axis=1))
    r = TM.route(x, tp, 2, 1.0)
    assert r.capacity == 8 and not r.keep[0, -2:].any()
    y = TM.moe_forward(x, tp, 2, 1.0)
    assert (y[0, -1] == 0).all() and (y[0, 0] != 0).any()


# ---------------------------------------------------------------------------
# the engine on the MoE SMOKE configs against the JAX engine
# ---------------------------------------------------------------------------

# frozen estimator (``test_torch_spec.py``): at tau = 1e9 the schedule
# does not depend on the measured step times
EST = dict(a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8, b_d=1e-3, t_c=1e-2)


def configs(arch, cf):
    cfg, tcfg = get_smoke(arch), t_get_smoke(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    return cfg, tcfg


def trace(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(3, 7)),
             rng.integers(1, vocab, int(rng.integers(15, 45))
                          ).astype(np.int32)) for _ in range(n)]


def run_jax(cfg, tree, items, num_blocks, spec_k=0, **kw):
    eng = JEngine(cfg, jax_tree(tree),
                  JEngineConfig(eta=1.0, w_p=4.0, tau=1e9, spec_k=spec_k),
                  make_policy("slidebatching"), num_blocks=num_blocks,
                  block_size=16, est=JEstimator(**EST),
                  spec_draft=(cfg, jax_tree(tree)) if spec_k else None, **kw)
    eng.refit_every = 10 ** 9
    reqs = []
    for olen, prompt in items:
        r = JRequest(prompt_len=len(prompt), output_len=olen, arrival=0.0,
                     slo=JSLO(3600.0, 3600.0), priority=1)
        eng.add_request(r, prompt)
        reqs.append(r)
    eng.run_until_drained(max_iters=400)
    eng.kill()
    return [eng.outputs[r.rid] for r in reqs], eng.stats


def run_port(tcfg, tree, items, num_blocks, spec_k=0, **kw):
    params = params_from_numpy(tree, device="cpu")
    eng = Engine(tcfg, params,
                 EngineConfig(eta=1.0, w_p=4.0, tau=1e9, spec_k=spec_k),
                 SlideBatching(), num_blocks=num_blocks, block_size=16,
                 est=BatchLatencyEstimator(**EST), device="cpu",
                 spec_draft=(tcfg, params) if spec_k else None, **kw)
    eng.refit_every = 10 ** 9
    reqs = []
    for olen, prompt in items:
        r = Request(prompt_len=len(prompt), output_len=olen, arrival=0.0,
                    slo=SLO(3600.0, 3600.0), priority=1)
        eng.add_request(r, prompt)
        reqs.append(r)
    eng.run_until_drained(max_iters=400)
    eng.kill()
    return [eng.outputs[r.rid] for r in reqs], eng.stats


@pytest.mark.parametrize("num_blocks", [128, 10], ids=["plain", "preemption"])
@pytest.mark.parametrize("cf", [None, 1.0], ids=["dropless", "cf1.0"])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen2_moe_a2_7b"])
def test_moe_engine_streams_equal_the_jax_engine(arch, cf, num_blocks,
                                                 monkeypatch):
    cfg, tcfg = configs(arch, cf)
    tree = perturbed_numpy_params(cfg)
    items = trace(cfg.vocab)
    want, jst = run_jax(cfg, tree, items, num_blocks)
    drops = DropCount(monkeypatch)
    got, st = run_port(tcfg, tree, items, num_blocks)
    assert got == want
    assert (st.evictions, st.packed_prefill_calls, st.decode_launches) == \
        (jst.evictions, jst.packed_prefill_calls, jst.decode_launches)
    if num_blocks == 10:
        assert st.evictions > 0
    assert drops.calls == cfg.n_layers * st.packed_prefill_calls
    # the SMOKE configs' capacity factor is E / k: dropless
    assert (drops.dropped > 0) == (cf is not None)
    # dropless streams are greedy forward's; the drops change some
    dropless = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                   / cfg.top_k)
    oracle = greedy_oracle(dropless, tree)
    greedy = [oracle(p, n) for n, p in items]
    assert (got == greedy) == (cf is None)


@pytest.mark.parametrize("kwargs", [dict(spec_k=2),
                                    dict(packed_prefill=False,
                                         fused_decode=False)],
                         ids=["spec_k=2", "per-request"])
def test_moe_engine_spec_and_per_request_equal_the_jax_engine(kwargs):
    """Speculation with an MoE target (verify rows are (R, 1, d), so the
    capacity stays per row, as in decode) and the per-request chunk path
    ((1, c, d) with the chunk's bucket padding), at cf 1.0."""
    cfg, tcfg = configs("olmoe_1b_7b", 1.0)
    tree = perturbed_numpy_params(cfg)
    items = trace(cfg.vocab, seed=1)
    want, jst = run_jax(cfg, tree, items, 128, **kwargs)
    got, st = run_port(tcfg, tree, items, 128, **kwargs)
    assert got == want
    for key in ("decode_launches", "packed_prefill_calls", "spec_proposed",
                "spec_accepted", "evictions"):
        assert getattr(st, key) == getattr(jst, key), key
    if "spec_k" in kwargs:
        assert st.spec_proposed > 0
    else:
        assert st.prefill_chunk_calls >= len(items)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen2_moe_a2_7b"])
def test_serve_entry_point_serves_moe_on_cpu(arch, capsys):
    """``launch/serve.py --arch <moe>`` runs unchanged: every request of
    the two-wave smoke traffic finishes, one JSON summary line."""
    from repro_torch.launch import serve
    res = serve.main(["--smoke", "--device", "cpu", "--arch", arch])
    out = capsys.readouterr().out
    assert f'"arch": "{res.cfg.name}"' in out and res.cfg.family == "moe"
    assert res.engine.stats.tokens_out == 12 * serve.SMOKE.output_len
    res.engine.kill()
