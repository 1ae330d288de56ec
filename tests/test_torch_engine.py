"""The port's ``Engine(device="cpu")`` against greedy decoding by the JAX
package's full-sequence ``forward`` on the same parameters and prompts:
token for token, on the ``tests/test_engine_real.py`` scenarios (plain,
preemption, sync offload / recompute-only), the per-request prefill and
logits-decode paths (``packed_prefill=False``, ``fused_decode=False``),
the port's two-wave serve traffic (prefix-cache hits), and the model
families that are not ported yet raising ``NotImplementedError``.  The
engine runs with its default background transfer lanes
(``overlap_transfers=True``) unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.models import forward as jax_forward
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import SLO, EngineConfig, Request, SlideBatching
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Engine

from _torch_port_util import jax_tree, perturbed_numpy_params

CFG = get_smoke("qwen1_5_0_5b")
TCFG = t_get_smoke("qwen1_5_0_5b")
TREE = perturbed_numpy_params(CFG)
JPARAMS = jax_tree(TREE)
TPARAMS = params_from_numpy(TREE, device="cpu")
PAD = 128            # one jit shape: causal attention ignores the padding


@jax.jit
def _last_logits(params, tokens, n):
    logits, _ = jax_forward(CFG, params, tokens)
    return jax.lax.dynamic_index_in_dim(logits[0], n - 1, keepdims=False)


def greedy_reference(prompt, n):
    seq = np.zeros((1, PAD), np.int32)
    seq[0, :len(prompt)] = prompt
    cur, out = len(prompt), []
    for _ in range(n):
        nxt = int(jnp.argmax(_last_logits(JPARAMS, jnp.asarray(seq), cur)))
        out.append(nxt)
        seq[0, cur] = nxt
        cur += 1
    return out


def make_engine(num_blocks=128, **kw):
    bm_kwargs = {k: kw.pop(k) for k in ("async_offload", "recompute_only")
                 if k in kw}
    return Engine(TCFG, TPARAMS, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                  SlideBatching(), num_blocks=num_blocks, block_size=16,
                  bm_kwargs=bm_kwargs, device="cpu", **kw)


def submit(eng, rng, plen, out_len, prio=1):
    r = Request(prompt_len=plen, output_len=out_len, arrival=0.0,
                slo=SLO(3600.0, 3600.0), priority=prio)
    prompt = rng.integers(1, CFG.vocab, plen).astype(np.int32)
    eng.add_request(r, prompt)
    return r, prompt


def check_streams(eng, reqs):
    for r, prompt in reqs:
        assert eng.outputs[r.rid] == greedy_reference(prompt, r.output_len), \
            f"rid {r.rid} diverged"
    st = eng.stats
    # one fetch per sampling launch: per-request chunks fetch only when
    # their prompt completes, once per request
    assert st.host_syncs == st.decode_launches + (
        st.packed_prefill_calls if eng.packed_prefill else len(reqs))


def test_engine_matches_greedy_reference():
    rng = np.random.default_rng(0)
    eng = make_engine()
    reqs = [submit(eng, rng, int(rng.integers(8, 40)), 5) for _ in range(3)]
    eng.run_until_drained()
    check_streams(eng, reqs)
    # CPU tensors take the plain versions: no CUDA kernel is launched
    assert set(ops.launch_counts()) == {
        "paged_decode_attention", "packed_prefill_attention",
        "chunked_prefill_attention", "packed_verify_attention",
        "kv_block_quantize", "kv_block_dequantize", "block_gather"}
    assert not any(ops.launch_counts().values())
    eng.kill()


def test_engine_preemption_roundtrip_exact():
    rng = np.random.default_rng(1)
    eng = make_engine(num_blocks=10)     # 144 usable tokens < 4*(40+6)
    reqs = [submit(eng, rng, 40, 6) for _ in range(4)]
    eng.run_until_drained(max_iters=400)
    assert eng.stats.evictions > 0, "test needs actual preemption pressure"
    check_streams(eng, reqs)


@pytest.mark.parametrize("kwargs", [dict(async_offload=False),
                                    dict(recompute_only=True)])
def test_engine_sync_offload_and_recompute_exact(kwargs):
    rng = np.random.default_rng(2)
    eng = make_engine(num_blocks=10, **kwargs)
    reqs = [submit(eng, rng, 40, 4) for _ in range(4)]
    eng.run_until_drained(max_iters=400)
    assert eng.stats.evictions > 0
    check_streams(eng, reqs)


PER_REQUEST = [dict(packed_prefill=False), dict(fused_decode=False),
               dict(packed_prefill=False, fused_decode=False)]


@pytest.mark.parametrize("kwargs", PER_REQUEST,
                         ids=lambda kw: ",".join(kw))
@pytest.mark.parametrize("num_blocks", [128, 10],
                         ids=["plain", "preemption"])
def test_per_request_paths_match_greedy_reference(kwargs, num_blocks):
    """The reference's fallback paths: one ``prefill_chunk`` per prefill
    chunk and the logits decode, with and without preemption."""
    rng = np.random.default_rng(5)
    eng = make_engine(num_blocks=num_blocks, **kwargs)
    reqs = [submit(eng, rng, 40, 5) for _ in range(4)]
    eng.run_until_drained(max_iters=400)
    if num_blocks == 10:
        assert eng.stats.evictions > 0
    check_streams(eng, reqs)
    st = eng.stats
    if eng.packed_prefill:
        assert st.prefill_chunk_calls == 0 and st.packed_prefill_calls > 0
    else:
        assert st.packed_prefill_calls == 0
        assert st.prefill_chunk_calls >= len(reqs)
    eng.kill()


def test_two_wave_serve_with_prefix_hits_exact():
    res = serve.serve(TCFG, TPARAMS, serve.SMOKE, seed=3, device="cpu")
    st = res.engine.stats
    assert st.cache_hit_tokens > 0 and st.evictions > 0
    check_streams(res.engine, res.requests)
    summary = res.summary()
    assert summary["requests"] == 12 and 0.0 <= summary["tdg_ratio"] <= 1.0


def test_run_until_drained_stops_at_first_idle_step():
    """``Engine.run_until_drained`` stops at the first step that forms no
    batch, as the reference's does: both consume the same steps."""
    from repro.core import EngineConfig as JEngineConfig
    from repro.core import make_policy
    from repro.serving import Engine as JEngine

    port = make_engine(overlap_transfers=False)
    ref = JEngine(CFG, JPARAMS, JEngineConfig(), make_policy("slidebatching"),
                  num_blocks=16, overlap_transfers=False)
    left = []
    for eng in (port, ref):
        steps = iter([{}, {}, None, {}, None])
        eng.has_work = lambda: True
        eng.step = lambda steps=steps: next(steps)
        eng.run_until_drained(max_iters=10)
        left.append(list(steps))
    assert left[0] == left[1] == [{}, None]
    steps = iter([{}, None, {}])
    port.step = lambda: next(steps)
    assert port.run_until_drained(max_iters=10) == 1
    port.has_work = lambda: False
    assert port.run_until_drained() == 0
    port.kill()
    ref.kill()


def test_serve_wave_loop_retries_one_idle_step():
    """The serve entry point's wave loop retries one idle step, since its
    planned evictions can free what the next step schedules; two in a
    row stop."""
    eng = make_engine(overlap_transfers=False)
    steps = iter([None, {}, None, None, {}])
    eng.has_work = lambda: True
    eng.step = lambda: next(steps)
    assert serve.drain(eng, max_iters=10) == 4
    assert next(steps) == {}
    eng.has_work = lambda: False
    assert serve.drain(eng, max_iters=10) == 0


def test_serve_entry_point_runs_on_cpu(capsys):
    res = serve.main(["--smoke", "--device", "cpu", "--seed", "1"])
    out = capsys.readouterr().out
    assert '"device": "cpu"' in out and "tdg_ratio" in out
    assert res.engine.stats.tokens_out == 12 * serve.SMOKE.output_len


@pytest.mark.parametrize("kwargs", [
    dict(spec_draft=(TCFG, TPARAMS)), dict(packed_prefill=False),
    dict(fused_decode=False)],
    ids=["spec_draft", "packed_prefill=False", "fused_decode=False"])
def test_ported_flags_are_accepted(kwargs):
    spec = "spec_draft" in kwargs
    eng = Engine(TCFG, TPARAMS, EngineConfig(spec_k=2 if spec else 0),
                 SlideBatching(), device="cpu", **kwargs)
    assert eng.packed_prefill == kwargs.get("packed_prefill", True)
    assert eng.fused_decode == kwargs.get("fused_decode", True)
    assert (eng.draft is not None) == spec
    if spec:
        assert eng.draft.pool.device == eng.device
        assert eng.draft.pool.kv.dtype == eng.pool.kv.dtype
    eng.kill()
    # a draft is only built when speculating
    plain = make_engine(spec_draft=(TCFG, TPARAMS))
    assert plain.draft is None
    plain.kill()


@pytest.mark.parametrize("kwargs", [
    dict(overlap_transfers=True), dict(overlap_transfers=False),
    dict(host_tier_bytes=1 << 20), dict(cold_quantize=False)],
    ids=lambda kw: next(iter(kw)) + "=" + str(next(iter(kw.values()))))
def test_ported_transfer_and_tier_flags_are_accepted(kwargs):
    eng = make_engine(**kwargs)
    assert (eng.worker is not None) == kwargs.get("overlap_transfers", True)
    assert eng.pool.tier.budget_bytes == kwargs.get("host_tier_bytes")
    assert eng.pool.tier.cold_quantize == kwargs.get("cold_quantize", True)
    assert eng.cache.spill == ("host_tier_bytes" in kwargs)
    eng.kill()


def test_unported_spec_k_and_families_raise():
    with pytest.raises(ValueError, match="spec_draft"):
        Engine(TCFG, TPARAMS, EngineConfig(spec_k=2), SlideBatching(),
               device="cpu")
    moe = t_get_smoke("qwen2_moe_a2_7b")
    with pytest.raises(NotImplementedError):
        Engine(moe, TPARAMS, EngineConfig(), SlideBatching(), device="cpu")
    with pytest.raises(ValueError):
        make_engine(role="router")
    from repro_torch.serving import PagedKVPool
    pool = PagedKVPool(TCFG, 8, 16, device="cpu", host_tier_bytes=1 << 20)
    assert pool.tier.budget_bytes == 1 << 20
    assert torch.float32 == TPARAMS["embed"].dtype
