"""OLMoE-1B-7B as published (``olmoe_1b_7b_0924``) on the port's serving
path, on the CPU: the ``Engine``'s packed prefill and paged decode give
the logits of the benchmark's plain reference (``bench/reference/
olmoe.py``) over the same tokens; each of the three published points
that the JAX reference renders otherwise (QK-norm over the whole
projection, top-k gates not renormalised, RMSNorm epsilon 1e-5), put
back alone, fails that comparison; the three fields at their defaults
leave the reference's arithmetic bit for bit; and the routed FFN's
counters count what its shapes and its capacity say."""
import dataclasses
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_smoke
from repro_torch.core import SLO, EngineConfig, Request, SlideBatching
from repro_torch.core.estimator import BatchLatencyEstimator
from repro_torch.models import layers, model, moe
from repro_torch.models.model import forward, init_params
from repro_torch.serving import Engine, model_exec

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = get_smoke("olmoe_1b_7b_0924")
# fp32 on the CPU: the paged path (plain attention over the pool, the
# capacity buffer's bmm) and the reference (per-head attention, one
# matmul per expert) sum in other orders; 2e-5 holds them, as in the
# benchmark's reference tests.  A routing or a norm computed otherwise
# moves a logit by far more: each point put back departs by > 1e-2.
ATOL = 2e-5
DEPARTS = 1e-2
# frozen estimator (``test_torch_moe.py``): the schedule does not depend
# on the measured step times
EST = dict(a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8, b_d=1e-3, t_c=1e-2)


def reference():
    """``bench/reference/olmoe.py``, loaded as the benchmark loads it."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench import check
    return check.reference(ROOT, {"reference": "olmoe"})


def spec_of(cfg) -> dict:
    """The published keys the reference reads, from a port config."""
    return {"num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
            "qkv_bias": cfg.qkv_bias, "qk_norm": cfg.qk_norm,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "num_experts_per_tok": cfg.top_k,
            "norm_topk_prob": cfg.norm_topk_prob}


def weights(cfg, seed: int) -> dict:
    """``init_params`` from the seed, every norm scale drawn as 1 +
    N(0, 0.1^2), so that a scale applied per head or over the whole
    projection shows."""
    g = torch.Generator().manual_seed(seed)
    w = init_params(cfg, g, device="cpu")

    def scales(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                scales(v)
            elif k in ("scale", "q_norm", "k_norm"):
                v.add_(0.1 * torch.randn(v.shape, generator=g))
    scales(w)
    return w


def prompts(vocab: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(4, 9)),
             rng.integers(1, vocab, int(rng.integers(12, 40))
                          ).astype(np.int32)) for _ in range(4)]


class Logits:
    """Every logits row the engine's packed prefill and decode computed,
    keyed by (request id, position), by wrapping the two model_exec
    functions that return logits.  A row's request is found by its table's
    first block (the prompts share no prefix)."""

    def __init__(self, monkeypatch, eng):
        self.eng, self.rows = eng, {}
        packed, decode = model_exec.prefill_packed, model_exec._decode_forward

        def prefill(cfg, params, pool_kv, tokens, positions, q_rows, q_cols,
                    sblocks, sslots, tables, ctx_lens, last_idx, *a):
            lg, pool = packed(cfg, params, pool_kv, tokens, positions,
                              q_rows, q_cols, sblocks, sslots, tables,
                              ctx_lens, last_idx, *a)
            pos = positions[0, last_idx.long()]
            for i in range(lg.shape[0]):
                self.put(int(tables[i, 0]), int(pos[i]), lg[i])
            return lg, pool

        def one_token(cfg, params, pool_kv, tokens, tables, lens):
            lg = decode(cfg, params, pool_kv, tokens, tables, lens)
            for i in range(lg.shape[0]):
                if int(tables[i, 0]):          # padding rows: null block 0
                    self.put(int(tables[i, 0]), int(lens[i]), lg[i])
            return lg
        monkeypatch.setattr(model_exec, "prefill_packed", prefill)
        monkeypatch.setattr(model_exec, "_decode_forward", one_token)

    def put(self, block: int, pos: int, row: torch.Tensor) -> None:
        rid = [r for r, t in self.eng.pool.tables.items()
               if t and t[0] == block]
        if rid:
            self.rows[rid[0], pos] = row.clone()


def serve(cfg, params, items, monkeypatch=None, **kw):
    """The requests served to the end by one CPU engine (packed prefill,
    fused decode on the paged pool); returns (engine, requests, the logits
    recorder or None)."""
    eng = Engine(cfg, params, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                 SlideBatching(), num_blocks=64, block_size=16,
                 est=BatchLatencyEstimator(**EST), device="cpu", **kw)
    eng.refit_every = 10 ** 9
    rec = Logits(monkeypatch, eng) if monkeypatch is not None else None
    reqs = []
    for olen, prompt in items:
        r = Request(prompt_len=len(prompt), output_len=olen, arrival=0.0,
                    slo=SLO(3600.0, 3600.0), priority=1)
        eng.add_request(r, prompt)
        reqs.append(r)
    eng.run_until_drained(max_iters=400)
    eng.kill()
    return eng, reqs, rec


def widest_gap(cfg, params, published_params, monkeypatch, seed=0):
    """The engine at ``cfg`` on ``params`` against the published
    reference on ``published_params``: the largest |logit difference|
    over every position the engine computed logits at, and their count."""
    items = prompts(cfg.vocab, seed)
    eng, reqs, rec = serve(cfg, params, items, monkeypatch)
    ref = reference()
    spec = spec_of(PUBLISHED)
    worst, n = 0.0, 0
    for r, (_, prompt) in zip(reqs, items):
        seq = np.concatenate([prompt, eng.outputs[r.rid][:-1]])
        # a prompt's last position, then each decoded one (a chunk of a
        # prompt split over steps also ends before it)
        mine = {p: row for (rid, p), row in rec.rows.items()
                if rid == r.rid and p >= len(prompt) - 1}
        assert sorted(mine) == list(range(len(prompt) - 1, len(seq)))
        tokens = torch.from_numpy(seq.astype(np.int64))
        want = ref.logits(spec, published_params, tokens, torch.arange(
            len(prompt) - 1, len(seq)))
        got = torch.stack([mine[p] for p in sorted(mine)])
        worst = max(worst, float((got - want).abs().max()))
        n += len(mine)
    return worst, n


def router_margin(params, items, outputs) -> float:
    """The reference's least gap between the k-th and the (k+1)-th router
    logit over every token of every layer: a seed whose margin clears the
    tolerance cannot route differently under rounding."""
    spec, m, k = spec_of(PUBLISHED), params["layers"]["moe"], PUBLISHED.top_k
    seen = []

    ref = reference()

    def record(li, h):
        lg = h @ m["router"][li]
        top = torch.sort(lg, dim=-1, descending=True).values
        seen.append(float((top[:, k - 1] - top[:, k]).min()))
        return ref.routed_ffn(spec, m, li, h)
    for (_, prompt), out in zip(items, outputs):
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
        ref.run(spec, params, torch.from_numpy(seq),
                torch.arange(len(seq)), record)
    return min(seen)


SEED = 8


@pytest.fixture(scope="module")
def published_params():
    return weights(PUBLISHED, SEED)


def test_the_engine_serves_the_published_model_as_the_reference(
        monkeypatch, published_params):
    worst, n = widest_gap(PUBLISHED, published_params, published_params,
                          monkeypatch)
    assert n > 20 and worst <= ATOL, worst


def _per_head(params: dict, cfg) -> dict:
    """The published weights with each q / k norm scale laid out per
    head, (L, H, hd): the port's per-head QK-norm then normalises each
    head with the published scale's slice."""
    attn = dict(params["layers"]["attn"])
    for name, heads in (("q_norm", cfg.n_heads), ("k_norm", cfg.n_kv_heads)):
        attn[name] = attn[name].reshape(cfg.n_layers, heads, cfg.hd)
    return dict(params, layers=dict(params["layers"], attn=attn))


def _small_embedding(params: dict) -> dict:
    """The published weights with the embedding scaled so that the mean
    square entering the first RMSNorm is about 1e-5, where its epsilon
    weighs as much as the signal."""
    return dict(params, embed=params["embed"] * (1e-5 ** 0.5 / 0.02))


@pytest.mark.parametrize("point", ["qk_norm_per_head", "renormalised_top_k",
                                   "eps_1e-6"])
def test_each_published_point_put_back_alone_departs(monkeypatch, point,
                                                     published_params):
    w = published_params
    if point == "qk_norm_per_head":
        cfg = dataclasses.replace(PUBLISHED, qk_norm_whole=False)
        served, ref = _per_head(w, PUBLISHED), w
    elif point == "renormalised_top_k":
        cfg = dataclasses.replace(PUBLISHED, norm_topk_prob=True)
        served, ref = w, w
    else:
        cfg = dataclasses.replace(PUBLISHED, norm_eps=1e-6)
        served = ref = _small_embedding(w)
        # the published model itself still matches on these weights
        good, _ = widest_gap(PUBLISHED, ref, ref, monkeypatch)
        assert good <= ATOL, good
    worst, n = widest_gap(cfg, served, ref, monkeypatch)
    assert n > 20 and worst > DEPARTS, worst


def test_the_seed_clears_every_router_near_tie(published_params):
    """The comparison above is not saved or sunk by a near-tie: on the
    published engine's own tokens every routing decision of the
    reference has a margin far above the tolerance."""
    items = prompts(PUBLISHED.vocab)
    eng, reqs, _ = serve(PUBLISHED, published_params, items)
    outs = [eng.outputs[r.rid] for r in reqs]
    assert router_margin(published_params, items, outs) > 100 * ATOL


def _frozen_qkv(cfg, ap, x):
    """``model._qkv`` as it stood before the published options."""
    q, k, v = x @ ap["wq"], x @ ap["wk"], x @ ap["wv"]
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = model.split_heads(q, cfg.n_heads, cfg.hd)
    k = model.split_heads(k, cfg.n_kv_heads, cfg.hd)
    v = model.split_heads(v, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(q, ap["q_norm"])
        k = layers.rmsnorm(k, ap["k_norm"])
    return q, k, v


def _frozen_norm(x, p, kind, *eps):
    if kind == "layernorm":
        return layers.layernorm(x, p["scale"], p["bias"])
    return layers.rmsnorm(x, p["scale"])


def _frozen_route(x, p, top_k, capacity_factor=1.25, norm_topk_prob=True):
    """``moe.route`` as it stood before the published options (which it
    takes only at their default)."""
    assert norm_topk_prob
    b, s, _ = x.shape
    n_exp = p["router"].shape[1]
    logits = x.float() @ p["router"].float()
    gates, idx = moe.sorted_top_k(logits, top_k)
    gates = torch.softmax(gates, dim=-1)
    cap = moe.capacity(top_k, s, n_exp, capacity_factor)
    e_flat = idx.reshape(b, s * top_k)
    onehot = (e_flat[..., None] == torch.arange(n_exp)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos_in_e = torch.gather(pos, 2, e_flat[..., None])[..., 0]
    return moe.Routing(gates, idx, pos_in_e, pos_in_e < cap, cap)


def _frozen(monkeypatch):
    for mod in (model, model_exec):
        monkeypatch.setattr(mod, "_qkv", _frozen_qkv)
        monkeypatch.setattr(mod, "apply_norm", _frozen_norm)
    monkeypatch.setattr(moe, "route", _frozen_route)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen2_7b"])
def test_the_fields_at_their_defaults_keep_the_arithmetic_bitwise(
        monkeypatch, arch):
    cfg = get_smoke(arch)
    assert (cfg.qk_norm_whole, cfg.norm_topk_prob, cfg.norm_eps) == \
        (False, True, 1e-6)
    w = weights(cfg, 5)
    items = prompts(cfg.vocab, 1)
    tokens = torch.from_numpy(items[0][1][None].astype(np.int64))
    new_logits = forward(cfg, w, tokens)
    eng, reqs, _ = serve(cfg, w, items)
    new_streams = [eng.outputs[r.rid] for r in reqs]
    with monkeypatch.context() as m:
        _frozen(m)
        old_logits = forward(cfg, w, tokens)
        eng, reqs, _ = serve(cfg, w, items)
        old_streams = [eng.outputs[r.rid] for r in reqs]
    assert torch.equal(new_logits, old_logits)
    assert new_streams == old_streams


def prefill_drops(monkeypatch) -> list:
    """The slots each packed-prefill ``moe_forward`` call (one flat
    (1, T, d) stream) drops, by the port's own router, counted apart from
    the engine's counter."""
    counted, inner = [], moe.moe_forward

    def wrapped(x, p, top_k, capacity_factor=1.25, **kw):
        if x.shape[0] == 1 and x.shape[1] > 1:
            keep = moe.route(x, p, top_k, capacity_factor, **kw).keep
            counted.append(int((~keep).sum()))
        return inner(x, p, top_k, capacity_factor, **kw)
    monkeypatch.setattr(moe, "moe_forward", wrapped)
    return counted


def launch_spans(t0: float) -> list:
    """The ``model_exec.launch`` spans this thread recorded since ``t0``."""
    me = threading.get_ident()
    return [s for s in obs.recorder().spans("model_exec.launch")
            if s.t0 >= t0 and s.thread == me]


@pytest.mark.parametrize("cf", [None, 1.0], ids=["dropless", "cf1.0"])
def test_the_routed_counters_count_shapes_and_drops(monkeypatch, cf):
    cfg = PUBLISHED if cf is None else dataclasses.replace(
        PUBLISHED, capacity_factor=cf)
    assert cf is not None or cfg.capacity_factor == cfg.n_experts / cfg.top_k
    drops = prefill_drops(monkeypatch)
    t0 = time.monotonic()
    eng, reqs, _ = serve(cfg, weights(cfg, SEED), prompts(cfg.vocab, 2))
    launches = launch_spans(t0)
    assert launches
    L, E, k = cfg.n_layers, cfg.n_experts, cfg.top_k
    routed = rows = 0
    for s in launches:
        a = s.attrs
        if a["kind"] == "decode":
            b, seq = model_exec.seg_bucket(a["rows"]), 1
        else:
            b, seq = 1, model_exec.flat_bucket(a["tokens"])
        assert a["moe_routed"] == L * a["tokens"] * k
        assert a["moe_rows"] == L * E * moe.capacity(
            k, seq, E, cfg.capacity_factor) * b
        routed += a["moe_routed"]
        rows += a["moe_rows"]
    st = eng.stats
    assert (st.moe_routed_slots, st.moe_expert_rows) == (routed, rows)
    # every prompt token once, every token decoded after the first once
    assert st.moe_routed_slots == L * k * (
        st.prefill_tokens + sum(len(eng.outputs[r.rid]) - 1 for r in reqs))
    # decode rows hold one token each, so only the packed prefill drops
    assert st.moe_dropped_slots == sum(drops)
    assert (st.moe_dropped_slots > 0) == (cf is not None)


def test_a_dense_engine_counts_no_routed_work():
    cfg = get_smoke("qwen2_7b")
    t0 = time.monotonic()
    eng, _, _ = serve(cfg, weights(cfg, 1), prompts(cfg.vocab))
    assert (eng.stats.moe_routed_slots, eng.stats.moe_expert_rows,
            eng.stats.moe_dropped_slots) == (0, 0, 0)
    launches = launch_spans(t0)
    assert launches and all("moe_rows" not in s.attrs for s in launches)
