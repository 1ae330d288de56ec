"""The plain references against the port at smoke size, their
independence from the program, and the control's machinery."""
from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench import check, harness, weights
from bench.tests import smoke
from bench.weights import make_weights

BENCH = Path(__file__).resolve().parents[1]


def _dense_spec():
    c = json.loads((BENCH / "configs" / "qwen2_7b_fp32.json").read_text())
    c.update(smoke.DENSE)
    c["program"]["overrides"].update(smoke.DENSE_ARCH)
    return c


CASES = {"qwen2": _dense_spec, "smoke_moe": smoke.moe_config}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A checkout that holds every case's reference."""
    return smoke.make(tmp_path_factory.mktemp("bench") / "checkout")


def _arch(spec):
    return harness.build_arch(spec, smoke.ROOT)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_equals_the_ports_forward(name, copy):
    from repro_torch.models.model import forward
    spec = CASES[name]()
    arch = _arch(spec)
    w = make_weights(arch, 2**32 + 3, "cpu")
    tokens = torch.randint(1, arch.vocab, (70,),
                           generator=torch.Generator().manual_seed(0))
    rows = torch.arange(70)
    ref = check.reference(copy, spec).logits(spec, w, tokens, rows)
    port = forward(arch, w, tokens[None].int())
    port = port[0] if isinstance(port, tuple) else port
    port = port[0] if port.dim() == 3 else port
    assert torch.allclose(ref, port, atol=2e-5, rtol=1e-5), \
        (ref - port).abs().max()


def test_qk_norm_is_per_head_or_over_the_projection_by_its_scale():
    from bench.reference import common
    x = torch.randn(5, 4, 8, generator=torch.Generator().manual_seed(2))
    per_head = torch.rand(8) + 0.5
    whole = torch.rand(32) + 0.5
    assert torch.equal(common.norm_heads(x, per_head, 1e-6),
                       common.rmsnorm(x, per_head, 1e-6))
    flat = x.reshape(5, 32)
    want = flat * torch.rsqrt((flat * flat).mean(-1, keepdim=True) + 1e-6)
    assert torch.allclose(common.norm_heads(x, whole, 1e-6),
                          (want * whole).reshape(5, 4, 8))


@pytest.mark.parametrize("renorm", [False, True])
def test_routed_ffn_gates_the_top_k_experts_of_the_softmax(renorm):
    from bench.reference import common
    g = torch.Generator().manual_seed(4)
    E, d, f, k = 6, 8, 5, 2
    m = {"router": torch.randn(1, d, E, generator=g),
         "w_gate": torch.randn(1, E, d, f, generator=g),
         "w_up": torch.randn(1, E, d, f, generator=g),
         "w_down": torch.randn(1, E, f, d, generator=g)}
    h = torch.randn(7, d, generator=g)
    spec = {"num_experts_per_tok": k, "norm_topk_prob": renorm}
    out = common.routed_ffn(spec, m, 0, h)
    for t in range(7):
        p = torch.softmax(h[t] @ m["router"][0], -1)
        top = torch.argsort(p, descending=True)[:k]
        w = p[top] / (p[top].sum() if renorm else 1.0)
        want = sum(w[i] * common.swiglu(h[t], m["w_gate"][0, e],
                                        m["w_up"][0, e], m["w_down"][0, e])
                   for i, e in enumerate(top.tolist()))
        assert torch.allclose(out[t], want, atol=1e-5), t


def _frozen_dense(arch, seed, device, dtype=torch.float32):
    """``make_weights`` for dense models as it stood before it took other
    families: its draws must not change."""
    g = torch.Generator(device).manual_seed(weights.seed_int(seed))
    d, hd, L = arch.d_model, arch.hd, arch.n_layers
    H, Hkv = arch.n_heads, arch.n_kv_heads

    def normal(shape, std, mean=0.0):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(mean, std, generator=g)

    def scale(shape):
        return normal(shape, 0.1, 1.0)

    attn = {"wq": normal((L, d, H * hd), d ** -0.5),
            "wk": normal((L, d, Hkv * hd), d ** -0.5),
            "wv": normal((L, d, Hkv * hd), d ** -0.5),
            "wo": normal((L, H * hd, d), (H * hd * 2 * L) ** -0.5)}
    if arch.qkv_bias:
        attn.update(bq=normal((L, H * hd), 0.1), bk=normal((L, Hkv * hd), 0.1),
                    bv=normal((L, Hkv * hd), 0.1))
    if arch.qk_norm:
        attn.update(q_norm=scale((L, hd)), k_norm=scale((L, hd)))
    layers = {"ln1": {"scale": scale((L, d))}, "ln2": {"scale": scale((L, d))},
              "attn": attn}
    f = arch.d_ff
    layers["mlp"] = {"w_gate": normal((L, d, f), d ** -0.5),
                     "w_up": normal((L, d, f), d ** -0.5),
                     "w_down": normal((L, f, d), f ** -0.5)}
    return {"embed": normal((arch.vocab, d), 0.02),
            "lm_head": normal((arch.vocab, d), 0.02),
            "ln_f": {"scale": scale((d,))},
            "layers": layers}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 77, -5])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_dense_weights_are_bit_for_bit_the_frozen_makers(seed, qk_norm):
    arch = dataclasses.replace(_arch(_dense_spec()), qk_norm=qk_norm)
    ours = dict(_leaves(make_weights(arch, seed, "cpu")))
    theirs = dict(_leaves(_frozen_dense(arch, seed, "cpu")))
    assert list(ours) == list(theirs)
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)


def test_routed_weights_are_drawn_by_role_from_the_seed():
    arch = _arch(smoke.moe_config())
    w = dict(_leaves(make_weights(arch, 3, "cpu")))
    again = dict(_leaves(make_weights(arch, 3, "cpu")))
    other = dict(_leaves(make_weights(arch, 4, "cpu")))
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert not any(torch.equal(w[k], other[k]) for k in w)
    d, f, L = arch.d_model, arch.d_expert, arch.n_layers
    want = {"layers.moe.router": (0.0, d ** -0.5),
            "layers.moe.w_gate": (0.0, d ** -0.5),
            "layers.moe.w_down": (0.0, f ** -0.5),
            "layers.attn.wo": (0.0, (arch.n_heads * arch.hd * 2 * L) ** -0.5),
            "embed": (0.0, 0.02), "layers.attn.q_norm": (1.0, 0.1),
            "layers.ln1.scale": (1.0, 0.1)}
    for name, (mean, std) in want.items():
        g = torch.Generator().manual_seed(weights._leaf_seed(3, name))
        drawn = torch.empty(w[name].shape).normal_(mean, std, generator=g)
        assert torch.equal(w[name], drawn), name


def test_a_leaf_of_unknown_role_raises_naming_it():
    from repro_torch.configs import get_smoke
    with pytest.raises(NotImplementedError, match=r"leaf 'layers\.ssm\.\w+'"):
        make_weights(get_smoke("mamba2_1_3b"), 1, "cpu")


def _olmoe_file(**extra):
    """OLMoE-1B-7B's published keys (config.json) that the harness checks."""
    return dict(dict(num_hidden_layers=16, hidden_size=2048,
                     num_attention_heads=16, num_key_value_heads=16,
                     intermediate_size=1024, vocab_size=50304,
                     num_experts=64, num_experts_per_tok=8,
                     rope_theta=10000.0,
                     program={"arch": "olmoe_1b_7b",
                              "fields": {"num_experts": "n_experts",
                                         "num_experts_per_tok": "top_k"}}),
                **extra)


def test_published_keys_are_checked_by_the_files_fields():
    arch = harness.build_arch(_olmoe_file(), smoke.ROOT)
    assert (arch.n_experts, arch.top_k, arch.d_expert) == (64, 8, 1024)
    with pytest.raises(ValueError, match="num_experts_per_tok"):
        harness.build_arch(_olmoe_file(num_experts_per_tok=4), smoke.ROOT)
    # Qwen1.5-MoE: intermediate_size is the shared experts' width, and
    # moe_intermediate_size one routed expert's
    qwen = dict(hidden_size=2048, intermediate_size=5632,
                moe_intermediate_size=1408, num_experts=60,
                num_experts_per_tok=4, vocab_size=151936,
                program={"arch": "qwen2_moe_a2_7b",
                         "fields": {"moe_intermediate_size": "d_expert",
                                    "num_experts": "n_experts",
                                    "num_experts_per_tok": "top_k"}})
    assert harness.build_arch(qwen, smoke.ROOT).d_expert == 1408


@pytest.mark.parametrize("fields", [{"num_experts": "n_routed_experts"},
                                    {"shared_expert_size": "d_expert"}])
def test_a_fields_entry_it_cannot_check_raises(fields):
    conf = _olmoe_file()
    conf["program"]["fields"] = fields
    with pytest.raises(ValueError, match="program.fields"):
        harness.build_arch(conf, smoke.ROOT)


@pytest.mark.parametrize("name", sorted(CASES))
def test_weights_have_the_ports_layout(name):
    from repro_torch.models.model import init_params
    arch = _arch(CASES[name]())

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}
    ours = make_weights(arch, 5, "cpu")
    theirs = init_params(arch, torch.Generator().manual_seed(5), device="cpu")
    assert shapes(ours) == shapes(theirs)
    again = make_weights(arch, 5, "cpu")
    assert torch.equal(ours["layers"]["attn"]["wq"],
                       again["layers"]["attn"]["wq"])
    meta = init_params(arch, None, device="meta")
    assert shapes(meta) == shapes(ours)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert _imports(path) <= {"torch", "math", "__future__"}, path


def test_no_module_the_benchmark_loads_is_jax_or_the_jax_package(tmp_path):
    copy = smoke.make(tmp_path / "checkout")
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(copy)!r})\n"
        "from pathlib import Path\n"
        "import bench.run\n"
        "from bench import harness\n"
        f"harness.run_cell('smoke.chat', 3, 1.0, True, "
        f"t_start=time.monotonic(), device='cpu', root=Path({str(copy)!r}),"
        " log=lambda *a, **k: None)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=copy)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "bench" in top
    assert not top & set(harness.FORBIDDEN)


def test_control_reads_the_same_positions_as_the_check(tmp_path):
    """On the CPU TF32 does not exist, so the control reads the fp32
    reference twice and must find the served tokens first everywhere, and
    ``check`` judges it as it judges the program; on the card it is the
    TF32 reference (``control_gaps``)."""
    copy = smoke.make(tmp_path / "checkout")
    import time
    res = harness.run_cell("smoke.chat", 9, 2.0, False,
                           t_start=time.monotonic(), device="cpu",
                           root=copy, do_check=False,
                           log=lambda *a, **k: None)
    run, w = res["run"], res["weights"]
    picked = check.sample(run.cell, run, 9)
    assert picked and picked[0].output_len == max(
        r.output_len for r in run.recs if r.complete)
    assert any(r.planned.prefix >= 0 for r in picked)
    ref = check.reference(copy, run.cell.config)
    for r in picked:
        served = check.served_gaps(ref, run.cell.config, w, r)
        ctrl = check.control_gaps(ref, run.cell.config, w, r)
        assert served.shape == ctrl.shape == (r.output_len,)
        assert (ctrl == 0).all() and served.max() < 1e-5
    res = check.check(run.cell, run, w, 9, log=lambda *a, **k: None,
                      gaps=check.control_gaps)
    assert res["correct"] and res["requests"] == [r.planned.idx
                                                  for r in picked]


def test_the_routed_control_reads_the_same_positions(tmp_path):
    """Under the routed rule too, the control on the CPU finds every
    served token first, and ``check`` judges it by the same numbers."""
    copy = smoke.make(tmp_path / "checkout")
    import time
    res = harness.run_cell(smoke.SMOKE_MOE, 9, 2.0, False,
                           t_start=time.monotonic(), device="cpu",
                           root=copy, do_check=False,
                           log=lambda *a, **k: None)
    run, w = res["run"], res["weights"]
    ref = check.reference(copy, run.cell.config)
    for r in check.sample(run.cell, run, 9):
        served = check.served_gaps(ref, run.cell.config, w, r)
        ctrl = check.control_gaps(ref, run.cell.config, w, r)
        assert (ctrl == 0).all() and served.max() < 1e-5
    res = check.check(run.cell, run, w, 9, log=lambda *a, **k: None,
                      gaps=check.control_gaps)
    assert res["correct"] and "departing_share" in res["numbers"]


WHY = {"gap_tol": "r", "max_departing_share": "s", "min_requests": "q",
       "min_tokens": "n"}
CHK = dict(gap_tol=1e-3, max_departing_share=0.15, min_requests=3,
           min_tokens=10, why=WHY)


def test_the_routed_rule_holds_the_mean_request_not_each_token():
    quiet = np.zeros(10)
    cascade = np.where(np.arange(10) % 3 == 0, 0.5, 0.0)  # 4 of 10 depart
    rounding = np.full(10, 1e-4)                          # under gap_tol
    numbers, readings = check.routed_rule(
        [quiet, cascade, rounding, quiet], CHK)
    assert readings["shares"] == [0.0, 0.4, 0.0, 0.0]
    assert numbers["departing_share"]["value"] == pytest.approx(0.1)
    assert all(v["holds"] for v in numbers.values())
    assert readings["max_logit_gap"] == 0.5
    # the same departures in every request
    numbers, _ = check.routed_rule([cascade] * 4, CHK)
    assert not numbers["departing_share"]["holds"]
    # too few requests to dilute one
    numbers, _ = check.routed_rule([quiet, quiet], CHK)
    assert not numbers["requests_checked"]["holds"]


@pytest.mark.parametrize("drop", ["gap_tol", "why"])
def test_the_routed_rule_wants_each_limit_with_its_reason(drop):
    chk = dict(CHK, why=dict(WHY))
    if drop == "why":
        del chk["why"]["min_tokens"]
    else:
        del chk[drop]
    with pytest.raises(ValueError, match="routed rule"):
        check.routed_rule([np.zeros(4)] * 4, chk)


@pytest.mark.gpu
def test_the_tf32_control_fails_the_check_on_the_card():
    """At Qwen2-7B's full size, the TF32 reference put in the program's
    place comes out not correct through ``check.check``: at 1,000
    positions of a 2,000-token sequence its choices fall below the fp32
    reference's best by more than the configuration's limit somewhere,
    on each of three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get
    spec = json.loads((BENCH / "configs" / "qwen2_7b_fp32.json").read_text())
    arch = dataclasses.replace(get("qwen2_7b"),
                               **spec["program"]["overrides"])
    for seed in (1, 2, 3):
        w = make_weights(arch, seed, "cuda")
        tokens = torch.randint(1, arch.vocab, (2000,), device="cuda",
                               generator=torch.Generator("cuda")
                               .manual_seed(seed))
        torch.backends.cuda.matmul.allow_tf32 = False
        # the control reads each position after the context before it:
        # here a prompt of 1,000 tokens and 1,000 more as its continuation
        rec = SimpleNamespace(
            planned=SimpleNamespace(prompt=tokens[:1000].cpu().numpy(),
                                    idx=0, prefix=-1),
            tokens=tokens[1000:].cpu().tolist(), output_len=1000,
            complete=True, error=None)
        cell = SimpleNamespace(config=dict(spec, check=dict(
            spec["check"], include=[])), root=BENCH.parent)
        run = SimpleNamespace(recs=[rec])
        ctrl = check.check(cell, run, w, seed, log=lambda *a, **k: None,
                           gaps=check.control_gaps)
        assert not ctrl["correct"], ctrl["numbers"]
        assert ctrl["numbers"]["tokens_checked"]["holds"]
        del w
        torch.cuda.empty_cache()
