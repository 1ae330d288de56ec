"""The published OLMoE-1B-7B configuration (``configs/olmoe_1b_7b_fp32.json``)
and its cell on the CPU: ``build_arch`` takes the file and checks its
``program.fields``; the reference, loaded from the checkout, agrees with
the port at smoke widths through the file's own overrides; the file at
smoke widths runs as a cell under the routed rule, and the published
gates put back to the renormalised ones come out not correct; the
``moe.slot_fill_share`` reader."""
from __future__ import annotations

import dataclasses
import json
import time
from types import SimpleNamespace

import pytest
import torch

from bench import check, harness
from bench.tests import smoke
from bench.weights import make_weights

CELL = "olmoe_1b_7b.decode_long"
SMOKE_CELL = "smoke.olmoe_published"
SEED = 2**33 + 5


def published() -> dict:
    return json.loads((smoke.ROOT / "bench" / "configs"
                       / "olmoe_1b_7b_fp32.json").read_text())


def smoke_published() -> dict:
    """The published file at the port's OLMoE smoke widths (8 experts,
    top-2, capacity factor E / k = 4: dropless); its published points
    (QK-norm over the projection, gates not renormalised, epsilon 1e-5)
    stay."""
    c = published()
    c.update(smoke.MOE)
    c["program"]["overrides"].update(smoke.MOE_ARCH)
    c["serve"]["num_blocks"] = 400
    c["check"].update(min_tokens=20)
    return c


def test_build_arch_takes_the_published_file_and_checks_its_fields():
    c = published()
    arch = harness.build_arch(c, smoke.ROOT)
    assert (arch.n_layers, arch.d_model, arch.n_experts, arch.top_k,
            arch.d_expert, arch.vocab) == (16, 2048, 64, 8, 1024, 50304)
    assert (arch.qk_norm, arch.qk_norm_whole, arch.norm_topk_prob,
            arch.norm_eps, arch.capacity_factor) == (True, True, False,
                                                     1e-5, 8.0)
    assert c["program"]["fields"] == {
        "rms_norm_eps": "norm_eps", "norm_topk_prob": "norm_topk_prob",
        "num_experts": "n_experts", "num_experts_per_tok": "top_k"}
    for key, other in (("rms_norm_eps", 1e-6), ("norm_topk_prob", True),
                       ("num_experts", 60), ("num_experts_per_tok", 4),
                       ("intermediate_size", 2048)):
        with pytest.raises(ValueError):
            harness.build_arch(dict(c, **{key: other}), smoke.ROOT)


def test_the_cell_reports_every_metric_but_the_prefix_cache():
    cell = harness.load_cell(CELL, smoke.ROOT)
    bench = json.loads((smoke.ROOT / "BENCHMARK.json").read_text())
    assert [m["name"] for m in cell.end_to_end] == ["tdg_ratio", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in bench["per_layer"]
        if m["name"] != "prefix.hit_share"]
    assert "shared_prefixes" not in cell.mix


def test_the_reference_from_the_checkout_equals_the_ports_forward():
    from repro_torch.models.model import forward
    spec = smoke_published()
    arch = harness.build_arch(spec, smoke.ROOT)
    assert (arch.qk_norm_whole, arch.norm_topk_prob, arch.norm_eps) == \
        (True, False, 1e-5)
    w = make_weights(arch, SEED, "cpu")
    assert w["layers"]["attn"]["q_norm"].shape == (2, 4 * 16)
    tokens = torch.randint(1, arch.vocab, (70,),
                           generator=torch.Generator().manual_seed(1))
    ref = check.reference(smoke.ROOT, spec).logits(spec, w, tokens,
                                                   torch.arange(70))
    port = forward(arch, w, tokens[None].int())[0]
    assert torch.allclose(ref, port, atol=2e-5, rtol=1e-5), \
        (ref - port).abs().max()


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A checkout with the published file at smoke widths, a short mix
    of the cell's shape and a cell of the two, added as files and
    entries."""
    dst = smoke.make(tmp_path_factory.mktemp("bench") / "checkout")
    (dst / "bench" / "configs" / "smoke_olmoe_published.json").write_text(
        json.dumps(smoke_published()))
    mix = json.loads((dst / "bench" / "traffic"
                      / "decode_long.json").read_text())
    mix.update(rate_per_s=12.0, ramp_s=0.5, drain_limit_s=60.0,
               prompt_tokens={"mean": 48, "sigma": 0.6, "min": 8, "max": 96},
               output_tokens={"mean": 16, "sigma": 0.5, "min": 8, "max": 32},
               warmup={"requests": 3, "output_tokens": 4})
    (dst / "bench" / "traffic" / "smoke_decode_long.json").write_text(
        json.dumps(mix))
    b = json.loads((dst / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "smoke_olmoe_published",
                         "source": published()["source"],
                         "file": "bench/configs/smoke_olmoe_published.json",
                         "reduced": [], "why": "a test's"})
    cells = {w["name"]: w for w in b["workloads"]}
    b["workloads"].append(dict(cells[CELL], name=SMOKE_CELL,
                               config="smoke_olmoe_published",
                               traffic="smoke_decode_long"))
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(SMOKE_CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return dst


def run(copy, trace=False):
    return harness.run_cell(SMOKE_CELL, SEED, 2.0, trace,
                            t_start=time.monotonic(), device="cpu",
                            root=copy, log=lambda *a, **k: None)


def test_the_published_model_runs_as_a_cell_and_is_correct(copy):
    res = run(copy, trace=True)
    chk = res["check"]
    assert chk["correct"], chk["numbers"]
    assert chk["numbers"]["departing_share"]["value"] == 0.0
    r = res["run"]
    assert (r.arch.qk_norm_whole, r.arch.norm_topk_prob) == (True, False)
    assert len(r.measured) == 24 and not any(x.failed for x in r.measured)
    share = res["metrics"]["moe.slot_fill_share"]["value"]
    # a decode row routes top_k of the E rows it computes; the packed
    # prefill's padding fills fewer
    assert 0 < share <= 100.0 * r.arch.top_k / r.arch.n_experts
    assert "prefix.hit_share" not in res["metrics"]


def test_renormalised_gates_in_the_program_are_not_correct(copy,
                                                          monkeypatch):
    build = harness.build_system

    def renormalised(arch, *a, **k):
        return build(dataclasses.replace(arch, norm_topk_prob=True), *a,
                     **k)
    monkeypatch.setattr(harness, "build_system", renormalised)
    nums = run(copy)["check"]["numbers"]
    assert not nums["departing_share"]["holds"], nums


def test_a_program_that_lost_the_whole_projection_norm_cannot_pass(
        copy, monkeypatch):
    """The file states no key for the QK-norm's form, so
    ``program.fields`` cannot hold the program to it; the weights then
    follow the program's layout.  A program back on per-head QK-norm
    hands the reference per-head scales, which it refuses."""
    build = harness.build_arch

    def per_head(*a, **k):
        return dataclasses.replace(build(*a, **k), qk_norm_whole=False)
    monkeypatch.setattr(harness, "build_arch", per_head)
    with pytest.raises(ValueError, match="whole q projection"):
        run(copy)


def test_the_reference_refuses_per_head_scales():
    spec = smoke_published()
    arch = dataclasses.replace(harness.build_arch(spec, smoke.ROOT),
                               qk_norm_whole=False)
    w = make_weights(arch, SEED, "cpu")
    assert w["layers"]["attn"]["q_norm"].shape == (2, 16)
    with pytest.raises(ValueError, match="whole q projection"):
        check.reference(smoke.ROOT, spec).logits(
            spec, w, torch.arange(1, 9), torch.arange(8))


def _span(t0, attrs, name="model_exec.launch"):
    from repro_torch.obs import Span
    return Span(name, t0, t0 + 0.01, 1, 0, 0, None, attrs)


def _reading(spans):
    run = SimpleNamespace(window=(10.0, 20.0),
                          _program_spans={"spans": spans})
    return harness.load_reader(smoke.ROOT, "moe.slot_fill_share")(run)


def test_slot_fill_share_reads_the_windows_routed_launches():
    inside = [_span(11.0, {"kind": "decode", "rows": 3, "tokens": 3,
                           "moe_routed": 16 * 3 * 8,
                           "moe_rows": 16 * 64 * 4}),
              _span(12.0, {"kind": "prefill", "rows": 2, "tokens": 300,
                           "moe_routed": 16 * 300 * 8,
                           "moe_rows": 16 * 64 * 512})]
    outside = [_span(5.0, {"kind": "decode", "rows": 1, "tokens": 1,
                           "moe_routed": 128, "moe_rows": 1024}),
               _span(19.995, {"kind": "decode", "rows": 1, "tokens": 1,
                              "moe_routed": 128, "moe_rows": 1024})]
    other = [_span(13.0, {"kind": "decode", "rows": 2, "tokens": 2}),
             _span(14.0, {"moe_routed": 1, "moe_rows": 1}, "engine.step")]
    got = _reading(inside + outside + other)
    want = 100.0 * (3 * 8 + 300 * 8) / (64 * 4 + 64 * 512)
    assert got == pytest.approx(want)


def test_slot_fill_share_gives_none_without_a_routed_launch():
    dense = [_span(11.0, {"kind": "decode", "rows": 2, "tokens": 2})]
    assert _reading(dense) is None
    assert _reading([]) is None
    assert _reading(None) is None
