"""The port's sharding rules and step stand-ins against the reference's,
with no process group: ``param_specs``, ``cache_specs`` and every
``shard_fn`` kind's spec equal the JAX package's ``PartitionSpec``s leaf
for leaf on fake meshes; ``launch.steps``' shapes, stand-in trees and
heuristics equal the reference's; the ``shard_fn`` hooks fire where the
reference's fire, and the identity hook changes no bit."""
from __future__ import annotations

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import repro.distributed.sharding as ref_sharding
import repro.launch.steps as ref_steps
from repro.configs import get as ref_get, get_smoke as ref_get_smoke
from repro.models import (decode_step as ref_decode_step,
                          forward as ref_forward, init_params as ref_init,
                          prefill as ref_prefill)
from repro_torch.configs import ARCH_IDS, get, get_smoke
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              ShardingPolicy, cache_specs,
                                              make_shard_fn, map_specs,
                                              named, param_specs)
from repro_torch.launch import steps
from repro_torch.models.model import (decode_step, forward, forward_train,
                                      init_params, prefill)
from repro_torch.training.train import make_loss_fn, value_and_grad
from repro_torch.training.tree import leaves


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    """The reference tests' fake mesh: ``shape`` by name, ``axis_names``."""
    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


MESHES = {
    "16x16": FakeMesh((16, 16), ("data", "model")),
    "2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model")),
    "4x2": FakeMesh((4, 2), ("data", "model")),
    "3x5": FakeMesh((3, 5), ("data", "model")),   # divides nothing
}
TOGGLES = list(itertools.product(("train", "serve"), (True, False),
                                 (True, False), (True, False)))


def policies(mesh):
    """(port policy, reference policy) for every mode and toggle."""
    for mode, sp, fsdp, seq_kv in TOGGLES:
        kw = dict(mode=mode, sp=sp, fsdp=fsdp, seq_sharded_kv=seq_kv)
        yield (ShardingPolicy(mesh, **kw),
               ref_sharding.ShardingPolicy(mesh, **kw), kw)


def ref_tuples(tree):
    """A reference spec tree as nested dicts of plain tuples."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def port_tuples(tree):
    return map_specs(tuple, tree)


_REF_PARAMS: dict = {}


def ref_params_struct(arch: str):
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = ref_steps.params_struct(ref_get(arch))
    return _REF_PARAMS[arch]


# --------------------------------------------------------------------------
# specs, leaf for leaf
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch, mesh):
    port_tree = steps.params_struct(get(arch))
    ref_tree = ref_params_struct(arch)
    for pol, ref_pol, kw in policies(MESHES[mesh]):
        got = port_tuples(param_specs(get(arch), pol, port_tree))
        want = ref_tuples(ref_sharding.param_specs(ref_get(arch), ref_pol,
                                                   ref_tree))
        assert got == want, kw


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_references(arch):
    for batch, max_seq in ((2, 48), (32, 64)):
        port_cache = steps.cache_struct(get_smoke(arch), batch, max_seq)
        ref_cache = ref_steps.cache_struct(ref_get_smoke(arch), batch,
                                           max_seq)
        assert sorted(port_cache) == sorted(ref_cache)
        for mesh in MESHES.values():
            for pol, ref_pol, kw in policies(mesh):
                got = port_tuples(cache_specs(get_smoke(arch), pol,
                                              port_cache))
                want = ref_tuples(ref_sharding.cache_specs(
                    ref_get_smoke(arch), ref_pol, ref_cache))
                assert got == want, (batch, max_seq, kw)


class Shaped:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)


SHAPES_BY_KIND = {
    "act": [(b, s, 64) for b in (1, 3, 32, 256) for s in (1, 15, 32, 4096)],
    "logits": [(b, 8, v) for b in (2, 32) for v in (51865, 151936, 256)],
    "act_decode": [(b, 1, 64) for b in (1, 6, 128)],
    "logits_decode": [(b, v) for b in (1, 32) for v in (50280, 65024)],
    "moe_dispatch": [(b, e, 5, 64) for b in (2, 32) for e in (60, 64, 8)],
    "moe_combine": [(b, e, 5, 64) for b in (2, 32) for e in (60, 64, 8)],
    "kv_stack": [(b, s, 2, 128) for b in (1, 32) for s in (30, 32, 4096)],
    "attn_scores": [(b, 4, 2, q, 32) for b in (1, 32) for q in (7, 32)],
    "dec_scores": [(b, 2, 16, s) for b in (1, 128) for s in (45, 32768)],
    "no_such_kind": [(4, 4)],
}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_fn_specs_equal_the_references(mesh, monkeypatch):
    # the reference's shard_fn, with its constraint returning the spec
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: s)
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda m, s: s)
    cfg, ref_cfg = get("qwen1_5_0_5b"), ref_get("qwen1_5_0_5b")
    for pol, ref_pol, kw in policies(MESHES[mesh]):
        spec_of = make_shard_fn(cfg, pol).spec_of
        ref_fn = ref_sharding.make_shard_fn(ref_cfg, ref_pol)
        for kind, shapes in SHAPES_BY_KIND.items():
            for shape in shapes:
                x = Shaped(shape)
                want = ref_fn(x, kind)
                got = spec_of(kind, x)
                if want is x:
                    assert got is None, (kind, shape, kw)
                else:
                    assert tuple(got) == tuple(want), (kind, shape, kw)


def test_shard_fn_leaves_a_plain_tensor_as_it_is():
    pol = ShardingPolicy(MESHES["4x2"], mode="serve")
    fn = make_shard_fn(get_smoke("qwen1_5_0_5b"), pol)
    x = torch.ones(4, 8, 16)
    for kind in SHAPES_BY_KIND:
        assert fn(x, kind) is x


def test_param_specs_divisibility_guards():
    """whisper vocab 51865 and mamba vocab 50280 must NOT be sharded on a
    16-way axis; qwen vocab 151936 must be (the reference's test)."""
    pol = ShardingPolicy.__new__(ShardingPolicy)
    object.__setattr__(pol, "mesh", MESHES["16x16"])
    object.__setattr__(pol, "mode", "serve")
    object.__setattr__(pol, "sp", True)
    object.__setattr__(pol, "fsdp", True)
    object.__setattr__(pol, "seq_sharded_kv", True)

    for arch, expect_sharded in [("whisper_small", False),
                                 ("mamba2_1_3b", False),
                                 ("qwen1_5_0_5b", True),
                                 ("hymba_1_5b", False)]:
        cfg = get(arch)
        fake = {"embed": np.zeros((cfg.vocab, 8)),
                "lm_head": np.zeros((cfg.vocab, 8))}
        specs = param_specs(cfg, pol, fake)
        sharded = specs["embed"][0] == "model"
        assert sharded == expect_sharded, arch


def test_qwen2_moe_experts_fall_back_to_tp_within_each_expert():
    cfg = get("qwen2_moe_a2_7b")               # 60 experts
    pol = ShardingPolicy(MESHES["16x16"], mode="train")
    specs = param_specs(cfg, pol, steps.params_struct(cfg))["layers"]["moe"]
    assert specs["w_gate"] == P(None, None, None, "model")
    assert specs["w_up"] == P(None, None, None, "model")
    assert specs["w_down"] == P(None, None, "model", None)
    olmoe = get("olmoe_1b_7b")                 # 64 experts: EP
    specs = param_specs(olmoe, pol,
                        steps.params_struct(olmoe))["layers"]["moe"]
    assert specs["w_gate"] == P(None, "model", None, None)


# --------------------------------------------------------------------------
# specs -> placements
# --------------------------------------------------------------------------

def test_named_maps_each_spec_to_one_placement_per_mesh_dim():
    mesh = MESHES["2x16x16"]
    cases = {
        P(("pod", "data"), None): (Shard(0), Shard(0), Replicate()),
        P(None, "model"): (Replicate(), Replicate(), Shard(1)),
        P("data", None, "model"): (Replicate(), Shard(0), Shard(2)),
        P(): (Replicate(), Replicate(), Replicate()),
    }
    for spec, want in cases.items():
        assert NamedSharding(mesh, spec).placements == want
    # an axis of one rank splits nothing
    one = FakeMesh((1, 4), ("data", "model"))
    assert NamedSharding(one, P("data", "model")).placements == \
        (Replicate(), Shard(1))
    tree = named(mesh, {"a": P(None, "model"), "b": {"c": P()}})
    assert tree["a"].placements == (Replicate(), Replicate(), Shard(1))
    assert tree["b"]["c"].spec == P()


def test_partition_spec_normalises_as_jax_does():
    assert P(("data",), None) == ("data", None)
    assert P((), "model") == (None, "model")
    assert tuple(P(("pod", "data"))) == (("pod", "data"),)
    for spec in (P(("data",), None), P((), "model"), P(("pod", "data"))):
        ref = jax.sharding.PartitionSpec(*spec)
        assert tuple(ref) == tuple(spec)


@pytest.mark.parametrize("spec,match", [
    (P("nope"), "not all in the mesh"),
    (P(("data", "pod")), "major-first"),
    (P("model", "model"), "shards two dims")])
def test_named_refuses_a_spec_the_mesh_cannot_hold(spec, match):
    with pytest.raises(ValueError, match=match):
        NamedSharding(MESHES["2x16x16"], spec).placements


# --------------------------------------------------------------------------
# launch.steps without a process group
# --------------------------------------------------------------------------

def test_shapes_and_skip_rules_are_the_references():
    assert {k: dataclasses.astuple(v) for k, v in steps.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_steps.SHAPES.items()}
    for arch in ARCH_IDS:
        for shape in steps.SHAPES:
            assert steps.cell_supported(get(arch), shape) == \
                ref_steps.cell_supported(ref_get(arch), shape)


def test_default_microbatches_are_the_references():
    for arch in ARCH_IDS:
        for mesh in MESHES.values():
            assert steps.default_microbatches(
                get(arch), ShardingPolicy(mesh)) == \
                ref_steps.default_microbatches(
                    ref_get(arch), ref_sharding.ShardingPolicy(mesh))


def test_parse_variant_is_the_references():
    for text in (None, "", "mb=8,attn=dense,grad_rs=1,fsdp=0",
                 "microbatches=2, compress=1, sp=0, seqkv=0",
                 "attn_impl=chunked"):
        assert steps.parse_variant(text) == ref_steps.parse_variant(text)
    for mod in (steps, ref_steps):
        with pytest.raises(ValueError, match="unknown variant key"):
            mod.parse_variant("depth=3")


def dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def same_structs(port_tree, ref_tree) -> None:
    """Leaf for leaf: shape and dtype, the port's on the meta device."""
    got = leaves(port_tree)
    want = jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert dtype_name(a) == str(b.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stand_in_trees_are_the_references(arch):
    """``params_struct`` and every cell's ``input_specs`` (the decode
    cells' caches included) against ``jax.eval_shape``'s, at the
    configs' full sizes, on the meta device."""
    same_structs(steps.params_struct(get(arch)), ref_params_struct(arch))
    for shape in steps.SHAPES:
        if not steps.cell_supported(get(arch), shape)[0]:
            continue
        got = steps.input_specs(get(arch), shape)
        want = ref_steps.input_specs(ref_get(arch), shape)
        assert sorted(got) == sorted(want)
        same_structs(got, want)


# --------------------------------------------------------------------------
# the hooks
# --------------------------------------------------------------------------

FAMILIES = ("qwen1_5_0_5b", "olmoe_1b_7b", "mamba2_1_3b", "hymba_1_5b",
            "whisper_small")


def smoke_inputs(cfg, seed: int = 0):
    g = np.random.default_rng(seed)
    tokens = g.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    labels = g.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    enc = None
    if cfg.family == "encdec":
        enc = (g.standard_normal((2, cfg.enc_frames, cfg.d_model))
               * 0.5).astype(np.float32)
    return tokens, labels, enc


def identity(x, kind):
    return x


@pytest.mark.parametrize("arch", FAMILIES)
def test_identity_hook_is_bitwise_no_hook(arch):
    cfg = get_smoke(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tokens, labels, enc = smoke_inputs(cfg)
    t, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    e = None if enc is None else torch.from_numpy(enc)
    for impl in ("dense", "chunked"):
        a = forward(cfg, params, t, attn_impl=impl, enc_inputs=e)
        b = forward(cfg, params, t, attn_impl=impl, enc_inputs=e,
                    shard_fn=identity)
        assert torch.equal(a, b), impl

    runs = []
    for hook in (None, identity):
        logits, cache = prefill(cfg, params, t, max_seq=16, enc_inputs=e,
                                shard_fn=hook)
        outs = [logits]
        tok = logits.argmax(-1)
        for _ in range(3):
            logits, cache = decode_step(cfg, params, cache, tok,
                                        shard_fn=hook)
            outs.append(logits)
            tok = logits.argmax(-1)
        runs.append((outs, cache))
    (o1, c1), (o2, c2) = runs
    assert all(torch.equal(x, y) for x, y in zip(o1, o2))
    assert sorted(c1) == sorted(c2)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)

    grads = []
    for hook in (None, identity):
        loss, g = value_and_grad(make_loss_fn(cfg, remat=False,
                                              shard_fn=hook))(
            params, t, lab, e)
        grads.append([loss] + leaves(g))
    assert all(torch.equal(x, y) for x, y in zip(*grads))


class Recorder:
    """A ``shard_fn`` that records each (kind, shape) it sees."""

    def __init__(self):
        self.seen: set = set()

    def __call__(self, x, kind):
        self.seen.add((kind, tuple(int(n) for n in x.shape)))
        return x


@pytest.mark.parametrize("arch", FAMILIES)
def test_hooks_see_what_the_references_see(arch):
    """Forward (the training path), prefill and decode_step, dense
    attention: the same set of (kind, shape) pairs as the reference's hook
    on the same inputs (the reference run without jit; its scan traces
    each layer once, the port's loop calls each layer's hooks)."""
    import jax.numpy as jnp

    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    ref_params = ref_init(ref_cfg, jax.random.PRNGKey(0))
    tokens, labels, enc = smoke_inputs(cfg)
    t = torch.from_numpy(tokens)
    e = None if enc is None else torch.from_numpy(enc)
    je = None if enc is None else jnp.asarray(enc)

    port, ref = Recorder(), Recorder()
    forward_train(cfg, params, t, enc_inputs=e, shard_fn=port)
    ref_forward(ref_cfg, ref_params, jnp.asarray(tokens), enc_inputs=je,
                shard_fn=ref)
    assert port.seen == ref.seen

    port, ref = Recorder(), Recorder()
    logits, cache = prefill(cfg, params, t, max_seq=16, enc_inputs=e,
                            shard_fn=port)
    decode_step(cfg, params, cache, logits.argmax(-1), shard_fn=port)
    ref_logits, ref_cache = ref_prefill(ref_cfg, ref_params,
                                        jnp.asarray(tokens), 16,
                                        enc_inputs=je, shard_fn=ref)
    ref_decode_step(ref_cfg, ref_params, ref_cache,
                    jnp.argmax(ref_logits, -1).astype(jnp.int32),
                    shard_fn=ref)
    assert port.seen == ref.seen
    kinds = {k for k, _ in port.seen}
    assert {"act", "logits", "act_decode", "logits_decode"} <= kinds
    if cfg.family != "ssm":
        assert {"kv_stack", "dec_scores"} <= kinds
    if cfg.family not in ("ssm", "encdec"):     # enc-dec: no score hook
        assert "attn_scores" in kinds
    if cfg.family == "moe":
        assert {"moe_dispatch", "moe_combine"} <= kinds
