"""Cost model over the traced per-rank program (port of
``repro.launch.hlo_cost``).

The reference parses the compiled SPMD HLO module, one per device, and
weights each while body by its trip count.  The port compiles nothing:
its per-rank program is the ``torch.fx`` graph that ``trace_step``
records, the aten ops each rank runs on its local shards with the
``_c10d_functional`` collectives between them.  This module walks that
graph.  There is no ``xla_cost_analysis`` counterpart: no compiler
counts anything.

All numbers are PER RANK:

  * flops        -- every node ``torch.utils.flop_counter`` has a formula
                    for (mm, bmm, addmm, convolution, attention), from the
                    node's local shapes
  * bytes        -- what eager PyTorch moves to and from device memory,
                    one kernel per node.  This departs from the
                    reference, which leaves elementwise ops out because
                    XLA fuses them on the TPU; eager fuses nothing:
                      - a node that makes a new storage: its operand bytes
                        plus its result bytes;
                      - a view or alias (its result lies in an
                        argument's storage, unwritten), ``getitem``,
                        ``wait_tensor``: nothing;
                      - an in-place write into part of a buffer
                        (``copy_`` into a slice, ``index_put_``,
                        ``scatter_``): the update read and written, and
                        any index read (the reference's
                        dynamic-update-slice rule);
                      - an indexed read (``index_select``, ``index``,
                        ``gather``, ``embedding``): the rows it returns,
                        read and written, and the index (the reference's
                        dynamic-slice rule);
                      - a factory (``zeros``, ``full``, ``*_like``): the
                        bytes it writes (``empty``: none);
                      - a collective: its result bytes, also counted under
                        ``collectives`` (as the reference adds them)
  * collectives  -- per kind, the result bytes of each collective node

A tensor's bytes are those of the memory it spans: an expanded (stride
0) dim is read once.  The layer and microbatch loops are Python loops,
so the trace unrolls them and every node counts once; a node may carry
``meta["trip"]``, a weight like the reference's ``known_trip_count``.
"""
from __future__ import annotations

import collections
import contextlib
import operator
from typing import Callable, Sequence

import torch
from torch.distributed.tensor import DTensor
from torch.fx import GraphModule, Node
from torch.fx.node import map_arg
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         is_traceable_wrapper_subclass_type)
from torch.utils.flop_counter import flop_registry

from ..training.tree import leaves, unflatten
from .steps import place

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
# the wait, and eager's wrapper around an async collective's result:
# aliases of their argument
_FREE_OPS = {"_c10d_functional.wait_tensor",
             "_c10d_functional._wrap_tensor_autograd"}
# in-place writes into part of a buffer: op -> position of the update
_UPDATE_OPS = {"aten.copy_": 1, "aten.index_put_": 2,
               "aten._index_put_impl_": 2, "aten.scatter_": 3,
               "aten.scatter_add_": 3, "aten.scatter_reduce_": 3,
               "aten.index_copy_": 3, "aten.masked_scatter_": 2}
_INDEXED_READS = {"aten.index_select", "aten.index", "aten.gather",
                  "aten.embedding"}
_EMPTY_OPS = {"aten.empty", "aten.empty_like", "aten.empty_strided",
              "aten.new_empty", "aten.new_empty_strided"}


def _name(node: Node) -> str:
    """``namespace.op`` of a node's overload packet ('' for a Python
    callable such as ``getitem``)."""
    target = node.target
    if isinstance(target, torch._ops.OpOverload):
        return f"{target.namespace}.{target._schema.name.split('::')[1]}"
    return ""


def _tensor_bytes(t) -> int:
    """Bytes of the memory a tensor spans: an expanded dim counts once."""
    if not isinstance(t, torch.Tensor) or t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _vals(node: Node) -> list:
    """The node's results as a list (a multi-result op gives several)."""
    val = node.meta.get("val")
    return list(val) if isinstance(val, (tuple, list)) else [val]


def _arg_vals(node: Node):
    return (map_arg(node.args, lambda n: n.meta.get("val")),
            map_arg(node.kwargs, lambda n: n.meta.get("val")))


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def _writes_in_place(node: Node) -> bool:
    """Whether the op's schema says it writes its result into an
    argument (``add_``, ``copy_``, ``index_put_``)."""
    target = node.target
    if not isinstance(target, torch._ops.OpOverload):
        return False
    returns = target._schema.returns
    return bool(returns and returns[0].alias_info is not None
                and returns[0].alias_info.is_write)


def _flops(node: Node) -> int:
    formula = flop_registry.get(getattr(node.target, "overloadpacket", None))
    if formula is None:
        return 0
    args, kwargs = _arg_vals(node)
    return int(formula(*args, **kwargs, out_val=node.meta.get("val")))


def node_cost(node: Node) -> tuple[int, int, str | None]:
    """(flops, bytes, collective kind or None) of one node, unweighted."""
    if node.op != "call_function":
        return 0, 0, None
    name = _name(node)
    if not name or name in _FREE_OPS:
        return 0, 0, None
    out_b = sum(_tensor_bytes(v) for v in _vals(node))
    kind = _COLLECTIVE_OPS.get(name)
    if kind is not None:
        return 0, out_b, kind
    if name.startswith(("_c10d_functional.", "_dtensor.")):
        raise ValueError(f"collective {node.target} has no kind in "
                         "hlo_cost._COLLECTIVE_OPS")
    args, kwargs = _arg_vals(node)
    if name in _UPDATE_OPS:
        # the update read and written into argument 0, and any index read
        dst, upd = args[0], args[_UPDATE_OPS[name]]
        idx = [t for t in _tensors((args[1:], kwargs))
               if t is not upd and not t.is_floating_point()]
        if name == "aten.copy_":
            written = _tensor_bytes(dst)
        else:
            n = upd.numel() if isinstance(upd, torch.Tensor) \
                else max((t.numel() for t in idx), default=0)
            written = n * dst.element_size()
        return (0, _tensor_bytes(upd) + written
                + sum(map(_tensor_bytes, idx)), None)
    in_place = _writes_in_place(node)
    if not in_place:
        held = {_storage(t) for t in _tensors((args, kwargs))}
        if set(_node_storages(node)) <= held:
            return 0, 0, None                     # a view or an alias
    if name in _INDEXED_READS:
        idx = [t for t in _tensors((args[1:], kwargs))
               if not t.is_floating_point()]
        return 0, 2 * out_b + sum(map(_tensor_bytes, idx)), None
    if name in _EMPTY_OPS:
        return 0, 0, None
    operands = _tensors((args, kwargs))
    if name.endswith("_like") or not operands:
        return 0, out_b, None                              # a factory
    if in_place and name in ("aten.fill_", "aten.zero_"):
        return 0, _tensor_bytes(args[0]), None
    return _flops(node), sum(map(_tensor_bytes, operands)) + out_b, None


def _trip(node: Node) -> int:
    return int(node.meta.get("trip", 1))


def analyze(graph) -> dict:
    """Per-rank flops, bytes and collectives of a traced program (a
    ``GraphModule`` or its ``Graph``), under the reference's keys."""
    g = getattr(graph, "graph", graph)
    flops = 0
    bytes_hbm = 0
    coll = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for node in g.nodes:
        f, b, kind = node_cost(node)
        m = _trip(node)
        flops += m * f
        bytes_hbm += m * b
        if kind is not None:
            coll[kind] += m * b
            counts[kind] += m
    return {"flops": flops, "bytes": bytes_hbm,
            "collectives": {**coll, "total": sum(coll.values()),
                            "counts": counts}}


def breakdown(graph, top: int = 15):
    """Debug: the largest byte contributors as ((op, trip, result shape),
    bytes) rows, and ``analyze``'s totals."""
    g = getattr(graph, "graph", graph)
    rows = collections.Counter()
    for node in g.nodes:
        _, b, _ = node_cost(node)
        if not b:
            continue
        val = _vals(node)[0]
        shape = (f"{str(val.dtype).replace('torch.', '')}"
                 f"{list(val.shape)}" if isinstance(val, torch.Tensor)
                 else "?")
        rows[(_name(node), _trip(node), shape[:64])] += _trip(node) * b
    return rows.most_common(top), analyze(graph)


# --------------------------------------------------------------------------
# memory: arguments, outputs, aliases, and the live set walked in order
# --------------------------------------------------------------------------

def _storage(t) -> int | None:
    """The identity of a tensor's storage (a view shares its base's)."""
    return t.untyped_storage()._cdata if isinstance(t, torch.Tensor) \
        else None


def _node_storages(node: Node) -> list:
    return [k for k in map(_storage, _vals(node)) if k is not None]


def memory_analysis(graph) -> dict:
    """Per-rank bytes: ``argument`` (the placeholders), ``output`` (the
    storages the outputs hold), ``alias`` (outputs that are an argument's
    storage, such as a cache written in place), ``temp`` (the peak of the
    live intermediates, outputs and arguments apart) and ``peak`` (the
    peak of everything the program allocates, outputs included: what a
    run adds to the memory its inputs hold).  A storage lives from the
    node that first holds it to its last use (a view or an in-place
    result shares its base's storage); nodes run in graph order.  Needs
    the graph ``trace`` records: its values are the traced (meta)
    tensors themselves, so storage identity is the traced run's."""
    g = getattr(graph, "graph", graph)
    order = list(g.nodes)
    # a wait, or eager's wrapper around an async result, holds its
    # argument's storage (on meta tensors the wrapper's shape function
    # returns a fresh tensor instead)
    same: dict = {}
    for node in order:
        if _name(node) in _FREE_OPS:
            src = _storage(_arg_vals(node)[0][0])
            for k in _node_storages(node):
                same[k] = same.get(src, src)

    def storages(n: Node) -> list:
        return [same.get(k, k) for k in _node_storages(n)]

    size: dict = {}
    born: dict = {}
    args, held = set(), set()
    for i, node in enumerate(order):
        for t in _vals(node):
            k = _storage(t)
            k = same.get(k, k)
            if k is not None and k not in born:
                born[k] = i
                size[k] = t.untyped_storage().nbytes()
                if node.op == "placeholder":
                    args.add(k)
                # a tensor made before the program (a get_attr constant)
                # is held already: neither an argument nor allocated here
                if node.op in ("placeholder", "get_attr"):
                    held.add(k)
    last: dict = {}
    for i, node in enumerate(order):
        map_arg((node.args, node.kwargs),
                lambda n: last.update((k, i) for k in storages(n)))
    out_node = next(n for n in order if n.op == "output")
    outs = set()
    map_arg(out_node.args, lambda n: outs.update(storages(n)))
    starts = collections.defaultdict(list)
    ends = collections.defaultdict(list)
    for k, i in born.items():
        if k in held:
            continue
        starts[i].append(k)
        if k not in outs:
            ends[max(i, last.get(k, i))].append(k)
    live = live_out = temp = peak = 0
    for i in range(len(order)):
        for k in starts.get(i, ()):
            if k in outs:
                live_out += size[k]
            else:
                live += size[k]
        temp = max(temp, live)
        peak = max(peak, live + live_out)
        for k in ends.get(i, ()):
            live -= size[k]
    return {"argument": sum(size[k] for k in args),
            "output": sum(size[k] for k in outs),
            "alias": sum(size[k] for k in outs & args),
            "temp": temp, "peak": peak}


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------

class _Recorder(TorchDispatchMode):
    """Records every op that reaches the dispatcher on plain tensors into
    an fx ``Graph``, the op's results kept as ``meta["val"]``.  An op on
    DTensors is left to DTensor (``NotImplemented``), which runs it as
    local ops and collectives that come back here: the graph is the
    per-rank program.  (``make_fx`` in "real" mode records the same ops;
    it also builds a proxy and a fake snapshot of every value, which
    makes a full-width trace ten times slower.)"""

    def __init__(self):
        super().__init__()
        self.graph = torch.fx.Graph()
        self.node_of: dict = {}          # id(tensor) -> Node
        self.paused = False
        self.trip = 1                    # weight of the nodes made now
        self.consts: dict = {}           # name -> tensor made before

    def placeholder(self, t: torch.Tensor) -> Node:
        node = self.graph.placeholder(f"arg{len(self.node_of)}")
        node.meta["val"] = t
        self.node_of[id(t)] = node
        return node

    def _arg(self, x):
        if isinstance(x, torch.Tensor):
            node = self.node_of.get(id(x))
            if node is None:                 # made before the trace
                name = f"_const{len(self.consts)}"
                self.consts[name] = x
                node = self.graph.get_attr(name)
                node.meta["val"] = x
                self.node_of[id(x)] = node
            return node
        if isinstance(x, (tuple, list)):
            return type(x)(self._arg(y) for y in x)
        if isinstance(x, dict):
            return {k: self._arg(v) for k, v in x.items()}
        return x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_traceable_wrapper_subclass_type(t) for t in types):
            return NotImplemented            # DTensor, an async result
        out = func(*args, **kwargs)
        if self.paused:
            return out
        node = self.graph.call_function(func, self._arg(tuple(args)),
                                        self._arg(kwargs))
        node.meta["val"] = out
        if self.trip != 1:
            node.meta["trip"] = self.trip
        if isinstance(out, (tuple, list)):
            for i, x in enumerate(out):
                if isinstance(x, torch.Tensor):
                    item = self.graph.call_function(operator.getitem,
                                                    (node, i))
                    item.meta["val"] = x
                    self.node_of[id(x)] = item
        elif isinstance(out, torch.Tensor):
            self.node_of[id(out)] = node
        return out

    def output(self, outs) -> GraphModule:
        self.graph.output([self._arg(x) for x in outs])
        root = torch.nn.Module()
        for name, t in self.consts.items():
            root.register_buffer(name, t)
        return GraphModule(root, self.graph)


_RECORDING: list = []


def trace(fn: Callable, *tensors: torch.Tensor) -> GraphModule:
    """The program ``fn(*tensors)`` runs, as a ``GraphModule`` whose
    placeholders are ``tensors`` and whose outputs are ``fn``'s result
    (a tensor or a list of tensors).  Run it on meta tensors: nothing is
    allocated then."""
    rec = _Recorder()
    for t in tensors:
        rec.placeholder(t)
    _RECORDING.append(rec)
    try:
        with rec, _traced_as_on_the_card():
            out = fn(*tensors)
    finally:
        _RECORDING.pop()
    return rec.output(out if isinstance(out, (tuple, list)) else [out])


@contextlib.contextmanager
def _traced_as_on_the_card():
    """DTensor, patched for the trace only:

    * On a CPU mesh DTensor turns a Shard(i) -> Shard(j) redistribution
      into an all-gather and a chunk (gloo has no all-to-all); on CUDA it
      runs ``_dtensor.shard_dim_alltoall``.  The trace runs on meta
      tensors, where that op has a shape function, so it records the op
      the cards would run.
    * Planning is not the program, and runs unrecorded: the sharding
      propagator runs each new op on fake tensors for its output's
      shape, and the redistribution planner finds a ``_StridedShard``'s
      local size by splitting an ``arange`` on the host."""
    from torch.distributed.tensor import _sharding_prop
    from torch.distributed.tensor import placement_types as pt

    saved = []

    def patch(owner, name, make):
        orig = getattr(owner, name, None)
        if orig is not None:
            saved.append((owner, name, owner.__dict__[name]))
            setattr(owner, name, make(orig))

    def alltoall(orig):
        def fn(input, gather_dim, shard_dim, mesh, mesh_dim):
            if mesh.device_type != "cpu" or not input.is_meta:
                return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim,
                mesh.get_group(mesh_dim).group_name)
        return fn

    def unrecorded(orig):
        def fn(*args, **kwargs):
            rec = _RECORDING[-1]
            was, rec.paused = rec.paused, True
            try:
                return orig(*args, **kwargs)
            finally:
                rec.paused = was
        return fn

    patch(pt, "shard_dim_alltoall", alltoall)
    patch(_sharding_prop.ShardingPropagator,
          "_propagate_tensor_meta_non_cached", unrecorded)
    if hasattr(pt, "_StridedShard"):
        patch(pt._StridedShard, "local_shard_size_and_offset", unrecorded)
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


@contextlib.contextmanager
def one_microbatch():
    """While active, a train step traced here runs two iterations of its
    microbatch loop, the second weighted by the count less one (the
    reference weights a while body by its ``known_trip_count``).  The
    first iteration moves slightly fewer bytes than the rest (its
    gradient sum starts from the zeros' placements); every later one runs
    the same ops, which ``tests/test_torch_hlo_cost.py`` checks against
    the unrolled trace."""
    from ..training import train

    def loop(n: int):
        rec = _RECORDING[-1]
        base = rec.trip
        for i, weight in ((0, 1), (1, n - 1))[:n]:
            rec.trip = base * weight
            try:
                yield i
            finally:
                rec.trip = base

    saved, train.microbatch_loop = train.microbatch_loop, loop
    try:
        yield
    finally:
        train.microbatch_loop = saved


def trace_step(step: Callable, args: Sequence) -> GraphModule:
    """The per-rank program of a ``launch.steps`` step on ``args`` (trees
    of meta tensors, such as the ``structs`` a ``build_*`` returns).

    The inputs are placed with ``steps.place`` BEFORE tracing, as the
    reference's jit takes its inputs already sharded: placing is not part
    of the step.  The traced function takes each rank's local shards,
    wraps them as DTensors and returns the outputs' local shards, so the
    graph holds the local aten ops and the collectives between them.  It
    runs on the meta tensors themselves, not under ``FakeTensorMode``:
    DTensor's redistribution planner reads a ``_StridedShard``'s local
    sizes with ``tolist()``, which a fake tensor cannot answer on a
    multi-rank mesh.  Placeholders are the local shards in
    ``training.tree.leaves`` order; outputs likewise."""
    placed = tuple(a if a is None else place(a, s)
                   for a, s in zip(args, step.in_shardings))
    flat = leaves(placed)
    specs = [(x.device_mesh, x.placements, x.shape, x.stride())
             for x in flat]

    def program(*local):
        dts = [DTensor.from_local(t, m, p, shape=s, stride=st,
                                  run_check=False)
               for t, (m, p, s, st) in zip(local, specs)]
        out = step(*unflatten(placed, dts))
        return [x.to_local() if isinstance(x, DTensor) else x
                for x in leaves(out)]

    return trace(program, *[x.to_local() for x in flat])


__all__ = ["COLLECTIVES", "analyze", "breakdown", "memory_analysis",
           "node_cost", "trace", "trace_step"]
