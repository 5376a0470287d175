"""chess_rewrite analogue: a peephole pass over the traced ATen graph.

The paper teaches the Chess compiler rules like::

    chess_rewrite int mac_rule(int c, int a, int b)
        {return c + a*b;} -> {return MAC(c,a,b);}

Here the "custom instructions" are ``torch.library`` ops (``marvel::mac``,
``marvel::fusedmac``, ``marvel::fusedconv``).  :func:`rewrite` traces a
function with ``make_fx`` over fake tensors, on the device its tensors live
on; the kernels are single nodes of that graph (``repro_torch.kernels.
library``).  The pass applies the reference's two rules
(``src/repro/core/rewrite.py::rewrite_jaxpr``), following the views and
permutes between the ops:

* ``{mm|addmm|bmm|convolution} -> add(bias) [-> act]`` becomes
  ``marvel::fusedmac`` / ``marvel::fusedconv`` (counted ``fusedmac`` with
  an activation, ``mac`` without);
* ``mul -> add`` whose accumulator has the product's shape and dtype (after
  the reference's rank promotion) becomes ``marvel::mac``.

Each custom op replays the ATen ops it replaced, in their order and with
their arguments, as the reference's custom primitives lower to their plain
chain, so the rewritten program computes what the unrewritten one does.
The user's model code never changes.

As in the reference, only the top level is rewritten: a layer stack under
:func:`~repro_torch.core.profiler.scan` (the reference's ``lax.scan``, one
eqn it does not enter) has its nodes tagged while it is traced
(:func:`scan_body`) and left alone.
"""
from __future__ import annotations

import contextlib
import functools
import json
from typing import Callable

import torch
from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx

SCAN_META = "marvel_scan"
CUSTOM_OPS = ("mac", "fusedmac", "fusedconv")


@contextlib.contextmanager
def scan_body():
    """Tag every graph node traced inside the block (a scan body) so the
    pass leaves it alone; outside a trace, nothing."""
    mode = get_proxy_mode()
    if mode is None:
        yield
        return
    graph = mode.tracer.graph
    before = len(graph.nodes)
    try:
        yield
    finally:
        for node in list(graph.nodes)[before:]:
            node.meta[SCAN_META] = True


# --- the custom instructions -------------------------------------------------
#
# A program is a JSON list of steps [op, args, kwargs]: ``op`` an ATen
# overload's name, the arguments with {"i": k} for the op's k-th input
# tensor and {"s": j} for step j's result; the last step's result is the
# op's output.


def _encode(a, ref: Callable):
    if isinstance(a, torch.fx.Node):
        return ref(a)
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    if isinstance(a, (list, tuple)):
        return [_encode(v, ref) for v in a]
    raise TypeError(f"cannot encode {type(a).__name__} in a program")


def _decode(a, inputs, results):
    if isinstance(a, list):
        return [_decode(v, inputs, results) for v in a]
    if isinstance(a, dict):
        return inputs[a["i"]] if "i" in a else results[a["s"]]
    return a


@functools.lru_cache(maxsize=None)
def _steps(program: str):
    out = []
    for op, args, kwargs in json.loads(program):
        ns, name, overload = op.split(".")
        out.append((getattr(getattr(getattr(torch.ops, ns), name), overload),
                    args, kwargs))
    return out


def _replay(inputs: list[torch.Tensor], program: str) -> torch.Tensor:
    results = []
    for fn, args, kwargs in _steps(program):
        results.append(fn(*_decode(args, inputs, results),
                          **{k: _decode(v, inputs, results)
                             for k, v in kwargs.items()}))
    return results[-1]  # an add or an act: a fresh tensor


OPS = {name: torch.library.custom_op(f"marvel::{name}", _replay,
                                     mutates_args=())
       for name in CUSTOM_OPS}
for _op in OPS.values():
    _op.register_fake(_replay)


# --- the peephole pass -------------------------------------------------------

aten = torch.ops.aten
MATMULS = {aten.mm.default: "dot", aten.bmm.default: "dot",
           aten.addmm.default: "dot_bias", aten.convolution.default: "conv"}
ADDS = {aten.add.Tensor}
# relu (clamp_min with a literal, the reference's max), relu6, sigmoid, tanh
ACTS = {aten.clamp_min.default, aten.relu.default, aten.clamp.default,
        aten.hardtanh.default, aten.sigmoid.default, aten.tanh.default}
VIEWS = {aten.view.default, aten._unsafe_view.default, aten.permute.default,
         aten.transpose.int, aten.t.default, aten.squeeze.dim,
         aten.unsqueeze.default, aten.expand.default, aten.alias.default}


def _sole_user(node) -> torch.fx.Node | None:
    users = list(node.users)
    return users[0] if len(users) == 1 else None


def _through_views(node, outputs):
    """(the views after ``node`` that lead to its single non-view consumer,
    that consumer); (.., None) where the chain branches or reaches a
    program output."""
    views = []
    while True:
        if node in outputs:
            return views, None
        user = _sole_user(node)
        if user is None or user.op != "call_function":
            return views, None
        if user.target not in VIEWS:
            return views, user
        views.append(user)
        node = user


def _is_relu(node) -> bool:
    if node.target is aten.clamp_min.default:
        return isinstance(node.args[1], (int, float))
    return True


def _acc_matches(acc, prod) -> bool:
    """The reference's ``mul -> add`` condition: the accumulator has the
    product's shape (a jnp operand is rank-promoted with leading 1s, not
    broadcast to the full shape) and dtype."""
    if not isinstance(acc, torch.fx.Node):
        return False
    a, p = acc.meta.get("val"), prod.meta.get("val")
    if not (isinstance(a, torch.Tensor) and isinstance(p, torch.Tensor)):
        return False
    promoted = (1,) * (p.ndim - a.ndim) + tuple(a.shape)
    return promoted == tuple(p.shape) and a.dtype == p.dtype


def _program(chain) -> tuple[list, str]:
    """(input nodes, JSON program) replaying ``chain`` in order."""
    inputs: list = []
    index = {n: i for i, n in enumerate(chain)}

    def ref(n):
        if n in index:
            return {"s": index[n]}
        if n not in inputs:
            inputs.append(n)
        return {"i": inputs.index(n)}

    steps = []
    for n in chain:
        steps.append([str(n.target), _encode(list(n.args), ref),
                      {k: _encode(v, ref) for k, v in n.kwargs.items()}])
    return inputs, json.dumps(steps)


def _add_ok(add, prev) -> bool:
    return (add.target in ADDS and add.kwargs.get("alpha", 1) == 1
            and len(add.args) == 2 and prev in add.args)


def _match(node, outputs, taken):
    """(custom op name, stats key, the chain of nodes it replaces) for a
    rule anchored at ``node``, or None."""
    if node in outputs:
        return None
    kind = MATMULS.get(node.target)
    if kind is not None:
        views, nxt = _through_views(node, outputs)
        if kind == "dot_bias":  # addmm: the product and its bias add
            add, chain_end = node, []
        else:
            if nxt is None or nxt in taken or not _add_ok(nxt, (views or
                                                               [node])[-1]):
                return None
            add, chain_end = nxt, views + [nxt]
        act_views, act = _through_views(add, outputs)
        chain = [node] + chain_end
        fused_act = act is not None and act not in taken and \
            act.target in ACTS and _is_relu(act)
        if fused_act:
            chain += act_views + [act]
        op = "fusedconv" if kind == "conv" else "fusedmac"
        return op, "fusedmac" if fused_act else "mac", chain
    if node.target is aten.mul.Tensor:
        views, nxt = _through_views(node, outputs)
        if nxt is None or nxt in taken or not _add_ok(nxt, (views or
                                                           [node])[-1]):
            return None
        prod = (views or [node])[-1]
        acc = nxt.args[1] if nxt.args[0] is prod else nxt.args[0]
        if not _acc_matches(acc, prod):
            return None
        return "mac", "mac", [node] + views + [nxt]
    return None


def rewrite_graph(gm: torch.fx.GraphModule) -> dict:
    """Apply the two rules to ``gm`` in place (top level only: nodes
    tagged by :func:`scan_body` stay); returns the fusion stats."""
    graph = gm.graph
    outputs: set = set()
    torch.fx.node.map_arg(graph.output_node().args,
                          lambda n: outputs.add(n) or n)
    stats = {"mac": 0, "fusedmac": 0}
    taken: set = set()
    plans = []
    for node in list(graph.nodes):
        if node.op != "call_function" or node in taken \
                or node.meta.get(SCAN_META):
            continue
        m = _match(node, outputs, taken)
        if m is None:
            continue
        op, key, chain = m
        try:
            inputs, program = _program(chain)
        except TypeError:
            continue
        taken.update(chain)
        stats[key] += 1
        plans.append((op, chain, inputs, program))
    replaced: dict = {}  # a chain's last node -> its fused node
    for op, chain, inputs, program in plans:
        last = chain[-1]
        with graph.inserting_before(last):
            fused = graph.call_function(
                getattr(torch.ops.marvel, op).default,
                ([replaced.get(n, n) for n in inputs], program))
        fused.meta.update(last.meta)
        last.replace_all_uses_with(fused)
        replaced[last] = fused
        for n in reversed(chain):
            graph.erase_node(n)
    graph.lint()
    gm.recompile()
    return stats


def trace(fn: Callable, *example_args) -> torch.fx.GraphModule:
    """``fn`` traced over fake tensors into an ATen graph (the tensors it
    closes over become the graph's constants, by reference)."""
    with torch.no_grad():
        return make_fx(fn, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(*example_args)


def rewrite(fn: Callable, *example_args) -> tuple[Callable, dict]:
    """Trace ``fn``, apply the peephole pass, return (callable, fusion
    stats).  The callable is the rewritten graph, specialized to
    ``example_args``'s shapes and dtypes: re-rewrite per shape bucket (as
    ``MarvelProgram`` does)."""
    gm = trace(fn, *example_args)
    stats = rewrite_graph(gm)
    return gm, stats


def count_custom_instructions(graph) -> dict:
    """``{"marvel_mac", "marvel_fusedmac", "marvel_fusedconv"}`` node
    counts of a graph (or a GraphModule)."""
    graph = getattr(graph, "graph", graph)
    out = {f"marvel_{name}": 0 for name in CUSTOM_OPS}
    for node in graph.nodes:
        for name in CUSTOM_OPS:
            if node.target is getattr(torch.ops.marvel, name).default:
                out[f"marvel_{name}"] += 1
    return out
