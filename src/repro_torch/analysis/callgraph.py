"""Lightweight per-module call graph seeded at capture boundaries and at
the port's device steps.  Port of ``repro.analysis.callgraph``.

The linter's reachability questions are "can this code run under CUDA
graph capture or ``torch.compile``?" and "does this code drive a device
step from a host loop?".  Both are answered per module, from the AST
alone:

* **Traced entry points** — functions handed to ``torch.compile`` /
  ``torch.cuda.make_graphed_callables`` (as decorators, direct
  arguments, or lambdas lexically inside the wrapper call), and the
  body of a ``with torch.cuda.graph(g):`` block.  Everything reachable
  from one through the module's own call edges is *traced-reachable*: a
  host sync or a Python branch on a tensor value there raises under
  capture or breaks the compiled graph (JAX01/JAX03), not a style
  choice.
* **Device steps** — the reference binds its decode, prefill, paged
  block and train step from ``jax.jit(...)``; the port calls the same
  callables as plain functions and methods.  :data:`DEVICE_STEPS` names
  them.  A function that transitively calls one is *hot*: it drives the
  device pipeline, and blocking host syncs inside its loops serialize
  decode (the scheduler's "ONE host sync per block" discipline).
* **Loop-called closure** — functions invoked (transitively) from inside
  a loop statement of a hot function.  Their whole body sits on the hot
  path even when the sync itself is not lexically inside a ``while``.

Resolution is name-based and intra-module: ``self.engine.decode(...)``
resolves by its attribute *tail* to any same-module function or method
of that name, without a whole-program type inference pass.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional

# The port's device steps: the callables the reference wraps in jax.jit
# (Engine._decode/_prefill/_prefill_padded/_splice, PagedScheduler._block/
# _resume/_splice, the trainer's step_fn), by the names the port calls.
DEVICE_STEPS = frozenset({
    "decode", "decode_step", "prefill", "prefill_single", "prefill_resume",
    "splice_slot", "splice_request", "_run_block", "step_fn",
})

_CAPTURE_WRAPPERS = {"torch.compile", "torch.cuda.make_graphed_callables",
                     "cuda.make_graphed_callables", "make_graphed_callables"}
_CAPTURE_BLOCKS = {"torch.cuda.graph", "cuda.graph"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_tail(node: ast.Call) -> Optional[str]:
    """The final name of the call target: ``self.engine.decode(...)``
    -> ``"decode"``; ``np.asarray(...)`` -> ``"asarray"``."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def call_root(node: ast.Call) -> Optional[str]:
    """The leftmost name of the call target chain (``np`` for
    ``np.asarray``), or the bare name itself."""
    f = node.func
    while isinstance(f, ast.Attribute):
        f = f.value
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_capture_expr(node: ast.AST) -> bool:
    """Does this expression denote ``torch.compile`` /
    ``make_graphed_callables`` (called with options, or a partial)?"""
    if dotted_name(node) in _CAPTURE_WRAPPERS:
        return True
    if isinstance(node, ast.Call):
        if dotted_name(node.func) in _CAPTURE_WRAPPERS:
            return True            # @torch.compile(mode=...)
        if call_tail(node) == "partial" and node.args \
                and _is_capture_expr(node.args[0]):
            return True
    return False


def is_capture_block(node: ast.AST) -> bool:
    """A ``with torch.cuda.graph(g):`` statement."""
    return isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(it.context_expr, ast.Call)
        and dotted_name(it.context_expr.func) in _CAPTURE_BLOCKS
        for it in node.items)


@dataclasses.dataclass(eq=False)   # identity hash: one node, one info
class FuncInfo:
    """One function/method/lambda of the module, or one capture block."""

    node: ast.AST                      # FunctionDef | Lambda | With
    name: str
    qualname: str
    cls: Optional[str] = None          # enclosing class name
    entry: set = dataclasses.field(default_factory=set)   # {"compile","graph"}
    calls: set = dataclasses.field(default_factory=set)       # tails, anywhere
    loop_calls: set = dataclasses.field(default_factory=set)  # tails inside loops

    @property
    def is_entry(self) -> bool:
        return bool(self.entry)


class ModuleIndex:
    """AST index of one module: functions, capture boundaries, device
    steps, reachability."""

    def __init__(self, tree: ast.Module, path: str = "<module>"):
        self.tree = tree
        self.path = path
        self.funcs: dict[int, FuncInfo] = {}        # id(node) -> info
        self.by_name: dict[str, list[FuncInfo]] = {}
        self._collect_functions(tree)
        self._collect_entries(tree)
        self._collect_calls()
        self.traced = self._traced_closure()
        self.hot = self._hot_closure()
        self.loop_called = self._loop_called_closure()

    # ------------------------------------------------------------ building

    def _add(self, node, name, qual, cls, named=True):
        info = FuncInfo(node=node, name=name, qualname=qual, cls=cls)
        self.funcs[id(node)] = info
        if named:
            self.by_name.setdefault(name, []).append(info)
        return info

    def _collect_functions(self, tree):
        index = self

        class V(ast.NodeVisitor):
            def __init__(self):
                self.stack: list[str] = []
                self.cls: list[str] = []

            def visit_ClassDef(self, node):
                self.cls.append(node.name)
                self.stack.append(node.name)
                self.generic_visit(node)
                self.stack.pop()
                self.cls.pop()

            def _func(self, node, name, named=True):
                qual = ".".join(self.stack + [name])
                index._add(node, name, qual,
                           self.cls[-1] if self.cls else None, named)
                self.stack.append(name)
                self.generic_visit(node)
                self.stack.pop()

            def visit_FunctionDef(self, node):
                self._func(node, node.name)

            def visit_AsyncFunctionDef(self, node):
                self._func(node, node.name)

            def visit_Lambda(self, node):
                self._func(node, f"<lambda:{node.lineno}>")

            def visit_With(self, node):
                # a capture block is a scope of its own: nothing calls it
                if is_capture_block(node):
                    self._func(node, f"<graph:{node.lineno}>", named=False)
                else:
                    self.generic_visit(node)

            visit_AsyncWith = visit_With

        V().visit(tree)

    def _mark_entry(self, node: ast.AST, kind: str):
        """Mark a function expression (Lambda / local Name reference) as a
        traced entry, including lambdas nested inside wrapper chains like
        ``torch.compile(self._meshed(lambda ...))``."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Lambda):
                self.funcs[id(sub)].entry.add(kind)
            elif isinstance(sub, ast.Name):
                for fi in self.by_name.get(sub.id, ()):
                    fi.entry.add(kind)

    def _collect_entries(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if _is_capture_expr(dec):
                        self.funcs[id(node)].entry.add("compile")
            if is_capture_block(node):
                self.funcs[id(node)].entry.add("graph")
            if isinstance(node, ast.Call) and _is_capture_expr(node.func) \
                    and node.args:
                self._mark_entry(node.args[0], "compile")

    def _collect_calls(self):
        own = set(self.funcs)

        def harvest(info: FuncInfo):
            def walk(node, in_loop):
                for child in ast.iter_child_nodes(node):
                    if id(child) in own:
                        continue                 # nested defs: their own scope
                    child_in_loop = in_loop or isinstance(
                        child, (ast.For, ast.While, ast.AsyncFor))
                    if isinstance(child, ast.Call):
                        tail = call_tail(child)
                        if tail:
                            info.calls.add(tail)
                            if in_loop:
                                info.loop_calls.add(tail)
                    walk(child, child_in_loop)

            walk(info.node, False)

        for info in self.funcs.values():
            harvest(info)

    # ------------------------------------------------------- reachability

    def resolve(self, tail: str, from_info: Optional[FuncInfo] = None):
        """Functions a call tail may refer to (same-class first)."""
        cands = self.by_name.get(tail, [])
        if from_info is not None and from_info.cls:
            same = [c for c in cands if c.cls == from_info.cls]
            if same:
                return same
        return cands

    def _closure(self, seeds):
        seen = set(seeds)
        work = list(seeds)
        while work:
            info = work.pop()
            for tail in info.calls:
                for callee in self.resolve(tail, info):
                    if callee not in seen:
                        seen.add(callee)
                        work.append(callee)
        return seen

    def _traced_closure(self):
        return self._closure([f for f in self.funcs.values() if f.is_entry])

    def _hot_closure(self):
        """Functions that transitively call a device step."""
        hot = set()
        changed = True
        while changed:
            changed = False
            for info in self.funcs.values():
                if info in hot or info.is_entry:
                    continue
                if info.calls & DEVICE_STEPS:
                    hot.add(info)
                    changed = True
                    continue
                for tail in info.calls:
                    if any(c in hot for c in self.resolve(tail, info)):
                        hot.add(info)
                        changed = True
                        break
        return hot

    def _loop_called_closure(self):
        """Functions whose WHOLE body runs inside some hot function's loop."""
        seeds = []
        for info in self.hot:
            for tail in info.loop_calls:
                seeds.extend(self.resolve(tail, info))
        return self._closure(seeds)

    # ----------------------------------------------------------- queries

    def is_traced(self, info: FuncInfo) -> bool:
        return info.is_entry or info in self.traced
