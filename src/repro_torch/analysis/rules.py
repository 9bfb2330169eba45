"""The accel-lint rule implementations.  Port of ``repro.analysis.rules``.

Each rule encodes one repo invariant (see :data:`repro_torch.analysis.
findings.RULES` for the catalog), in torch's form.  All rules are AST
passes over one module, sharing the :class:`~repro_torch.analysis.
callgraph.ModuleIndex` for the reachability questions (traced / hot /
loop-called).

Path scoping: the hot-loop half of JAX01, JAX02, JAX04 and ACC02 apply
only under ``src/`` — benchmarks time with ``torch.cuda.synchronize``
and seed the global RNG for reproducibility on purpose, and tests pull
device values to assert on them.  Capture-breaking rules (JAX01 inside
traced functions, JAX03, ACC01, ACC03, ACC04) apply everywhere.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from .callgraph import FuncInfo, ModuleIndex, call_root, call_tail, dotted_name
from .findings import Finding

# Call roots/tails whose results live on the host: assignments from these
# do NOT taint, and a sync over them is not a device sync.
HOST_SAFE_ROOTS = {
    "np", "numpy", "math", "time", "os", "sys", "re", "json", "collections",
    "heapq", "itertools", "functools", "dataclasses", "logging", "random",
    "copy", "ast", "pathlib",
}
HOST_SAFE_TAILS = {
    "len", "range", "list", "tuple", "dict", "set", "frozenset", "sorted",
    "min", "max", "sum", "abs", "enumerate", "zip", "str", "repr", "int",
    "float", "bool", "round", "isinstance", "getattr", "hasattr", "id",
    "host_sync", "deque", "perf_counter", "append", "popleft", "pop", "get",
    "keys", "values", "items", "join", "split_lines", "format",
}
# reads of a tensor's value on the host (flagged unless the receiver is
# known to live there already); synchronize() always blocks
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_BLOCKING = {"synchronize"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While)
# generator plumbing that draws nothing; manual_seed/set_state re-seed
_GEN_DERIVERS = {"manual_seed", "set_state", "get_state", "initial_seed",
                 "clone_state", "graphsafe_get_state", "graphsafe_set_state"}
_GEN_RESEEDS = {"manual_seed", "set_state"}
# torch draws that take generator=; without it they use the global RNG
_GLOBAL_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                 "randn_like", "randint_like", "multinomial", "normal",
                 "bernoulli", "poisson"}
_INPLACE_DRAWS = {"normal_", "uniform_", "random_", "bernoulli_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}
_GLOBAL_SEEDS = {"manual_seed", "manual_seed_all", "seed"}
_FACTORIES = {"tensor", "as_tensor", "from_numpy", "zeros", "ones", "full",
              "empty", "arange", "linspace", "logspace", "eye", "rand",
              "randn", "randint", "randperm", "zeros_like", "ones_like",
              "full_like", "empty_like", "stack", "cat"}
_FROZEN_SPECS = {"ExecSpec", "Postreduce", "CimaImage", "replace"}
_RECORD_TAILS = {"MvmRecord", "trace", "_record_mvm"}
# the collectives that make a function a per-rank body: torch.distributed's
# and the port's mesh (launch/mesh.py, accel/shard.py)
_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "reduce_scatter",
                "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "sharded_program_matmul"}
_DEPRECATED = {"set_policy", "get_policy"}
_UNCAPTURED = ("torch.cuda.", "torch.backends.", "torch.distributed.",
               "torch.jit.", "torch.compiler.")


# ------------------------------------------------------------------ walking

def _walk_ctx(node: ast.AST, own: set,
              in_loop: bool = False, loops: tuple = (), branch: tuple = (),
              ) -> Iterator[tuple]:
    """Yield ``(node, in_loop, loops, branch)`` for every descendant of
    ``node`` in source order, skipping nested function/lambda scopes.

    ``loops`` is the tuple of enclosing loop-node ids; ``branch`` is a
    tuple of ``(id(if_node), arm)`` pairs so two uses can be proven to
    sit on disjoint sides of the same ``if``.
    """
    if isinstance(node, ast.If):
        yield node.test, in_loop, loops, branch
        yield from _walk_ctx(node.test, own, in_loop, loops, branch)
        for arm, stmts in ((0, node.body), (1, node.orelse)):
            b = branch + ((id(node), arm),)
            for st in stmts:
                if id(st) in own:
                    continue
                yield st, in_loop, loops, b
                yield from _walk_ctx(st, own, in_loop, loops, b)
        return
    for child in ast.iter_child_nodes(node):
        if id(child) in own:
            continue
        yield child, in_loop, loops, branch
        if isinstance(child, _LOOPS):
            yield from _walk_ctx(child, own, True, loops + (id(child),),
                                 branch)
        else:
            yield from _walk_ctx(child, own, in_loop, loops, branch)


def _branch_disjoint(b1: tuple, b2: tuple) -> bool:
    """True when the two branch paths cannot execute in the same pass
    (they sit in different arms of a common ``if``)."""
    arms1 = dict(b1)
    return any(arms1.get(if_id, arm) != arm for if_id, arm in b2)


def _first_arg(call: ast.Call) -> Optional[ast.AST]:
    return call.args[0] if call.args else None


def _base_name(node: ast.AST) -> Optional[str]:
    """The leftmost Name under a Subscript/Attribute chain."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _host_safe_call(call: ast.Call) -> bool:
    return (call_root(call) in HOST_SAFE_ROOTS
            or call_tail(call) in HOST_SAFE_TAILS)


def _host_call(call: ast.Call) -> bool:
    """A call whose result surely lives on the host: a numpy/stdlib
    root, a builtin called by its bare name, or ``host_sync`` (a tensor
    method such as ``x.sum()`` shares a tail with the builtin)."""
    if call_root(call) in HOST_SAFE_ROOTS or call_tail(call) == "host_sync":
        return True
    return isinstance(call.func, ast.Name) and call.func.id in HOST_SAFE_TAILS


def _targets(node: ast.AST) -> list[str]:
    """The plain names an assignment or loop target binds."""
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [n for e in node.elts for n in _targets(e)]
    return []


def _is_cpu_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and call_tail(node) == "device"
            and bool(node.args) and _is_cpu_literal(node.args[0]))


def _moves_to_cpu(call: ast.Call) -> bool:
    """``t.to("cpu")`` / ``t.to(device="cpu")`` / ``torch.device("cpu")``."""
    if call_tail(call) != "to" or not isinstance(call.func, ast.Attribute):
        return False
    args = list(call.args[:1]) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
    return any(_is_cpu_literal(a) for a in args)


# -------------------------------------------------------- JAX01: host syncs

def _jax01_function(index: ModuleIndex, info: FuncInfo, path: str,
                    mode: str) -> list[Finding]:
    """``mode``: 'traced' (whole body), 'hot_all' (whole body — function
    is loop-called from a hot driver), 'hot_loops' (loop bodies only)."""
    own = set(index.funcs)
    out: list[Finding] = []
    tainted: set[str] = set()     # names bound to device values
    host: set[str] = set()        # names bound to host values

    def flag(node, what):
        where = {"traced": "in captured/compiled code",
                 "hot_all": "on the hot decode path (loop-called from a "
                            "device-step driver)",
                 "hot_loops": "inside the loop of a device-step driver",
                 }[mode]
        out.append(Finding("JAX01", path, node.lineno, node.col_offset,
                           f"{what} {where}; batch the sync or route it "
                           f"through host_sync(..., reason=...)"))

    def value_tainted(v: ast.AST) -> bool:
        # The result of a host-safe top-level call (np.asarray included)
        # is a host value no matter what it synced over.
        if isinstance(v, ast.Call) and _host_safe_call(v):
            return False
        for sub in ast.walk(v):
            if isinstance(sub, ast.Call) and not _host_safe_call(sub):
                return True
            if isinstance(sub, ast.Name) and sub.id in tainted:
                return True
        return False

    def value_host(v: ast.AST) -> bool:
        if isinstance(v, ast.Call):
            return _host_call(v)
        if isinstance(v, ast.Constant):
            return True
        return _base_name(v) in host if isinstance(
            v, (ast.Name, ast.Subscript, ast.Attribute)) else False

    def check_call(node: ast.Call) -> None:
        tail, root = call_tail(node), call_root(node)
        if tail in _BLOCKING:
            flag(node, f".{tail}() host sync")
        elif tail in _SYNC_ATTRS and isinstance(node.func, ast.Attribute):
            if not value_host(node.func.value):
                flag(node, f".{tail}() host sync")
        elif _moves_to_cpu(node):
            if not value_host(node.func.value):
                flag(node, ".to('cpu') host sync")
        elif root in ("np", "numpy") and tail in ("asarray", "array"):
            arg = _first_arg(node)
            if isinstance(arg, ast.Call) and not _host_safe_call(arg):
                flag(node, f"{root}.{tail}() over a device-producing call")
            elif isinstance(arg, (ast.Name, ast.Subscript, ast.Attribute)) \
                    and _base_name(arg) in tainted:
                flag(node, f"{root}.{tail}() over a device value")
        elif tail in ("int", "float", "bool") and isinstance(node.func,
                                                             ast.Name):
            arg = _first_arg(node)
            if isinstance(arg, (ast.Name, ast.Subscript)) \
                    and _base_name(arg) in tainted:
                flag(node, f"{tail}() forcing a device value to host")
        elif tail == "host_sync":
            reason = next((kw.value for kw in node.keywords
                           if kw.arg == "reason"), None)
            ok = (isinstance(reason, ast.Constant)
                  and isinstance(reason.value, str) and reason.value.strip())
            if not ok:
                flag(node, "host_sync() without a literal reason= string")

    def bind(names, device: bool, on_host: bool):
        for name in names:
            (tainted.add if device else tainted.discard)(name)
            (host.add if on_host else host.discard)(name)

    checked: set[int] = set()
    for node, in_loop, _loops, _branch in _walk_ctx(info.node, own):
        applies = mode in ("traced", "hot_all") or in_loop
        if isinstance(node, ast.Assign):
            # check calls in the value against the PRE-assignment taint:
            # `toks = toks.tolist()` syncs the OLD (device) toks
            if applies:
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Call) and id(sub) not in checked:
                        checked.add(id(sub))
                        check_call(sub)
            names = [n for t in node.targets for n in _targets(t)]
            bind(names, value_tainted(node.value), value_host(node.value))
            continue
        if isinstance(node, (ast.For, ast.AsyncFor)):
            # a loop over a host sequence binds host values
            bind(_targets(node.target), value_tainted(node.iter),
                 value_host(node.iter))
            continue
        if isinstance(node, ast.AugAssign) and isinstance(node.target,
                                                          ast.Name):
            if value_tainted(node.value):
                tainted.add(node.target.id)
                host.discard(node.target.id)
            continue
        if not isinstance(node, ast.Call) or id(node) in checked:
            continue
        if not applies:
            continue
        check_call(node)
    return out


def rule_jax01(index: ModuleIndex, path: str, src_scope: bool
               ) -> list[Finding]:
    out = []
    for info in index.funcs.values():
        if index.is_traced(info):
            out += _jax01_function(index, info, path, "traced")
        elif src_scope and info in index.loop_called:
            out += _jax01_function(index, info, path, "hot_all")
        elif src_scope and info in index.hot:
            out += _jax01_function(index, info, path, "hot_loops")
    return out


# ----------------------------------------------- JAX02: shared RNG streams

def _global_draw(call: ast.Call) -> Optional[str]:
    """The name of a draw from (or a seeding of) the process-global RNG."""
    tail = call_tail(call)
    if any(kw.arg == "generator" for kw in call.keywords):
        return None
    root = call_root(call)
    if root == "torch" and tail in _GLOBAL_DRAWS:
        return f"torch.{tail}"
    if tail in _INPLACE_DRAWS and isinstance(call.func, ast.Attribute):
        return f".{tail}"
    if root == "torch" and tail in _GLOBAL_SEEDS:
        return dotted_name(call.func)
    return None


def _is_gen_maker(call: ast.Call) -> bool:
    """``torch.Generator(...)`` or a seeded one (``....manual_seed(s)``;
    ``torch.manual_seed`` seeds the global RNG instead)."""
    if dotted_name(call.func) in ("torch.Generator", "Generator"):
        return True
    return call_tail(call) == "manual_seed" and call_root(call) != "torch"


def rule_jax02(index: ModuleIndex, path: str, src_scope: bool
               ) -> list[Finding]:
    if not src_scope:
        return []
    out: list[Finding] = []
    for node in ast.walk(index.tree):
        if isinstance(node, ast.Call):
            what = _global_draw(node)
            if what is not None:
                out.append(Finding(
                    "JAX02", path, node.lineno, node.col_offset,
                    f"{what}() draws from the process-global RNG; pass an "
                    f"explicit generator= seeded per consumer"))
    own = set(index.funcs)
    for info in index.funcs.values():
        gen_vars: set[str] = set()
        counted: set[int] = set()   # Name-node ids already logged as a use
        ret_map: dict = {}          # node id -> enclosing Return/Raise id
        # events: (kind, name, node, loops, branch, ret) in source order
        events = []
        for node, _in_loop, loops, branch in _walk_ctx(info.node, own):
            if isinstance(node, (ast.Return, ast.Raise)):
                # two distinct return/raise statements never both execute
                ret_map.update((id(d), id(node)) for d in ast.walk(node))
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                targets = [n for t in node.targets for n in _targets(t)]
                if _is_gen_maker(node.value):
                    gen_vars.update(targets)
                for name in targets:
                    events.append(("assign", name, node, loops, branch, 0))
            elif isinstance(node, ast.Call):
                if call_tail(node) in _GEN_DERIVERS:
                    # seeding / state plumbing draws nothing; a re-seed
                    # of a named generator starts a fresh stream
                    recv = node.func.value if isinstance(
                        node.func, ast.Attribute) else None
                    if call_tail(node) in _GEN_RESEEDS and isinstance(
                            recv, ast.Name):
                        events.append(("assign", recv.id, node, loops,
                                       branch, 0))
                    counted.update(id(n) for n in ast.walk(node)
                                   if isinstance(n, ast.Name))
                    continue
                for sub in list(node.args) + [kw.value for kw in
                                              node.keywords]:
                    for leaf in ast.walk(sub):
                        if isinstance(leaf, ast.Call) and call_tail(
                                leaf) in _GEN_DERIVERS:
                            counted.update(
                                id(n) for n in ast.walk(leaf)
                                if isinstance(n, ast.Name))
                        if isinstance(leaf, ast.Subscript) and \
                                isinstance(leaf.value, ast.Name):
                            # gens[i]: indexing a list of generators picks
                            # a DISTINCT one per index — not a reuse
                            counted.add(id(leaf.value))
                        if isinstance(leaf, ast.Name) and \
                                id(leaf) not in counted:
                            events.append(("use", leaf.id, node, loops,
                                           branch,
                                           ret_map.get(id(node), 0)))
                            counted.add(id(leaf))
        for name in gen_vars:
            assign_loops: set = set()
            for kind, n, _node, loops, _b, _r in events:
                if kind == "assign" and n == name:
                    assign_loops.update(loops)
            active: list[tuple] = []
            for kind, n, node, loops, branch, ret in events:
                if n != name:
                    continue
                if kind == "assign":
                    active = []
                    continue
                if loops and not (set(loops) & assign_loops):
                    out.append(Finding(
                        "JAX02", path, node.lineno, node.col_offset,
                        f"generator '{name}' drawn from inside a loop "
                        f"without a fresh seed per iteration"))
                    active = []
                    continue
                clash = any(
                    not _branch_disjoint(b, branch)
                    and not (ret and r and r != ret)
                    for _l, b, r in active)
                if clash:
                    out.append(Finding(
                        "JAX02", path, node.lineno, node.col_offset,
                        f"generator '{name}' passed to a second consumer "
                        f"without a fresh seed"))
                active.append((loops, branch, ret))
    return out


# --------------------------------- JAX03: Python branch on a tensor value

def _tensor_value_expr(test: ast.AST) -> Optional[ast.Call]:
    for sub in ast.walk(test):
        if not isinstance(sub, ast.Call):
            continue
        d = dotted_name(sub.func) or ""
        if call_root(sub) == "torch" and not d.startswith(_UNCAPTURED) \
                and not (call_tail(sub) or "").startswith("is_"):
            return sub
        if isinstance(sub.func, ast.Attribute) and sub.func.attr in (
                "any", "all"):
            return sub
    return None


def rule_jax03(index: ModuleIndex, path: str, src_scope: bool
               ) -> list[Finding]:
    out = []
    own = set(index.funcs)
    for info in index.funcs.values():
        if not index.is_traced(info):
            continue
        for node, *_ in _walk_ctx(info.node, own):
            if isinstance(node, (ast.If, ast.While, ast.Assert)):
                bad = _tensor_value_expr(node.test)
            else:
                continue
            if bad is not None:
                kind = type(node).__name__.lower()
                out.append(Finding(
                    "JAX03", path, node.lineno, node.col_offset,
                    f"Python `{kind}` branches on a tensor value in "
                    f"captured/compiled code; use torch.where or masked "
                    f"arithmetic"))
    return out


# ----------------------------------- JAX04: import-time tensor construction

def rule_jax04(index: ModuleIndex, path: str, src_scope: bool
               ) -> list[Finding]:
    if not src_scope:
        return []
    out = []
    own = set(index.funcs)

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if id(child) in own:
                continue
            if isinstance(child, ast.Call):
                tail = call_tail(child)
                moves = isinstance(child.func, ast.Attribute) and tail in (
                    "cuda", "to")
                if moves or (call_root(child) == "torch"
                             and tail in _FACTORIES):
                    out.append(Finding(
                        "JAX04", path, child.lineno, child.col_offset,
                        "device tensor built at module import time; move "
                        "the construction inside the function that uses "
                        "it"))
            walk(child)

    walk(index.tree)
    return out


# -------------------------------- ACC01: trace record inside a rank body

def _rank_body(index: ModuleIndex, info: FuncInfo) -> bool:
    """Does this function run a collective (it is a per-rank body)?"""
    if info.calls & _COLLECTIVES:
        return True
    own = set(index.funcs)
    return any(isinstance(n, ast.Call) and (
        (dotted_name(n.func) or "").startswith("torch.distributed.")
        or call_root(n) == "dist")
        for n, *_ in _walk_ctx(info.node, own))


def rule_acc01(index: ModuleIndex, path: str, src_scope: bool
               ) -> list[Finding]:
    out = []
    own = set(index.funcs)
    for info in index.funcs.values():
        if not _rank_body(index, info):
            continue
        for node, *_ in _walk_ctx(info.node, own):
            if isinstance(node, ast.Call) and call_tail(node) in \
                    _RECORD_TAILS:
                out.append(Finding(
                    "ACC01", path, node.lineno, node.col_offset,
                    f"{call_tail(node)}() inside a per-rank body records "
                    f"once per tile; emit the MvmRecord before the "
                    f"sharded call"))
    return out


# ----------------------------------------- ACC02: bypassing accel.matmul

def _is_backend_import(node: ast.AST) -> bool:
    if isinstance(node, ast.ImportFrom):
        mod = node.module or ""
        parts = mod.split(".")
        if "kernels" in parts:
            return True
        if parts and parts[-1] == "backends" and "accel" in parts:
            return True
        if mod in ("repro_torch.accel", "accel"):
            return any(a.name == "backends" for a in node.names)
        return False
    if isinstance(node, ast.Import):
        return any("kernels" in a.name.split(".")
                   or a.name.endswith("accel.backends")
                   for a in node.names)
    return False


def rule_acc02(index: ModuleIndex, path: str, src_scope: bool
               ) -> list[Finding]:
    parts = path.replace("\\", "/").split("/")
    exempt = (not src_scope
              or any(p in ("accel", "kernels", "analysis") for p in parts))
    if exempt:
        return []
    out = []
    for node in ast.walk(index.tree):
        if _is_backend_import(node):
            out.append(Finding(
                "ACC02", path, node.lineno, node.col_offset,
                "direct backend/kernel import bypasses the accel.matmul "
                "dispatch entry point (policy, overrides, image "
                "validation, trace records); call repro_torch.accel."
                "matmul"))
    return out


# ------------------------------------------ ACC03: frozen-spec mutation

def rule_acc03(index: ModuleIndex, path: str, src_scope: bool
               ) -> list[Finding]:
    out = []
    own = set(index.funcs)
    for info in index.funcs.values():
        frozen: set[str] = set()
        for node, *_ in _walk_ctx(info.node, own):
            if isinstance(node, ast.Assign):
                v = node.value
                if isinstance(v, ast.Call) and call_tail(v) in _FROZEN_SPECS:
                    frozen.update(t.id for t in node.targets
                                  if isinstance(t, ast.Name))
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id in frozen:
                        out.append(Finding(
                            "ACC03", path, t.lineno, t.col_offset,
                            f"attribute assignment on frozen spec "
                            f"'{t.value.id}'; build a new value with "
                            f"dataclasses.replace(...)"))
            elif isinstance(node, ast.Call):
                d = dotted_name(node.func)
                if d == "object.__setattr__" and info.name != \
                        "__post_init__":
                    out.append(Finding(
                        "ACC03", path, node.lineno, node.col_offset,
                        "object.__setattr__ outside __post_init__ "
                        "defeats the frozen-spec contract; use "
                        "dataclasses.replace(...)"))
    # module level: object.__setattr__ in no function at all
    in_func = {id(n) for f in index.funcs.values()
               for n in ast.walk(f.node)}
    for node in ast.walk(index.tree):
        if isinstance(node, ast.Call) and id(node) not in in_func and \
                dotted_name(node.func) == "object.__setattr__":
            out.append(Finding(
                "ACC03", path, node.lineno, node.col_offset,
                "object.__setattr__ at module scope on a frozen "
                "spec; use dataclasses.replace(...)"))
    return out


# ------------------------------------------------ ACC04: deprecated APIs

def rule_acc04(index: ModuleIndex, path: str, src_scope: bool
               ) -> list[Finding]:
    out = []
    for node in ast.walk(index.tree):
        name = None
        if isinstance(node, ast.Name) and node.id in _DEPRECATED:
            name = node.id
        elif isinstance(node, ast.Attribute) and node.attr in _DEPRECATED:
            name = node.attr
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in _DEPRECATED:
            name = node.name
        elif isinstance(node, ast.ImportFrom):
            hits = [a.name for a in node.names if a.name in _DEPRECATED]
            name = hits[0] if hits else None
        if name is not None:
            out.append(Finding(
                "ACC04", path, node.lineno, node.col_offset,
                f"deprecated API '{name}': the global default policy is "
                f"gone; construct ShardPolicy(...) and thread it "
                f"explicitly"))
    return out


ALL_RULES = (rule_jax01, rule_jax02, rule_jax03, rule_jax04,
             rule_acc01, rule_acc02, rule_acc03, rule_acc04)


def run_rules(tree: ast.Module, path: str, *, src_scope: bool
              ) -> list[Finding]:
    index = ModuleIndex(tree, path)
    out: list[Finding] = []
    for rule in ALL_RULES:
        out.extend(rule(index, path, src_scope))
    return out
