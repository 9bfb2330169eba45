"""Tests for repro_torch.analysis: the port's accel-lint rules and its
runtime sanitizer, held to the reference's ``repro.analysis``.

The first part is ``tests/test_analysis.py`` test for test, in torch
idiom: small fixture modules go through :func:`repro_torch.analysis.
lint_source` under a synthetic ``src/`` path (the strict scope), each
rule with a positive fixture (must flag) and a negative one (must stay
clean), and the sanitizer scope on CPU tensors.  Then parity with the
reference (rule codes, suppression parsing, the hot functions of the
serving, training and tuning modules, and every ``SanitizerStats`` count
of eager ``accel.matmul`` calls on the same numpy operands, exactly),
and what only the port has: gradients bitwise with a scope open, meta
and fake tensors skipped, and the shutdown audit of a real
``PagedScheduler`` run.
"""
import ast
import dataclasses
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro.analysis import callgraph as jcallgraph
from repro.analysis import findings as jfindings
from repro.analysis.sanitize import sanitize as jsanitize
from repro.core.datapath import Postreduce as JPostreduce
from repro_torch import accel
from repro_torch.analysis import lint_paths, lint_source
from repro_torch.analysis import callgraph
from repro_torch.analysis.findings import RULES, explain, scan_suppressions
from repro_torch.analysis.sanitize import SanitizeError, active, sanitize
from repro_torch.configs import get_config
from repro_torch.core.datapath import Postreduce
from repro_torch.models import init_params
from repro_torch.serve import PagedScheduler, ServeConfig
from repro_torch.serve.host import host_sync
from repro_torch.serve.kv import BlockAllocator

ROOT = Path(__file__).resolve().parents[1]
SRC = "src/repro_torch/serve/fixture.py"   # strict scope, not ACC02-exempt
TEST = "tests/fixture.py"                   # relaxed scope


def codes(source, path=SRC):
    return [f.code for f in lint_source(textwrap.dedent(source), path)]


# ----------------------------------------------------------------- JAX01

def test_jax01_item_in_traced_function():
    assert codes("""
        import torch

        @torch.compile
        def step(x):
            return x.sum().item()
        """) == ["JAX01"]


def test_jax01_asarray_in_hot_loop():
    # `drive` is not captured, but it loop-calls a device step: the
    # per-step np.asarray over the device value serializes dispatch.
    assert codes("""
        import numpy as np

        def drive(engine, x):
            for _ in range(8):
                x = engine.decode(x)
                t = np.asarray(x)
            return x
        """) == ["JAX01"]


def test_jax01_clean_outside_hot_path():
    # identical syncs in a plain function: no device step anywhere near
    assert codes("""
        import numpy as np

        def plain(x):
            return np.asarray(x), x.item(), x.tolist()
        """) == []


def test_jax01_host_sync_requires_reason():
    assert codes("""
        import torch
        from repro_torch.serve.host import host_sync

        @torch.compile
        def step(x):
            return host_sync(x)
        """) == ["JAX01"]
    assert codes("""
        from repro_torch.serve.host import host_sync

        def drive(engine, x):
            for _ in range(8):
                x = engine.decode(x)
                t = host_sync(x, reason="documented per-block pull")
                n = t.tolist()
            return x
        """) == []


def test_jax01_relaxed_in_tests_scope():
    # benchmarks/tests sync on purpose; only capture-breaking syncs flag
    assert codes("""
        import numpy as np

        def drive(engine, x):
            for _ in range(8):
                x = engine.decode(x)
                t = np.asarray(x)
            return x
        """, path=TEST) == []


@pytest.mark.parametrize("sync", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()", "x.to('cpu')",
    "x.to(device='cpu')", "int(x)", "float(x[0])", "torch.cuda.synchronize()",
    "done.synchronize()"])
def test_jax01_torch_syncs_in_hot_loop(sync):
    assert codes(f"""
        import torch

        def drive(engine, x, done):
            for _ in range(8):
                x = engine.decode(x)
                t = {sync}
            return x
        """) == ["JAX01"]


def test_jax01_graph_capture_block():
    # the body of `with torch.cuda.graph(g):` is captured, and so is
    # every helper it reaches
    assert codes("""
        import torch

        def helper(x):
            return x.item()

        def capture(g, x):
            with torch.cuda.graph(g):
                y = helper(x)
            return y
        """) == ["JAX01"]
    assert codes("""
        import torch

        def capture(g, static, fn):
            with torch.cuda.graph(g):
                out = fn(static)
            return out.tolist()
        """) == []


# ----------------------------------------------------------------- JAX02

def test_jax02_key_reuse():
    assert codes("""
        import torch

        def sample():
            gen = torch.Generator().manual_seed(0)
            a = torch.randn(3, generator=gen)
            b = torch.rand(3, generator=gen)
            return a + b
        """) == ["JAX02"]


def test_jax02_split_is_clean():
    assert codes("""
        import torch
        from repro_torch.accel.context import fold_seed

        def sample():
            g1 = torch.Generator().manual_seed(fold_seed(0, 1))
            g2 = torch.Generator().manual_seed(fold_seed(0, 2))
            a = torch.randn(3, generator=g1)
            b = torch.rand(3, generator=g2)
            return a + b
        """) == []


def test_jax02_loop_use_without_refresh():
    assert codes("""
        import torch

        def gen_all(n):
            gen = torch.Generator().manual_seed(0)
            out = []
            for i in range(n):
                out.append(torch.randn(3, generator=gen))
            return out
        """) == ["JAX02"]


def test_jax02_fold_in_per_iteration_is_clean():
    assert codes("""
        import torch
        from repro_torch.accel.context import fold_seed

        def gen_all(n):
            gen = torch.Generator()
            out = []
            for i in range(n):
                gen.manual_seed(fold_seed(0, i))
                out.append(torch.randn(3, generator=gen))
            return out
        """) == []


def test_jax02_disjoint_branches_are_clean():
    # the two consumers sit on opposite arms: only one executes
    assert codes("""
        import torch

        def pick(flag):
            gen = torch.Generator().manual_seed(0)
            if flag:
                return torch.randn(3, generator=gen)
            else:
                return torch.rand(3, generator=gen)
        """) == []


@pytest.mark.parametrize("draw", [
    "torch.randn(3)", "torch.randint(0, 9, (3,))",
    "torch.multinomial(p, 1)", "x.normal_()", "torch.manual_seed(0)"])
def test_jax02_global_rng(draw):
    src = f"""
        import torch

        def sample(p, x):
            return {draw}
        """
    assert codes(src) == ["JAX02"]
    assert codes(src, path=TEST) == []


# ----------------------------------------------------------------- JAX03

def test_jax03_python_branch_on_traced_value():
    assert codes("""
        import torch

        @torch.compile
        def f(x):
            if torch.any(x > 0):
                return x
            return -x
        """) == ["JAX03"]


def test_jax03_clean_when_not_traced():
    assert codes("""
        import torch

        def f(x):
            if torch.any(x > 0):
                return x
            return -x
        """) == []
    # static queries are not tensor values
    assert codes("""
        import torch

        @torch.compile
        def f(x):
            if torch.is_grad_enabled() and x.is_cuda:
                return x
            return -x
        """) == []


# ----------------------------------------------------------------- JAX04

def test_jax04_import_time_array():
    assert codes("""
        import torch

        SCALE = torch.ones(3)
        """) == ["JAX04"]
    assert codes("""
        import numpy as np

        TABLE = np.ones(3).cuda()
        """) == ["JAX04"]


def test_jax04_lazy_construction_is_clean():
    assert codes("""
        import torch

        DEVICE = torch.device("cuda")

        def scale():
            return torch.ones(3, device=DEVICE)
        """) == []
    # tests may build tensors at module scope (they own the process)
    assert codes("""
        import torch

        SCALE = torch.ones(3)
        """, path=TEST) == []


# ----------------------------------------------------------------- ACC01

def test_acc01_trace_record_inside_shard_map():
    # a function that runs a collective is a per-rank body
    assert codes("""
        import torch.distributed as dist
        from repro_torch.accel.context import trace

        def body(x):
            trace(x)
            dist.all_reduce(x)
            return x
        """) == ["ACC01"]
    assert codes("""
        from repro_torch.accel.context import _record_mvm

        def tile(mesh, x):
            _record_mvm(x)
            return mesh.all_gather(x, "model", 1)
        """) == ["ACC01"]


def test_acc01_record_outside_shard_map_is_clean():
    assert codes("""
        import torch.distributed as dist
        from repro_torch.accel.context import trace

        def launch(x):
            trace(x)
            return body(x)

        def body(x):
            dist.all_reduce(x)
            return x
        """) == []


# ----------------------------------------------------------------- ACC02

def test_acc02_backend_import_outside_accel():
    assert codes("""
        from repro_torch.accel import backends
        """) == ["ACC02"]
    assert codes("""
        from repro_torch.kernels import cima_mvm
        """) == ["ACC02"]


def test_acc02_exempt_paths():
    src = "from repro_torch.accel import backends\n"
    assert [f.code for f in lint_source(src, TEST)] == []
    assert [f.code for f in
            lint_source(src, "src/repro_torch/accel/fixture.py")] == []


# ----------------------------------------------------------------- ACC03

def test_acc03_frozen_spec_mutation():
    assert codes("""
        from repro_torch.accel import ExecSpec

        def widen(spec):
            spec = ExecSpec(backend="bpbs", ba=2, bx=2)
            spec.ba = 4
            return spec
        """) == ["ACC03"]


def test_acc03_setattr_outside_post_init():
    assert codes("""
        def widen(spec):
            object.__setattr__(spec, "ba", 4)
            return spec
        """) == ["ACC03"]


def test_acc03_replace_and_post_init_are_clean():
    assert codes("""
        import dataclasses
        from repro_torch.accel import ExecSpec

        def widen(spec):
            spec = ExecSpec(backend="bpbs", ba=2, bx=2)
            return dataclasses.replace(spec, ba=4)

        class Spec:
            def __post_init__(self):
                object.__setattr__(self, "ba", 4)
        """) == []


# ----------------------------------------------------------------- ACC04

def test_acc04_deprecated_policy_api():
    assert codes("""
        from repro_torch.distributed.sharding import set_policy
        """) == ["ACC04"]
    assert codes("""
        def f(sharding):
            return sharding.get_policy()
        """) == ["ACC04"]


def test_acc04_threaded_policy_is_clean():
    assert codes("""
        from repro_torch.distributed.sharding import ShardPolicy

        def f(mesh, policy):
            return ShardPolicy(mode=policy)
        """) == []


# ----------------------------------------------------------- suppressions

def test_suppression_inline_with_reason():
    assert codes("""
        import torch

        @torch.compile
        def step(x):
            return x.sum().item()  # accel-lint: allow[JAX01] fixture
        """) == []


def test_suppression_standalone_covers_next_line():
    assert codes("""
        import torch

        @torch.compile
        def step(x):
            # accel-lint: allow[JAX01] fixture: documented sync
            return x.sum().item()
        """) == []


def test_suppression_standalone_covers_only_next_line():
    assert codes("""
        import torch

        @torch.compile
        def step(x):
            # accel-lint: allow[JAX01] fixture: too far away
            y = x + 1
            return y.sum().item()
        """) == ["JAX01"]


def test_suppression_without_reason_is_lnt00():
    out = codes("""
        import torch

        @torch.compile
        def step(x):
            return x.sum().item()  # accel-lint: allow[JAX01]
        """)
    # the bare allow is itself a finding AND does not suppress
    assert sorted(out) == ["JAX01", "LNT00"]


def test_suppression_unknown_code_is_lnt00():
    assert codes("""
        x = 1  # accel-lint: allow[BOGUS99] not a rule
        """) == ["LNT00"]


def test_suppression_inside_string_literal_is_ignored():
    # only real COMMENT tokens count; doc text mentioning the syntax
    # neither suppresses nor trips LNT00
    assert codes('''
        HELP = "write # accel-lint: allow[NOPE] to suppress"
        ''') == []


# ------------------------------------------------------------- call graph

def test_callgraph_traced_reaches_helpers():
    # the sync lives in a plain helper; it flags because the helper is
    # reachable from a compiled entry
    assert codes("""
        import torch

        def helper(x):
            return x.item()

        def entry(x):
            return helper(x)

        fast = torch.compile(entry)
        """) == ["JAX01"]


def test_callgraph_unreached_helper_is_clean():
    assert codes("""
        def helper(x):
            return x.item()

        def plain(x):
            return helper(x)
        """) == []


# -------------------------------------------------------------- rule docs

def test_every_rule_has_doc_and_explain():
    for code in ("JAX01", "JAX02", "JAX03", "JAX04",
                 "ACC01", "ACC02", "ACC03", "ACC04", "LNT00"):
        assert code in RULES
        text = explain(code)
        assert RULES[code].title in text and "Fix:" in text
    assert "unknown rule code" in explain("NOPE")


def test_syntax_error_is_lnt00():
    assert codes("def broken(:\n") == ["LNT00"]


# ---------------------------------------------------------- self-run gate

def test_self_run_is_clean():
    """The port's linter passes over the port: the rules ARE the
    contract, so src/repro_torch carries zero unsuppressed findings."""
    findings = lint_paths([str(ROOT / "src" / "repro_torch")])
    assert findings == [], "\n".join(f.render() for f in findings)


# --------------------------------------------------------------- sanitizer

_SPEC = accel.ExecSpec(backend="bpbs", ba=2, bx=2)


def _ones(shape, value):
    return torch.full(shape, value, dtype=torch.float32)


def test_sanitize_scope_activation():
    outer = active()
    with sanitize() as san:
        assert active() is san
        assert san is not outer
    assert active() is outer


def test_sanitize_nan_input_trips():
    x = _ones((4, 8), 1.0)
    x[0, 0] = float("nan")
    w = _ones((8, 16), 0.1)
    with pytest.raises(SanitizeError, match="non-finite"):
        with sanitize():
            accel.matmul(x, w, _SPEC)


def test_sanitize_host_sync_guard():
    bad = torch.tensor([1.0, float("inf")])
    with pytest.raises(SanitizeError, match="host_sync"):
        with sanitize():
            host_sync(bad, reason="fixture")
    # outside every scope host_sync is a plain pull
    out = host_sync(bad, reason="fixture")
    assert np.isinf(out[1])


def test_sanitize_clean_dispatch_counts():
    x, w = _ones((4, 8), 0.25), _ones((8, 16), 0.1)
    with sanitize() as san:
        accel.matmul(x, w, _SPEC)
    assert san.stats.dispatches == 1
    assert san.stats.finite_checks == 3     # input, weight, output
    assert san.stats.adc_conversions > 0


def test_sanitize_saturation_counter_and_limit():
    # large inputs on a 1-b spec pin the charge-share range to the top
    # code: the counter sees it, and an opted-in limit fails the scope
    x, w = _ones((4, 8), 3.0), _ones((8, 16), 1.0)
    spec = accel.ExecSpec(backend="bpbs", ba=1, bx=1)
    with sanitize() as san:
        accel.matmul(x, w, spec)
    assert san.stats.adc_saturated > 0
    with pytest.raises(SanitizeError, match="saturation rate"):
        with sanitize(adc_saturation_limit=0.01):
            accel.matmul(x, w, spec)


def test_sanitize_allocator_leak_audit():
    alloc = BlockAllocator(num_blocks=8)
    held = alloc.alloc(3)
    with pytest.raises(SanitizeError, match="leaked 3 block"):
        with sanitize() as san:
            san.audit_allocator(alloc, "fixture shutdown")
    alloc.free(held)
    with sanitize() as san:
        san.audit_allocator(alloc, "fixture shutdown")
    assert san.stats.allocator_audits == 1   # fresh stats per scope


def test_sanitize_vdd_corner():
    with pytest.raises(SanitizeError, match="not a modeled supply corner"):
        with sanitize(vdd=0.7):
            pass
    x, w = _ones((4, 8), 0.25), _ones((8, 16), 0.1)
    with sanitize(vdd=0.85) as san:
        accel.matmul(x, w, _SPEC)        # sigma 0.0 < the 0.85V corner
    assert san.stats.corner_mismatches == 1


def test_sanitize_require_noise_key():
    noisy = accel.ExecSpec(backend="bpbs", ba=2, bx=2, adc_sigma_lsb=0.3)
    x, w = _ones((4, 8), 0.25), _ones((8, 16), 0.1)
    with pytest.raises(SanitizeError, match="no noise key"):
        with sanitize(require_noise_key=True):
            accel.matmul(x, w, noisy)
    with sanitize(require_noise_key=True):
        with accel.adc_noise(0):
            accel.matmul(x, w, noisy)


def test_sanitize_survives_jit():
    # torch.compile traces with fake tensors: the checks must neither
    # read them nor raise, while the dispatch still counts (on the card,
    # tests/test_torch_cuda.py captures a CUDA graph inside a scope)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        x, w = torch.empty(4, 8), torch.empty(8, 16)
    with sanitize() as san, mode:
        y = accel.matmul(x, w, accel.ExecSpec(backend="digital"))
    assert y.shape == (4, 16)
    assert san.stats.dispatches == 1
    assert san.stats.finite_checks == 0


# ------------------------------------------------ parity with the reference

def test_rule_codes_equal_the_reference():
    assert list(RULES) == list(jfindings.RULES)


SUPPRESSION_SOURCES = [
    "x = 1  # accel-lint: allow[JAX01] the one sync\n",
    "# accel-lint: allow[JAX02, ACC01] two codes, standalone\nx = 1\n",
    "x = 1  # accel-lint: allow[jax03] lower case\n",
    "x = 1  # accel-lint: allow[JAX01]\n",
    "x = 1  # accel-lint: allow[BOGUS99] not a rule\n",
    "x = 1  # accel-lint: allow[] empty\n",
    "x = 1  #accel-lint:allow[LNT00]   tight spacing  \n",
    'S = "# accel-lint: allow[NOPE] in a string"\n',
    "def f(:\n    pass  # accel-lint: allow[JAX01] unparsable\n",
]


@pytest.mark.parametrize("source", SUPPRESSION_SOURCES)
def test_scan_suppressions_matches_the_reference(source):
    sups, bad = scan_suppressions(source, "f.py")
    jsups, jbad = jfindings.scan_suppressions(source, "f.py")
    assert [dataclasses.astuple(s) for s in sups] == \
        [dataclasses.astuple(s) for s in jsups]
    assert [(f.code, f.line, f.col) for f in bad] == \
        [(f.code, f.line, f.col) for f in jbad]


# reference jit attribute -> the port's device step, per module, and the
# reference's hot function -> the port's (identical names unless listed)
HOT_MODULES = {
    "serve/engine.py": {"_decode": "decode", "_prefill": "prefill",
                        "_prefill_padded": "prefill_single",
                        "_splice": "splice_slot"},
    "serve/scheduler.py": {"_block": "_run_block",
                           "_resume": "prefill_resume",
                           "_splice": "splice_request"},
    "train/trainer.py": {"step_fn": "step_fn"},
    "tune/tuner.py": {},
}
HOT_RENAMED: dict = {}


def _index(index_mod, pkg, rel):
    path = ROOT / "src" / pkg / rel
    return index_mod.ModuleIndex(ast.parse(path.read_text()), str(path))


@pytest.mark.parametrize("rel", sorted(HOT_MODULES))
def test_hot_set_covers_the_reference(rel):
    ref = _index(jcallgraph, "repro", rel)
    port = _index(callgraph, "repro_torch", rel)
    steps = HOT_MODULES[rel]
    assert set(steps) == ref.jit_attrs
    assert set(steps.values()) <= callgraph.DEVICE_STEPS
    want = {HOT_RENAMED.get(f.qualname, f.qualname) for f in ref.hot}
    assert want <= {f.qualname for f in port.hot}


def _stat_fields(stats):
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(stats)}


STATS_CASES = [
    # (ba, bx, operands, vdd, Postreduce scale with saturate=True)
    (1, 1, "normal", None, None), (2, 2, "normal", None, None),
    (4, 4, "normal", None, None), (8, 8, "normal", None, None),
    (1, 1, "saturating", None, None),    # test_sanitize_saturation_...
    (2, 2, "normal", 0.85, None), (2, 2, "normal", None, 1e5),
]


@pytest.mark.parametrize("case", STATS_CASES, ids=str)
def test_sanitizer_stats_equal_the_reference(case):
    ba, bx, operands, vdd, sat = case
    kw = dict(backend="bpbs", ba=ba, bx=bx)
    if operands == "saturating":
        x, w = np.full((4, 8), 3.0, np.float32), np.ones((8, 16), np.float32)
    else:
        r = np.random.default_rng(ba)
        x = r.standard_normal((4, 32)).astype(np.float32)
        w = (r.standard_normal((32, 16)) * 0.2).astype(np.float32)
        kw["bank_n"] = 16                     # two banks
    jpost = post = None
    if sat is not None:
        jpost = JPostreduce(scale=jnp.float32(sat), saturate=True)
        post = Postreduce(scale=torch.tensor(sat), saturate=True)
    with jsanitize(vdd=vdd) as jsan:
        jaccel.matmul(jnp.asarray(x), jnp.asarray(w),
                      jaccel.ExecSpec(**kw), post=jpost)
    with sanitize(vdd=vdd) as san:
        accel.matmul(torch.from_numpy(x), torch.from_numpy(w),
                     accel.ExecSpec(**kw), post=post)
    assert _stat_fields(san.stats) == _stat_fields(jsan.stats)
    assert san.stats.dispatches == 1 and san.stats.adc_conversions > 0
    assert (san.stats.by_overflowed > 0) == (sat is not None)
    assert (san.stats.corner_mismatches == 1) == (vdd is not None)
    if operands == "saturating":
        assert san.stats.adc_saturated > 0


# ------------------------------------------------------------- port only

def test_sanitize_keeps_gradients_bitwise():
    r = np.random.default_rng(3)
    x0 = torch.from_numpy(r.standard_normal((5, 32)).astype(np.float32))
    w0 = torch.from_numpy(r.standard_normal((32, 12)).astype(np.float32))
    post = Postreduce(scale=torch.full((12,), 0.5, requires_grad=True),
                      act="relu")
    spec = accel.ExecSpec(backend="bpbs", ba=2, bx=2, bank_n=16)

    def grads():
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        post.scale.grad = None
        y = accel.matmul(x, w, spec, post=post)
        (y * torch.arange(12.0)).sum().backward()
        return y.detach(), x.grad, w.grad, post.scale.grad

    plain = grads()
    with sanitize() as san:
        checked = grads()
    assert san.stats.dispatches == 1 and san.stats.finite_checks == 3
    for a, b in zip(plain, checked):
        assert torch.equal(a, b)


def test_sanitize_skips_meta_tensors():
    x, w = torch.empty(4, 8, device="meta"), torch.empty(8, 16, device="meta")
    with sanitize() as san:
        y = accel.matmul(x, w, accel.ExecSpec(backend="digital"))
        san.check_finite(torch.empty(3, device="meta"), "fixture")
    assert y.is_meta and y.shape == (4, 16)
    assert san.stats.dispatches == 1 and san.stats.finite_checks == 0
    with sanitize() as san:      # int8 planes are not checked either
        san.check_finite(torch.zeros(3, dtype=torch.int8), "fixture")
    assert san.stats.finite_checks == 0


def _paged(held: int):
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), n_layers=2)
    params = init_params(cfg, 0, device="cpu")
    sched = PagedScheduler(params, cfg, ServeConfig(
        max_seq=32, max_new_tokens=4, kv_block_size=8, decode_block=2),
        n_slots=2, device="cpu")
    rng = np.random.default_rng(0)
    for n in (5, 9, 3):
        sched.submit(rng.integers(1, cfg.vocab, (n,)).astype(np.int32))
    kept = sched.alloc.alloc(held)           # a block nobody frees
    return sched, kept


def test_paged_shutdown_audit():
    sched, _ = _paged(held=0)
    with sanitize() as san:
        out = sched.run()
    assert len(out) == 3 and san.stats.allocator_audits == 1
    assert san.stats.dispatches > 0
    sched, kept = _paged(held=1)
    with pytest.raises(SanitizeError, match="leaked 1 block"):
        with sanitize():
            sched.run()
    assert len(kept) == 1
