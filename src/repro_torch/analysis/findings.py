"""Finding records, the rule catalog, and inline suppressions.  Port of
``repro.analysis.findings``.

Every rule has a stable code, a one-line summary, the repo invariant it
mechanically enforces, and a fix-it message, here in torch's terms.
``--explain CODE`` prints the full entry; findings print the short form.
The nine codes and the comment syntax are the reference's, so each
linter accepts the other's suppressions.

Suppressions are inline comments::

    toks = toks.tolist()  # accel-lint: allow[JAX01] the ONE documented sync

The reason text after the bracket is REQUIRED — a bare ``allow[CODE]``
is itself reported (LNT00).  A suppression covers its own line and, when
it is a standalone comment line, the next code line.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: {self.code} {self.message}"

    def fingerprint(self) -> str:
        """Baseline identity, keyed by line: enough for a findings
        snapshot that is expected to stay empty."""
        return f"{self.path}:{self.line}:{self.code}"


@dataclasses.dataclass(frozen=True)
class RuleDoc:
    code: str
    title: str
    invariant: str
    fixit: str


RULES: dict[str, RuleDoc] = {r.code: r for r in [
    RuleDoc(
        "JAX01", "host sync on the accelerator hot path",
        "Host-sync primitives (.item(), .tolist(), .cpu(), .numpy(), "
        ".to('cpu'), int()/float()/bool() of a tensor, np.asarray over "
        "a tensor, torch.cuda.synchronize(), Event.synchronize()) must "
        "not appear inside functions captured by torch.cuda.graph / "
        "make_graphed_callables or compiled by torch.compile (capture "
        "raises or the graph breaks) nor inside the loops of functions "
        "that drive the device steps (decode, prefill, the paged "
        "block, the train step): serving's contract is ONE host sync "
        "per decode block, and every extra blocking read serializes "
        "decode dispatch.",
        "Batch the read (sync once per block, not per step) or route a "
        "deliberate sync through repro_torch.serve.host.host_sync(x, "
        "reason=...) so the stall is audited; suppress only the "
        "documented per-block sync."),
    RuleDoc(
        "JAX02", "RNG stream shared by two consumers",
        "Every random draw takes an explicit torch.Generator, and a "
        "generator feeds exactly one consumer: a second draw, or a draw "
        "in each loop iteration, needs a fresh seed first.  A draw from "
        "the global RNG (torch.rand*/randn/randint/multinomial/normal_ "
        "without generator=, or torch.manual_seed) couples every caller "
        "of the process.  Serving seeds one generator per (request, "
        "step) so streams are batch-composition independent — a shared "
        "stream makes a request's samples depend on its neighbours.",
        "Seed a generator per consumer: torch.Generator(device)."
        "manual_seed(fold_seed(seed, i)), or gen.manual_seed(...) "
        "inside the loop before each draw; pass generator= to every "
        "draw."),
    RuleDoc(
        "JAX03", "Python branch on a tensor value in captured code",
        "Python if/while/assert on the value of a torch expression "
        "inside a function captured by torch.cuda.graph or compiled by "
        "torch.compile reads the tensor back to the host: capture "
        "raises, and compilation breaks the graph or freezes the "
        "branch taken on the first call.  Control flow on tensor "
        "values must stay on the device.",
        "Use torch.where / masked arithmetic, or hoist the decision to "
        "static config."),
    RuleDoc(
        "JAX04", "device tensor built at module import time",
        "Module-scope torch tensor factories, .cuda() or .to(device) "
        "allocate at import, before the process picks its device, "
        "rank or mesh — they initialise CUDA in every importer, pin "
        "memory for code that may never run, and couple import order "
        "to device state.  Library modules must build tensors lazily.",
        "Move the construction into the function that uses it (or a "
        "cached factory); keep module scope to Python/numpy constants."),
    RuleDoc(
        "ACC01", "trace record emitted inside a per-rank body",
        "MvmRecords are emitted LOGICALLY, exactly once, outside the "
        "per-rank body of a mesh call: the record describes the whole "
        "matmul, and energy_summary derives per-device work from its "
        "devices/partition annotations.  Emitting inside a function "
        "that runs the collectives (torch.distributed, the mesh's "
        "all_reduce/all_gather, accel.shard.sharded_program_matmul) "
        "records once per tile — double-counting energy and cycles.",
        "Emit the record before the sharded body (see "
        "accel.dispatch._record_mvm); the body must stay record-free."),
    RuleDoc(
        "ACC02", "backend/kernel called around the dispatch entry point",
        "accel.matmul is the single entry point every projection goes "
        "through: it resolves the policy spec, applies scoped overrides, "
        "validates compiled images, and records the MVM for the energy "
        "trace.  Direct calls into accel.backends or repro_torch.kernels "
        "from model/serving/tuning code bypass all four (tests and "
        "benchmarks exercise backends directly on purpose and are "
        "exempt by path).",
        "Call repro_torch.accel.matmul(x, w, spec, ...) and let dispatch "
        "route to the backend."),
    RuleDoc(
        "ACC03", "mutation of a frozen execution spec",
        "ExecSpec, Postreduce and CimaImage are value objects: specs "
        "are hashable policy keys, images are compile-time snapshots "
        "validated against the resolved spec, and epilogues are shared "
        "by every call that closed over them.  In-place mutation "
        "(attribute assignment or object.__setattr__ outside "
        "__post_init__) desynchronizes them from every cached image or "
        "captured graph built from the old value.",
        "Build a new value with dataclasses.replace(spec, ...) (or "
        "spec.with_(...)); never assign fields in place."),
    RuleDoc(
        "ACC04", "deprecated policy API",
        "set_policy()/get_policy() mutated a module-global default "
        "ShardPolicy, so a training run and a live serving engine "
        "clobbered each other's distribution mode.  The policy is a "
        "value threaded explicitly (ServeConfig.shard_policy, "
        "distributed.use_mesh(mesh, policy)); the globals are gone.",
        "Construct ShardPolicy(...) and pass it through the config "
        "path that reaches your call site."),
    RuleDoc(
        "LNT00", "malformed suppression",
        "Every accel-lint suppression must name a known rule code and "
        "carry a non-empty reason string — an unexplained allow is "
        "indistinguishable from a stale one.",
        "Write `# accel-lint: allow[CODE] why this site is exempt`."),
]}


def explain(code: str) -> str:
    doc = RULES.get(code.upper())
    if doc is None:
        known = ", ".join(sorted(RULES))
        return f"unknown rule code {code!r}; known: {known}"
    return (f"{doc.code} — {doc.title}\n\n"
            f"Invariant:\n  {doc.invariant}\n\n"
            f"Fix:\n  {doc.fixit}\n")


# ---------------------------------------------------------- suppressions

_SUPPRESS_RE = re.compile(
    r"#\s*accel-lint:\s*allow\[(?P<code>[A-Za-z0-9_,\s]*)\](?P<reason>.*)")


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int          # the line the comment sits on
    codes: tuple
    reason: str
    standalone: bool   # comment-only line: also covers the next code line

    def covers(self, code: str, line: int) -> bool:
        if code not in self.codes:
            return False
        if line == self.line:
            return True
        return self.standalone and line == self.line + 1


def scan_suppressions(source: str, path: str
                      ) -> tuple[list[Suppression], list[Finding]]:
    """All suppression comments in ``source`` plus LNT00 findings for the
    malformed ones (unknown code / missing reason)."""
    sups: list[Suppression] = []
    bad: list[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return [], []
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        i = tok.start[0]
        codes = tuple(c.strip().upper() for c in m.group("code").split(",")
                      if c.strip())
        reason = m.group("reason").strip()
        unknown = [c for c in codes if c not in RULES]
        col = tok.start[1]
        if not codes or unknown:
            bad.append(Finding("LNT00", path, i, col,
                               f"suppression names unknown rule code(s) "
                               f"{unknown or '[]'}"))
            continue
        if not reason:
            bad.append(Finding("LNT00", path, i, col,
                               f"suppression allow[{','.join(codes)}] has no "
                               f"reason string"))
            continue
        standalone = tok.line[:col].strip() == ""
        sups.append(Suppression(i, codes, reason, standalone))
    return sups, bad


def apply_suppressions(findings: list[Finding],
                       sups: list[Suppression]) -> list[Finding]:
    out = []
    for f in findings:
        if f.code == "LNT00" or not any(
                s.covers(f.code, f.line) for s in sups):
            out.append(f)
    return out
