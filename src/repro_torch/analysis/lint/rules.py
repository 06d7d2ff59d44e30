"""swanlint Layer 1 for the port — stdlib-``ast`` rules over the port's
standing constraints (port of ``repro/analysis/lint/rules.py``).

Each rule has a stable ID so findings can be suppressed inline::

    # swanlint: disable=SWAN102 -- host fetch point, tokens must cross here

A suppression REQUIRES justification text after the rule list (``--``,
``:`` or parentheses); a bare ``disable=`` is itself a finding (SWAN100).
A suppression on its own comment line covers the next statement.

Rules
-----
SWAN101  The port's import floor: an import of ``jax``/``jaxlib``, of the
         reference package ``repro`` or of its ``benchmarks`` anywhere in
         the port (``src/repro_torch/``, ``chip_smoke.py``,
         ``examples/torch_*.py``) — the static twin of the subprocess
         guard in ``tests/test_torch_serve.py``.
SWAN102  Host sync on the serve hot path: ``.item()``, ``.tolist()``,
         ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()`` and an
         event's or stream's ``.synchronize()``, always; and
         ``float()/int()/bool()/np.asarray()`` applied to a value tainted
         by a dispatch result (the engine's ``_decode_call``,
         ``_chunk_call``, ``_prefill_call``, ``_insert_call`` and
         ``GraphSet.run``), in any function of ``runtime/`` reachable from
         an engine's ``step()``/``run()`` or the lockstep session's
         ``generate()``.  The designed fetch points (``_resolve_tokens``,
         ``_lane_tokens``, ``_sample``) are allowlisted — tokens are
         SUPPOSED to cross there.
SWAN103  Shape bucketing: non-power-of-two literal dims in
         ``torch``/``np`` ``zeros/ones/full/empty`` and in
         ``expand``/``broadcast_to`` inside dispatch functions under
         ``runtime/`` / ``models/`` — each such literal mints a graph
         bucket of its own.
SWAN104  Spec completeness (cross-module): every serve-state leaf key
         that the cache and state initialisers build (``packed_side`` and
         the ``init_*cache(s)``/``init_*state``/``init_*pool`` functions
         of ``SPEC_STATE_MODULES``) must be listed in
         ``repro_torch/sharding/serve_specs.py``'s ``KNOWN_LEAF_NAMES``,
         read statically — the static twin of
         ``serve_specs.unspecced_serve_leaves``.
SWAN105  Observability: module-level metric containers (dicts named
         ``*_metrics``/``*_counters``/…) outside ``repro_torch/obs`` —
         counters and gauges go through the ``MetricsRegistry``.

Everything here is pure ``ast`` + ``re``: no torch import.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "SWAN100": "malformed swanlint suppression (unknown rule id or "
               "missing justification)",
    "SWAN101": "jax, jaxlib, repro or benchmarks imported by the port",
    "SWAN102": "host sync on the serve hot path",
    "SWAN103": "non-power-of-two literal shape in a dispatch function",
    "SWAN104": "serve-state leaf without a sharding-spec rule",
    "SWAN105": "ad-hoc metrics container outside MetricsRegistry",
}
# top-level modules the port must never import
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "repro", "benchmarks")

# the engine's dispatch callables (the reference's jitted executables)
DISPATCH_FNS = ("_decode_call", "_chunk_call", "_prefill_call",
                "_insert_call")
# the roots of the per-step serve loops
HOT_ROOTS = ("step", "run", "generate")
# known host fetch points: the functions whose JOB is to move sampled
# tokens/logits across the device boundary
HOST_FETCH_ALLOWLIST = ("_resolve_tokens", "_lane_tokens", "_sample")

# sync primitives flagged unconditionally on the hot path
_SYNC_ATTRS = ("item", "tolist", "cpu", "numpy", "synchronize")
# conversions flagged only when applied to a dispatch-tainted value
_CONV_NAMES = ("float", "int", "bool")
_CONV_DOTTED = ("np.asarray", "np.array", "numpy.asarray", "numpy.array",
                "np.ascontiguousarray", "numpy.ascontiguousarray")

# constructors whose literal dims SWAN103 inspects
_CTOR_TAILS = ("zeros", "ones", "full", "empty")
_EXPAND_TAILS = ("expand", "broadcast_to")
_DISPATCH_FN_RE = re.compile(
    r"decode|prefill|chunk|dispatch|serve|insert|step")

# modules whose state initialisers build the serve engine's state trees
# (SWAN104's scope; the encoder-decoder's state is the lockstep session's
# only, as in the reference)
SPEC_STATE_MODULES = (
    "core/hybrid_cache.py", "core/paged_cache.py", "models/attention.py",
    "models/mamba.py", "models/rwkv.py", "models/rwkv_model.py",
    "models/transformer.py", "models/jamba.py",
)
_STATE_INIT_RE = re.compile(r"^(packed_side|init_\w*(cache|caches|state|pool))$")
# tensor constructors whose dict keys SWAN104 reads as leaves (a leading
# underscore names a module's own wrapper, e.g. hybrid_cache._zeros)
_ARRAY_CTOR_TAILS = ("zeros", "ones", "full", "empty", "zeros_like",
                     "empty_like", "full_like", "stack", "cat", "tensor",
                     "as_tensor", "arange")

_METRIC_NAME_RE = re.compile(r"(metric|counter|gauge|histogram)s?(_|$)",
                             re.IGNORECASE)


@dataclass
class Finding:
    rule: str
    path: str            # repo-relative path
    line: int
    col: int
    message: str
    snippet: str = ""
    suppressed: bool = False
    justification: str = ""

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used for baseline diffs: a finding
        moves with its source line, not with unrelated edits above it."""
        return f"{self.rule}|{self.path}|{' '.join(self.snippet.split())}"

    def to_json(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet, "suppressed": self.suppressed,
                "justification": self.justification,
                "fingerprint": self.fingerprint}


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*swanlint:\s*disable=([A-Z0-9, ]+?)(?:\s*(?:--|:|\())(.*)$")
_SUPPRESS_BARE_RE = re.compile(r"#\s*swanlint:\s*disable=?(.*)$")


def _parse_suppressions(lines: Sequence[str], path: str
                        ) -> Tuple[List[Tuple[int, Set[str], str]],
                                   List[Finding]]:
    """-> ([(line, rule ids, justification)], malformed findings)."""
    out: List[Tuple[int, Set[str], str]] = []
    bad: List[Finding] = []
    for i, raw in enumerate(lines, 1):
        if "swanlint" not in raw:
            continue
        m = _SUPPRESS_RE.search(raw)
        if not m:
            if _SUPPRESS_BARE_RE.search(raw):
                bad.append(Finding(
                    "SWAN100", path, i, 0,
                    "suppression needs 'disable=RULE -- justification'",
                    snippet=raw.strip()))
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        just = m.group(2).strip().rstrip(")").strip()
        unknown = rules - set(RULES)
        if unknown:
            bad.append(Finding(
                "SWAN100", path, i, 0,
                f"unknown rule id(s) in suppression: {sorted(unknown)}",
                snippet=raw.strip()))
            rules -= unknown
        if not just:
            bad.append(Finding(
                "SWAN100", path, i, 0,
                "suppression without justification text "
                "(say WHY the finding is safe)", snippet=raw.strip()))
            continue                       # unjustified => does not suppress
        if rules:
            out.append((i, rules, just))
    return out, bad


def _is_comment_line(line: str) -> bool:
    s = line.strip()
    return not s or s.startswith("#")


def suppression_map(text: str, tree: Optional[ast.Module], path: str
                    ) -> Tuple[Dict[int, Tuple[Set[str], str]],
                               List[Finding]]:
    """Resolve suppression comments to the line ranges they cover: an
    inline comment covers its own (possibly multi-line) statement, a
    standalone comment (or block of comment lines) the next statement,
    with statement extents from the AST."""
    lines = text.splitlines()
    entries, bad = _parse_suppressions(lines, path)
    spans: List[Tuple[int, int]] = []
    if tree is not None:
        for node in ast.walk(tree):
            if isinstance(node, ast.stmt) and hasattr(node, "end_lineno"):
                spans.append((node.lineno, node.end_lineno or node.lineno))
    out: Dict[int, Tuple[Set[str], str]] = {}

    def cover(ln: int, rules: Set[str], just: str) -> None:
        old = out.get(ln)
        out[ln] = ((old[0] | rules, old[1] or just) if old
                   else (rules, just))

    for lineno, rules, just in entries:
        target = lineno
        if lineno - 1 < len(lines) and _is_comment_line(lines[lineno - 1]):
            target = lineno + 1
            while target <= len(lines) \
                    and _is_comment_line(lines[target - 1]):
                target += 1
        hits = [(l0, l1) for l0, l1 in spans if l0 <= target <= l1]
        if hits:
            l0, l1 = max(hits, key=lambda s: s[0])
            for ln in range(l0, l1 + 1):
                cover(ln, rules, just)
        else:
            cover(target, rules, just)
        cover(lineno, rules, just)
    return out, bad


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _names_in(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            d = _dotted(n)
            if d is not None and d.startswith("self."):
                out.add(d)
    return out


def _snippet(lines: Sequence[str], lineno: int) -> str:
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


def _norm(rel: str) -> str:
    return rel.replace("\\", "/")


# ---------------------------------------------------------------------------
# SWAN101 — the port's import floor
# ---------------------------------------------------------------------------

def _forbidden(module: str) -> Optional[str]:
    top = module.split(".", 1)[0]
    return top if top in FORBIDDEN_IMPORTS else None


def _rule_imports(tree: ast.AST, rel: str, lines) -> List[Finding]:
    out: List[Finding] = []

    def hit(node, module):
        out.append(Finding(
            "SWAN101", rel, node.lineno, node.col_offset,
            f"import of {module!r}: the port imports neither jax nor the "
            "reference package (keep a copy in repro_torch instead)",
            snippet=_snippet(lines, node.lineno)))

    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                hit(node, node.module)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if _forbidden(alias.name):
                    hit(node, alias.name)
    return out


# ---------------------------------------------------------------------------
# SWAN102 — host sync on the serve hot path
# ---------------------------------------------------------------------------

@dataclass
class _FnInfo:
    node: ast.AST                       # FunctionDef | AsyncFunctionDef
    qual: str                           # "Class.method" or "function"
    name: str
    cls: Optional[str]
    calls: Set[str] = field(default_factory=set)        # bare callee names
    tainted_params: Set[str] = field(default_factory=set)


def _function_index(tree: ast.Module) -> List[_FnInfo]:
    fns: List[_FnInfo] = []

    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{cls}.{child.name}" if cls else child.name
                fns.append(_FnInfo(child, qual, child.name, cls))
                visit(child, cls)

    visit(tree, None)
    return fns


def _call_name(call: ast.Call) -> Optional[str]:
    """Bare callee name: ``self.f(...)`` / ``f(...)`` -> 'f'."""
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id in ("self", "cls"):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_dispatch(call: ast.Call) -> bool:
    """A call to one of the engine's dispatch callables or to a graph
    set's ``run`` (``self._graphs.run(...)``)."""
    if _call_name(call) in DISPATCH_FNS:
        return True
    d = _dotted(call.func) or ""
    return d.endswith("_graphs.run") or d.endswith("GraphSet.run")


def _rule_host_sync(tree: ast.Module, rel: str, lines) -> List[Finding]:
    rel_n = _norm(rel)
    if "/runtime/" not in rel_n and not rel_n.startswith("runtime/"):
        return []
    if not any(isinstance(n, ast.Call) and _is_dispatch(n)
               for n in ast.walk(tree)):
        return []
    fns = _function_index(tree)
    by_name: Dict[str, _FnInfo] = {}
    for f in fns:
        by_name.setdefault(f.name, f)
    for f in fns:
        for n in ast.walk(f.node):
            if isinstance(n, ast.Call):
                cn = _call_name(n)
                if cn:
                    f.calls.add(cn)

    # hot set: BFS over bare-name calls from the loop roots
    roots = [f.name for f in fns if f.name in HOT_ROOTS]
    hot: Set[str] = set()
    frontier = list(roots)
    while frontier:
        name = frontier.pop()
        if name in hot or name not in by_name:
            continue
        hot.add(name)
        frontier.extend(by_name[name].calls)

    # functions that RETURN a dispatch result (transitively) taint callers
    returns_tainted: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for f in fns:
            if f.name in returns_tainted:
                continue
            for n in ast.walk(f.node):
                if isinstance(n, ast.Return) and n.value is not None and any(
                        isinstance(c, ast.Call) and (
                            _is_dispatch(c)
                            or _call_name(c) in returns_tainted)
                        for c in ast.walk(n.value)):
                    returns_tainted.add(f.name)
                    changed = True
                    break

    tainted_attrs: Set[str] = set()      # "self.x" assigned from dispatch

    def analyze(f: _FnInfo, emit: bool) -> List[Finding]:
        """One pass over ``f``: track tainted locals, optionally emit
        findings, and record tainted args at call sites."""
        tainted: Set[str] = set(f.tainted_params)
        out: List[Finding] = []

        def is_tainted(expr: ast.AST) -> bool:
            for n in ast.walk(expr):
                if isinstance(n, ast.Call) and (
                        _is_dispatch(n) or _call_name(n) in returns_tainted):
                    return True
            names = _names_in(expr)
            return bool(names & tainted or names & tainted_attrs)

        for node in ast.walk(f.node):
            if isinstance(node, ast.Assign) and is_tainted(node.value):
                for tgt in node.targets:
                    for t in (tgt.elts if isinstance(tgt, ast.Tuple)
                              else [tgt]):
                        if isinstance(t, ast.Name):
                            tainted.add(t.id)
                        elif isinstance(t, ast.Attribute):
                            d = _dotted(t)
                            if d:
                                tainted_attrs.add(d)
            if not isinstance(node, ast.Call):
                continue
            cn = _call_name(node)
            if cn in by_name:
                callee = by_name[cn]
                pnames = [a.arg for a in callee.node.args.args
                          if a.arg not in ("self", "cls")]
                for i, arg in enumerate(node.args):
                    if i < len(pnames) and is_tainted(arg):
                        callee.tainted_params.add(pnames[i])
            if not emit:
                continue
            d = _dotted(node.func)
            viol: Optional[str] = None
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_ATTRS:
                viol = (f"{d}() forces a host sync" if d and d.startswith(
                    "torch.") else f".{node.func.attr}() forces a host sync")
            elif ((d in _CONV_DOTTED
                   or (isinstance(node.func, ast.Name)
                       and node.func.id in _CONV_NAMES))
                  and node.args and is_tainted(node.args[0])):
                label = d or node.func.id  # type: ignore[union-attr]
                viol = (f"{label}() on a dispatch result blocks on device "
                        "compute")
            if viol is not None:
                out.append(Finding(
                    "SWAN102", rel, node.lineno, node.col_offset,
                    f"{viol} inside {f.qual}, which is reachable from the "
                    "per-step serve loop — keep the hot path async "
                    "(allowlisted fetch points: "
                    f"{', '.join(HOST_FETCH_ALLOWLIST)})",
                    snippet=_snippet(lines, node.lineno)))
        return out

    hot_fns = [f for f in fns if f.name in hot]
    # two silent passes to reach a taint fixpoint across call sites, then
    # one emitting pass
    for _ in range(2):
        for f in hot_fns:
            analyze(f, emit=False)
    out: List[Finding] = []
    for f in hot_fns:
        if f.name in HOST_FETCH_ALLOWLIST:
            continue
        out.extend(analyze(f, emit=True))
    return out


# ---------------------------------------------------------------------------
# SWAN103 — shape bucketing
# ---------------------------------------------------------------------------

def _shape_dims(node: ast.Call, d: str, tail: str) -> List[ast.AST]:
    """The literal-dim candidates of a constructor or expand call."""
    args = node.args
    if not args:
        return []
    if tail == "broadcast_to":
        # torch.broadcast_to(x, shape) / np.broadcast_to(x, shape) vs the
        # method x.broadcast_to(shape)
        module_fn = d.split(".", 1)[0] in ("torch", "np", "numpy")
        shape = args[1] if module_fn and len(args) > 1 else args[0]
        args = [shape]
    elif tail == "full" or isinstance(args[0], (ast.Tuple, ast.List)):
        args = [args[0]]
    dims: List[ast.AST] = []
    for a in args:
        dims += a.elts if isinstance(a, (ast.Tuple, ast.List)) else [a]
    return dims


def _rule_bucketing(tree: ast.Module, rel: str, lines) -> List[Finding]:
    rel_n = _norm(rel)
    if not any(seg in rel_n for seg in ("/runtime/", "/models/")) \
            and not rel_n.startswith(("runtime/", "models/")):
        return []
    out: List[Finding] = []
    for f in _function_index(tree):
        if not _DISPATCH_FN_RE.search(f.name):
            continue
        for node in ast.walk(f.node):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or ""
            tail = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else "")
            is_ctor = (tail in _CTOR_TAILS
                       and d.split(".", 1)[0] in ("torch", "np", "numpy"))
            if not (is_ctor or tail in _EXPAND_TAILS):
                continue
            for dim in _shape_dims(node, d, tail):
                if isinstance(dim, ast.Constant) \
                        and type(dim.value) is int \
                        and dim.value > 1 and not _is_pow2(dim.value):
                    out.append(Finding(
                        "SWAN103", rel, dim.lineno, dim.col_offset,
                        f"literal dim {dim.value} in {d or tail}(...) inside "
                        f"dispatch function {f.qual} is not a power of two "
                        "— route it through a bucket (cf. _pow2/"
                        "_bucket_len) or the graph family grows per "
                        "shape", snippet=_snippet(lines, dim.lineno)))
    return out


# ---------------------------------------------------------------------------
# SWAN104 — spec completeness (cross-module; see lint_paths)
# ---------------------------------------------------------------------------

def extract_known_leaf_names(tree: ast.Module) -> Optional[Set[str]]:
    """Static read of ``KNOWN_LEAF_NAMES = (...)`` from serve_specs."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) \
                        and tgt.id == "KNOWN_LEAF_NAMES" \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    return {e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)}
    return None


def _is_array_ctor(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    d = _dotted(value.func) or ""
    tail = d.rsplit(".", 1)[-1]
    return ("." in d or tail.startswith("_")) \
        and tail.lstrip("_") in _ARRAY_CTOR_TAILS


def extract_state_leaves(tree: ast.Module) -> List[Tuple[str, int]]:
    """(leaf key, line) pairs for tensor-valued dict keys built by the
    state initialisers (``_STATE_INIT_RE``).  Dict values that are
    themselves dicts or other calls are containers, not leaves."""
    out: List[Tuple[str, int]] = []
    for f in _function_index(tree):
        if not _STATE_INIT_RE.match(f.name):
            continue
        for node in ast.walk(f.node):
            if isinstance(node, ast.Dict):
                for key, value in zip(node.keys, node.values):
                    if isinstance(key, ast.Constant) \
                            and isinstance(key.value, str) \
                            and _is_array_ctor(value):
                        out.append((key.value, key.lineno))
            elif (isinstance(node, ast.Assign)
                  and len(node.targets) == 1
                  and isinstance(node.targets[0], ast.Subscript)
                  and isinstance(node.targets[0].slice, ast.Constant)
                  and isinstance(node.targets[0].slice.value, str)
                  and _is_array_ctor(node.value)):
                # d["idx"] = torch.zeros(...): the conditional-leaf idiom
                out.append((node.targets[0].slice.value,
                            node.targets[0].lineno))
    return out


def spec_completeness_findings(known: Set[str],
                               leaves_by_file: Dict[str, List[Tuple[str,
                                                                    int]]],
                               lines_by_file: Dict[str, Sequence[str]]
                               ) -> List[Finding]:
    out: List[Finding] = []
    for rel, leaves in sorted(leaves_by_file.items()):
        for name, line in leaves:
            if name not in known:
                out.append(Finding(
                    "SWAN104", rel, line, 0,
                    f"serve-state leaf {name!r} has no rule in "
                    "repro_torch.sharding.serve_specs (KNOWN_LEAF_NAMES) — "
                    "over a data mesh it would ship replicated and every "
                    "shard would write the full array",
                    snippet=_snippet(lines_by_file.get(rel, []), line)))
    return out


# ---------------------------------------------------------------------------
# SWAN105 — obs hygiene
# ---------------------------------------------------------------------------

def _rule_obs(tree: ast.Module, rel: str, lines) -> List[Finding]:
    rel_n = _norm(rel)
    if "/obs/" in rel_n or rel_n.startswith("obs/"):
        return []
    out: List[Finding] = []
    for node in ast.iter_child_nodes(tree):           # module level only
        if not isinstance(node, ast.Assign):
            continue
        val = node.value
        dictish = isinstance(val, (ast.Dict, ast.DictComp)) or (
            isinstance(val, ast.Call)
            and (_dotted(val.func) or "").rsplit(".", 1)[-1] in
            ("defaultdict", "Counter", "dict", "OrderedDict"))
        if not dictish:
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and _METRIC_NAME_RE.search(tgt.id):
                out.append(Finding(
                    "SWAN105", rel, node.lineno, node.col_offset,
                    f"module-level metrics container {tgt.id!r} bypasses "
                    "MetricsRegistry — mint instruments through the "
                    "registry (repro_torch.obs.metrics) so they reach the "
                    "exposition and the schema-drift guard",
                    snippet=_snippet(lines, node.lineno)))
    return out


# ---------------------------------------------------------------------------
# Running the rules
# ---------------------------------------------------------------------------

_PER_FILE_RULES = (_rule_imports, _rule_host_sync, _rule_bucketing,
                   _rule_obs)


def apply_suppressions(findings: List[Finding],
                       sup: Dict[int, Tuple[Set[str], str]]
                       ) -> List[Finding]:
    for f in findings:
        hit = sup.get(f.line)
        if hit and f.rule in hit[0]:
            f.suppressed = True
            f.justification = hit[1]
    return findings


def lint_source(text: str, rel: str) -> List[Finding]:
    """All findings for one module (suppressions applied)."""
    lines = text.splitlines()
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding("SWAN100", rel, e.lineno or 0, 0,
                        f"file does not parse: {e.msg}")]
    findings: List[Finding] = []
    for rule in _PER_FILE_RULES:
        findings.extend(rule(tree, rel, lines))
    sup, bad = suppression_map(text, tree, rel)
    findings.extend(bad)
    return apply_suppressions(findings, sup)


def lint_paths(root: str, rel_paths: Iterable[str]) -> List[Finding]:
    """Lint a file set (paths relative to ``root``), the cross-module
    spec-completeness rule (SWAN104) included: it runs when the set holds
    the port's ``sharding/serve_specs.py``."""
    findings: List[Finding] = []
    known: Optional[Set[str]] = None
    leaves_by_file: Dict[str, List[Tuple[str, int]]] = {}
    lines_by_file: Dict[str, Sequence[str]] = {}
    sups: Dict[str, Dict[int, Tuple[Set[str], str]]] = {}
    for rel in sorted(rel_paths):
        try:
            with open(os.path.join(root, rel), "r", encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            continue
        findings.extend(lint_source(text, rel))
        rel_n = _norm(rel)
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue
        sups[rel], _ = suppression_map(text, tree, rel)
        if rel_n.endswith("sharding/serve_specs.py"):
            known = extract_known_leaf_names(tree)
        if rel_n.endswith(SPEC_STATE_MODULES):
            leaves = extract_state_leaves(tree)
            if leaves:
                leaves_by_file[rel] = leaves
                lines_by_file[rel] = text.splitlines()
    if known is not None and leaves_by_file:
        extra = spec_completeness_findings(known, leaves_by_file,
                                           lines_by_file)
        for f in extra:
            apply_suppressions([f], sups.get(f.path, {}))
        findings.extend(extra)
    return findings
