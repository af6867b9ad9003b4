"""The port's AST linter: the conventions its tests rely on, as
machine-checked rules. The port's copy of ``heat2d_tpu/analysis/lint.py``,
re-rooted: it lints ``heat2d_tpu_torch/`` and the port's root scripts
(``chip_smoke.py``, ``bench_torch.py``), never the JAX package.

- **R001 atomic-write discipline**: ``open(path, "w"/"wb")`` on a
  persistent artifact must go through the tmp + fsync + ``os.replace``
  idiom (``io/binary.py``'s commit protocol). A direct write can be torn
  by a crash and then load as a valid artifact. Exempt: staging paths
  (the expression mentions ``tmp``) and functions that themselves
  ``os.replace`` (they ARE the idiom).
- **R002 no wall-clock/RNG in traced code**: ``time.*``,
  ``datetime.now``, ``random.*`` inside a traced scope bake one
  trace-time value into the captured program. A traced scope is a
  function handed to one of torch's tracing entry points:
  ``torch.fx.symbolic_trace``, ``torch.jit.script``/``trace``,
  ``torch.compile``, the ``torch.func`` transforms,
  ``torch.cuda.make_graphed_callables``, or the body of a ``with
  torch.cuda.graph(g):`` capture (how a ``CUDAGraph`` is captured).
- **R003 traced-value leaks**: ``float()``/``int()``/``bool()`` /
  ``.item()`` on tensor values inside traced scopes (a graph break, a
  capture error or a host sync).
- **R004 chaos purity**: ``resil/chaos.py`` may not import or touch
  torch: a campaign changes only the host's orchestration around a
  launch, never what a launch computes (``analysis.launch_pin``).
- **R005 metric/doc drift**: every metric family instantiated through
  the obs registry must appear in the port's metric tables (the
  README's "Port metric families" section), and every family listed
  there must exist in code.
- **R006 bare locks in serve/resil/mesh**: threaded modules take their
  mutexes from ``analysis.locks`` so the lock audit
  (``HEAT2D_LOCK_AUDIT=1``) sees every acquisition.

The port calls none of torch's tracing entry points today, so R002/R003
check an empty set on the tree; their tests seed one. Pure stdlib
``ast``; the ``heat2d-tpu-torch-lint`` CLI (``analysis/cli.py``) holds the
tree at zero findings not in ``analysis/baseline.json``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

ALL_RULES = ("R001", "R002", "R003", "R004", "R005", "R006")

#: the package linted, and the port's scripts at the repo root
PACKAGE = "heat2d_tpu_torch"
ROOT_SCRIPTS = ("chip_smoke.py", "bench_torch.py")

#: directory names never scanned (the JAX package is never linted here)
SKIP_DIRS = {"tests", "__pycache__", ".git", ".claude", "benchmarks",
             "heat2d_tpu"}

#: skipped only when they are NOT python packages: "dist"/"build" name
#: setuptools output, but heat2d_tpu_torch/dist/ (the multi-process
#: runtime) is source: the __init__.py is the tiebreaker
ARTIFACT_DIRS = {"build", "dist"}

#: last names of torch's tracing entry points whose function-valued
#: arguments become traced scopes, when the call chain starts at one of
#: ``TRACER_ROOTS`` (``torch.compile``, ``torch.jit.script``,
#: ``fx.symbolic_trace``, ``torch.func.vmap``, ...)
TRACER_CALLS = {
    "symbolic_trace", "compile", "script", "trace", "trace_module",
    "make_graphed_callables", "vmap", "grad", "grad_and_value", "jacrev",
    "jacfwd", "hessian", "vjp", "jvp", "functional_call", "export",
}

#: first names of a call chain that make ``TRACER_CALLS`` torch's
TRACER_ROOTS = {"torch", "fx", "jit", "func", "functorch"}

#: tracing entry points recognized by their bare name alone (imported
#: with ``from torch.fx import symbolic_trace`` and the like; the others,
#: such as ``compile`` or ``trace``, are too common a name)
BARE_TRACER_CALLS = {"symbolic_trace", "make_graphed_callables", "vmap",
                     "jacrev", "jacfwd", "functional_call"}

#: context managers whose body is captured: ``with torch.cuda.graph(g):``
CAPTURE_CONTEXTS = {"graph"}

#: callees whose function-valued arguments run on the HOST (never mark
#: their arguments traced even when lexically inside a tracer call)
HOST_CALLS = {"Thread", "submit", "partial", "register_hook"}

#: wall-clock / RNG call chains banned inside traced scopes (R002)
WALLCLOCK_ROOTS = {"time", "random"}
WALLCLOCK_DATETIME_ATTRS = {"now", "utcnow", "today"}

METRIC_METHODS = {"counter", "gauge", "observe", "series", "timer"}

#: the README section whose backticked names are the port's metric tables
METRICS_HEADING = "Port metric families"

#: metric families the drift rule covers (names outside these prefixes
#: are not part of the documented contract)
METRIC_RE = re.compile(
    r"^(serve|fleet|resil|tune|inverse|slo|load|control|mesh|adi|mg"
    r"|perf|problem|ir|analysis|autoscale|dist)_[a-z0-9_]+$")

#: keyword names whose literal string values name a metric family
#: (e.g. ``SingleFlight(counter="fleet_coalesced_total")``); ``name``
#: only in a call of one of ``METRIC_METHODS`` (elsewhere it names other
#: things: ``MixProfile(name="inverse_heavy")`` is a traffic profile)
METRIC_KEYWORDS = {"counter", "metric", "name"}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str           # posix-relative to the scanned root
    line: int
    context: str        # enclosing qualname, or a rule-specific tag
    match: str          # short source snippet (baseline identity)
    message: str

    @property
    def key(self) -> str:
        """Line-number-free identity: a finding keeps its baseline
        entry across unrelated edits to the same file."""
        return f"{self.rule}:{self.path}:{self.context}:{self.match}"

    def render(self) -> str:
        return (f"{self.rule} {self.path}:{self.line} [{self.context}] "
                f"{self.message}  ->  {self.match}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self) | {"key": self.key}


class BaselineError(ValueError):
    """A malformed baseline file (entry without a justification, bad
    schema): a grandfathered finding without a WHY is just a
    suppressed finding."""


def load_baseline(path: Optional[str]) -> Dict[str, str]:
    """{finding key: justification}. Every entry must carry a
    non-empty ``justification`` string."""
    if path is None or not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    entries = data.get("findings")
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: expected a 'findings' list")
    out: Dict[str, str] = {}
    for e in entries:
        key = e.get("key")
        just = e.get("justification")
        if not key or not isinstance(key, str):
            raise BaselineError(f"{path}: entry missing 'key': {e}")
        if not just or not isinstance(just, str) or not just.strip():
            raise BaselineError(
                f"{path}: baselined finding {key!r} has no "
                "justification — grandfathering requires a reason")
        out[key] = just
    return out


# ------------------------------------------------------------------ #
# shared AST plumbing
# ------------------------------------------------------------------ #

def _attr_chain(node: ast.AST) -> List[str]:
    """``a.b.c(...)`` -> ["a", "b", "c"]; empty when not a plain
    name/attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def _terminal_name(func: ast.AST) -> Optional[str]:
    chain = _attr_chain(func)
    return chain[-1] if chain else None


def _snippet(src_lines: List[str], node: ast.AST, limit: int = 96) -> str:
    try:
        text = ast.get_source_segment("\n".join(src_lines), node)
    except Exception:
        text = None
    if not text:
        line = src_lines[node.lineno - 1] if node.lineno - 1 < len(
            src_lines) else ""
        text = line.strip()
    text = " ".join(text.split())
    return text[:limit]


class _Scopes(ast.NodeVisitor):
    """Function table + parent/qualname maps for one module."""

    def __init__(self, tree: ast.Module):
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.functions: List[ast.AST] = []
        self.qualnames: Dict[ast.AST, str] = {}
        self.module_funcs: Dict[str, ast.AST] = {}
        self._stack: List[str] = []
        self._class_depth = 0
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self._visit_block(tree)

    def _visit_block(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = ".".join(self._stack + [child.name])
                self.qualnames[child] = qn
                self.functions.append(child)
                if not self._stack:
                    self.module_funcs[child.name] = child
                self._stack.append(child.name)
                self._visit_block(child)
                self._stack.pop()
            elif isinstance(child, ast.Lambda):
                qn = ".".join(self._stack + ["<lambda>"])
                self.qualnames[child] = qn
                self.functions.append(child)
                self._visit_block(child)
            elif isinstance(child, ast.ClassDef):
                self._stack.append(child.name)
                self._visit_block(child)
                self._stack.pop()
            else:
                self._visit_block(child)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def context_of(self, node: ast.AST) -> str:
        fn = self.enclosing_function(node)
        return self.qualnames.get(fn, "<module>") if fn is not None \
            else "<module>"


def _function_nodes_within(fn: ast.AST) -> Iterable[ast.AST]:
    yield fn
    for sub in ast.walk(fn):
        if sub is not fn and isinstance(
                sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            yield sub


def _is_tracer_call(func: ast.AST) -> bool:
    """True for a call of one of torch's tracing entry points."""
    chain = _attr_chain(func)
    if not chain:
        return False
    if len(chain) == 1:
        return chain[0] in BARE_TRACER_CALLS
    return chain[-1] in TRACER_CALLS and chain[0] in TRACER_ROOTS


def _capture_blocks(tree: ast.Module) -> List[ast.AST]:
    """The ``with torch.cuda.graph(g):`` statements (their bodies are
    captured into a CUDA graph)."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            ctx = item.context_expr
            chain = (_attr_chain(ctx.func) if isinstance(ctx, ast.Call)
                     else [])
            if (len(chain) >= 2 and chain[-1] in CAPTURE_CONTEXTS
                    and chain[-2] == "cuda"):
                out.append(node)
    return out


def _traced_functions(tree: ast.Module, scopes: _Scopes
                      ) -> Tuple[Set[ast.AST], List[ast.AST]]:
    """The traced scopes of one module: (functions, capture blocks).
    Functions handed to a tracing entry point (directly, by name, or
    through ``functools.partial``), functions decorated with one, the
    functions a capture block calls, everything lexically nested in
    those, then closed over same-module calls (a traced body calling a
    module-level helper traces the helper)."""
    roots: Set[ast.AST] = set()

    for fn in scopes.functions:
        for deco in getattr(fn, "decorator_list", []):
            target = deco.func if isinstance(deco, ast.Call) else deco
            if _is_tracer_call(target):
                roots.add(fn)

    def mark_arg(arg: ast.AST) -> None:
        if isinstance(arg, ast.Lambda):
            roots.add(arg)
        elif isinstance(arg, ast.Name):
            target = scopes.module_funcs.get(arg.id)
            if target is not None:
                roots.add(target)
            else:
                # a locally-defined function passed by name
                for fn in scopes.functions:
                    if getattr(fn, "name", None) == arg.id:
                        roots.add(fn)
        elif isinstance(arg, ast.Call):
            t = _terminal_name(arg.func)
            if t in HOST_CALLS and t != "partial":
                return
            for a in list(arg.args) + [k.value for k in arg.keywords]:
                mark_arg(a)

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_tracer_call(node.func):
            for arg in list(node.args) + [k.value for k in node.keywords]:
                mark_arg(arg)

    blocks = _capture_blocks(tree)
    for blk in blocks:
        for stmt in blk.body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Name):
                    callee = scopes.module_funcs.get(node.func.id)
                    if callee is not None:
                        roots.add(callee)

    traced: Set[ast.AST] = set()
    for r in roots:
        traced.update(_function_nodes_within(r))

    # fixpoint: same-module calls out of traced bodies
    changed = True
    while changed:
        changed = False
        for fn in list(traced):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Name):
                    callee = scopes.module_funcs.get(node.func.id)
                    if callee is not None and callee not in traced:
                        for sub in _function_nodes_within(callee):
                            if sub not in traced:
                                traced.add(sub)
                                changed = True
    return traced, blocks


def _param_names(fn: ast.AST) -> Set[str]:
    a = fn.args
    names = [p.arg for p in list(a.posonlyargs) + list(a.args)
             + list(a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


# ------------------------------------------------------------------ #
# per-file rules
# ------------------------------------------------------------------ #

def _walk_py(top: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in SKIP_DIRS
            and (d not in ARTIFACT_DIRS or os.path.isfile(
                os.path.join(dirpath, d, "__init__.py"))))
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _iter_py_files(root: str) -> Iterable[str]:
    """The files linted under ``root``: a repo checkout (it holds
    ``PACKAGE``) gives the package and the ``ROOT_SCRIPTS`` beside it;
    any other tree (a fixture, the package directory itself) is walked
    whole, ``SKIP_DIRS`` left out."""
    pkg = os.path.join(root, PACKAGE)
    if not os.path.isdir(pkg):
        yield from _walk_py(root)
        return
    yield from _walk_py(pkg)
    for name in ROOT_SCRIPTS:
        path = os.path.join(root, name)
        if os.path.isfile(path):
            yield path


def _relpath(path: str, root: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def _write_mode(node: ast.Call) -> Optional[str]:
    """The constant mode string of an ``open`` call when it opens for
    (over)writing — "w"/"wb"/"w+"...; None otherwise."""
    mode: Optional[ast.AST] = None
    if len(node.args) >= 2:
        mode = node.args[1]
    else:
        for k in node.keywords:
            if k.arg == "mode":
                mode = k.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
            and "w" in mode.value:
        return mode.value
    return None


def _rule_r001(rel: str, tree: ast.Module, scopes: _Scopes,
               src_lines: List[str]) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "open" and node.args):
            continue
        mode = _write_mode(node)
        if mode is None:
            continue
        path_src = _snippet(src_lines, node.args[0])
        if "tmp" in path_src.lower():
            continue                    # a staging file: the idiom's
            #                             first half, committed later
        fn = scopes.enclosing_function(node)
        search_in = fn if fn is not None else tree
        has_replace = any(
            isinstance(n, ast.Call)
            and _attr_chain(n.func)[-2:] == ["os", "replace"]
            for n in ast.walk(search_in))
        if has_replace:
            continue                    # the tmp+replace idiom inline
        out.append(Finding(
            "R001", rel, node.lineno, scopes.context_of(node),
            _snippet(src_lines, node),
            f"direct open(..., {mode!r}) on a persistent artifact: "
            "use the tmp + fsync + os.replace idiom "
            "(io.binary.write_text_atomic / write_json_atomic)"))
    return out


def _rule_r002_r003(rel: str, tree: ast.Module, scopes: _Scopes,
                    src_lines: List[str], rules: Set[str]
                    ) -> List[Finding]:
    out: List[Finding] = []
    traced, blocks = _traced_functions(tree, scopes)
    if not traced and not blocks:
        return out
    traced_params: Dict[ast.AST, Set[str]] = {}

    def params_in_scope(fn: Optional[ast.AST]) -> Set[str]:
        if fn is None:
            return set()
        if fn not in traced_params:
            names: Set[str] = set()
            cur: Optional[ast.AST] = fn
            while cur is not None and cur in traced:
                names |= _param_names(cur)
                cur = scopes.enclosing_function(cur)
            traced_params[fn] = names
        return traced_params[fn]

    # (call, the names a traced value may go by there)
    calls: List[Tuple[ast.Call, Set[str]]] = []
    for fn in traced:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    scopes.enclosing_function(node) is fn:
                calls.append((node, params_in_scope(fn)))
    for blk in blocks:
        host = scopes.enclosing_function(blk)
        names = _param_names(host) if host is not None else set()
        for stmt in blk.body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) and \
                        scopes.enclosing_function(node) is host:
                    calls.append((node, names))

    seen: Set[int] = set()
    for node, names in calls:
        if id(node) in seen:
            continue
        seen.add(id(node))
        chain = _attr_chain(node.func)
        if "R002" in rules and chain:
            rooted = chain[0]
            term = chain[-1]
            bad = (
                (rooted in WALLCLOCK_ROOTS and len(chain) > 1)
                or ("datetime" in chain and term in WALLCLOCK_DATETIME_ATTRS)
                or (len(chain) >= 2 and chain[-2] == "random"
                    and rooted in ("np", "numpy"))
            )
            if bad:
                out.append(Finding(
                    "R002", rel, node.lineno, scopes.context_of(node),
                    _snippet(src_lines, node),
                    "wall-clock/RNG call inside a traced scope: the value "
                    "is baked in when the program is captured (read it on "
                    "the host and pass it in)"))
        if "R003" in rules:
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "item":
                out.append(Finding(
                    "R003", rel, node.lineno, scopes.context_of(node),
                    _snippet(src_lines, node),
                    ".item() on a value inside a traced scope: a graph "
                    "break, a capture error or a host sync"))
            elif (isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int", "bool")
                    and node.args):
                mentioned = {n.id for n in ast.walk(node.args[0])
                             if isinstance(n, ast.Name)}
                if mentioned & names:
                    out.append(Finding(
                        "R003", rel, node.lineno, scopes.context_of(node),
                        _snippet(src_lines, node),
                        f"{node.func.id}() applied to a traced value "
                        "inside a traced scope: reads the tensor back to "
                        "the host"))
    return out


def _rule_r004(rel: str, tree: ast.Module, scopes: _Scopes,
               src_lines: List[str]) -> List[Finding]:
    if not rel.endswith("resil/chaos.py"):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch" or alias.name.startswith("torch."):
                    out.append(Finding(
                        "R004", rel, node.lineno, scopes.context_of(node),
                        _snippet(src_lines, node),
                        "chaos hooks must stay torch-free: a campaign may "
                        "change the host's orchestration, never what a "
                        "launch computes"))
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "torch" or mod.startswith("torch."):
                out.append(Finding(
                    "R004", rel, node.lineno, scopes.context_of(node),
                    _snippet(src_lines, node),
                    "chaos hooks must stay torch-free (import from torch)"))
        elif isinstance(node, ast.Attribute):
            chain = _attr_chain(node)
            # the outermost attribute of a chain only (one finding each)
            if chain and chain[0] == "torch" and not isinstance(
                    scopes.parents.get(node), ast.Attribute):
                out.append(Finding(
                    "R004", rel, node.lineno, scopes.context_of(node),
                    _snippet(src_lines, node),
                    "chaos hooks must not touch torch values"))
    return out


def _rule_r006(rel: str, tree: ast.Module, scopes: _Scopes,
               src_lines: List[str]) -> List[Finding]:
    if not any(seg in rel.split("/") for seg in ("serve", "fleet",
                                                 "resil", "mesh")):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if chain[:1] == ["threading"] and chain[-1] in (
                "Lock", "RLock", "Condition"):
            out.append(Finding(
                "R006", rel, node.lineno, scopes.context_of(node),
                _snippet(src_lines, node),
                f"bare threading.{chain[-1]} in a threaded module: use "
                "analysis.locks.AuditedLock/AuditedRLock/AuditedCondition "
                "so HEAT2D_LOCK_AUDIT sees it"))
    return out


# ------------------------------------------------------------------ #
# R005: metric/doc drift (cross-file)
# ------------------------------------------------------------------ #

def _code_metric_names(trees: Dict[str, ast.Module]) -> Tuple[
        Dict[str, Tuple[str, int]], Set[str]]:
    """(literal name -> (file, line), wildcard suffixes). A metric
    instantiated with ``prefix + "_suffix"`` contributes a wildcard,
    checked loosely (some documented name must end with the suffix)."""
    names: Dict[str, Tuple[str, int]] = {}
    wildcards: Set[str] = set()

    def note(value, rel, lineno) -> None:
        if isinstance(value, str) and METRIC_RE.match(value):
            names.setdefault(value, (rel, lineno))

    for rel, tree in trees.items():
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # metric names as the defaults of parameters named like a
                # metric slot (``counter="serve_coalesced_total"``)
                pos = node.args.posonlyargs + node.args.args
                for prm, d in zip(pos[len(pos) - len(node.args.defaults):],
                                  node.args.defaults):
                    if prm.arg in METRIC_KEYWORDS and isinstance(
                            d, ast.Constant):
                        note(d.value, rel, d.lineno)
                for prm, d in zip(node.args.kwonlyargs,
                                  node.args.kw_defaults):
                    if d is not None and prm.arg in METRIC_KEYWORDS \
                            and isinstance(d, ast.Constant):
                        note(d.value, rel, d.lineno)
                continue
            if not isinstance(node, ast.Call):
                continue
            method = (isinstance(node.func, ast.Attribute)
                      and node.func.attr in METRIC_METHODS)
            for kw in node.keywords:
                if kw.arg in METRIC_KEYWORDS and isinstance(
                        kw.value, ast.Constant) and (
                            method or kw.arg != "name"):
                    note(kw.value.value, rel, kw.value.lineno)
            if not (method and node.args):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                note(arg.value, rel, node.lineno)
            elif (isinstance(arg, ast.BinOp)
                    and isinstance(arg.op, ast.Add)
                    and isinstance(arg.right, ast.Constant)
                    and isinstance(arg.right.value, str)):
                wildcards.add(arg.right.value)
    return names, wildcards


_DOC_METRIC_RE = re.compile(
    r"`((?:serve|fleet|resil|tune|inverse|slo|load|control|mesh|adi|mg"
    r"|perf|problem|ir|analysis|autoscale|dist)_[a-z0-9_*]+)"
    r"(?:\{[^`]*\})?`")

_HEADING_RE = re.compile(r"^(#+)\s+(.*)$")


def default_docs_path(root: str) -> str:
    return os.path.join(root, "README.md")


def _doc_metric_names(docs_path: str) -> Dict[str, Tuple[str, int]]:
    """The backticked metric families of the port's tables: the section
    of ``docs_path`` under the ``METRICS_HEADING`` heading (down to the
    next heading of its level or above), or the whole file when it has no
    such heading (a metrics page of its own)."""
    out: Dict[str, Tuple[str, int]] = {}
    if not os.path.isfile(docs_path):
        return out
    with open(docs_path) as f:
        lines = f.read().splitlines()
    headed = any(_HEADING_RE.match(x) and METRICS_HEADING in x
                 for x in lines)
    level = None
    inside = not headed
    name_of = os.path.basename(docs_path)
    for i, line in enumerate(lines, 1):
        m = _HEADING_RE.match(line)
        if headed and m:
            if METRICS_HEADING in m.group(2):
                inside, level = True, len(m.group(1))
                continue
            if inside and len(m.group(1)) <= level:
                inside = False
        if not inside:
            continue
        for mm in _DOC_METRIC_RE.finditer(line):
            name = mm.group(1)
            if name.endswith("_"):
                # brace shorthand (``serve_cache_{size,hit_rate}``): a
                # prefix wildcard
                name += "*"
            out.setdefault(name, (name_of, i))
    return out


def _rule_r005(trees: Dict[str, ast.Module],
               docs_path: str) -> List[Finding]:
    code, code_wild = _code_metric_names(trees)
    docs = _doc_metric_names(docs_path)
    doc_exact = {n for n in docs if "*" not in n}
    doc_prefixes = {n.rstrip("*") for n in docs if "*" in n}
    out: List[Finding] = []

    def doc_covers(name: str) -> bool:
        return name in doc_exact or any(
            name.startswith(p) for p in doc_prefixes)

    for name, (rel, line) in sorted(code.items()):
        if not doc_covers(name):
            out.append(Finding(
                "R005", rel, line, "metrics", name,
                f"metric family {name!r} is instantiated here but appears "
                f"in no row of the port's metric tables "
                f"({os.path.basename(docs_path)}, {METRICS_HEADING!r})"))

    code_exact = set(code)

    def code_covers(name: str) -> bool:
        if "*" in name:
            prefix = name.rstrip("*")
            return (any(c.startswith(prefix) for c in code_exact)
                    or bool(code_wild))
        return (name in code_exact
                or any(name.endswith(x) for x in code_wild))

    for name, (rel, line) in sorted(docs.items()):
        if not code_covers(name):
            out.append(Finding(
                "R005", rel, line, "metrics", name,
                f"documented metric family {name!r} is never instantiated "
                f"in code"))
    return out


# ------------------------------------------------------------------ #
# driver
# ------------------------------------------------------------------ #

def lint_tree(root: str, rules: Optional[Iterable[str]] = None,
              docs_path: Optional[str] = None) -> List[Finding]:
    """Run the selected rules over the port's ``*.py`` under ``root``
    (``_iter_py_files``) plus the docs drift check against ``docs_path``
    (default: ``root``'s README.md). Returns findings sorted by (path,
    line)."""
    active = set(rules) if rules is not None else set(ALL_RULES)
    unknown = active - set(ALL_RULES)
    if unknown:
        raise ValueError(f"unknown rule(s): {sorted(unknown)}")
    trees: Dict[str, ast.Module] = {}
    sources: Dict[str, List[str]] = {}
    findings: List[Finding] = []
    for path in _iter_py_files(root):
        rel = _relpath(path, root)
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            findings.append(Finding(
                "R000", rel, e.lineno or 0, "<module>", "syntax-error",
                f"file does not parse: {e.msg}"))
            continue
        trees[rel] = tree
        sources[rel] = src.splitlines()

    for rel, tree in trees.items():
        scopes = _Scopes(tree)
        lines = sources[rel]
        if "R001" in active:
            findings.extend(_rule_r001(rel, tree, scopes, lines))
        if active & {"R002", "R003"}:
            findings.extend(_rule_r002_r003(rel, tree, scopes, lines,
                                            active))
        if "R004" in active:
            findings.extend(_rule_r004(rel, tree, scopes, lines))
        if "R006" in active:
            findings.extend(_rule_r006(rel, tree, scopes, lines))

    if "R005" in active:
        findings.extend(_rule_r005(
            trees, docs_path if docs_path is not None
            else default_docs_path(root)))

    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def split_baselined(findings: List[Finding],
                    baseline: Dict[str, str]) -> Tuple[
        List[Finding], List[Finding], List[str]]:
    """(new, grandfathered, stale-baseline-keys)."""
    new, old = [], []
    seen: Set[str] = set()
    for f in findings:
        if f.key in baseline:
            old.append(f)
            seen.add(f.key)
        else:
            new.append(f)
    stale = [k for k in baseline if k not in seen]
    return new, old, stale
