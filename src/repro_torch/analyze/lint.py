"""Pass 2 — the concurrency lint, a copy of ``repro.analyze.lint``.

An AST-based checker over ``src/repro_torch`` that turns the threading
invariants documented in comments (``dispatch/store.py`` lock-order block,
``dispatch/service.py`` one-lock fast path) into machine-checked rules:

  * **REP101** — ``time.time()`` used in a duration computation
    (``time.time() - t0``). Wall clocks step under NTP; durations must use
    ``time.monotonic()`` / ``time.perf_counter()``. Persisted cross-process
    timestamps legitimately subtract wall-clock values — allowlist those
    sites with a pragma.
  * **REP102** — shared-state mutation outside a lock in a lock-owning
    class. The invariant is self-consistency: an attribute that is ever
    mutated inside a ``with <lock>:`` block must be mutated under the lock
    *everywhere* (``__init__`` and ``*_locked`` caller-holds-lock helpers
    exempt; private helpers whose every call site is already inside a
    locked region inherit that protection).
  * **REP103** — lock-order violation. Lock classes carry ranks
    (``TuningStore`` = 0, ``OpLog`` = 1; the documented order is always
    store → fleet) and acquiring a lower-ranked lock while holding a
    higher-ranked one — directly or through a method call — is flagged.
  * **REP104** — a ``threading.Thread`` started without ``daemon=True``
    and without an enclosing stop/shutdown method: an unowned thread that
    can hang interpreter exit.
  * **REP105** — a broad ``except`` (bare / ``Exception`` /
    ``BaseException``) inside a thread run-loop that neither increments a
    counter nor re-raises. A daemon loop that silently eats its errors
    looks healthy while doing nothing (the SyncAgent anti-entropy swallow
    is the canonical *almost*-instance — it passes because it counts
    per-error-class stats). Handlers in methods a run-loop calls each
    iteration are covered too.

Allowlist pragma (on the flagged line or the line above)::

    x = time.time() - rec.created  # lint: allow=REP101 cross-host wall-clock

Multiple codes: ``# lint: allow=REP101,REP102 <reason>``.

Entry points: :func:`lint_source` (one snippet — test fixtures),
:func:`lint_paths` (files/dirs; builds the cross-module class table first so
REP103 resolves ``self.store.put()`` through ``__init__`` annotations).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Iterable, Mapping

__all__ = ["LintFinding", "lint_paths", "lint_source", "lint_sources",
           "LOCK_RANKS", "ATTR_TYPES"]

# documented lock order: store locks are acquired before fleet locks, never
# the reverse (dispatch/store.py op-sink contract). Lower rank = acquired
# earlier; REP103 fires on acquiring a lower rank while holding a higher.
LOCK_RANKS: dict[str, int] = {"TuningStore": 0, "OpLog": 1}

# conventional attribute names -> class, used when __init__ gives no
# annotation to resolve `self.<attr>.<method>()` receivers
ATTR_TYPES: dict[str, str] = {
    "store": "TuningStore",
    "oplog": "OpLog",
    "service": "DispatchService",
    "replica": "Replica",
}

# dict/list/set mutators counted as shared-state mutation by REP102
_MUTATORS = frozenset({
    "append", "extend", "insert", "add", "update", "pop", "popitem",
    "clear", "remove", "discard", "setdefault",
})

_THREAD_OWNER_METHODS = frozenset({"stop", "shutdown", "close", "join_all"})

# calls that count as "the error was accounted for" in a run-loop handler
# (REP105): metric/stat increments and bounded error-list appends. Logging
# deliberately does NOT qualify — a log line is not a queryable signal.
_COUNTERISH = frozenset({
    "add", "observe", "inc", "increment", "append", "record", "set_gauge",
})

_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow=([A-Z0-9,]+)")


@dataclass(frozen=True)
class LintFinding:
    code: str
    message: str
    path: str
    line: int

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def to_dict(self) -> dict:
        return {"code": self.code, "message": self.message,
                "path": self.path, "line": self.line}


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------


def _attr_chain(node: ast.AST) -> list[str] | None:
    """``self.store.put`` -> ["self", "store", "put"]; None for anything
    that is not a pure Name/Attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _annotation_class(node: ast.AST | None) -> str | None:
    """Best-effort class name out of an annotation: handles ``OpLog``,
    ``OpLog | None``, ``Optional[OpLog]``, ``"OpLog"``."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        name = node.value
        for tok in re.split(r"[\[\]|,\s]+", name):
            tok = tok.strip().rsplit(".", 1)[-1]
            if tok and tok not in ("None", "Optional", "Union"):
                return tok
        return None
    if isinstance(node, ast.Name):
        return None if node.id in ("None",) else node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _annotation_class(node.left) or _annotation_class(node.right)
    if isinstance(node, ast.Subscript):
        chain = _attr_chain(node.value)
        if chain and chain[-1] in ("Optional", "Union"):
            inner = node.slice
            if isinstance(inner, ast.Tuple):
                for elt in inner.elts:
                    got = _annotation_class(elt)
                    if got:
                        return got
                return None
            return _annotation_class(inner)
    return None


def _is_wallclock_call(node: ast.AST) -> bool:
    """A call to ``time.time`` (or bare ``time()`` from ``from time import
    time``) anywhere in this subtree."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        chain = _attr_chain(sub.func)
        if chain in (["time", "time"], ["time"]):
            return True
    return False


def _is_lockish_item(expr: ast.AST) -> list[str] | None:
    """The attr chain of a with-item that acquires a lock: ``self._lock``,
    ``self._tlock``, ``self._lock()``, ``svc._lock`` — anything whose final
    attribute name contains "lock"."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    chain = _attr_chain(expr)
    if chain and len(chain) >= 2 and "lock" in chain[-1].lower():
        return chain
    return None


def _mutated_self_attr(stmt: ast.stmt) -> tuple[str, int, bool] | None:
    """If ``stmt`` mutates ``self.<attr>`` (item/attr assignment, augmented
    assignment, del, or a mutating method call), return
    (attr, lineno, direct). ``direct`` distinguishes structural mutations
    (assignment/del/augassign — these define an attribute as lock-guarded
    when they appear under a lock) from mutator *method calls*
    (``.append()``/``.update()``/...), which are only ever flagged, never
    used to infer guarding: objects like the obs registry or
    ``threading.Event`` expose thread-safe mutators that legitimately run
    lock-free."""

    def base_attr(node: ast.AST) -> str | None:
        # peel subscripts: self.stats["x"] -> self.stats
        while isinstance(node, ast.Subscript):
            node = node.value
        chain = _attr_chain(node)
        if chain and chain[0] == "self" and len(chain) == 2:
            return chain[1]
        return None

    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            attr = base_attr(tgt)
            if attr is not None:
                return attr, stmt.lineno, True
    elif isinstance(stmt, (ast.AugAssign,)):
        attr = base_attr(stmt.target)
        if attr is not None:
            return attr, stmt.lineno, True
    elif isinstance(stmt, ast.Delete):
        for tgt in stmt.targets:
            attr = base_attr(tgt)
            if attr is not None:
                return attr, stmt.lineno, True
    elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        chain = _attr_chain(stmt.value.func)
        if (chain and chain[0] == "self" and len(chain) == 3
                and chain[2] in _MUTATORS):
            return chain[1], stmt.lineno, False
    return None


# ---------------------------------------------------------------------------
# per-class model
# ---------------------------------------------------------------------------


class ClassModel:
    def __init__(self, node: ast.ClassDef, path: str):
        self.node = node
        self.path = path
        self.name = node.name
        self.rank = LOCK_RANKS.get(node.name)
        self.methods: dict[str, ast.FunctionDef] = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.lock_attrs: set[str] = set()
        self.attr_types: dict[str, str] = {}
        self.has_stop = bool(_THREAD_OWNER_METHODS & self.methods.keys())
        self._scan_init()
        # method name -> set of lock ranks it (transitively, within this
        # class) acquires; filled in by the cross-class pass
        self.acquires: dict[str, set[int]] = {}

    def _scan_init(self) -> None:
        init = self.methods.get("__init__")
        ann: dict[str, str | None] = {}
        if init is not None:
            all_args = list(init.args.posonlyargs) + list(init.args.args) \
                + list(init.args.kwonlyargs)
            for a in all_args:
                ann[a.arg] = _annotation_class(a.annotation)
            for stmt in ast.walk(init):
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    chain = _attr_chain(stmt.targets[0])
                    if not (chain and chain[0] == "self" and len(chain) == 2):
                        continue
                    attr = chain[1]
                    # self._lock = threading.Lock() / RLock() / Condition()
                    if isinstance(stmt.value, ast.Call):
                        vchain = _attr_chain(stmt.value.func)
                        if vchain and vchain[-1] in ("Lock", "RLock",
                                                     "Condition"):
                            self.lock_attrs.add(attr)
                            continue
                    # self.store = store  (param with annotation)
                    vchain = _attr_chain(stmt.value)
                    if vchain and len(vchain) == 1 and ann.get(vchain[0]):
                        self.attr_types[attr] = ann[vchain[0]]
                elif isinstance(stmt, ast.AnnAssign):
                    chain = _attr_chain(stmt.target)
                    if chain and chain[0] == "self" and len(chain) == 2:
                        got = _annotation_class(stmt.annotation)
                        if got:
                            self.attr_types[chain[1]] = got

    def resolve_attr_class(self, attr: str) -> str | None:
        return self.attr_types.get(attr) or ATTR_TYPES.get(attr)


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------


class Linter:
    def __init__(self) -> None:
        self._modules: list[tuple[str, str, ast.Module]] = []
        self.classes: dict[str, ClassModel] = {}

    def add_source(self, src: str, path: str) -> None:
        tree = ast.parse(src, filename=path)
        self._modules.append((path, src, tree))
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = ClassModel(node, path)

    # -- cross-class lock summaries (REP103 support) -------------------------

    def _item_rank(self, cm: ClassModel, chain: list[str]) -> int | None:
        """Rank of the lock a with-item chain acquires, if resolvable."""
        if chain[0] == "self":
            if len(chain) == 2:
                return cm.rank
            owner = cm.resolve_attr_class(chain[1])
            if owner is not None:
                target = self.classes.get(owner)
                return target.rank if target else LOCK_RANKS.get(owner)
        return None

    def _compute_acquires(self) -> None:
        """Fixpoint: ranks each method acquires via its own with-items plus
        self-method and typed-attr method calls."""
        for cm in self.classes.values():
            for name in cm.methods:
                cm.acquires[name] = set()
        changed = True
        while changed:
            changed = False
            for cm in self.classes.values():
                for name, fn in cm.methods.items():
                    got = set(cm.acquires[name])
                    for node in ast.walk(fn):
                        if isinstance(node, ast.With):
                            for item in node.items:
                                chain = _is_lockish_item(item.context_expr)
                                if chain:
                                    r = self._item_rank(cm, chain)
                                    if r is not None:
                                        got.add(r)
                        elif isinstance(node, ast.Call):
                            got |= self._call_acquires(cm, node)
                    if got != cm.acquires[name]:
                        cm.acquires[name] = got
                        changed = True

    def _call_acquires(self, cm: ClassModel, call: ast.Call) -> set[int]:
        chain = _attr_chain(call.func)
        if not chain or chain[0] != "self":
            return set()
        if len(chain) == 2:  # self.method()
            return set(cm.acquires.get(chain[1], ()))
        if len(chain) == 3:  # self.attr.method()
            owner = cm.resolve_attr_class(chain[1])
            target = self.classes.get(owner) if owner else None
            if target is not None:
                return set(target.acquires.get(chain[2], ()))
            if owner in LOCK_RANKS:
                # class not in the linted set: assume any method may take
                # its own lock
                return {LOCK_RANKS[owner]}
        return set()

    # -- rule walks ----------------------------------------------------------

    def run(self) -> list[LintFinding]:
        self._compute_acquires()
        findings: list[LintFinding] = []
        for path, src, tree in self._modules:
            raw: list[LintFinding] = []
            raw += self._check_durations(path, tree)
            raw += self._check_threads(path, tree)
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    cm = self.classes[node.name]
                    raw += self._check_guarded_mutations(path, cm)
                    raw += self._check_lock_order(path, cm)
                    raw += self._check_runloop_swallows(path, cm)
            findings += _apply_pragmas(raw, src)
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings

    # REP101 ----------------------------------------------------------------

    def _check_durations(self, path: str, tree: ast.Module) -> list[LintFinding]:
        out = []
        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub) \
                    and (_is_wallclock_call(node.left)
                         or _is_wallclock_call(node.right)):
                out.append(LintFinding(
                    "REP101",
                    "time.time() in a duration computation — use "
                    "time.monotonic()/time.perf_counter() (wall clocks step "
                    "under NTP)",
                    path, node.lineno))
        return out

    # REP102 ----------------------------------------------------------------

    def _guard_contexts(self, cm: ClassModel) -> dict[str, list[tuple[str, int, bool, bool]]]:
        """Per method: [(mutated attr, line, under_lock, direct)]; also
        records self-method call sites as ("()name", line, under_lock,
        False)."""
        out: dict[str, list[tuple[str, int, bool, bool]]] = {}

        def walk(node: ast.AST, depth: int, sink: list) -> None:
            for child in ast.iter_child_nodes(node):
                d = depth
                if isinstance(child, ast.With):
                    if any(_is_lockish_item(i.context_expr)
                           for i in child.items):
                        d = depth + 1
                if isinstance(child, ast.stmt):
                    got = _mutated_self_attr(child)
                    if got is not None:
                        sink.append((got[0], got[1], d > 0, got[2]))
                if isinstance(child, ast.Call):
                    chain = _attr_chain(child.func)
                    if chain and chain[0] == "self" and len(chain) == 2:
                        sink.append(("()" + chain[1], child.lineno, d > 0,
                                     False))
                walk(child, d, sink)

        for name, fn in cm.methods.items():
            sink: list[tuple[str, int, bool, bool]] = []
            walk(fn, 0, sink)
            out[name] = sink
        return out

    def _check_guarded_mutations(self, path: str,
                                 cm: ClassModel) -> list[LintFinding]:
        if not cm.lock_attrs:
            return []
        ctx = self._guard_contexts(cm)
        # private helpers whose every in-class call site is under a lock (or
        # inside another such helper) inherit the caller's lock — fixpoint
        protected: set[str] = {
            n for n in cm.methods
            if n.endswith("_locked") or n == "__init__"
        }
        call_sites: dict[str, list[tuple[str, bool]]] = {n: [] for n in cm.methods}
        for caller, events in ctx.items():
            for attr, _line, locked, _direct in events:
                if attr.startswith("()") and attr[2:] in call_sites:
                    call_sites[attr[2:]].append((caller, locked))
        changed = True
        while changed:
            changed = False
            for name in cm.methods:
                if name in protected or not name.startswith("_") \
                        or name.startswith("__"):
                    continue
                sites = call_sites[name]
                if sites and all(locked or caller in protected
                                 for caller, locked in sites):
                    protected.add(name)
                    changed = True

        # pass 1: which attrs are ever DIRECTLY mutated under a lock?
        # (__init__ is exempt from flagging AND from defining guardedness —
        # construction races with nobody; mutator method calls never define
        # guardedness either, see _mutated_self_attr)
        guarded: set[str] = set()
        for method, events in ctx.items():
            if method == "__init__":
                continue
            for attr, _line, locked, direct in events:
                if not attr.startswith("()") and direct \
                        and (locked or method in protected):
                    guarded.add(attr)
        # pass 2: flag unguarded mutations of those attrs
        out = []
        for method, events in ctx.items():
            if method == "__init__" or method in protected:
                continue
            for attr, line, locked, _direct in events:
                if attr.startswith("()") or locked or attr not in guarded:
                    continue
                out.append(LintFinding(
                    "REP102",
                    f"{cm.name}.{method} mutates self.{attr} outside "
                    f"`with <lock>` but the attribute is lock-guarded "
                    f"elsewhere in the class",
                    path, line))
        return out

    # REP103 ----------------------------------------------------------------

    def _check_lock_order(self, path: str, cm: ClassModel) -> list[LintFinding]:
        out = []

        def walk(node: ast.AST, held: tuple[int, ...]) -> None:
            for child in ast.iter_child_nodes(node):
                h = held
                if isinstance(child, ast.With):
                    for item in child.items:
                        chain = _is_lockish_item(item.context_expr)
                        if not chain:
                            continue
                        r = self._item_rank(cm, chain)
                        if r is None:
                            continue
                        if held and r < max(held):
                            out.append(LintFinding(
                                "REP103",
                                f"acquires rank-{r} lock "
                                f"({'.'.join(chain)}) while holding a "
                                f"rank-{max(held)} lock — documented order "
                                f"is store → fleet",
                                path, child.lineno))
                        h = h + (r,)
                elif isinstance(child, ast.Call) and held:
                    acquired = self._call_acquires(cm, child)
                    bad = {r for r in acquired if r < max(held)}
                    if bad:
                        chain = _attr_chain(child.func) or ["<call>"]
                        out.append(LintFinding(
                            "REP103",
                            f"call {'.'.join(chain)}() acquires a "
                            f"rank-{min(bad)} lock while a rank-"
                            f"{max(held)} lock is held — documented order "
                            f"is store → fleet",
                            path, child.lineno))
                walk(child, h)

        for fn in cm.methods.values():
            walk(fn, ())
        return out

    # REP105 ----------------------------------------------------------------

    def _check_runloop_swallows(self, path: str,
                                cm: ClassModel) -> list[LintFinding]:
        """Broad excepts in thread run-loops that swallow without counting.

        Run-loop roots are methods handed to ``threading.Thread(target=
        self.X)`` (plus ``run``/``_run`` in any Thread-constructing class).
        A broad handler is flagged when it sits lexically inside a loop of
        a root, or anywhere in a method the loop body calls (transitively,
        within the class) — those handlers run every iteration — unless its
        body re-raises or increments a counter/error list."""
        roots: set[str] = set()
        constructs_thread = False
        for fn in cm.methods.values():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func)
                if chain not in (["threading", "Thread"], ["Thread"]):
                    continue
                constructs_thread = True
                for kw in node.keywords:
                    if kw.arg == "target":
                        tchain = _attr_chain(kw.value)
                        if tchain and tchain[0] == "self" and len(tchain) == 2:
                            roots.add(tchain[1])
        if constructs_thread:
            roots |= {n for n in ("run", "_run") if n in cm.methods}
        roots &= cm.methods.keys()
        if not roots:
            return []

        def self_calls(node: ast.AST) -> set[str]:
            got = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    chain = _attr_chain(sub.func)
                    if chain and chain[0] == "self" and len(chain) == 2:
                        got.add(chain[1])
            return got

        # methods whose handlers effectively run once per loop iteration
        frontier: set[str] = set()
        for r in roots:
            for node in ast.walk(cm.methods[r]):
                if isinstance(node, (ast.While, ast.For)):
                    frontier |= self_calls(node)
        loop_reachable: set[str] = set()
        while frontier:
            name = frontier.pop()
            if name in loop_reachable or name not in cm.methods \
                    or name in roots:
                continue
            loop_reachable.add(name)
            frontier |= self_calls(cm.methods[name])

        def broad(handler: ast.ExceptHandler) -> bool:
            if handler.type is None:
                return True
            elts = (handler.type.elts
                    if isinstance(handler.type, ast.Tuple) else [handler.type])
            for e in elts:
                chain = _attr_chain(e)
                if chain and chain[-1] in ("Exception", "BaseException"):
                    return True
            return False

        def accounted(handler: ast.ExceptHandler) -> bool:
            for node in ast.walk(handler):
                if isinstance(node, (ast.Raise, ast.AugAssign)):
                    return True
                if isinstance(node, ast.Call):
                    chain = _attr_chain(node.func)
                    if chain and chain[-1] in _COUNTERISH:
                        return True
            return False

        suspect_handlers: list[ast.ExceptHandler] = []
        for r in roots:
            for node in ast.walk(cm.methods[r]):
                if isinstance(node, (ast.While, ast.For)):
                    suspect_handlers += [
                        h for h in ast.walk(node)
                        if isinstance(h, ast.ExceptHandler)]
        for name in loop_reachable:
            suspect_handlers += [
                h for h in ast.walk(cm.methods[name])
                if isinstance(h, ast.ExceptHandler)]
        out, seen = [], set()
        for h in suspect_handlers:
            if h.lineno in seen or not broad(h) or accounted(h):
                continue
            seen.add(h.lineno)
            out.append(LintFinding(
                "REP105",
                f"{cm.name}: broad except in a thread run-loop swallows "
                f"errors without incrementing a counter or re-raising — a "
                f"silently failing daemon looks healthy while doing nothing",
                path, h.lineno))
        return out

    # REP104 ----------------------------------------------------------------

    def _check_threads(self, path: str, tree: ast.Module) -> list[LintFinding]:
        out = []
        # class bodies whose methods include a stop/shutdown handler
        owners: list[tuple[ast.ClassDef, bool]] = [
            (n, bool(_THREAD_OWNER_METHODS
                     & {m.name for m in n.body
                        if isinstance(m, ast.FunctionDef)}))
            for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
        ]

        def enclosing_has_stop(lineno: int) -> bool:
            for cls, has in owners:
                if cls.lineno <= lineno <= (cls.end_lineno or cls.lineno):
                    return has
            return False

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain not in (["threading", "Thread"], ["Thread"]):
                continue
            daemon = any(
                kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in node.keywords)
            if not daemon and not enclosing_has_stop(node.lineno):
                out.append(LintFinding(
                    "REP104",
                    "threading.Thread without daemon=True and no "
                    "stop/shutdown handler on the owning class — the thread "
                    "can outlive (and hang) interpreter exit",
                    path, node.lineno))
        return out


def _apply_pragmas(findings: Iterable[LintFinding],
                   src: str) -> list[LintFinding]:
    lines = src.splitlines()

    def allowed(f: LintFinding) -> bool:
        for ln in (f.line, f.line - 1):
            if 1 <= ln <= len(lines):
                m = _PRAGMA_RE.search(lines[ln - 1])
                if m and f.code in m.group(1).split(","):
                    return True
        return False

    return [f for f in findings if not allowed(f)]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_sources(sources: Mapping[str, str]) -> list[LintFinding]:
    """Lint a {path: source} mapping as one program (cross-module class
    resolution included)."""
    linter = Linter()
    for path, src in sources.items():
        linter.add_source(src, path)
    return linter.run()


def lint_source(src: str, path: str = "<src>") -> list[LintFinding]:
    """Lint one source snippet — the test-fixture entry point."""
    return lint_sources({path: src})


def _iter_py_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py"):
            yield p


def lint_paths(paths: Iterable[str]) -> list[LintFinding]:
    """Lint every ``.py`` file under ``paths`` (files or directories)."""
    sources: dict[str, str] = {}
    for fp in _iter_py_files(paths):
        with open(fp, "r", encoding="utf-8") as fh:
            sources[fp] = fh.read()
    return lint_sources(sources)
