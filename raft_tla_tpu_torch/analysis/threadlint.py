"""Pass 4 — static race detector over the port's host threading seams.

The port's copy of ``raft_tla_tpu/analysis/threadlint.py``: the same
model, rules, finding codes and ``# lint: thread-ok <reason>`` waiver,
walking ``raft_tla_tpu_torch/``.  The threads it models are the ones
the DDD engine, the campaign and the service run on: the background
flush worker (``utils/flushq.DedupWorker``), the upload prefetcher
(``utils/prefetch.BlockPrefetcher``), the shared dedup pool
(``utils/keyset``: the executor ``submit``/``map`` of the partitioned
master keys), the non-blocking ``EventLog`` writer (``obs/events``),
the chaos stalkers (``campaign/chaos``, ``serve/chaos``), the serve
scheduler's bin-build threads (``serve/sched``), the metrics endpoint's
server and snapshot threads (``obs/openmetrics``), the lock-protected
``PhaseTimers`` (``obs/phases``) and the module-global locks of the
kernel and host-store builds (``ops/build``, ``utils/native``).  Each
model entry point and each lock the pass found is listed on
:class:`Result` (``spawn_sites``, ``global_locks``), so a clean result
can be told from a blind one.

**Model.**  Stdlib-``ast`` only, whole-package, name-based:

- *Entry points*: every ``threading.Thread(target=...)`` and every
  executor ``submit``/``map`` whose first argument is a resolvable
  function.  The worker set is the call-graph closure from those
  targets; the main set is the closure from every other function
  (constructors included — publishing in ``__init__`` is the main
  thread's half of the handshake).
- *Call graph*: bare names resolve within the module (nested ``def``
  first), ``self.m(...)`` within the class, ``Cls.m(...)``/``Cls(...)``
  to that class (a constructor call also reaches ``__enter__``/
  ``__exit__``/``__call__`` — the context-manager protocol), and
  ``obj.m(...)`` to the *unique* scanned class defining ``m`` when there
  is exactly one.  Unresolvable calls get no edge: the pass prefers
  missing an edge to inventing one.
- *Shared names*: a field is analyzed when it belongs to a
  synchronization-bearing owner — a class (or module) that spawns a
  thread, holds a lock/handoff object, or is stored in a field of one —
  and is accessed from both the worker and the main closure.  Fields of
  plain value/handle classes (per-call objects that never cross a
  spawn) are presumed thread-confined; giving a class a lock or a
  thread is what opts it into scrutiny.
- *Local aliases* are tracked one level deep (``timers = self._timers;
  acc = timers._acc; acc[k] = ...`` mutates the timers' field) — the
  exact shape of the off-owner PhaseTimers race.

**The discipline.**  Every mutating access to a shared name must be

(a) guarded — inside a ``with self._lock:``-style context whose lock
    name is a ``Lock``/``RLock``/``Condition`` field of the owner, or
    in a helper every one of whose in-package call sites holds that
    lock (the ``_foo_locked`` convention, checked rather than trusted);
(b) published-before-spawn — a constructor write at or above the
    constructor's first spawn statement (or anywhere in a spawn-free
    constructor);
(c) a handoff — the field holds a queue/Event/Semaphore/executor/
    thread-local built in the constructor and is never rebound; or
(d) waived — ``# lint: thread-ok <reason>`` on the mutating line.  The
    reason is mandatory; pass 5 audits that every waiver still
    suppresses a live finding.

Anything else is an ``unguarded-shared-mutation`` error citing both the
mutation and a conflicting access on the other side of the spawn (or
``post-spawn-publish`` for a constructor write below the spawn).  All
findings are errors: a race the pass cannot rule out is a soundness
hole, the same severity contract as Pass 1's width overflows.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from raft_tla_tpu_torch.analysis import report
from raft_tla_tpu_torch.analysis.report import ERROR, THREAD, Finding

WAIVER = "lint: thread-ok"

# Constructor-call names that make a field a lock (guard-capable).
LOCK_TYPES = frozenset({"Lock", "RLock", "Condition"})

# Constructor-call names that make a field a handoff object: its whole
# purpose is cross-thread use and its own synchronization is internal.
HANDOFF_TYPES = frozenset({
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue", "Event",
    "Semaphore", "BoundedSemaphore", "Barrier", "ThreadPoolExecutor",
    "local", "count",
})

# Method names that mutate their receiver in place.
MUTATORS = frozenset({
    "append", "appendleft", "add", "update", "clear", "extend",
    "remove", "discard", "pop", "popleft", "popitem", "insert",
    "setdefault", "sort", "reverse",
})


# --------------------------------------------------------------------------
# model records


@dataclasses.dataclass
class _Access:
    field: tuple                 # ("attr", cls_key, name) | ("global", mod, name)
    write: bool
    path: str
    line: int
    guards: frozenset            # active lock/with names
    waiver: str | None           # None = not waived; "" = waived, no reason
    func: tuple                  # owning function key
    in_ctor_of: tuple | None     # cls_key when written via self in __init__


@dataclasses.dataclass
class _Func:
    key: tuple                   # (path, qualname)
    name: str                    # bare name (call resolution)
    cls: tuple | None            # (path, ClsName) of enclosing class
    parent: tuple | None         # enclosing function key (nested defs)
    node: ast.AST = None
    accesses: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    spawn_targets: list = dataclasses.field(default_factory=list)
    spawn_lines: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Class:
    key: tuple                   # (path, name)
    name: str
    fields: set = dataclasses.field(default_factory=set)
    locks: set = dataclasses.field(default_factory=set)
    handoffs: set = dataclasses.field(default_factory=set)
    field_types: dict = dataclasses.field(default_factory=dict)
    ctor_spawn_line: int | None = None
    owns_spawn: bool = False


@dataclasses.dataclass
class _Module:
    path: str
    globals_: set = dataclasses.field(default_factory=set)
    global_locks: set = dataclasses.field(default_factory=set)
    global_handoffs: set = dataclasses.field(default_factory=set)
    has_spawn: bool = False


@dataclasses.dataclass
class Result:
    """Findings plus the waiver bookkeeping pass 5 audits."""
    findings: list
    used_waivers: set            # {(path, line)} waivers suppressing a finding
    spawn_sites: list = dataclasses.field(default_factory=list)
    # [(path, line, target function key)] — every modeled entry point
    global_locks: list = dataclasses.field(default_factory=list)
    # [(path, name)] — module-global Lock/RLock/Condition objects


# --------------------------------------------------------------------------
# phase A: skeletons (classes, fields, globals) — needed before any
# access can be attributed


def _call_type_name(node: ast.AST) -> str | None:
    """For ``x = Foo(...)`` / ``x = mod.Foo(...)``, the ``Foo``."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


class _Skeleton:
    def __init__(self):
        self.modules: dict[str, _Module] = {}
        self.classes: dict[tuple, _Class] = {}
        self.funcs: dict[tuple, _Func] = {}
        self.class_names: dict[str, list] = {}     # bare name -> cls keys
        self.field_owners: dict[str, set] = {}     # field name -> cls keys
        self.method_owners: dict[str, set] = {}    # method name -> cls keys

    def collect(self, path: str, tree: ast.Module):
        mod = _Module(path)
        self.modules[path] = mod
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_func(path, stmt, cls=None, parent=None,
                               prefix="")
            elif isinstance(stmt, ast.ClassDef):
                self._add_class(path, stmt)
            elif isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        mod.globals_.add(t.id)
                        tn = _call_type_name(stmt.value)
                        if tn in LOCK_TYPES:
                            mod.global_locks.add(t.id)
                        elif tn in HANDOFF_TYPES:
                            mod.global_handoffs.add(t.id)
            elif isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                mod.globals_.add(stmt.target.id)

    def _add_class(self, path: str, node: ast.ClassDef):
        key = (path, node.name)
        cls = _Class(key, node.name)
        self.classes[key] = cls
        self.class_names.setdefault(node.name, []).append(key)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_func(path, stmt, cls=key, parent=None,
                               prefix=node.name + ".")
                self.method_owners.setdefault(stmt.name, set()).add(key)
                is_ctor = stmt.name == "__init__"
                for sub in ast.walk(stmt):
                    if isinstance(sub, (ast.Assign, ast.AugAssign,
                                        ast.AnnAssign)):
                        targets = sub.targets if isinstance(sub, ast.Assign) \
                            else [sub.target]
                        for t in targets:
                            if isinstance(t, ast.Attribute) and \
                                    isinstance(t.value, ast.Name) and \
                                    t.value.id == "self":
                                cls.fields.add(t.attr)
                                self.field_owners.setdefault(
                                    t.attr, set()).add(key)
                                if is_ctor and isinstance(sub, ast.Assign):
                                    tn = _call_type_name(sub.value)
                                    if tn in LOCK_TYPES:
                                        cls.locks.add(t.attr)
                                    elif tn in HANDOFF_TYPES:
                                        cls.handoffs.add(t.attr)
                                    elif tn:
                                        cls.field_types[t.attr] = tn

    def _add_func(self, path, node, cls, parent, prefix):
        key = (path, prefix + node.name)
        self.funcs[key] = _Func(key, node.name, cls, parent, node)
        # nested defs become first-class functions (the serve/chaos
        # `def run(): ...; Thread(target=run)` shape); their bodies are
        # excluded from the enclosing function's access set
        for sub in node.body:
            self._walk_nested(path, sub, cls, key, prefix + node.name)

    def _walk_nested(self, path, stmt, cls, parent, prefix):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._add_func(path, stmt, cls=cls, parent=parent,
                           prefix=prefix + ".<locals>.")
            return
        if isinstance(stmt, ast.ClassDef):
            return                          # function-local class: opaque
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.stmt):
                self._walk_nested(path, sub, cls, parent, prefix)


# --------------------------------------------------------------------------
# phase B: per-function analysis (accesses, guards, calls, spawns)


class _FuncAnalyzer:
    def __init__(self, sk: _Skeleton, fn: _Func, src_lines: list):
        self.sk = sk
        self.fn = fn
        self.path = fn.key[0]
        self.mod = sk.modules[self.path]
        self.cls = sk.classes.get(fn.cls) if fn.cls else None
        self.src_lines = src_lines
        self.guards: list = []
        self.aliases: dict = {}
        self.locals_: set = set()
        self.global_decls: set = set()
        self._seen: set = set()
        node = fn.node
        args = node.args
        for p in args.args + args.posonlyargs + args.kwonlyargs:
            self.locals_.add(p.arg)
        if args.vararg:
            self.locals_.add(args.vararg.arg)
        if args.kwarg:
            self.locals_.add(args.kwarg.arg)
        self.is_ctor = fn.cls is not None and fn.name == "__init__" and \
            "<locals>" not in fn.key[1]

    def run(self):
        for stmt in self.fn.node.body:
            self._stmt(stmt)

    # -- helpers ------------------------------------------------------------

    def _waiver(self, line: int) -> str | None:
        txt = self.src_lines[line - 1] if line <= len(self.src_lines) else ""
        idx = txt.find(WAIVER)
        if idx < 0:
            return None
        return txt[idx + len(WAIVER):].strip(" -—:#").strip()

    def _record(self, field, write, line, in_ctor=False):
        if field is None:
            return
        dedup = (field, write, line)
        if dedup in self._seen:
            return
        self._seen.add(dedup)
        self.fn.accesses.append(_Access(
            field=field, write=write, path=self.path, line=line,
            guards=frozenset(self.guards), waiver=self._waiver(line),
            func=self.fn.key,
            in_ctor_of=self.fn.cls if (in_ctor and self.is_ctor) else None))

    def _unique_field_owner(self, name: str):
        owners = self.sk.field_owners.get(name, ())
        if len(owners) == 1:
            return next(iter(owners))
        return None

    def _field_of_cls(self, cls_key, name):
        return ("attr", cls_key, name)

    def _resolve_chain(self, base_field: str, attr: str):
        """Owner of ``self.<base_field>.<attr>`` (one level deep)."""
        if self.cls is not None:
            tn = self.cls.field_types.get(base_field)
            if tn and tn in self.sk.class_names and \
                    len(self.sk.class_names[tn]) == 1:
                ck = self.sk.class_names[tn][0]
                return self._field_of_cls(ck, attr)
            if base_field in self.cls.handoffs:
                return None                 # handoff internals: not ours
        owner = self._unique_field_owner(attr)
        if owner is not None:
            return self._field_of_cls(owner, attr)
        return None

    def _resolve_ref(self, node: ast.AST):
        """Field key a reference expression denotes, or None."""
        if isinstance(node, ast.Name):
            a = self.aliases.get(node.id)
            if a and a[0] == "fieldref":
                return a[1]
            if node.id in self.mod.globals_ and \
                    node.id not in self.locals_:
                return ("global", self.path, node.id)
            return None
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name):
                if base.id == "self" and self.cls is not None:
                    if node.attr in self.cls.fields:
                        return self._field_of_cls(self.cls.key, node.attr)
                    owner = self._unique_field_owner(node.attr)
                    if owner is not None:
                        return self._field_of_cls(owner, node.attr)
                    return None
                a = self.aliases.get(base.id)
                if a:
                    if a[0] == "self" and self.cls is not None:
                        return self._field_of_cls(self.cls.key, node.attr)
                    if a[0] == "selfattr":
                        return self._resolve_chain(a[1], node.attr)
                return None
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self":
                return self._resolve_chain(base.attr, node.attr)
        return None

    def _alias_for(self, value: ast.AST):
        if isinstance(value, ast.Name):
            if value.id == "self":
                return ("self",)
            return self.aliases.get(value.id)
        if isinstance(value, ast.Attribute) and \
                isinstance(value.value, ast.Name):
            if value.value.id == "self":
                return ("selfattr", value.attr)
            a = self.aliases.get(value.value.id)
            if a and a[0] == "self":
                return ("selfattr", value.attr)
            if a and a[0] == "selfattr":
                fk = self._resolve_chain(a[1], value.attr)
                if fk is not None:
                    return ("fieldref", fk)
        fk = self._resolve_ref(value)
        if fk is not None:
            return ("fieldref", fk)
        return None

    # -- statements ---------------------------------------------------------

    def _stmt(self, s: ast.stmt):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.locals_.add(s.name)        # analyzed as its own _Func
            return
        if isinstance(s, ast.ClassDef):
            return
        if isinstance(s, ast.Global):
            self.global_decls.update(s.names)
            return
        if isinstance(s, ast.Assign):
            self._expr(s.value)
            alias = self._alias_for(s.value)
            for t in s.targets:
                self._target(t, alias)
            return
        if isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._expr(s.value)
                self._target(s.target, self._alias_for(s.value))
            return
        if isinstance(s, ast.AugAssign):
            self._expr(s.value)
            self._target(s.target, None)
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in s.items:
                ce = item.context_expr
                self._expr(ce)
                g = None
                if isinstance(ce, ast.Attribute):
                    g = ce.attr
                elif isinstance(ce, ast.Name):
                    g = ce.id
                if g is not None:
                    self.guards.append(g)
                    pushed += 1
                if item.optional_vars is not None:
                    self._target(item.optional_vars, None)
            for sub in s.body:
                self._stmt(sub)
            for _ in range(pushed):
                self.guards.pop()
            return
        if isinstance(s, ast.For):
            self._expr(s.iter)
            self._target(s.target, None)
            for sub in s.body + s.orelse:
                self._stmt(sub)
            return
        # everything else: visit child expressions, recurse into child
        # statements (If/While/Try/Return/Expr/Raise/...)
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            elif isinstance(child, ast.expr):
                self._expr(child)
            elif isinstance(child, (ast.excepthandler,)):
                for sub in child.body:
                    self._stmt(sub)

    def _target(self, t: ast.AST, alias):
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._target(el, None)
            return
        if isinstance(t, ast.Starred):
            self._target(t.value, None)
            return
        if isinstance(t, ast.Name):
            if t.id in self.global_decls and t.id in self.mod.globals_:
                self._record(("global", self.path, t.id), True, t.lineno)
                return
            self.locals_.add(t.id)
            if alias is not None:
                self.aliases[t.id] = alias
            else:
                self.aliases.pop(t.id, None)
            return
        if isinstance(t, ast.Attribute):
            base = t.value
            if isinstance(base, ast.Name) and base.id == "self" and \
                    self.cls is not None:
                self._record(self._field_of_cls(self.cls.key, t.attr),
                             True, t.lineno, in_ctor=True)
                return
            fk = self._resolve_ref(t)
            if fk is not None:
                self._record(fk, True, t.lineno)
            return
        if isinstance(t, ast.Subscript):
            fk = self._resolve_ref(t.value)
            if fk is not None:
                self._record(fk, True, t.lineno)
            else:
                self._expr(t.value)
            self._expr(t.slice)
            return

    # -- expressions --------------------------------------------------------

    def _expr(self, e: ast.AST):
        for node in ast.walk(e):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Load):
                fk = self._resolve_ref(node)
                if fk is not None:
                    self._record(fk, False, node.lineno)
            elif isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Load):
                if node.id in self.mod.globals_ and \
                        node.id not in self.locals_ and \
                        node.id not in self.aliases:
                    self._record(("global", self.path, node.id), False,
                                 node.lineno)
            elif isinstance(node, ast.Call):
                self._call(node)

    def _call(self, node: ast.Call):
        f = node.func
        # spawn: threading.Thread(target=...) / Thread(target=...)
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    self._spawn(kw.value, node.lineno)
            return
        # spawn: executor.submit(fn, ...) / executor.map(fn, ...)
        if isinstance(f, ast.Attribute) and f.attr in ("submit", "map") \
                and node.args:
            self._spawn(node.args[0], node.lineno, require_resolved=True)
        # mutator method on a resolvable field reference
        if isinstance(f, ast.Attribute):
            fk = self._resolve_ref(f.value)
            if fk is not None:
                self._record(fk, f.attr in MUTATORS, f.lineno)
        # call edges
        self._edge(node)

    def _spawn(self, target: ast.AST, line: int, require_resolved=False):
        ref = None
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self" and self.fn.cls is not None:
            ref = ("method", self.fn.cls, target.attr)
        elif isinstance(target, ast.Name):
            ref = ("localname", self.fn.key, target.id)
        elif isinstance(target, ast.Attribute) and not require_resolved:
            ref = ("uniquemethod", target.attr)
        if ref is None:
            return
        self.fn.spawn_targets.append(ref)
        self.fn.spawn_lines.append(line)
        self.mod.has_spawn = True
        if self.cls is not None:
            self.cls.owns_spawn = True
            if self.is_ctor:
                sl = self.cls.ctor_spawn_line
                self.cls.ctor_spawn_line = line if sl is None \
                    else min(sl, line)

    def _edge(self, node: ast.Call):
        f = node.func
        g = frozenset(self.guards)
        if isinstance(f, ast.Name):
            if f.id in self.sk.class_names:
                self.fn.calls.append((("class", f.id), g))
            else:
                self.fn.calls.append((("localname", self.fn.key, f.id), g))
            return
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name):
                if base.id == "self" and self.fn.cls is not None:
                    self.fn.calls.append((("method", self.fn.cls, f.attr), g))
                    return
                if base.id in self.sk.class_names:
                    keys = self.sk.class_names[base.id]
                    if len(keys) == 1:
                        self.fn.calls.append(
                            (("clsmethod", keys[0], f.attr), g))
                        return
            self.fn.calls.append((("uniquemethod", f.attr), g))


# --------------------------------------------------------------------------
# phase C: reachability + verdicts


def _resolve_edge(sk: _Skeleton, ref) -> list:
    kind = ref[0]
    if kind == "method":
        _, cls_key, m = ref
        key = (cls_key[0], f"{cls_key[1]}.{m}")
        return [key] if key in sk.funcs else []
    if kind == "clsmethod":
        _, cls_key, m = ref
        key = (cls_key[0], f"{cls_key[1]}.{m}")
        return [key] if key in sk.funcs else []
    if kind == "class":
        _, name = ref
        out = []
        for cls_key in sk.class_names.get(name, ()):
            for m in ("__init__", "__enter__", "__exit__", "__call__"):
                key = (cls_key[0], f"{cls_key[1]}.{m}")
                if key in sk.funcs:
                    out.append(key)
        return out
    if kind == "localname":
        _, fkey, name = ref
        # nested defs of the calling function shadow module-level ones
        nested = (fkey[0], f"{fkey[1]}.<locals>.{name}")
        if nested in sk.funcs:
            return [nested]
        mod_fn = (fkey[0], name)
        if mod_fn in sk.funcs and sk.funcs[mod_fn].cls is None:
            return [mod_fn]
        return []
    if kind == "uniquemethod":
        _, m = ref
        owners = sk.method_owners.get(m, ())
        if len(owners) == 1:
            ck = next(iter(owners))
            key = (ck[0], f"{ck[1]}.{m}")
            return [key] if key in sk.funcs else []
        return []
    return []


def _closure(sk: _Skeleton, roots: set) -> set:
    seen = set(roots)
    todo = list(roots)
    while todo:
        fkey = todo.pop()
        fn = sk.funcs.get(fkey)
        if fn is None:
            continue
        for ref, _g in fn.calls:
            for nxt in _resolve_edge(sk, ref):
                if nxt not in seen:
                    seen.add(nxt)
                    todo.append(nxt)
    return seen


def _candidates(sk: _Skeleton) -> set:
    """Class keys whose fields are subject to analysis: spawn owners,
    lock/handoff holders, plus classes stored in a candidate's fields."""
    cand = {k for k, c in sk.classes.items()
            if c.owns_spawn or c.locks or c.handoffs}
    changed = True
    while changed:
        changed = False
        for k in list(cand):
            for tn in sk.classes[k].field_types.values():
                keys = sk.class_names.get(tn, ())
                for ck in keys:
                    if ck not in cand:
                        cand.add(ck)
                        changed = True
    return cand


def analyze(sources: dict) -> Result:
    """Run the race detector over ``{relpath: source}``."""
    sk = _Skeleton()
    trees, lines = {}, {}
    for path in sorted(sources):
        try:
            tree = report.parse(sources[path], path)
        except SyntaxError:
            continue                        # pass 3 reports parse errors
        trees[path] = tree
        lines[path] = sources[path].splitlines()
        sk.collect(path, tree)
    for fn in sk.funcs.values():
        _FuncAnalyzer(sk, fn, lines[fn.key[0]]).run()

    spawn_roots, spawn_sites = set(), []
    for fn in sk.funcs.values():
        for ref, line in zip(fn.spawn_targets, fn.spawn_lines):
            targets = _resolve_edge(sk, ref)
            spawn_roots.update(targets)
            spawn_sites += [(fn.key[0], line, t) for t in targets]
    worker = _closure(sk, spawn_roots)
    main = _closure(sk, set(sk.funcs) - spawn_roots)

    # guard sets carried by every in-package call edge into a function:
    # an access inside `_foo_locked` counts as guarded when *all* call
    # sites hold the owner's lock (and the function is not itself a
    # thread entry point, which would bypass every call site)
    incoming: dict = {}
    for fn in sk.funcs.values():
        for ref, g in fn.calls:
            for callee in _resolve_edge(sk, ref):
                incoming.setdefault(callee, []).append(g)

    def _inherited_guards(fkey) -> frozenset:
        sites = incoming.get(fkey)
        if not sites or fkey in spawn_roots:
            return frozenset()
        return frozenset.intersection(*sites)

    cand = _candidates(sk)
    by_field: dict = {}
    for fn in sk.funcs.values():
        for acc in fn.accesses:
            by_field.setdefault(acc.field, []).append(acc)

    findings, used = [], set()
    for field in sorted(by_field):
        kind = field[0]
        if kind == "attr":
            _, cls_key, name = field
            cls = sk.classes.get(cls_key)
            if cls is None or cls_key not in cand:
                continue
            if name in cls.locks:
                continue                    # the guards themselves
            is_handoff = name in cls.handoffs
            owner_locks = cls.locks
            label = f"{cls_key[1]}.{name}"
            ctor_spawn = cls.ctor_spawn_line
        else:
            _, mpath, name = field
            mod = sk.modules[mpath]
            if not (mod.has_spawn or mod.global_locks):
                continue
            if name in mod.global_locks:
                continue
            is_handoff = name in mod.global_handoffs
            owner_locks = mod.global_locks
            label = name
            ctor_spawn = None

        accs = by_field[field]
        worker_accs = [a for a in accs if a.func in worker]
        main_accs = [a for a in accs if a.func in main]
        if not worker_accs or not main_accs:
            continue
        for acc in accs:
            if not acc.write:
                continue
            if is_handoff and acc.in_ctor_of is not None:
                continue                    # the constructor build
            pre_spawn_publish = (
                acc.in_ctor_of is not None
                and (ctor_spawn is None or acc.line <= ctor_spawn))
            guarded = bool(
                (set(acc.guards) | _inherited_guards(acc.func))
                & owner_locks)
            if not is_handoff and (pre_spawn_publish or guarded):
                continue
            if acc.waiver is not None:
                used.add((acc.path, acc.line))
                if not acc.waiver:
                    findings.append(Finding(
                        THREAD, ERROR, "waiver-missing-reason",
                        f"`# lint: thread-ok` on shared {label} carries "
                        "no reason — every thread waiver must say why "
                        "the unguarded access is safe",
                        field=label, file=acc.path, line=acc.line))
                continue
            other = next((a for a in worker_accs if a.func != acc.func),
                         None) or next(
                (a for a in main_accs if a.func != acc.func), None) \
                or (worker_accs + main_accs)[0]
            if is_handoff:
                findings.append(Finding(
                    THREAD, ERROR, "handoff-rebound",
                    f"handoff object {label} is rebound outside the "
                    f"constructor while also used at "
                    f"{other.path}:{other.line} — threads holding the "
                    "old object never see the new one; mutate in place "
                    "or guard the swap",
                    field=label, file=acc.path, line=acc.line))
            elif acc.in_ctor_of is not None:
                findings.append(Finding(
                    THREAD, ERROR, "post-spawn-publish",
                    f"{label} is written after the constructor spawns "
                    f"its thread (spawn at line {ctor_spawn}); the "
                    f"worker (via {other.path}:{other.line}) can read "
                    "the pre-write value — publish before the spawn "
                    "or guard both sides",
                    field=label, file=acc.path, line=acc.line))
            else:
                findings.append(Finding(
                    THREAD, ERROR, "unguarded-shared-mutation",
                    f"{label} is mutated without holding a lock while "
                    f"also accessed from another thread entry point "
                    f"(conflicting access {other.path}:{other.line}) — "
                    "guard with the owner's lock, make it a handoff "
                    "object, or waive with `# lint: thread-ok <reason>`",
                    field=label, file=acc.path, line=acc.line))
    global_locks = sorted((m.path, name) for m in sk.modules.values()
                          for name in m.global_locks)
    return Result(findings, used, sorted(spawn_sites), global_locks)


# --------------------------------------------------------------------------
# entry points


def lint_source(src: str, path: str = "<string>") -> list:
    """Lint one self-contained module (tests, planted mutations)."""
    return analyze({path: src}).findings


def package_sources(root: str | None = None) -> dict:
    """``{relpath: source}`` for every module under raft_tla_tpu_torch/."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    pkg = os.path.join(root, "raft_tla_tpu_torch")
    out = {}
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            full = os.path.join(dirpath, f)
            with open(full, "r", encoding="utf-8") as fh:
                out[os.path.relpath(full, root)] = fh.read()
    return out


def lint_paths(root: str | None = None) -> list:
    """The whole package, one model (cross-module reachability)."""
    return analyze(package_sources(root)).findings
