"""Pass 3 — host-sync AST lint over the port's sources.

The port's counterpart of ``raft_tla_tpu/analysis/jitlint.py``.  There
the hazard is a JAX tracer: Python control flow on a traced value either
fails under ``jit`` or burns one call's value into the program.  Here
nothing is traced.  A torch op on the card is queued on a stream and
returns at once, and the hazard is a *host sync*: Python that needs a
tensor's value on the host waits until the card has drained the stream
up to that op (an implicit ``cudaStreamSynchronize``), and the card then
idles while the host issues the next ops.  One such sync per chunk of a
search loop can set the wall.  The rules:

- ``tensor-python-if`` — a Python ``if``, ``while`` or ``assert`` whose
  test reads a tensor's elements (``x[i]``, ``x.any()``, ``x.sum()``,
  ...) inside a function whose body uses ``torch``;
- ``tensor-scalar-cast`` — ``int()``/``float()``/``bool()`` of such a
  read, and every ``.item()``, inside such a function;
- ``host-sync`` — ``.cpu()``, ``.tolist()``, ``.numpy()`` and
  ``torch.tensor(..., device=<not cpu>)`` (a blocking host-to-device
  copy) inside a loop body, or anywhere in a function that a loop of the
  same module calls by name (``f(...)`` to the module's function or the
  caller's nested ``def``, ``self.m(...)`` to the class's method, as
  Pass 4 resolves them), in a module that uses ``torch``;
- ``set-iteration`` — iterating a set literal / ``set(...)`` call: set
  order is salted per process, so anything assembled from it differs run
  to run (as in the reference);
- ``narrow-astype`` — ``.astype`` to a sub-32-bit dtype (as in the
  reference) or ``.to(torch.int8|int16|uint8|uint16|bool|float16|
  bfloat16)`` with no width justification in a comment on the same line
  (a ``bit`` or ``width`` word): silent truncation is the bug class
  Pass 1 proves away for the packed encodings.

Heuristics, not semantics — every rule is waivable with ``# lint:
jit-ok <reason>`` on the offending line, and all Pass 3 findings are
warnings (exit 0 unless ``--strict``).  The module name, the pass name
``jit`` (``--skip jit``) and the waiver keep the reference's spelling, so
Pass 5 audits the waivers unchanged: a waiver whose line no longer
produces a finding is a stale-waiver error.  Tensor-ness is approximated
as the reference approximates traced-ness: a value rooted in a parameter
of a function whose body mentions ``torch``.  Tests of ``.shape``,
``.ndim``, ``.dtype``, ``.device``, ``.numel()``, ``len()``, ``in`` and
``is`` are static and never flagged.
"""

from __future__ import annotations

import ast
import os

from raft_tla_tpu_torch.analysis import report
from raft_tla_tpu_torch.analysis.report import JIT, WARNING, Finding

WAIVER = "lint: jit-ok"

# Default scan set: the whole package (tests/test_torch_jitlint.py
# asserts the walk misses nothing against an independent os.walk).
DEFAULT_TARGETS = ("raft_tla_tpu_torch",)

_NARROW_DTYPES = {"int8", "int16", "uint8", "uint16", "bfloat16", "float16",
                  "bool_"}
_NARROW_TORCH = {"int8", "int16", "uint8", "uint16", "bool", "float16",
                 "bfloat16", "half", "short", "char"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                 "numel", "dim"}
# Methods whose value is read from a tensor's elements.
_ELEMENT_READS = {"any", "all", "sum", "max", "min", "prod", "mean",
                  "item", "argmax", "argmin", "equal", "allclose",
                  "count_nonzero"}
_SYNC_METHODS = {"cpu", "tolist", "numpy"}

_COMPS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _torch_users(tree: ast.Module) -> set:
    """The module and the functions whose text uses the name ``torch``,
    in one walk."""
    users = set()

    def walk(node) -> bool:
        found = isinstance(node, ast.Name) and node.id == "torch"
        for child in ast.iter_child_nodes(node):
            found |= walk(child)
        if found and isinstance(node, (ast.Module, *_FUNCS)):
            users.add(node)
        return found

    walk(tree)
    return users


def _param_names(fn: ast.AST) -> set:
    a = fn.args
    names = {p.arg for p in a.args + a.posonlyargs + a.kwonlyargs}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    # self/cls are never tensors; bounds/cfg/config/device are static.
    return names - {"self", "cls", "bounds", "xp", "cfg", "config",
                    "device"}


def _root_name(node: ast.AST) -> str | None:
    """The Name at the root of an attribute/subscript/call chain."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


def _is_static_test(node: ast.AST) -> bool:
    """Tests that never read a tensor's elements: shape/ndim/dtype/device
    probes, len() of containers, identity and membership tests."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id in ("len", "isinstance", "hasattr",
                                    "callable"):
            return True
        if isinstance(sub, ast.Compare) and any(
                isinstance(op, (ast.In, ast.NotIn, ast.Is, ast.IsNot))
                for op in sub.ops):
            return True
    return False


def _param_element_roots(node: ast.AST, params: set) -> set:
    """Parameter names whose *elements* the expression reads: ``x[i]``
    or an element reduction ``x.any()``/``x.sum()``/... (a bare ``x``
    could be a loop bound)."""
    roots = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Subscript):
            r = _root_name(sub.value)
        elif isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr in _ELEMENT_READS:
            r = _root_name(sub.func.value)
        else:
            continue
        if r in params:
            roots.add(r)
    return roots


def _device_off_cpu(call: ast.Call) -> bool:
    """``torch.tensor(..., device=D)`` with D not the CPU."""
    for kw in call.keywords:
        if kw.arg != "device":
            continue
        d = kw.value
        if isinstance(d, ast.Constant):
            return not (isinstance(d.value, str)
                        and d.value.startswith("cpu")) and d.value is not None
        if isinstance(d, ast.Call) and d.args and \
                isinstance(d.args[0], ast.Constant) and \
                isinstance(d.args[0].value, str) and \
                d.args[0].value.startswith("cpu"):
            return False                   # torch.device("cpu")
        return True
    return False


# -- which functions a loop calls -------------------------------------------


def _loop_children(node: ast.AST):
    """``(child, per_iteration)`` for the child nodes of ``node``."""
    if isinstance(node, (ast.For, ast.AsyncFor)):
        yield node.target, False
        yield node.iter, False
        for s in node.body:
            yield s, True
        for s in node.orelse:
            yield s, False
    elif isinstance(node, ast.While):
        yield node.test, True
        for s in node.body:
            yield s, True
        for s in node.orelse:
            yield s, False
    elif isinstance(node, _COMPS):
        first = True
        for gen in node.generators:
            yield gen.target, True
            yield gen.iter, not first
            for cond in gen.ifs:
                yield cond, True
            first = False
        if isinstance(node, ast.DictComp):
            yield node.key, True
            yield node.value, True
        else:
            yield node.elt, True
    else:
        for child in ast.iter_child_nodes(node):
            yield child, False


class _Scope:
    """Function qualnames of one module, as Pass 4 names them."""

    def __init__(self, tree: ast.Module):
        self.funcs: dict = {}              # qualname -> (node, class name)
        for stmt in tree.body:
            if isinstance(stmt, _FUNCS):
                self._add(stmt, stmt.name, None)
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, _FUNCS):
                        self._add(sub, f"{stmt.name}.{sub.name}", stmt.name)

    def _add(self, fn, qual, cls):
        self.funcs[qual] = (fn, cls)
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNCS):
                self._add(node, f"{qual}.<locals>.{node.name}", cls)
            elif not isinstance(node, (ast.ClassDef, ast.Lambda)):
                stack.extend(ast.iter_child_nodes(node))

    def resolve(self, call: ast.Call, qual: str, cls: str | None):
        f = call.func
        if isinstance(f, ast.Name):
            nested = f"{qual}.<locals>.{f.id}"
            if nested in self.funcs:
                return nested
            if f.id in self.funcs and self.funcs[f.id][1] is None:
                return f.id
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self" and cls is not None:
            m = f"{cls}.{f.attr}"
            if m in self.funcs:
                return m
        return None

    def hot(self) -> dict:
        """``{qualname: line of the loop that calls it}``."""
        out: dict = {}
        for qual, (fn, cls) in self.funcs.items():
            stack = [(s, False) for s in fn.body]
            while stack:
                node, in_loop = stack.pop()
                if isinstance(node, (*_FUNCS, ast.ClassDef, ast.Lambda)):
                    continue
                if in_loop and isinstance(node, ast.Call):
                    callee = self.resolve(node, qual, cls)
                    if callee is not None and callee != qual:
                        out.setdefault(callee, node.lineno)
                for child, per_iter in _loop_children(node):
                    stack.append((child, in_loop or per_iter))
        return out


# -- the visitor ---------------------------------------------------------------


class _FnVisitor(ast.NodeVisitor):
    def __init__(self, path: str, src_lines: list, tree: ast.Module):
        self.path = path
        self.src_lines = src_lines
        self.findings: list = []
        self._fn_stack: list = []
        self._cls_stack: list = []
        self._torch = _torch_users(tree)
        self._torch_module = tree in self._torch
        self._hot = _Scope(tree).hot()

    # -- helpers -------------------------------------------------------------
    def _line(self, lineno: int) -> str:
        return self.src_lines[lineno - 1] if lineno <= len(self.src_lines) \
            else ""

    def _line_comment(self, lineno: int) -> str:
        line = self._line(lineno)
        idx = line.find("#")
        return line[idx:] if idx >= 0 else ""

    def _emit(self, code: str, message: str, node: ast.AST):
        if WAIVER in self._line(node.lineno):
            return
        self.findings.append(Finding(
            JIT, WARNING, code, message, file=self.path, line=node.lineno))

    def _in_torch_fn(self) -> bool:
        return bool(self._fn_stack) and self._fn_stack[-1]["torch"]

    def _params(self) -> set:
        return self._fn_stack[-1]["params"] if self._fn_stack else set()

    # -- functions, classes and loops -----------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef):
        self._cls_stack.append(node.name)
        self.generic_visit(node)
        self._cls_stack.pop()

    def _visit_fn(self, node):
        if self._fn_stack:
            qual = f"{self._fn_stack[-1]['qual']}.<locals>.{node.name}"
        elif self._cls_stack:
            qual = f"{self._cls_stack[-1]}.{node.name}"
        else:
            qual = node.name
        self._fn_stack.append({
            "torch": node in self._torch,
            "params": _param_names(node),
            "qual": qual,
            "hot": self._hot.get(qual),
            "loop": 0,
        })
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _visit_loop(self, node):
        for child, per_iter in _loop_children(node):
            if per_iter and self._fn_stack:
                self._fn_stack[-1]["loop"] += 1
                self.visit(child)
                self._fn_stack[-1]["loop"] -= 1
            else:
                self.visit(child)

    def visit_For(self, node: ast.For):
        it = node.iter
        is_set = isinstance(it, ast.Set) or (
            isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
            and it.func.id in ("set", "frozenset"))
        if is_set:
            self._emit(
                "set-iteration",
                "iteration over a set: order is salted per process, so "
                "any program assembled from it differs run to run — "
                "iterate a sorted() or a tuple", node)
        self._visit_loop(node)

    visit_AsyncFor = _visit_loop

    def visit_While(self, node: ast.While):
        self._check_test(node.test, "while", node)
        self._visit_loop(node)

    visit_ListComp = visit_SetComp = visit_DictComp = visit_GeneratorExp = \
        _visit_loop

    # -- rules ---------------------------------------------------------------
    def _check_test(self, test, kind: str, node):
        if not self._in_torch_fn() or _is_static_test(test):
            return
        roots = _param_element_roots(test, self._params())
        if roots:
            self._emit(
                "tensor-python-if",
                f"Python `{kind}` on a value read from tensor "
                f"{'/'.join(sorted(roots))}: the host waits for the card "
                "to compute it (an implicit cudaStreamSynchronize) — keep "
                "the decision on the device (torch.where) or batch it "
                "into one read", node)

    def visit_If(self, node: ast.If):
        self._check_test(node.test, "if", node)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert):
        self._check_test(node.test, "assert", node)
        self.generic_visit(node)

    def _hot_context(self) -> str | None:
        if not self._fn_stack or not self._torch_module:
            return None
        top = self._fn_stack[-1]
        if top["loop"]:
            return "inside a loop body"
        if top["hot"] is not None:
            return (f"in {top['qual']}, which the loop at line "
                    f"{top['hot']} calls")
        return None

    def visit_Call(self, node: ast.Call):
        f = node.func
        if self._in_torch_fn():
            if isinstance(f, ast.Name) and f.id in ("int", "float", "bool") \
                    and node.args and not _is_static_test(node.args[0]):
                roots = _param_element_roots(node.args[0], self._params())
                if roots:
                    self._emit(
                        "tensor-scalar-cast",
                        f"{f.id}() of a value read from tensor "
                        f"{'/'.join(sorted(roots))}: a host sync — keep "
                        "it a tensor or batch the read", node)
            elif isinstance(f, ast.Attribute) and f.attr == "item" \
                    and not node.args:
                self._emit(
                    "tensor-scalar-cast",
                    ".item() copies one element to the host: a host sync "
                    "— keep it a tensor or batch the read", node)
        where = self._hot_context()
        if where is not None:
            sync = None
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                sync = f".{f.attr}()"
            elif isinstance(f, ast.Attribute) and f.attr == "tensor" and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id == "torch" and _device_off_cpu(node):
                sync = "torch.tensor(..., device=...)"
            if sync is not None:
                self._emit(
                    "host-sync",
                    f"{sync} {where}: a blocking copy between host and "
                    "card on every pass — hoist it out of the loop, keep "
                    "the value on the device, or batch the copies", node)
        self._check_narrow(node)
        self.generic_visit(node)

    def visit_Constant(self, node):
        pass

    def _narrow_comment_ok(self, lineno: int) -> bool:
        comment = self._line_comment(lineno)
        return "bit" in comment or "width" in comment or WAIVER in comment

    def _check_narrow(self, node: ast.Call):
        f = node.func
        if not isinstance(f, ast.Attribute):
            return
        if f.attr == "astype" and node.args:
            arg = node.args[0]
            dtype = None
            if isinstance(arg, ast.Attribute):
                dtype = arg.attr
            elif isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                dtype = arg.value
            if dtype in _NARROW_DTYPES and \
                    not self._narrow_comment_ok(node.lineno):
                self._emit(
                    "narrow-astype",
                    f"narrowing .astype({dtype}) without a width comment: "
                    "state a `# <n>-bit ...` justification (or waive) so "
                    "the truncation is provably safe", node)
        elif f.attr == "to":
            cands = list(node.args) + [kw.value for kw in node.keywords
                                       if kw.arg == "dtype"]
            for arg in cands:
                if isinstance(arg, ast.Attribute) and \
                        isinstance(arg.value, ast.Name) and \
                        arg.value.id == "torch" and \
                        arg.attr in _NARROW_TORCH and \
                        not self._narrow_comment_ok(node.lineno):
                    self._emit(
                        "narrow-astype",
                        f"narrowing .to(torch.{arg.attr}) without a width "
                        "comment: state a `# <n>-bit ...` justification "
                        "(or waive) so the truncation is provably safe",
                        node)


def lint_source(src: str, path: str = "<string>") -> list:
    """Lint one source text; returns findings (all warnings)."""
    try:
        tree = report.parse(src, path)
    except SyntaxError as e:
        return [Finding(JIT, WARNING, "syntax-error",
                        f"could not parse: {e.msg}", file=path,
                        line=e.lineno)]
    v = _FnVisitor(path, src.splitlines(), tree)
    v.visit(tree)
    return v.findings


def _default_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def covered_files(targets=DEFAULT_TARGETS,
                  root: str | None = None) -> list:
    """Absolute paths the targets resolve to — the lint's actual scan
    set, so coverage can be asserted rather than assumed."""
    if root is None:
        root = _default_root()
    files = []
    for target in targets:
        full = os.path.join(root, target)
        if os.path.isfile(full):
            files.append(full)
        elif os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"]
                files += [os.path.join(dirpath, f)
                          for f in sorted(filenames)
                          if f.endswith(".py")]
    return sorted(set(files))


def lint_paths(targets=DEFAULT_TARGETS, root: str | None = None) -> list:
    """Lint every .py under the target files/dirs (relative to the repo
    root, resolved against this package's parent by default)."""
    if root is None:
        root = _default_root()
    findings = []
    for path in covered_files(targets, root):
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        rel = os.path.relpath(path, root)
        findings += lint_source(src, rel)
    return findings
