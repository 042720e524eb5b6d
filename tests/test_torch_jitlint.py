"""Pass 3 of the port (``raft_tla_tpu_torch/analysis/jitlint.py``, host
syncs): each torch rule fires on a planted snippet and static tests are
never flagged; the two rules it shares with the reference's tracer lint
(``set-iteration``, ``narrow-astype`` on ``.astype``) give the reference's
findings on the same source; the walk covers every module of the port;
the known hidden syncs (``device_engine._chunk``, the host engine's search
loop) are seen once their waivers are stripped, and are waived with a
reason; the tree is clean.  Tolerance: exact equality of finding codes,
lines and (for the shared rules) every field.
"""

import dataclasses
import os
import re
from pathlib import Path

import pytest

from raft_tla_tpu.analysis import jitlint as jjitlint

from raft_tla_tpu_torch.analysis import jitlint

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "raft_tla_tpu_torch"
WAIVER_RE = re.compile(r"\s*#[^#\n]*lint: jit-ok.*$", re.M)

CASES = {
    "tensor-python-if": (
        "import torch\n"
        "def k(s, i):\n"
        "    if s[i] == 1:\n"
        "        return torch.ones(())\n"
        "    while s.any():\n"
        "        s = s - 1\n"
        "    assert s.sum() >= 0\n", [3, 5, 7]),
    "tensor-scalar-cast": (
        "import torch\n"
        "def k(s, i):\n"
        "    n = int(s[i]) + float(s.max())\n"
        "    return torch.zeros(3).sum().item() + n\n", [3, 3, 4]),
    "host-sync": (
        "import torch\n"
        "def chunk(x):\n"
        "    return x.cpu()\n"
        "def run(xs, dev):\n"
        "    for x in xs:\n"
        "        chunk(x)\n"
        "        y = torch.tensor(0, device=dev) + torch.tensor(1)\n"
        "        z = [v.tolist() for v in x] + [torch.tensor(\n"
        "            2, device='cpu')]\n"
        "    return xs[0].numpy()\n", [3, 7, 8]),
    "narrow-astype": (
        "import torch\n"
        "def k(s):\n"
        "    a = s.to(torch.int8)\n"
        "    b = s.to(dtype=torch.bfloat16)\n"
        "    c = s.to(torch.uint8)  # 1-bit flags\n"
        "    return s.to(torch.int32)\n", [3, 4]),
}


def _strip_waivers(src):
    return WAIVER_RE.sub("", src)


@pytest.mark.parametrize("code", list(CASES))
def test_torch_rules_fire(code):
    src, lines = CASES[code]
    fs = jitlint.lint_source(src, "case.py")
    assert [f.code for f in fs] == [code] * len(lines)
    assert sorted(f.line for f in fs) == lines
    assert all(f.severity == "warning" for f in fs)


def test_static_tests_and_host_code_not_flagged():
    clean = (
        "import torch\n"
        "def k(s, i, fields):\n"
        "    if s['x'].shape[0] > 2:\n"
        "        pass\n"
        "    if 'role' in fields or s is None:\n"
        "        pass\n"
        "    while len(s['x']) == 3 and s.dtype == torch.int32:\n"
        "        break\n"
        "    assert s.numel() >= 0 and s.device.type == 'cpu'\n"
        "    return int(s['x'].shape[-1])\n"
        "def host(a):\n"
        "    if a[0]:\n"
        "        return int(a[1])\n")
    assert jitlint.lint_source(clean, "clean.py") == []
    no_torch = ("def f(xs):\n"
                "    for x in xs:\n"
                "        x.tolist()\n")
    assert jitlint.lint_source(no_torch, "host.py") == []
    waived = CASES["host-sync"][0].replace(
        "return x.cpu()", "return x.cpu()  # lint: jit-ok planted")
    assert 3 not in [f.line for f in jitlint.lint_source(waived, "w.py")]


SHARED = (
    "import numpy as np\n"
    "import jax.numpy as jnp\n"
    "def f(x):\n"
    "    for k in {1, 2}:\n"
    "        pass\n"
    "    for k in set(x):\n"
    "        pass\n"
    "    a = x.astype(np.int16)\n"
    "    b = x.astype('uint8') + x.astype(jnp.bfloat16)\n"
    "    c = x.astype(np.int8)  # 8-bit: values < 100\n"
    "    d = x.astype(np.bool_)  # lint: jit-ok planted\n"
    "    return x.astype(np.int32)\n")


def test_shared_rules_match_reference():
    """On the same sources, ``set-iteration`` and ``.astype`` narrowing
    give the reference's findings field for field: a planted snippet, and
    every module of the port with all its comments (waivers and width
    notes) stripped (the ``.to`` form is the port's own and is left
    out)."""
    def shared(lint, src, path):
        return [dataclasses.astuple(f) for f in lint.lint_source(src, path)
                if f.code == "set-iteration" or
                (f.code == "narrow-astype" and ".astype(" in f.message)]

    mine = shared(jitlint, SHARED, "s.py")
    assert mine == shared(jjitlint, SHARED, "s.py")
    assert [f[2] for f in mine] == ["set-iteration"] * 2 + \
        ["narrow-astype"] * 3
    found = 0
    for path in jitlint.covered_files():
        bare = re.sub(r"\s*#.*$", "", Path(path).read_text(), flags=re.M)
        mine = shared(jitlint, bare, path)
        assert mine == shared(jjitlint, bare, path), path
        found += len(mine)
    assert found >= 1        # ops/symmetry.py's int16 rank maps, bare


def test_walk_covers_every_module():
    """The scan set is a package walk: an independent os.walk finds
    nothing it misses."""
    covered = set(jitlint.covered_files())
    expected = set()
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        expected |= {os.path.join(dirpath, f) for f in filenames
                     if f.endswith(".py")}
    assert len(expected) > 70 and covered == expected


def _fn_lines(src, name):
    import ast
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return range(node.lineno, node.end_lineno + 1)
    raise AssertionError(name)


def test_device_engine_chunk_syncs_are_seen_and_waived():
    """The four blocking host-to-device copies of ``_chunk`` (called from
    ``_run``'s chunk loop) are host-sync findings once their waivers are
    stripped, and each carries the ROADMAP waiver; the one-time result
    assembly of ``_extract_trace`` is not flagged."""
    src = (PKG / "device_engine.py").read_text()
    lines = src.splitlines()
    chunk = _fn_lines(src, "_chunk")
    copies = [n for n in chunk if "torch.tensor(" in lines[n - 1]]
    assert len(copies) == 4
    fs = jitlint.lint_source(_strip_waivers(src), "device_engine.py")
    seen = sorted(f.line for f in fs if f.line in chunk)
    assert seen == copies and all(f.code == "host-sync" for f in fs
                                  if f.line in chunk)
    assert all("which the loop at line" in f.message for f in fs
               if f.line in chunk)
    for n in copies:
        assert lines[n - 1].endswith(
            "# lint: jit-ok hidden sync, ROADMAP queue B (d) 1")
    trace = _fn_lines(src, "_extract_trace")
    assert not [f for f in fs if f.line in trace]
    assert not [f for f in jitlint.lint_source(src, "device_engine.py")
                if f.line in chunk]


def test_host_engine_loop_is_seen():
    """The host engine's search loop: 13 copies to the host (``.cpu()``,
    ``.numpy()``, ``.tolist()``) inside the loop body, all waived."""
    src = (PKG / "engine.py").read_text()
    fs = jitlint.lint_source(_strip_waivers(src), "engine.py")
    loop = _fn_lines(src, "check")
    assert len([f for f in fs if f.line in loop
                and f.code == "host-sync"
                and "inside a loop body" in f.message]) == 13
    assert jitlint.lint_source(src, "engine.py") == []


def test_tree_is_clean_and_every_waiver_has_a_reason():
    assert jitlint.lint_paths() == []
    for path in jitlint.covered_files():
        for n, line in enumerate(Path(path).read_text().splitlines(), 1):
            if "# " in line and "lint: jit-ok" in line.split("#", 1)[1]:
                reason = line.split("lint: jit-ok", 1)[1].strip()
                assert reason, f"{path}:{n}: a jit-ok waiver without reason"
