"""Layer 2: AST lint over ``src/repro_torch``; port of
``repro/staticcheck/ast_lint.py`` (rules R1, R3 and R4).

The rules encode contracts that otherwise live only in docstrings:

* **R1** ``bvh-loop-outside-engine`` — no Python ``while``/``for`` loop
  whose body subscripts a BVH node array (``rope`` / ``left_child`` /
  ``right_child`` / ``node_lo`` / ``node_hi``) outside the traversal's
  homes: ``core/query.py``, ``core/traversal.py``, ``core/bvh.py`` (the
  builds and ``node_depths``), ``kernels/wavefront.py`` and
  ``kernels/nearest.py``. The reference's walks are ``while_loop``s; the
  port's are Python loops over lanes, so the loop statement is what is
  checked. Every traversal goes through the engine and its kernels, so
  engine-level improvements reach every client. A subscript is what
  counts: ``models/attention.py`` calls ``L.rope(q, ...)``, rotary
  embeddings, which walks no tree; union-find fixpoints index no BVH
  array and stay legal.
* **R3** ``unchecked-csr-overflow`` — every ``DeviceCsr`` /
  ``BufferedCsr`` producer call-site must consume ``.overflowed`` (or
  return the result to its caller, which moves the obligation there), or
  opt out with ``# staticcheck: overflow-ok``. Fixed-capacity protocols
  that silently drop hits are how wrong answers happen.
* **R4** ``unguarded-minimage-fold`` — no ``round(x / period) * period``
  minimum-image fold (``torch.round(d / L)`` or ``(d / L).round()``)
  without an ``abs(...) > 2 * period`` guard (or ``# staticcheck:
  minimage-ok``): in float32 with BIG padding, ``round(BIG/L)*L == BIG``
  aliases padded rows to distance zero.

The reference's R2 (``jax.jit`` around a ``shard_map`` program) guards an
XLA:CPU deadlock; the port has neither construct, and has no R2.

Pragmas: ``# staticcheck: <token>`` on the flagged line (or the line
directly above, or any line of a flagged loop) suppresses the matching
rule; ``# staticcheck: ignore`` suppresses any rule there.
"""
from __future__ import annotations

import ast
import pathlib
import re

from repro_torch.staticcheck.findings import Finding

__all__ = [
    "BVH_NODE_FIELDS",
    "CSR_PRODUCERS",
    "ENGINE_FILES",
    "RULES",
    "lint_source",
    "lint_paths",
]

# The traversal-structure arrays: a hand-rolled walk must read the node
# links (rope/children) or the node boxes to descend. ``leaf_perm`` is
# deliberately NOT here: clients legally reindex results through it
# without traversing anything.
BVH_NODE_FIELDS = frozenset({
    "rope", "left_child", "right_child", "node_lo", "node_hi",
})

CSR_PRODUCERS = frozenset({
    "query_csr", "query_csr_device", "query_csr_buffered",
    "sharded_query_csr", "sharded_neighbor_csr", "raycast_all",
})

# R1: the homes of BVH loops (matched as posix-path suffixes): the
# engine, its shims, the builds, and the kernel modules whose plain
# versions walk the tree. Any other module hand-rolling a walk fires.
ENGINE_FILES = ("core/query.py", "core/traversal.py", "core/bvh.py",
                "kernels/wavefront.py", "kernels/nearest.py")

_PRAGMA_RE = re.compile(r"#\s*staticcheck:\s*([\w,\s-]+)")


def _pragma_lines(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            out[i] = {tok.strip() for tok in m.group(1).replace(",", " ").split()
                      if tok.strip()}
    return out


def _suppressed(pragmas: dict[int, set[str]], node: ast.AST, token: str) -> bool:
    lines = range(node.lineno - 1, getattr(node, "end_lineno", node.lineno) + 1)
    for ln in lines:
        toks = pragmas.get(ln, ())
        if token in toks or "ignore" in toks:
            return True
    return False


def _call_name(call: ast.Call) -> str:
    """The called name's last part: ``round`` for ``torch.round(...)``
    and for ``(d / L).round()``."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return ""


def _parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    par: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            par[child] = node
    return par


def _enclosing_functions(node: ast.AST, parents) -> list[ast.AST]:
    """FunctionDefs containing ``node``, innermost first."""
    out = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(cur)
        cur = parents.get(cur)
    return out


def _matches(path: str, suffixes: tuple[str, ...]) -> bool:
    p = pathlib.PurePath(path).as_posix()
    return any(p.endswith(s) for s in suffixes)


# --- R1: BVH traversal loops outside the engine -----------------------------

def _resolve_local_fn(name: str, scopes: list[ast.AST]) -> ast.AST | None:
    """Find a def/lambda bound to ``name`` in the given scopes (innermost
    first; each scope searched with its nested defs)."""
    for scope in scopes:
        for node in ast.walk(scope):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name:
                return node
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Lambda):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == name:
                        return node.value
    return None


def _indexes_bvh_fields(nodes, scopes: list[ast.AST],
                        _seen: set | None = None) -> bool:
    """Do these statements subscript a BVH node array (``x.rope[...]``),
    directly or through a locally-defined helper they call?"""
    seen = _seen if _seen is not None else set()
    for root in nodes:
        if id(root) in seen:
            continue
        seen.add(id(root))
        for node in ast.walk(root):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr in BVH_NODE_FIELDS:
                return True
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                callee = _resolve_local_fn(node.func.id, scopes)
                if callee is not None and _indexes_bvh_fields(
                        [callee], scopes, seen):
                    return True
    return False


def _rule_r1(tree, source, path, pragmas, parents) -> list[Finding]:
    if _matches(path, ENGINE_FILES):
        return []
    findings = []
    flagged: set[int] = set()
    for node in ast.walk(tree):   # outer loops before the loops they hold
        if not isinstance(node, (ast.While, ast.For, ast.AsyncFor)):
            continue
        if _suppressed(pragmas, node, "bvh-loop-ok"):
            continue
        cur = parents.get(node)
        while cur is not None and id(cur) not in flagged:
            cur = parents.get(cur)
        if cur is not None:       # inside a loop already flagged
            continue
        scopes = _enclosing_functions(node, parents) + [tree]
        parts = ([node.test] if isinstance(node, ast.While) else []) + node.body
        if _indexes_bvh_fields(parts, scopes):
            flagged.add(id(node))
            findings.append(Finding(
                rule="R1-bvh-loop-outside-engine", path=path, line=node.lineno,
                message=("hand-rolled BVH traversal loop (subscripts BVH "
                         "node arrays) outside the engine's homes — use "
                         "the query engine (core/query.py)")))
    return findings


# --- R3: CSR overflow must be consumed --------------------------------------

def _rule_r3(tree, source, path, pragmas, parents) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _call_name(node) in CSR_PRODUCERS):
            continue
        if _suppressed(pragmas, node, "overflow-ok"):
            continue
        parent = parents.get(node)
        # return producer(...) / lambda *: producer(...)  -> the obligation
        # moves to the caller
        if isinstance(parent, ast.Return) or (
                isinstance(parent, ast.Lambda) and parent.body is node):
            continue
        # producer(...).overflowed  -> consumed on the spot
        if isinstance(parent, ast.Attribute) and parent.attr == "overflowed":
            continue
        consumed = False
        if isinstance(parent, (ast.Assign, ast.AnnAssign)):
            targets = parent.targets if isinstance(parent, ast.Assign) \
                else [parent.target]
            names = {t.id for t in targets if isinstance(t, ast.Name)}
            scopes = _enclosing_functions(node, parents) or [tree]
            for sub in ast.walk(scopes[0]):
                if isinstance(sub, ast.Attribute) and sub.attr == "overflowed" \
                        and isinstance(sub.value, ast.Name) \
                        and sub.value.id in names:
                    consumed = True
                    break
        if not consumed:
            findings.append(Finding(
                rule="R3-unchecked-csr-overflow", path=path, line=node.lineno,
                message=(f"{_call_name(node)}(...) result never consumes "
                         f".overflowed — check it or annotate "
                         f"'# staticcheck: overflow-ok'")))
    return findings


# --- R4: guarded minimum-image folds ----------------------------------------

_ROUND_FNS = frozenset({"round", "rint"})
_ABS_FNS = frozenset({"abs", "absolute", "fabs"})


def _is_two(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value in (2, 2.0)


def _has_minimage_guard(scope: ast.AST) -> bool:
    """An ``abs(...) <cmp> 2 * period``-shaped comparison anywhere in scope."""
    for node in ast.walk(scope):
        if not isinstance(node, ast.Compare):
            continue
        has_abs = any(isinstance(sub, ast.Call) and _call_name(sub) in _ABS_FNS
                      for sub in ast.walk(node))
        has_2x = any(
            isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mult)
            and (_is_two(sub.left) or _is_two(sub.right))
            for sub in ast.walk(node))
        if has_abs and has_2x:
            return True
    return False


def _rounded_quotient(call: ast.Call) -> ast.BinOp | None:
    """The ``x / period`` of ``round(x / period)`` or ``(x / period).round()``."""
    if _call_name(call) not in _ROUND_FNS:
        return None
    if len(call.args) == 1 and isinstance(call.args[0], ast.BinOp) \
            and isinstance(call.args[0].op, ast.Div):
        return call.args[0]
    if not call.args and isinstance(call.func, ast.Attribute) \
            and isinstance(call.func.value, ast.BinOp) \
            and isinstance(call.func.value.op, ast.Div):
        return call.func.value
    return None


def _rule_r4(tree, source, path, pragmas, parents) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        quotient = _rounded_quotient(node)
        if quotient is None or _suppressed(pragmas, node, "minimage-ok"):
            continue
        period = ast.dump(quotient.right)
        scopes = _enclosing_functions(node, parents)
        scope = scopes[0] if scopes else tree
        # It is a min-image fold only if the rounded quotient is folded
        # back by the SAME period (a `* period` in the same scope).
        folds_back = any(
            isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mult)
            and (ast.dump(sub.left) == period or ast.dump(sub.right) == period)
            for sub in ast.walk(scope))
        if folds_back and not _has_minimage_guard(scope):
            findings.append(Finding(
                rule="R4-unguarded-minimage-fold", path=path, line=node.lineno,
                message=("round(x / period) * period min-image fold without "
                         "an abs(diff) > 2 * period guard — f32 padding "
                         "aliases to distance 0")))
    return findings


RULES = {
    "R1": _rule_r1,
    "R3": _rule_r3,
    "R4": _rule_r4,
}


def lint_source(source: str, path: str = "<string>", *,
                rules=None) -> list[Finding]:
    """Lint one source string. ``rules``: iterable of rule keys ("R1"…)
    to run, default all."""
    tree = ast.parse(source, filename=path)
    pragmas = _pragma_lines(source)
    parents = _parents(tree)
    findings: list[Finding] = []
    for key in (rules or sorted(RULES)):
        findings.extend(RULES[key](tree, source, path, pragmas, parents))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_paths(paths, *, rules=None) -> tuple[list[Finding], int]:
    """Lint every ``.py`` file under the given files/directories. Returns
    (findings, number_of_files_checked)."""
    files: list[pathlib.Path] = []
    for p in map(pathlib.Path, paths):
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    findings: list[Finding] = []
    for f in files:
        findings.extend(lint_source(f.read_text(), str(f), rules=rules))
    return findings, len(files)
