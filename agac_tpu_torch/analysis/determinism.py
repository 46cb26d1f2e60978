"""Determinism audit (program analysis 3 of 4).

The deterministic-replay contract (the sim runtime hashes every
scheduling decision; byte-identical traces across runs and machines)
survives only if nothing nondeterministic leaks into hashed or
user-facing output.  Three whole-program rules:

- ``unordered-iteration`` — iterating a ``set`` (literal, ``set()``
  call, comprehension, or a local bound to one) without ``sorted()``
  inside a replay-hash or exposition function.  Set order varies under
  ``PYTHONHASHSEED``, so a set-driven loop feeding a trace hash or a
  metrics page diverges across processes.  Dict iteration is
  insertion-ordered in Python and is deliberately NOT flagged.
- ``unseeded-random`` — module-global ``random.*`` calls and no-arg
  ``random.Random()`` anywhere in the program (a seeded
  ``random.Random(seed)`` instance is the sanctioned spelling; the sim
  fuzzer threads one through everything).
- ``unseamed-thread`` — ``threading.Thread``/``Timer`` construction in
  a function where neither the function itself nor any direct caller
  consults ``clockseam.threads_enabled()``.  This is the whole-program
  generalization of the per-file ``unseamed-clock`` rule: the gate may
  live one call level up, which a per-file pass cannot see.

Pre-existing ungated spawns (manager loops, health watchdog, leader
election, informers) are grandfathered in ``baseline.json``
with per-entry reasons; the gate fails only on new ones.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from .program import (
    Finding,
    FunctionInfo,
    Program,
    in_package,
    program_rule,
    walk_function,
)

ANALYSIS = "determinism"

# modules where raw thread spawning is the point, not a leak (paths
# below a package root, PACKAGE_ROOTS)
_THREAD_SANCTIONED = (
    "clockseam.py",
    "analysis/",
    "sim/",
    "cluster/testserver.py",
)
_RANDOM_SEEDED_OK = frozenset({"Random", "SystemRandom", "seed"})
_HASH_RECEIVER = re.compile(r"hash|digest", re.IGNORECASE)
_SINK_NAME = re.compile(r"render|exposition|expose|digest|trace", re.IGNORECASE)


def _sanctioned(path: str, sanctioned: tuple[str, ...]) -> bool:
    return in_package(path, sanctioned)


# ---------------------------------------------------------------------------
# unordered set iteration into hash/exposition paths
# ---------------------------------------------------------------------------


def _is_sink(finfo: FunctionInfo) -> bool:
    """A function whose output is replay-hashed or user-facing: it
    feeds a hash object, calls into hashlib, or is a render/exposition
    entry point by name."""
    if _SINK_NAME.search(finfo.name):
        return True
    minfo = finfo.module
    for node in walk_function(finfo.node):
        if not isinstance(node, ast.Call):
            continue
        origin = minfo.imports.resolve_call_target(node.func)
        if origin is not None and (
            origin == "hashlib" or origin.startswith("hashlib.")
        ):
            return True
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr in ("update", "hexdigest", "digest")
        ):
            receiver = func.value
            name = None
            if isinstance(receiver, ast.Name):
                name = receiver.id
            elif isinstance(receiver, ast.Attribute):
                name = receiver.attr
            if name is not None and _HASH_RECEIVER.search(name):
                return True
    return False


def _set_locals(finfo: FunctionInfo) -> set[str]:
    """Local names bound to a set in this function."""
    out: set[str] = set()
    for node in walk_function(finfo.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
            if isinstance(target, ast.Name) and _is_set_expr(value, ()):
                out.add(target.id)
    return out


def _is_set_expr(expr: ast.expr, set_names: tuple[str, ...] | set[str]) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        func = expr.func
        if isinstance(func, ast.Name) and func.id in ("set", "frozenset"):
            return True
        # set operations keep set-ness: s.union(...), s.difference(...)
        if isinstance(func, ast.Attribute) and func.attr in (
            "union", "difference", "intersection", "symmetric_difference",
        ):
            return _is_set_expr(func.value, set_names)
    if isinstance(expr, ast.Name) and expr.id in set_names:
        return True
    if isinstance(expr, ast.BinOp) and isinstance(
        expr.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
    ):
        return _is_set_expr(expr.left, set_names) or _is_set_expr(
            expr.right, set_names
        )
    return False


def _iter_targets(finfo: FunctionInfo):
    """(iterable expression, line) for every iteration point — for
    loops and comprehension generators."""
    for node in walk_function(finfo.node):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            yield node.iter, node.lineno
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            for gen in node.generators:
                yield gen.iter, node.lineno


def check_unordered_iteration(program: Program) -> list[Finding]:
    findings: list[Finding] = []
    for fqn, finfo in program.functions.items():
        if not _is_sink(finfo):
            continue
        set_names = _set_locals(finfo)
        for iterable, line in _iter_targets(finfo):
            # sorted(...) / list(...)+sort anywhere around it is fine
            if isinstance(iterable, ast.Call):
                func = iterable.func
                if isinstance(func, ast.Name) and func.id in ("sorted", "enumerate"):
                    continue
            if _is_set_expr(iterable, set_names):
                desc = (
                    iterable.id
                    if isinstance(iterable, ast.Name)
                    else type(iterable).__name__
                )
                findings.append(
                    Finding(
                        ANALYSIS,
                        "unordered-iteration",
                        str(finfo.module.path),
                        line,
                        f"unordered-iteration::{fqn}::{desc}",
                        f"{fqn} iterates a set ({desc}) inside a replay-hash/"
                        "exposition path — set order varies under "
                        "PYTHONHASHSEED; wrap in sorted()",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# unseeded random
# ---------------------------------------------------------------------------


def check_unseeded_random(program: Program) -> list[Finding]:
    findings: list[Finding] = []
    for fqn, finfo in program.functions.items():
        minfo = finfo.module
        for node in walk_function(finfo.node):
            if not isinstance(node, ast.Call):
                continue
            origin = minfo.imports.resolve_call_target(node.func)
            if origin is None or not (
                origin == "random" or origin.startswith("random.")
            ):
                continue
            leaf = origin.rsplit(".", 1)[-1]
            if leaf in _RANDOM_SEEDED_OK and (node.args or node.keywords):
                continue  # random.Random(seed) — the sanctioned spelling
            if leaf in ("Random", "SystemRandom") and not node.args:
                message = (
                    f"{fqn} constructs an unseeded random.{leaf}() — pass an "
                    "explicit seed so replay stays deterministic"
                )
            elif leaf in _RANDOM_SEEDED_OK:
                continue
            else:
                message = (
                    f"{fqn} calls the module-global random.{leaf}() — draw "
                    "from a seeded random.Random instance instead"
                )
            findings.append(
                Finding(
                    ANALYSIS,
                    "unseeded-random",
                    str(minfo.path),
                    node.lineno,
                    f"unseeded-random::{fqn}::{leaf}",
                    message,
                )
            )
    return findings


# ---------------------------------------------------------------------------
# thread spawns outside the clockseam gate
# ---------------------------------------------------------------------------


def _calls_threads_enabled(finfo: FunctionInfo) -> bool:
    for node in walk_function(finfo.node):
        if isinstance(node, ast.Call):
            func = node.func
            name = None
            if isinstance(func, ast.Name):
                name = func.id
            elif isinstance(func, ast.Attribute):
                name = func.attr
            if name == "threads_enabled":
                return True
    return False


def _spawn_target_desc(node: ast.Call) -> str:
    for kw in node.keywords:
        if kw.arg == "target":
            terminal = kw.value
            if isinstance(terminal, ast.Attribute):
                return terminal.attr
            if isinstance(terminal, ast.Name):
                return terminal.id
    return "thread"


def check_unseamed_threads(program: Program) -> list[Finding]:
    gated = {
        fqn for fqn, finfo in program.functions.items()
        if _calls_threads_enabled(finfo)
    }
    # reverse edges: spawning fn -> callers, so "the gate lives one
    # call level up" is visible
    callers: dict[str, set[str]] = {}
    for fqn in program.functions:
        for callee in program.direct_callees(fqn):
            callers.setdefault(callee, set()).add(fqn)

    findings: list[Finding] = []
    for fqn, finfo in program.functions.items():
        minfo = finfo.module
        if _sanctioned(str(minfo.path), _THREAD_SANCTIONED):
            continue
        spawns: list[tuple[ast.Call, str]] = []
        for node in walk_function(finfo.node):
            if not isinstance(node, ast.Call):
                continue
            origin = minfo.imports.resolve_call_target(node.func)
            if origin in ("threading.Thread", "threading.Timer"):
                spawns.append((node, origin.rsplit(".", 1)[-1]))
        if not spawns:
            continue
        if fqn in gated or (callers.get(fqn, set()) & gated):
            continue
        for node, kind in spawns:
            target = _spawn_target_desc(node)
            findings.append(
                Finding(
                    ANALYSIS,
                    "unseamed-thread",
                    str(minfo.path),
                    node.lineno,
                    f"unseamed-thread::{fqn}::{target}",
                    f"{fqn} spawns threading.{kind}(target={target}) without "
                    "consulting clockseam.threads_enabled() here or in a "
                    "direct caller — the sim cannot keep this off the real "
                    "scheduler",
                )
            )
    return findings


@program_rule(
    "determinism",
    "replay-determinism audit: set iteration into hash/exposition paths, "
    "unseeded random, thread spawns outside the clockseam gate",
)
def check_determinism(program: Program):
    findings = (
        check_unordered_iteration(program)
        + check_unseeded_random(program)
        + check_unseamed_threads(program)
    )
    blocks = {
        "rules": ["unordered-iteration", "unseeded-random", "unseamed-thread"],
        "findings": [f.to_json() for f in findings],
    }
    return findings, blocks
