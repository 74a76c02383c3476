"""AST lint engine: host-sync, RNG-discipline, and bare-time rules.

These are *textual* contracts that a recorded run can't see — a
``tensor.item()`` host sync never shows up among the ops a run records (it
happens between them), and reusing an RNG key runs fine but silently
breaks bitwise resume/repair.  The engine parses each module once,
collects candidate violations per rule, then applies the suppression
contract:

    some_host_sync()  # contract: allow(host-sync): harvested post-event

A suppression must name the rule AND carry a non-empty justification after
the colon; an allow() with no justification is itself reported (and the
finding stays unsuppressed).  Suppression comments attach to the flagged
line or the contiguous comment block directly above it.

The engine and the suppression contract are the reference's
(``repro.analysis.lint``); the spellings are torch's:

* host-sync: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")``, any ``.synchronize()`` (``torch.cuda.synchronize``, an
  event's, a stream's), ``float()`` of a runtime value, ``bool()`` /
  ``int()`` of a torch-rooted expression and the truthiness of one in
  ``if`` / ``while``;
* rng-discipline: ``split`` / ``fold_in`` of ``jax.random`` and of the
  port's ``rng``; a ``torch.arange`` over positional bounds is positional
  (the batched ``fold_in(key, t)`` over a range of steps);
* bare-time: ``time.time()``, stdlib ``random.*``, and draws from torch's
  global generator (``torch.manual_seed``, a ``torch.rand``-family call or
  an in-place ``.uniform_``-family fill without ``generator=``).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.registry import Finding

HOST_SYNC = "host-sync"
RNG_DISCIPLINE = "rng-discipline"
BARE_TIME = "bare-time"

LINT_RULES = (HOST_SYNC, RNG_DISCIPLINE, BARE_TIME)

_ALLOW_RE = re.compile(
    r"#\s*contract:\s*allow\(([A-Za-z0-9_-]+)\)\s*(?::\s*(.*?))?\s*$"
)

# tensor methods that copy device memory to the host (or wait for it)
_HOST_METHODS = {
    "item": ".item() materializes a device scalar on the host",
    "tolist": ".tolist() copies a device tensor to a host list",
    "cpu": ".cpu() is a blocking device-to-host copy",
    "numpy": ".numpy() reads the tensor's memory on the host",
    "synchronize": ".synchronize() stalls the host until the device "
                   "(or an event or stream) catches up",
}
# torch functions that draw from the global generator unless given one
_GLOBAL_DRAWS = ("rand", "randn", "randint", "randperm", "bernoulli",
                 "multinomial", "normal")
_INPLACE_DRAWS = ("uniform_", "normal_", "random_", "exponential_")


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted path of a Name/Attribute chain ('' otherwise)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _root_name(node: ast.AST) -> str:
    dotted = _dotted(node)
    return dotted.split(".", 1)[0] if dotted else ""


def _is_device_rooted(node: ast.AST) -> bool:
    """Heuristic: an expression whose call/attr chain roots at ``torch``
    produces a tensor — truthiness on it forces a host sync."""
    if isinstance(node, ast.Call):
        return _root_name(node.func) == "torch"
    return _root_name(node) == "torch"


def _is_rng_call(dotted: str, name: str) -> bool:
    """``jax.random.<name>`` (any prefix ending in ``random``), the port's
    ``rng.<name>``, or the bare name."""
    return (dotted == name or dotted.endswith(f"random.{name}")
            or dotted.split(".")[-2:] == ["rng", name])


def _is_cpu(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


class _Hit:
    __slots__ = ("rule", "line", "message")

    def __init__(self, rule: str, line: int, message: str):
        self.rule = rule
        self.line = line
        self.message = message


class _Visitor(ast.NodeVisitor):
    def __init__(self, rules: Sequence[str], imports_stdlib_random: bool):
        self.rules = set(rules)
        self.imports_stdlib_random = imports_stdlib_random
        self.hits: List[_Hit] = []

    def _hit(self, rule: str, node: ast.AST, message: str) -> None:
        if rule in self.rules:
            self.hits.append(_Hit(rule, getattr(node, "lineno", 0), message))

    # -- host-sync -----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        dotted = _dotted(func)
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        if isinstance(func, ast.Name) and func.id == "float" and node.args:
            if not isinstance(node.args[0], ast.Constant):
                self._hit(HOST_SYNC, node,
                          "float() on a runtime value blocks on the device "
                          "stream when the value is a CUDA tensor")
        elif (isinstance(func, ast.Name) and func.id in ("bool", "int")
              and node.args):
            if any(_is_device_rooted(a) for a in node.args):
                self._hit(HOST_SYNC, node,
                          f"{func.id}() of a device expression forces a "
                          f"host sync")
        elif isinstance(func, ast.Attribute) and func.attr in _HOST_METHODS:
            self._hit(HOST_SYNC, node, _HOST_METHODS[func.attr])
        elif isinstance(func, ast.Attribute) and func.attr == "to" and (
                (node.args and _is_cpu(node.args[0]))
                or _is_cpu(kw.get("device"))):
            self._hit(HOST_SYNC, node,
                      '.to("cpu") is a blocking device-to-host copy')
        # -- rng-discipline: fold_in with non-positional second arg ---------
        if _is_rng_call(dotted, "fold_in"):
            if len(node.args) >= 2 and not self._positional_arg(node.args[1]):
                self._hit(RNG_DISCIPLINE, node,
                          "fold_in() data argument is not a literal/offset "
                          "expression — per-chunk keys must be positional "
                          "(chunk id / offset) for bitwise resume and repair")
        # -- bare-time -------------------------------------------------------
        if dotted == "time.time":
            self._hit(BARE_TIME, node,
                      "time.time() in library code makes runs wall-clock "
                      "dependent; inject a clock or use loadgen timing")
        elif (self.imports_stdlib_random
              and _root_name(func) == "random"
              and isinstance(func, ast.Attribute)):
            self._hit(BARE_TIME, node,
                      f"stdlib {dotted}() draws unseeded global randomness; "
                      f"use the port's rng with a positional key")
        elif dotted == "torch.manual_seed":
            self._hit(BARE_TIME, node,
                      "torch.manual_seed() reseeds torch's global generator; "
                      "pass a seeded torch.Generator to each draw")
        elif "generator" not in kw and (
                dotted in {f"torch.{f}" for f in _GLOBAL_DRAWS}
                or (isinstance(func, ast.Attribute)
                    and func.attr in _INPLACE_DRAWS)):
            self._hit(BARE_TIME, node,
                      f"{dotted or func.attr}() without generator= draws "
                      f"from torch's global generator; pass a seeded "
                      f"torch.Generator")
        self.generic_visit(node)

    @staticmethod
    def _positional_arg(node: ast.AST) -> bool:
        """Is a fold_in data argument 'positional' — a literal, a named
        offset, or arithmetic over those?  Device-coordinate calls
        (``axis_index``) count: they are positional by construction; so
        does ``torch.arange`` over positional bounds, one positional key
        per element."""
        if isinstance(node, (ast.Constant, ast.Name, ast.Attribute)):
            return True
        if isinstance(node, ast.BinOp):
            return (_Visitor._positional_arg(node.left)
                    and _Visitor._positional_arg(node.right))
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted == "torch.arange":
                return bool(node.args) and all(
                    _Visitor._positional_arg(a) for a in node.args)
            return dotted.endswith("axis_index")
        return False

    # -- host-sync: tensor truthiness ---------------------------------------
    def _check_truthiness(self, test: ast.AST) -> None:
        queue = [test]
        while queue:
            node = queue.pop()
            if isinstance(node, ast.BoolOp):
                queue.extend(node.values)
            elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
                queue.append(node.operand)
            elif _is_device_rooted(node):
                self._hit(HOST_SYNC, node,
                          "truthiness of a device expression in a branch "
                          "condition forces a host sync")

    def visit_If(self, node: ast.If) -> None:
        self._check_truthiness(node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_truthiness(node.test)
        self.generic_visit(node)

    # -- rng-discipline: split stored into mutable state --------------------
    def _check_key_store(self, targets: Sequence[ast.AST],
                         value: ast.AST, node: ast.AST) -> None:
        if not any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in self._flatten_targets(targets)):
            return
        for sub in ast.walk(value):
            if isinstance(sub, ast.Call):
                if _is_rng_call(_dotted(sub.func), "split"):
                    self._hit(
                        RNG_DISCIPLINE, node,
                        "random split result stored into mutable state — "
                        "build/repair keys must derive positionally "
                        "(fold_in(base, chunk)) so resume replays bitwise")

    @staticmethod
    def _flatten_targets(targets: Sequence[ast.AST]) -> List[ast.AST]:
        flat: List[ast.AST] = []
        queue = list(targets)
        while queue:
            t = queue.pop()
            if isinstance(t, (ast.Tuple, ast.List)):
                queue.extend(t.elts)
            else:
                flat.append(t)
        return flat

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_key_store(node.targets, node.value, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_key_store([node.target], node.value, node)
        self.generic_visit(node)


def parse_suppressions(source: str) -> Dict[int, Tuple[str, str]]:
    """Map line number -> (rule, justification) for every allow() comment."""
    out: Dict[int, Tuple[str, str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            out[i] = (m.group(1), (m.group(2) or "").strip())
    return out


def lint_source(
    source: str,
    anchor: str,
    rules: Sequence[str],
) -> List[Finding]:
    """Lint one module's source under ``rules``; ``anchor`` is the
    repo-relative path stamped on findings."""
    tree = ast.parse(source, filename=anchor)
    imports_random = any(
        (isinstance(n, ast.Import)
         and any(a.name == "random" for a in n.names))
        or (isinstance(n, ast.ImportFrom) and n.module == "random")
        for n in ast.walk(tree)
    )
    visitor = _Visitor(rules, imports_random)
    visitor.visit(tree)
    suppressions = parse_suppressions(source)
    src_lines = source.splitlines()
    findings: List[Finding] = []
    for hit in visitor.hits:
        sup: Optional[Tuple[str, str]] = None
        # the flagged line itself, then upward through the contiguous
        # comment block directly above it (multi-line justifications)
        candidates = [hit.line]
        line = hit.line - 1
        while 1 <= line <= len(src_lines) and \
                src_lines[line - 1].lstrip().startswith("#"):
            candidates.append(line)
            line -= 1
        for line in candidates:
            entry = suppressions.get(line)
            if entry and entry[0] == hit.rule:
                sup = entry
                break
        if sup is None:
            findings.append(Finding(
                rule=hit.rule, file=anchor, line=hit.line,
                message=hit.message,
            ))
        elif not sup[1]:
            findings.append(Finding(
                rule=hit.rule, file=anchor, line=hit.line,
                message=f"{hit.message} [allow({hit.rule}) present but "
                        f"missing the required justification text]",
            ))
        else:
            findings.append(Finding(
                rule=hit.rule, file=anchor, line=hit.line,
                message=hit.message, suppressed=True, justification=sup[1],
            ))
    return findings


def lint_file(path: Path, anchor: str, rules: Sequence[str]) -> List[Finding]:
    return lint_source(path.read_text(), anchor, rules)
