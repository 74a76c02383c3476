"""Recorded-run and kernel-source auditing primitives: the contract
predicates behind the traced rules.

The reference (``repro.analysis.jaxpr``) reads a jaxpr.  The port has no
program to read before it runs, so it records one: :class:`Recorder` is a
``TorchDispatchMode`` that keeps the op name, shape and dtype of every
output of every op an entry point runs under it.  On the card the
hand-written kernels are ``ctypes`` calls the mode cannot see, but their
outputs and scratch come from ``torch.empty``, which it does, so a run on
the CUDA path is audited as fully as one on the plain versions.

``hbm-residency`` has no jaxpr counterpart at all: a CUDA kernel reads its
operands where the caller keeps them, so the rule is restated over what
could make a block's shared memory grow with the graph —
:func:`shared_memory_findings` reads each kernel's ``.cu`` and the headers
it includes, and :func:`static_smem_bytes` reads the built library — and
over the launch's arguments (:func:`operand_findings`).

Functions here return :class:`~repro_torch.analysis.registry.Finding`
lists for the runner.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Sequence,
                    Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.registry import Finding


@dataclasses.dataclass(frozen=True)
class Record:
    """One output of one op of a recorded run."""

    op: str
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


class Recorder(TorchDispatchMode):
    """Records every op output of the code run under it (``with
    Recorder() as rec: ...``; then ``rec.records``)."""

    def __init__(self):
        super().__init__()
        self.records: List[Record] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.records.append(Record(str(func), tuple(t.shape),
                                           t.dtype))
        return out


def record(fn: Callable[..., Any], *args, **kwargs
           ) -> Tuple[Any, List[Record]]:
    """``fn(*args, **kwargs)`` run under a :class:`Recorder`: its result
    and the records."""
    with Recorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.records


# -- dense-state-bound and no-replicated-index --------------------------------

def dense_state_findings(
    records: Iterable[Record],
    *,
    budget: int,
    floor: int,
    rule: str = "dense-state-bound",
    anchor: str = "",
    dtype: torch.dtype = torch.float32,
) -> List[Finding]:
    """Flag any recorded ``dtype`` output over ``budget`` elements.

    ``floor`` is the dense-state size the sparse path exists to avoid
    (``rows * n`` / ``Q * n``); the rule demands ``budget < floor`` so a
    budget inflation can never silently re-admit dense state ("teeth").
    """
    findings: List[Finding] = []
    if budget >= floor:
        findings.append(Finding(
            rule=rule, file=anchor, line=0,
            message=f"budget {budget} >= dense floor {floor}: the bound has "
                    f"no teeth (would admit a dense [rows, n] intermediate)",
        ))
        return findings
    seen = set()
    for rec in records:
        if rec.dtype != dtype or rec.numel <= budget:
            continue
        if (rec.op, rec.shape) in seen:
            continue
        seen.add((rec.op, rec.shape))
        findings.append(Finding(
            rule=rule, file=anchor, line=0,
            message=f"{str(dtype).replace('torch.', '')}{list(rec.shape)} "
                    f"intermediate ({rec.numel} elements, op {rec.op!r}) "
                    f"exceeds the sparse-state budget {budget} (dense floor "
                    f"{floor})",
        ))
    return findings


def replicated_index_findings(
    records: Iterable[Record],
    outputs: Sequence[Tuple[int, ...]],
    *,
    n: int,
    l: int,
    shards: int,
    rule: str = "no-replicated-index",
    anchor: str = "",
) -> List[Finding]:
    """The sharded build's step on a stacked mesh: it must return its rows
    stacked on the model shard axis (``outputs``' shapes, the first of
    ``shards``: the counterpart of a shard_map), and no recorded output
    may have the shape ``[..., >=n, >=l]`` — a whole index in one array,
    which erases the sharded build's memory asymptotics.  ``n`` is the
    *global* vertex count; a legal per-shard block is ``[n/ep, L]``."""
    findings: List[Finding] = []
    if not any(len(s) >= 2 and s[0] == shards for s in outputs):
        findings.append(Finding(
            rule=rule, file=anchor, line=0,
            message=f"build step returns no array stacked on its {shards} "
                    f"model shards (outputs {[list(s) for s in outputs]}): "
                    f"sharded-build contract cannot be audited",
        ))
        return findings
    seen = set()
    for rec in records:
        shape = rec.shape
        if len(shape) < 2 or shape[-2] < n or shape[-1] < l:
            continue
        if (rec.op, shape) in seen:
            continue
        seen.add((rec.op, shape))
        findings.append(Finding(
            rule=rule, file=anchor, line=0,
            message=f"array {shape} (op {rec.op!r}) covers the full "
                    f"[{n}, {l}] index — replicated, not sharded",
        ))
    return findings


# -- hbm-residency: the kernels' sources --------------------------------------

# tile parameters a launch's dynamic shared memory may depend on: the
# frontier, answer and exchange widths and the hash table's size (never
# n, m or nnz)
TILE_PARAMETERS = frozenset({"k", "k_out", "t_log2", "wire_k"})
_CPP_WORDS = frozenset({
    "sizeof", "alignof", "int", "unsigned", "long", "short", "char", "float",
    "double", "size_t", "bool", "true", "false", "const", "static_cast"})
_IDENT = re.compile(r"(?<![\w.])[A-Za-z_]\w*(?:::[A-Za-z_]\w*)*")
_CODE = re.compile(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"', re.S)
_KERNEL = re.compile(
    r"__global__\s+(?:(?:void|static|inline)\s+|__launch_bounds__\s*"
    r"\([^)]*\)\s*)*([A-Za-z_]\w*)\s*\(")
_LAUNCH = re.compile(
    r"([A-Za-z_]\w*(?:::[A-Za-z_]\w*)*)\s*(?:<[^<>;]*>)?\s*<<<(.*?)>>>", re.S)


def strip_comments(text: str) -> str:
    """``text`` with comments blanked (newlines kept, so offsets keep their
    line numbers) and string literals left as they are."""
    def blank(m):
        s = m.group(0)
        return s if s.startswith('"') else re.sub(r"[^\n]", " ", s)
    return _CODE.sub(blank, text)


def kernel_sources(cu: Path) -> List[Path]:
    """``cu`` and every local header it includes, transitively."""
    seen: List[Path] = []
    queue = [cu]
    while queue:
        p = queue.pop(0)
        if p in seen:
            continue
        seen.append(p)
        for m in re.finditer(r'^\s*#\s*include\s+"([^"]+)"',
                             strip_comments(p.read_text()), re.M):
            queue.append(p.parent / m.group(1))
    return seen


def _last(name: str) -> str:
    return name.rsplit("::", 1)[-1]


def compile_time_names(texts: Iterable[str]) -> set:
    """Names that are compile-time constants in ``texts``: ``constexpr``
    variables, enumerators, macros and template parameters."""
    names = set()
    for t in texts:
        names.update(re.findall(
            r"\bconstexpr\b[^;{(]*?\b([A-Za-z_]\w*)\s*(?:=|\{)", t))
        names.update(re.findall(r"#\s*define\s+([A-Za-z_]\w*)", t))
        for body in re.findall(
                r"\benum\b(?:\s+class)?\s*\w*\s*(?::\s*\w+\s*)?\{([^}]*)\}",
                t):
            names.update(re.findall(r"(?:^|,)\s*([A-Za-z_]\w*)", body))
        for params in re.findall(r"\btemplate\s*<([^<>]*)>", t):
            for item in params.split(","):
                ids = re.findall(r"[A-Za-z_]\w*", item.split("=")[0])
                if ids:
                    names.add(ids[-1])
    return names


def _split_top(s: str) -> List[str]:
    """``s`` split at its top-level commas."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts]


def _free_names(expr: str, text: str, pos: int, constants: set,
                depth: int = 0) -> List[str]:
    """Identifiers of ``expr`` (in ``text`` before offset ``pos``) that are
    neither compile-time, nor called functions, nor tile parameters; a
    local ``int x = ...;`` is replaced by its initializer first."""
    free = []
    for m in _IDENT.finditer(expr):
        name = m.group(0)
        short = _last(name)
        if (short in constants or short in _CPP_WORDS
                or short in TILE_PARAMETERS
                or expr[m.end():].lstrip().startswith("(")):
            continue
        init = None
        if depth < 4:
            for d in re.finditer(
                    r"\b(?:const\s+)?(?:int|unsigned|size_t|long long|auto)"
                    rf"\s+{re.escape(short)}\s*=\s*([^;]*);", text[:pos]):
                init = d.group(1)
        if init is None:
            free.append(short)
        else:
            free.extend(_free_names(init, text, pos, constants, depth + 1))
    return free


def _line(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _anchor(path: Path, root: Path) -> str:
    """``path`` relative to ``root`` where it lies under it."""
    try:
        return str(path.resolve().relative_to(root.resolve()))
    except ValueError:
        return str(path)


def _kernel_params(text: str) -> Dict[str, Tuple[int, List[str]]]:
    """``__global__`` kernel name -> (its offset, its parameter list)."""
    out = {}
    for m in _KERNEL.finditer(text):
        depth, i = 1, m.end()
        while depth and i < len(text):
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        out[m.group(1)] = (m.start(), _split_top(text[m.end():i - 1]))
    return out


def shared_memory_findings(
    cu: Path,
    *,
    operands: Iterable[str],
    root: Path,
    rule: str = "hbm-residency",
) -> List[Finding]:
    """The static half of the kernel memory contract over ``cu`` and the
    headers it includes (anchors relative to ``root``):

    1. every ``__shared__`` array's extent is a compile-time constant
       (literal, ``constexpr``, enumerator, macro or template parameter);
    2. every launch of a kernel that declares ``extern __shared__`` takes
       its dynamic bytes from compile-time constants, tile parameters
       (:data:`TILE_PARAMETERS`) and named planner functions — never from
       a graph size such as ``n`` or ``nnz``;
    3. each ``operands`` name (the CSR's ``col_idx``, the index's ``vals``
       and ``idx``) is a kernel parameter, and every kernel parameter of
       that name is a ``const`` pointer: the caller's global memory, only
       gathered from.
    """
    files = kernel_sources(cu)
    texts = {p: strip_comments(p.read_text()) for p in files}
    constants = compile_time_names(texts.values())
    findings: List[Finding] = []

    def finding(p: Path, pos: int, message: str) -> None:
        findings.append(Finding(
            rule=rule, file=_anchor(p, root), line=_line(texts[p], pos),
            message=message))

    extern_kernels: Dict[str, Tuple[Path, int]] = {}
    kernels = {p: _kernel_params(t) for p, t in texts.items()}
    for p, t in texts.items():
        for m in re.finditer(r"\b__shared__\b([^;]*);", t):
            decl = re.sub(r"__align__\s*\([^)]*\)", "", m.group(1))
            if t[:m.start()].rstrip().endswith("extern"):
                owner = [(pos, name) for name, (pos, _) in kernels[p].items()
                         if pos < m.start()]
                if not owner:
                    finding(p, m.start(), "extern __shared__ outside a "
                            "__global__ kernel: its launch cannot be audited")
                    continue
                extern_kernels[max(owner)[1]] = (p, m.start())
                continue
            for arr in re.finditer(r"([A-Za-z_]\w*)\s*((?:\[[^\]]*\])+)",
                                   decl):
                bad = [x for x in _IDENT.findall(arr.group(2))
                       if _last(x) not in constants
                       and _last(x) not in _CPP_WORDS]
                if bad:
                    finding(p, m.start(),
                            f"__shared__ {arr.group(1)}{arr.group(2)} is "
                            f"sized by {sorted(set(bad))}, not a "
                            f"compile-time constant: a block's shared "
                            f"memory would grow with the input")
    launched = set()
    for p, t in texts.items():
        for m in _LAUNCH.finditer(t):
            kernel = _last(m.group(1))
            if kernel not in extern_kernels:
                continue
            launched.add(kernel)
            config = _split_top(m.group(2))
            smem = config[2] if len(config) > 2 else "0"
            free = _free_names(smem, t, m.start(), constants)
            if free:
                finding(p, m.start(),
                        f"launch of {kernel} takes {smem!r} bytes of dynamic "
                        f"shared memory, which depend on {sorted(set(free))}"
                        f": not a planner of tile parameters "
                        f"{sorted(TILE_PARAMETERS)}")
    for kernel, (p, pos) in extern_kernels.items():
        if kernel not in launched:
            finding(p, pos, f"{kernel} declares extern __shared__ but no "
                            f"launch of it was found to audit its bytes")
    for name in operands:
        params = [(p, pos, prm) for p, ks in kernels.items()
                  for pos, prms in ks.values() for prm in prms
                  if re.findall(r"[A-Za-z_]\w*", prm)[-1:] == [name]]
        if not params:
            findings.append(Finding(
                rule=rule, file=_anchor(cu, root), line=0,
                message=f"no kernel takes the operand {name!r}: the memory "
                        f"contract cannot be audited"))
        for p, pos, prm in params:
            if not re.search(r"\bconst\b", prm):
                finding(p, pos, f"kernel parameter {prm!r} is writable: the "
                                f"operand {name!r} must be only gathered "
                                f"from")
    return findings


# -- hbm-residency: the built library and the launches ------------------------

def cuobjdump_path() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError(
            "cuobjdump not found (PATH, $CUDA_HOME/bin, /usr/local/cuda)")
    return path


def parse_res_usage(text: str) -> Dict[str, int]:
    """Static shared memory of every kernel in ``cuobjdump -res-usage``'s
    output, by its (mangled) name."""
    sizes: Dict[str, int] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function\s+([^\s:]+)\s*:", line)
        if m:
            name = m.group(1)
        m = re.search(r"\bSHARED:(\d+)", line)
        if m and name is not None:
            sizes[name] = int(m.group(1))
            name = None
    return sizes


def static_smem_bytes(library: Path) -> Dict[str, int]:
    """Static shared memory of every kernel in a built library."""
    return parse_res_usage(subprocess.run(
        [cuobjdump_path(), "-res-usage", str(library)],
        capture_output=True, text=True, check=True).stdout)


def symbol_matches(raw: str, name: str) -> bool:
    """Whether the library symbol ``raw`` is kernel ``name``: the name
    itself (``extern "C"``) or a mangled name that holds it."""
    return raw == name or f"{len(name)}{name}" in raw


def smem_totals(static: Mapping[str, int],
                dynamic: Mapping[str, int]) -> Dict[str, int]:
    """Each kernel's static plus dynamic shared bytes a block."""
    return {raw: b + sum(v for k, v in dynamic.items()
                         if symbol_matches(raw, k))
            for raw, b in static.items()}


def smem_findings(
    totals: Mapping[str, Mapping[str, int]],
    optin: int,
    *,
    name: str,
    rule: str = "hbm-residency",
    anchor: str = "",
) -> List[Finding]:
    """``totals`` (graph label -> each kernel's shared bytes a block):
    every kernel within the opt-in limit on every graph, and the same
    bytes on every graph — a block's shared memory does not grow with
    the graph."""
    findings: List[Finding] = []
    for label, sizes in totals.items():
        for raw, b in sizes.items():
            if b > optin:
                findings.append(Finding(
                    rule=rule, file=anchor, line=0,
                    message=f"{name}: {raw} takes {b} bytes of shared "
                            f"memory a block on {label}, over the opt-in "
                            f"limit {optin}"))
    if len({tuple(sorted(s.items())) for s in totals.values()}) > 1:
        findings.append(Finding(
            rule=rule, file=anchor, line=0,
            message=f"{name}: shared memory a block grows with the graph: "
                    f"{dict(totals)}"))
    return findings


def operand_findings(
    launch_args: Sequence[Any],
    operands: Mapping[str, int],
    owners: Mapping[str, torch.Tensor],
    *,
    label: str,
    shapes: Sequence[Tuple[int, ...]] = (),
    rule: str = "hbm-residency",
    anchor: str = "",
) -> List[Finding]:
    """Each operand (``name -> position`` in a recorded launch's
    arguments) must be its owner's own storage: the same ``data_ptr()``
    as the graph's or the index's tensor, never a copy; and, where
    ``shapes`` is given, of one of those shapes."""
    findings: List[Finding] = []
    for name, pos in operands.items():
        t = launch_args[pos]
        if t.data_ptr() != owners[name].data_ptr():
            findings.append(Finding(
                rule=rule, file=anchor, line=0,
                message=f"{label}: the launch's {name} is not the caller's "
                        f"storage (a copy reached the kernel)"))
        if shapes and tuple(t.shape) not in [tuple(s) for s in shapes]:
            findings.append(Finding(
                rule=rule, file=anchor, line=0,
                message=f"{label}: the launch's {name} has shape "
                        f"{tuple(t.shape)}, not one of {list(shapes)}"))
    return findings
