"""Kernel resource budget of the CUDA kernels, from ``ptxas -v`` (twin of
``repro.analysis.kernel_budget``).

The reference models a TPU core's VMEM for each Pallas launch.  The card
has no VMEM: what a kernel can run out of there is registers and shared
memory, and the compiler reports both.  ``kernels/_build.py`` compiles
with ``-Xptxas=-v`` and keeps the report beside the library; a copy from
the card is committed as ``ptxas_sm90a.txt`` here, headed by the build's
hash (``_build.source_tag``: the flags and every ``csrc/*.cu*`` file).

Per ``__global__`` (the parser reads the report; ``__launch_bounds__``,
the block size of each launch and the constants come from ``csrc/``):

* ``REG-SPILL`` — spill stores or loads above 0 bytes;
* ``REG-BUDGET`` — registers x threads a block above an SM's 65,536, or
  registers above 255;
* ``SMEM-BUDGET`` — static shared memory plus the dynamic amount of the
  launcher's formula at its largest documented parameter (``sort_pass``
  at ``MAX_GROUP_SHARDS`` shards; ``group_by_key``'s digit passes at
  2^7 and 2^6 buckets) above 49,152 bytes for a kernel that does not opt
  in, or 232,448 for one that does;
* ``BUDGET-STALE`` — the record's hash is not today's (a kernel edit
  without a fresh record) or, on the card, the live report differs from
  the record.

Resident blocks and warps a SM are reported (not a finding).
``max_shards_under_smem`` is the twin of ``max_capacity_under_budget``:
the largest shard count all three ``sort_pass`` kernels launch with.
The VMEM accounting the port keeps in ``kernels/ops.py`` mirrors the
reference's dispatch and is not this module's.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.findings import Finding

_PKG = Path(__file__).resolve().parent.parent          # src/repro_torch
RECORD_PATH = Path(__file__).resolve().parent / "ptxas_sm90a.txt"
RECORD_REL = "src/repro_torch/analysis/ptxas_sm90a.txt"
CSRC_REL = "src/repro_torch/csrc"

# sm_90 (H100) limits a block and a SM
REGS_PER_SM = 65536
MAX_REGS_PER_THREAD = 255
SMEM_DEFAULT_BYTES = 48 * 1024          # a block without opting in
SMEM_OPTIN_BYTES = 227 * 1024           # 232,448: a block that opts in
SMEM_PER_SM_BYTES = 228 * 1024          # a SM's shared memory
SMEM_RESERVED_PER_BLOCK = 1024          # the runtime's share of a block
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
REG_ALLOC_UNIT = 256                    # registers a warp, allocated in


@dataclasses.dataclass
class KernelUsage:
    """One ``__global__`` as ptxas reports it."""

    name: str                  # demangled: "group_scatter_kernel<true>"
    source: str = ""           # the .cu file it came from
    registers: int = 0
    spill_stores: int = 0      # bytes
    spill_loads: int = 0       # bytes
    stack: int = 0             # bytes of stack frame a thread
    smem_static: int = 0       # bytes

    @property
    def base(self) -> str:
        return self.name.split("<")[0]

    def numbers(self) -> Tuple[int, ...]:
        return (self.registers, self.spill_stores, self.spill_loads,
                self.stack, self.smem_static)


# ---------------------------------------------------------------------------
# Parsing: names, the report, the sources
# ---------------------------------------------------------------------------

def demangle(symbol: str) -> str:
    """``name<args>`` of an Itanium-mangled kernel symbol, its namespaces
    (the anonymous one included) dropped; bool and int template arguments
    read, anything else kept as ``?``.  An unmangled name is returned as
    it is."""
    if not symbol.startswith("_Z"):
        return symbol
    i = 2
    nested = symbol[i] == "N"
    if nested:
        i += 1
    names: List[str] = []
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        n = int(symbol[i:j])
        names.append(symbol[j:j + n])
        i = j + n
        if not nested:
            break
    name = names[-1] if names else symbol
    if i < len(symbol) and symbol[i] == "I":
        args, i = [], i + 1
        while i < len(symbol) and symbol[i] != "E":
            m = re.match(r"L([a-z])(n?\d+)E", symbol[i:])
            if not m:
                args.append("?")
                break
            kind, val = m.group(1), m.group(2).replace("n", "-")
            args.append({"1": "true", "0": "false"}[val] if kind == "b"
                        else val)
            i += m.end()
        name += "<" + ", ".join(args) + ">"
    return name


_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_PROPS_RE = re.compile(r"Function properties for (\S+)")
_FRAME_RE = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads")
_USED_RE = re.compile(r"Used (\d+) registers")
_SMEM_RE = re.compile(r"(\d+) bytes smem")
_TAG_RE = re.compile(r"^# tag ([0-9a-f]+):", re.M)


def parse_ptxas(text: str) -> Dict[str, KernelUsage]:
    """Every entry function of a ``ptxas -v`` report, by demangled name
    (``## file`` lines, as ``_build`` writes them, name the source)."""
    out: Dict[str, KernelUsage] = {}
    source = ""
    entry: Optional[str] = None       # the entry being compiled
    props: Optional[str] = None       # whose properties the next line has
    frames: Dict[str, Tuple[int, int, int]] = {}
    for line in text.splitlines():
        if line.startswith("## "):
            source = line[3:].strip()
            continue
        m = _ENTRY_RE.search(line)
        if m:
            entry = m.group(1)
            out[entry] = KernelUsage(demangle(entry), source)
            continue
        m = _PROPS_RE.search(line)
        if m:
            props = m.group(1)
            continue
        m = _FRAME_RE.search(line)
        if m and props is not None:
            frames[props] = tuple(int(g) for g in m.groups())
            continue
        m = _USED_RE.search(line)
        if m and entry is not None:
            k = out[entry]
            k.registers = int(m.group(1))
            s = _SMEM_RE.search(line)
            k.smem_static = int(s.group(1)) if s else 0
    for sym, (stack, st, ld) in frames.items():
        if sym in out:
            out[sym].stack, out[sym].spill_stores, out[sym].spill_loads = \
                stack, st, ld
    return {k.name: k for k in out.values()}


def record_tag(text: str) -> Optional[str]:
    m = _TAG_RE.search(text)
    return m.group(1) if m else None


def _int_literal(expr: str) -> str:
    return re.sub(r"\b(0x[0-9a-fA-F]+|\d+)[uUlL]+\b", r"\1", expr)


def _eval_int(expr: str, env: Dict[str, int]) -> int:
    """An integer C expression of literals, names in ``env``, + - * / % <<
    >> and parentheses (a cast such as ``(size_t)`` is dropped)."""
    expr = re.sub(r"\((?:unsigned|int|size_t|long long)\)", "",
                  _int_literal(expr.strip()))
    ops = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a // b,
           ast.FloorDiv: lambda a, b: a // b, ast.Mod: lambda a, b: a % b,
           ast.LShift: lambda a, b: a << b, ast.RShift: lambda a, b: a >> b}

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name) and node.id in env:
            return env[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in ops:
            return ops[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        raise ValueError(f"not a constant expression: {expr!r}")

    return ev(ast.parse(expr, mode="eval"))


def constants(src: str) -> Dict[str, int]:
    """``constexpr`` integers of a CUDA source, in order of definition."""
    env: Dict[str, int] = {}
    for m in re.finditer(r"constexpr\s+(?:int|unsigned|size_t|long long)"
                         r"\s+(\w+)\s*=\s*([^;]+);", src):
        try:
            env[m.group(1)] = _eval_int(m.group(2), env)
        except (ValueError, SyntaxError):
            pass
    return env


def _split_top(s: str) -> List[str]:
    parts, depth, cur = [], 0, ""
    for ch in s:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    parts.append(cur.strip())
    return parts


@dataclasses.dataclass
class KernelSource:
    """What ``csrc/`` says of one ``__global__``."""

    name: str
    source: str
    max_threads: int           # __launch_bounds__ first argument
    min_blocks: int            # its second, 0 when absent
    block_dims: Tuple[int, ...]    # block size of every launch site


def kernel_sources(csrc: Path) -> Dict[str, KernelSource]:
    """Every ``__global__`` of ``csrc/*.cu``: its launch bounds and the
    block size of its launches, by base name."""
    out: Dict[str, KernelSource] = {}
    for path in sorted(csrc.glob("*.cu")):
        src = path.read_text()
        env = constants(src)
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\("
                             r"([^)]*)\)\s*)?(\w+)\s*\(", src):
            # without bounds a block may take the card's 1024 threads
            args = ([_eval_int(a, env) for a in _split_top(m.group(1))]
                    if m.group(1) else [1024])
            out[m.group(2)] = KernelSource(
                m.group(2), path.name, args[0],
                args[1] if len(args) > 1 else 0, ())
        for m in re.finditer(r"(\w+)\s*(?:<[^<>;]*>)?\s*<<<(.*?)>>>", src,
                             re.S):
            if m.group(1) in out:
                dims = _split_top(" ".join(m.group(2).split()))
                ks = out[m.group(1)]
                ks.block_dims = ks.block_dims + (_eval_int(dims[1], env),)
        # cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(block), ...)
        for m in re.finditer(r"cudaLaunchCooperativeKernel\(\s*(?:\([^()]*"
                             r"\))?\s*(\w+)\s*(?:<[^<>;]*>)?\s*,\s*dim3\("
                             r"[^()]*\)\s*,\s*dim3\(([^()]*)\)", src):
            if m.group(1) in out:
                ks = out[m.group(1)]
                ks.block_dims = ks.block_dims + (_eval_int(m.group(2), env),)
    return out


# ---------------------------------------------------------------------------
# Dynamic shared memory at the largest documented parameter
# ---------------------------------------------------------------------------

def _group_constants(csrc: Path) -> Dict[str, int]:
    return constants((csrc / "shard_group.cu").read_text())


def dynamic_smem(csrc: Path, shards: Optional[int] = None
                 ) -> Dict[str, Tuple[int, bool, str]]:
    """``sort_pass``'s dynamic shared memory (``shard_group.cu``): by
    kernel, (bytes at the largest parameter, whether the launcher opts
    in above the default, the parameter).  Shard mode takes ``shards``
    (the documented ``MAX_GROUP_SHARDS``), key mode the larger of its two
    digit passes (2^kLowDigitBits and 2^(kKeyBucketBits -
    kLowDigitBits) buckets); the scan kernel serves both."""
    from repro_torch.kernels.shard_group import MAX_GROUP_SHARDS

    c = _group_constants(csrc)
    S = MAX_GROUP_SHARDS if shards is None else shards
    key_buckets = max(1 << c["kLowDigitBits"],
                      1 << (c["kKeyBucketBits"] - c["kLowDigitBits"]))

    def counters(s):
        return (s + 1) * 4

    def scatter(s):
        return 2 * counters(s) + 3 * c["kTile"] * 4

    return {
        "group_histogram_kernel<false>": (counters(S), False,
                                          f"shards = {S}"),
        "group_histogram_kernel<true>": (counters(key_buckets), False,
                                         f"{key_buckets} key buckets"),
        "group_scan_kernel": (counters(max(S, key_buckets)), False,
                              f"shards = {max(S, key_buckets)}"),
        "group_scatter_kernel<false>": (scatter(S),
                                        scatter(S) > c["kDefaultSmem"],
                                        f"shards = {S}"),
        "group_scatter_kernel<true>": (scatter(key_buckets),
                                       scatter(key_buckets)
                                       > c["kDefaultSmem"],
                                       f"{key_buckets} key buckets"),
    }


def max_shards_under_smem(usage: Optional[Dict[str, KernelUsage]] = None,
                          csrc: Optional[Path] = None) -> int:
    """The largest ``shards`` that each of ``sort_pass``'s three shard-mode
    kernels (histogram, scan, scatter) can launch with: the histogram and
    the scan hold ``(shards + 1)`` counters under the default 48 KiB, the
    scatter twice that and its tile under the 227 KiB it opts in to; the
    static shared memory comes from the ptxas record."""
    csrc = csrc or _PKG / "csrc"
    usage = usage if usage is not None else load_record()[1]
    c = _group_constants(csrc)
    hist = SMEM_DEFAULT_BYTES - usage["group_histogram_kernel<false>"]\
        .smem_static
    scan = SMEM_DEFAULT_BYTES - usage["group_scan_kernel"].smem_static
    scat = (SMEM_OPTIN_BYTES - usage["group_scatter_kernel<false>"]
            .smem_static - 3 * c["kTile"] * 4) // 2
    return min(hist, scan, scat) // 4 - 1


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

def occupancy(registers: int, threads: int, smem: int) -> Tuple[int, int]:
    """(resident blocks, resident warps) a SM for a block of ``threads``
    threads at ``registers`` a thread and ``smem`` bytes."""
    warps = -(-threads // 32)
    per_warp = -(-max(registers, 1) * 32 // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    by_regs = (REGS_PER_SM // per_warp) // warps
    by_smem = SMEM_PER_SM_BYTES // (smem + SMEM_RESERVED_PER_BLOCK)
    by_threads = MAX_THREADS_PER_SM // (warps * 32)
    blocks = min(by_regs, by_smem, by_threads, MAX_BLOCKS_PER_SM)
    return blocks, blocks * warps


def load_record(path: Optional[Path] = None
                ) -> Tuple[Optional[str], Dict[str, KernelUsage]]:
    """(tag, kernels) of a report file (the committed record by default);
    (None, {}) if it is missing."""
    path = path or RECORD_PATH
    if not path.exists():
        return None, {}
    text = path.read_text()
    return record_tag(text), parse_ptxas(text)


def live_record_text() -> str:
    """The card build's ptxas report as a record: ``_build``'s header, a
    line naming the card (``nvidia-smi`` name and power limit), nvcc and
    torch, then the report.  Needs the card and nvcc."""
    import subprocess

    import torch

    from repro_torch.kernels import _build

    _build.library()
    text = _build.ptxas_report_path().read_text()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    nvcc = [ln for ln in subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True,
        check=True).stdout.splitlines() if "release" in ln][0]
    head, _, rest = text.partition("\n## ")
    return (f"{head}\n# built on the card machine: {smi.strip()}; "
            f"{nvcc.strip()}; torch {torch.__version__}\n## {rest}")


def check_kernels(usage: Dict[str, KernelUsage],
                  csrc: Optional[Path] = None
                  ) -> Tuple[List[Finding], List[dict]]:
    """REG-SPILL, REG-BUDGET and SMEM-BUDGET of every kernel: (findings,
    one row a kernel with its numbers and occupancy).  A finding's path
    is the kernel's source file."""
    csrc = csrc or _PKG / "csrc"
    sources = kernel_sources(csrc)
    dyn = dynamic_smem(csrc)
    findings: List[Finding] = []
    rows: List[dict] = []

    def flag(rule, k, msg):
        findings.append(Finding(rule=rule, path=f"{CSRC_REL}/{k.source}",
                                line=0, symbol=k.name, message=msg))

    for k in sorted(usage.values(), key=lambda k: k.name):
        ks = sources.get(k.base)
        threads = max((ks.block_dims or (ks.max_threads,))) if ks else 0
        d_bytes, opt_in, param = dyn.get(k.name, (0, False, ""))
        smem = k.smem_static + d_bytes
        limit = SMEM_OPTIN_BYTES if opt_in else SMEM_DEFAULT_BYTES
        if k.spill_stores or k.spill_loads:
            flag("REG-SPILL", k, f"{k.spill_stores} bytes spill stores, "
                                 f"{k.spill_loads} bytes spill loads at "
                                 f"{k.registers} registers")
        if k.registers > MAX_REGS_PER_THREAD or \
                k.registers * threads > REGS_PER_SM:
            flag("REG-BUDGET", k, f"{k.registers} registers x {threads} "
                                  f"threads = {k.registers * threads} > "
                                  f"{REGS_PER_SM}")
        if smem > limit:
            flag("SMEM-BUDGET", k,
                 f"{k.smem_static} static + {d_bytes} dynamic bytes"
                 f"{' (' + param + ')' if param else ''} = {smem} > "
                 f"{limit} ({'opt-in' if opt_in else 'no opt-in'})")
        if ks is None:
            flag("BUDGET-STALE", k, "in the ptxas report but no "
                                    "__global__ of csrc/ has its name")
        blocks, warps = occupancy(k.registers, threads or 1, smem)
        rows.append({"kernel": k.name, "source": k.source,
                     "registers": k.registers,
                     "spill_bytes": k.spill_stores + k.spill_loads,
                     "spill_stores": k.spill_stores,
                     "spill_loads": k.spill_loads,
                     "stack": k.stack, "smem_static": k.smem_static,
                     "smem_dynamic_max": d_bytes, "threads": threads,
                     "launch_bounds": ([ks.max_threads, ks.min_blocks]
                                       if ks else None),
                     "blocks_per_sm": blocks, "warps_per_sm": warps})
    bases = {k.base for k in usage.values()}
    for name, ks in sorted(sources.items()):
        if name not in bases:
            findings.append(Finding(
                rule="BUDGET-STALE", path=f"{CSRC_REL}/{ks.source}",
                line=0, symbol=name,
                message=f"__global__ {name} of {ks.source} is not in the "
                        "ptxas report"))
    return findings, rows


def _diff(a: Dict[str, KernelUsage], b: Dict[str, KernelUsage]) -> List[str]:
    out = [f"{n}: {'missing from' if n not in b else 'only in'} the record"
           for n in sorted(set(a) ^ set(b))]
    for n in sorted(set(a) & set(b)):
        if a[n].numbers() != b[n].numbers():
            out.append(f"{n}: live (regs, spill st, spill ld, stack, smem) "
                       f"{a[n].numbers()} != record {b[n].numbers()}")
    return out


def run_budget(live: Optional[bool] = None
               ) -> Tuple[List[Finding], List[str], List[dict]]:
    """The budget pass: (findings, checked kernels, per-kernel rows).

    On the CPU (``live`` false; default: no card) it checks the committed
    record and fires ``BUDGET-STALE`` if its hash is not today's; on the
    card it builds the library, checks the live report and fires
    ``BUDGET-STALE`` where it differs from the record."""
    import torch

    from repro_torch.kernels import _build

    if live is None:
        live = torch.cuda.is_available()
    findings: List[Finding] = []
    tag, record = load_record()
    today = _build.source_tag()
    if tag is None:
        findings.append(Finding(
            rule="BUDGET-STALE", path=RECORD_REL, line=0, symbol="record",
            message="no ptxas record: copy a card build's report here"))
    elif tag != today:
        findings.append(Finding(
            rule="BUDGET-STALE", path=RECORD_REL, line=0, symbol="record",
            message=f"the record is of build {tag}, today's csrc/ and "
                    f"flags are {today}: refresh it from a card build"))
    usage = record
    if live:
        _build.library()
        usage = parse_ptxas(_build.ptxas_report_path(today).read_text())
        for d in (_diff(usage, record) if tag is not None else ()):
            findings.append(Finding(
                rule="BUDGET-STALE", path=RECORD_REL, line=0,
                symbol="live report", message=d))
    fs, rows = check_kernels(usage)
    findings.extend(fs)
    return findings, [r["kernel"] for r in rows], rows
