"""Pass 5: buffer aliasing and in-place lifetime (ALIAS5xx).

Two hazards of the reference carry over to torch with their sign
changed.  On the reference's CPU backend `jax.device_put(arr)` could
alias the numpy buffer zero-copy; in torch it always does on `cpu`:
`torch.as_tensor(a)` / `torch.from_numpy(a)` share `a`'s memory, and
`.to("cpu")` hands the same tensor back, while `.to("cuda")` copies.  A
host-side in-place update of the template after it was handed over
uncopied then leaks into the "device" planes on `cpu` and not on the
card, so the CPU tests and the card can disagree (`ResidentSolver.
_put_node` copies first, and this pass keeps it that way).  And where
the reference read a buffer after donating it, the port changes
buffers in place: a name bound to the same storage reads the new
values, two wrapper layers down from the in-place op.

Rules
  ALIAS501  host in-place mutation of a buffer that previously flowed
            into `torch.as_tensor` / `torch.from_numpy` WITHOUT a copy
            (`np.asarray`, `np.ascontiguousarray`, same-dtype casts and
            slicing keep identity; `np.array`, `.copy()`,
            `torch.tensor` and `.clone()` copy), with or without
            `.to(device)`.  Checked in order within a function, and in
            any order across the methods of a class (the put-in-one-
            method / mutate-in-another shape), including puts made by a
            helper on its parameter and mutations made by a callee in
            the in-place map.
  ALIAS502  a snapshot read after an in-place mutation reached through
            the TRANSITIVE in-place map (a wrapper of a wrapper of
            `delta_scatter_set`): what JIT204's one hop cannot see.
            Sites JIT204 already reports are not reported again.
  ALIAS503  `self.<attr> = torch.as_tensor(<parameter>)` /
            `torch.from_numpy(<parameter>)` without a copy: the caller
            keeps a live handle to the buffer long-lived state now
            aliases on `cpu`.  (warn tier)
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set

from .core import AnalysisConfig, Finding, PackageIndex
from .dataflow import DataflowEngine


def run_alias_pass(index: PackageIndex, cfg: AnalysisConfig,
                   engine: Optional[DataflowEngine] = None,
                   prior: Sequence[Finding] = ()) -> List[Finding]:
    engine = engine or DataflowEngine(index, cfg)
    findings: List[Finding] = []
    findings += _alias501_local(index, engine)
    findings += _alias501_class(index, engine)
    findings += _alias503(index, engine)
    findings += _alias502(index, cfg, engine, prior)
    return findings


# ------------------------------------------------------------ ALIAS501
def _alias501_local(index: PackageIndex,
                    engine: DataflowEngine) -> List[Finding]:
    """Within one function, in source order: a buffer handed to torch
    uncopied, then an in-place mutation of the same buffer."""
    findings: List[Finding] = []
    for fkey, fi in sorted(index.functions.items()):
        fl = engine.flow(fkey, bound_cls=_own_class(index, fi))
        if not fl.puts or not fl.mutations:
            continue
        for put in fl.puts:
            if put.src.copied or not (put.src.atoms or put.src.key):
                continue
            for mut in fl.mutations:
                if mut.line <= put.line:
                    continue
                if _same_buffer(put.src.atoms, put.src.key,
                                mut.target.atoms, mut.target.key):
                    sym = put.src.key or sorted(put.src.atoms)[0]
                    findings.append(Finding(
                        "ALIAS501", fi.module, fi.qual, sym, fi.path,
                        mut.line,
                        f"in-place mutation of `{sym}` after it was "
                        f"handed to torch on line {put.line} without a "
                        "copy; on `cpu` the tensor shares the numpy "
                        "buffer, so it sees the host write too (and on "
                        "the card it does not)",
                        hint="torch.as_tensor(np.array(x)) — copy before "
                             "handing over — or stop mutating the host "
                             "buffer after shipping it"))
                    break
    return findings


def _alias501_class(index: PackageIndex,
                    engine: DataflowEngine) -> List[Finding]:
    """Across the methods of one concrete class: some method hands
    `self.<a>` (or a buffer it aliases) to torch uncopied, another
    mutates it in place."""
    findings: List[Finding] = []
    seen: Set[str] = set()
    for ckey in sorted(index.classes):
        facts = engine.class_facts(ckey)
        for attr, fact in sorted(facts.items()):
            if not fact.uncopied_puts or not fact.mutations:
                continue
            put_fkey, put_line = fact.uncopied_puts[0]
            for mut_fkey, mut_line, desc in fact.mutations:
                if mut_fkey == put_fkey and mut_line <= put_line:
                    continue     # already covered order-sensitively
                mfi = index.functions[mut_fkey]
                key = f"{mut_fkey}:{mut_line}:{attr}"
                if key in seen:
                    continue
                seen.add(key)
                pfi = index.functions[put_fkey]
                findings.append(Finding(
                    "ALIAS501", mfi.module, mfi.qual, attr, mfi.path,
                    mut_line,
                    f"in-place mutation ({desc}) of `self.{attr}`, "
                    "which is handed to torch without a copy in "
                    f"{pfi.qual} ({pfi.path}:{put_line}); on `cpu` the "
                    "tensor shares the buffer, so the planes see both the "
                    "host write and their own update",
                    hint="copy at the hand-over "
                         "(torch.as_tensor(np.array(...))) or make the "
                         "host update produce a fresh array"))
                break
    return findings


def _same_buffer(atoms_a, key_a, atoms_b, key_b) -> bool:
    if atoms_a & atoms_b:
        return True
    if key_a and key_b:
        return (key_a == key_b or key_b.startswith(key_a + "[")
                or key_a.startswith(key_b + "["))
    return False


def _own_class(index: PackageIndex, fi) -> Optional[str]:
    return f"{fi.module}:{fi.cls}" if fi.cls else None


# ------------------------------------------------------------ ALIAS503
def _alias503(index: PackageIndex,
              engine: DataflowEngine) -> List[Finding]:
    findings: List[Finding] = []
    for fkey, fi in sorted(index.functions.items()):
        fl = engine.flow(fkey, bound_cls=_own_class(index, fi))
        for put in fl.puts:
            if put.stored_attr is None or put.src.copied \
                    or put.via_call:
                continue
            params = sorted(a[6:] for a in put.src.atoms
                            if a.startswith("param:"))
            if not params:
                continue
            findings.append(Finding(
                "ALIAS503", fi.module, fi.qual, put.stored_attr,
                fi.path, put.line,
                f"`self.{put.stored_attr}` aliases caller-owned buffer "
                f"`{params[0]}` through an uncopied torch.as_tensor / "
                "from_numpy; on `cpu` the caller keeps a live handle to "
                "long-lived state",
                hint="torch.as_tensor(np.array(...)) or .clone() to sever "
                     "the alias at the boundary"))
    return findings


# ------------------------------------------------------------ ALIAS502
def _alias502(index: PackageIndex, cfg: AnalysisConfig,
              engine: DataflowEngine,
              prior: Sequence[Finding]) -> List[Finding]:
    from .jit_pass import Provenance, find_jit_roots, snapshot_reads
    full = engine.inplace_map()
    base = engine.inplace_base()
    deep = {k: tuple(p for p in v if p not in base.get(k, ()))
            for k, v in full.items()}
    deep = {k: v for k, v in deep.items() if v}
    if not deep:
        return []
    prior_sites = {(f.path, f.line, f.symbol) for f in prior
                   if f.rule == "JIT204"}
    prov = Provenance(index, find_jit_roots(index, cfg))
    findings: List[Finding] = []
    for fkey in sorted(index.functions):
        if not index.callees(fkey) & set(deep):
            continue
        for f in snapshot_reads(index, prov, fkey, deep,
                                rule="ALIAS502"):
            if (f.path, f.line, f.symbol) in prior_sites:
                continue
            findings.append(Finding(
                f.rule, f.module, f.func, f.symbol, f.path, f.line,
                f.message + " (the in-place update reaches this call "
                "through a chain of wrappers the direct JIT204 scan "
                "cannot see)",
                hint=f.hint))
    return findings
