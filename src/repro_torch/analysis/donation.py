"""R1 donation-alias: the zero-copy cache invariant, as a rule (the JAX
package's ``analysis/donation.py``).

The paper's C1 finding is that hidden memory management, a full cache
copy per step, dominates inference on its stack.  The reference's engine
donates the cache to every jit, and its rule reads the compiled module:
every donated cache leaf aliases an output, and no copy has a leaf's
size.  The port updates the cache in place with no donation to read, so
the invariant becomes three checks over one traced step:

  (a) every cache leaf keeps its storage across the step (the pointer
      before equals the pointer after: the in-place update that donation
      is for);
  (b) no op that reads a cache leaf's storage allocates a buffer of a
      leaf's size: the cache materialising.  Exact sizes where the MoE
      gather decode is on (its expert-weight copies legitimately exceed a
      leaf), sizes >= the smallest leaf otherwise.  An eager step
      allocates every intermediate, and at the reduced widths some (an
      expert FFN's hidden block) have a leaf's size by coincidence, so the
      check keys on the buffer's source, which the compiled HLO's ``copy``
      opcode said for the reference;
  (c) on ``paged_kernel``, no op that reads the pool allocates the
      (B, NB * page_size, Hkv, .) virtual cache of a layer's leaf, the
      buffer the block-table kernel exists to remove.

On the CPU (c) fires: the kernel's plain version gathers that buffer
(``kernels/paged_attn.py``), the tripwire baseline the reference gets
from its gather path.  On the card (c) is clean: the kernel allocates
no such buffer.  The CPU CLI leaves ``paged_kernel`` out of its default
programs and says so; asked for it explicitly, it reports the finding.
"""
from __future__ import annotations

from repro_torch.analysis.framework import Rule
from repro_torch.launch import opcount


def virtual_cache_sizes(prog) -> set:
    """Per-(layer, leaf) virtual-cache byte sizes of a paged program: the
    (B, NB*page_size, Hkv, .) buffer a page walk gathers from a pool leaf
    of (L, P, page_size, Hkv, .)."""
    eng = prog.engine
    n_layers = prog.cfg.num_layers
    scale = prog.batch * eng.max_blocks
    return {nb // (n_layers * eng.num_pages) * scale
            for nb in prog.cache_bytes}


def virtual_cache_traffic(prog) -> list:
    """Every op of ``prog`` that read the pool and allocated exactly a
    virtual-cache buffer, as (kind, line, bytes)."""
    sizes = virtual_cache_sizes(prog)
    lo = min(sizes)
    gathers = opcount.sized_gathers(prog.records, lo, prog.cache_storages)
    out = [("gather", line, nb) for line, nb in gathers if nb in sizes]
    out += [("copy", line, nb) for line, nb in opcount.sized_copies(
        prog.records, lo, prog.cache_storages)
        if nb in sizes and (line, nb) not in gathers]
    return out


class DonationAliasRule(Rule):
    rule_id = "R1"
    name = "donation-alias"
    description = ("every cache leaf is updated in place; no copy of a "
                   "cache leaf's size; no virtual cache on the kernel path")
    requires = "ops"

    def check(self, prog):
        findings = []
        for path, nb, b, a in zip(prog.cache_paths, prog.cache_bytes,
                                  prog.cache_ptrs_before,
                                  prog.cache_ptrs_after):
            if a != b:
                findings.append(self.finding(
                    prog.name,
                    f"cache leaf {path} ({nb} B) left its storage in the "
                    "step — a fresh buffer every step (paper C1 overhead)",
                    leaf=path, bytes=nb, check="a"))
        copies = opcount.sized_copies(prog.records, min(prog.cache_bytes),
                                      prog.cache_storages)
        if prog.copy_exact_sizes:
            sizes = set(prog.cache_bytes)
            copies = [c for c in copies if c[1] in sizes]
        for line, nb in copies:
            findings.append(self.finding(
                prog.name, f"cache-sized copy ({nb} B): {line[:120]}",
                bytes=nb, line=line, check="b"))
        if prog.variant == "paged_kernel":
            for kind, line, nb in virtual_cache_traffic(prog):
                findings.append(self.finding(
                    prog.name,
                    f"virtual-cache-sized {kind} ({nb} B) in the "
                    f"paged_kernel program — attention is materializing "
                    f"the (B, NB*page_size, Hkv, .) buffer the block-table "
                    f"kernel must avoid: {line[:120]}",
                    bytes=nb, line=line, check="c"))
        return findings
