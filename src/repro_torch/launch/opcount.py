"""Op-stream facts of one step: the port's counterpart of the JAX
package's ``launch/hlo.py``.

The JAX package reads what XLA compiled: it parses HLO text for FLOPs,
bytes, copies, gathers and collectives, with while-loop trip counts.  The
port runs eagerly, so the same facts are counted from the stream of aten
ops a step dispatches, seen through a ``TorchDispatchMode``
(``capture``).  Every op is one record (``OpRecord``): its name, its
outputs' shapes, dtypes and bytes, the bytes of the storages it
allocated, whether it wrote in place or returned a view, the storages of
its outputs and the serials of its operand and output tensors (the
dataflow R5 walks).  A loop over layers is unrolled in the stream, so no
trip count is needed.  On top of the records, the reference's functions:

  ``analyze``          <- ``hlo.analyze``: ``Totals`` with the reference's
                          field names (``flops``, ``bytes``, ``hbm_bytes``,
                          ``convert_bytes``, ``coll``, ``collective_bytes``)
  ``breakdown``        <- ``hlo.breakdown``: the top byte movers
  ``sized_copies``     <- ``hlo.sized_copies``: every op that allocated a
                          buffer of at least a size (in eager PyTorch every
                          allocation is a materialised buffer)
  ``sized_gathers``    <- ``hlo.sized_gathers``: the same, for the gather
                          and index ops
  ``collective_ops``   <- ``hlo.collective_ops``: the collectives, each with
                          its result bytes

FLOPs are ``torch.utils.flop_counter``'s: each op's formula from the
registry ``FlopCounterMode`` reads (``flop_registry``).  A hand-written
kernel is a ctypes launch no dispatch mode sees, so on a meta tensor its
wrapper books the kernel's output, FLOPs and bytes itself
(``book_kernel``, ``kernels/cost.py``).  The collectives of
``core/collectives.py`` book themselves too (``book_collective``), by the
HLO kind names ``mesh.bytes`` keys.

Beside the records a capture keeps the peak of the live bytes of the
storages allocated inside it (each counted from the op that created it
until it is freed): the dry-run's ``temp_bytes``.

What has no counterpart: ``hlo.input_output_alias_pairs`` (aliasing is
storage identity here, which R1 reads from the cache leaves before and
after the step), the trip-count parser (the stream is unrolled) and the
dry-run's ``cpu_upcast_bytes`` (no backend rewrites a program here).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

# ops that allocate and move nothing, or only read metadata
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "empty_like", "detach",
                         "lift_fresh", "alias", "_local_scalar_dense"})
_CONVERTS = frozenset({"_to_copy", "to", "_to_copy.default"})
# ops whose result is rows picked from an operand by an index
GATHERS = frozenset({"index", "gather", "index_select", "embedding",
                     "take", "take_along_dim"})

_ACTIVE: list = []


@dataclasses.dataclass(frozen=True)
class OpRecord:
    name: str              # aten op ("mm"), "kernel.<name>", "coll.<kind>"
    out_shapes: tuple
    out_dtypes: tuple
    out_bytes: int         # bytes of every output tensor
    new_bytes: tuple       # bytes of each storage the op allocated
    in_bytes: int          # bytes of every tensor operand
    inplace: bool
    view: bool
    storages: tuple        # storage keys of the outputs
    in_storages: tuple     # storage keys of the operands
    inputs: tuple          # tensor serials of the operands
    outputs: tuple         # tensor serials of the outputs
    flops: float = 0.0

    @property
    def line(self) -> str:
        """The record as one line, the HLO instruction's stand-in."""
        outs = ", ".join(f"{str(d).replace('torch.', '')}{list(s)}"
                         for s, d in zip(self.out_shapes, self.out_dtypes))
        return f"{self.name} -> {outs}"


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (nested in tuples,
    lists and dicts), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


class Capture(TorchDispatchMode):
    """The records of everything dispatched while the mode is active.
    ``records``: the ``OpRecord``s in order; ``peak_bytes``: the peak of
    the live bytes of storages created inside the capture; ``watched``:
    the serials of the tensors handed to ``capture(watch=)``."""

    def __init__(self, watch=()):
        super().__init__()
        self.records: list[OpRecord] = []
        self._serials = WeakTensorKeyDictionary()
        self._next = 0
        self._live: dict = {}          # key -> (weakref, nbytes, created)
        self._current = 0
        self.peak_bytes = 0
        self.watched = [self.serial(t) for t in watch]
        self.result = None

    # -- tensor and storage identity ----------------------------------------

    def serial(self, t: torch.Tensor) -> int:
        s = self._serials.get(t)
        if s is None:
            s = self._serials[t] = self._next
            self._next += 1
        return s

    def _sweep(self) -> None:
        dead = [k for k, (ref, _, _) in self._live.items() if ref.expired()]
        for k in dead:
            _, nb, created = self._live.pop(k)
            if created:
                self._current -= nb

    def _see(self, t: torch.Tensor, created: bool) -> tuple:
        """(storage key, bytes the storage newly adds).  ``_current``
        counts frees only at a sweep, so between sweeps it can only
        overstate the live bytes; a sweep runs whenever it would set a
        new peak, which keeps ``peak_bytes`` exact."""
        st = _storage(t)
        if st is None:
            return None, 0
        key = st._cdata
        ent = self._live.get(key)
        if ent is not None and not ent[0].expired():
            return key, 0
        if ent is not None:
            # a freed storage's key reused: settle the old one first
            _, nb, was_created = self._live.pop(key)
            if was_created:
                self._current -= nb
        nb = st.nbytes()
        self._live[key] = (StorageWeakRef(st), nb, created)
        if not created:
            return key, 0
        self._current += nb
        if self._current > self.peak_bytes:
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self._current)
        return key, nb

    @property
    def live_bytes(self) -> int:
        self._sweep()
        return self._current

    # -- recording ------------------------------------------------------------

    def record(self, name: str, args, outs, *, inplace=False, view=False,
               flops: float = 0.0) -> OpRecord:
        ins = _tensors(args, [])
        outs = _tensors(outs, [])
        in_keys = tuple(self._see(a, created=False)[0] for a in ins)
        keys, new = [], []
        for o in outs:
            key, nb = self._see(o, created=not (inplace or view))
            keys.append(key)
            if nb:
                new.append(nb)
        rec = OpRecord(
            name=name, out_shapes=tuple(tuple(o.shape) for o in outs),
            out_dtypes=tuple(o.dtype for o in outs),
            out_bytes=sum(_nbytes(o) for o in outs), new_bytes=tuple(new),
            in_bytes=sum(_nbytes(a) for a in ins), inplace=inplace,
            view=view, storages=tuple(keys), in_storages=in_keys,
            inputs=tuple(self.serial(a) for a in ins),
            outputs=tuple(self.serial(o) for o in outs), flops=float(flops))
        self.records.append(rec)
        return rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        flops = 0.0
        if packet in flop_counter.flop_registry:
            flops = flop_counter.flop_registry[packet](*args, **kwargs,
                                                       out_val=out)
        schema = func._schema
        inplace = any(a.alias_info is not None and a.alias_info.is_write
                      for a in schema.arguments)
        self.record(packet.__name__, (args, kwargs), out, inplace=inplace,
                    view=func.is_view, flops=flops)
        return out


def active() -> Capture | None:
    """The innermost capture in progress, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def capture(fn, *args, watch=(), **kwargs) -> Capture:
    """Run ``fn(*args, **kwargs)`` under a fresh ``Capture`` and return
    it (``.result`` holds what ``fn`` returned).  ``watch``: tensors whose
    serials are fixed first, in order (``Capture.watched``)."""
    cap = Capture(watch)
    _ACTIVE.append(cap)
    try:
        with cap:
            cap.result = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return cap


def book_kernel(name: str, args, out, flops: float, nbytes: float) -> None:
    """A hand-written kernel's launch as a record of the active capture
    (the wrapper calls this on a meta tensor): its operands, its output,
    its FLOPs and the bytes it must move."""
    cap = active()
    if cap is None:
        return
    rec = cap.record(f"kernel.{name}", args, out, flops=flops)
    cap.records[-1] = dataclasses.replace(
        rec, in_bytes=int(nbytes) - rec.out_bytes)


def book_collective(kind: str, x: torch.Tensor, out_bytes: int) -> None:
    """A collective of ``core/collectives`` as a record of the active
    capture: its operand, the bytes of its result, its kind."""
    cap = active()
    if cap is None:
        return
    cap.records.append(OpRecord(
        name=f"coll.{kind}", out_shapes=(), out_dtypes=(x.dtype,),
        out_bytes=int(out_bytes), new_bytes=(), in_bytes=_nbytes(x),
        inplace=False, view=False, storages=(), in_storages=(),
        inputs=(cap.serial(x),), outputs=()))


# ---------------------------------------------------------------------------
# the reference's functions over records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    hbm_bytes: float = 0.0
    convert_bytes: float = 0.0
    coll: dict = dataclasses.field(default_factory=lambda: defaultdict(float))

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll.values()))


def _traffic(rec: OpRecord) -> int:
    """Bytes an op moves through device memory: its operands read and
    its outputs written; views, allocations without a write and
    collectives (counted apart) move none, an in-place op's result is its
    operand."""
    if (rec.view or rec.name in _NO_TRAFFIC
            or rec.name.startswith("coll.")):
        return 0
    return rec.in_bytes + (0 if rec.inplace else rec.out_bytes)


def analyze(records) -> Totals:
    t = Totals()
    for rec in records:
        if rec.name.startswith("coll."):
            t.coll[rec.name[5:]] += rec.in_bytes
            continue
        t.flops += rec.flops
        moved = _traffic(rec)
        t.bytes += rec.in_bytes + rec.out_bytes
        t.hbm_bytes += moved
        if rec.name in _CONVERTS:
            t.convert_bytes += moved
    return t


def breakdown(records, top: int = 20) -> list[tuple[str, float, float]]:
    """The top device-memory movers as (op@dtype[shape], bytes, flops)."""
    agg: dict = {}
    for rec in records:
        key = rec.name + "@" + (
            f"{str(rec.out_dtypes[0]).replace('torch.', '')}"
            f"{list(rec.out_shapes[0])}" if rec.out_shapes else "?")
        d = agg.setdefault(key, [0.0, 0.0])
        d[0] += _traffic(rec)
        d[1] += rec.flops
    ranked = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    return [(k, v[0], v[1]) for k, v in ranked]


def sized_copies(records, min_bytes: int,
                 reading=None) -> list[tuple[str, int]]:
    """Every buffer of at least ``min_bytes`` an op allocated, as (the
    op's line, the buffer's bytes); with ``reading`` (storage keys) only
    the ops that read one of those storages: a copy OF them."""
    return [(rec.line, nb) for rec in records for nb in rec.new_bytes
            if nb >= min_bytes and (reading is None or set(
                rec.in_storages) & set(reading))]


def sized_gathers(records, min_bytes: int,
                  reading=None) -> list[tuple[str, int]]:
    """The same for the ops that pick rows by an index (``GATHERS``)."""
    return sized_copies([r for r in records if r.name in GATHERS],
                        min_bytes, reading)


def collective_ops(records) -> list[tuple[str, int, str]]:
    """Every collective as (kind, result bytes, line)."""
    return [(rec.name[5:], rec.out_bytes, rec.line) for rec in records
            if rec.name.startswith("coll.")]

