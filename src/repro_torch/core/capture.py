"""Trace capture: record the request stream a *model* actually emits.

``TraceCapture`` is the controller's observability seam for application
traffic (ARCHITECTURE §13). While the lifecycle recorder
(``telemetry.TraceRecorder``) watches the modeled pipeline
from the inside (per-request lifecycle events during a
``simulate()`` run), ``TraceCapture`` watches the *data plane* from the
outside: every controller-routed model operation — embedding gather
(``mc_embed``), embedding-gradient scatter (``mc_scatter``), KV-page
append (``mc_kv_append``), MoE expert dispatch, audio/vision frontend
streaming — reports its ``(pe_id, row_id, rw, bytes, arrival)`` request
batch into the active recorder. The captured trace replays through
``MemoryController.simulate()`` / ``autotune.tune`` as a plain
``RequestStream``, which is what turns the repo's two synthetic
workloads into a per-architecture workload zoo (``data/model_traces.py``).

Contract (same rule the telemetry layer is property-tested under): with
no capture active, every hooked code path is bit-identical to the
unhooked one — recording never changes values, shapes or dtypes, only
observes them. Hooks are *lossy by design* under tracing: a tensor
without data (a meta tensor, or a fake tensor under ``torch.compile`` /
``FakeTensorMode``) cannot be read, so the record is skipped and counted
in ``n_skipped_traced``; capture runs are expected to execute the model
eagerly. A tensor on the card is copied to the host.

Address space: each traffic class registers a named *region* (an
``n_rows`` × ``row_bytes`` row range). Regions stack, so the embedding
table, KV pages, MoE token buffers and frontend streams occupy disjoint
row ranges of one flat address space — the same flattening an SoC memory
map performs — and reads and writes to the same logical structure (e.g.
``mc_embed`` + ``mc_scatter`` on the embedding table) land on the same
rows. Layers share a region when they share (name, shape): layer-k and
layer-k+1 KV appends to slot *s* hit the same row, modeling page reuse
within a decode step.

Counterpart of the reference's ``repro.core.capture``, where the tracer
test is a JAX one. ``MemoryController.capture`` records the controller's
own calls, and the MoE dispatch and SSM state-update hooks
(``models.blocks``) record into an active capture; the embedding, KV and
frontend hooks are ROADMAP A7.6.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np
import torch

DEFAULT_ROW_BYTES = 4096

# Stack of active recorders (innermost last). Module-level because the
# ``mc_*`` wrappers receive only a ``MemoryControllerConfig`` — there is
# no instance to hang the recorder on at the model call sites.
_ACTIVE: List["TraceCapture"] = []


def active_capture() -> Optional["TraceCapture"]:
    """The innermost active recorder, or None (capture disabled)."""
    return _ACTIVE[-1] if _ACTIVE else None


def is_concrete(x) -> bool:
    """True unless ``x`` is a torch tensor without data — a meta tensor or
    a fake tensor (no data copy — use to gate records whose row ids come
    from static shapes)."""
    if not isinstance(x, torch.Tensor):
        return True
    if x.device.type == "meta":
        return False
    from torch._subclasses.fake_tensor import is_fake
    return not is_fake(x)


def concrete(x) -> Optional[np.ndarray]:
    """``x`` as a host numpy array (a tensor on the card is copied), or
    None if it has no data (see :func:`is_concrete`)."""
    if isinstance(x, torch.Tensor):
        if not is_concrete(x):
            return None
        return x.detach().cpu().numpy()
    try:
        return np.asarray(x)
    except Exception:
        return None


@dataclasses.dataclass
class _Region:
    name: str
    base: int
    n_rows: int
    row_bytes: int


class TraceCapture:
    """Append-only recorder of model-emitted memory requests.

    Use as a context manager::

        with TraceCapture() as cap:
            lm.forward(params, batch)          # hooks report into cap
        res = MemoryController(cfg).simulate(*cap.replay_arrays(cfg.num_pes),
                                             capture_rows := ROW_BYTES)

    Requests recorded in one ``record`` call share an *arrival stamp*
    (the op ordinal — a logical clock in program order), the multi-port
    analogue of the serving workloads' same-stamp query bursts.
    """

    def __init__(self) -> None:
        self._regions: Dict[str, _Region] = {}
        self._next_row = 0
        self._pe: List[np.ndarray] = []
        self._row: List[np.ndarray] = []
        self._rw: List[np.ndarray] = []
        self._nbytes: List[np.ndarray] = []
        self._op: List[np.ndarray] = []
        self._arrival: List[np.ndarray] = []
        self.op_labels: List[str] = []
        self._op_index: Dict[str, int] = {}
        self.n_ops = 0                 # record() calls that landed
        self.n_skipped_traced = 0      # record() calls dropped on tracers

    # ---- context management -------------------------------------------------
    def __enter__(self) -> "TraceCapture":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        assert _ACTIVE and _ACTIVE[-1] is self, "unbalanced TraceCapture"
        _ACTIVE.pop()

    # ---- address regions ----------------------------------------------------
    def region(self, name: str, n_rows: int, row_bytes: int) -> int:
        """Register (or look up) a named address region; returns its base
        row. Re-registration must agree on the shape — two traffic classes
        may alias a region only by using the same name deliberately."""
        n_rows, row_bytes = int(n_rows), int(row_bytes)
        if n_rows <= 0 or row_bytes <= 0:
            raise ValueError(f"region {name!r}: need n_rows > 0 and "
                             f"row_bytes > 0, got {n_rows}x{row_bytes}")
        reg = self._regions.get(name)
        if reg is not None:
            if (reg.n_rows, reg.row_bytes) != (n_rows, row_bytes):
                raise ValueError(
                    f"region {name!r} re-registered with a different shape: "
                    f"{reg.n_rows}x{reg.row_bytes} vs {n_rows}x{row_bytes}")
            return reg.base
        reg = _Region(name, self._next_row, n_rows, row_bytes)
        self._regions[name] = reg
        self._next_row += n_rows
        return reg.base

    # ---- recording ----------------------------------------------------------
    def record(self, op: str, region_name: str, n_rows: int, row_bytes: int,
               row_ids, *, rw=0, pe_id=0, nbytes=None) -> bool:
        """Report one operation's request batch.

        ``row_ids`` are region-local (hooks never see the global map);
        ``rw``/``pe_id`` broadcast against them. Returns True if the batch
        was recorded, False if any value had no data (the call is
        skipped whole — a half-observed op would corrupt the stream — and
        counted in ``n_skipped_traced``)."""
        rows = concrete(row_ids)
        rwv = concrete(rw)
        pev = concrete(pe_id)
        if rows is None or rwv is None or pev is None:
            self.n_skipped_traced += 1
            return False
        rows = rows.astype(np.int64).reshape(-1)
        if rows.size == 0:
            return False
        base = self.region(region_name, n_rows, row_bytes)
        if rows.min() < 0 or rows.max() >= int(n_rows):
            raise ValueError(
                f"op {op!r}: row ids [{rows.min()}, {rows.max()}] outside "
                f"region {region_name!r} (0..{int(n_rows) - 1})")
        n = rows.size
        per_req = int(row_bytes) if nbytes is None else int(nbytes)
        oid = self._op_index.setdefault(op, len(self.op_labels))
        if oid == len(self.op_labels):
            self.op_labels.append(op)
        self._pe.append(np.broadcast_to(
            pev.astype(np.int64).reshape(-1), (n,)).copy())
        self._row.append(rows + base)
        self._rw.append(np.broadcast_to(
            rwv.astype(np.int32).reshape(-1), (n,)).copy())
        self._nbytes.append(np.full(n, per_req, np.int64))
        self._op.append(np.full(n, oid, np.int32))
        self._arrival.append(np.full(n, float(self.n_ops), np.float64))
        self.n_ops += 1
        return True

    def record_slice(self, op: str, region_name: str, n_rows: int,
                     row_bytes: int, start, length: int, *,
                     rw=1, pe_id=0) -> bool:
        """Record a contiguous ``[start, start+length)`` row run — the
        bulk/streaming request class (KV append, DMA tiles)."""
        s = concrete(start)
        if s is None:
            self.n_skipped_traced += 1
            return False
        # clamp exactly like the reference's lax.dynamic_update_slice —
        # the record must never fail where its data plane succeeds
        first = int(np.asarray(s).reshape(-1)[0])
        first = max(0, min(first, int(n_rows) - int(length)))
        return self.record(op, region_name, n_rows, row_bytes,
                           first + np.arange(int(length), dtype=np.int64),
                           rw=rw, pe_id=pe_id)

    # ---- views --------------------------------------------------------------
    def __len__(self) -> int:
        return int(sum(a.size for a in self._row))

    def _cat(self, chunks: List[np.ndarray], dtype) -> np.ndarray:
        if not chunks:
            return np.zeros(0, dtype)
        return np.concatenate(chunks).astype(dtype)

    def rows(self) -> Dict[str, np.ndarray]:
        """The captured columns as flat arrays (program order)."""
        return {
            "pe_id": self._cat(self._pe, np.int64),
            "row_id": self._cat(self._row, np.int64),
            "rw": self._cat(self._rw, np.int32),
            "nbytes": self._cat(self._nbytes, np.int64),
            "op": self._cat(self._op, np.int32),
            "arrival_cycle": self._cat(self._arrival, np.float64),
        }

    @property
    def n_rows_total(self) -> int:
        """Flat address-space height (rows) across all regions."""
        return self._next_row

    @property
    def n_ports(self) -> int:
        pe = self._cat(self._pe, np.int64)
        return int(pe.max()) + 1 if pe.size else 0

    def op_counts(self) -> Dict[str, int]:
        op = self._cat(self._op, np.int32)
        return {label: int((op == i).sum())
                for i, label in enumerate(self.op_labels)}

    def replay_arrays(self, num_ports: Optional[int] = None):
        """``(pe_id, row_ids, rw)`` for ``MemoryController.simulate``.

        Port ids are folded onto ``num_ports`` arbiter ports (experts and
        sequences map onto the controller's physical PEs round-robin).
        Closed-loop by construction: arrival stamps are *not* returned —
        feeding the logical op clock to ``simulate`` would flip it into
        open-loop serving mode and disable the cache/scheduler stages
        under test. Use ``rows()['arrival_cycle']`` explicitly for
        serving-mode replay."""
        r = self.rows()
        pe = r["pe_id"]
        if num_ports is not None:
            pe = pe % int(num_ports)
        return pe, r["row_id"], r["rw"]

    def as_request_stream(self, row_bytes: int = DEFAULT_ROW_BYTES,
                          num_ports: Optional[int] = None,
                          with_arrivals: bool = False):
        """Validated ``RequestStream`` of the captured trace.

        ``row_bytes`` is the replay granularity: the capture is
        row-indexed (per-request true transfer sizes live in
        ``rows()['nbytes']``), and the pipeline's address map prices every
        row at one fixed stride."""
        from repro_torch.core.pipeline import RequestStream
        r = self.rows()
        pe = r["pe_id"]
        if num_ports is not None:
            pe = pe % int(num_ports)
        return RequestStream.from_rows(
            r["row_id"], r["rw"], row_bytes=row_bytes, pe_id=pe,
            arrival_cycle=r["arrival_cycle"] if with_arrivals else None)

    # ---- on-disk format (tests/goldens/traces/*.json) -----------------------
    def to_dict(self) -> dict:
        r = self.rows()
        return {
            "version": 1,
            "regions": [dataclasses.asdict(reg) for reg in
                        sorted(self._regions.values(), key=lambda g: g.base)],
            "op_labels": list(self.op_labels),
            "n_ops": self.n_ops,
            "pe_id": r["pe_id"].tolist(),
            "row_id": r["row_id"].tolist(),
            "rw": r["rw"].tolist(),
            "nbytes": r["nbytes"].tolist(),
            "op": r["op"].tolist(),
            "arrival_cycle": r["arrival_cycle"].tolist(),
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=None, sort_keys=True,
                      separators=(",", ":"))
            f.write("\n")

    @classmethod
    def from_dict(cls, d: dict) -> "TraceCapture":
        if d.get("version") != 1:
            raise ValueError(f"unknown trace version {d.get('version')!r}")
        cap = cls()
        for reg in d["regions"]:
            base = cap.region(reg["name"], reg["n_rows"], reg["row_bytes"])
            if base != reg["base"]:
                raise ValueError(
                    f"region {reg['name']!r}: stored base {reg['base']} "
                    f"inconsistent with stacking order (got {base})")
        cap.op_labels = list(d["op_labels"])
        cap._op_index = {n: i for i, n in enumerate(cap.op_labels)}
        cap.n_ops = int(d["n_ops"])
        cap._pe = [np.asarray(d["pe_id"], np.int64)]
        cap._row = [np.asarray(d["row_id"], np.int64)]
        cap._rw = [np.asarray(d["rw"], np.int32)]
        cap._nbytes = [np.asarray(d["nbytes"], np.int64)]
        cap._op = [np.asarray(d["op"], np.int32)]
        cap._arrival = [np.asarray(d["arrival_cycle"], np.float64)]
        n = cap._row[0].size
        for k in ("_pe", "_rw", "_nbytes", "_op", "_arrival"):
            if getattr(cap, k)[0].size != n:
                raise ValueError(f"trace column {k[1:]!r} length mismatch")
        if n and cap._row[0].size:
            hi = cap.n_rows_total
            if cap._row[0].min() < 0 or (hi and cap._row[0].max() >= hi):
                raise ValueError("trace row ids outside the region map")
        return cap

    @classmethod
    def load(cls, path: str) -> "TraceCapture":
        with open(path) as f:
            return cls.from_dict(json.load(f))
