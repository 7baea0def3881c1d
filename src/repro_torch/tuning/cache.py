"""Persistent kernel-tuning cache.

Counterpart of ``repro/tuning/cache.py``, with its keys, entries, JSON
schema 1 and encoding: a file maps a ``KernelKey`` (kernel, shape,
dtype, backend) to the winning launch configuration and its measured
time. The port's keys carry the backend ``"cuda"`` (the hand-written
kernels on the card) or ``"cpu"`` (their plain versions), so an entry
that the reference wrote for ``"xla"`` or ``"pallas"`` loads but never
matches a key the port looks up: TPU times never steer H100 launches.

- **Graceful degradation** — a missing, corrupt, or stale (schema
  mismatch) cache file loads as an *empty* cache whose ``load_error``
  says why; every consumer then keeps its heuristic defaults, so tuning
  is an overlay, never a dependency.
- **Determinism** — ``save()`` writes sorted keys with a fixed layout,
  so cache files round-trip byte-for-byte.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

SCHEMA_VERSION = 1

_KEY_SEP = "|"


@dataclasses.dataclass(frozen=True)
class KernelKey:
    """Identity of one tuning problem.

    ``shape`` is the kernel's *logical* problem shape (the one the
    deploy pipeline emits), not the padded launch shape — both the
    autotuner and ``kernel_opt`` derive it the same way so keys agree.
    """
    kernel: str               # 'fused_dense' | 'gravnet' | 'flash_attention'
    shape: tuple[int, ...]
    dtype: str                # 'float32' | 'bf16' | 'int8' | ...
    backend: str              # 'cuda' | 'cpu' (reference: 'xla', 'pallas')

    def encode(self) -> str:
        dims = "x".join(str(d) for d in self.shape)
        return _KEY_SEP.join((self.kernel, dims, self.dtype, self.backend))

    @classmethod
    def decode(cls, s: str) -> "KernelKey":
        kernel, dims, dtype, backend = s.split(_KEY_SEP)
        shape = tuple(int(d) for d in dims.split("x")) if dims else ()
        return cls(kernel, shape, dtype, backend)


def fused_dense_key(rows: int, d_in: int, d_out: int, dtype: str,
                    backend: str) -> KernelKey:
    """Dense kernels row-pack micro-batches, so the batch/bucket
    dimensions fold into ``rows``: a batch-packed bucket executable
    keys with rows = microbatch × bucket_n_hits (see
    ``kernel_opt.fused_dense_shape``)."""
    return KernelKey("fused_dense", (rows, d_in, d_out), dtype, backend)


def gravnet_key(n: int, d_s: int, d_f: int, k: int, dtype: str,
                backend: str, batch: int = 1) -> KernelKey:
    """``n`` is the per-event graph size (= the occupancy bucket);
    ``batch`` the packed micro-batch width of the batched kernel's
    leading event grid dimension. ``batch=1`` keeps the legacy 4-dim
    shape so existing caches and per-event lookups stay hits."""
    if batch > 1:
        return KernelKey("gravnet", (batch, n, d_s, d_f, k), dtype, backend)
    return KernelKey("gravnet", (n, d_s, d_f, k), dtype, backend)


def gravnet_block_key(n: int, d_hidden: int, d_f: int, k: int, dtype: str,
                      backend: str, batch: int = 1) -> KernelKey:
    """Key for the fused GravNet-block megakernel. Mirrors
    ``gravnet_key``: ``n`` is the per-event graph size (= the occupancy
    bucket), ``batch`` the leading event grid dimension of a
    batch-packed executable — 5-dim shape when batched, 4-dim
    per-event. ``d_hidden`` (the x operand width) and ``d_f`` pin the
    prologue and (with ``concat_x``) the epilogue K; the remaining
    block dims (d_s, d_out) ride along inside the cached config so
    warm-up can replay the exact problem."""
    if batch > 1:
        return KernelKey("gravnet_block", (batch, n, d_hidden, d_f, k),
                         dtype, backend)
    return KernelKey("gravnet_block", (n, d_hidden, d_f, k), dtype, backend)


def gravnet_block_int8_key(n: int, d_hidden: int, d_f: int, k: int,
                           backend: str, batch: int = 1) -> KernelKey:
    """Key for the *quantized* GravNet-block megakernel — a distinct
    kernel family (``gravnet_block_int8|…|int8|backend``), not a dtype
    variation of the f32 key: the int8 kernel has its own launch
    surface (per-channel scale operands, baked requant constants) and
    its own candidate space, so winners must never cross-pollinate.
    Shape layout mirrors ``gravnet_block_key`` (5-dim batched, 4-dim
    per-event)."""
    if batch > 1:
        return KernelKey("gravnet_block_int8",
                         (batch, n, d_hidden, d_f, k), "int8", backend)
    return KernelKey("gravnet_block_int8", (n, d_hidden, d_f, k), "int8",
                     backend)


def edge_aggregate_key(n: int, e: int, d: int, dtype: str, backend: str,
                       batch: int = 1) -> KernelKey:
    """Key for the edge-aggregation (segment-sum/mean) kernel. ``n`` is
    the per-event node count, ``e`` the padded edge count, ``d`` the
    message feature width. Mirrors ``gravnet_key``: ``batch`` prepends
    the packed micro-batch width (5-dim shape) while ``batch=1`` keeps
    the per-event 3-dim shape."""
    if batch > 1:
        return KernelKey("edge_aggregate", (batch, n, e, d), dtype, backend)
    return KernelKey("edge_aggregate", (n, e, d), dtype, backend)


def flash_attention_key(bh: int, s: int, t: int, d: int, dtype: str,
                        backend: str) -> KernelKey:
    return KernelKey("flash_attention", (bh, s, t, d), dtype, backend)


def knn_build_key(n: int, d_s: int, k: int, dtype: str, backend: str,
                  batch: int = 1) -> KernelKey:
    """Key for the ragged-path neighbor-selection kernel. ``n`` is the
    packed bin capacity (= the detector's n_hits), ``batch`` the bin
    count of the batched launch. Mirrors ``gravnet_key``: 4-dim shape
    batched, 3-dim per-bin."""
    if batch > 1:
        return KernelKey("knn_build", (batch, n, d_s, k), dtype, backend)
    return KernelKey("knn_build", (n, d_s, k), dtype, backend)


def knn_aggregate_key(n: int, d_f: int, k: int, dtype: str, backend: str,
                      batch: int = 1) -> KernelKey:
    """Key for the ragged-path aggregation kernel (same shape layout as
    ``knn_build_key``)."""
    if batch > 1:
        return KernelKey("knn_aggregate", (batch, n, d_f, k), dtype,
                         backend)
    return KernelKey("knn_aggregate", (n, d_f, k), dtype, backend)


@dataclasses.dataclass
class TuningEntry:
    """One cached winner: the launch config plus search provenance."""
    config: dict
    us: float | None = None          # measured microseconds of the winner
    default_us: float | None = None  # the heuristic default's time
    candidates: int = 0              # how many configs were searched

    def to_json(self) -> dict:
        return {"config": dict(self.config), "us": self.us,
                "default_us": self.default_us,
                "candidates": self.candidates}

    @classmethod
    def from_json(cls, d: dict) -> "TuningEntry":
        return cls(config=dict(d["config"]), us=d.get("us"),
                   default_us=d.get("default_us"),
                   candidates=int(d.get("candidates", 0)))


class TuningCache:
    """In-memory view of the JSON tuning cache.

    ``lookup`` returns the winning config dict for a key, or ``None``
    (cache miss → caller keeps its heuristic default). ``put`` +
    ``save`` persist new winners.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = None if path is None else os.fspath(path)
        self._entries: dict[KernelKey, TuningEntry] = {}
        self.load_error: str | None = None   # why the file was ignored

    # ------------------------------------------------------------- I/O ----
    @classmethod
    def load(cls, path: str | os.PathLike) -> "TuningCache":
        """Load a cache file; any problem yields an *empty* cache whose
        ``load_error`` says why (missing file is not an error)."""
        cache = cls(path)
        p = os.fspath(path)
        if not os.path.exists(p):
            return cache
        try:
            with open(p) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            cache.load_error = f"unreadable tuning cache {p}: {e}"
            return cache
        if not isinstance(raw, dict):
            cache.load_error = f"tuning cache {p} is not a JSON object"
            return cache
        if raw.get("schema") != SCHEMA_VERSION:
            cache.load_error = (
                f"tuning cache {p} has schema {raw.get('schema')!r}, "
                f"expected {SCHEMA_VERSION} (stale — ignored)")
            return cache
        entries = raw.get("entries", {})
        if not isinstance(entries, dict):
            cache.load_error = f"tuning cache {p}: 'entries' is not a dict"
            return cache
        for enc, body in entries.items():
            try:
                key = KernelKey.decode(enc)
                entry = TuningEntry.from_json(body)
            except (ValueError, KeyError, TypeError, AttributeError):
                # one malformed entry does not poison the rest
                continue
            cache._entries[key] = entry
        return cache

    def save(self, path: str | os.PathLike | None = None) -> str:
        p = os.fspath(path) if path is not None else self.path
        if p is None:
            raise ValueError("TuningCache.save: no path given")
        payload = {
            "schema": SCHEMA_VERSION,
            "entries": {k.encode(): e.to_json()
                        for k, e in sorted(self._entries.items(),
                                           key=lambda kv: kv[0].encode())},
        }
        # atomic replace: a crashed writer never leaves a torn file for
        # the graceful-degradation path to reject
        d = os.path.dirname(os.path.abspath(p)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tuning_cache_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, p)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self.path = p
        return p

    # ----------------------------------------------------------- access ----
    def lookup(self, key: KernelKey) -> dict | None:
        e = self._entries.get(key)
        return None if e is None else e.config

    def entry(self, key: KernelKey) -> TuningEntry | None:
        return self._entries.get(key)

    def put(self, key: KernelKey, config: dict, *, us: float | None = None,
            default_us: float | None = None, candidates: int = 0) -> None:
        self._entries[key] = TuningEntry(config=dict(config), us=us,
                                         default_us=default_us,
                                         candidates=candidates)

    def entries(self) -> dict[KernelKey, TuningEntry]:
        return dict(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: KernelKey) -> bool:
        return key in self._entries

    def __bool__(self) -> bool:   # empty caches are still real caches
        return True
