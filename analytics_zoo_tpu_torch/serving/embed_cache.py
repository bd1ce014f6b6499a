"""Host hot-row embedding cache for the serving path (port of
``analytics_zoo_tpu/serving/embed_cache.py``: ``EmbedCache`` is a copy;
``CachedEmbeddingModel`` keeps its tables as tensors on the card, gathers
the misses there with ``index_select``, and runs the dense tail through the
port's ``InferenceModel``, from CUDA graphs on the card).

Host hot-row embedding cache for the serving path.

Recsys traffic is zipf-skewed: a small set of hot users/items dominates
every request window.  Serving each request with a full device gather
re-fetches those same rows forever; the device round-trip — not the
tail MLP — is the per-request cost at high QPS.  ``EmbedCache`` keeps
the recently-served rows host-side in an LRU, so a request only touches
the device for ids nobody asked about recently.

Correctness across hot swaps: entries are keyed by
``(model, version, table, id)``, and ``attach()`` subscribes to
``ModelRegistry.on_swap`` / ``on_unload`` — the outgoing version's rows
are dropped at the flip, and the version in the key makes a stale hit
structurally impossible even before the invalidation runs (the new
adapter reads under the new version key).  The flip also FENCES the
outgoing version: the registry drains in-flight old-version batches
AFTER the swap hooks fire, so a batch completing mid-drain would
otherwise re-insert the rows the invalidation just dropped — fenced
inserts are refused instead (the batch's own reply is unaffected; only
the cache write is), and a version is unfenced if a later swap or
promotion makes it active again (rollback).

``CachedEmbeddingModel`` is the serving-model adapter tying it
together: one request row = ``[user_id | k candidate item ids]``; the
adapter dedups the batch's ids per table, consults the cache, gathers
only the misses from the device-resident table, runs the dense tail
(e.g. ``models.NCFTail``) on the assembled features, and replies with
the candidate ids ranked by P(positive) — raw event ids in, ranked
item ids out.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from .. import DeviceLike, resolve_device
from ..core import metrics as metrics_lib
from ..parallel.embedding import lookup_stats


class EmbedCache:
    """Thread-safe LRU over embedding rows, keyed
    ``(model, version, table, id)``.

    ``capacity`` counts ROWS (not bytes) — size it from row width:
    100k cached f32 rows at dim 64 is ~26 MB of host RAM.  Metrics
    (``embed.cache_hits`` / ``embed.cache_misses`` /
    ``embed.cache_evictions`` counters and the ``embed.cache_size``
    gauge) land in the given registry so hit rate is assertable from
    telemetry, not inferred from wall clock."""

    def __init__(self, capacity: int = 100_000,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._rows: "OrderedDict[Tuple[str, str, str, int], np.ndarray]" \
            = OrderedDict()
        reg = metrics or metrics_lib.get_registry()
        self._m_hits = reg.counter("embed.cache_hits")
        self._m_misses = reg.counter("embed.cache_misses")
        self._m_evict = reg.counter("embed.cache_evictions")
        self._m_size = reg.gauge("embed.cache_size")
        self._m_fenced = reg.counter("embed.cache_fenced_inserts")
        self._fenced: set = set()  # {(model, version)} retired by swap
        self._registries: List[Any] = []

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def lookup(self, model: str, version: str, table: str,
               ids: Sequence[int]
               ) -> Tuple[Dict[int, np.ndarray], List[int]]:
        """One batched consult: ``({id: row} for the hits, [missing
        ids])``.  Hits are refreshed to most-recently-used."""
        hits: Dict[int, np.ndarray] = {}
        missing: List[int] = []
        with self._lock:
            for i in ids:
                key = (model, version, table, int(i))
                row = self._rows.get(key)
                if row is None:
                    missing.append(int(i))
                else:
                    self._rows.move_to_end(key)
                    hits[int(i)] = row
        self._m_hits.inc(len(hits))
        self._m_misses.inc(len(missing))
        return hits, missing

    def insert(self, model: str, version: str, table: str,
               ids: Sequence[int], rows: np.ndarray) -> None:
        """Cache freshly-gathered ``rows`` (``[len(ids), dim]``),
        evicting least-recently-used entries beyond ``capacity``.
        Inserts for a fenced (swapped-out) version are refused — an
        in-flight batch finishing during the post-flip drain must not
        resurrect rows the swap invalidation already dropped."""
        evicted = 0
        with self._lock:
            if (model, str(version)) in self._fenced:
                self._m_fenced.inc(len(ids))
                return
            for i, row in zip(ids, np.asarray(rows)):
                self._rows[(model, version, table, int(i))] = row
                self._rows.move_to_end((model, version, table, int(i)))
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)
                evicted += 1
            size = len(self._rows)
        if evicted:
            self._m_evict.inc(evicted)
        self._m_size.set(size)

    def invalidate(self, model: Optional[str] = None,
                   version: Optional[str] = None) -> int:
        """Drop every row of ``(model, version)`` — or of all versions
        of ``model``, or the whole cache with no arguments.  Returns the
        number of rows dropped."""
        with self._lock:
            if model is None:
                dropped = len(self._rows)
                self._rows.clear()
            else:
                doomed = [k for k in self._rows
                          if k[0] == model
                          and (version is None or k[1] == str(version))]
                for k in doomed:
                    del self._rows[k]
                dropped = len(doomed)
            size = len(self._rows)
        self._m_size.set(size)
        return dropped

    # -- registry wiring ------------------------------------------------------

    def attach(self, registry: Any) -> "EmbedCache":
        """Subscribe invalidation to a ``ModelRegistry``: a hot swap
        drops the outgoing version's rows at the flip, an unload drops
        the unloaded version's."""
        registry.on_swap(self._on_swap)
        registry.on_unload(self._on_unload)
        self._registries.append(registry)
        return self

    def detach(self, registry: Any) -> None:
        registry.off_swap(self._on_swap)
        registry.off_unload(self._on_unload)
        try:
            self._registries.remove(registry)
        except ValueError:
            pass

    def _on_swap(self, name: str, old_version: Optional[str],
                 new_version: str) -> None:
        with self._lock:
            # a rollback re-activating a fenced version reopens it
            self._fenced.discard((name, str(new_version)))
            if old_version is not None and old_version != new_version:
                self._fenced.add((name, str(old_version)))
        if old_version is not None and old_version != new_version:
            self.invalidate(name, old_version)

    def _on_unload(self, name: str, version: str) -> None:
        with self._lock:
            self._fenced.add((name, str(version)))
        self.invalidate(name, version)


class CachedEmbeddingModel:
    """Serving-model adapter: cached/deduped embedding lookup + dense
    tail + top-k ranking, speaking the ``predict(x) -> np.ndarray``
    protocol ``ClusterServing`` batches against.

    One request row is ``[user_id, item_1, ..., item_k]`` (int); the
    reply row is those k candidate ids ranked by P(positive), best
    first.  ``tables`` maps table name → host ``[rows, dim]`` array (kept
    on ``device``, ``None``: the card);
    ``columns`` declares, in tail-input order, which id each table
    gathers (``"user"`` or ``"item"``) — for NCF both come straight from
    ``NeuralCF.serving_split`` / ``embedding_columns``.

    Per batch and per table the adapter dedups ids BEFORE any fetch
    (``embed.gather_rows`` vs ``embed.gather_rows_naive`` meter the
    win), consults the cache, and gathers only the misses from the
    device-resident table."""

    concurrent_num = 4

    def __init__(self, tables: Dict[str, np.ndarray],
                 columns: Sequence[Tuple[str, str]], tail: Any,
                 cache: Optional[EmbedCache] = None,
                 model_name: str = "recsys", version: str = "v1",
                 metrics: Optional[metrics_lib.MetricsRegistry] = None,
                 device: DeviceLike = None):
        bad = [w for _, w in columns if w not in ("user", "item")]
        if bad:
            raise ValueError(f"columns must gather 'user' or 'item', "
                             f"got {bad}")
        self.device = resolve_device(device)
        # device-resident tables: the miss path gathers from these
        self._tables = {name: torch.tensor(np.asarray(t), device=self.device)
                        for name, t in tables.items()}
        self._dims = {name: int(t.shape[-1]) for name, t in
                      tables.items()}
        self.columns = list(columns)
        self.tail = tail
        self.cache = cache
        self.model_name = str(model_name)
        self.version = str(version)
        self._metrics = metrics or metrics_lib.get_registry()
        self._lock = threading.Lock()

    def warm_from(self, other: Any) -> int:
        """Hot-swap warming: forward to the tail when both sides have
        one (the tail holds the executables; tables are data)."""
        tail_other = getattr(other, "tail", other)
        if hasattr(self.tail, "warm_from"):
            return self.tail.warm_from(tail_other)
        return 0

    def _gather(self, table: str, ids: Any) -> np.ndarray:
        """Rows ``ids`` of a table, gathered on its device, to the host."""
        idx = torch.as_tensor(np.asarray(ids, np.int64)).to(self.device)
        return self._tables[table].index_select(0, idx).cpu().numpy()

    def _rows_for(self, table: str, ids: np.ndarray) -> np.ndarray:
        """``[len(ids), dim]`` rows for already-DEDUPED ids: cache
        first, device gather for the misses only."""
        if self.cache is None:
            return self._gather(table, ids)
        hits, missing = self.cache.lookup(self.model_name, self.version,
                                          table, ids)
        if missing:
            fetched = self._gather(table, missing)
            self.cache.insert(self.model_name, self.version, table,
                              missing, fetched)
            hits.update(zip(missing, fetched))
        return np.stack([hits[int(i)] for i in ids])

    def predict(self, x: np.ndarray) -> np.ndarray:
        """``x``: int ``[B, 1 + k]`` rows of ``[user | k items]``;
        returns int32 ``[B, k]`` — each row's candidates ranked by
        P(positive), best first."""
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] < 2:
            raise ValueError(
                f"expected [B, 1 + k] rows of [user | k items], got "
                f"shape {x.shape}")
        users = x[:, 0].astype(np.int64)
        items = x[:, 1:].astype(np.int64)   # [B, k]
        b, k = items.shape
        flat_items = items.reshape(-1)      # [B*k]
        pair_users = np.repeat(users, k)    # [B*k]

        # per-table dedup + fetch; parts assemble in tail-input order
        parts = []
        with self._lock:
            for table, which in self.columns:
                ids = pair_users if which == "user" else flat_items
                uniq, inv = np.unique(ids, return_inverse=True)
                lookup_stats(ids, self._dims[table],
                             metrics=self._metrics)
                rows = self._rows_for(table, uniq)
                parts.append(rows[inv])
        feats = np.concatenate(parts, axis=1).astype(np.float32)

        logits = np.asarray(self.tail.predict(feats))  # [B*k, classes]
        # rank by P(positive) = 1 - P(class 0) (models/recommendation's
        # _recommend convention), stable within a request
        z = logits - logits.max(axis=-1, keepdims=True)
        p = np.exp(z)
        pos = 1.0 - p[:, 0] / p.sum(axis=-1)
        order = np.argsort(-pos.reshape(b, k), axis=1, kind="stable")
        return np.take_along_axis(items, order, axis=1).astype(np.int32)
