"""Staleness-controlled feature cache for serving.

Training already tolerates bounded staleness in halo exchange (the
delayed-communication cd>1 schedule refreshes remote partials every cd
epochs). Serving reuses the same contract on the *input features*: each
server partition owns the authoritative rows for its nodes and keeps a
cache of remote rows, each stamped with the feature-store version at
which it was fetched. A cached row may answer a request while

    version_now - fetched_version <= max_staleness

and must be re-fetched otherwise. ``max_staleness=0`` is strict
read-your-writes (every remote read hits the store); larger values trade
freshness for fetch traffic, exactly the cd knob.

The store itself is in-process here (one NumPy array), so "fetch" is a
row copy — the point of the class is the *policy* and its observability
(hit/miss/refresh/age counters, asserted by the staleness-bound test and
exported into ``BENCH_serving.json``), not RPC plumbing.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np


class FeatureCache:
    """Per-partition feature view: authoritative local rows + a bounded-
    staleness cache of remote rows.

    ``store`` is the [N, F] feature array (shared, authoritative),
    ``part`` the [N] partition labels, ``home`` this server's partition.
    ``version`` advances via :meth:`tick` / :meth:`update_features`; a
    cached remote row whose age exceeds ``max_staleness`` is refreshed on
    access, and :meth:`refresh` sweeps the whole cache between batches
    (the background refresh of the delayed-comm schedule).
    """

    def __init__(self, store: np.ndarray, part: np.ndarray, home: int,
                 max_staleness: int = 0):
        if max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        self.store = store
        self.part = np.asarray(part)
        self.home = int(home)
        self.max_staleness = int(max_staleness)
        self.version = 0
        # global id -> (row copy, fetched_version)
        self._rows: Dict[int, np.ndarray] = {}
        self._fetched: Dict[int, int] = {}
        self.hits = 0
        self.misses = 0
        self.refreshes = 0
        self.local_reads = 0
        self.max_age_served = 0

    # -- store mutation ----------------------------------------------------

    def tick(self) -> int:
        """Advance the feature-store version (external writers moved on)."""
        self.version += 1
        return self.version

    def update_features(self, ids: Iterable[int],
                        rows: np.ndarray) -> int:
        """Write new feature rows into the store and advance the version."""
        ids = np.asarray(list(ids), dtype=np.int64)
        self.store[ids] = rows
        return self.tick()

    # -- reads -------------------------------------------------------------

    def _fetch(self, gid: int) -> np.ndarray:
        # Copy, never alias: the cache must keep serving the *fetched*
        # value even after the store row is overwritten, or age accounting
        # would be meaningless.
        row = np.array(self.store[gid])
        self._rows[gid] = row
        self._fetched[gid] = self.version
        return row

    def get_row(self, gid: int) -> np.ndarray:
        gid = int(gid)
        if self.part[gid] == self.home:
            self.local_reads += 1
            return self.store[gid]
        if gid in self._rows:
            age = self.version - self._fetched[gid]
            if age <= self.max_staleness:
                self.hits += 1
                self.max_age_served = max(self.max_age_served, age)
                return self._rows[gid]
            self.refreshes += 1
            return self._fetch(gid)
        self.misses += 1
        return self._fetch(gid)

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """Fetch feature rows for ``ids`` under the staleness policy."""
        return np.stack([self.get_row(g) for g in np.asarray(ids)])

    # -- maintenance -------------------------------------------------------

    def refresh(self, force: bool = False) -> int:
        """Background sweep: re-fetch every cached row that is (or with
        ``force`` merely could become) stale. Returns rows refreshed."""
        n = 0
        for gid in list(self._rows):
            age = self.version - self._fetched[gid]
            if force or age > self.max_staleness:
                self._fetch(gid)
                self.refreshes += 1
                n += 1
        return n

    def clear(self) -> None:
        """Drop every cached remote row (counters keep accumulating) —
        returns the cache to cold without rebuilding the server."""
        self._rows.clear()
        self._fetched.clear()

    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "refreshes": self.refreshes,
            "local_reads": self.local_reads,
            "max_age_served": self.max_age_served,
            "cached_rows": len(self._rows),
            "version": self.version,
            "max_staleness": self.max_staleness,
        }
