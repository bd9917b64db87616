"""Minimum Vertex Cover on bipartite graphs (paper §5.3).

König's theorem: in a bipartite graph, |minimum vertex cover| = |maximum
matching|, and the cover is recoverable from a maximum matching via
alternating-path reachability. Maximum matching via Hopcroft–Karp
(O(E sqrt(V)), the algorithm the paper cites [27]).

The paper optimizes NetworkX's implementation for preprocessing speed
(§7.2); here the array-based Hopcroft–Karp below plays that role.
"""

from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

INF = np.iinfo(np.int64).max


def _build_adj(nu: int, edges_u: np.ndarray, edges_v: np.ndarray) -> List[np.ndarray]:
    order = np.argsort(edges_u, kind="stable")
    eu, ev = edges_u[order], edges_v[order]
    starts = np.searchsorted(eu, np.arange(nu + 1))
    return [ev[starts[u]:starts[u + 1]] for u in range(nu)]


def hopcroft_karp(
    nu: int, nv: int, edges_u: np.ndarray, edges_v: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Maximum matching. Returns (match_u [nu], match_v [nv]) with -1 = free."""
    edges_u = np.asarray(edges_u, dtype=np.int64)
    edges_v = np.asarray(edges_v, dtype=np.int64)
    adj = _build_adj(nu, edges_u, edges_v)
    match_u = np.full(nu, -1, dtype=np.int64)
    match_v = np.full(nv, -1, dtype=np.int64)
    dist = np.zeros(nu, dtype=np.int64)

    def bfs() -> bool:
        q = deque()
        for u in range(nu):
            if match_u[u] == -1:
                dist[u] = 0
                q.append(u)
            else:
                dist[u] = INF
        found = False
        while q:
            u = q.popleft()
            for v in adj[u]:
                w = match_v[v]
                if w == -1:
                    found = True
                elif dist[w] == INF:
                    dist[w] = dist[u] + 1
                    q.append(int(w))
        return found

    def dfs(u: int) -> bool:
        for v in adj[u]:
            w = match_v[v]
            if w == -1 or (dist[w] == dist[u] + 1 and dfs(int(w))):
                match_u[u] = v
                match_v[v] = u
                return True
        dist[u] = INF
        return False

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, nu + nv + 1000))
    try:
        while bfs():
            for u in range(nu):
                if match_u[u] == -1:
                    dfs(u)
    finally:
        sys.setrecursionlimit(old_limit)
    return match_u, match_v


def min_vertex_cover_bipartite(
    nu: int, nv: int, edges_u: np.ndarray, edges_v: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """König construction: cover = (U \\ Z) ∪ (V ∩ Z).

    Z = vertices reachable from unmatched U vertices via alternating paths
    (unmatched edges U→V, matched edges V→U). Returns boolean masks
    (cover_u [nu], cover_v [nv]); guaranteed |cover| == |max matching|.
    """
    edges_u = np.asarray(edges_u, dtype=np.int64)
    edges_v = np.asarray(edges_v, dtype=np.int64)
    match_u, match_v = hopcroft_karp(nu, nv, edges_u, edges_v)
    adj = _build_adj(nu, edges_u, edges_v)

    visited_u = np.zeros(nu, dtype=bool)
    visited_v = np.zeros(nv, dtype=bool)
    q = deque(int(u) for u in np.where(match_u == -1)[0])
    for u in q:
        visited_u[u] = True
    while q:
        u = q.popleft()
        for v in adj[u]:
            if not visited_v[v]:
                visited_v[v] = True
                w = match_v[v]
                if w != -1 and not visited_u[w]:
                    visited_u[w] = True
                    q.append(int(w))
    cover_u = ~visited_u
    cover_v = visited_v
    # König: |cover| equals matching size — cheap internal consistency check.
    assert int(cover_u.sum() + cover_v.sum()) == int((match_u >= 0).sum())
    return cover_u, cover_v


def verify_cover(
    edges_u: np.ndarray, edges_v: np.ndarray, cover_u: np.ndarray, cover_v: np.ndarray
) -> bool:
    return bool(np.all(cover_u[edges_u] | cover_v[edges_v]))
