"""The online inference server on the card: batched bucketed-ELL ego-net serving.

Counterpart of ``repro/serve/server.py``. ``build_server(spec)`` lowers a
:class:`~repro_torch.serve.spec.ServeSpec` onto a live :class:`GNNServer`
holding the normalized graph, the partition labels (for feature
ownership) and the model parameters on ``device``: fresh ones drawn from
``exec.seed``, or the trained ones of ``serve.ckpt``, a checkpoint
directory of the port's or the JAX package's trainer (same format).

Request path (``serve_batch``), as in the JAX package:

1. each request's k-hop ego-net is extracted (:mod:`repro_torch.serve.egonet`),
2. up to ``serve.batch_size`` ego CSRs merge into ONE block-diagonal
   operator (``graph.structure.block_diag_csrs``) and its degree-bucketed
   layout,
3. node features are gathered through the staleness-controlled
   :class:`~repro_torch.serve.cache.FeatureCache`,
4. the batch is padded onto a :class:`ShapeLadder` class and the layer
   stack runs on the card, each layer's aggregation one launch of the
   ``seg_aggregate`` CUDA kernel (GAT: its attention in PyTorch, and the
   weighted sum one launch with the heads stacked).

PyTorch runs eagerly, so there is no program cache to bound; the server
still pads to shape classes (the fixed shapes a later CUDA-graph capture
needs) and reports the classes it touched where the JAX server reports
``compiled_programs``.

Exactness: with full fanout a served logit is derived from the same
neighbour rows in the same order as the full-batch forward, and the
kernel sums each row's slots in a fixed order and stores it once, so the
aggregation of a served row equals the full-batch one bit for bit. The
dense products are fp32 ``torch.matmul`` (TF32 off); whether the matrix
library keeps them row-stable across row counts is measured, not assumed
(``check_parity``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import layers as L
from repro_torch.core import model as M
from repro_torch.graph.structure import (BucketedEll, block_diag_csrs,
                                         bucketed_ell_from_csr,
                                         degree_bucket_ladder,
                                         stack_bucketed_ells)
from repro_torch.kernels import padded_device_bucketed
from repro_torch.kernels.seg_aggregate import bucketed_aggregate, device_bucketed
from repro_torch.serve.cache import FeatureCache
from repro_torch.serve.egonet import EgoNet, extract_ego
from repro_torch.serve.spec import ServeConfig, ServeSpec


class ServeError(RuntimeError):
    """A serving deployment cannot be built or cannot answer (no card, a
    checkpoint that cannot be restored, malformed request)."""


def _pow2ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ShapeLadder:
    """Fixed padded signatures for arbitrary request batches.

    A batch's padded signature is a *shape class* ``C`` (node capacity, a
    power of two floored at ``min_nodes``) plus per-bucket row capacities
    that are a PURE FUNCTION of ``C``: edge capacity ``E(C) = C *
    edges_per_node`` (edges_per_node = pow2ceil of the graph's mean
    degree, fixed at server build) and, for every K on the graph's full
    degree ladder,

        R_K(C) = min(C, pow2ceil(max(8, 2 * E(C) // K)))

    — sound because a bucket's rows all have degree > K/2, so ``rows_K *
    K/2 < nnz <= E(C)``. ``class_for`` doubles C past node/edge/bucket
    overflow. A copy of the JAX package's ladder, held to it by the tests.
    """

    def __init__(self, max_degree: int, mean_degree: float,
                 min_nodes: int = 64):
        self.ladder = degree_bucket_ladder(max(1, int(max_degree)))
        self.edges_per_node = _pow2ceil(max(1, int(np.ceil(mean_degree))))
        self.min_nodes = _pow2ceil(max(8, int(min_nodes)))

    def caps(self, c: int) -> List[Tuple[int, int]]:
        e = c * self.edges_per_node
        return [(k, min(c, _pow2ceil(max(8, (2 * e) // k))))
                for k in self.ladder]

    def class_for(self, ell: BucketedEll) -> Tuple[int, List[Tuple[int, int]]]:
        """Smallest class fitting ``ell``; raises if a bucket K is off the
        graph ladder (cannot happen for subgraphs of the build graph)."""
        rows_by_k = {b.k: b.rows.shape[0] for b in ell.buckets}
        off = sorted(set(rows_by_k) - set(self.ladder))
        if off:
            raise ServeError(
                f"batch has degree-bucket K={off} beyond the graph ladder "
                f"{self.ladder} — was the server built on a smaller graph?")
        c = max(self.min_nodes, _pow2ceil(max(1, ell.num_rows)))
        while True:
            caps = self.caps(c)
            cap_by_k = dict(caps)
            if (ell.num_rows <= c
                    and ell.nnz <= c * self.edges_per_node
                    and all(r <= cap_by_k[k]
                            for k, r in rows_by_k.items())):
                return c, caps
            c *= 2


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ServeError(
                f"device {device!r}: no CUDA card is available (pass "
                "device='cpu' to run the plain PyTorch path)")
        # The dense products must stay fp32 for parity with the full-batch
        # forward and the JAX package: no TF32 in matmuls or convolutions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class GNNServer:
    """Answers per-node classification requests from a model on ``device``."""

    def __init__(self, cfg: M.GCNConfig, graph: Any, x: np.ndarray,
                 params: Dict, serve_cfg: Optional[ServeConfig] = None,
                 part: Optional[np.ndarray] = None, home: int = 0,
                 device="cuda"):
        self.device = _resolve_device(device)
        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig()
        self.graph = graph
        self.csr = graph.csr_by_dst()
        self.params = M.to_device(params, self.device)
        n = graph.num_nodes
        self.labels = (np.asarray(graph.labels, np.int32)
                       if graph.labels is not None
                       else np.zeros(n, np.int32))
        self.train_mask = (np.asarray(graph.train_mask, bool)
                           if graph.train_mask is not None
                           else np.ones(n, bool))
        # Serving-time label propagation mirrors eval: every train label
        # is embedded (single_eval's prop = train_mask convention).
        self.prop_mask = (self.train_mask if cfg.label_prop
                          else np.zeros(n, bool))
        if part is None:
            part = np.zeros(n, np.int32)
        self.cache = FeatureCache(np.asarray(x, np.float32), part, home,
                                  max_staleness=self.serve_cfg.max_staleness)
        deg = self.csr.row_degrees()
        self.ladder = ShapeLadder(
            max_degree=int(deg.max()) if deg.size else 1,
            mean_degree=(self.csr.nnz / max(1, n)),
            min_nodes=self.serve_cfg.min_nodes)
        self.fanouts = self.serve_cfg.resolved_fanouts(cfg.num_layers)
        self._rng = np.random.default_rng(self.serve_cfg.seed)
        self._classes: set = set()
        self._ref_logits: Optional[np.ndarray] = None
        self.requests_served = 0
        self.batches_dispatched = 0
        # Host seconds per request-path stage, summed over dispatches:
        # ego-net extraction, layout (block-diagonal merge, bucketing,
        # shape class, padded device layout), feature/label gather, and
        # the device forward (copies in, layer stack, logits back).
        self.stage_seconds = dict.fromkeys(
            ("extract", "layout", "features", "device"), 0.0)

    # -- the layer stack ---------------------------------------------------

    def _forward(self, x: np.ndarray, labels: np.ndarray, prop: np.ndarray,
                 ell) -> np.ndarray:
        dev = self.device
        xt = torch.from_numpy(x).to(dev)
        n = xt.shape[0]
        if self.cfg.model == "gat":
            agg = lambda l, h: L.gat_aggregate_bucketed(
                self.params["layers"][l], h, ell, n, self.cfg.gat_heads)
        else:
            agg = lambda l, h: bucketed_aggregate(h, ell, n)
        with torch.inference_mode():
            logits = M.forward(
                self.params, self.cfg, xt, torch.from_numpy(labels).to(dev),
                torch.from_numpy(prop).to(dev), agg)
            return logits.cpu().numpy()

    # -- request path ------------------------------------------------------

    def extract(self, targets: Sequence[int]) -> EgoNet:
        t0 = time.perf_counter()
        ego = extract_ego(self.csr, targets, self.cfg.num_layers,
                          fanouts=self.fanouts, rng=self._rng)
        self.stage_seconds["extract"] += time.perf_counter() - t0
        return ego

    def _dispatch(self, egos: List[EgoNet]) -> List[np.ndarray]:
        t0 = time.perf_counter()
        merged = block_diag_csrs([e.csr for e in egos])
        nodes = np.concatenate([e.nodes for e in egos])
        ell = bucketed_ell_from_csr(merged)
        c, caps = self.ladder.class_for(ell)
        self._classes.add(c)
        dev = padded_device_bucketed(ell, caps, device=self.device)
        t1 = time.perf_counter()
        f = self.cache.store.shape[1]
        x = np.zeros((c, f), np.float32)
        x[: nodes.shape[0]] = self.cache.gather(nodes)
        labels = np.zeros(c, np.int32)
        labels[: nodes.shape[0]] = self.labels[nodes]
        prop = np.zeros(c, bool)
        prop[: nodes.shape[0]] = self.prop_mask[nodes]
        t2 = time.perf_counter()
        logits = self._forward(x, labels, prop, dev)
        t3 = time.perf_counter()
        for stage, dt in (("layout", t1 - t0), ("features", t2 - t1),
                          ("device", t3 - t2)):
            self.stage_seconds[stage] += dt
        out = []
        off = 0
        for e in egos:
            out.append(logits[off: off + e.num_targets])
            off += e.num_nodes
        self.batches_dispatched += 1
        self.requests_served += len(egos)
        if (self.serve_cfg.refresh_every
                and self.batches_dispatched
                % self.serve_cfg.refresh_every == 0):
            self.cache.refresh()
        return out

    def serve_batch(self, requests: Sequence[Sequence[int]]
                    ) -> List[np.ndarray]:
        """Answer ``requests`` (each a list of target node ids), packing
        up to ``serve.batch_size`` ego-nets per dispatch. Returns one
        ``[num_targets, num_classes]`` logits array per request."""
        if not requests:
            return []
        egos = [self.extract(r) for r in requests]
        out: List[np.ndarray] = []
        b = self.serve_cfg.batch_size
        for i in range(0, len(egos), b):
            out.extend(self._dispatch(egos[i: i + b]))
        return out

    def serve(self, targets: Sequence[int]) -> np.ndarray:
        """One request, one dispatch (the unbatched baseline)."""
        return self._dispatch([self.extract(targets)])[0]

    # -- the bit-parity reference ------------------------------------------

    def full_batch_logits(self) -> np.ndarray:
        """Whole-graph forward on the authoritative feature store — the
        reference the full-fanout served logits are held to."""
        ell = device_bucketed(stack_bucketed_ells([bucketed_ell_from_csr(self.csr)]),
                              device=self.device)
        return self._forward(self.cache.store, self.labels, self.prop_mask, ell)

    def check_parity(self, targets: Sequence[int]) -> bool:
        """True iff serving ``targets`` reproduces the full-batch logits
        bit-identically (only meaningful with full fanout)."""
        served = self.serve(targets)
        if self._ref_logits is None:
            self._ref_logits = self.full_batch_logits()
        return bool(np.array_equal(served,
                                   self._ref_logits[np.asarray(targets)]))

    # -- observability -----------------------------------------------------

    def shape_classes(self) -> List[int]:
        """Shape classes dispatched so far (the JAX server's
        ``compiled_programs`` is bounded by the same set)."""
        return sorted(self._classes)

    def stats(self) -> Dict[str, Any]:
        return {
            "requests_served": self.requests_served,
            "batches_dispatched": self.batches_dispatched,
            "shape_classes": self.shape_classes(),
            "shape_ladder": {
                "min_nodes": self.ladder.min_nodes,
                "edges_per_node": self.ladder.edges_per_node,
                "degree_ladder": self.ladder.ladder,
            },
            "cache": self.cache.stats(),
            "device": str(self.device),
            "stage_seconds": dict(self.stage_seconds),
        }


# -- spec resolution -------------------------------------------------------


def _restore_params(serve_cfg: ServeConfig, run, cfg: M.GCNConfig,
                    device) -> Dict:
    """Trained params from ``serve.ckpt`` via the corruption-tolerant
    ``load_latest()`` path, with a clean error on graph mismatch."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.ckpt import restore_arrays

    mgr = CheckpointManager(serve_cfg.ckpt)
    ck, step = mgr.load_latest()
    if ck is None:
        raise ServeError(
            f"serve.ckpt={serve_cfg.ckpt!r}: no loadable checkpoint "
            "(empty directory, or every snapshot corrupt)")
    meta = ck["manifest"].get("meta", {}) or {}
    want = run.graph.content_hash()
    got = meta.get("graph_hash")
    if got is not None and got != want:
        raise ServeError(
            f"checkpoint at step {step} was trained on graph {got} but "
            f"this server is built on graph {want} — refusing to serve "
            "logits from mismatched parameters")
    # The training state is {"params": ..., "opt_state": ...}; serving
    # restores only the params subtree, matched by key path (extra
    # optimizer leaves in the checkpoint are simply ignored).
    template = {"params": M.init_params(cfg, device=device)}
    try:
        return restore_arrays(ck["arrays"], template)["params"]
    except (KeyError, ValueError) as err:
        raise ServeError(
            f"checkpoint at step {step} does not fit the serve spec's model "
            f"section (it must match the training run's): {err}") from err


def build_server(spec: ServeSpec, device="cuda") -> GNNServer:
    """Lower a ServeSpec end to end onto a live :class:`GNNServer` on
    ``device`` (the card unless the caller asks for the CPU; raises if the
    card is missing). Parameters are restored from ``serve.ckpt`` when it
    is set, else drawn from ``exec.seed`` with a ``torch.Generator``."""
    from repro_torch.run.session import build_graph, build_partition

    spec = spec.validate()
    run = spec.run
    dev = _resolve_device(device)
    g, x = build_graph(run)
    part = build_partition(run, g).part
    cfg = run.model.to_gcn_config(run.graph, run.schedule)
    if spec.serve.ckpt:
        params = _restore_params(spec.serve, run, cfg, dev)
    else:
        params = M.init_params(cfg, torch.Generator().manual_seed(run.exec.seed))
    return GNNServer(cfg, g, x, params, serve_cfg=spec.serve, part=part,
                     home=0, device=dev)
