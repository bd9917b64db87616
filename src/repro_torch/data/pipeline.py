"""Data pipeline: graph datasets for the GCN system, synthetic token
streams for the LM substrate.

Offline container => all data is generated (DESIGN.md §8.3): SBM graphs
with block-correlated features for accuracy experiments, R-MAT for
structure/communication experiments, and a deterministic mixture token
stream (Zipf unigrams + periodic motifs, so perplexity visibly falls
during smoke training).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.graph.generators import sbm_graph, sbm_features
from repro_torch.graph.structure import Graph


@dataclass
class GraphDataset:
    name: str
    graph: Graph
    features: np.ndarray
    num_classes: int


def make_gcn_dataset(name: str, seed: int = 0) -> GraphDataset:
    """Synthetic stand-ins keyed by the paper's dataset names (Table 2)."""
    presets = {
        # name: (nodes, classes, degree, feat, homophily)
        "ogbn-arxiv-syn": (8192, 40, 13.8, 128, 0.8),
        "reddit-syn": (4096, 41, 90.0, 602, 0.85),
        "ogbn-products-syn": (16384, 47, 25.0, 100, 0.8),
        "proteins-syn": (8192, 16, 150.0, 128, 0.7),
        "tiny": (1024, 8, 10.0, 32, 0.85),
    }
    if name not in presets:
        raise KeyError(f"unknown dataset {name!r}; known: {list(presets)}")
    n, c, deg, f, hom = presets[name]
    g = sbm_graph(n, c, avg_degree=deg, homophily=hom, seed=seed)
    x, _ = sbm_features(g, f, noise=2.0, seed=seed + 1)
    return GraphDataset(name=name, graph=g, features=x, num_classes=c)


class TokenPipeline:
    """Deterministic synthetic LM stream: Zipf unigrams + injected motifs.

    Motifs (fixed n-grams appearing with period ~32) give the model
    something learnable beyond unigram frequency, so smoke-training loss
    drops visibly within tens of steps.
    """

    def __init__(self, vocab_size: int, seed: int = 0, motif_len: int = 8,
                 num_motifs: int = 16):
        self.vocab_size = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1)
        p = 1.0 / ranks ** 1.1
        self.probs = p / p.sum()
        self.motifs = self.rng.integers(0, vocab_size,
                                        (num_motifs, motif_len)).astype(np.int32)

    def batch(self, batch_size: int, seq_len: int) -> np.ndarray:
        toks = self.rng.choice(self.vocab_size, size=(batch_size, seq_len),
                               p=self.probs).astype(np.int32)
        ml = self.motifs.shape[1]
        for b in range(batch_size):
            for start in range(0, seq_len - ml, 32):
                if self.rng.random() < 0.7:
                    m = self.motifs[self.rng.integers(len(self.motifs))]
                    toks[b, start:start + ml] = m
        return toks

    def batches(self, batch_size: int, seq_len: int,
                steps: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while steps is None or i < steps:
            yield {"tokens": self.batch(batch_size, seq_len)}
            i += 1


def synthetic_token_batches(vocab_size: int, batch_size: int, seq_len: int,
                            steps: int, seed: int = 0):
    return TokenPipeline(vocab_size, seed).batches(batch_size, seq_len, steps)
