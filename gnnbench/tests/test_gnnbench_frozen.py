"""The frozen generators equal the port's at a small size, so that a cell's
data is the port's generators' today."""

from __future__ import annotations

import numpy as np

from conftest import SEED, SMALL
from gnnbench.frozen import generators as fgen


def _same_graph(a, b):
    assert a.num_nodes == b.num_nodes
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)


def test_generators_bit_for_bit():
    from repro_torch.graph import generators as pgen

    a = fgen.sbm_graph(SMALL, 47, avg_degree=50.5, homophily=0.8, seed=SEED)
    b = pgen.sbm_graph(SMALL, 47, avg_degree=50.5, homophily=0.8, seed=SEED)
    _same_graph(a, b)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.train_mask, b.train_mask)
    np.testing.assert_array_equal(fgen.sbm_features(a, 100, 2.5, SEED + 1)[0],
                                  pgen.sbm_features(b, 100, 2.5, SEED + 1)[0])
    _same_graph(fgen.rmat_graph(11, edge_factor=31, seed=SEED),
                pgen.rmat_graph(11, edge_factor=31, seed=SEED))
