"""The port's graph data (``repro_torch/data/graphs.py``) against the
JAX package's: ``powerlaw_graph`` and ``NeighborSampler.sample`` give
the same bytes for the same seeds (the same ``rng`` calls in the same
order), isolated nodes included (they loop to themselves).
"""
import numpy as np
import pytest

from repro.data import graphs as jgraphs
from repro_torch.data import graphs as tgraphs


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed,n,e,d,c", [(0, 32, 96, 8, 3),
                                          (1, 64, 256, 12, 5),
                                          (7, 300, 1200, 16, 41)])
def test_powerlaw_graph_byte_equal(seed, n, e, d, c):
    _same(tgraphs.powerlaw_graph(n, e, d_feat=d, n_classes=c, seed=seed),
          jgraphs.powerlaw_graph(n, e, d_feat=d, n_classes=c, seed=seed))


@pytest.mark.parametrize("seed,fanouts", [(0, (3, 2)), (3, (15, 10)),
                                          (5, (4, 3, 2))])
def test_neighbor_sampler_byte_equal(seed, fanouts):
    """Three batches from one sampler of each package (the rng state
    carries over between calls), on a graph whose last 8 nodes have no
    in-edges."""
    g = jgraphs.powerlaw_graph(80, 200, d_feat=6, n_classes=4, seed=seed)
    ei = g["edge_index"].copy()
    ei[1] = ei[1] % 72          # nodes 72..79 are isolated
    samplers = [mod.NeighborSampler(ei, 80, g["nodes"], g["labels"],
                                    fanouts=fanouts, seed=seed)
                for mod in (tgraphs, jgraphs)]
    for seeds in (np.arange(8), np.arange(70, 80), np.array([79, 0, 79])):
        got, want = (s.sample(seeds) for s in samplers)
        _same(got, want)
    isolated = samplers[0].sample(np.array([75, 76]))
    first = isolated["edges"][0]
    src_nodes = np.concatenate([[75, 76], np.repeat([75, 76],
                                                    fanouts[0])])
    assert (isolated["feats"][first[0]] ==
            g["nodes"][src_nodes[first[0]]]).all()
    assert (isolated["feats"][2:2 + 2 * fanouts[0]] ==
            g["nodes"][np.repeat([75, 76], fanouts[0])]).all()
