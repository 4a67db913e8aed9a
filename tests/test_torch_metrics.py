"""The port's retrieval metrics (oatx_torch.metrics.retrieval) against oatx's:
the same similarity matrices give the same dicts exactly; mean average
precision, which oatx takes from sklearn and the port computes in numpy,
agrees to 1e-6."""

import numpy as np
import pytest

from oatx.metrics import retrieval as J
from oatx_torch.metrics import retrieval as P


def _sims(seed, rows, cols, ties):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((rows, cols)).astype(np.float32)
    return np.round(s, 1) if ties else s


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(12, 12), (24, 12), (60, 60)])
def test_t2v_v2t_equal_oatx(shape, ties):
    sims = _sims(0, *shape, ties)
    for name in ("t2v_metrics", "v2t_metrics"):
        for kw in ({}, {"break_ties": "optimistically"}, {"break_ties": "averaging"}):
            assert getattr(P, name)(sims, **kw) == getattr(J, name)(sims, **kw), (name, kw)
    masks = np.random.default_rng(1).random(shape[0]) < 0.8
    masks[0] = True
    assert P.t2v_metrics(sims, masks) == J.t2v_metrics(sims, masks)
    assert P.v2t_metrics(sims, masks) == J.v2t_metrics(sims, masks)


@pytest.mark.parametrize("ties", [False, True])
def test_classification_and_map_match_oatx(ties):
    rng = np.random.default_rng(2)
    sims = _sims(3, 20, 9, ties)
    labels = (rng.random((20, 9)) < 0.3).astype(np.int64)
    labels[0] = 1
    assert P.retrieval_as_classification(sims, labels) == \
        J.retrieval_as_classification(sims, labels)
    got, want = P.mean_average_precision(sims, labels), J.mean_average_precision(sims, labels)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["mAP"], want["mAP"], rtol=0, atol=1e-6)
    for fn in (P.mean_average_precision, P.retrieval_as_classification):
        with pytest.raises(ValueError, match="query_masks"):
            fn(sims)
    assert P.REQUIRES_QUERY_MASKS == J.REQUIRES_QUERY_MASKS


def test_accuracies_match_oatx():
    out = _sims(4, 30, 5, False)
    target = np.random.default_rng(5).integers(0, 5, 30)
    assert P.acc(out, target) == J.acc(out, target)
    assert P.top_k_acc(out, target, k=3) == J.top_k_acc(out, target, k=3)
