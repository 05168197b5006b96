"""The port's ranking metrics against the JAX package's, on the CPU: the
numpy oracles on the same impressions, and each batched metric on the
same padded scores, with heavy ties, padding and degenerate rows."""

import numpy as np
import pytest
import torch

from newsrecommendation_tpu import metrics as J
from newsrecommendation_tpu_torch import metrics as M

SUM_TOL = dict(rtol=1e-6, atol=0)


def padded_batch(seed, b=16, cmax=30, ties=None, degenerate=True):
    """Scores, labels and a candidate mask (B, C) as eval batches hold
    them: ragged real widths, labels 0 on padding; ``ties``: scores
    rounded to 1/ties so many are equal; degenerate rows (all 0, all 1,
    all padding) at the end."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(b, cmax)).astype(np.float32)
    if ties:
        scores = np.round(scores * ties) / ties
    mask = np.zeros((b, cmax), np.float32)
    for i, n in enumerate(rng.integers(2, cmax + 1, size=b)):
        mask[i, :n] = 1.0
    labels = rng.integers(0, 2, size=(b, cmax)).astype(np.float32) * mask
    labels[:, 0], labels[:, 1] = 1.0, 0.0
    if degenerate:
        labels[-3] = 0.0
        labels[-2] = mask[-2]
        mask[-1] = labels[-1] = 0.0
    return scores, labels, mask


CASES = [dict(seed=0), dict(seed=1, cmax=64, ties=3),
         dict(seed=2, cmax=384, ties=5), dict(seed=3, cmax=8, ties=1)]


def tensors(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=lambda c: str(c))
@pytest.mark.parametrize("name, kw", [
    ("batched_auc", {}), ("batched_mrr", {}), ("batched_ndcg", {"k": 5}),
    ("batched_ndcg", {"k": 10}), ("batched_ctr", {"k": 1}),
    ("batched_ctr", {"k": 3}), ("batched_dcg", {"k": 10})])
def test_batched_metric_matches_jax(case, name, kw):
    s, l, m = padded_batch(**case)
    got = getattr(M, name)(*tensors(s, l, m), **kw)
    want = np.asarray(getattr(J, name)(s, l, m, **kw))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=2e-7)


@pytest.mark.parametrize("case", CASES, ids=lambda c: str(c))
def test_impression_metrics_sums_match_jax(case):
    s, l, m = padded_batch(**case)
    got = M.impression_metrics(*tensors(s, l, m))
    want = J.impression_metrics(s, l, m)
    assert set(got) == set(want) == {"auc", "mrr", "ndcg5", "ndcg10",
                                     "count"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   **SUM_TOL, err_msg=k)
    # the three degenerate rows drop out
    assert float(got["count"]) == case.get("b", 16) - 3


@pytest.mark.parametrize("case", CASES, ids=lambda c: str(c))
def test_auc_against_the_oracles(case):
    """Tie-averaged AUC equals the pairwise formula and the numpy oracle
    (sklearn's) on every valid row."""
    s, l, m = padded_batch(**case)
    got = M.batched_auc(*tensors(s, l, m)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(J.batched_auc_pairwise(s, l, m)), atol=1e-6)
    valid = M.valid_impression_mask(*tensors(l, m)).numpy()
    for i in np.nonzero(valid)[0]:
        real = m[i] > 0
        assert got[i] == pytest.approx(M.roc_auc_score(l[i][real], s[i][real]),
                                       abs=1e-6)


def test_tie_order_does_not_leak():
    """Permuting the candidates of an impression permutes nothing in its
    metrics, however the scores tie."""
    s, l, m = padded_batch(5, b=8, cmax=12, ties=1, degenerate=False)
    m[:] = 1.0
    rng = np.random.default_rng(9)
    perm = rng.permutation(12)
    a = M.impression_metrics(*tensors(s, l, m))
    b = M.impression_metrics(*tensors(s[:, perm], l[:, perm], m[:, perm]))
    for k in ("auc", "count"):
        assert float(a[k]) == float(b[k]), k


def test_valid_impression_mask_matches_jax():
    labels = np.array([[1, 0, 0], [1, 1, 0], [0, 0, 0], [1, 1, 1]],
                      dtype=np.float32)
    mask = np.array([[1, 1, 0], [1, 1, 0], [1, 1, 1], [1, 1, 1]],
                    dtype=np.float32)
    got = M.valid_impression_mask(*tensors(labels, mask)).numpy()
    np.testing.assert_array_equal(got, [1.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(
        got, np.asarray(J.valid_impression_mask(labels, mask)))


def test_batched_rankdata_average_matches_jax():
    x = np.random.default_rng(4).integers(0, 5, size=(6, 40)).astype(
        np.float32)
    got = M.batched_rankdata_average(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        J.batched_rankdata_average(x)))
    np.testing.assert_array_equal(
        M.batched_rankdata_average(torch.from_numpy(x.T.copy()), dim=0)
        .numpy(), got.T)
    np.testing.assert_allclose(got, np.stack(
        [J._rankdata_average(r.astype(np.float64)) for r in x]))


def test_train_accuracy_matches_jax():
    logits = np.array([[1.0, 2.0, 0.0], [3.0, 1.0, 0.0]], np.float32)
    labels = np.array([1, 2])
    got = float(M.train_accuracy(*tensors(labels, logits)))
    assert got == pytest.approx(0.5)
    assert got == float(J.train_accuracy(labels, logits))


@pytest.mark.parametrize("n", [5, 17, 50])
def test_numpy_oracles_match_jax(n):
    rng = np.random.default_rng(n)
    for _ in range(10):
        y = rng.integers(0, 2, size=n).astype(np.float64)
        y[0], y[1] = 1, 0
        s = rng.integers(0, 4, size=n).astype(np.float64)  # ties
        assert M.roc_auc_score(y, s) == J.roc_auc_score(y, s)
        assert M.mrr_score(y, s) == J.mrr_score(y, s)
        for k in (5, 10):
            assert M.ndcg_score(y, s, k) == J.ndcg_score(y, s, k)
            assert M.dcg_score(y, s, k) == J.dcg_score(y, s, k)
        assert M.ctr_score(y, s, 2) == J.ctr_score(y, s, 2)
    with pytest.raises(ValueError, match="single-class"):
        M.roc_auc_score(np.ones(4), np.arange(4.0))
