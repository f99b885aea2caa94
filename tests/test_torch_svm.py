"""Port parity for SVM-RBF: the port's RBF C-SVC (``hsimae_tpu_torch``'s
batched SMO) against sklearn's ``SVC(kernel="rbf")``, and its grid search
and ``cli.benchmark --models SVM-RBF`` against ``hsimae_tpu``'s, on the CPU.

Inputs are min-max normalised synthetic spectra (200 bands), the SVM's own
input, 5 training rows a class. Tolerances:

* at ``tol=1e-10`` in both: the support set, the dual coefficients (scaled
  by C), the intercepts and the one-vs-one decision values (scaled by their
  largest magnitude) within 1e-6. libsvm caches ``Q`` in float32 (``typedef
  float Qfloat``), so its solution is that of a ``Q`` rounded to float32;
  the port's solver runs in float64, and where ``Q`` is ill-conditioned
  (large C, small gamma) the two optima differ by up to ~5e-5 of C. This
  test hands the port's SMO libsvm's float32-rounded ``Q`` (the solver
  itself unchanged) and holds it to the limits above. With duplicate rows
  ``Q`` is singular and the split of a coefficient between identical rows
  is not unique: the support set and the coefficients are held per group
  of identical rows;
* the port's own float64 solve at the default ``tol``: feasible, meeting
  the stopping rule on a gradient computed afresh, and labelling >= 99.9%
  of the scene's pixels as sklearn does (near-ties may differ);
* the grid search against JAX's ``SVMRBF`` (sklearn inside): the same
  ``best_c`` / ``best_gamma`` and >= 99.9% of scene labels equal; a
  disagreement is reported with both score tables;
* ``cli.benchmark --models SVM-RBF``: the same report as JAX's.
"""

import itertools

import numpy as np
import pytest
import torch
from sklearn.svm import SVC as SkSVC

from hsimae_tpu.cli import benchmark as jax_bench
from hsimae_tpu.data.sampling import sample_per_class as jax_sample_per_class
from hsimae_tpu.models.baselines import svm_rbf as jax_svm
from hsimae_tpu_torch.cli import benchmark as port_bench
from hsimae_tpu_torch.data.synthetic import make_synthetic_scene
from hsimae_tpu_torch.models.baselines import svm_rbf

TOL = 1e-6
CORNERS = [(2.0**-3, 2.0**-5), (2.0**-3, 2.0**3), (2.0**3, 2.0**-1), (2.0**9, 2.0**-5),
           (2.0**9, 2.0**3), (2.0**10.75, 2.0**-1)]
CASES = {  # name: (classes, (C, gamma) points, rows duplicated)
    "two_classes": (2, CORNERS, 0),
    "sixteen_classes": (16, CORNERS, 0),
    "all_at_bound": (16, [(2.0**-3, g) for g in (2.0**-5, 2.0**-1, 2.0**3)], 0),
    "duplicate_rows": (6, CORNERS, 8),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (six pytest workers share
    the machine's cores). Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spectra(n_classes, dup=0, seed=5):
    """5 training rows a class of a normalised synthetic scene (labels in
    the scene's order of first appearance, not sorted), ``dup`` of them
    repeated; and the scene's labelled pixels, rounded to float32."""
    scene, gt = make_synthetic_scene(48, 48, bands=200, n_classes=n_classes, seed=seed)
    sc = np.asarray(scene, np.float64)
    sc = (sc - sc.min()) / (sc.max() - sc.min())
    flat, g = sc.reshape(-1, sc.shape[-1]), gt.reshape(-1)
    rng = np.random.default_rng(seed)
    idx = np.concatenate([rng.choice(np.flatnonzero(g == k), 5, replace=False)
                          for k in range(1, n_classes + 1)])
    idx = rng.permutation(np.concatenate([idx, idx[:dup]]))
    return flat[idx], g[idx], flat[g > 0].astype(np.float32)


def libsvm_q(monkeypatch):
    """Hand the port's SMO ``Q`` rounded to float32, as libsvm caches it."""
    smo = svm_rbf.smo
    monkeypatch.setattr(svm_rbf, "smo",
                        lambda q, y, c, tol: smo(q.float().double(), y, c, tol))


def sklearn_ovo(sk, x):
    """sklearn's one-vs-one values, coefficients and intercepts in libsvm's
    sign convention (sklearn flips all three for two classes)."""
    dec, coef, icpt = sk.decision_function(x), sk.dual_coef_, sk.intercept_
    if len(sk.classes_) == 2:
        return -dec[:, None], -coef, -icpt
    return dec, coef, icpt


def row_groups(x):
    """Each row's group of identical rows, as the group's first row."""
    _, first, inverse = np.unique(x, axis=0, return_index=True, return_inverse=True)
    return first[inverse.reshape(-1)]


def by_group(support, coef, groups):
    """Support set and dual coefficients summed over groups of identical rows."""
    keys = np.unique(groups[support])
    summed = np.stack([coef[:, groups[support] == k].sum(1) for k in keys], 1)
    return keys, summed


@pytest.mark.parametrize("case", list(CASES))
def test_svc_matches_sklearn(case, monkeypatch):
    n_classes, points, dup = CASES[case]
    x, y, pix = spectra(n_classes, dup)
    libsvm_q(monkeypatch)
    groups = row_groups(x)
    held = pix[::5]
    for c, g in points:
        sk = SkSVC(C=c, gamma=g, kernel="rbf", tol=1e-10, decision_function_shape="ovo").fit(x, y)
        ours = svm_rbf.SVC(C=c, gamma=g, tol=1e-10, device="cpu").fit(x, y)
        dec, coef, icpt = sklearn_ovo(sk, held)
        where = f"{case} C={c:g} gamma={g:g}"
        np.testing.assert_array_equal(ours.classes_, sk.classes_, err_msg=where)
        sk_keys, sk_coef = by_group(sk.support_, coef, groups)
        our_keys, our_coef = by_group(ours.support_, ours.dual_coef_, groups)
        np.testing.assert_array_equal(our_keys, sk_keys, err_msg=where)
        if not dup:
            np.testing.assert_array_equal(ours.support_, sk.support_, err_msg=where)
        assert np.abs(our_coef - sk_coef).max() <= TOL * c, where
        scale = np.abs(dec).max()
        assert np.abs(ours.intercept_ - icpt).max() <= TOL * scale, where
        assert np.abs(ours.decision_function(held) - dec).max() <= TOL * scale, where
        if case == "all_at_bound":  # every alpha at C: rho is libsvm's midpoint
            assert np.all(np.abs(ours.dual_coef_) == c), where


@pytest.mark.parametrize("case", list(CASES))
def test_float64_svc_at_default_tol(case):
    """The port's own solve: feasible, the stopping rule met on a gradient
    computed afresh, and sklearn's labels on >= 99.9% of the scene."""
    n_classes, points, dup = CASES[case]
    x, y, pix = spectra(n_classes, dup)
    grid = svm_rbf.OvOGrid(x, y, points, device="cpu")
    a, q, yy, c = grid.alpha, grid.q, grid.y, grid.c
    assert bool(((a >= 0) & (a <= c[:, None])).all())
    assert float(((yy * a).sum(1).abs() / c).max()) <= 1e-9
    gap = svm_rbf.solution_gap(q, yy, c, a)
    assert float(gap.max()) <= grid.tol * (1 + 1e-6)
    ours = grid.predict(pix)
    for k, (cc, g) in enumerate(points):
        sk = SkSVC(C=cc, gamma=g, kernel="rbf").fit(x, y)
        same = (ours[k] == sk.predict(pix)).mean()
        assert same >= 0.999, (case, cc, g, same)


def test_votes_follow_libsvm():
    """A value > 0 votes for the pair's first class, else (0 included) for
    its second; a tie goes to the lowest class."""
    x = np.array([[0.0], [1.0], [2.0]])
    grid = svm_rbf.OvOGrid(x, [3, 5, 9], [(1.0, 1.0)], device="cpu")
    assert grid.pairs == [(0, 1), (0, 2), (1, 2)]
    dec = torch.tensor([[1.0, -1.0, 1.0],  # 3, 9, 5: a three-way tie -> 3
                        [0.0, 0.0, 0.0],  # 5, 9, 9 -> 9
                        [-1.0, 1.0, -1.0],  # 5, 3, 9: tie -> 3
                        [-1.0, -1.0, 1.0]], dtype=torch.float64)  # 5, 9, 5 -> 5
    assert grid.votes_to_labels(dec).tolist() == [3, 9, 3, 5]


def test_smo_raises_at_the_iteration_cap(monkeypatch):
    x, y, _ = spectra(16)
    point = [(2.0**9, 2.0**-5)]
    needs = int(svm_rbf.OvOGrid(x, y, point, device="cpu").iters.max())
    assert needs > svm_rbf.CHECK_EVERY
    monkeypatch.setattr(svm_rbf, "max_iter", lambda n: svm_rbf.CHECK_EVERY)
    with pytest.raises(RuntimeError, match="iteration cap"):
        svm_rbf.OvOGrid(x, y, point, device="cpu")


def score_tables(monkeypatch):
    """Record JAX's selection scores (oa + aa + kappa, per grid point)."""
    scores = []
    real = jax_svm.classification_metrics

    def recording(y_true, y_pred):
        m = real(y_true, y_pred)
        scores.append(m.oa + m.aa + m.kappa)
        return m
    monkeypatch.setattr(jax_svm, "classification_metrics", recording)
    return scores


def test_svmrbf_train_matches_jax(monkeypatch):
    scene, gt = make_synthetic_scene(64, 64, bands=200, n_classes=8, seed=11)
    sc = np.asarray(scene, np.float64)
    sc = (sc - sc.min()) / (sc.max() - sc.min())
    seed = 3407
    jax_scores = score_tables(monkeypatch)
    runs = []
    for svm in (jax_svm.SVMRBF(seed), svm_rbf.SVMRBF(seed, device="cpu")):
        rng = np.random.default_rng(seed)
        tr_idx, _ = jax_sample_per_class(gt.reshape(-1), num=10, rng=rng)
        x, y = sc.reshape(-1, sc.shape[-1])[tr_idx], gt.reshape(-1)[tr_idx]
        svm.train(x, y, rng=rng)
        runs.append((svm, svm.predict_scene(sc.astype(np.float32))))
    (jsvm, jmap), (tsvm, tmap) = runs
    tables = (f"JAX scores {np.round(jax_scores, 6).tolist()}\n"
              f"port scores {[np.round(s['scores'], 6).tolist() for s in tsvm.stage_stats]}")
    assert (tsvm.best_c, tsvm.best_gamma) == (jsvm.best_c, jsvm.best_gamma), tables
    assert (tmap == jmap).mean() >= 0.999, tables


def test_cli_benchmark_svm_matches_jax():
    argv = ["--synthetic", "--synthetic-size", "40", "--synthetic-bands", "103",
            "--synthetic-classes", "6", "--models", "SVM-RBF", "--test-seeds", "2"]
    want = jax_bench.main(argv)
    got = port_bench.main(argv + ["--device", "cpu"])
    assert got == want
    assert got["SVM-RBF"]["best_lr"] is None and len(got["SVM-RBF"]["per_seed_oa"]) == 2


def test_cli_benchmark_svm_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = ["--synthetic", "--synthetic-size", "16", "--synthetic-classes", "3",
            "--models", "SVM-RBF", "--test-seeds", "1", "--device", "cuda"]
    with pytest.raises((AssertionError, RuntimeError)):
        port_bench.main(argv)
