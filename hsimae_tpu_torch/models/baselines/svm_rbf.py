"""SVM-RBF baseline: an RBF C-SVC of the port's own, and its two-stage grid
search on (C, gamma) over 1x1-pixel spectra.

Counterpart of ``hsimae_tpu/models/baselines/svm_rbf.py``, which runs
sklearn's ``SVC`` on the host. Here the SVC is torch code that runs on the
card (or on the CPU when asked), with the semantics of sklearn's
``SVC(kernel="rbf")`` and of the libsvm inside it:

* ``K(x, x') = exp(-gamma * |x - x'|^2)``, float64 throughout;
* one-vs-one over every pair ``(a, b)`` of the sorted classes, ``a`` the
  positive side; each pair's dual ``min 1/2 a'Qa - e'a, 0 <= a <= C,
  y'a = 0`` solved by SMO with libsvm's second-order working-set selection
  (its ``TAU = 1e-12`` guard and its ties: the last index wins), stopped
  when the largest violating pair's gap falls below ``tol``;
* ``rho`` as libsvm's ``calculate_rho``: the mean of ``y*G`` over free
  variables, or the midpoint of its bounds when none is free;
* prediction by votes: a pair's decision value ``> 0`` votes for ``a``,
  else for ``b``; the most votes win, the first class on a tie.

libsvm shrinks its active set and keeps ``Q`` in float32; this solver does
neither, so its path differs from libsvm's while its solution meets the
same stopping rule. The kernel among the training rows (``[points, n, n]``)
is computed once on the host: the SMO is elementwise float64 arithmetic,
gathers and exact maxima, so with the same ``Q`` the card and the CPU take
the same path to the same solution.

Every problem of one grid stage, its (C, gamma) points times the class
pairs, is solved by one batched SMO (:func:`smo`): ``[P, n_max]`` tensors,
padding masked out, one working pair a problem and iteration. The host
reads a convergence flag every ``CHECK_EVERY`` iterations; reaching
libsvm's iteration cap raises.
"""

from __future__ import annotations

import itertools
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hsimae_tpu_torch.data.sampling import train_val_split
from hsimae_tpu_torch.utils.metrics import classification_metrics

TAU = 1e-12  # libsvm's floor of a non-positive quadratic coefficient
CHECK_EVERY = 32  # SMO iterations between two reads of the convergence flag
DECISION_ELEMENTS = 1 << 25  # float64 elements of one chunk's kernel or decision values
COARSE_C = [2.0**i for i in range(-3, 10, 2)]
COARSE_GAMMA = [2.0**i for i in range(-5, 4, 2)]


def max_iter(n: int) -> int:
    """libsvm's iteration cap for a problem of ``n`` variables."""
    return max(10_000_000, 100 * n)


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[n, d]`` x ``[m, d]`` -> ``[n, m]`` squared distances (float64)."""
    d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    return d.clamp_min_(0.0)


def _last_argmax(v: torch.Tensor) -> torch.Tensor:
    """Index of the row maximum, the last one on a tie (libsvm's ``>=``)."""
    return v.shape[1] - 1 - v.flip(1).argmax(1)


def smo(q: torch.Tensor, y: torch.Tensor, c: torch.Tensor, tol: float):
    """Solve ``P`` C-SVC duals at once.

    ``q`` ``[P, n, n]`` is ``y_i y_j K_ij`` (float64), ``y`` ``[P, n]`` is
    +1 / -1, and 0 for padding, ``c`` ``[P]`` each problem's C. Returns
    ``(alpha, grad, iters)``: the duals, the gradient ``Q alpha - e`` as the
    solver kept it, and each problem's iteration count."""
    p, n = y.shape
    rows = torch.arange(p, device=y.device)
    pos, neg = y > 0, y < 0
    cc = c[:, None]
    qd = q.diagonal(dim1=1, dim2=2)
    alpha = torch.zeros_like(y)
    grad = torch.full_like(y, -1.0)
    iters = torch.zeros(p, dtype=torch.int64, device=y.device)
    live = torch.ones(p, dtype=torch.bool, device=y.device)
    cap, it = max_iter(n), 0
    inf = torch.tensor(float("inf"), dtype=y.dtype, device=y.device)
    while True:
        if it % CHECK_EVERY == 0:
            if not bool(live.any()):  # the host's one read a check
                break
            if it >= cap:
                raise RuntimeError(f"SMO reached libsvm's iteration cap ({cap}) on "
                                   f"{int(live.sum())} of {p} problems")
        it += 1
        up = (pos & (alpha < cc)) | (neg & (alpha > 0))
        low = (pos & (alpha > 0)) | (neg & (alpha < cc))
        yg = y * grad
        # i: the largest -y G over I_up
        v_up = torch.where(up, -yg, -inf)
        i = _last_argmax(v_up)
        g_max = v_up.gather(1, i[:, None])
        # j: the largest second-order decrease over I_low with -y_j G_j < -y_i G_i
        g_max2 = torch.where(low, yg, -inf).amax(1)
        q_i = q[rows, i]
        yi = y.gather(1, i[:, None])
        diff = g_max + yg
        quad = qd.gather(1, i[:, None]) + qd - 2.0 * yi * y * q_i
        quad = torch.where(quad > 0, quad, TAU)
        obj = torch.where(low & (diff > 0), -diff * diff / quad, inf)
        j = _last_argmax(-obj)
        found = torch.isfinite(obj.gather(1, j[:, None]))[:, 0]
        live &= (g_max[:, 0] + g_max2 >= tol) & found
        iters += live
        # the two-variable update, libsvm's clipping in its order
        ij = torch.stack([i, j], 1)
        ai, aj = alpha.gather(1, ij).unbind(1)
        gi, gj = grad.gather(1, ij).unbind(1)
        yj = y.gather(1, j[:, None])[:, 0]
        yi = yi[:, 0]
        q_ij = q_i.gather(1, j[:, None])[:, 0]
        qdi, qdj = qd.gather(1, ij).unbind(1)
        ci = c
        # y_i != y_j
        qc = qdi + qdj + 2.0 * q_ij
        qc = torch.where(qc > 0, qc, TAU)
        delta = (-gi - gj) / qc
        dif = ai - aj
        ni, nj = ai + delta, aj + delta
        cut = (dif > 0) & (nj < 0)
        ni, nj = torch.where(cut, dif, ni), torch.where(cut, 0.0, nj)
        cut = (dif <= 0) & (ni < 0)
        ni, nj = torch.where(cut, 0.0, ni), torch.where(cut, -dif, nj)
        cut = (dif > 0) & (ni > ci)
        ni, nj = torch.where(cut, ci, ni), torch.where(cut, ci - dif, nj)
        cut = (dif <= 0) & (nj > ci)
        ni, nj = torch.where(cut, ci + dif, ni), torch.where(cut, ci, nj)
        # y_i == y_j
        qc = qdi + qdj - 2.0 * q_ij
        qc = torch.where(qc > 0, qc, TAU)
        delta = (gi - gj) / qc
        s = ai + aj
        si, sj = ai - delta, aj + delta
        cut = (s > ci) & (si > ci)
        si, sj = torch.where(cut, ci, si), torch.where(cut, s - ci, sj)
        cut = (s <= ci) & (sj < 0)
        si, sj = torch.where(cut, s, si), torch.where(cut, 0.0, sj)
        cut = (s > ci) & (sj > ci)
        si, sj = torch.where(cut, s - ci, si), torch.where(cut, ci, sj)
        cut = (s <= ci) & (si < 0)
        si, sj = torch.where(cut, 0.0, si), torch.where(cut, s, sj)
        same = yi == yj
        ni, nj = torch.where(same, si, ni), torch.where(same, sj, nj)
        da = torch.where(live[:, None], torch.stack([ni - ai, nj - aj], 1), 0.0)
        alpha.scatter_add_(1, ij, da)
        grad += q_i * da[:, :1] + q[rows, j] * da[:, 1:]
    return alpha, grad, iters


def solution_gap(q: torch.Tensor, y: torch.Tensor, c: torch.Tensor,
                 alpha: torch.Tensor) -> torch.Tensor:
    """The largest violating pair's gap ``max_up(-yG) - min_low(-yG)`` of
    each problem at ``alpha``, its gradient computed afresh (``-inf`` where
    a side is empty)."""
    grad = (q @ alpha[:, :, None])[:, :, 0] - (y != 0).to(y.dtype)
    yg = y * grad
    pos, neg, cc = y > 0, y < 0, c[:, None]
    up = (pos & (alpha < cc)) | (neg & (alpha > 0))
    low = (pos & (alpha > 0)) | (neg & (alpha < cc))
    inf = float("inf")
    return (torch.where(up, -yg, -inf).amax(1) + torch.where(low, yg, -inf).amax(1))


def calculate_rho(y: torch.Tensor, c: torch.Tensor, alpha: torch.Tensor,
                  grad: torch.Tensor) -> torch.Tensor:
    """libsvm's ``rho`` of each problem: the mean of ``y G`` over free
    variables, or the midpoint of its bounds when none is free."""
    yg = y * grad
    pos, neg = y > 0, y < 0
    upper = (y != 0) & (alpha >= c[:, None])
    lower = (y != 0) & (alpha <= 0)
    free = (y != 0) & ~upper & ~lower
    inf = float("inf")
    ub = torch.where((upper & neg) | (lower & pos), yg, inf).amin(1)
    lb = torch.where((upper & pos) | (lower & neg), yg, -inf).amax(1)
    n_free = free.sum(1)
    mean_free = torch.where(free, yg, 0.0).sum(1) / n_free.clamp_min(1)
    return torch.where(n_free > 0, mean_free, (ub + lb) / 2)


class OvOGrid:
    """One-vs-one RBF C-SVCs at every point of a (C, gamma) grid, fitted by
    one batched SMO.

    ``points`` are the (C, gamma) pairs in the order given; problem ``k``
    of point ``g`` is class pair ``pairs[k]`` (indices into the sorted
    ``classes``, libsvm's order). ``coef`` ``[G, K, n_train]`` holds each
    problem's ``y alpha`` on the training rows (0 off its two classes),
    ``rho`` ``[G, K]`` its offset. The per-problem tensors of the solve
    (``q``, ``y``, ``c``, ``alpha``, ``grad``, ``iters``, ``rows``) are
    kept ``[G * K, n_max]`` for checks."""

    def __init__(self, x, y, points: Sequence[Tuple[float, float]], tol: float = 1e-3,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.points = [(float(c), float(g)) for c, g in points]
        self.tol = tol
        labels = np.asarray(y).reshape(-1)
        self.classes = np.unique(labels)
        if len(self.classes) < 2:
            raise ValueError(f"an SVC needs at least 2 classes, got {self.classes}")
        xt = np.asarray(x, np.float64)
        self.x = torch.as_tensor(xt, device=self.device)
        n_train = len(labels)
        self.row_class = np.searchsorted(self.classes, labels)
        by_class = [np.flatnonzero(labels == k) for k in self.classes]
        self.pairs = list(itertools.combinations(range(len(self.classes)), 2))
        n_max = max(len(by_class[a]) + len(by_class[b]) for a, b in self.pairs)
        n_g, n_k = len(self.points), len(self.pairs)
        rows = np.zeros((n_k, n_max), np.int64)
        sign = np.zeros((n_k, n_max))
        for k, (a, b) in enumerate(self.pairs):
            r = np.concatenate([by_class[a], by_class[b]])
            rows[k, :len(r)] = r
            sign[k, :len(by_class[a])] = 1.0
            sign[k, len(by_class[a]):len(r)] = -1.0
        dev = self.device
        gammas = np.array([g for _, g in self.points])
        self.gamma = torch.as_tensor(gammas, device=dev)
        cs = torch.tensor([c for c, _ in self.points], dtype=torch.float64, device=dev)
        # the training rows' kernel at each point, [G, n_train, n_train], on
        # the host: every device then solves the same Q
        sq = (xt * xt).sum(1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (xt @ xt.T), 0.0)
        kernel = torch.as_tensor(np.exp(-gammas[:, None, None] * d2[None]), device=dev)
        self.rows = torch.as_tensor(rows, device=dev).repeat(n_g, 1)
        self.y = torch.as_tensor(sign, device=dev).repeat(n_g, 1)
        self.c = cs.repeat_interleave(n_k)
        r = self.rows
        point = torch.arange(n_g, device=dev).repeat_interleave(n_k)
        k_sub = kernel[point[:, None, None], r[:, :, None], r[:, None, :]]
        self.q = self.y[:, :, None] * self.y[:, None, :] * k_sub
        self.alpha, self.grad, self.iters = smo(self.q, self.y, self.c, tol)
        rho = calculate_rho(self.y, self.c, self.alpha, self.grad)
        coef = torch.zeros(n_g * n_k, n_train, dtype=torch.float64, device=dev)
        coef.scatter_add_(1, r, self.y * self.alpha)
        self.coef = coef.view(n_g, n_k, n_train)
        self.rho = rho.view(n_g, n_k)
        self._a = torch.as_tensor([a for a, _ in self.pairs], device=dev)
        self._b = torch.as_tensor([b for _, b in self.pairs], device=dev)
        self._labels = torch.as_tensor(self.classes, device=dev)

    def _decision_chunks(self, x, points: Optional[Sequence[int]]):
        """The decision values ``[G, rows, K]`` of ``x``'s rows, chunk by
        chunk: the squared distances of a chunk to the training rows once,
        then every selected point's kernel and all its pairs in one product."""
        sel = torch.arange(len(self.points)) if points is None else torch.as_tensor(points)
        sel = sel.to(self.device)
        x = torch.as_tensor(np.asarray(x, np.float64), device=self.device)
        gamma, coef, rho = self.gamma[sel], self.coef[sel], self.rho[sel]
        step = max(1, DECISION_ELEMENTS // (len(sel) * max(coef.shape[1:])))
        for start in range(0, len(x), step):
            k = torch.exp(-gamma[:, None, None] * sq_dists(x[start:start + step], self.x))
            yield torch.bmm(k, coef.transpose(1, 2)) - rho[:, None, :]

    def decision_function(self, x, points: Optional[Sequence[int]] = None) -> torch.Tensor:
        """libsvm's one-vs-one decision values ``[G, n, K]`` (float64, on
        the grid's device) of the rows of ``x`` at each grid point (or at
        the indices ``points``)."""
        return torch.cat(list(self._decision_chunks(x, points)), 1)

    def votes_to_labels(self, dec: torch.Tensor) -> torch.Tensor:
        """``[..., K]`` decision values -> ``[...]`` class labels: each pair
        votes for its first class where its value is > 0, else its second;
        the most votes win, the lowest class index on a tie."""
        winner = torch.where(dec > 0, self._a, self._b)
        votes = torch.zeros(*dec.shape[:-1], len(self.classes), dtype=torch.int64,
                            device=dec.device)
        votes.scatter_add_(-1, winner, torch.ones_like(winner))
        return self._labels[votes.argmax(-1)]

    def predict(self, x, points: Optional[Sequence[int]] = None) -> np.ndarray:
        """``[G, n]`` labels of the rows of ``x`` at each grid point."""
        return torch.cat([self.votes_to_labels(d) for d in self._decision_chunks(x, points)],
                         1).cpu().numpy()


class SVC:
    """sklearn's ``SVC(kernel="rbf", C, gamma, tol)``: one point of
    :class:`OvOGrid`. After :meth:`fit`: ``classes_``, ``n_iter_`` (each
    pair's SMO iterations), ``support_`` (sorted by class, then by row),
    ``dual_coef_`` ``[n_classes - 1, n_SV]`` and ``intercept_`` (``-rho``)
    laid out as sklearn lays them out for more than two classes."""

    def __init__(self, C: float = 1.0, gamma: float = 1.0, tol: float = 1e-3,
                 device: str | torch.device = "cuda"):
        self.C, self.gamma, self.tol, self.device = C, gamma, tol, device
        self.grid: Optional[OvOGrid] = None
        self.point = 0  # this SVC's index into grid.points

    @classmethod
    def from_grid(cls, grid: OvOGrid, point: int) -> "SVC":
        """The SVC fitted at ``grid.points[point]``."""
        c, g = grid.points[point]
        svc = cls(C=c, gamma=g, tol=grid.tol, device=grid.device)
        svc.grid, svc.point = grid, point
        return svc

    def fit(self, x, y) -> "SVC":
        self.grid = OvOGrid(x, y, [(self.C, self.gamma)], self.tol, self.device)
        return self

    @property
    def classes_(self) -> np.ndarray:
        return self.grid.classes

    @property
    def n_iter_(self) -> np.ndarray:
        k = len(self.grid.pairs)
        return self.grid.iters[self.point * k:(self.point + 1) * k].cpu().numpy()

    def _coef(self) -> np.ndarray:
        return self.grid.coef[self.point].cpu().numpy()

    @property
    def support_(self) -> np.ndarray:
        nz = (self._coef() != 0).any(0)
        order = np.argsort(self.grid.row_class, kind="stable")
        return order[nz[order]]

    @property
    def dual_coef_(self) -> np.ndarray:
        coef, sv, cls = self._coef(), self.support_, self.grid.row_class
        out = np.zeros((len(self.classes_) - 1, len(sv)))
        for k, (a, b) in enumerate(self.grid.pairs):
            for col, r in enumerate(sv):
                if cls[r] == a:
                    out[b - 1, col] = coef[k, r]
                elif cls[r] == b:
                    out[a, col] = coef[k, r]
        return out

    @property
    def intercept_(self) -> np.ndarray:
        return -self.grid.rho[self.point].cpu().numpy()

    def decision_function(self, x) -> np.ndarray:
        """libsvm's one-vs-one values ``[n, n_pairs]`` (sklearn's
        ``decision_function_shape="ovo"`` for more than two classes)."""
        return self.grid.decision_function(x, [self.point])[0].cpu().numpy()

    def predict(self, x) -> np.ndarray:
        return self.grid.predict(x, [self.point])[0]


def best_point(grid: OvOGrid, x_val, y_val) -> Tuple[int, List[float]]:
    """The first strict maximum of ``oa + aa + kappa`` on the val rows, in
    the grid's order (JAX's tie rule), and every point's score."""
    preds = grid.predict(x_val)
    scores, best, top = [], 0, -1.0
    for k in range(len(grid.points)):
        m = classification_metrics(y_val, preds[k])
        scores.append(m.oa + m.aa + m.kappa)
        if scores[-1] > top:
            best, top = k, scores[-1]
    return best, scores


class SVMRBF:
    """The two-stage grid search of ``hsimae_tpu/models/baselines/svm_rbf.py``:
    a coarse grid, then a fine one around its optimum, each scored by ``oa +
    aa + kappa`` on a 50/50 split of the training pixels drawn from ``rng``;
    the final SVC is the fine stage's at its optimum, fitted on that stage's
    train half. ``stage_stats`` keeps each stage's size, seconds (to the
    host's read of its val labels), largest SMO iteration count and every
    point's score."""

    def __init__(self, seed: int = 42, device: str | torch.device = "cuda"):
        self.name = "SVM_RBF"
        self.best_est: Optional[SVC] = None
        self.seed = seed
        self.device = device
        self.best_c = None
        self.best_gamma = None
        self.stage_stats: List[dict] = []

    def _select(self, x, y, cs, gs, rng) -> Tuple[SVC, float, float]:
        idx = np.arange(len(x))
        tr_i, tr_y, va_i, va_y = train_val_split(idx, y, 0.5, rng=rng)
        t0 = time.perf_counter()
        grid = OvOGrid(x[tr_i], tr_y, list(itertools.product(cs, gs)), device=self.device)
        best, scores = best_point(grid, x[va_i], va_y)
        self.stage_stats.append({"points": len(grid.points), "problems": grid.y.shape[0],
                                 "n_max": grid.y.shape[1], "seconds": time.perf_counter() - t0,
                                 "max_iters": int(grid.iters.max()), "scores": scores})
        c, g = grid.points[best]
        # the final fit on the train half at the best point is the grid's own
        # (libsvm is deterministic)
        return SVC.from_grid(grid, best), c, g

    def train(self, x: np.ndarray, y: np.ndarray, rng=None):
        rng = rng or np.random.default_rng(self.seed)
        _, c0, g0 = self._select(x, y, COARSE_C, COARSE_GAMMA, rng)
        fine = np.arange(-1.75, 2.0, 0.25)
        cs = [c0 * 2.0**i for i in fine]
        gs = [g0 * 2.0**i for i in fine]
        self.best_est, self.best_c, self.best_gamma = self._select(x, y, cs, gs, rng)
        return self

    def predict_scene(self, scene: np.ndarray) -> np.ndarray:
        h, w, c = scene.shape
        return self.best_est.predict(scene.reshape(-1, c)).reshape(h, w)

    def test(self, scene: np.ndarray, test_gt: np.ndarray):
        pred = self.predict_scene(scene)
        return classification_metrics(test_gt, pred), pred
