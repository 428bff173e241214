"""libsvm's two-class C-SVC with an RBF kernel, solved on the tensor's device.

What ``sklearn.svm.SVC(kernel="rbf", probability=...)`` computes for two
classes with per-sample weights, after libsvm (Chang & Lin, "LIBSVM: a
library for support vector machines", and scikit-learn's copy of it):

  * the dual: minimise 1/2 a'Qa - e'a subject to 0 <= a_i <= C w_i and
    y'a = 0, with Q_ij = y_i y_j K(x_i, x_j), K(u, v) = exp(-gamma |u - v|^2)
    and y_i = +1 for the first class (in sorted order), -1 for the second;
  * SMO with Fan, Chen & Lin's second-order working-set selection
    (libsvm's ``select_working_set``, tau = 1e-12), stopped once
    m(a) - M(a) < ``tol``; no shrinking; rho as libsvm's ``calculate_rho``;
  * the two kernel columns an iteration needs are computed from X on the
    device in float64: memory grows as n d, the n^2 Gram matrix is never
    built;
  * probabilities as ``svm_binary_svc_probability``: Platt's A and B
    (``sigmoid_train``: Newton's method with backtracking on the
    prior-corrected targets) fitted on 5-fold cross-validated decision
    values, and at prediction the clipped sigmoid followed by the two-class
    pairwise coupling (``multiclass_probability``, which libsvm runs for two
    classes too).

The rows are grouped by class, first class first, as libsvm groups them, so
ties in the working-set selection break as libsvm's do (the last index
wins).  One iteration is a fixed sequence of tensor operations on 0-d and
n-long device tensors with no host read; the stopping flag is read every
``CHECK_EVERY`` iterations, the iterations past convergence being masked to
no-ops.  On a CUDA device the iterations run as a captured CUDA graph of
``GRAPH_STEPS`` iterations, replayed.

Orientation: ``decision`` here is libsvm's, positive for the first class;
``sklearn``'s ``decision_function`` is its negation (positive for the
second class), which :mod:`sed_tpu_torch.classical.svm` exposes.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

TAU = 1e-12
CHECK_EVERY = 256          # iterations between two host reads of the stop flag
GRAPH_STEPS = 32           # iterations in one captured CUDA graph
PREDICT_ELEMENTS = 1 << 25  # kernel entries computed at once when predicting
NR_FOLD = 5
MIN_PROB = 1e-7


def gamma_scale(x: np.ndarray) -> float:
    """``gamma="scale"``: 1 / (n_features * X.var()), 1 when X is constant."""
    x = np.asarray(x, dtype=np.float64)
    var = x.var()
    return float(1.0 / (x.shape[1] * var)) if var != 0 else 1.0


@dataclasses.dataclass
class DualSolution:
    alpha: torch.Tensor     # (n,) float64, in the problem's row order
    rho: float
    n_iter: int


def _pair_update(ai, aj, ci, cj, gi, gj, q, same, where, not_, zero):
    """libsvm's update of the working pair (a_i, a_j) for a curvature
    ``q``, returned as (new a_i, new a_j): for y_i != y_j along a_i - a_j
    = const, for y_i == y_j along a_i + a_j = const, each clipped to the box
    with the bound values set exactly, as ``Solver::Solve`` sets them.

    Written once for two kinds of operand: 0-d device tensors (``where`` =
    ``torch.where``, ``not_`` = ``torch.logical_not``) and Python floats
    (``where`` a conditional expression), which round alike (IEEE double,
    one operation at a time)."""
    # y_i != y_j: a_i - a_j is kept.
    delta = (-gi - gj) / q
    diff = ai - aj
    ni, nj = ai + delta, aj + delta
    gt = diff > 0
    lo1 = gt & (nj < 0)
    lo2 = not_(gt) & (ni < 0)
    ni, nj = (where(lo1, diff, where(lo2, zero, ni)),
              where(lo1, zero, where(lo2, -diff, nj)))
    gt = diff > ci - cj
    hi1 = gt & (ni > ci)
    hi2 = not_(gt) & (nj > cj)
    ni, nj = (where(hi1, ci, where(hi2, cj + diff, ni)),
              where(hi1, ci - diff, where(hi2, cj, nj)))
    # y_i == y_j: a_i + a_j is kept.
    delta = (gi - gj) / q
    total = ai + aj
    si, sj = ai - delta, aj + delta
    gt = total > ci
    up1 = gt & (si > ci)
    lo3 = not_(gt) & (sj < 0)
    si, sj = (where(up1, ci, where(lo3, total, si)),
              where(up1, total - ci, where(lo3, zero, sj)))
    gt = total > cj
    up2 = gt & (sj > cj)
    lo4 = not_(gt) & (si < 0)
    si, sj = (where(up2, total - cj, where(lo4, zero, si)),
              where(up2, cj, where(lo4, total, sj)))
    return where(same, si, ni), where(same, sj, nj)


def _py_where(cond, a, b):
    return a if cond else b


class _SMO:
    """The solver's state on the device; :meth:`step` is one iteration of
    libsvm's ``Solver::Solve`` without shrinking.

    The rows are held in reverse order, so that ``argmax``/``argmin``'s
    first index is libsvm's last; :meth:`alpha` gives them back in the
    problem's order.  ``a``, ``c``, ``y`` and ``grad`` are the rows of one
    (4, n) buffer, so the working pair's values are one gather.  On a CUDA
    device the pair's update runs on 0-d tensors; on the CPU, where a read
    costs nothing, on Python floats (the same rounding, fewer dispatches)."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, c: torch.Tensor, gamma: float,
                 tol: float):
        n, dev = x.shape[0], x.device
        self.x = x.flip(0)
        self.gamma, self.tol = gamma, tol
        self.sq = (self.x * self.x).sum(1)
        self.buf = torch.stack([torch.zeros(n, dtype=torch.float64, device=dev), c.flip(0),
                                y.flip(0), torch.full((n,), -1.0, dtype=torch.float64,
                                                      device=dev)])
        self.a, self.c, self.y, self.grad = self.buf.unbind()
        self.pos = self.y > 0
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.iters = torch.zeros((), dtype=torch.int64, device=dev)
        self.inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
        self.neg_inf = -self.inf
        self.zero = torch.zeros((), dtype=torch.float64, device=dev)
        self.host = dev.type == "cpu"

    def column(self, i: torch.Tensor) -> torch.Tensor:
        """K(X, x_i): (n,) float64, for a (1,) index tensor ``i``."""
        d = torch.addmv(self.sq + self.sq.index_select(0, i), self.x,
                        self.x.index_select(0, i).squeeze(0), alpha=-2.0)
        return torch.exp(d.mul_(-self.gamma))

    def step(self) -> None:
        y, a, grad = self.y, self.a, self.grad
        yg = y * grad
        below_c, above_0 = a < self.c, a > 0
        up = torch.where(self.pos, below_c, above_0)     # y_t a_t may grow
        low = torch.where(self.pos, above_0, below_c)    # y_t a_t may shrink
        v_up = torch.where(up, -yg, self.neg_inf)
        i = torch.argmax(v_up, 0, keepdim=True)
        gmax = v_up.index_select(0, i)
        gmax2 = torch.where(low, yg, self.neg_inf).max()
        ki = self.column(i)
        grad_diff = gmax + yg
        quad = 2.0 - 2.0 * ki                            # K_ii + K_tt - 2 K_it, K_tt = 1
        quad = torch.where(quad > 0, quad, TAU)
        cand = low & (grad_diff > 0)
        obj = torch.where(cand, -(grad_diff * grad_diff) / quad, self.inf)
        j = torch.argmin(obj, 0, keepdim=True)
        done = self.done | ((gmax + gmax2).squeeze(0) < self.tol) | ~cand.any()
        ij = torch.cat([i, j])
        pair = self.buf.index_select(1, ij)              # (a, c, y, grad) x (i, j)
        q = quad.index_select(0, j)
        if self.host:
            self.iters.add_(int(not done))
            self.done.copy_(done)
            if done:
                return
            (ai, aj), (ci, cj), (yi, yj), (gi, gj) = pair.tolist()
            ni, nj = _pair_update(ai, aj, ci, cj, gi, gj, q.item(), yi == yj,
                                  _py_where, lambda v: not v, 0.0)
            a.index_copy_(0, ij, torch.tensor([ni, nj], dtype=torch.float64))
            grad.add_(y * (ki * ((ni - ai) * yi) + self.column(j) * ((nj - aj) * yj)))
            return
        (ai, aj), (ci, cj), (yi, yj), (gi, gj) = pair.unbind()
        new = torch.stack(_pair_update(ai, aj, ci, cj, gi, gj, q.squeeze(0), yi == yj,
                                       torch.where, torch.logical_not, self.zero))
        old = pair[0]
        new = torch.where(done, old, new)
        step = (new - old) * pair[2]
        a.index_copy_(0, ij, new)
        grad.add_(y * (ki * step[0] + self.column(j) * step[1]))
        self.iters.add_((~done).to(torch.int64))
        self.done.copy_(done)

    def alpha(self) -> torch.Tensor:
        return self.a.flip(0)

    def rho(self) -> float:
        """libsvm's ``calculate_rho``: the mean of y G over the free
        variables, else the middle of the bounds' interval."""
        y, c, a = self.y, self.c, self.a
        yg = (y * self.grad).cpu().numpy()
        pos = self.pos.cpu().numpy()
        upper = (a >= c).cpu().numpy()
        lower = (a <= 0).cpu().numpy()
        free = ~upper & ~lower
        if free.any():
            return float(yg[free].sum() / free.sum())
        ub_mask = (upper & ~pos) | (lower & pos)
        lb_mask = (upper & pos) | (lower & ~pos)
        ub = yg[ub_mask].min() if ub_mask.any() else np.inf
        lb = yg[lb_mask].max() if lb_mask.any() else -np.inf
        return float((ub + lb) / 2)


def _run_graphed(smo: _SMO, max_iter: int) -> None:
    """Replay a CUDA graph of ``GRAPH_STEPS`` iterations until the stop
    flag is set (read every ``CHECK_EVERY`` iterations)."""
    def block():
        for _ in range(GRAPH_STEPS):
            smo.step()

    side = torch.cuda.Stream(device=smo.x.device)
    side.wait_stream(torch.cuda.current_stream(smo.x.device))
    with torch.cuda.stream(side):
        block()                       # warm-up iterations are real ones
    torch.cuda.current_stream(smo.x.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        block()
    steps = GRAPH_STEPS
    while not bool(smo.done) and steps < max_iter:
        for _ in range(CHECK_EVERY // GRAPH_STEPS):
            graph.replay()
        steps += CHECK_EVERY
    del graph


def solve_dual(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor, gamma: float,
               tol: float = 1e-3, graph: bool = None) -> DualSolution:
    """Solve the weighted C-SVC dual on ``x``'s device.

    ``x``: (n, d) float64; ``y``: (n,) float64 of +-1; ``c``: (n,) float64
    upper bounds C w_i.  At libsvm's max(10_000_000, 100 n) iterations it
    stops with a warning, as libsvm does.  ``graph`` (default: on CUDA)
    runs the iterations as a replayed CUDA graph; ``False`` runs them one
    by one (the tests hold the two equal).
    """
    max_iter = max(10_000_000, 100 * x.shape[0])
    smo = _SMO(x, y, c, gamma, tol)
    if graph is None:
        graph = x.device.type == "cuda"
    if graph:
        _run_graphed(smo, max_iter)
    else:
        steps = 0
        while steps < max_iter:
            for _ in range(CHECK_EVERY):
                smo.step()
            steps += CHECK_EVERY
            if bool(smo.done):
                break
    n_iter = int(smo.iters)
    if not bool(smo.done):
        warnings.warn(f"the SVC solver reached max_iter={max_iter} before tol={tol}")
    return DualSolution(smo.alpha(), smo.rho(), n_iter)


@dataclasses.dataclass
class BinaryModel:
    """A fitted two-class SVC in libsvm's orientation."""
    support: torch.Tensor          # (n_sv,) row indices of the training set
    support_vectors: torch.Tensor  # (n_sv, d) float64
    sv_coef: torch.Tensor          # (n_sv,) a_i y_i
    rho: float
    gamma: float
    n_iter: int

    def decision(self, x: torch.Tensor) -> torch.Tensor:
        """sum_i a_i y_i K(x_i, x) - rho: (len(x),) float64, positive for
        the first class."""
        return decision_values(x, self.support_vectors, self.sv_coef, self.rho, self.gamma)


def decision_values(x: torch.Tensor, sv: torch.Tensor, sv_coef: torch.Tensor, rho: float,
                    gamma: float) -> torch.Tensor:
    """K(x, sv) @ sv_coef - rho in ``x``'s dtype, the RBF kernel as
    libsvm's ``kernel_rbf`` writes it, exp(-gamma (|x|^2 + |sv|^2 - 2
    x.sv)), in row blocks of at most ``PREDICT_ELEMENTS`` kernel entries."""
    sv_sq = (sv * sv).sum(1)
    rows = max(1, PREDICT_ELEMENTS // max(1, sv.shape[0]))
    out = []
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows]
        k = torch.exp(-gamma * ((xb * xb).sum(1)[:, None] + sv_sq[None, :] - 2.0 * (xb @ sv.T)))
        out.append(k @ sv_coef - rho)
    return torch.cat(out) if out else x.new_zeros(0)


def train(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor, gamma: float,
          tol: float = 1e-3) -> BinaryModel:
    """libsvm's ``svm_train_one`` for a C-SVC on the rows grouped as libsvm
    groups them (the +1 rows, then the -1 rows, each in their given order):
    the dual, then the support (a_i > 0, as indices of the given order)
    with its coefficients a_i y_i."""
    idx = torch.arange(y.shape[0], device=y.device)
    order = torch.cat([idx[y > 0], idx[y <= 0]])
    xs, ys = x.index_select(0, order), y.index_select(0, order)
    sol = solve_dual(xs, ys, c.index_select(0, order), gamma, tol)
    support = torch.nonzero(sol.alpha > 0).squeeze(1)
    return BinaryModel(order.index_select(0, support), xs.index_select(0, support),
                       (sol.alpha * ys).index_select(0, support), sol.rho, gamma, sol.n_iter)


def sigmoid_train(dec: np.ndarray, labels: np.ndarray):
    """Platt's A, B (libsvm's ``sigmoid_train``): P(+1 | f) = 1 / (1 +
    exp(A f + B)) fitted by Newton's method with backtracking on the
    targets (N+ + 1) / (N+ + 2) and 1 / (N- + 2); ``labels`` > 0 is the
    positive class."""
    dec = np.asarray(dec, dtype=np.float64)
    pos = np.asarray(labels) > 0
    prior1 = float(pos.sum())
    prior0 = float(len(dec) - prior1)
    max_iter, min_step, sigma, eps = 100, 1e-10, 1e-12, 1e-5
    t = np.where(pos, (prior1 + 1.0) / (prior1 + 2.0), 1.0 / (prior0 + 2.0))

    def objective(a, b):
        f = dec * a + b
        return np.where(f >= 0, t * f + np.log1p(np.exp(-np.abs(f))),
                        (t - 1) * f + np.log1p(np.exp(-np.abs(f)))).sum()

    a, b = 0.0, float(np.log((prior0 + 1.0) / (prior1 + 1.0)))
    fval = objective(a, b)
    for _ in range(max_iter):
        f = dec * a + b
        e = np.exp(-np.abs(f))
        p = np.where(f >= 0, e / (1.0 + e), 1.0 / (1.0 + e))
        q = np.where(f >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
        d2 = p * q
        h11 = sigma + (dec * dec * d2).sum()
        h22 = sigma + d2.sum()
        h21 = (dec * d2).sum()
        d1 = t - p
        g1 = (dec * d1).sum()
        g2 = d1.sum()
        if abs(g1) < eps and abs(g2) < eps:
            break
        det = h11 * h22 - h21 * h21
        da = -(h22 * g1 - h21 * g2) / det
        db = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * da + g2 * db
        step = 1.0
        while step >= min_step:
            na, nb = a + step * da, b + step * db
            newf = objective(na, nb)
            if newf < fval + 0.0001 * step * gd:
                a, b, fval = na, nb, newf
                break
            step /= 2.0
        if step < min_step:
            warnings.warn("line search fails in two-class probability estimates")
            break
    else:
        warnings.warn("reaching maximal iterations in two-class probability estimates")
    return float(a), float(b)


def binary_probability(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor, gamma: float,
                       generator: torch.Generator, tol: float = 1e-3):
    """libsvm's ``svm_binary_svc_probability``: (A, B) from 5-fold
    cross-validated decision values, each fold's sub-problem keeping its
    rows' weights, the folds drawn by ``generator``'s permutation; a fold
    whose training part holds one class gives its rows +-1 (0 when empty)."""
    n = x.shape[0]
    perm = torch.randperm(n, generator=generator).to(x.device)
    dec = torch.zeros(n, dtype=torch.float64, device=x.device)
    for k in range(NR_FOLD):
        begin, end = k * n // NR_FOLD, (k + 1) * n // NR_FOLD
        held = perm[begin:end]
        kept = torch.cat([perm[:begin], perm[end:]])
        ys = y.index_select(0, kept)
        p_count = int((ys > 0).sum())
        n_count = ys.numel() - p_count
        if p_count == 0 and n_count == 0:
            dec.index_fill_(0, held, 0.0)
        elif n_count == 0:
            dec.index_fill_(0, held, 1.0)
        elif p_count == 0:
            dec.index_fill_(0, held, -1.0)
        else:
            sub = train(x.index_select(0, kept), ys, c.index_select(0, kept), gamma, tol)
            dec.index_copy_(0, held, sub.decision(x.index_select(0, held)))
    return sigmoid_train(dec.cpu().numpy(), y.cpu().numpy())


def sigmoid_predict(dec: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """libsvm's ``sigmoid_predict``: 1 / (1 + exp(A f + B)), written so
    that neither branch overflows."""
    f = dec * a + b
    e = torch.exp(-f.abs())
    return torch.where(f >= 0, e / (1.0 + e), 1.0 / (1.0 + e))


def couple_two(r01: torch.Tensor) -> torch.Tensor:
    """libsvm's ``multiclass_probability`` for k = 2, a row at a time in
    vectors: (n,) pairwise P(first | first or second) -> (n, 2) class
    probabilities.  Each row iterates until its own max error < 0.005 / k
    (at most 100 iterations), as libsvm's loop breaks."""
    k, max_iter = 2, 100
    eps = 0.005 / k
    r10 = 1.0 - r01
    q00, q11, q01 = r10 * r10, r01 * r01, -r10 * r01
    p0 = torch.full_like(r01, 1.0 / k)
    p1 = torch.full_like(r01, 1.0 / k)
    running = torch.ones_like(r01, dtype=torch.bool)
    for it in range(max_iter):
        qp0 = q00 * p0 + q01 * p1
        qp1 = q01 * p0 + q11 * p1
        pqp = p0 * qp0 + p1 * qp1
        err = torch.maximum((qp0 - pqp).abs(), (qp1 - pqp).abs())
        running = running & (err >= eps)
        # t = 0
        diff = (-qp0 + pqp) / q00
        n0 = p0 + diff
        pqp2 = (pqp + diff * (diff * q00 + 2 * qp0)) / (1 + diff) / (1 + diff)
        qp0b, n0 = (qp0 + diff * q00) / (1 + diff), n0 / (1 + diff)
        qp1b, n1 = (qp1 + diff * q01) / (1 + diff), p1 / (1 + diff)
        # t = 1
        diff = (-qp1b + pqp2) / q11
        n1 = n1 + diff
        n0, n1 = n0 / (1 + diff), n1 / (1 + diff)
        p0 = torch.where(running, n0, p0)
        p1 = torch.where(running, n1, p1)
        if (it + 1) % 8 == 0 and not bool(running.any()):   # read the flags now and then
            break
    return torch.stack([p0, p1], 1)


def probability(dec: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """libsvm's ``svm_predict_probability`` for two classes: (n, 2)."""
    r01 = sigmoid_predict(dec, a, b).clamp(MIN_PROB, 1 - MIN_PROB)
    return couple_two(r01)
