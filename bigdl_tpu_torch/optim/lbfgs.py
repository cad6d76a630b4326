"""L-BFGS with a strong-Wolfe line search (counterpart of
``bigdl_tpu/optim/lbfgs.py``: ``line_search_wolfe`` :21, ``LBFGS`` :90).

The caller's ``feval(x) -> (f, g)`` evaluates the loss and its gradient
on the device (for a model: one forward and backward through the
kernels); the outer iteration -- the history of ``n_correction`` (s, y)
pairs, the two-loop recursion, the Wolfe bracketing -- is a host loop
over flat device tensors, the JAX package's order of operations.  The
host reads a device value where the JAX package calls ``float()`` or
branches on a device comparison.
"""

from typing import Callable, List

import torch


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def line_search_wolfe(feval, x, t, d, f0, g0, gtd0,
                      c1=1e-4, c2=0.9, max_iter=25, tol_change=1e-9):
    """Strong-Wolfe cubic-interpolation line search along ``d`` from
    ``x``: returns ``(f, g, t, n_evals)``."""

    def phi(step):
        f, g = feval(x + step * d)
        return f, g, _dot(g, d)

    n_evals = 0
    t_prev, f_prev, gtd_prev = 0.0, f0, gtd0
    g_prev = g0
    bracket = None

    for _ in range(max_iter):
        f_new, g_new, gtd_new = phi(t)
        n_evals += 1
        if (f_new > f0 + c1 * t * gtd0) or (n_evals > 1 and f_new >= f_prev):
            bracket = (t_prev, t, f_prev, f_new, g_prev, g_new,
                       gtd_prev, gtd_new)
            break
        if torch.abs(gtd_new) <= -c2 * gtd0:
            return f_new, g_new, t, n_evals
        if gtd_new >= 0:
            bracket = (t_prev, t, f_prev, f_new, g_prev, g_new,
                       gtd_prev, gtd_new)
            break
        t_prev, f_prev, g_prev, gtd_prev = t, f_new, g_new, gtd_new
        t = 3.0 * t  # geometric expansion

    if bracket is None:
        # expansion exhausted: (f_new, g_new) belong to the last evaluated
        # step t_prev, not the already-expanded t
        return f_new, g_new, t_prev, n_evals

    lo_t, hi_t, lo_f, hi_f, lo_g, hi_g, lo_gtd, hi_gtd = bracket
    for _ in range(max_iter):
        if abs(hi_t - lo_t) * max(abs(float(lo_gtd)), abs(float(hi_gtd))) \
                < tol_change:
            break
        # cubic interpolation between the bracket's ends
        d1 = lo_gtd + hi_gtd - 3 * (lo_f - hi_f) / (lo_t - hi_t)
        sq = d1 * d1 - lo_gtd * hi_gtd
        if sq >= 0:
            d2 = torch.sqrt(torch.as_tensor(sq)) * \
                (1.0 if hi_t > lo_t else -1.0)
            t = float(hi_t - (hi_t - lo_t)
                      * ((hi_gtd + d2 - d1) / (hi_gtd - lo_gtd + 2 * d2)))
            lo, hi = min(lo_t, hi_t), max(lo_t, hi_t)
            if not (lo < t < hi):
                t = (lo_t + hi_t) / 2
        else:
            t = (lo_t + hi_t) / 2
        f_new, g_new, gtd_new = phi(t)
        n_evals += 1
        if (f_new > f0 + c1 * t * gtd0) or (f_new >= lo_f):
            hi_t, hi_f, hi_g, hi_gtd = t, f_new, g_new, gtd_new
        else:
            if torch.abs(gtd_new) <= -c2 * gtd0:
                return f_new, g_new, t, n_evals
            if gtd_new * (hi_t - lo_t) >= 0:
                hi_t, hi_f, hi_g, hi_gtd = lo_t, lo_f, lo_g, lo_gtd
            lo_t, lo_f, lo_g, lo_gtd = t, f_new, g_new, gtd_new
    return f_new, g_new, t, n_evals


class LBFGS:
    """Limited-memory BFGS on a flat parameter tensor.

    ``optimize(feval, x)`` runs up to ``max_iter`` quasi-Newton
    iterations; with ``line_search=True`` each step satisfies the strong
    Wolfe conditions, otherwise a fixed ``learning_rate`` step is taken,
    the first scaled by ``min(1, 1/||g||_1)``.  The curvature history
    persists across ``optimize`` calls, so repeated calls go on
    minimising the same objective; ``clear_history()`` before another
    objective.  ``history_bytes()`` is the device memory the history
    holds."""

    def __init__(self, max_iter=20, max_eval=None, tolerance_fun=1e-5,
                 tolerance_x=1e-9, n_correction=100, learning_rate=1.0,
                 line_search=True):
        self.max_iter = max_iter
        self.max_eval = max_eval or int(max_iter * 1.25)
        self.tolerance_fun = tolerance_fun
        self.tolerance_x = tolerance_x
        self.n_correction = n_correction
        self.learning_rate = learning_rate
        self.line_search = line_search
        self._state = None

    def clear_history(self):
        """Drop the curvature history (before optimizing a new
        objective)."""
        self._state = None
        return self

    def history_bytes(self):
        """Bytes of the (s, y) pairs and the previous point and
        gradient."""
        if self._state is None:
            return 0
        st = self._state
        tensors = [*st["old_dirs"], *st["old_steps"]] + \
            [t for t in (st["prev_g"], st["prev_x"]) if t is not None]
        return sum(t.numel() * t.element_size() for t in tensors)

    def optimize(self, feval: Callable, x):
        """``(x_new, [f after each iteration, the first f first])``."""
        if self._state is None:
            self._state = {"old_dirs": [], "old_steps": [], "ro": [],
                           "prev_g": None, "prev_x": None, "h_diag": 1.0,
                           "f_hist": []}
        st = self._state
        f, g = feval(x)
        f_hist = [float(f)]
        n_eval = 1

        for it in range(self.max_iter):
            if float(torch.max(torch.abs(g))) <= 1e-10:  # converged
                break
            # ---- update the history ----
            if st["prev_g"] is not None:
                y = g - st["prev_g"]
                s = x - st["prev_x"]
                ys = float(_dot(y, s))
                if ys > 1e-10:
                    if len(st["old_dirs"]) >= self.n_correction:
                        st["old_dirs"].pop(0)
                        st["old_steps"].pop(0)
                        st["ro"].pop(0)
                    st["old_dirs"].append(y)
                    st["old_steps"].append(s)
                    st["ro"].append(1.0 / ys)
                    st["h_diag"] = ys / float(_dot(y, y))
            st["prev_g"], st["prev_x"] = g, x

            # ---- two-loop recursion for the direction ----
            q = -g
            k = len(st["old_dirs"])
            al: List[float] = [0.0] * k
            for i in range(k - 1, -1, -1):
                al[i] = float(_dot(st["old_steps"][i], q)) * st["ro"][i]
                q = q - al[i] * st["old_dirs"][i]
            d = q * st["h_diag"]
            for i in range(k):
                be = float(_dot(st["old_dirs"][i], d)) * st["ro"][i]
                d = d + (al[i] - be) * st["old_steps"][i]

            gtd = float(_dot(g, d))
            if gtd > -self.tolerance_x:  # not a descent direction
                break
            # the first step is lr * min(1, 1/||g||_1)
            if it == 0 and not st["old_dirs"]:
                t = min(1.0, 1.0 / float(torch.sum(torch.abs(g)))) \
                    * self.learning_rate
            else:
                t = self.learning_rate

            if self.line_search:
                f, g, t, evals = line_search_wolfe(
                    feval, x, t, d, f, g, gtd)
                x = x + t * d
                n_eval += evals
            else:
                x = x + t * d
                f, g = feval(x)
                n_eval += 1
            f_hist.append(float(f))

            # ---- convergence checks, in the reference's order ----
            if n_eval >= self.max_eval:
                break
            if float(torch.max(torch.abs(t * d))) <= self.tolerance_x:
                break
            if len(f_hist) > 1 and abs(f_hist[-1] - f_hist[-2]) \
                    < self.tolerance_fun:
                break
        return x, f_hist
