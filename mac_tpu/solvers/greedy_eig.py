"""GreedyEig: greedy lambda_2 maximization baseline.

At each of k steps, add the candidate edge whose inclusion maximizes the
algebraic connectivity (reference: mac/solvers/greedy_eig.py:86-155).

Accelerator redesign: the reference evaluates candidates one at a time with
incremental Cholesky up/downdates of a CHOLMOD factor (greedy_eig.py:
131-134) and prunes serially with the supergradient bound
lambda_2(L + e_j) <= lambda_2 + grad_j (greedy_eig.py:119-122). On an
accelerator the economical shape is the opposite: *batch* the trial evaluations — a
chunked `vmap` of the Fiedler solve over candidate weight vectors, each
warm-started from the current eigenvector block — and use the same
supergradient bound as a branch-&-bound filter to skip whole chunks.
Results are identical (argmax with a 1e-8 tie tolerance toward the lowest
index, as in the reference).
"""

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mac_tpu.ops.laplacian import build_operator
from mac_tpu.utils import fiedler as _fiedler
from mac_tpu.utils.graphs import Edge, edges_to_arrays


class GreedyEig:
    def __init__(
        self,
        odom_measurements,
        lc_measurements,
        num_poses: int,
        fiedler_tol: float = 1e-8,
        chunk: int = 64,
        dtype=None,
    ):
        fixed_idx, w_fixed = edges_to_arrays(odom_measurements)
        cand_idx, w_cand = edges_to_arrays(lc_measurements)
        self.num_poses = int(num_poses)
        self.weights = np.asarray(w_cand)
        self.edge_list = np.asarray(cand_idx)
        self._m_fixed = fixed_idx.shape[0]
        self.chunk = int(chunk)
        self.fiedler_tol = float(fiedler_tol)

        if dtype is None:
            dtype = _fiedler.default_dtype()
        self.dtype = dtype
        all_idx = np.concatenate([fixed_idx, cand_idx], axis=0)
        self.op = build_operator(all_idx, self.num_poses)
        self._w_fixed = jnp.asarray(w_fixed, dtype=dtype)
        self._w_cand = jnp.asarray(w_cand, dtype=dtype)
        self._X0 = jnp.asarray(
            _fiedler.default_block(self.num_poses), dtype=dtype
        )

        def eval_one(x, X):
            w_all = jnp.concatenate([self._w_fixed, x * self._w_cand])
            res = _fiedler.fiedler_pair_op(
                self.op, w_all, X, tol=self.fiedler_tol
            )
            return res.lam[0], res.X

        self._eval_jit = jax.jit(eval_one)
        self._eval_batch = jax.jit(jax.vmap(eval_one, in_axes=(0, None)))

    def find_fiedler_pair(self, x):
        """(lambda_2, v_2) of L(x) (parity helper; reference
        greedy_eig.py:27-47 delegates to NetworkX)."""
        lam, X = self._eval_jit(jnp.asarray(x, self.dtype), self._X0)
        return float(lam), np.asarray(X[:, 0])

    def grad_from_fiedler(self, fiedler_vec) -> np.ndarray:
        """Supergradient w_k (v_i - v_j)^2, Eq. (8) of arXiv:2203.13897
        (reference: greedy_eig.py:66-84)."""
        v = np.asarray(fiedler_vec)
        d = v[self.edge_list[:, 0]] - v[self.edge_list[:, 1]]
        return self.weights * d * d

    def subset(self, k: int) -> Tuple[np.ndarray, List[Edge]]:
        k = int(k)
        m = len(self.weights)
        solution = np.zeros(m)
        lam, X = self._eval_jit(jnp.asarray(solution, self.dtype), self._X0)
        lam = float(lam)
        grad = self.grad_from_fiedler(np.asarray(X[:, 0]))
        selected: List[Edge] = []
        tol = 1e-8

        for _ in range(k):
            unsel = np.nonzero(solution == 0)[0]
            # Supergradient upper bounds, evaluated best-first in chunks;
            # a chunk whose best bound can't beat the incumbent is skipped
            # (and so is every later chunk).
            bounds = lam + grad[unsel]
            order = unsel[np.argsort(-bounds)]
            best_l2 = 0.0
            evals = []  # (candidate index, lambda2)
            blocks = {}  # X blocks kept ONLY for the current tie group
            for s in range(0, len(order), self.chunk):
                cand = order[s : s + self.chunk]
                # Prune strictly below the tie window (best - tol): a
                # pruned candidate must not be able to join the tie group,
                # or the lowest-index tie-break below would miss it.
                if lam + grad[cand].max() < best_l2 - tol:
                    break
                xs = np.repeat(solution[None, :], len(cand), axis=0)
                xs[np.arange(len(cand)), cand] = 1.0
                lams, Xs = self._eval_batch(jnp.asarray(xs, self.dtype), X)
                lams = np.asarray(lams)
                best_l2 = max(best_l2, float(lams.max()))
                for t in range(len(cand)):
                    evals.append((int(cand[t]), float(lams[t])))
                    if float(lams[t]) >= best_l2 - tol:
                        blocks[int(cand[t])] = Xs[t]
                # Drop blocks that fell out of the tie group as best rose
                # (keeps device memory at O(tie group), not O(evaluated)).
                for idx in [i for i in blocks
                            if dict(evals)[i] < best_l2 - tol]:
                    del blocks[idx]
            # Winner: replay the reference's sequential index-order scan
            # over the collected (index, lambda2) pairs — running best from
            # 0, update iff l2 > best + 1e-8 (reference greedy_eig.py:
            # 139-144). Chunks here are visited best-bound-first, so the
            # replay happens after collection; candidates pruned by the
            # chunk bound have l2 below (final best - tol) and provably
            # cannot change the scan's last updater, so the replayed
            # winner matches the reference exactly, chained ties included.
            best_idx, run_best = -1, 0.0
            for idx, l2 in sorted(evals):
                if l2 > run_best + tol:
                    best_idx, run_best = idx, l2
            assert best_idx != -1, "no improving edge found"
            best_l2, best_X = run_best, blocks[best_idx]
            solution[best_idx] = 1.0
            selected.append(
                Edge(
                    int(self.edge_list[best_idx, 0]),
                    int(self.edge_list[best_idx, 1]),
                    float(self.weights[best_idx]),
                )
            )
            lam, X = float(best_l2), best_X
            _, v = self.find_fiedler_pair(solution)
            grad = self.grad_from_fiedler(v)
        return solution, selected
