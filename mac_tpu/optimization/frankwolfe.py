"""Frank-Wolfe for maximizing concave functions over simple feasible sets.

Functional, jit-native redesign of the reference's Python loop
(reference: mac/optimization/frankwolfe.py:10-79): the whole solve is one
`lax.while_loop` whose carry is an explicit pytree

    (x, u, state, it, done_reason)

so solver state is checkpointable/resumable for free and auxiliary problem
state (e.g. the Fiedler eigenvector block) is threaded across iterations —
implementing the warm start the reference intended but never engaged
(SURVEY.md §3.1; reference mac/solvers/mac.py:114-127).

Termination semantics match the reference exactly: the candidate iterate is
*not* stepped when a tolerance check fires, i.e. we return the x at which the
(f, grad) pair was evaluated (reference: frankwolfe.py:62-76).
"""

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp


def naive_stepsize(k) -> jax.Array:
    """Classic 2/(k+2) open-loop step size (reference: frankwolfe.py:7-8)."""
    return 2.0 / (k + 2.0)


def fw_initial_carry(initial, state0, averaging: bool):
    """The frank_wolfe_with_state loop carry at step 0 — exposed so a
    host-chunked caller can construct it in a tiny init program and then
    resume via carry0 without ever compiling the carry0=None variant."""
    x0 = jnp.asarray(initial)
    inf = jnp.asarray(jnp.inf, x0.dtype)
    it0 = jnp.asarray(0, jnp.int32)
    zero = jnp.asarray(0, jnp.int32)
    xavg0 = jnp.zeros_like(x0) if averaging else x0
    return (x0, inf, state0, it0, jnp.asarray(False), xavg0, zero)


def frank_wolfe_with_state(
    initial: jax.Array,
    state0,
    problem: Callable,
    solve_lp: Callable,
    stepsize: Optional[Callable] = None,
    maxiter: int = 50,
    relative_duality_gap_tol: float = 1e-5,
    grad_norm_tol: float = 1e-10,
    verbose: bool = False,
    tail_average_from: Optional[int] = None,
    carry0=None,
    return_carry: bool = False,
):
    """Maximize a concave f via Frank-Wolfe, threading auxiliary state.

    problem(x, state) -> (f, gradf, state'): objective, supergradient, and
        updated auxiliary state (warm-start data); must be traceable.
    solve_lp(gradf) -> s: LP oracle over the feasible set.
    stepsize(x, gradf, s, k) -> gamma in [0, 1]; default 2/(k+2).

    tail_average_from: when set, the returned iterate is the MEAN of the
        evaluated iterates from that step index on (Cesaro tail average).
        With inexact (noisy) gradients, plain FW limit-cycles around the
        optimum — the last iterate's objective oscillates by several
        times the trend — while by concavity f(mean of tail) >= mean of
        tail f, so averaging removes the downside of the oscillation
        deterministically, with no extra objective evaluations. The mean
        of points in a convex feasible set stays feasible.

    carry0 / return_carry: resume protocol for HOST-CHUNKED execution
        (one bounded device program per chunk instead of one while_loop
        over the full budget — see MAC.fw_dispatch_chunk). Pass
        return_carry=True to get the raw loop carry back,
        feed it as carry0 with a larger (traceable) maxiter to continue;
        the step index, dual bound, stop flag, and Cesaro accumulator all
        live in the carry, so chunked execution is bit-identical to the
        single-program loop. The final call unpacks as usual.

    Returns (x, u, state, num_iters) with u the dual upper bound, or the
    raw carry when return_carry=True.
    """
    if stepsize is None:
        stepsize = lambda x, g, s, k: naive_stepsize(k)

    x0 = jnp.asarray(initial)
    dtype = x0.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    averaging = tail_average_from is not None

    def cond(carry):
        x, u, state, it, done, xavg, cnt = carry
        return jnp.logical_and(~done, it < maxiter)

    def body(carry):
        x, u, state, it, done, xavg, cnt = carry
        f, gradf, state_new = problem(x, state)
        s = solve_lp(gradf)
        u_new = jnp.minimum(u, f + gradf @ (s - x))
        if verbose:
            jax.debug.print(
                "FW iter {it}: f = {f}, gap = {gap}", it=it, f=f, gap=u_new - f
            )
        # Scale-aware: the reference's absolute ||grad|| < tol test
        # misfires on tiny-lambda_2 graphs (n=3e5 local loops: lambda_2 ~
        # 2e-7 makes EVERY gradient norm < 1e-8 from step one, which is
        # small scale, not convergence). min(1, |f|) leaves every
        # normal-scale graph at the reference's absolute semantics.
        small_grad = (jnp.linalg.norm(gradf)
                      < grad_norm_tol * jnp.minimum(1.0, jnp.abs(f)))
        # tol <= 0 disables the duality-gap stop entirely: with a noisy
        # (e.g. float32 inexact-eigensolve) objective the accumulated min
        # bound u can dip BELOW a later noisy f, so even `gap < 0` fires
        # spuriously — u_new - f is then noise, not a certificate.
        small_gap = jnp.logical_and(
            relative_duality_gap_tol > 0,
            (u_new - f) < relative_duality_gap_tol * jnp.abs(f))
        stop = jnp.logical_or(small_grad, small_gap)
        gamma = stepsize(x, gradf, s, it).astype(dtype)
        x_stepped = x + gamma * (s - x)
        x_new = jnp.where(stop, x, x_stepped)
        if averaging:
            # Running mean of the iterates at which f was EVALUATED.
            take = it >= tail_average_from
            cnt_new = jnp.where(take, cnt + 1, cnt)
            xavg_new = jnp.where(
                take, xavg + (x - xavg) / jnp.maximum(cnt_new, 1).astype(dtype),
                xavg)
        else:
            cnt_new, xavg_new = cnt, xavg
        return (x_new, u_new, state_new, it + 1, stop, xavg_new, cnt_new)

    if carry0 is None:
        carry0 = fw_initial_carry(x0, state0, averaging)
    carry = jax.lax.while_loop(cond, body, carry0)
    if return_carry:
        return carry
    x, u, state, it, done, xavg, cnt = carry
    if averaging:
        x = jnp.where(cnt > 0, xavg, x)
    return x, u, state, it


def frank_wolfe(
    initial,
    problem: Callable,
    solve_lp: Callable,
    stepsize: Optional[Callable] = None,
    maxiter: int = 50,
    relative_duality_gap_tol: float = 1e-5,
    grad_norm_tol: float = 1e-10,
    verbose: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Stateless Frank-Wolfe with the reference's call signature
    (problem(x) -> (f, gradf)). Returns (x, u)."""

    def problem_s(x, state):
        f, g = problem(x)
        return f, g, state

    x, u, _, _ = frank_wolfe_with_state(
        jnp.asarray(initial, dtype=jnp.result_type(float, jnp.asarray(initial))),
        0,
        problem_s,
        solve_lp,
        stepsize=stepsize,
        maxiter=maxiter,
        relative_duality_gap_tol=relative_duality_gap_tol,
        grad_norm_tol=grad_norm_tol,
        verbose=verbose,
    )
    return x, u
