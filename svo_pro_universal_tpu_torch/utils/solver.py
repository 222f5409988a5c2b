"""Generic Gauss-Newton / Levenberg-Marquardt drivers.

Counterpart of ``svo_pro_universal_tpu/utils/solver.py`` (reference
mini_least_squares_solver.h:53, GN loop mini_least_squares_solver.hpp:42,
LM :110). The JAX package runs a ``lax.while_loop``; here a Python loop
runs ``max_iter`` rounds with the convergence test kept on the device as a
``done`` flag: a finished solve stops changing (every update is masked by
it) and no round reads anything back to the host, so the loop costs no
synchronization and returns what the while-loop returns.

Conventions: ``evaluate(state) -> (H, g, chi2)`` with H = Σ JᵀWJ and
g = −Σ JᵀWr; step dx = (H + μ·diag(H))⁻¹ g; ``update(state, dx) -> state``.
A state is a tensor or a (named) tuple of them.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class SolveResult(NamedTuple):
    state: Any
    chi2: torch.Tensor
    n_iter: torch.Tensor
    converged: torch.Tensor


def _tree_where(mask: torch.Tensor, a, b):
    """``torch.where(mask, a, b)`` over matching (named) tuples of
    tensors."""
    if isinstance(a, tuple):
        return type(a)(*(_tree_where(mask, x, y) for x, y in zip(a, b))) \
            if hasattr(a, "_fields") else tuple(
                _tree_where(mask, x, y) for x, y in zip(a, b))
    return torch.where(mask, a, b)


def solve_normal_eq(H: torch.Tensor, g: torch.Tensor, mu=0.0,
                    eps: float = 1e-10) -> torch.Tensor:
    """Solve (H + mu·diag(H) + eps·I) dx = g for small D; a singular or
    non-finite system gives a zero step (no exception, no host read)."""
    D = H.shape[-1]
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    damp = mu * diag + eps
    Hd = H + torch.eye(D, dtype=H.dtype, device=H.device) * damp[..., None, :]
    dx = torch.linalg.solve_ex(Hd, g[..., :, None]).result[..., 0]
    return torch.where(torch.isfinite(dx), dx, 0.0)


def gauss_newton(evaluate: Callable, update: Callable, state0: Any,
                 max_iter: int = 10, min_update_sq: float = 1e-10,
                 keep_best: bool = True) -> SolveResult:
    """Plain GN keeping the best state seen (the reference's trials/rho
    logic without a host sync per iteration)."""
    _, _, chi2 = evaluate(state0)
    dev = chi2.device
    state = best = state0
    n_iter = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        active = ~done
        H, g, _ = evaluate(state)
        dx = solve_normal_eq(H, g)
        new_state = update(state, dx)
        _, _, new_chi2 = evaluate(new_state)
        if keep_best:
            keep = active & (new_chi2 < chi2)
            best = _tree_where(keep, new_state, best)
            chi2 = torch.where(keep, new_chi2, chi2)
        else:
            best = _tree_where(active, new_state, best)
            chi2 = torch.where(active, new_chi2, chi2)
        state = _tree_where(active, new_state, state)
        n_iter = n_iter + active.to(torch.int32)
        done = done | (torch.sum(dx * dx) < min_update_sq)
    return SolveResult(best, chi2, n_iter, done)


def levenberg_marquardt(evaluate: Callable, update: Callable, state0: Any,
                        max_iter: int = 10, mu_init: float = 0.01,
                        nu_init: float = 2.0, min_update_sq: float = 1e-10
                        ) -> SolveResult:
    """LM with multiplicative damping adaptation (reference LM loop :110)."""
    _, _, chi2 = evaluate(state0)
    dev = chi2.device
    state = state0
    mu = torch.full((), mu_init, dtype=torch.float32, device=dev)
    nu = torch.full((), nu_init, dtype=torch.float32, device=dev)
    n_iter = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        active = ~done
        H, g, _ = evaluate(state)
        dx = solve_normal_eq(H, g, mu=mu)
        cand = update(state, dx)
        _, _, chi2_new = evaluate(cand)
        ok = chi2_new < chi2
        take = active & ok
        state = _tree_where(take, cand, state)
        chi2 = torch.where(take, chi2_new, chi2)
        mu_next = torch.where(ok, mu * torch.clamp(1.0 - nu * 0.1,
                                                   min=1.0 / 3.0), mu * nu)
        nu_next = torch.where(ok, torch.full_like(nu, nu_init), nu * 2.0)
        mu = torch.where(active, mu_next, mu)
        nu = torch.where(active, nu_next, nu)
        n_iter = n_iter + active.to(torch.int32)
        done = done | ((torch.sum(dx * dx) < min_update_sq) & ok)
    return SolveResult(state, chi2, n_iter, done)
