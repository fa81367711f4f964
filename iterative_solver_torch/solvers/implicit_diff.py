"""Differentiable eigensolves: gradients through the fused Davidson (port of
iterative_solver_tpu/solvers/implicit_diff.py).

The converged lowest eigenvalues become differentiable functions of the
operator data via the Hellmann-Feynman theorem,

    d lambda_i / d theta = x_i^T (dA/d theta) x_i     (x_i normalised),

as a ``torch.autograd.Function`` (JAX: a ``custom_vjp``) that never
differentiates through the iteration: the forward runs the solve under
``no_grad``, the backward is one ``torch.autograd.grad`` of ``matvec(x, op)``
with respect to the operand's tensor leaves.

The operand may be any pytree of tensors (``torch.utils._pytree``): every
leaf that requires grad gets its gradient. The matvec must be
differentiable in the operand: plain tensor code is, and the packed
symmetric kernel K1 is through ``ops.kernels.symm.make_differentiable_symm_action``
(its adjoint is K1 again; tile cotangents are batched outer products).

``make_differentiable_eigenpairs`` adds the eigenvector adjoint: the
response systems P_i (A - lambda_i) P_i y_i = P_i xbar_i, solved by the
fused linear-equation loop from its zero state, as in JAX.

DEGENERACY CAVEAT: for (near-)degenerate eigenvalues the individual
eigenvectors — and therefore the per-root gradients — are only defined up
to a rotation of the degenerate subspace. Only symmetric functions of a
complete degenerate cluster have basis-independent gradients.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .fused_davidson import _dots, make_davidson_init, make_davidson_solve

Tensor = torch.Tensor


def _normalise(x: Tensor) -> Tensor:
    norms = torch.sqrt(_dots(x, x))
    return x / torch.where(norms > 0, norms, torch.ones_like(norms))[:, None]


def _operand_vjp(matvec: Callable[..., Tensor], x: Tensor, spec, leaves, needs,
                 cotangent: Tensor) -> list:
    """Gradients of <cotangent, matvec(x, op)> for each leaf of the operand
    whose ``needs`` flag is set (None for the others): one forward call of
    the matvec with those leaves tracked, then one ``torch.autograd.grad``."""
    with torch.enable_grad():
        tracked = [leaf.detach().requires_grad_(True) if need else leaf
                   for leaf, need in zip(leaves, needs)]
        out = matvec(x, pytree.tree_unflatten(tracked, spec))
        wanted = [t for t, need in zip(tracked, needs) if need]
        grads = iter(torch.autograd.grad(out, wanted, grad_outputs=cotangent,
                                         allow_unused=True) if wanted else ())
    return [next(grads) if need else None for need in needs]


def make_differentiable_eigenvalues(
    matvec: Callable[..., Tensor],
    nroots: int,
    m_max: int,
    tol: float = 1e-8,
    max_iter: int = 200,
    rr: str = "full",
):
    """Return ``eigenvalues(v0, operand, diag) -> (nroots,)`` differentiable
    w.r.t. the tensor leaves of ``operand``.

    The eigenvalues are the converged Ritz vectors' full-length Rayleigh
    quotients, exactly the quantity whose operand-gradient Hellmann-Feynman
    gives; the adjoint is accurate to O(residual^2). ``v0`` and ``diag`` get
    no gradient (the converged eigenvalues do not depend on them). After a
    call, ``eigenvalues.last_iterations`` holds the solve's iteration
    count."""
    solve = make_davidson_solve(matvec, nroots, m_max, rr=rr)
    init = make_davidson_init(matvec, nroots, m_max)

    class Eigenvalues(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v0, diag, spec, *leaves):
            operand = pytree.tree_unflatten(list(leaves), spec)
            final, eigenvalues.last_iterations = solve(init(v0, operand), operand, diag, tol,
                                                       max_iter)
            x = _normalise(final.x)
            lam = _dots(x, matvec(x, operand))
            ctx.spec = spec
            ctx.leaves = leaves
            ctx.save_for_backward(x)
            return lam

        @staticmethod
        def backward(ctx, bar):
            (x,) = ctx.saved_tensors
            # d lambda_i = x_i^T dA x_i: the cotangent on the matvec's output
            # rows is bar_i x_i, pulled back onto the operand; x is
            # stationary (Hellmann-Feynman), so no solve adjoint is needed
            grads = _operand_vjp(matvec, x, ctx.spec, ctx.leaves,
                                 ctx.needs_input_grad[3:], bar[:, None] * x)
            return (None, None, None, *grads)

    def eigenvalues(v0, operand, diag):
        leaves, spec = pytree.tree_flatten(operand)
        return Eigenvalues.apply(v0, diag, spec, *leaves)

    eigenvalues.last_iterations = None
    return eigenvalues


def make_differentiable_eigenpairs(
    matvec: Callable[..., Tensor],
    nroots: int,
    m_max: int,
    tol: float = 1e-9,
    max_iter: int = 300,
    rr: str = "full",
    response_tol: float = 1e-8,
    response_max_iter: int = 200,
    response_m_max: Optional[int] = None,
):
    """Return ``eigenpairs(v0, operand, diag) -> (evals, x)`` differentiable
    w.r.t. the operand's tensor leaves INCLUDING the eigenvectors.

    The eigenvector adjoint solves the response (coupled-perturbed) systems

        P_i (A - lambda_i) P_i  y_i = P_i xbar_i,   P_i = 1 - x_i x_i^T

    with the fused linear-equation loop (shifted and projected operator,
    row-wise diag - lambda_i Jacobi preconditioning), then pulls
    ``lambdabar_i x_i - y_i`` back through the matvec. The response systems
    are singular across an exactly degenerate cluster. After a call,
    ``eigenpairs.last_iterations`` holds the eigen solve's iteration count;
    after a backward, ``eigenpairs.last_response`` holds the response
    solve's ``(iterations, errors)``."""
    from .fused_linear import LinearState, make_linear_solve

    solve = make_davidson_solve(matvec, nroots, m_max, rr=rr)
    init = make_davidson_init(matvec, nroots, m_max)
    r_m_max = response_m_max if response_m_max is not None else m_max

    def _project(xs, z):
        return z - xs * _dots(xs, z)[:, None]

    def _response_matvec(z, op_aug):
        operand, lam, xs = op_aug
        zp = _project(xs, z)
        w = matvec(zp, operand) - lam[:, None] * zp
        w = _project(xs, w)
        # identity on span(x_i): keeps the system nonsingular; solutions of
        # rhs ⊥ x_i stay ⊥ x_i
        return w + (z - zp)

    response_solve = make_linear_solve(_response_matvec, nroots, r_m_max, response_tol,
                                       response_max_iter)

    class Eigenpairs(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v0, diag, spec, *leaves):
            operand = pytree.tree_unflatten(list(leaves), spec)
            final, eigenpairs.last_iterations = solve(init(v0, operand), operand, diag, tol,
                                                      max_iter)
            x = _normalise(final.x)
            lam = _dots(x, matvec(x, operand))
            ctx.spec = spec
            ctx.leaves = leaves
            ctx.save_for_backward(lam, x, diag)
            return lam, x

        @staticmethod
        def backward(ctx, lam_bar, x_bar):
            lam, x, diag = ctx.saved_tensors
            operand = pytree.tree_unflatten(list(ctx.leaves), ctx.spec)
            rhs = _project(x, x_bar)
            d_resp = diag[None, :].expand(x.shape) - lam[:, None]
            n = x.shape[1]
            like = dict(dtype=x.dtype, device=x.device)
            # the zero state is a valid start: the loop appends preconditioned
            # residuals (v and w are written in place, so two buffers)
            st = LinearState(
                v=torch.zeros((r_m_max, n), **like), w=torch.zeros((r_m_max, n), **like),
                mask=torch.zeros((r_m_max,), **like), k=0,
                x=torch.zeros_like(x), r=torch.zeros_like(x),
                errors=torch.ones((nroots,), **like),
            )
            b_norm = torch.sqrt(_dots(rhs, rhs))
            b_norm = torch.where(b_norm > 0, b_norm, torch.ones_like(b_norm))
            with torch.no_grad():
                final, iters = response_solve(st, (operand, lam, x), d_resp, rhs, b_norm)
            eigenpairs.last_response = (iters, final.errors)
            y = _project(x, final.x)  # numerical hygiene: re-project
            cot_rows = lam_bar[:, None] * x - y
            grads = _operand_vjp(matvec, x, ctx.spec, ctx.leaves,
                                 ctx.needs_input_grad[3:], cot_rows)
            return (None, None, None, *grads)

    def eigenpairs(v0, operand, diag):
        leaves, spec = pytree.tree_flatten(operand)
        return Eigenpairs.apply(v0, diag, spec, *leaves)

    eigenpairs.last_iterations = None
    eigenpairs.last_response = None
    return eigenpairs
