"""Eigenvector adjoints: property gradients through the fused Davidson.

``make_differentiable_eigenpairs`` (solvers/implicit_diff.py) makes the
converged eigenvectors differentiable with respect to the operator data:
the backward pass solves the projected response systems

    P (A - lambda) P y = P xbar,   P = 1 - x xᵀ

with the fused linear-equation machinery and pulls the result back through
one vector-Jacobian product of the matvec: the coupled-perturbed adjoint of
dipole and density property gradients. (One root carries the cotangent:
with cotangents on several roots the response does not converge, in either
package.)

The ground state of H(theta) = T + theta V carries a "property"
p(theta) = <x0(theta)| M |x0(theta)>, and dp/dtheta from
``torch.autograd`` is checked against central finite differences along a
scan of theta. Dense float64 products, on the card or, with
``--device cpu``, on the host.

Run: python3 examples_torch/eigenvector_adjoint.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402
from iterative_solver_torch import make_differentiable_eigenpairs  # noqa: E402


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    f64 = dict(dtype=torch.float64, device=device)
    n = 160
    rng = np.random.default_rng(3)
    t = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    T = torch.as_tensor(t + t.T + np.diag(np.linspace(0.0, 12.0, n)), **f64)
    v = rng.standard_normal((n, n)) * (0.3 / np.sqrt(n))
    V = torch.as_tensor(v + v.T, **f64)
    m = rng.standard_normal((n, n)) * (1.0 / np.sqrt(n))
    M = torch.as_tensor(m + m.T, **f64)  # the "dipole" operator

    def matvec(x, op):
        (theta,) = op
        return torch.matmul(x, (T + theta * V).T)

    pairs = make_differentiable_eigenpairs(matvec, nroots=1, m_max=12, tol=1e-11,
                                           max_iter=400, response_tol=1e-10,
                                           response_max_iter=400)
    diag = torch.diagonal(T)
    v0 = torch.zeros((1, n), **f64)
    v0[0, 0] = 1.0

    def prop(theta):
        """<x0|M|x0>: depends on theta only through the eigenvector."""
        _, x = pairs(v0, (theta,), diag)
        x0 = x[0]
        return x0 @ (M @ x0)

    print(f"{'theta':>6} {'p':>12} {'dp/dtheta':>12} {'fin.diff':>12} {'|err|':>9}")
    h = 1e-5
    worst = 0.0
    points = []
    for theta in np.linspace(0.0, 1.0, 5):
        th = torch.tensor(theta, requires_grad=True, **f64)
        p_t = prop(th)
        (grad,) = torch.autograd.grad(p_t, th)
        p, g = float(p_t.detach()), float(grad)
        with torch.no_grad():
            fd = (float(prop(torch.tensor(theta + h, **f64)))
                  - float(prop(torch.tensor(theta - h, **f64)))) / (2 * h)
        err = abs(g - fd)
        worst = max(worst, err)
        print(f"{theta:6.2f} {p:12.7f} {g:12.7f} {fd:12.7f} {err:9.2e}")
        points.append({"theta": theta, "property": p, "gradient": g,
                       "finite_difference": fd})

    assert worst < 5e-5, worst
    print("eigenvector adjoint matches finite differences")
    return _cli.report({"example": "eigenvector_adjoint", "device": device.type, "n": n,
                        "points": points, "worst": worst})


if __name__ == "__main__":
    main()
