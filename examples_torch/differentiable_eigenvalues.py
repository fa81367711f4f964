"""Differentiable eigensolves: forces along a model potential curve.

``torch.autograd`` flows through the fused Davidson solve by the
Hellmann-Feynman rule (iterative_solver_torch/solvers/implicit_diff.py):
the backward pass costs one vector-Jacobian product of the matvec and never
differentiates the iteration. A model Hamiltonian H(theta) = T + theta V is
scanned and the ground-state "force" -dE0/dtheta is compared with central
finite differences at every point. Dense float64 products, on the card or,
with ``--device cpu``, on the host.

Run: python3 examples_torch/differentiable_eigenvalues.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402
from iterative_solver_torch import make_differentiable_eigenvalues  # noqa: E402


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    f64 = dict(dtype=torch.float64, device=device)
    n, nroots = 200, 1
    rng = np.random.default_rng(0)
    t = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    T = torch.as_tensor(t + t.T + np.diag(np.linspace(0.0, 15.0, n)), **f64)
    v = rng.standard_normal((n, n)) * (0.3 / np.sqrt(n))
    V = torch.as_tensor(v + v.T, **f64)

    def matvec(x, op):
        theta, = op
        return torch.matmul(x, (T + theta * V).T)

    eigfn = make_differentiable_eigenvalues(matvec, nroots, 8, tol=1e-11, max_iter=300)
    diag = torch.diagonal(T)
    v0 = torch.zeros((nroots, n), **f64)
    v0[0, 0] = 1.0

    def energy(theta):
        return eigfn(v0, (theta,), diag)[0]

    points = []
    for theta in np.linspace(-0.5, 0.5, 5):
        th = torch.tensor(theta, requires_grad=True, **f64)
        e_t = energy(th)
        iterations = eigfn.last_iterations
        (grad,) = torch.autograd.grad(-e_t, th)
        e, f = float(e_t.detach()), float(grad)
        eps = 1e-6
        with torch.no_grad():
            fd = -(float(energy(torch.tensor(theta + eps, **f64)))
                   - float(energy(torch.tensor(theta - eps, **f64)))) / (2 * eps)
        assert abs(f - fd) < 1e-5 * max(1.0, abs(fd)), (theta, f, fd)
        print(f"theta={theta:+.2f}: E0={e:+.6f}  force={f:+.6f}  (fd {fd:+.6f})")
        points.append({"theta": theta, "energy": e, "force": f, "finite_difference": fd,
                       "iterations": iterations})
    print("gradients match finite differences at every scan point")
    return _cli.report({"example": "differentiable_eigenvalues", "device": device.type,
                        "n": n, "points": points})


if __name__ == "__main__":
    main()
