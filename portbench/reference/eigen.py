"""The plain lowest eigenpairs of a symmetric operator given by its action:
a block Davidson in float64 with the diagonal as preconditioner, a full
Rayleigh-Ritz every step and a restart to the Ritz block when the basis
is full. It starts from unit vectors on the lowest diagonal entries, with
``extra`` more than it reports, so that no root is lost to the start.
"""

from __future__ import annotations

import torch


def lowest(action, diag: torch.Tensor, k: int, extra: int = 8, tol: float = 1e-8,
           max_iter: int = 100, m_max: int = None):
    """(eigenvalues, residual norms) of the ``k`` lowest eigenpairs, in
    float64, the residual ||A x - theta x|| of each unit Ritz vector below
    ``tol``. ``action(x)`` maps (m, n) rows to their (m, n) action.
    Raises if ``max_iter`` steps do not reach ``tol``."""
    f64 = torch.float64
    diag = diag.to(f64)
    n = diag.numel()
    bs = min(k + extra, n)
    m_max = m_max or 4 * bs
    v = torch.zeros((bs, n), dtype=f64, device=diag.device)
    v[torch.arange(bs, device=diag.device), torch.argsort(diag)[:bs]] = 1.0
    w = action(v).to(f64)
    for _ in range(max_iter):
        h = v @ w.T
        theta, c = torch.linalg.eigh(0.5 * (h + h.T))
        theta, c = theta[:bs], c[:, :bs]
        x, ax = c.T @ v, c.T @ w
        r = ax - theta[:, None] * x
        res = torch.linalg.norm(r, dim=1)
        if float(res[:k].max()) <= tol:
            return theta[:k].cpu().numpy(), res[:k].cpu().numpy()
        den = diag[None, :] - theta[:, None]
        den = torch.where(den.abs() < 1e-8, torch.full_like(den, 1e-8), den)
        t = r / den
        if v.shape[0] + bs > m_max:
            v, w = x, ax
        for _ in range(2):
            t = t - (t @ v.T) @ v
        q, rr = torch.linalg.qr(t.T)
        keep = rr.diagonal().abs() > 1e-10 * torch.linalg.norm(t, dim=1).max()
        t = q.T[keep]
        v = torch.cat([v, t])
        w = torch.cat([w, action(t).to(f64)])
    raise RuntimeError(f"the reference eigensolver did not reach {tol} in {max_iter} steps "
                       f"(residuals {res[:k].max():.3e})")
