"""Linear algebra ops: port of ``paddle_tpu/tensor/linalg.py``.

Torch's solvers run on the tensors' device (cuSOLVER on the card, LAPACK
on the host).  ``lstsq`` is computed from the SVD as ``jnp.linalg.lstsq``
computes it, on every device (torch's CUDA ``lstsq`` has only the
``gels`` driver, which gives no rank and no singular values).
"""

from __future__ import annotations

import torch

from ..core.dispatch import dispatch
from ._helpers import asarray, dims, normalize_axis

__all__ = [
    "matmul", "dot", "norm", "dist", "t", "cross", "cholesky",
    "cholesky_solve", "cholesky_inverse", "inv", "det", "slogdet", "svd",
    "qr", "eig", "eigh", "eigvals", "eigvalsh", "matrix_power", "matrix_rank",
    "pinv", "solve", "triangular_solve", "lstsq", "lu", "bmm", "mv",
    "multi_dot", "cond", "corrcoef", "cov", "householder_product",
    "vector_norm", "matrix_norm", "pca_lowrank",
]

from .math import matmul  # noqa: E402  (shared definition)

_INF = float("inf")


def dot(x, y, name=None):
    def impl(a, b):
        if a.ndim == 1:
            return torch.dot(a, b)
        return torch.sum(a * b, dim=-1)

    return dispatch("dot", impl, asarray(x), asarray(y), promote=0)


def t(input, name=None):
    def impl(a):
        if a.ndim < 2:
            return a
        return a.permute(*reversed(range(a.ndim)))

    return dispatch("t", impl, asarray(input))


def norm(x, p=None, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)

    def impl(a):
        if p is None or p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(torch.square(a)))
            return torch.linalg.norm(a, None, ax, keepdim)
        if p == "nuc":
            return torch.linalg.norm(a, "nuc", ax, keepdim)
        if p == _INF:
            return torch.amax(torch.abs(a), dims(ax, a.ndim), keepdim)
        if p == -_INF:
            return torch.amin(torch.abs(a), dims(ax, a.ndim), keepdim)
        if ax is None:
            return torch.sum(torch.abs(a) ** p) ** (1.0 / p)
        if isinstance(ax, tuple) and len(ax) == 2:
            return torch.linalg.matrix_norm(a, p, ax, keepdim)
        return torch.sum(torch.abs(a) ** p, dims(ax, a.ndim),
                         keepdim=keepdim) ** (1.0 / p)

    return dispatch("norm", impl, asarray(x))


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)

    def impl(a):
        if ax is None:
            out = torch.linalg.vector_norm(a.reshape(-1), p)
            return out.reshape((1,) * a.ndim) if keepdim else out
        return torch.linalg.vector_norm(a, p, ax, keepdim)

    return dispatch("vector_norm", impl, asarray(x))


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return dispatch("matrix_norm", lambda a: torch.linalg.matrix_norm(
        a, p, (-2, -1), keepdim), asarray(x))


def dist(x, y, p=2, name=None):
    def impl(a, b):
        d = (a - b).reshape(-1)
        if p == 0:
            return torch.sum(d != 0).to(a.dtype)
        if p == _INF:
            return torch.amax(torch.abs(d))
        if p == -_INF:
            return torch.amin(torch.abs(d))
        return torch.sum(torch.abs(d) ** p) ** (1.0 / p)

    return dispatch("dist", impl, asarray(x), asarray(y), promote=0)


def cross(x, y, axis=9, name=None):
    def impl(a, b):
        ax = axis
        if ax == 9:  # paddle default: first axis with dim 3
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)

    return dispatch("cross", impl, asarray(x), asarray(y), promote=0)


def cholesky(x, upper=False, name=None):
    return dispatch("cholesky", lambda a: torch.linalg.cholesky(
        a, upper=upper), asarray(x))


def _lower(chol, upper):
    return chol.mT.conj() if upper else chol


def cholesky_solve(x, y, upper=False, name=None):
    # two triangular solves reading only the factor's triangle, as the
    # reference's (its gradient is that triangle's)
    def impl(b, chol):
        low = _lower(chol, upper)
        z = torch.linalg.solve_triangular(low, b, upper=False)
        return torch.linalg.solve_triangular(low.mT.conj(), z, upper=True)

    return dispatch("cholesky_solve", impl, asarray(x), asarray(y),
                    promote=0)


def cholesky_inverse(x, upper=False, name=None):
    def impl(chol):
        low = _lower(chol, upper)
        eye = torch.eye(low.shape[-1], dtype=low.dtype, device=low.device)
        z = torch.linalg.solve_triangular(low, eye, upper=False)
        return z.mT.conj() @ z

    return dispatch("cholesky_inverse", impl, asarray(x))


def inv(x, name=None):
    return dispatch("inv", torch.linalg.inv, asarray(x))


def det(x, name=None):
    return dispatch("det", torch.linalg.det, asarray(x))


def slogdet(x, name=None):
    def impl(a):
        sign, logabs = torch.linalg.slogdet(a)
        return torch.stack([sign, logabs])

    return dispatch("slogdet", impl, asarray(x))


def svd(x, full_matrices=False, name=None):
    """Returns (U, S, VH) with x = U @ diag(S) @ VH."""
    return dispatch("svd", lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), asarray(x))


def qr(x, mode="reduced", name=None):
    def impl(a):
        if mode == "r":
            return torch.linalg.qr(a, mode="r")[1]
        return tuple(torch.linalg.qr(a, mode=mode))

    return dispatch("qr", impl, asarray(x))


def _real_if_real(*arrays):
    """numpy's ``eig`` rule, which the reference's host LAPACK follows:
    real results when every eigenvalue is real (a host read)."""
    if not bool(torch.any(arrays[0].imag != 0)):
        return tuple(a.real.contiguous() for a in arrays)
    return arrays


def eig(x, name=None):
    return dispatch("eig", lambda a: _real_if_real(*torch.linalg.eig(a)),
                    asarray(x), n_diff=0)


def eigh(x, UPLO="L", name=None):
    return dispatch("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO)),
                    asarray(x))


def eigvals(x, name=None):
    return dispatch("eigvals", lambda a: _real_if_real(
        torch.linalg.eigvals(a))[0], asarray(x), n_diff=0)


def eigvalsh(x, UPLO="L", name=None):
    return dispatch("eigvalsh", lambda a: torch.linalg.eigvalsh(a, UPLO),
                    asarray(x))


def matrix_power(x, n, name=None):
    return dispatch("matrix_power", lambda a: torch.linalg.matrix_power(
        a, n), asarray(x))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return dispatch("matrix_rank", lambda a: torch.linalg.matrix_rank(
        a, rtol=tol, hermitian=hermitian), asarray(x), nondiff=[True])


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return dispatch("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), asarray(x))


def solve(x, y, name=None):
    return dispatch("solve", torch.linalg.solve, asarray(x), asarray(y),
                    promote=0)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def impl(a, b):
        if transpose:
            a, up = a.mT, not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return dispatch("triangular_solve", impl, asarray(x), asarray(y),
                    promote=0)


def lstsq(x, y, rcond=None, driver=None, name=None):
    def impl(a, b):
        m, n = a.shape[-2], a.shape[-1]
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        rc = torch.finfo(a.dtype).eps * max(m, n) if rcond is None else rcond
        keep = s > rc * s[..., :1]
        s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0),
                            torch.zeros_like(s))
        vec = b.ndim == a.ndim - 1
        bb = b.unsqueeze(-1) if vec else b
        sol = vh.mT @ (s_inv.unsqueeze(-1) * (u.mT @ bb))
        rank = keep.sum(-1).to(torch.int32)
        if int(rank) == n and m > n:
            res = torch.sum(torch.abs(bb - a @ sol) ** 2, dim=-2)
            res = res[..., 0] if vec else res
        else:
            res = torch.zeros((0,), dtype=a.dtype, device=a.device)
        return (sol[..., 0] if vec else sol), res, rank, s

    return dispatch("lstsq", impl, asarray(x), asarray(y), n_diff=1,
                    promote=0)


def lu(x, pivot=True, get_infos=False, name=None):
    def impl(a):
        lu_, piv = torch.linalg.lu_factor(a)
        piv = piv.to(torch.int32)
        if get_infos:
            return lu_, piv, torch.zeros((), dtype=torch.int32,
                                         device=a.device)
        return lu_, piv

    return dispatch("lu", impl, asarray(x), n_diff=1)


def bmm(x, y, name=None):
    return dispatch("bmm", torch.matmul, asarray(x), asarray(y), promote=0)


def mv(x, vec, name=None):
    return dispatch("mv", torch.matmul, asarray(x), asarray(vec),
                    promote=0)


def multi_dot(x, name=None):
    return dispatch("multi_dot", lambda *arrays: torch.linalg.multi_dot(
        arrays), *[asarray(t) for t in x], promote=0)


def cond(x, p=None, name=None):
    return dispatch("cond", lambda a: torch.linalg.cond(a, p), asarray(x))


def corrcoef(x, rowvar=True, name=None):
    return dispatch("corrcoef", lambda a: torch.corrcoef(
        a if rowvar else a.mT), asarray(x))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return dispatch("cov", lambda a: torch.cov(
        a if rowvar else a.mT, correction=1 if ddof else 0), asarray(x))


def householder_product(x, tau, name=None):
    def impl(a, t_):
        m, n = a.shape[-2], a.shape[-1]
        eye = torch.eye(m, dtype=a.dtype, device=a.device)
        q = eye
        rows = torch.arange(m, device=a.device)
        for i in range(n):
            col = a[..., :, i]
            col = torch.where(rows == i, torch.ones_like(col), col)
            v = torch.where(rows < i, torch.zeros_like(col), col)[..., :, None]
            # the reference's broadcast of tau's i-th column
            q = q @ (eye - t_[..., i] * (v @ v.mT))
        return q[..., :, :n]

    return dispatch("householder_product", impl, asarray(x), asarray(tau),
                    promote=0)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    def impl(a):
        k = q if q is not None else min(6, a.shape[-2], a.shape[-1])
        b = a - torch.mean(a, dim=-2, keepdim=True) if center else a
        u, s, vh = torch.linalg.svd(b, full_matrices=False)
        return u[..., :k], s[..., :k], vh.mT[..., :k]

    return dispatch("pca_lowrank", impl, asarray(x))
