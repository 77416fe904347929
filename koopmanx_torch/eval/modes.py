"""Koopman spectral analysis (the port's own numpy copy of
``koopmanx/eval/modes.py``; reference capability
``DeepLearning_KoopmanControl_Approach3.py:254-308`` and the A spectrum
print at ``duffing.py:627``): decompose the identified operator

  A = W diag(lambda) W^-1

Koopman eigenfunctions at states: phi_i(x) = (W^-1 psi(x))_i; Koopman
modes in output space: v_i = C W[:, i]; the prediction then decomposes as
y_k = sum_i lambda_i^k phi_i(x_0) v_i, with continuous-time frequencies
and decay rates from log(lambda)/h. Offline analysis on the host, in
float64: a model's tensors are copied there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..types import LinearModel


class KoopmanSpectrum(NamedTuple):
    eigenvalues: np.ndarray  # (N,) complex discrete-time eigenvalues
    ct_eigenvalues: np.ndarray  # (N,) log(lambda)/h continuous-time
    eigenvectors: np.ndarray  # (N, N) right eigenvectors W
    left_inverse: np.ndarray  # (N, N) W^-1
    modes: np.ndarray  # (p, N) output-space Koopman modes C W
    frequencies_hz: np.ndarray  # (N,) |Im(ct)| / 2pi
    decay_rates: np.ndarray  # (N,) Re(ct)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def spectral_decomposition(model: LinearModel, h: float = 0.05
                           ) -> KoopmanSpectrum:
    a, c = _host(model.A), _host(model.C)
    lam, w = np.linalg.eig(a)
    w_inv = np.linalg.inv(w)
    ct = np.log(lam.astype(np.complex128)) / h
    return KoopmanSpectrum(
        eigenvalues=lam,
        ct_eigenvalues=ct,
        eigenvectors=w,
        left_inverse=w_inv,
        modes=c.astype(np.complex128) @ w,
        frequencies_hz=np.abs(ct.imag) / (2.0 * np.pi),
        decay_rates=ct.real,
    )


def eigenfunctions(spec: KoopmanSpectrum, z) -> np.ndarray:
    """Every Koopman eigenfunction at lifted states z (S, N) -> (S, N)
    complex phi_i(x_s)."""
    return _host(z).astype(np.complex128) @ spec.left_inverse.T


def mode_amplitudes(spec: KoopmanSpectrum, z0) -> np.ndarray:
    """|phi_i(x0)| * ||v_i||: which modes dominate the prediction from
    z0."""
    phi0 = spec.left_inverse @ _host(z0).astype(np.complex128)
    return np.abs(phi0) * np.linalg.norm(spec.modes, axis=0)


def reconstruct_prediction(spec: KoopmanSpectrum, z0, steps: int
                           ) -> np.ndarray:
    """y_k = sum_i lambda_i^k phi_i v_i, which equals C A^k z0 (the modal
    consistency check); (T, p)."""
    phi0 = spec.left_inverse @ _host(z0).astype(np.complex128)
    powers = spec.eigenvalues[None, :] ** np.arange(steps)[:, None]
    return np.real((powers * phi0[None, :]) @ spec.modes.T)


def spectrum_summary(model: LinearModel, h: float = 0.05) -> dict:
    """The reference's sanity numbers (duffing.py:627 spectrum, :659-665
    controllability rank) as a dict."""
    spec = spectral_decomposition(model, h)
    a, b = _host(model.A), _host(model.B)
    n = a.shape[0]
    ctrb = np.concatenate(
        [np.linalg.matrix_power(a, k) @ b for k in range(n)], axis=1)
    return {
        "spectral_radius": float(np.abs(spec.eigenvalues).max()),
        "eigenvalues_abs": np.abs(spec.eigenvalues).tolist(),
        "dominant_frequency_hz": float(
            spec.frequencies_hz[np.argmax(np.abs(spec.eigenvalues))]),
        "controllability_rank": int(np.linalg.matrix_rank(ctrb)),
        "nlift": n,
    }
