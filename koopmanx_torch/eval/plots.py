"""The reference's matplotlib figure set (counterpart of
``koopmanx/eval/plots.py``, with its signatures, labels, styles and file
names).

Each function takes logged arrays and an optional matplotlib Axes: the
port's logs and models as tensors on any device (copied to the host with
``.detach().cpu()``), or numpy arrays. The figures mirror the reference's:
tracking with/without the update overlaid (duffing.py:1031-1051),
lifted-coordinate panels (:346-390), drift curves, input trace, phase
portrait with the invariant-ellipsoid section
(Revise_2/Koopman_update.m:521-535). matplotlib is imported only when a
figure is drawn (``eval/__init__.py`` does not import this module), so a
machine without it runs everything else. :func:`eigenfunction_grid` needs
no matplotlib: it lifts its grid through the port's dictionary on the
dictionary's own device and dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..tree import host_numpy


def _np(a) -> np.ndarray:
    """A host numpy copy of a tensor on any device (``np.asarray`` of a
    CUDA tensor raises), or ``np.asarray`` of anything else."""
    return host_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def tracking(
    x,
    r,
    h: float = 0.05,
    x_compare=None,
    labels=("online update", "static model"),
    channel: int = 0,
    ax=None,
):
    """Tracking trajectory vs reference; optionally overlay a second run
    (the reference's central with/without-update comparison figure)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    t = h * np.arange(_np(x).shape[0])
    ax.plot(t, _np(x)[:, channel], label=labels[0], linewidth=2.0)
    if x_compare is not None:
        ax.plot(
            t,
            _np(x_compare)[:, channel],
            label=labels[1],
            linewidth=1.5,
            alpha=0.8,
        )
    ax.plot(
        t,
        _np(r)[:, 0],
        linestyle="--",
        label="reference",
        linewidth=1.5,
    )
    ax.set_xlabel("$t/s$")
    ax.set_ylabel(f"$x_{channel + 1}$")
    ax.grid(True)
    ax.legend()
    return ax


def lifted_coordinates(z_traj, h: float = 0.05, ncols: int = 4, fig=None):
    """Panel per lifted coordinate Ψ_i(x) (duffing.py:346-369)."""
    plt = _plt()
    z = _np(z_traj)
    nlift = z.shape[1]
    nrows = -(-nlift // ncols)
    if fig is None:
        fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2 * nrows))
    else:
        axes = fig.subplots(nrows, ncols)
    t = h * np.arange(z.shape[0])
    for i in range(nlift):
        ax = np.asarray(axes).ravel()[i]
        ax.plot(t, z[:, i])
        ax.set_ylabel(f"$\\Psi_{{{i + 1}}}$")
        ax.grid(True)
    fig.tight_layout()
    return fig


def drift_curves(drift_a, drift_b, drift_c, h: float = 0.05, ax=None):
    """Per-step model-drift norms (duffing.py:985-990)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    t = h * np.arange(len(_np(drift_a)))
    ax.semilogy(t, _np(drift_a), label="$\\|A_{k+1}-A_k\\|$")
    ax.semilogy(t, _np(drift_b), label="$\\|B_{k+1}-B_k\\|$")
    ax.semilogy(t, _np(drift_c), label="$\\|C_{k+1}-C_k\\|$")
    ax.set_xlabel("$t/s$")
    ax.grid(True)
    ax.legend()
    return ax


def input_trace(u, h: float = 0.05, bounds=None, ax=None):
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    u = _np(u)
    t = h * np.arange(u.shape[0])
    for j in range(u.shape[1]):
        label = "$u$" if u.shape[1] == 1 else f"$u_{{{j + 1}}}$"
        ax.plot(t, u[:, j], label=label)
    if u.shape[1] > 1:
        ax.legend()
    if bounds is not None:
        ax.axhline(bounds[0], linestyle=":", color="r")
        ax.axhline(bounds[1], linestyle=":", color="r")
    ax.set_xlabel("$t/s$")
    ax.set_ylabel("$u$")
    ax.grid(True)
    return ax


def phase_portrait(x, ellipsoid: Optional[np.ndarray] = None, center=None, ax=None):
    """(x1, x2) phase plot with optional invariant-ellipsoid section: given
    the 2x2 section matrix E (from chol(C P C'/gamma)), draws
    {c + E^{-1} [cos t; sin t]} (Revise_2/Koopman_update.m:521-535)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    x = _np(x)
    ax.plot(x[:, 0], x[:, 1], linewidth=1.5)
    ax.scatter([x[0, 0]], [x[0, 1]], marker="o", c="g", label="start")
    ax.scatter([x[-1, 0]], [x[-1, 1]], marker="x", c="r", label="end")
    if ellipsoid is not None:
        th = np.linspace(0, 2 * np.pi, 200)
        circ = np.stack([np.cos(th), np.sin(th)])
        pts = np.linalg.solve(_np(ellipsoid), circ)
        c = np.zeros(2) if center is None else _np(center)
        ax.plot(c[0] + pts[0], c[1] + pts[1], "k--", label="invariant set")
    ax.set_xlabel("$x_1$")
    ax.set_ylabel("$x_2$")
    ax.grid(True)
    ax.legend()
    return ax


def training_scatter(x_data, ax=None):
    """Training-data scatter in the (x1, x2) plane (the reference plots the
    collected snapshots before fitting, duffing.py:346-352)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    x = _np(x_data)
    if x.ndim > 2:
        x = x.reshape(-1, x.shape[-1])
    if x.shape[-1] == 1:
        ax.scatter(np.arange(x.shape[0]), x[:, 0], s=2, alpha=0.4)
        ax.set_xlabel("snapshot")
        ax.set_ylabel("$x$")
    else:
        ax.scatter(x[:, 0], x[:, 1], s=2, alpha=0.4)
        ax.set_xlabel("$x_1$")
        ax.set_ylabel("$x_2$")
    ax.set_title("training snapshots")
    ax.grid(True)
    return ax


def reconstruction(x_true, x_recon, h: float = 0.05, fig=None):
    """Per-channel state vs decoder/C-map reconstruction subplots
    (duffing.py:354-390: x_i overlaid with Dec(Enc(x))_i)."""
    plt = _plt()
    xt = _np(x_true)
    xr = _np(x_recon)
    n = xt.shape[1]
    if fig is None:
        fig, axes = plt.subplots(n, 1, figsize=(6, 2.2 * n), squeeze=False)
        axes = axes[:, 0]
    else:
        axes = fig.subplots(n, 1, squeeze=False)[:, 0]
    t = h * np.arange(xt.shape[0])
    for i in range(n):
        axes[i].plot(t, xt[:, i], label="true", linewidth=1.5)
        axes[i].plot(t, xr[:, i], "--", label="reconstruction", linewidth=1.2)
        axes[i].set_ylabel(f"$x_{i + 1}$")
        axes[i].grid(True)
    axes[0].legend()
    axes[-1].set_xlabel("$t/s$")
    fig.tight_layout()
    return fig


def monitor_series(values, ylabel: str, ax=None, diff: bool = False):
    """One Revise_2 per-step monitor series (V, dV, eps, gamma, compensator,
    Compare_State, Minus_Set — Revise_2/Koopman_update.m:505-560 figures)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    v = _np(values)
    if v.ndim > 1:
        v = v.reshape(v.shape[0], -1)[:, 0]
    if diff:
        v = np.diff(v)
    ax.plot(v, linewidth=2.0)
    ax.set_xlabel("Steps")
    ax.set_ylabel(ylabel)
    ax.grid(True)
    return ax


def ellipsoid_rings(ellipse_series, x=None, stride: int = 1, ax=None):
    """The invariant-ellipsoid ring plot (Revise_2/Koopman_update.m:521-535):
    for each logged section matrix E_k = C P_k C'/Gamma_k draw
    {chol(E_k)^{-1} [cos t; sin t]}, overlaying the state trajectory.
    Cholesky runs HERE on host — never on the per-step device path."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    es = _np(ellipse_series)
    th = np.linspace(0, 2 * np.pi, 200)
    circ = np.stack([np.cos(th), np.sin(th)])
    for k in range(0, es.shape[0], max(stride, 1)):
        e = es[k][:2, :2]
        if not np.isfinite(e).all():
            continue
        try:
            rr = np.linalg.cholesky(e)
        except np.linalg.LinAlgError:
            continue
        pts = np.linalg.solve(rr, circ)
        ax.plot(pts[0], pts[1], linewidth=0.8, alpha=0.5)
    if x is not None:
        x = _np(x)
        ax.plot(x[:, 0], x[:, 1], "r-", linewidth=2.5, label="State trajectory")
        ax.legend()
    ax.set_xlabel("$x_1$")
    ax.set_ylabel("$x_2$")
    ax.grid(True)
    return ax


def spectrum_plot(spec, ax=None):
    """Identified-operator spectrum on the complex plane with the unit
    circle (the discrete-time stability boundary) — the diagnostic the
    reference prints as a table (duffing.py:627)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    lam = _np(spec.eigenvalues)
    th = np.linspace(0, 2 * np.pi, 400)
    ax.plot(np.cos(th), np.sin(th), "k:", linewidth=1.0, label="unit circle")
    ax.scatter(lam.real, lam.imag, c=np.abs(lam), cmap="viridis", zorder=3)
    ax.set_xlabel(r"$\mathrm{Re}\,\lambda$")
    ax.set_ylabel(r"$\mathrm{Im}\,\lambda$")
    ax.set_aspect("equal")
    ax.grid(True)
    ax.legend()
    return ax


def eigenfunction_grid(spec, dictionary, extent=(-2.0, 2.0, -2.0, 2.0),
                       resolution: int = 60):
    """Evaluate every Koopman eigenfunction phi_i(x) = (W^{-1} psi(x))_i on
    a regular state grid (host-side analysis helper).

    The reference scatters eigenVECTOR entries at the training states and
    griddata-interpolates (``DeepLearning_KoopmanControl_Approach3.py:
    288-308`` ``plotDuffingScatter``); evaluating the eigenFUNCTION on the
    grid directly is the same picture without the interpolation artifact.

    2-D systems: extent=(x1min, x1max, x2min, x2max) -> returns
    ``(grid_pts, phi)`` with phi (resolution, resolution, N) complex,
    row/col oriented for imshow(origin='lower'). 1-D: extent=(xmin, xmax)
    -> phi (resolution, N).

    The grid is lifted by the port's ``dictionary`` (a batched module) on
    the device and in the dtype of its parameters or buffers (float64 on
    the CPU for one that has none), then copied to the host.
    """
    from .modes import eigenfunctions

    if len(extent) == 2:
        xs = np.linspace(extent[0], extent[1], resolution)
        pts = xs[:, None]
        shape = (resolution,)
    else:
        x1 = np.linspace(extent[0], extent[1], resolution)
        x2 = np.linspace(extent[2], extent[3], resolution)
        g1, g2 = np.meshgrid(x1, x2)  # (res, res), row = x2, col = x1
        pts = np.stack([g1.ravel(), g2.ravel()], axis=1)
        shape = (resolution, resolution)
    like = next(iter([*dictionary.parameters(), *dictionary.buffers()]),
                torch.empty((), dtype=torch.float64))
    with torch.no_grad():
        z = dictionary(torch.as_tensor(pts, dtype=like.dtype,
                                       device=like.device))
    phi = eigenfunctions(spec, z).reshape(shape + (-1,))
    return pts.reshape(shape + (pts.shape[-1],)), phi


def eigenfunction_gallery(model, dictionary, h: float = 0.05,
                          extent=(-2.0, 2.0, -2.0, 2.0),
                          resolution: int = 60, top: int = 8,
                          part: str = "real", fig=None):
    """Heatmap per Koopman eigenfunction over the state plane, ordered by
    |lambda| (dominant first), each panel titled with its eigenvalue — the
    runnable counterpart of the reference's ``plotDuffingScatter``
    eigenfunction view (``DeepLearning_KoopmanControl_Approach3.py:254-308``).

    ``part``: 'real' (reference's choice), 'abs' (magnitude), or 'phase'.
    1-D systems get line plots instead of heatmaps.
    """
    from .modes import spectral_decomposition

    plt = _plt()
    spec = spectral_decomposition(model, h)
    pts, phi = eigenfunction_grid(spec, dictionary, extent, resolution)
    order = np.argsort(-np.abs(spec.eigenvalues))[:top]
    take = {
        "real": lambda v: v.real,
        "abs": np.abs,
        "phase": np.angle,
    }[part]
    ncols = min(4, len(order))
    nrows = -(-len(order) // ncols)
    if fig is None:
        fig, axes = plt.subplots(
            nrows, ncols, figsize=(3.4 * ncols, 3.0 * nrows), squeeze=False
        )
    else:
        axes = fig.subplots(nrows, ncols, squeeze=False)
    axes = np.asarray(axes).ravel()
    for ax in axes[len(order):]:
        ax.axis("off")
    one_d = phi.ndim == 2
    for k, idx in enumerate(order):
        ax = axes[k]
        lam = spec.eigenvalues[idx]
        vals = take(phi[..., idx])
        # match the reference's normalization (Za /= ||Za.real||)
        nrm = np.linalg.norm(vals)
        if nrm > 0:
            vals = vals / nrm
        if one_d:
            ax.plot(pts[:, 0], vals)
            ax.set_xlabel("$x$")
            ax.grid(True)
        else:
            im = ax.imshow(
                vals,
                origin="lower",
                extent=extent,
                cmap=plt.cm.Spectral_r,
                aspect="auto",
            )
            fig.colorbar(im, ax=ax, shrink=0.85)
            ax.set_xlabel("$x_1$")
            ax.set_ylabel("$x_2$")
        ax.set_title(
            f"$\\phi_{{{idx + 1}}}$, "
            f"$\\lambda={lam.real:.3f}{lam.imag:+.3f}i$",
            fontsize=9,
        )
    fig.tight_layout()
    return fig


def save_figure_bundle(
    prefix: str, log, h: float = 0.05, u_bounds=None, data=None, recon=None,
    spectral=None,
):
    """Write the standard figure set for a closed-loop run.

    Always: tracking, drift, input(+bounds), phase. With ``data`` (training
    Snapshots): the training scatter. With ``recon=(x_true, x_hat)``: the
    reconstruction subplots. With ``spectral=(model, dictionary)``: the
    Koopman spectrum + eigenfunction gallery (pass the FINAL online model
    to see what the updated operator learned). When the log carries live
    Revise_2 certificate monitors (``gamma`` nonzero): the full 11-figure
    Revise_2 counterpart set (Revise_2/Koopman_update.m:479-563) — x1/x2/u
    are covered by tracking+input, plus eps, V, dV, ellipsoid rings, gamma,
    gamma margin, compensator, Compare_State, Minus_Set.
    """
    plt = _plt()

    def _save(ax_or_fig, name):
        fig = getattr(ax_or_fig, "figure", ax_or_fig)
        fig.savefig(f"{prefix}_{name}.png", dpi=120)
        plt.close(fig)

    _save(tracking(log.x, log.r, h), "tracking")
    x = _np(log.x)
    if x.shape[1] > 1:
        _save(tracking(log.x, log.r, h, channel=1), "tracking_x2")
    _save(drift_curves(log.drift_a, log.drift_b, log.drift_c, h), "drift")
    _save(input_trace(log.u, h, u_bounds), "input")
    _save(phase_portrait(log.x), "phase")
    if data is not None:
        _save(training_scatter(getattr(data, "x", data)), "training_scatter")
    if recon is not None:
        _save(reconstruction(recon[0], recon[1], h), "reconstruction")
    if spectral is not None:
        from .modes import spectral_decomposition

        model, dictionary = spectral
        # state grid sized to the visited trajectory (pad 25%)
        lo, hi = x.min(axis=0), x.max(axis=0)
        pad = 0.25 * np.maximum(hi - lo, 1e-3)
        if x.shape[1] == 1:
            ext = (float(lo[0] - pad[0]), float(hi[0] + pad[0]))
        else:
            ext = (
                float(lo[0] - pad[0]), float(hi[0] + pad[0]),
                float(lo[1] - pad[1]), float(hi[1] + pad[1]),
            )
        _save(
            spectrum_plot(spectral_decomposition(model, h)), "spectrum"
        )
        if x.shape[1] <= 2:
            _save(
                eigenfunction_gallery(model, dictionary, h, extent=ext),
                "eigenfunctions",
            )
        # >2-state systems: the gallery needs a 2-D grid the dictionary
        # can't consume (it lifts full n-dim states) — skip it rather than
        # crash; the spectrum plot above is dimension-agnostic. Callers
        # wanting a section can slice the dictionary and call
        # eigenfunction_gallery directly.
    gamma = _np(getattr(log, "gamma", np.zeros(1)))
    if np.any(gamma != 0.0):
        _save(monitor_series(log.eps_state, r"$\epsilon$"), "epsilon")
        _save(monitor_series(log.eps_op, r"$\|\epsilon\,\mathrm{pinv}(z)\|$"), "eps_operator")
        _save(monitor_series(log.lyapunov, r"$V=\phi^T P \phi$"), "lyapunov")
        _save(monitor_series(log.lyapunov, r"$V(k+1)-V(k)$", diff=True), "lyapunov_decrease")
        _save(monitor_series(gamma, r"$\gamma_k$"), "gamma")
        _save(monitor_series(log.gamma_margin, r"$\gamma$ margin"), "gamma_margin")
        _save(monitor_series(log.compensator, "Compensator"), "compensator")
        _save(monitor_series(log.compare_state, "Compare\\_State"), "compare_state")
        _save(monitor_series(log.minus_set, "Minus\\_Set"), "minus_set")
        es = _np(log.ellipse)
        if es.shape[-1] >= 2:
            stride = max(1, es.shape[0] // 100)
            _save(ellipsoid_rings(es, log.x, stride=stride), "ellipsoid")
