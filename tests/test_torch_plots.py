"""koopmanx_torch's figure set (``eval/plots.py``, ``cli --figures``)
against the JAX package's, on the CPU with matplotlib's Agg backend.

Every one of the 13 functions draws, in both packages, the same log (made
from a numpy seed: the JAX side gets jax arrays, the port's side torch
tensors) and what was drawn is compared artist by artist: each axes'
lines (data, style, colour, label), collections (offsets, colour arrays),
images (arrays, extents), titles, axis labels, scales, legend texts, and
the number of axes. The arrays are held to 1e-10 of the largest entry
of JAX's (or of 1). ``eigenfunction_grid`` is held to JAX's on the
2-D Duffing and the 1-D toy1d model (the pipelines carried across with
``convert.pipeline_from_numpy``) within 1e-10; the figure bundle and the
CLI's ``run``/``modes --figures`` write JAX's file sets.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib  # noqa: E402

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from koopmanx import cli as jcli  # noqa: E402
from koopmanx import configs as JC  # noqa: E402
from koopmanx.eval import modes as jmodes  # noqa: E402
from koopmanx.eval import plots as jplots  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402

from koopmanx_torch import cli as tcli  # noqa: E402
from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy  # noqa: E402
from koopmanx_torch.eval import modes as tmodes  # noqa: E402
from koopmanx_torch.eval import plots as tplots  # noqa: E402
from koopmanx_torch.run import resolve_weights_path  # noqa: E402

from test_torch_vdp import arrays_from_jax  # noqa: E402

F64 = torch.float64
T = 40
RTOL = 1e-10
MONITORS = ("eps_state", "eps_op", "lyapunov", "gamma_margin", "compensator",
            "compare_state", "minus_set")


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


class Log:
    def __init__(self, **fields):
        self.__dict__.update(fields)


def make_logs(gamma: bool, seed=0):
    """One log in both packages' types: x (T, 2), r, u (T, 1), the drift
    norms and, with ``gamma``, the Revise_2 monitors and a series of
    positive-definite 2 x 2 ellipse sections (one non-finite step, which
    the ring plot skips)."""
    rng = np.random.default_rng(seed)
    f = {"x": np.cumsum(rng.normal(size=(T, 2)) * 0.1, axis=0),
         "r": np.ones((T, 2)), "u": rng.uniform(-2, 2, (T, 1))}
    for k in ("drift_a", "drift_b", "drift_c", "residual"):
        f[k] = rng.uniform(1e-4, 1.0, T)
    f["gamma"] = rng.uniform(1, 10, T) if gamma else np.zeros(T)
    for k in MONITORS:
        f[k] = rng.normal(size=T)
    m = rng.normal(size=(T, 2, 2))
    f["ellipse"] = m @ np.swapaxes(m, 1, 2) + 0.5 * np.eye(2)
    f["ellipse"][3] = np.nan
    return (Log(**{k: jnp.asarray(v) for k, v in f.items()}),
            Log(**{k: torch.tensor(v) for k, v in f.items()}))


def drawn(fig):
    """What a figure shows, axes by axes, as plain values."""
    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(), "yscale": ax.get_yscale(),
            "axis_on": ax.axison, "aspect": str(ax.get_aspect()),
            "legend": None if legend is None else [
                t.get_text() for t in legend.get_texts()],
            "lines": [(ln.get_xydata(), ln.get_linestyle(), ln.get_linewidth(),
                       ln.get_alpha(), ln.get_label(), ln.get_color(),
                       ln.get_marker()) for ln in ax.lines],
            "collections": [(c.get_offsets(), c.get_array(),
                             c.get_facecolors()) for c in ax.collections],
            "images": [(im.get_array(), im.get_extent(), im.origin)
                       for im in ax.images],
        })
    return out


def assert_same(a, b, path="figure"):
    """Equal structure and strings; arrays within RTOL of the largest
    entry."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), path
        for i, (p, q) in enumerate(zip(a, b)):
            assert_same(p, q, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.ma.filled(np.ma.asarray(a, float), np.nan), np.ma.filled(
            np.ma.asarray(b, float), np.nan)
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), path)
        if a.size:
            scale = max(np.nanmax(np.abs(b), initial=0.0), 1.0)
            assert np.nanmax(np.abs(a - b), initial=0.0) <= RTOL * scale, path
    else:
        assert a == b, (path, a, b)


def fig_of(obj):
    return getattr(obj, "figure", obj)


def compare(jfn, tfn, jargs, targs, **kw):
    assert_same(drawn(fig_of(tfn(*targs, **kw))),
                drawn(fig_of(jfn(*jargs, **kw))))


@pytest.mark.parametrize("overlay", [False, True])
@pytest.mark.parametrize("channel", [0, 1])
def test_tracking(overlay, channel):
    (jl, tl), (jl2, tl2) = make_logs(False), make_logs(False, seed=1)
    compare(jplots.tracking, tplots.tracking,
            (jl.x, jl.r, 0.05, jl2.x if overlay else None),
            (tl.x, tl.r, 0.05, tl2.x if overlay else None), channel=channel)


def test_lifted_coordinates():
    z = np.random.default_rng(2).normal(size=(T, 6))
    compare(jplots.lifted_coordinates, tplots.lifted_coordinates,
            (jnp.asarray(z),), (torch.tensor(z),), ncols=4)


def test_drift_curves():
    jl, tl = make_logs(False)
    compare(jplots.drift_curves, tplots.drift_curves,
            (jl.drift_a, jl.drift_b, jl.drift_c),
            (tl.drift_a, tl.drift_b, tl.drift_c))


@pytest.mark.parametrize("m", [1, 2])
def test_input_trace(m):
    u = np.random.default_rng(3).uniform(-2, 2, (T, m))
    compare(jplots.input_trace, tplots.input_trace, (jnp.asarray(u),),
            (torch.tensor(u),), bounds=(-2.0, 2.0))


@pytest.mark.parametrize("ellipsoid", [False, True])
def test_phase_portrait(ellipsoid):
    jl, tl = make_logs(True)
    e = np.array([[2.0, 0.3], [0.0, 1.5]])
    kw = {"ellipsoid": e, "center": np.array([0.5, -0.2])} if ellipsoid else {}
    compare(jplots.phase_portrait, tplots.phase_portrait, (jl.x,), (tl.x,),
            **kw)


@pytest.mark.parametrize("n", [1, 2])
def test_training_scatter(n):
    x = np.random.default_rng(4).normal(size=(5, 20, n))
    compare(jplots.training_scatter, tplots.training_scatter,
            (jnp.asarray(x),), (torch.tensor(x),))


def test_reconstruction():
    jl, tl = make_logs(False)
    compare(jplots.reconstruction, tplots.reconstruction, (jl.x, jl.x * 0.9),
            (tl.x, tl.x * 0.9))


@pytest.mark.parametrize("diff", [False, True])
def test_monitor_series(diff):
    jl, tl = make_logs(True)
    compare(jplots.monitor_series, tplots.monitor_series,
            (jl.ellipse, "$V$"), (tl.ellipse, "$V$"), diff=diff)


def test_ellipsoid_rings():
    jl, tl = make_logs(True)
    compare(jplots.ellipsoid_rings, tplots.ellipsoid_rings,
            (jl.ellipse, jl.x), (tl.ellipse, tl.x), stride=2)


def _pipelines(name):
    """The preset's JAX pipeline at test size (float64) and the port's
    carried across: its dictionary and initial model."""
    jcfg, tcfg = JC.PRESETS[name](), TC.PRESETS[name]()
    for cfg in (jcfg, tcfg):
        cfg.dtype = "float64"
        if name == "toy1d":
            cfg.data = dataclasses.replace(cfg.data, n_traj=300)
        else:
            cfg.data = dataclasses.replace(cfg.data, n_step=30, n_traj=30)
    jcfg.lift.weights_path = resolve_weights_path(tcfg.lift.weights_path,
                                                  tcfg.system)
    jpipe = j_build_pipeline(jcfg)
    return jpipe, pipeline_from_numpy(arrays_from_jax(jpipe), tcfg,
                                      device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def duffing():
    return _pipelines("duffing")


@pytest.fixture(scope="module")
def toy1d():
    return _pipelines("toy1d")


def test_spectrum_plot(duffing):
    jpipe, tpipe = duffing
    compare(jplots.spectrum_plot, tplots.spectrum_plot,
            (jmodes.spectral_decomposition(jpipe.model0),),
            (tmodes.spectral_decomposition(tpipe.model0),))


@pytest.mark.parametrize("case,extent", [("duffing", (-2.0, 2.0, -1.5, 2.5)),
                                         ("toy1d", (-1.0, 1.0))])
def test_eigenfunction_grid(case, extent, request):
    """The grid points and every eigenfunction on them: 1e-10 of JAX's
    (the port lifts the grid in one batched call on the dictionary's
    device and dtype, JAX with ``vmap``)."""
    jpipe, tpipe = request.getfixturevalue(case)
    jspec = jmodes.spectral_decomposition(jpipe.model0)
    tspec = tmodes.spectral_decomposition(tpipe.model0)
    jpts, jphi = jplots.eigenfunction_grid(jspec, jpipe.dictionary, extent, 17)
    tpts, tphi = tplots.eigenfunction_grid(tspec, tpipe.dictionary, extent, 17)
    assert tpts.shape == jpts.shape and tphi.shape == jphi.shape
    assert tphi.shape[:-1] == ((17, 17) if len(extent) == 4 else (17,))
    np.testing.assert_array_equal(tpts, jpts)
    scale = max(np.abs(jphi).max(), 1.0)
    assert np.abs(tphi - jphi).max() <= RTOL * scale


@pytest.mark.parametrize("case,extent,top", [
    ("duffing", (-2.0, 2.0, -2.0, 2.0), 6), ("toy1d", (-1.0, 1.0), 2)])
@pytest.mark.parametrize("part", ["real", "abs"])
def test_eigenfunction_gallery(case, extent, top, part, request):
    """Heatmaps (2-D) or lines (1-D), one per eigenfunction by |lambda|,
    each titled with its eigenvalue and normalized to unit norm; the
    unused panels off. The toy1d model at this size has rank 2: its other
    seven eigenvalues are round-off (|lambda| < 1e-12) and their
    eigenfunctions, ~1e-15 on the grid, are round-off in either package,
    so that each normalized panel of them is noise: the gallery is held
    on the two that are not."""
    jpipe, tpipe = request.getfixturevalue(case)
    lam = np.sort(np.abs(jmodes.spectral_decomposition(
        jpipe.model0).eigenvalues))[::-1]
    assert lam[top - 1] > 0.5 and (case == "duffing" or lam[top] < 1e-12)
    compare(jplots.eigenfunction_gallery, tplots.eigenfunction_gallery,
            (jpipe.model0, jpipe.dictionary), (tpipe.model0, tpipe.dictionary),
            extent=extent, resolution=20, top=top, part=part)


def _written(directory):
    return sorted(os.listdir(directory))


@pytest.mark.parametrize("revise2", [False, True])
def test_save_figure_bundle_file_names(duffing, tmp_path, revise2):
    """The standard set with data, reconstruction and spectral figures;
    with gamma != 0 also the Revise_2 monitors and the ellipsoid rings
    (tests/test_eval.py:65)."""
    jpipe, tpipe = duffing
    jl, tl = make_logs(revise2)
    sets = []
    x_data = jpipe.data.x
    for pkg, log, pipe, data in (
            (jplots, jl, jpipe, x_data),
            (tplots, tl, tpipe, torch.tensor(np.asarray(x_data)))):
        out = tmp_path / pkg.__name__.split(".")[0]
        out.mkdir()
        pkg.save_figure_bundle(
            str(out / "fig"), log, h=0.05, u_bounds=(-2.0, 2.0), data=data,
            recon=(log.x, log.x * 0.9),
            spectral=(pipe.model0, pipe.dictionary))
        sets.append(_written(out))
    assert sets[0] == sets[1]
    assert ("fig_ellipsoid.png" in sets[1]) == revise2
    assert "fig_eigenfunctions.png" in sets[1]


@pytest.mark.parametrize("argv", [
    ["run", "--steps", "20"],
    ["modes", "--top", "4"],
])
def test_cli_figures_write_jax_file_sets(tmp_path, argv, capsys):
    """``run``/``modes --cpu --figures P`` write the files that
    ``koopmanx.cli`` writes for the same preset."""
    small = ["--preset", "duffing", "--cpu", "-o", "data.n_step=20",
             "-o", "data.n_traj=20"]
    sets = []
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        out = tmp_path / name
        out.mkdir()
        main([*argv, *small, "--figures", str(out / "p")])
        sets.append(_written(out))
    capsys.readouterr()
    assert sets[0] == sets[1] and len(sets[1]) >= 2
