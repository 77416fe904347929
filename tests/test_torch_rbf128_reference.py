"""The ``duffing_rbf128`` deployment of the benchmark against its plain
reference, on the CPU: the port's closed loop on the Woodbury lane of the
windowed estimator (``benchmark/configs/duffing_rbf128.json`` at a test
size, float64, the plain route) against ``benchmark.reference.Reference``
with its thin-plate RBF lift and its exact windowed ridge least squares;
the pinned k-means centers; ``lift.rbf_centers``'s accepted values; and the
Woodbury estimator's work count that ``estimator_roofline`` reads."""
import copy
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scipy.io  # noqa: E402

from benchmark import check, estimator_work, spec, traffic  # noqa: E402
from benchmark.reference import F64, Reference  # noqa: E402
from koopmanx_torch import configs as C  # noqa: E402
from koopmanx_torch.edmd import windowed  # noqa: E402
from koopmanx_torch.lifts.rbf import kmeans  # noqa: E402
from koopmanx_torch.run import (REPO_ROOT, build_pipeline, rbf_centers,  # noqa: E402
                                replicate, training_snapshots)
from koopmanx_torch.systems.data import Snapshots, collect, uniform  # noqa: E402
from koopmanx_torch.systems.library import get_system  # noqa: E402

sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
from write_rbf_centers import kmeans_centers  # noqa: E402

BATCH, STEPS, CENTERS, WINDOW = 4, 16, 14, 16
# the float64 loop against the reference, step by step, each bound with
# its reason: the applied input to 1e-8, the one-ulp floor of the Woodbury
# lane's float64 loops (the port's duffing_rff loop against itself with x0
# moved by one ulp gives u 8.6e-9 apart; here u reads ~3e-10); the states
# and the model to 1e-9 (both read ~1e-11 to 3e-11: the carried inverse,
# polished twice a step, tracks the exact ridge inverse to round-off); the
# set-up's fit and the prefilled window to 1e-10, the flagship reference
# test's bound on its fit
U_TOL, X_TOL, MODEL_TOL, SETUP_TOL = 1e-8, 1e-9, 1e-9, 1e-10


@pytest.fixture(scope="module")
def small_config(tmp_path_factory):
    """The configuration at a test size: 14 k-means centers plus the state,
    a window of 16, float64, the plain route; the centers pinned in a
    file as the benchmark's are."""
    config = copy.deepcopy(spec.part(spec.ROOT, "configs", "duffing_rbf128"))
    rc = config["run_config"]
    rc["dtype"], rc["mpc"]["qp_backend"] = "float64", "xla"
    rc["steps"], rc["switch_step"] = STEPS, STEPS // 2
    rc["lift"]["nlift"], rc["update"]["window"] = CENTERS, WINDOW
    cfg = C.RunConfig.from_dict(rc)
    cfg.lift.rbf_centers = "kmeans"
    gen = torch.Generator().manual_seed(cfg.seed)
    centers = rbf_centers(cfg, training_snapshots(cfg, gen), gen)
    path = tmp_path_factory.mktemp("centers") / "centers.mat"
    scipy.io.savemat(str(path), {"centers": centers.numpy()})
    rc["lift"]["rbf_centers"] = str(path)
    return config


def _gaps(config, **update):
    """The port's closed loop (its estimator settings changed by
    ``update``) against the reference's own loop from the same scenarios:
    the widest gaps of the set-up, the states, the inputs and the model."""
    cfg = C.RunConfig.from_dict(config["run_config"])
    for key, value in update.items():
        setattr(cfg.update, key, value)
    pipe = build_pipeline(cfg, device="cpu")
    x0, th0, th1 = traffic.draw(config["plant"], {"x0_range": [-2.0, 2.0],
                                                  "param_scale": 0.15},
                                BATCH, 11, 0, torch.float64, "cpu")
    kind = type(get_system(cfg.system).theta0)
    carry, log = pipe.closed_loop(replicate(pipe.params, BATCH), x0,
                                  replicate(pipe.model0, BATCH),
                                  replicate(pipe.rls0, BATCH), kind(**th0),
                                  kind(**th1))
    ref = Reference(config, spec.ROOT, F64)
    out = {"model0": check.worst(*(check.rel_gap(p[None], r[None]) for p, r
                                    in zip(pipe.model0, ref.model0)))}
    rls0 = {k: v[None] for k, v in pipe.rls0._asdict().items()
            if v is not None}
    out["est0"] = check._est_gap(ref, rls0, ref.estimator0(1))
    x, est = x0, ref.estimator0(BATCH)
    model = tuple(t.expand((BATCH,) + t.shape) for t in ref.model0)
    warm = torch.zeros(BATCH, ref.horizon * ref.m, dtype=torch.float64)
    out["x"] = out["u"] = 0.0
    for t in range(STEPS):
        out["x"] = max(out["x"], check.worst((x - log.x[:, t]).abs()))
        z = ref.lift(x)
        u, warm, _ = ref.control(model, z, x, warm)
        out["u"] = max(out["u"], check.worst((u - log.u[:, t]).abs()))
        x_next = ref.plant_step(x, u, ref.theta(th0, th1, t))
        est, model = ref.update(est, model, z, u, ref.lift(x_next), x_next)
        x = x_next
    out["model"] = check.worst(*(check.rel_gap(p, r) for p, r in
                                 zip(carry.model, model)))
    return out


def test_woodbury_loop_follows_the_exact_window_reference(small_config):
    gaps = _gaps(small_config)
    assert gaps["model0"] < SETUP_TOL and gaps["est0"] < SETUP_TOL, gaps
    assert gaps["u"] < U_TOL and gaps["x"] < X_TOL, gaps
    assert gaps["model"] < MODEL_TOL, gaps


def test_a_ridge_the_reference_does_not_have_fails_the_comparison(
        small_config):
    """The port with ridge 0 (floored at 1e-5) against the reference's 1.0:
    the comparison above catches it by orders of magnitude."""
    gaps = _gaps(small_config, ridge=0.0)
    assert gaps["model"] > 1e3 * MODEL_TOL and gaps["u"] > 1e3 * U_TOL, gaps


# float32 at the configuration's own size (nlift 128, W = 256, the pinned
# centers), 4 scenarios x 24 steps (switch at 12), each bound with its
# reason: the carried inverses' residual ||I - G G^-1||_2 to 0.02, under
# the prefilled Gauss-Jordan inverse's own 0.024 (it reads 0.0015 to
# 0.0047 on seeds 0-3; with the polish's iterate symmetrized, as the JAX
# package does, 0.64 and more); the carried Grams to 1e-5 of the ring's
# (they read 3e-7); the model's predictions to 5e-5 of the exact float64
# ridge solve of the ring (they read 3e-6 to 6e-6; the float32 control
# with TF32 products reads 6e-5 to 1e-4 on the same rings; without the
# refinement, 1.8e-3 to 8.2e-3); C's coefficients to 1e-5 of that
# solve's (they read 5e-8 to 4.2e-7; with gz and mc carried in float32,
# 1.1e-3)
F32_STEPS, F32_SEEDS = 24, (0, 3)
RESIDUAL_TOL, GRAM_TOL, MODEL_F32_TOL, C_TOL = 0.02, 1e-5, 5e-5, 1e-5


@pytest.fixture(scope="module")
def float32_pipeline():
    config = copy.deepcopy(spec.part(spec.ROOT, "configs", "duffing_rbf128"))
    rc = config["run_config"]
    rc["mpc"]["qp_backend"] = "xla"
    rc["steps"], rc["switch_step"] = F32_STEPS, F32_STEPS // 2
    pipe = build_pipeline(C.RunConfig.from_dict(rc), device="cpu")
    return config, pipe, Reference(config, spec.ROOT, F64)


def _float32_drift(config, pipe, ref, seed):
    """The carried statistics after the loop against the ring they
    summarize: the inverses' residual, the Grams' relative drift, the
    model's predictions against the reference's exact solve of the ring
    (``check``'s ``model`` number) and C against that solve's."""
    x0, th0, th1 = traffic.draw(config["plant"], {"x0_range": [-2.0, 2.0],
                                                  "param_scale": 0.15},
                                BATCH, seed, 0, torch.float32, "cpu")
    kind = type(get_system(config["run_config"]["system"]).theta0)
    carry, log = pipe.closed_loop(replicate(pipe.params, BATCH), x0,
                                  replicate(pipe.model0, BATCH),
                                  replicate(pipe.rls0, BATCH), kind(**th0),
                                  kind(**th1))
    st = carry.rls
    f64 = lambda t: t.to(torch.float64)
    residual = 0.0
    for gram, inv in ((st.g, st.g_inv), (st.gz, st.gz_inv)):
        eye = torch.eye(gram.shape[-1], dtype=torch.float64)
        residual = max(residual, float(torch.linalg.matrix_norm(
            eye - f64(gram) @ f64(inv), ord=2).max()))
    v = torch.cat([f64(st.zx), f64(st.u)], -1)
    fresh = v.transpose(-1, -2) @ v + torch.eye(v.shape[-1],
                                                 dtype=torch.float64)
    fields = {k: t for k, t in st._asdict().items() if t is not None}
    model = check._model_gap(ref, carry.model, fields,
                             ref.lift(f64(log.x[:, -1])), f64(log.u[:, -1]))
    exact_c = ref.model_of(ref.estimator_from(fields))[2]
    return {"residual": residual,
            "gram": check.worst(check.rel_gap(st.g, fresh)),
            "model": model,
            "c": check.worst(check.rel_gap(carry.model.C, exact_c))}


@pytest.mark.parametrize("seed", F32_SEEDS)
def test_float32_carry_stays_with_its_window(float32_pipeline, seed):
    drift = _float32_drift(*float32_pipeline, seed)
    assert drift["residual"] < RESIDUAL_TOL, drift
    assert drift["gram"] < GRAM_TOL, drift
    assert drift["model"] < MODEL_F32_TOL, drift
    assert drift["c"] < C_TOL, drift


def _symmetrized(polished):
    def polish(mat, inv, steps):
        inv = polished(mat, inv, steps)
        return 0.5 * (inv + inv.transpose(-1, -2))
    return polish


@pytest.mark.parametrize("mutation", ["symmetrized polish", "no refinement",
                                      "float32 output statistics"])
def test_float32_carry_bounds_catch_the_faults(float32_pipeline, monkeypatch,
                                               mutation):
    """The polish's iterate symmetrized (the JAX package's form) breaks the
    residual's bound; the model taken as the inverse's product alone
    breaks the model's; gz and mc carried in float32 break C's."""
    config, pipe, ref = float32_pipeline
    if mutation == "symmetrized polish":
        monkeypatch.setattr(windowed, "_polished",
                            _symmetrized(windowed._polished))
        key, tol = "residual", RESIDUAL_TOL
    elif mutation == "no refinement":
        monkeypatch.setattr(windowed, "_refined_solve",
                            lambda mat, inv, rhs, steps=1:
                            inv @ rhs.to(inv.dtype))
        key, tol = "model", MODEL_F32_TOL
    else:
        rls0 = pipe.rls0
        pipe = pipe._replace(rls0=rls0._replace(gz=rls0.gz.float(),
                                                mc=rls0.mc.float()))
        key, tol = "c", C_TOL
    drift = _float32_drift(config, pipe, ref, F32_SEEDS[0])
    assert drift[key] > 10 * tol, drift


def test_the_pinned_centers_are_the_presets_own_kmeans():
    """Bit for bit, both in one thread: with more threads Lloyd's cluster
    sums reduce in another order and the centers move by a few ulps."""
    pinned = scipy.io.loadmat(os.path.join(
        REPO_ROOT, "artifacts", "duffing_rbf128_centers.mat"))["centers"]
    assert pinned.dtype == np.float32 and pinned.shape == (126, 2)
    assert np.array_equal(kmeans_centers("duffing_rbf128").numpy(), pinned)
    config = spec.part(spec.ROOT, "configs", "duffing_rbf128")
    assert (config["run_config"]["lift"]["rbf_centers"]
            == "artifacts/duffing_rbf128_centers.mat")


@pytest.mark.parametrize("name", sorted(C.PRESETS))
def test_every_preset_draws_the_same_data_and_centers(name):
    """``training_snapshots`` is ``collect`` as ``build_pipeline`` called
    it, and an RBF preset's centers are those of its k-means or uniform
    draw from the generator that drew the data."""
    cfg = C.PRESETS[name]()
    cfg.data.n_step, cfg.data.n_traj = 20, 20
    gen_a, gen_b = (torch.Generator().manual_seed(cfg.seed) for _ in "ab")
    data = training_snapshots(cfg, gen_a)
    dtype = getattr(torch, cfg.dtype)
    want = collect(get_system(cfg.system), gen_b, n_step=20, n_traj=20,
                   h=cfg.data.h, u_range=cfg.data.u_range,
                   x0_range=cfg.data.x0_range, integrator=cfg.integrator,
                   clamp_x0=cfg.data.clamp_x0, dtype=dtype)
    for a, b in zip(data, want):
        assert torch.equal(a, b)
    if cfg.lift.kind != "rbf":
        return
    centers = rbf_centers(cfg, data, gen_a)
    if cfg.lift.rbf_centers == "kmeans":
        old = kmeans(gen_b, want.x.to(dtype), cfg.lift.nlift)[0]
    else:
        old = uniform(gen_b, (cfg.lift.nlift, get_system(cfg.system).n),
                      0.0, 1.0, dtype)
    assert torch.equal(centers, old)


@pytest.mark.parametrize("value", ["kmean", "uniform", "centers.npy"])
def test_an_unknown_centers_value_raises(value):
    cfg = C.PRESETS["duffing_rbf"]()
    cfg.lift.rbf_centers = value
    gen = torch.Generator().manual_seed(0)
    x = uniform(gen, (8, 2), -1.0, 1.0, torch.float32)
    with pytest.raises(ValueError, match="rbf_centers"):
        rbf_centers(cfg, Snapshots(x=x, y=x, u=x[:, :1]), gen)


def test_woodbury_work_by_hand_at_d_4():
    """nz = 3, m = 1 (d = 4), n = 2, polish 2: motion 4*16 + 4*9 + 4*4*3 +
    4*3*2 = 172, Sherman-Morrison 2 (4*16 + 8) + 2 (4*9 + 6) = 228,
    Newton-Schulz 2*4*64 + 2*4*27 = 728, the model ([A B] refined once, C
    twice) 6*16*3 + 10*9*2 + 2*4*3 + 4*3*2 = 516, the guard 12*2*9 = 216:
    1,860 operations; bytes: the float32 statistics 2 (2*16 + 9 + 4*3) =
    106, three rows of 9 and the model 12 + 6, 151 floats, and gz and mc
    in float64 2 (9 + 3*2) = 30 doubles: 844."""
    flops, nbytes = estimator_work.woodbury_work(1, 3, 1, 2, 2)
    assert (flops, nbytes) == (1860, 844)
    assert estimator_work.woodbury_work(5, 3, 1, 2, 2) == (5 * 1860, 5 * 844)


def test_estimator_roofline_reads_the_configurations_sizes():
    """The reader takes the polish and the outputs from the configuration
    file, the fleet and the width from the run's record, and reads
    nothing where the width is another configuration's."""
    config = spec.part(spec.ROOT, "configs", "duffing_rbf128")
    rc = config["run_config"]
    assert (rc["update"]["window"], rc["update"]["window_polish"],
            config["plant"]["n"], rc["lift"]["nlift"]) == (256, 2, 2, 126)
    rec = {"entry": "sweep", "batch": 8192, "nlift": 128, "m": 1,
           "itemsize": 4, "steps": 10,
           "profile": {"stage_us": {"estimator": 10 * 48e3}}}
    work = estimator_work.config_work(rec, config)
    assert work == estimator_work.woodbury_work(8192, 128, 1, 2, 2, 4)
    assert abs(work[0] / 8192 - 47.950e6) < 1e3
    share = spec.reader(spec.ROOT, "estimator_roofline")(rec)
    assert share == pytest.approx(100 * work[0] / 67e12 / 48e-3)
    assert spec.reader(spec.ROOT, "estimator_roofline")(
        dict(rec, nlift=8)) is None
