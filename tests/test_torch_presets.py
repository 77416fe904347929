"""The presets koopmanx_torch gained with the Revise_2 slice against the
JAX package: ``revise2_duffing``, ``revise2_vdp``, ``toy1d`` and the two
self-trained presets (``duffing_selftrained``, ``pendulum_selftrained``)
field for field, with the Revise_2 bench configs; every JAX preset has
its port; the Revise_2 presets build on the CPU from the repo's own
files; the self-trained loops against JAX ``run_batch``. float64 on the
CPU, inputs from numpy with a seed."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from koopmanx import configs as JC  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.edmd import rls as trls  # noqa: E402
from koopmanx_torch.edmd.batch import gram_stats  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.run import build_pipeline as t_build_pipeline  # noqa: E402
from koopmanx_torch.run import replicate, resolve_weights_path  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.types import RLSState  # noqa: E402

from test_torch_vdp import (  # noqa: E402
    STEPS,
    _jax_bench,
    _jax_resolved,
    assert_logs_match,
    run_both,
)

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CONFIGS = {
    name: (TC.PRESETS[name], JC.PRESETS[name])
    for name in ("revise2_duffing", "revise2_vdp", "toy1d",
                 "duffing_selftrained", "pendulum_selftrained")
}
CONFIGS.update({
    "revise2_duffing_bench": (TC.revise2_duffing_bench_config,
                              lambda: _jax_bench("revise2_duffing")),
    "revise2_vdp_bench": (TC.revise2_vdp_bench_config,
                          lambda: _jax_bench("revise2_vdp")),
    "toy1d_bench": (TC.toy1d_bench_config, lambda: _jax_bench("toy1d")),
})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_preset_configs_match_jax(name):
    """Field for field against the JAX package's presets (the bench
    configs against the preset with ``bench.py``'s overrides); the weights
    resolve to the file JAX loads: the in-repo artifact where the
    reference's is absent (``revise2_duffing`` to the Duffing encoder,
    ``revise2_vdp`` to the VDP one), the shipped self-trained encoders,
    none (a random init) for ``toy1d``."""
    tcfg, jcfg = CONFIGS[name]
    t, j = tcfg(), jcfg()
    for part in ("data", "lift", "mpc", "update"):
        td, jd = (dataclasses.asdict(getattr(c, part)) for c in (t, j))
        jd = {k: v for k, v in jd.items() if k in td}
        td.pop("weights_path", None), jd.pop("weights_path", None)
        assert td == jd, part
    assert (resolve_weights_path(t.lift.weights_path, t.system)
            == _jax_resolved(j.lift.weights_path, j.system))
    for k in ("system", "steps", "switch_step", "reference",
              "reference_value", "reference_state", "x0", "integrator",
              "dtype", "seed"):
        assert getattr(t, k) == getattr(j, k), k
    expect = {"revise2_duffing": "duffing_kmae_encoder.mat",
              "revise2_vdp": "vanderpol_kmae_encoder.mat",
              "duffing_selftrained": "duffing_kmae_refscale_encoder.mat",
              "pendulum_selftrained":
                  "pendulum_kmae_refscale_s1_encoder.mat"}.get(
        name.replace("_bench", ""))
    path = resolve_weights_path(t.lift.weights_path, t.system)
    assert (path and os.path.basename(path)) == expect


def test_every_jax_preset_has_its_port():
    """The port's presets are the JAX package's, all 16."""
    assert set(TC.PRESETS) == set(JC.PRESETS)
    assert len(TC.PRESETS) == 16


@pytest.mark.parametrize("name", ["revise2_duffing", "revise2_vdp",
                                  "toy1d"])
def test_revise2_preset_builds_on_the_cpu(name):
    """``build_pipeline(cfg, device='cpu')`` from the repo's own files
    (20x20 data, float64): the lift (nlift 10 = 2 + 8 for the
    state-augmented Duffing encoder, 8 for VDP, 1 + 8 for toy1d's random
    init), the terminal synthesis's Q_lift (diag(10, 10, 0, ...) on
    output tracking, 100 I under lifted tracking, none without
    synthesis), ``revise2_duffing``'s SM RLS warm-started from the port's
    own lifted training Grams (``rls_init_from_grams``); then 3 scenarios
    for 6 steps: finite, |u| within the box, a fresh certificate every
    step under synthesis."""
    cfg = TC.PRESETS[name]()
    cfg.steps, cfg.dtype = 6, "float64"
    cfg.data = dataclasses.replace(cfg.data, n_step=20, n_traj=20)
    pipe = t_build_pipeline(cfg, device="cpu")
    system = tlib.get_system(cfg.system)
    nlift = pipe.dictionary.nlift
    assert nlift == {"revise2_duffing": 10, "revise2_vdp": 8,
                     "toy1d": 9}[name]
    q_lift = pipe.params.q_lift
    if name == "revise2_duffing":
        np.testing.assert_array_equal(
            q_lift.numpy(), np.diag([10.0, 10.0] + [0.0] * (nlift - 2)))
        with torch.no_grad():
            stats = gram_stats(pipe.dictionary(pipe.data.x),
                               pipe.dictionary(pipe.data.y), pipe.data.u,
                               pipe.data.x)
        ref = trls.rls_init_from_grams(stats)
        assert type(pipe.rls0) is RLSState
        for got, want in zip(pipe.rls0, ref):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-12 * want.abs().max().item())
    elif name == "revise2_vdp":
        np.testing.assert_array_equal(q_lift.numpy(), 100.0 * np.eye(nlift))
        np.testing.assert_array_equal(pipe.x_init.numpy(), [1.0, 1.0])
        np.testing.assert_array_equal(pipe.params.ref_state.numpy(),
                                      [-1.0, 0.0])
    else:
        assert q_lift is None and type(pipe.rls0) is trls.SqrtRLSState
    b = 3
    x0 = torch.tensor(np.random.default_rng(2).uniform(
        -1.0, 1.0, (b, system.n)))
    carry, log = t_run_batch(pipe.closed_loop, replicate(pipe.params, b), x0,
                             replicate(pipe.model0, b),
                             replicate(pipe.rls0, b))
    assert torch.isfinite(log.x).all() and torch.isfinite(log.u).all()
    assert float(log.u.abs().max()) <= cfg.mpc.u_max
    assert log.cert_fresh.all()
    if cfg.mpc.terminal_synthesis:
        assert (log.gamma > 0).all() and len(carry.cert) == 3


PLANTS = {
    "duffing_selftrained": (jlib.DuffingParams, tlib.DuffingParams,
                            list(jlib.DUFFING.theta0),
                            list(jlib.DUFFING.theta1)),
    "pendulum_selftrained": (jlib.PendulumParams, tlib.PendulumParams,
                             list(jlib.PENDULUM.theta0),
                             list(jlib.PENDULUM.theta1)),
}


@pytest.mark.parametrize("name", sorted(PLANTS))
def test_selftrained_loop_matches_jax_run_batch(name):
    """4 scenarios x 16 steps through the switch at 8, float64, 20x20
    data, horizon 10, the kernel route, on one pipeline with the shipped
    self-trained encoder: the square-root RLS (Duffing) and the windowed
    estimator (pendulum) against JAX ``run_batch``: x to 1e-9 and u to
    1e-8 per scenario and step, or ten times JAX's own one-ulp-of-x0
    floor there where larger (``assert_logs_match``); |u| in the box."""
    cfgs = []
    for C in (JC, TC):
        cfg = C.PRESETS[name]()
        cfg.steps, cfg.dtype, cfg.switch_step = STEPS, "float64", STEPS // 2
        cfg.mpc.horizon, cfg.mpc.qp_backend = 10, "pallas"
        cfg.data = dataclasses.replace(cfg.data, n_step=20, n_traj=20)
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    jlogs, log, carry, pipe = run_both(jcfg, tcfg, PLANTS[name])
    assert_logs_match(jlogs, log)
    assert float(log.u.abs().max()) <= tcfg.mpc.u_max
    assert pipe.dictionary.nlift == 8
