"""The plain reference against the port's plain route (``'xla'``) on the
CPU, a few scenarios of each configuration. In float64 both sides round
alike, so the reference follows the port's whole closed loop (not step by
step) to round-off; in float32, as configured, the comparison of a run
passes."""
import copy

import pytest
import torch

from benchmark import check, spec, traffic
from benchmark.reference import F64, Reference

CONFIGS = ("duffing", "revise2_duffing")


def _port_loop(config, batch, steps, seed):
    from koopmanx_torch import configs as C
    from koopmanx_torch.run import build_pipeline, replicate
    from koopmanx_torch.systems.library import get_system

    cfg = C.RunConfig.from_dict(config["run_config"])
    pipe = build_pipeline(cfg, device="cpu")
    dtype = pipe.x_init.dtype
    x0, th0, th1 = traffic.draw(config["plant"], {"x0_range": [-2.0, 2.0],
                                                  "param_scale": 0.15},
                                batch, seed, 0, dtype, "cpu")
    kind = type(get_system(cfg.system).theta0)
    carry, log = pipe.closed_loop(replicate(pipe.params, batch), x0,
                                  replicate(pipe.model0, batch),
                                  replicate(pipe.rls0, batch), kind(**th0),
                                  kind(**th1))
    return pipe, carry, log, x0, th0, th1


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_follows_the_float64_port(name):
    config = copy.deepcopy(spec.part(spec.ROOT, "configs", name))
    rc = config["run_config"]
    rc["dtype"], rc["mpc"]["qp_backend"] = "float64", "xla"
    rc["steps"], rc["switch_step"] = 16, 8
    batch = 6
    pipe, carry, log, x0, th0, th1 = _port_loop(config, batch, 16, 11)
    ref = Reference(config, spec.ROOT, F64)
    assert check.worst(*(check.rel_gap(p[None], r[None])
                         for p, r in zip(pipe.model0, ref.model0))) < 1e-10
    # the reference's own closed loop from the same scenarios
    x, est = x0.double(), ref.estimator0(batch)
    model = tuple(t.expand((batch,) + t.shape) for t in ref.model0)
    warm = torch.zeros(batch, ref.horizon * ref.m, dtype=torch.float64)
    cert = ref.cert0(batch) if ref.synthesis else ()
    c_next = rc["update"]["c_pairing"] == "next"
    for t in range(16):
        assert check.worst((x - log.x[:, t]).abs()) < 1e-7, t
        z = ref.lift(x)
        u, warm, cert = ref.control(model, z, x, warm, cert)
        assert check.worst((u - log.u[:, t]).abs()) < 1e-6, t
        if ref.synthesis:
            assert check.worst(check.rel_gap(log.gamma[:, t:t + 1],
                                             cert[2][:, None])) < 1e-6, t
        x_next = ref.plant_step(x, u, ref.theta(th0, th1, t))
        est, model = ref.update(est, model, z, u, ref.lift(x_next),
                                x_next if c_next else x)
        x = x_next
    assert check.worst(*(check.rel_gap(p, r) for p, r in
                         zip(carry.model, model))) < 1e-6
    if ref.synthesis:  # the certificate held after the loop: P, K, gamma
        assert check.worst(*(check.rel_gap(p.reshape(batch, -1),
                                           r.reshape(batch, -1))
                             for p, r in zip(carry.cert, cert))) < 1e-6


@pytest.mark.parametrize("cell", ["duffing.sweep-256k", "revise2.sweep-64k",
                                  "duffing.serve-64k"])
def test_float32_run_passes_its_comparison(cell, root_of):
    from benchmark import run

    out = run.run(root_of(cell), cell, 2**33 + 17, 0.5, False, device="cpu",
                  overrides={"scenarios": 24, "check_scenarios": 24})
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


def test_window_ending_on_an_episode_start():
    """A window whose last chunk opens an episode: the ``last`` stretch is
    the chunk before it, which starts from the program's own state."""
    from benchmark import run
    from benchmark.check import judge

    cell = run.Cell(spec.ROOT, "revise2.sweep-64k", 5, device="cpu",
                    overrides={"scenarios": 16, "check_scenarios": 16,
                               "min_chunks": 11})
    cell.window(5, 0.0)  # 100-step episodes: chunk 11 opens episode 1
    assert cell.kept["start"]["offset"] == 0
    assert cell.kept["last"]["offset"] == 90
    assert cell.kept["last"]["carry_in"] is not None
    assert judge(cell.numbers(cell.selection(5)), cell.limits)
