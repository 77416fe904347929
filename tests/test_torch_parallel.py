"""koopmanx_torch's several-card layer (``parallel/``, the data-parallel
KMAE step, ``edmd/batch.py``'s ``method`` and ``rcond``) against the JAX
package's, float64 on the CPU.

In-process cases run at world size 1 on gloo. The many-rank cases run
once, in four gloo processes on localhost (the port's
``initialize_multihost``; the workers import no JAX and load numpy inputs
written here), against JAX's ``shard_map`` over a 4-device CPU mesh on the
same inputs (``tests/conftest.py`` gives 8 CPU devices):

- the distributed fit over 160 identity-lift snapshots, within 1e-10 of
  JAX's and of the port's one-rank fit (measured 1.1e-16 and 2.2e-16);
- ``psum_mean`` of arange(16): 7.5 exactly;
- the sharded Duffing loop (16 scenarios, 25 steps, a random-init MLP
  lift) and the Woodbury ``tank_mimo`` loop (16 scenarios, 20 steps): x
  to 1e-9 and u to 1e-8 of JAX's sharded loop in every scenario and step,
  or, where larger, ten times JAX's own divergence there from one ulp of
  x0 (``test_torch_vdp.assert_logs_match``, the chaotic loops' floor);
  measured: Duffing 3.2e-10 in x and 9.6e-9 in u (JAX's one-ulp floor
  3.1e-10 and 9.4e-9), tank_mimo 8.3e-11 and 6.9e-10 (floor 1.5e-10 and
  1.1e-9); the gathered shards equal the port's whole-batch ``run_batch``
  bit for bit;
- one data-parallel KMAE step over 4 shards (``__graft_entry__.py``'s
  build: pred_horizon 3, hidden 16, nlift 8): every parameter, Adam
  moment, ``a_prev``, ``b_prev`` and the loss within 1e-9 of the largest
  entry of JAX's (measured 5.6e-11 in the leaves, 2.2e-12 in the loss),
  the same on every rank, and within 1e-9 of the port's plain whole-batch
  step (8.0e-11, 1.0e-12).

JAX's sharded loops and step run under ``jax.jit``, compiled once each.
"""
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx import parallel as jpar  # noqa: E402
from koopmanx.edmd import batch as jbatch  # noqa: E402
from koopmanx.lifts import identity_dictionary as j_identity  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.systems.data import Snapshots as JSnapshots  # noqa: E402
from koopmanx.train import kmae as jk  # noqa: E402

import torch.distributed as dist  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch import convert  # noqa: E402
from koopmanx_torch import parallel as tpar  # noqa: E402
from koopmanx_torch.edmd import batch as tbatch  # noqa: E402
from koopmanx_torch.lifts.base import identity_dictionary  # noqa: E402
from koopmanx_torch.systems.data import Snapshots  # noqa: E402
from koopmanx_torch.train import kmae as tk  # noqa: E402

from test_torch_train import jax_arrays  # noqa: E402
from test_torch_vdp import arrays_from_jax, assert_logs_match  # noqa: E402

F64 = torch.float64
RANKS, BATCH = 4, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_TOL, KMAE_RTOL = 1e-10, 1e-9
DUFFING = (jlib.DuffingParams, [-0.5, 1.0, -1.0], [-5.0, 2.0, -0.5])
MIMO = (jlib.TankMimoParams, [0.5, 0.4, 0.2, 0.3, 0.25],
        [0.53, 0.3, 0.1, 0.35, 0.2])


@pytest.fixture
def mesh1():
    """A CPU mesh of world size 1 (gloo on a local store), destroyed
    afterwards: xdist reuses its workers."""
    mesh = tpar.make_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def fit_data():
    """160 snapshots of a linear plant, as tests/test_parallel.py:27-41."""
    rng = np.random.default_rng(0)
    x, u = rng.normal(size=(160, 2)), rng.normal(size=(160, 1))
    y = x @ np.array([[0.9, 0.1], [0.0, 0.8]]).T + u @ np.array([[0.1],
                                                                [0.2]]).T
    return x, y, u


# ---- in-process: world size 1 ----------------------------------------


@pytest.mark.parametrize("method", ["pinv", "solve"])
@pytest.mark.parametrize("rcond", [None, 1e-3])
def test_fit_from_grams_matches_jax(method, rcond):
    """Both methods, and a pinv cutoff that drops the Gram's smallest
    singular value (~1e-4 of its largest), where the default keeps it:
    1e-10 of JAX's."""
    rng = np.random.default_rng(1)
    zx = rng.normal(size=(300, 6))
    zx[:, 5] = zx[:, 4] + 1e-2 * rng.normal(size=300)
    zy, u, x = rng.normal(size=(300, 6)), rng.normal(size=(300, 1)), \
        rng.normal(size=(300, 2))
    js = jbatch.gram_stats(*(jnp.asarray(a) for a in (zx, zy, u, x)))
    ts = tbatch.gram_stats(*(torch.tensor(a) for a in (zx, zy, u, x)))
    want = jbatch.fit_from_grams(js, 6, method=method, rcond=rcond)
    got = tbatch.fit_from_grams(ts, 6, method=method, rcond=rcond)
    for g, w in zip(got, want):
        assert rel(g, w) <= FIT_TOL, (method, rcond, rel(g, w))


def test_fit_from_grams_refuses_an_unknown_method():
    ts = tbatch.gram_stats(*(torch.ones(4, k, dtype=F64) for k in (3, 3, 1, 2)))
    with pytest.raises(ValueError, match="unknown method 'lstsq'"):
        tbatch.fit_from_grams(ts, 3, method="lstsq")


def test_edmd_fit_methods_match_jax():
    """``edmd_fit`` passes ``method`` and ``rcond`` through: 1e-10."""
    x, y, u = fit_data()
    for method in ("pinv", "solve"):
        want = jbatch.edmd_fit(j_identity(2), JSnapshots(
            *(jnp.asarray(a) for a in (x, y, u))), method=method)
        got = tbatch.edmd_fit(identity_dictionary(2), Snapshots(
            *(torch.tensor(a) for a in (x, y, u))), method=method)
        for g, w in zip(got, want):
            assert rel(g, w) <= FIT_TOL


def test_mesh_is_one_data_dim(mesh1):
    assert mesh1.mesh_dim_names == (tpar.DATA_AXIS,)
    assert mesh1.size() == 1 and mesh1.device_type == "cpu"
    assert dist.get_backend() == "gloo"
    assert tpar.data_sharding(mesh1) == (torch.distributed.tensor.Shard(0),)
    assert tpar.replicated(mesh1) == (torch.distributed.tensor.Replicate(),)


def test_make_mesh_without_a_card_raises():
    """No fallback to the CPU: the default mesh is the card's."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()
    assert not dist.is_initialized()


def test_initialize_multihost_single_process_is_a_no_op():
    for n in (None, 0, 1):
        tpar.initialize_multihost("127.0.0.1:1", n, 0)
    assert not dist.is_initialized()


def test_shard_batch_and_psum_mean_at_world_size_one(mesh1):
    tree = Snapshots(*(torch.arange(30.0, dtype=F64).reshape(10, 3)
                       for _ in range(3)))
    out = tpar.shard_batch(tree, mesh1)
    assert type(out) is Snapshots
    for a, b in zip(out, tree):
        assert torch.equal(a, b)
    v = torch.arange(16.0, dtype=F64)
    assert float(tpar.psum_mean(tpar.shard_batch(v, mesh1), mesh1)) == 7.5


def test_distributed_fit_at_world_size_one_is_edmd_fit(mesh1):
    """One rank: the all-reduce sums one term, so the fit is
    ``edmd_fit(method='solve')`` bit for bit, and within 1e-10 of JAX's."""
    x, y, u = fit_data()
    data = Snapshots(*(torch.tensor(a) for a in (x, y, u)))
    got = tpar.distributed_edmd_fit(identity_dictionary(2),
                                    tpar.shard_batch(data, mesh1), mesh1)
    plain = tbatch.edmd_fit(identity_dictionary(2), data, method="solve")
    want = jbatch.edmd_fit(j_identity(2), JSnapshots(
        *(jnp.asarray(a) for a in (x, y, u))), method="solve")
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        assert np.abs(g.numpy() - np.asarray(w)).max() <= FIT_TOL


def kmae_inputs(seed=0, n_step=12, n_traj=10):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n_traj * n_step, 2))
    y = x + 0.05 * rng.normal(size=x.shape)
    u = rng.uniform(-2, 2, (n_traj * n_step, 1))
    snaps = tuple(torch.tensor(a) for a in (x, y, u))
    return snaps, tk.make_windows(*snaps, n_step, 3)


@pytest.mark.parametrize("rec_only", [False, True])
def test_data_parallel_step_at_world_size_one_is_the_plain_step(mesh1,
                                                                 rec_only):
    """One rank of the data-parallel step: the Grams summed before the
    ridge, the gradients and loss averaged over one rank, bit for bit the
    plain step (parameters, Adam's moments, A, B, loss), over two steps."""
    cfg = tk.KMAEConfig(pred_horizon=3)
    snaps, wins = kmae_inputs()
    states = [tk.init_state(torch.Generator().manual_seed(4), cfg, 2, 4,
                            hidden=8, dtype=F64, device="cpu")
              for _ in range(2)]
    plain = tk.make_train_step(cfg)[0]
    dp = tk.make_train_step(cfg, group=mesh1.get_group("data"))[0]
    for _ in range(2):
        states[0], l0, _ = plain(states[0], *snaps, *wins, rec_only)
        states[1], l1, _ = dp(states[1], *tpar.shard_batch(snaps, mesh1),
                              *tpar.shard_batch(wins, mesh1), rec_only)
        assert torch.equal(l0, l1)
    a, b = (convert.kmae_leaves(convert.kmae_state_to_numpy(s))
            for s in states)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)


def test_psum_gradient_is_the_sum_of_the_cotangents(mesh1):
    """The collective's backward is itself the sum over the group: at
    one rank, d/dw (w * psum(x))^2 equals the plain gradient."""
    from koopmanx_torch.parallel.sharded import psum

    x = torch.arange(4.0, dtype=F64)
    w = torch.tensor(2.0, dtype=F64, requires_grad=True)
    ((w * psum(x, mesh1.get_group("data")).sum()) ** 2).backward()
    assert float(w.grad) == 2 * 2.0 * 6.0 ** 2


# ---- four gloo ranks against JAX's 4-device mesh ---------------------


_WORKER = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from koopmanx_torch import configs as TC, convert
    from koopmanx_torch.convert import pipeline_from_numpy
    from koopmanx_torch.lifts.base import identity_dictionary
    from koopmanx_torch.parallel import (distributed_edmd_fit,
        initialize_multihost, make_mesh, psum_mean, shard_batch,
        sharded_closed_loop)
    from koopmanx_torch.run import replicate
    from koopmanx_torch.systems import library as tlib
    from koopmanx_torch.systems.data import Snapshots
    from koopmanx_torch.train import kmae as tk

    rank = int(os.environ["KX_RANK"])
    initialize_multihost(os.environ["KX_COORD"], 4, rank, backend="gloo")
    mesh = make_mesh("cpu")
    with open(os.environ["KX_IN"], "rb") as f:
        inp = pickle.load(f)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    out = {"world": mesh.size(), "rank": mesh.get_local_rank("data")}

    out["rows"] = shard_batch(torch.arange(32.0).reshape(16, 2), mesh).numpy()
    try:
        shard_batch(torch.zeros(10), mesh)
        out["ragged"] = "no error"
    except ValueError as e:
        out["ragged"] = str(e)

    data = Snapshots(*(t(a) for a in inp["fit"]))
    model = distributed_edmd_fit(identity_dictionary(2),
                                 shard_batch(data, mesh), mesh)
    out["fit"] = [m.numpy() for m in model]
    out["psum_mean"] = float(psum_mean(
        shard_batch(torch.arange(16.0, dtype=torch.float64), mesh), mesh))

    for name, params in (("duffing", tlib.DuffingParams),
                         ("mimo", tlib.TankMimoParams)):
        case = inp[name]
        pipe = pipeline_from_numpy(case["arrays"],
                                   TC.RunConfig.from_json(case["cfg"]),
                                   device="cpu", dtype=torch.float64)
        b = len(case["x0"])
        args = (replicate(pipe.params, b), t(case["x0"]),
                replicate(pipe.model0, b), replicate(pipe.rls0, b),
                params(*t(case["th0"]).T), params(*t(case["th1"]).T))
        _, log = sharded_closed_loop(pipe.closed_loop, mesh,
                                     *shard_batch(args, mesh))
        out[name] = {"x": log.x.numpy(), "u": log.u.numpy(),
                     "r": log.r.numpy()}

    k = inp["kmae"]
    cfg = tk.KMAEConfig(**k["cfg"])
    state = convert.kmae_state_from_numpy(k["state"], device="cpu",
                                          dtype=torch.float64)
    snaps = tuple(t(a) for a in k["snaps"])
    wins = tuple(t(a) for a in k["wins"])
    step = tk.make_train_step(cfg, group=mesh.get_group("data"))[0]
    state, loss, _ = step(state, *shard_batch(snaps, mesh),
                          *shard_batch(wins, mesh))
    out["kmae"] = {"leaves": convert.kmae_leaves(
        convert.kmae_state_to_numpy(state)), "loss": float(loss)}
    out["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "koopmanx."))
                              or m == "koopmanx" for m in sys.modules)
    with open(os.environ["KX_OUT"], "wb") as f:
        pickle.dump(out, f)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _duffing_configs():
    """tests/test_parallel.py:53-61's loop with a random-init MLP lift
    (hidden 16) in place of the reference's weights, the kernel route."""
    cfgs = []
    for C in (JC, TC):
        cfg = C.duffing_nn_preset()
        cfg.steps, cfg.dtype = 25, "float64"
        cfg.mpc.qp_backend = "pallas"
        cfg.data = C.DataConfig(n_step=30, n_traj=30)
        cfg.lift = C.LiftConfig(kind="mlp", nlift=8, hidden=16)
        cfgs.append(cfg)
    return cfgs


def _mimo_configs():
    """tests/test_parallel.py:101-111's Woodbury tank_mimo loop."""
    cfgs = []
    for C in (JC, TC):
        cfg = C.tank_mimo_preset()
        cfg.steps, cfg.dtype = 20, "float64"
        cfg.data = C.DataConfig(n_step=30, n_traj=30, u_range=(-4.0, 4.0),
                                clamp_x0=True)
        cfg.update.window_carry = "woodbury"
        cfg.update.ridge = 0.1
        cfgs.append(cfg)
    return cfgs


def _scenarios(plant, seed, x0_range, scale):
    _, nominal, switched = plant
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(*x0_range, size=(BATCH, 2))
    th0 = np.array(nominal) * (1 + rng.uniform(-scale, scale,
                                               (BATCH, len(nominal))))
    th1 = np.array(switched) * (1 + rng.uniform(-scale, scale,
                                                (BATCH, len(switched))))
    return x0, th0, th1


def _jax_sharded_logs(jpipe, mesh, plant, x0, th0, th1):
    """JAX's ``sharded_closed_loop`` over the mesh, compiled once, from x0
    and from x0 moved up, then down, by one ulp (its own round-off
    floor)."""
    rep = lambda v: jnp.broadcast_to(v, (BATCH,) + v.shape)
    sb = lambda tree: jpar.shard_batch(tree, mesh)
    jp = plant[0]
    run = jax.jit(lambda x: jpar.sharded_closed_loop(
        jpipe.closed_loop, mesh, sb(jax.tree_util.tree_map(rep, jpipe.params)),
        sb(x), sb(jax.tree_util.tree_map(rep, jpipe.model0)),
        sb(jax.tree_util.tree_map(rep, jpipe.rls0)),
        sb(jp(*jnp.asarray(th0.T))), sb(jp(*jnp.asarray(th1.T))))[1])
    return tuple(run(jnp.asarray(x)) for x in (
        x0, np.nextafter(x0, 9.0), np.nextafter(x0, -9.0)))


def _jax_dp_step(mesh, state, snaps, wins, cfg):
    """__graft_entry__.py:174-195's data-parallel step over the mesh,
    under ``jax.jit``."""
    train_step, _ = jk.make_train_step(cfg, axis_name="data")

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P("data"), P("data"), P("data"), P("data"),
                       P("data")),
             out_specs=P(), check_vma=False)
    def dp_step(state_, xs, ys, us, xw, uw):
        new_state, loss, _ = train_step(state_, xs, ys, us, xw, uw)
        return new_state, loss

    return dp_step(state, *(jpar.shard_batch(jnp.asarray(a), mesh)
                            for a in (*snaps, *wins)))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Inputs from the JAX pipelines, four port ranks spawned on them, and
    JAX's side computed on its 4-device mesh while they run. Returns
    (the ranks' outputs in rank order, JAX's results, the inputs)."""
    tmp = tmp_path_factory.mktemp("ranks")
    mesh = jpar.make_mesh(jax.devices()[:RANKS])
    inp, cases = {"fit": fit_data()}, {}
    for name, (jcfg, tcfg), plant, x0_range, scale in (
            ("duffing", _duffing_configs(), DUFFING, (-2.0, 2.0), 0.1),
            ("mimo", _mimo_configs(), MIMO, (0.1, 0.9), 0.05)):
        jpipe = j_build_pipeline(jcfg)
        sc = _scenarios(plant, 1, x0_range, scale)
        inp[name] = {"arrays": arrays_from_jax(jpipe), "cfg": tcfg.to_json(),
                     "x0": sc[0], "th0": sc[1], "th1": sc[2]}
        cases[name] = (jpipe, plant, sc)
    jcfg = jk.KMAEConfig(pred_horizon=3)
    jstate = jk.init_state(jax.random.PRNGKey(1), jcfg, n=2, nlift=8,
                           hidden=16, dtype=jnp.float64)
    data = cases["duffing"][0].data
    xw, uw = jk.make_windows(data.x, data.y, data.u, 30, jcfg.pred_horizon)
    n_win = (xw.shape[0] // RANKS) * RANKS
    s = (data.x.shape[0] // RANKS) * RANKS
    snaps = [np.asarray(a[:s]) for a in (data.x, data.y, data.u)]
    wins = [np.asarray(xw[:n_win]), np.asarray(uw[:n_win])]
    inp["kmae"] = {"cfg": {"pred_horizon": 3}, "state": jax_arrays(jstate),
                   "snaps": snaps, "wins": wins}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)

    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "KX_COORD": f"127.0.0.1:{_free_port()}", "KX_IN": str(tmp / "in.pkl")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER], cwd=str(tmp),
        env={**env, "KX_RANK": str(r), "KX_OUT": str(tmp / f"out{r}.pkl")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(RANKS)]
    try:
        want = {"fit": jpar.distributed_edmd_fit(
            j_identity(2), jpar.shard_batch(JSnapshots(
                *(jnp.asarray(a) for a in inp["fit"])), mesh), mesh),
            "psum_mean": float(jpar.psum_mean(jpar.shard_batch(
                jnp.arange(16.0), mesh), mesh))}
        for name, (jpipe, plant, sc) in cases.items():
            want[name] = _jax_sharded_logs(jpipe, mesh, plant, *sc)
        new_state, loss = _jax_dp_step(mesh, jstate, snaps, wins, jcfg)
        want["kmae"] = (jax.tree_util.tree_leaves(new_state), float(loss))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=150)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{out}\n{err[-3000:]}"
    ranks = []
    for r in range(RANKS):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, want, inp, cases


def test_ranks_form_one_mesh_without_jax(four_ranks):
    ranks, *_ = four_ranks
    assert [o["rank"] for o in ranks] == list(range(RANKS))
    assert all(o["world"] == RANKS for o in ranks)
    assert not any(o["jax_imported"] for o in ranks)


def test_shard_batch_rows_are_p_data_blocks(four_ranks):
    """Rank r holds rows [4r, 4r + 4) of 16, JAX's P('data') layout, and
    a batch of 10 does not split over 4 ranks."""
    ranks, *_ = four_ranks
    full = np.arange(32.0).reshape(16, 2)
    for r, o in enumerate(ranks):
        np.testing.assert_array_equal(o["rows"], full[4 * r:4 * r + 4])
        assert "does not split over 4 ranks" in o["ragged"]


def test_distributed_fit_over_four_ranks(four_ranks):
    ranks, want, inp, _ = four_ranks
    x, y, u = inp["fit"]
    one = tbatch.edmd_fit(identity_dictionary(2), Snapshots(
        *(torch.tensor(a) for a in (x, y, u))), method="solve")
    for o in ranks:
        for got, w, p in zip(o["fit"], want["fit"], one):
            assert np.abs(got - np.asarray(w)).max() <= FIT_TOL
            assert np.abs(got - p.numpy()).max() <= FIT_TOL


def test_psum_mean_over_four_ranks(four_ranks):
    ranks, want, *_ = four_ranks
    assert want["psum_mean"] == 7.5
    assert all(o["psum_mean"] == 7.5 for o in ranks)


class _Log:
    def __init__(self, **fields):
        self.__dict__.update(fields)


@pytest.mark.parametrize("name", ["duffing", "mimo"])
def test_sharded_loop_over_four_ranks(four_ranks, name):
    """The gathered shards against JAX's sharded loop (x 1e-9, u 1e-8, or
    ten times JAX's one-ulp-of-x0 floor) and bit for bit against the
    port's whole-batch ``run_batch``."""
    from koopmanx_torch.convert import pipeline_from_numpy
    from koopmanx_torch.engine.loop import run_batch
    from koopmanx_torch.run import replicate
    from koopmanx_torch.systems import library as tlib

    ranks, want, inp, _ = four_ranks
    gathered = {k: np.concatenate([o[name][k] for o in ranks])
                for k in ("x", "u", "r")}
    log = _Log(**{k: torch.tensor(v) for k, v in gathered.items()})
    out = assert_logs_match(want[name], log)
    assert out["x"] <= 1e-9 or out["x"] <= 10 * out["x_floor"]
    case = inp[name]
    pipe = pipeline_from_numpy(case["arrays"], TC.RunConfig.from_json(
        case["cfg"]), device="cpu", dtype=F64)
    params = tlib.DuffingParams if name == "duffing" else tlib.TankMimoParams
    t = lambda a: torch.tensor(a)
    _, whole = run_batch(pipe.closed_loop, replicate(pipe.params, BATCH),
                         t(case["x0"]), replicate(pipe.model0, BATCH),
                         replicate(pipe.rls0, BATCH),
                         params(*t(case["th0"]).T), params(*t(case["th1"]).T))
    np.testing.assert_array_equal(gathered["x"], whole.x.numpy())
    np.testing.assert_array_equal(gathered["u"], whole.u.numpy())


def test_data_parallel_kmae_step_over_four_ranks(four_ranks):
    """One step over 4 shards against JAX's ``dp_step``: every leaf of the
    new state (parameters, Adam's count and moments, A, B) and the loss
    within KMAE_RTOL of the largest entry of JAX's; every rank took the
    same step; and the port's plain step on the whole batch agrees."""
    ranks, want, inp, _ = four_ranks
    jleaves, jloss = want["kmae"]
    k = inp["kmae"]
    for o in ranks:
        assert len(o["kmae"]["leaves"]) == len(jleaves)
        for a, b in zip(o["kmae"]["leaves"], jleaves):
            assert a.shape == np.shape(b)
            assert rel(a, b) <= KMAE_RTOL
        assert rel(o["kmae"]["loss"], jloss) <= KMAE_RTOL
        for a, b in zip(o["kmae"]["leaves"], ranks[0]["kmae"]["leaves"]):
            np.testing.assert_array_equal(a, b)
    state = convert.kmae_state_from_numpy(k["state"], device="cpu", dtype=F64)
    step = tk.make_train_step(tk.KMAEConfig(pred_horizon=3))[0]
    state, loss, _ = step(state, *(torch.tensor(a) for a in k["snaps"]),
                          *(torch.tensor(a) for a in k["wins"]))
    plain = convert.kmae_leaves(convert.kmae_state_to_numpy(state))
    for a, b in zip(ranks[0]["kmae"]["leaves"], plain):
        assert rel(a, b) <= KMAE_RTOL
    assert rel(ranks[0]["kmae"]["loss"], float(loss)) <= KMAE_RTOL
