"""koopmanx_torch KMAE training (``train/``, ``systems/autonomous.py``, the
approach3 plant, ``lifts/io.py::save_mat_mlp``, ``cli train``) against the
JAX package, on numpy inputs made from a seed.

Sizes: encoder 2-16-16-16-4, decoder 4-16-16-16-2, 20 x 20 snapshots,
horizon 4. A JAX state crosses over with ``convert.kmae_state_from_numpy``
(its parameters, Adam's count and moments, the carried A and B). Both
packages run the same float64 arithmetic up to summation order and the
rounding of Adam's bias corrections (optax divides the moments by them,
torch folds them into the step size), so values agree to ~1e-12 and are
held to the tolerances below."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx.lifts.io import load_mat_mlp as j_load_mat_mlp  # noqa: E402
from koopmanx.systems import autonomous as jauto  # noqa: E402
from koopmanx.systems import base as jbase  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.systems.data import collect as j_collect  # noqa: E402
from koopmanx.train import kmae as jk  # noqa: E402
from koopmanx.train import trainer as jt  # noqa: E402

from koopmanx_torch import cli  # noqa: E402
from koopmanx_torch import convert  # noqa: E402
from koopmanx_torch.lifts.io import load_mat_mlp  # noqa: E402
from koopmanx_torch.ops.linalg import spd_inverse  # noqa: E402
from koopmanx_torch.systems import autonomous as tauto  # noqa: E402
from koopmanx_torch.systems import base as tbase  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.systems.data import Snapshots, rollout  # noqa: E402
from koopmanx_torch.train import kmae as tk  # noqa: E402
from koopmanx_torch.train import trainer as tt  # noqa: E402

F64 = torch.float64
N_TRAJ, N_STEP, H, NLIFT, HIDDEN, BATCH = 20, 20, 4, 4, 16, 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def data():
    """Trajectory-major snapshots: random states, a smooth next state and
    inputs in the Duffing data's ranges."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (N_TRAJ * N_STEP, 2))
    y = x + 0.05 * rng.normal(size=x.shape)
    u = rng.uniform(-2, 2, (N_TRAJ * N_STEP, 1))
    return x, y, u


def _tree(params):
    return [tuple(np.asarray(t) for t in layer) for layer in params]


def jax_arrays(js):
    """A JAX KMAEState as ``convert``'s dict."""
    adam = js.opt_state[0]
    return {
        "encoder": _tree(js.params.encoder), "decoder": _tree(js.params.decoder),
        "count": int(adam.count),
        "mu": {"encoder": _tree(adam.mu.encoder),
               "decoder": _tree(adam.mu.decoder)},
        "nu": {"encoder": _tree(adam.nu.encoder),
               "decoder": _tree(adam.nu.decoder)},
        "a_prev": np.asarray(js.a_prev), "b_prev": np.asarray(js.b_prev),
    }


def jax_state(seed=0, dtype=jnp.float64, cfg=None):
    return jk.init_state(jax.random.PRNGKey(seed), cfg or jk.KMAEConfig(
        pred_horizon=H), n=2, nlift=NLIFT, hidden=HIDDEN, dtype=dtype)


def port_state(js, dtype=F64):
    return convert.kmae_state_from_numpy(jax_arrays(js), device="cpu",
                                         dtype=dtype)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def assert_states_close(ts, js, rtol):
    """Every leaf (parameters, count, moments, A, B) within ``rtol`` of
    the largest entry of its JAX counterpart; the count exactly."""
    ours = convert.kmae_leaves(convert.kmae_state_to_numpy(ts))
    theirs = jax.tree_util.tree_leaves(js)
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == np.shape(b), i
        if np.asarray(b).dtype == np.int32:
            assert int(a) == int(b)
        else:
            assert rel(a, b) <= rtol, (i, rel(a, b))


def windows(x, y, u):
    jw = jk.make_windows(jnp.asarray(x), jnp.asarray(y), jnp.asarray(u),
                         N_STEP, H)
    tw = tk.make_windows(*(torch.tensor(a) for a in (x, y, u)), N_STEP, H)
    return jw, tw


def test_config_fields_match_jax():
    assert dataclasses.asdict(tk.KMAEConfig()) == dataclasses.asdict(
        jk.KMAEConfig())


def test_leaves_are_jax_tree_flatten_order():
    """``convert.kmae_leaves`` of a JAX state's arrays is
    ``jax.tree_util.tree_flatten`` of that state, leaf for leaf, and
    ``kmae_arrays_from_leaves`` inverts it; a port state built from them
    gives them back."""
    js = jax_state()
    arrays = jax_arrays(js)
    leaves, _ = jax.tree_util.tree_flatten(js)
    ours = convert.kmae_leaves(arrays)
    assert len(ours) == len(leaves) == 3 * 16 + 3
    for a, b in zip(ours, leaves):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    back = convert.kmae_arrays_from_leaves(ours, (4, 4))
    for a, b in zip(convert.kmae_leaves(back), ours):
        np.testing.assert_array_equal(a, b)
    ts = port_state(js)
    for a, b in zip(convert.kmae_leaves(convert.kmae_state_to_numpy(ts)),
                    ours):
        np.testing.assert_array_equal(a, b)


def test_make_windows_bit_for_bit(data):
    (jx, ju), (tx, tu) = windows(*data)
    assert tx.shape == (N_TRAJ * (N_STEP - H), H + 1, 2)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def test_spd_inverse_gradcheck():
    """Autograd through the in-place pivot-free Gauss-Jordan (block 1, as
    the fit uses it) against finite differences."""
    rng = np.random.default_rng(1)
    m = rng.normal(size=(5, 5))
    g = torch.tensor(m @ m.T + 5 * np.eye(5), requires_grad=True)
    assert torch.autograd.gradcheck(spd_inverse, (g,))


def test_differentiable_edmd_values_and_grads():
    """A, B and the gradient of a weighted sum of them in zx, zy and u
    against ``jax.grad``: f64 1e-10."""
    rng = np.random.default_rng(2)
    zx, zy = rng.normal(size=(200, NLIFT)), rng.normal(size=(200, NLIFT))
    u = rng.normal(size=(200, 1))
    wa, wb = rng.normal(size=(NLIFT, NLIFT)), rng.normal(size=(NLIFT, 1))

    def jf(zx, zy, u):
        a, b = jk.differentiable_edmd(zx, zy, u, 1e-8)
        return jnp.sum(a * wa) + jnp.sum(b * wb), (a, b)

    (jv, (ja, jb)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(zx), jnp.asarray(zy), jnp.asarray(u))
    ins = [torch.tensor(v, requires_grad=True) for v in (zx, zy, u)]
    ta, tb = tk.differentiable_edmd(*ins, 1e-8)
    ((ta * torch.tensor(wa)).sum() + (tb * torch.tensor(wb)).sum()).backward()
    assert rel(ta.detach(), ja) <= 1e-10 and rel(tb.detach(), jb) <= 1e-10
    for t, j in zip(ins, jg):
        assert rel(t.grad, j) <= 1e-10


@pytest.mark.parametrize("exponent", ["rollout", "legacy_train"])
def test_multi_step_loss_matches_jax(exponent):
    """Both input exponents against JAX (1e-10); 'legacy_train' also
    against the numpy oracle of tests/test_train.py:86, the reference
    training loop's A^{s-1} sum, which 'rollout' must not give."""
    rng = np.random.default_rng(3)
    js = jax_state(seed=3)
    ts = port_state(js)
    a = rng.normal(size=(NLIFT, NLIFT)) * 0.3
    b = rng.normal(size=(NLIFT, 1))
    xw = rng.normal(size=(5, H + 1, 2))
    uw = rng.normal(size=(5, H, 1))
    jcfg = jk.KMAEConfig(pred_horizon=H, lin_exponent=exponent)
    tcfg = tk.KMAEConfig(pred_horizon=H, lin_exponent=exponent)
    want = jk.multi_step_loss(js.params, jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(xw), jnp.asarray(uw), jcfg)
    with torch.no_grad():
        got = tk.multi_step_loss(ts.params, torch.tensor(a), torch.tensor(b),
                                 torch.tensor(xw), torch.tensor(uw), tcfg)
        z_all = ts.params.encoder(torch.tensor(xw)).numpy()
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-10
    # the reference training loop's formula, from tests/test_train.py:86
    lin = np.zeros((H, 5))
    for p in range(1, H + 1):
        for bi in range(5):
            z = np.linalg.matrix_power(a, p) @ z_all[bi, 0]
            for s in range(1, p + 1):
                z = z + np.linalg.matrix_power(a, s - 1) @ b @ uw[bi, s - 1]
            lin[p - 1, bi] = np.sum((z - z_all[bi, p]) ** 2)
    legacy = float(np.mean(lin.sum(axis=0) / H))
    if exponent == "legacy_train":
        assert rel(got[1], legacy) <= 1e-10
    else:
        assert abs(float(got[1]) - legacy) > 1e-6


@pytest.mark.parametrize("rec_only", [False, True])
def test_kmae_loss_value_and_grads_match_jax(data, rec_only):
    """The loss and every parameter's gradient against
    ``jax.value_and_grad``, full and rec-only: f64 1e-9 relative. The
    biases start at 0, where the L1 term's derivative is 1 in JAX."""
    x, y, u = data
    (jxw, juw), (txw, tuw) = windows(x, y, u)
    js = jax_state(seed=4)
    ts = port_state(js)
    jcfg, tcfg = jk.KMAEConfig(pred_horizon=H), tk.KMAEConfig(pred_horizon=H)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jk.kmae_loss, has_aux=True),
                             static_argnums=(8, 9))(
        js.params, js.a_prev, js.b_prev, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(u), jxw[:BATCH], juw[:BATCH], jcfg, rec_only)
    tl, taux = tk.kmae_loss(ts.params, ts.a_prev, ts.b_prev,
                            *(torch.tensor(a) for a in (x, y, u)),
                            txw[:BATCH], tuw[:BATCH], tcfg, rec_only)
    tl.backward()
    assert rel(tl.detach(), jl) <= 1e-9
    for key in ("l_rec", "l_lin", "l_pred", "a", "b"):
        assert rel(taux[key].detach(), jaux[key]) <= 1e-9, key
    leaves = ts.params.leaves()
    assert all(float(p.detach().abs().max()) == 0.0 for p in leaves[1::2])
    for p, g in zip(leaves, jax.tree_util.tree_leaves(jg)):
        assert rel(p.grad, g) <= 1e-9


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's train step, jitted once per dtype for the module."""
    cfg = jk.KMAEConfig(pred_horizon=H)
    step, _ = jk.make_train_step(cfg)
    return jax.jit(step, static_argnums=6)


def run_steps(jstep, js, ts, data, n, seed, dtype=np.float64, first=0,
              rows=None):
    """``n`` steps of both packages on the same minibatches (steps past
    the third rec-only), the snapshot set's rows in the order ``rows``
    (the windows keep theirs); each step's (JAX loss, port loss)."""
    x, y, u = (a.astype(dtype) for a in data)
    (jxw, juw), (txw, tuw) = windows(x, y, u)
    rows = np.arange(x.shape[0]) if rows is None else rows
    tstep, _ = tk.make_train_step(tk.KMAEConfig(pred_horizon=H))
    jin = [jnp.asarray(a[rows]) for a in (x, y, u)]
    tin = [torch.tensor(a[rows]) for a in (x, y, u)]
    rng = np.random.default_rng(seed)
    losses = []
    for k in range(first, first + n):
        idx = rng.permutation(jxw.shape[0])[:BATCH]
        rec_only = k >= 3
        js, jl, jaux = jstep(js, *jin, jxw[idx], juw[idx], rec_only)
        ts, tl, taux = tstep(ts, *tin, txw[idx], tuw[idx], rec_only)
        losses.append((float(jl), float(tl)))
        assert taux["a"].grad_fn is None and not ts.a_prev.requires_grad
    return js, ts, losses


def leaves_of(js, ts):
    """(JAX's leaves, the port's), both in tree_flatten order."""
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(js)],
            convert.kmae_leaves(convert.kmae_state_to_numpy(ts)))


def test_five_train_steps_match_jax_f64(jax_steps, data):
    """5 steps (3 full, 2 rec-only) on the same minibatches from one JAX
    state carried across: parameters, count, Adam's moments, A, B and the
    losses within 1e-8 relative in float64."""
    js = jax_state(seed=5)
    ts = port_state(js)
    js, ts, losses = run_steps(jax_steps, js, ts, data, 5, seed=5)
    assert max(rel(t, j) for j, t in losses) <= 1e-8
    assert_states_close(ts, js, 1e-8)
    assert ts.opt_state.state[ts.params.leaves()[0]]["step"] == 5


def test_five_train_steps_match_jax_f32(jax_steps, data):
    """The same 5 steps in float32, each leaf and the losses within 1e-4
    relative or ten times the larger of the two packages' own spreads
    when the 400 snapshot rows are summed in two other orders, where that
    is larger. The float32 fit of (A, B) carries ~1e-4 relative error at
    this conditioning (ridge 1e-8) in both packages, and Adam's first
    steps, near lr * sign(g), turn an entry whose gradient sign lies
    under that error into an O(lr) difference: one package's own spread
    reaches ~3e-2 on some leaves (decoder biases, which start at 0)."""
    js0 = jax_state(seed=5, dtype=jnp.float32)
    runs = []
    for rows in (None, *(np.random.default_rng(100 + k).permutation(
            N_TRAJ * N_STEP) for k in (1, 2))):
        js, ts, losses = run_steps(jax_steps, js0,
                                   port_state(js0, dtype=torch.float32),
                                   data, 5, seed=5, dtype=np.float32,
                                   rows=rows)
        runs.append((leaves_of(js, ts), losses))
    (jl, tl), losses = runs[0]
    for k, (j, t) in enumerate(losses):
        spread = max(max(rel(other[k][0], j), rel(other[k][1], t))
                     for _, other in runs[1:])
        assert rel(t, j) <= max(1e-4, 10 * spread), (k, rel(t, j), spread)
    for i, (a, b) in enumerate(zip(tl, jl)):
        if b.dtype == np.int32:
            assert int(a) == int(b) == 5
            continue
        spread = max(max(rel(other[0][i], b), rel(other[1][i], a))
                     for other, _ in runs[1:])
        assert rel(a, b) <= max(1e-4, 10 * spread), (i, rel(a, b), spread)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_resume_in_the_other_package(jax_steps, data, tmp_path,
                                                 writer):
    """Two JAX steps, carried across; one package writes the checkpoint
    and the other reads it (JAX's ``load_checkpoint`` on its template):
    equal leaf for leaf. Then one more step in each agrees to 1e-8."""
    js = jax_state(seed=6)
    ts = port_state(js)
    js, ts, _ = run_steps(jax_steps, js, ts, data, 2, seed=6)
    path = str(tmp_path / "kmae.npz")
    template_j = jax_state(seed=7)
    template_t = port_state(template_j)
    if writer == "jax":
        jt.save_checkpoint(path, js, 2)
        ts, step = tt.load_checkpoint(path, template_t)
    else:
        tt.save_checkpoint(path, ts, 2)
        js, step = jt.load_checkpoint(path, template_j)
    assert step == 2
    assert_states_close(ts, js, 0.0)
    js, ts, losses = run_steps(jax_steps, js, ts, data, 1, seed=8, first=2)
    assert max(rel(t, j) for j, t in losses) <= 1e-8
    assert_states_close(ts, js, 1e-8)


def test_export_weights_read_by_jax(tmp_path):
    """The port's ``.mat`` export reads back exactly through the JAX
    package's ``load_mat_mlp`` and the port's."""
    ts = port_state(jax_state(seed=9))
    prefix = str(tmp_path / "model")
    tt.export_weights(ts, prefix)
    for part, mlp in zip(("encoder", "decoder"), ts.params):
        ours = mlp.params()
        for reader in (lambda p: j_load_mat_mlp(p, dtype=jnp.float64),
                       lambda p: load_mat_mlp(p, dtype=F64)):
            back = reader(f"{prefix}_{part}.mat")
            assert len(back) == len(ours) == 4
            for (w1, b1), (w2, b2) in zip(ours, back):
                np.testing.assert_array_equal(w1.detach().numpy(),
                                              np.asarray(w2))
                np.testing.assert_array_equal(b1.detach().numpy(),
                                              np.asarray(b2))


def test_evaluate_matches_jax(data):
    js = jax_state(seed=10)
    snaps = Snapshots(*(torch.tensor(a) for a in data))
    ours = tt.evaluate(port_state(js), snaps, N_STEP,
                       tk.KMAEConfig(pred_horizon=H), dtype=F64)
    theirs = jt.evaluate(js, jbase_snapshots(data), N_STEP,
                         jk.KMAEConfig(pred_horizon=H), dtype=jnp.float64)
    assert set(ours) == set(theirs)
    for key in ours:
        assert rel(ours[key], theirs[key]) <= 1e-10, key


def jbase_snapshots(data):
    from koopmanx.systems.data import Snapshots as JSnapshots

    return JSnapshots(*(jnp.asarray(a) for a in data))


def test_fit_lowers_the_loss_and_keeps_the_best_state(data, tmp_path):
    """``fit`` on the CPU lowers the loss as tests/test_train.py:39 asks
    (4 epochs, no rec-only phase); ``eval_callback`` picks the state of
    the lowest score, which is the one returned and checkpointed."""
    cfg = tk.KMAEConfig(pred_horizon=H, epochs=4, rec_only_after_epoch=None)
    scores = iter([3.0, 1.0, 2.0, 5.0])
    seen = {}

    def callback(state, epoch):
        seen[epoch] = convert.kmae_state_to_numpy(state)
        return next(scores)

    path = str(tmp_path / "kmae.npz")
    state, history = tt.fit(Snapshots(*(torch.tensor(a) for a in data)),
                            N_STEP, cfg, nlift=NLIFT, hidden=32, dtype=F64,
                            batch_windows=128, verbose=False,
                            checkpoint_path=path, eval_callback=callback,
                            eval_every=1, device="cpu")
    assert [h["epoch"] for h in history] == [0, 1, 2, 3]
    assert history[-1]["loss"] < history[0]["loss"] * 0.9
    assert [h.get("val_best", False) for h in history] == [True, True, False,
                                                          False]
    best = convert.kmae_leaves(seen[1])
    for a, b in zip(convert.kmae_leaves(convert.kmae_state_to_numpy(state)),
                    best):
        np.testing.assert_array_equal(a, b)
    template = tk.init_state(torch.Generator().manual_seed(1), cfg, n=2,
                             nlift=NLIFT, hidden=32, dtype=F64, device="cpu")
    loaded, step = tt.load_checkpoint(path, template)
    assert step == 4
    for a, b in zip(convert.kmae_leaves(convert.kmae_state_to_numpy(loaded)),
                    best):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_fit_takes_another_optimizer(data, tmp_path, kind):
    """A non-default optimizer factory through ``fit``: the best state
    (parameters, optimizer state, A and B) is the one returned. An AdamW
    checkpoints and the checkpoint reloads into a template of the same
    factory; an SGD, whose state is not optax Adam's, is refused before
    the first step when a checkpoint is asked for."""
    cfg = tk.KMAEConfig(pred_horizon=H, epochs=3, rec_only_after_epoch=None)
    factory = {
        "adamw": lambda p: torch.optim.AdamW(p, lr=5e-4, weight_decay=1e-2),
        "sgd": lambda p: torch.optim.SGD(p, lr=1e-3, momentum=0.9),
    }[kind]
    snaps = Snapshots(*(torch.tensor(a) for a in data))
    kw = dict(nlift=NLIFT, hidden=32, dtype=F64, batch_windows=128,
              verbose=False, optimizer=factory, device="cpu")
    path = str(tmp_path / "kmae.npz")
    if kind == "sgd":
        with pytest.raises(ValueError, match="Adam"):
            tt.fit(snaps, N_STEP, cfg, checkpoint_path=path, **kw)
        assert not os.path.exists(path)
    scores = iter([2.0, 1.0, 3.0])
    seen = {}

    def callback(state, epoch):
        seen[epoch] = ([p.detach().clone() for p in state.params.leaves()],
                       [t.clone() for st in state.opt_state.state.values()
                        for t in st.values() if torch.is_tensor(t)],
                       state.a_prev.clone())
        return next(scores)

    state, history = tt.fit(snaps, N_STEP, cfg, eval_callback=callback,
                            eval_every=1,
                            checkpoint_path=path if kind == "adamw" else None,
                            **kw)
    assert all(np.isfinite(h["loss"]) for h in history)
    assert [h.get("val_best", False) for h in history] == [True, True, False]
    assert type(state.opt_state).__name__ == {"adamw": "AdamW",
                                              "sgd": "SGD"}[kind]
    params, opt, a_prev = seen[1]
    for a, b in zip(state.params.leaves(), params):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    got = [t for st in state.opt_state.state.values() for t in st.values()
           if torch.is_tensor(t)]
    assert len(got) == len(opt)
    for a, b in zip(got, opt):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(state.a_prev, a_prev, rtol=0, atol=0)
    if kind == "adamw":
        template = tk.init_state(torch.Generator().manual_seed(1), cfg, n=2,
                                 nlift=NLIFT, hidden=32, dtype=F64,
                                 optimizer=factory, device="cpu")
        loaded, step = tt.load_checkpoint(path, template)
        assert step == 3
        for a, b in zip(
                convert.kmae_leaves(convert.kmae_state_to_numpy(loaded)),
                convert.kmae_leaves(convert.kmae_state_to_numpy(state))):
            np.testing.assert_array_equal(a, b)


def test_training_wants_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tk.init_state(torch.Generator(), tk.KMAEConfig(), n=2, nlift=4,
                      hidden=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--n-step", "10", "--n-traj", "10"])


@pytest.mark.parametrize("name", ["ez_example_solve", "duffing_solve",
                                  "lti_snapshots"])
def test_autonomous_generators_bit_for_bit(name):
    """The port's copy on the same ``np.random.default_rng`` gives JAX's
    arrays bit for bit (with ``pairs_from_rollouts`` on the rollouts)."""
    args = {"ez_example_solve": (6,), "duffing_solve": (6,),
            "lti_snapshots": (50,)}[name]
    ours = getattr(tauto, name)(*args, rng=np.random.default_rng(11))
    theirs = getattr(jauto, name)(*args, rng=np.random.default_rng(11))
    if name != "lti_snapshots":
        ours, theirs = (tauto.pairs_from_rollouts(ours),
                        jauto.pairs_from_rollouts(theirs))
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_approach3_step_and_collect_match_jax():
    """The approach3 plant: its RK4 step on random states, inputs and
    parameters, and a collection rollout on the same inputs, 1e-12."""
    assert tlib.get_system("approach3") is tlib.APPROACH3
    rng = np.random.default_rng(12)
    x0 = rng.uniform(-2, 2, (8, 2))
    u = rng.uniform(-2, 2, (8, 30, 1))
    th = np.array([-0.1, -1.0]) * (1 + rng.uniform(-0.15, 0.15, (8, 2)))
    jstep = jbase.make_step(jlib.APPROACH3, 0.05)
    want = jax.vmap(lambda x, uu, t: jstep(x, uu, jlib.Approach3Params(*t)))(
        jnp.asarray(x0), jnp.asarray(u[:, 0]), jnp.asarray(th))
    tstep = tbase.make_step(tlib.APPROACH3, 0.05)
    th_t = tlib.Approach3Params(*torch.tensor(th.T))
    got = tstep(torch.tensor(x0), torch.tensor(u[:, 0]), th_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    # collection: the same rollout as JAX's collect draws, fed its inputs
    jd = j_collect(jlib.APPROACH3, jax.random.PRNGKey(0), n_step=30,
                   n_traj=8, dtype=jnp.float64)
    ju = np.asarray(jd.u).reshape(8, 30, 1)
    jx0 = np.asarray(jd.x).reshape(8, 30, 2)[:, 0]
    theta = tbase.as_params(tlib.APPROACH3.theta0, F64, torch.device("cpu"))
    xs, ys = rollout(tstep, torch.tensor(jx0), torch.tensor(ju), theta)
    np.testing.assert_allclose(xs.reshape(-1, 2).numpy(), np.asarray(jd.x),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ys.reshape(-1, 2).numpy(), np.asarray(jd.y),
                               rtol=0, atol=1e-12)


def _last_json(text: str):
    """The JSON object that closes the CLI's output (the epoch lines come
    first, as in the JAX CLI)."""
    return json.loads(text[text.index("\n{") + 1:] if not text.startswith(
        "{") else text)


def test_cli_train_exports_and_resumes(tmp_path, capsys):
    """``train --cpu`` at a tiny size prints its JSON, exports ``.mat``
    files that both packages load, and resumes from ``--checkpoint``."""
    prefix, ckpt = str(tmp_path / "duffing"), str(tmp_path / "kmae.npz")
    tiny = ["train", "--cpu", "--n-step", "12", "--n-traj", "10",
            "--hidden", "8", "--nlift", "4", "--pred-horizon", "3",
            "--checkpoint", ckpt]
    cli.main([*tiny, "--epochs", "2", "--export", prefix])
    first = _last_json(capsys.readouterr().out)["final"]
    assert first["epoch"] == 1 and np.isfinite(first["loss"])
    assert set(first) == {"epoch", "loss", "l_rec", "l_lin", "l_pred",
                          "rec_only"}
    enc = load_mat_mlp(prefix + "_encoder.mat")
    assert [tuple(w.shape) for w, _ in enc] == [(8, 2), (8, 8), (8, 8), (4, 8)]
    assert len(j_load_mat_mlp(prefix + "_decoder.mat")) == 4
    assert jt.load_checkpoint(ckpt, jax_cli_template())[1] == 2
    cli.main([*tiny, "--epochs", "3"])
    resumed = _last_json(capsys.readouterr().out)["final"]
    assert resumed["epoch"] == 2 and np.isfinite(resumed["loss"])
    cli.main([*tiny, "--epochs", "3"])  # nothing left to train
    assert _last_json(capsys.readouterr().out) == {"final": None}


def jax_cli_template():
    return jk.init_state(jax.random.PRNGKey(0), jk.KMAEConfig(), n=2,
                         nlift=4, hidden=8)


def test_train_package_imports_no_jax():
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "koopmanx_torch")
    files = [os.path.join(root, "train", f) for f in
             ("__init__.py", "kmae.py", "trainer.py")]
    files.append(os.path.join(root, "systems", "autonomous.py"))
    for path in files:
        with open(path) as f:
            text = f.read()
        assert "import jax" not in text and "koopmanx." not in text.replace(
            "koopmanx_torch", ""), path
