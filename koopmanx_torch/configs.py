"""The configuration surface (a copy of ``koopmanx/configs.py:18-299``, the
Revise_2 presets ``revise2_duffing`` / ``revise2_vdp`` at :302-362, the
``duffing_rbf``/``duffing_rff`` presets at :365-413, ``tank3`` at
:416-452, ``tank_mimo`` at :454-482, ``pendulum`` at :485-515,
``duffing_rbf128`` at :517-547, ``toy1d`` at :550-567, ``vanderpol_rbf``
at :570-577 and the self-trained presets at :580-650): every preset of
the JAX package.

The port keeps its own copy of the dataclasses so that it imports nothing
of ``koopmanx``. Field names and defaults are the JAX package's; fields of
paths the port has not reached yet are kept so that a JAX config carries
over field by field, and the engine raises ``NotImplementedError`` on them
(see ``engine/core.py``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class DataConfig:
    n_step: int = 100
    n_traj: int = 100
    h: float = 0.05
    u_range: Tuple[float, float] = (-2.0, 2.0)
    x0_range: Tuple[float, float] = (-2.0, 2.0)
    clamp_x0: bool = False
    seed: int = 0


@dataclasses.dataclass
class LiftConfig:
    kind: str = "mlp"  # mlp | rbf | fourier | hermite | monomial | identity
    nlift: int = 8
    hidden: int = 100
    rbf_type: str = "thinplate"
    rbf_centers: str = "kmeans"
    rff_bandwidth: float = 1.0
    state_augmented: bool = False
    zero_offset: bool = False
    normalize: bool = False  # standardize lifted features (f32 robustness)
    weights_path: Optional[str] = None


@dataclasses.dataclass
class MPCConfig:
    controller: str = "mpc"  # mpc | lqr (the closed-loop LQR law, no QP)
    horizon: int = 10
    q_weight: float = 100.0
    r_weight: float = 1e-4
    u_min: float = -2.0
    u_max: float = 2.0
    delta_u: bool = False
    du_min: float = -0.5
    du_max: float = 0.5
    applied_min: Optional[float] = None
    applied_max: Optional[float] = None
    applied_bounds: str = "box"
    track_lifted: bool = False
    cy_index: Optional[int] = None
    terminal_synthesis: bool = False
    terminal_mode: str = "dare"  # dare | lmi (the Revise_2 LMI, control/lmi.py)
    state_bounds: Optional[Tuple[float, float]] = None
    markov: str = "dag"  # prediction-matrix build: dag|doubling|assoc|scan
    qp_iters: int = 60
    qp_rho: float = 0.1
    qp_unroll: int = 10  # scan unroll in JAX; no meaning in eager PyTorch
    qp_kkt_lowrank: bool = True
    qp_kkt_block: int = 4  # KKT elimination block size (ops/linalg.spd_inverse)
    qp_kkt_bf16: bool = False
    qp_kkt_refine: int = 0
    qp_kkt_reanchor: int = 16
    # 'pallas' routes the batched box QP through the hand-written ADMM
    # kernel (ops/box_admm.py; the slice's main path); 'xla' runs the plain
    # batched solve_box_qp (the counterpart of the JAX default route)
    qp_backend: str = "xla"


@dataclasses.dataclass
class UpdateConfig:
    mode: str = "rls"  # rls | rls_sqrt | rls_chol | windowed | storage | off
    c_ab: float = 1e4
    c_c: float = 1e2
    warm_start_from_batch: bool = False
    forgetting: float = 1.0
    ridge: float = 0.0  # rls_sqrt: per-step diagonal trickle (f32 robustness)
    reset_mult: float = 0.0  # residual-spike reset multiple; 0 disables
    reset_factor: float = 1e-3
    dither: float = 0.0
    window: int = 256
    window_filter: int = 24
    window_filter_late: int = 0
    window_filter_warmup: int = 300
    window_refit_every: int = 1
    window_carry: str = "none"
    window_polish: int = 1
    window_anchor: int = 0
    window_store: str = "float32"
    symmetrize: bool = True
    c_pairing: str = "next"  # next (python) | same (matlab)


@dataclasses.dataclass
class RunConfig:
    system: str = "duffing"
    steps: int = 1000
    switch_step: int = 100
    reference: str = "constant"
    reference_value: float = 1.0
    reference_state: Optional[Tuple[float, ...]] = None
    x0: Optional[Tuple[float, ...]] = None
    integrator: str = "rk4"
    dtype: str = "float32"
    seed: int = 101
    unroll: int = 1  # scan unroll in JAX; no meaning in eager PyTorch
    matmul_precision: str = "default"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    lift: LiftConfig = dataclasses.field(default_factory=LiftConfig)
    mpc: MPCConfig = dataclasses.field(default_factory=MPCConfig)
    update: UpdateConfig = dataclasses.field(default_factory=UpdateConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunConfig":
        """The config a :meth:`to_json` dict (this package's or the JAX
        package's) describes; JSON lists come back as the tuples they
        were."""
        tup = lambda v: tuple(v) if isinstance(v, list) else v
        d = {k: tup(v) for k, v in d.items()}
        for key, sub in (("data", DataConfig), ("lift", LiftConfig),
                         ("mpc", MPCConfig), ("update", UpdateConfig)):
            if isinstance(d.get(key), dict):
                d[key] = sub(**{k: tup(v) for k, v in d[key].items()})
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        return cls.from_dict(json.loads(s))


def duffing_nn_preset() -> RunConfig:
    """The duffing.py flagship loop: NN lift (Nlift=8), Np=Nc=10,
    u in [-2, 2], Q=100 on outputs, R=1e-4, r = 1, RLS init 1e4 I / 100 I,
    inert plant switch, block-8 KKT elimination, square-root RLS with a
    1e-2 ridge trickle.

    The encoder weights are the reference's trained ``.mat``, named
    relative to the reference tree (resolved against the repo root); where
    it is absent, ``run.build_dictionary`` falls back to the in-repo
    artifact ``artifacts/duffing_kmae_encoder.mat``, as the JAX package
    does."""
    return RunConfig(
        system="duffing",
        steps=10000,
        switch_step=10**9,
        mpc=MPCConfig(horizon=10, q_weight=100.0, r_weight=1e-4, u_min=-2,
                      u_max=2, qp_kkt_block=8),
        update=UpdateConfig(
            mode="rls_sqrt", ridge=1e-2, c_ab=1e4, c_c=1e2, c_pairing="next"
        ),
        lift=LiftConfig(
            kind="mlp", nlift=8, normalize=True,
            weights_path="Revise_2/duffing_weights.mat",
        ),
    )


def vdp_lifted_preset() -> RunConfig:
    """vanderpol.py: lifted-space tracking of the encoded reference,
    u in [-6, 6] (:542-544), RLS inits 1e5 (:874, :888), the live switch at
    step 100 (:712), block-8 KKT elimination, square-root RLS with a 1e-2
    ridge trickle.

    The encoder weights are the reference's ``Good_VDP.mat``, named
    relative to the reference tree; where it is absent,
    ``run.build_dictionary`` falls back to the in-repo artifact
    ``artifacts/vanderpol_kmae_encoder.mat``, as the JAX package does."""
    return RunConfig(
        system="vanderpol",
        steps=10000,
        switch_step=100,
        mpc=MPCConfig(
            horizon=10, q_weight=100.0, r_weight=1e-4, u_min=-6, u_max=6,
            track_lifted=True, qp_kkt_block=8,
        ),
        update=UpdateConfig(
            mode="rls_sqrt", ridge=1e-2, c_ab=1e5, c_c=1e5, c_pairing="next"
        ),
        lift=LiftConfig(
            kind="mlp", nlift=8, normalize=True,
            weights_path="VDP_Revise_2/Good_VDP.mat",
        ),
    )


def tank_preset() -> RunConfig:
    """Tank_System.m: thinplate RBF Nlift=10 (:62-68), du formulation with
    |du| <= 0.5 and -8 <= U0 <= 8 (:147-159), N=20, Q=10, R=0.001
    (:117-119), switch at 100 (:194), 3000 steps, Cy=[0 1]; the windowed
    estimator (W = 256) with refit cadence 8 past the 300-step warm-up."""
    return RunConfig(
        system="tank",
        steps=3000,
        switch_step=100,
        mpc=MPCConfig(
            horizon=20,
            q_weight=10.0,
            r_weight=1e-3,
            delta_u=True,
            du_min=-0.5,
            du_max=0.5,
            applied_min=-8.0,
            applied_max=8.0,
            cy_index=1,
        ),
        update=UpdateConfig(
            mode="windowed", window=256, ridge=3e-2, c_ab=1e4, c_c=1e4,
            c_pairing="same", window_refit_every=8,
        ),
        lift=LiftConfig(
            kind="rbf", nlift=10, rbf_type="thinplate", rbf_centers="random",
            normalize=True,
        ),
        data=DataConfig(u_range=(-5.0, 5.0), clamp_x0=True),
    )


def tank3_preset() -> RunConfig:
    """Three-tank cascade: the tank recipe over a 3-dim state, tracking the
    last tank's level (Cy selects x3), state-augmented thinplate RBF
    (nlift 12 + 3)."""
    return RunConfig(
        system="tank3",
        steps=3000,
        switch_step=100,
        mpc=MPCConfig(
            horizon=20,
            q_weight=10.0,
            r_weight=1e-3,
            delta_u=True,
            du_min=-0.5,
            du_max=0.5,
            applied_min=-8.0,
            applied_max=8.0,
            cy_index=2,
        ),
        update=UpdateConfig(
            mode="windowed", window=256, ridge=3e-2, c_ab=1e4, c_c=1e4,
            c_pairing="same", window_refit_every=8,
        ),
        lift=LiftConfig(
            kind="rbf", nlift=12, rbf_type="thinplate", rbf_centers="random",
            normalize=True, state_augmented=True,
        ),
        data=DataConfig(u_range=(-5.0, 5.0), clamp_x0=True),
    )


def tank_mimo_preset() -> RunConfig:
    """Two-pump cascaded tanks (the one multi-input plant, m = 2): tank 2's
    level tracked with both pumps under a per-channel +-4 input box, so the
    QP has N*m = 40 decisions against N*py = 20 outputs; the tank recipe
    otherwise, with the window refit every step (the JAX package measured
    cadence 8 worse here: a stale (nlift, 2) B misallocates the pumps)."""
    return RunConfig(
        system="tank_mimo",
        steps=3000,
        switch_step=100,
        mpc=MPCConfig(
            horizon=20, q_weight=10.0, r_weight=1e-3, u_min=-4.0, u_max=4.0,
            cy_index=1,
        ),
        update=UpdateConfig(
            mode="windowed", window=256, ridge=3e-2, c_pairing="same",
        ),
        lift=LiftConfig(
            kind="rbf", nlift=10, rbf_type="thinplate", rbf_centers="random",
            normalize=True,
        ),
        data=DataConfig(u_range=(-4.0, 4.0), clamp_x0=True),
    )


def pendulum_preset() -> RunConfig:
    """Damped torque-driven pendulum tracking x1 = 1 rad (steady torque
    a*sin(1)/k, 3.37 nominal and 5.05 after the mass switch at step 1000,
    inside the +-6 box): state-augmented thinplate RBF, the windowed
    estimator with refit cadence 8."""
    return RunConfig(
        system="pendulum",
        steps=2000,
        switch_step=1000,
        mpc=MPCConfig(
            horizon=20, q_weight=10.0, r_weight=1e-3, u_min=-6.0, u_max=6.0,
        ),
        update=UpdateConfig(
            mode="windowed", window=256, ridge=3e-2, c_pairing="same",
            window_refit_every=8,
        ),
        lift=LiftConfig(
            kind="rbf", nlift=12, rbf_type="thinplate", rbf_centers="random",
            normalize=True, state_augmented=True,
        ),
        data=DataConfig(u_range=(-6.0, 6.0), x0_range=(-2.0, 2.0)),
    )


def duffing_rbf_preset() -> RunConfig:
    """duffing_RBF.py: thinplate-eps RBF lift with k-means centers (:20-23,
    :44-46), state-augmented and normalized, the storage-method online
    update (:404-438: the Grams of the training snapshots grown by every
    observation and pseudo-inverted every step), otherwise the duffing.py
    MPC scenario. The base of ``duffing_rff``, ``duffing_rbf128`` and
    ``vanderpol_rbf``."""
    return RunConfig(
        system="duffing",
        steps=10000,
        switch_step=10**9,
        mpc=MPCConfig(horizon=10, q_weight=100.0, r_weight=1e-4, u_min=-2,
                      u_max=2),
        update=UpdateConfig(mode="storage", c_pairing="next"),
        lift=LiftConfig(
            kind="rbf", nlift=8, rbf_type="thinplate_eps",
            rbf_centers="kmeans", normalize=True, state_augmented=True,
        ),
    )


def duffing_rff_preset() -> RunConfig:
    """Random-Fourier-feature lift (32 features, bandwidth 2.0 data stds,
    state-augmented and normalized: nlift 34) on the duffing scenario,
    with the Woodbury lane over a 256-step window (ridge 0.3, polish 2)."""
    cfg = duffing_rbf_preset()
    cfg.lift = LiftConfig(
        kind="fourier", nlift=32, rff_bandwidth=2.0,
        state_augmented=True, normalize=True,
    )
    cfg.update = UpdateConfig(
        mode="windowed", window=256, ridge=0.3, c_pairing="next",
        window_carry="woodbury", window_polish=2,
    )
    return cfg


def duffing_rbf128_preset() -> RunConfig:
    """The large-lift preset: 126 thinplate-eps RBF centers (k-means) plus
    the state, nlift 128, 3000 steps, with the Woodbury lane over a
    256-step window (ridge 1.0, polish 2)."""
    cfg = duffing_rbf_preset()
    cfg.lift.nlift = 126
    cfg.steps = 3000
    cfg.update = UpdateConfig(
        mode="windowed", window=256, ridge=1.0, c_pairing="next",
        window_carry="woodbury", window_polish=2,
    )
    return cfg


def vanderpol_rbf_preset() -> RunConfig:
    """vanderpol_RBF.py: ``duffing_rbf``'s lift and storage update on the
    VDP plant, with its switch at step 100 and u in [-6, 6]."""
    cfg = duffing_rbf_preset()
    cfg.system = "vanderpol"
    cfg.switch_step = 100
    cfg.mpc.u_min, cfg.mpc.u_max = -6.0, 6.0
    return cfg


def vanderpol_selftrained_preset() -> RunConfig:
    """Self-contained VDP: the in-repo KMAE encoder
    (``artifacts/vanderpol_kmae_refscale_encoder.mat``, trained with +-6
    excitation) under OUTPUT tracking (y = C z against [1, 0]) and data
    excited over the control range. The JAX package found lifted tracking
    encoder-sensitive: a generically trained encoder settles at the wrong
    point, output tracking does not."""
    cfg = vdp_lifted_preset()
    cfg.mpc.track_lifted = False
    cfg.data.u_range = (-6.0, 6.0)
    cfg.lift.weights_path = "artifacts/vanderpol_kmae_refscale_encoder.mat"
    return cfg


def duffing_selftrained_preset() -> RunConfig:
    """The duffing scenario controlled by the encoder trained in the repo
    (``artifacts/duffing_kmae_refscale_encoder.mat``): ``duffing`` with
    that lift, no reference artifact involved."""
    cfg = duffing_nn_preset()
    cfg.lift.weights_path = "artifacts/duffing_kmae_refscale_encoder.mat"
    return cfg


def pendulum_selftrained_preset() -> RunConfig:
    """The pendulum scenario with the encoder trained in the repo
    (``artifacts/pendulum_kmae_refscale_s1_encoder.mat``, nlift 8,
    normalized) in place of the thinplate RBF lift."""
    cfg = pendulum_preset()
    cfg.lift = LiftConfig(
        kind="mlp", nlift=8, normalize=True,
        weights_path="artifacts/pendulum_kmae_refscale_s1_encoder.mat",
    )
    return cfg


def revise2_duffing_preset() -> RunConfig:
    """Revise_2/Koopman_update.m: the state-augmented MLP lift with zero
    offset, [x; g(x) - g(0)] (:67), N = 10, Q = 10 I2, R = 0.01
    (:115-117), u in [-2, 2] (:215), the SM RLS warm-started from the
    batch Grams (:264-265), the per-step terminal synthesis (:314-381, the
    DARE certificate), 100 steps, the MATLAB RK4. The weights are named
    relative to the reference tree; where they are absent,
    ``run.build_dictionary`` falls back to
    ``artifacts/duffing_kmae_encoder.mat`` (8 outputs, nlift 10 with the
    state), as the JAX package does."""
    return RunConfig(
        system="duffing",
        steps=100,
        switch_step=100,
        integrator="rk4_matlab",
        mpc=MPCConfig(
            horizon=10, q_weight=10.0, r_weight=0.01, u_min=-2, u_max=2,
            terminal_synthesis=True,
        ),
        update=UpdateConfig(
            mode="rls", warm_start_from_batch=True, c_pairing="same"
        ),
        lift=LiftConfig(
            kind="mlp", nlift=10, state_augmented=True, zero_offset=True,
            weights_path="Revise_2/duffing_weights.mat",
        ),
    )


def revise2_vdp_preset() -> RunConfig:
    """VDP_Revise_2/Koopman_update_Tracking_Lift.m: lifted tracking
    (C = Cy = I, :99, :106), Q = 100 I / R = 1e-4 (:109-110), the encoded
    set point [-1, 0] (:111) as the certificate's anchor, the FULL P
    injected as the terminal block (:283), u in [-6, 6], 1000 steps,
    x0 = [1, 1] (:118), the live switch at step 100 under the MATLAB RK4,
    the zero-offset MLP lift (:65-66), the square-root RLS (1e5 priors,
    ridge 1e-2), the per-step DARE certificate. The weights fall back to
    ``artifacts/vanderpol_kmae_encoder.mat`` (nlift 8), as in the JAX
    package."""
    return RunConfig(
        system="vanderpol",
        steps=1000,
        switch_step=100,
        integrator="rk4_matlab",
        reference_state=(-1.0, 0.0),
        reference_value=-1.0,
        x0=(1.0, 1.0),
        mpc=MPCConfig(
            horizon=10, q_weight=100.0, r_weight=1e-4, u_min=-6, u_max=6,
            track_lifted=True, terminal_synthesis=True,
        ),
        update=UpdateConfig(
            mode="rls_sqrt", ridge=1e-2, c_ab=1e5, c_c=1e5, c_pairing="same"
        ),
        lift=LiftConfig(
            kind="mlp", nlift=8, zero_offset=True, normalize=True,
            weights_path="VDP_Revise_2/Good_VDP.mat",
        ),
    )


def toy1d_preset() -> RunConfig:
    """One_Dimensional_Toy_Example_Continuous_System.m: the one-state plant
    under the MATLAB RK4, the state-augmented normalized MLP lift
    [x; Enc(x)] (:25-27), N = 10, |u| <= 1, r = 0.5, the square-root RLS;
    2000 one-step data trajectories in [-1, 1]. No ``toy1d`` artifact
    ships, so the lift falls back to a random init, as in the JAX
    package."""
    return RunConfig(
        system="toy1d",
        steps=500,
        switch_step=10**9,
        integrator="rk4_matlab",
        mpc=MPCConfig(horizon=10, q_weight=100.0, r_weight=1e-4, u_min=-1,
                      u_max=1),
        update=UpdateConfig(mode="rls_sqrt", ridge=1e-2, c_pairing="same"),
        lift=LiftConfig(
            kind="mlp", nlift=8, state_augmented=True, normalize=True,
            weights_path="One_Dimensional_System22.mat",
        ),
        data=DataConfig(n_step=1, n_traj=2000, u_range=(-1.0, 1.0),
                        x0_range=(-1.0, 1.0)),
        reference_value=0.5,
    )


PRESETS = {
    "duffing": duffing_nn_preset,
    "duffing_selftrained": duffing_selftrained_preset,
    "vanderpol_selftrained": vanderpol_selftrained_preset,
    "pendulum_selftrained": pendulum_selftrained_preset,
    "duffing_rbf": duffing_rbf_preset,
    "duffing_rbf128": duffing_rbf128_preset,
    "duffing_rff": duffing_rff_preset,
    "vanderpol_rbf": vanderpol_rbf_preset,
    "vanderpol": vdp_lifted_preset,
    "tank": tank_preset,
    "tank3": tank3_preset,
    "tank_mimo": tank_mimo_preset,
    "pendulum": pendulum_preset,
    "revise2_duffing": revise2_duffing_preset,
    "revise2_vdp": revise2_vdp_preset,
    "toy1d": toy1d_preset,
}


def flagship_config(steps: int = 200, horizon: int = 20,
                    qp_backend: str = "pallas") -> RunConfig:
    """``duffing_nn_preset`` with the overrides of ``bench.py:53-98``: f32,
    the plant switch at ``steps // 2``, 50x50 data and a random-init,
    un-normalized MLP lift 2-100-100-100-8 (``bench.py:98`` replaces the
    preset's LiftConfig). ``qp_backend='pallas'`` sends the box QP through
    the hand-written kernel: the slice's main path."""
    cfg = duffing_nn_preset()
    cfg.steps = steps
    cfg.dtype = "float32"
    cfg.mpc.horizon = horizon
    cfg.mpc.qp_backend = qp_backend
    cfg.switch_step = steps // 2
    cfg.data = DataConfig(n_step=50, n_traj=50)
    cfg.lift = LiftConfig(kind="mlp", nlift=8)
    return cfg


def _bench_overrides(cfg: RunConfig, steps: int, qp_backend: str
                     ) -> RunConfig:
    """``bench.py``'s overrides for a preset other than Duffing
    (``bench.py:52-113``): f32, horizon 20, the plant switch at
    ``steps // 2`` and 50x50 data with the preset's ranges."""
    cfg.steps = steps
    cfg.dtype = "float32"
    cfg.mpc.horizon = 20
    cfg.mpc.qp_backend = qp_backend
    cfg.switch_step = steps // 2
    cfg.data = dataclasses.replace(cfg.data, n_step=50, n_traj=50)
    return cfg


def tank_bench_config(steps: int = 400, qp_backend: str = "pallas"
                      ) -> RunConfig:
    """``tank_preset`` with ``bench.py``'s overrides for a preset other
    than Duffing (``bench.py:53-101``): f32, horizon 20, the plant switch
    at ``steps // 2`` and 50x50 data with the preset's ``u_range`` and
    ``clamp_x0``. The bench samples x0 in U[0, 2] for the tanks
    (``bench.py:103-110``)."""
    return _bench_overrides(tank_preset(), steps, qp_backend)


def rbf128_bench_config(steps: int = 200, qp_backend: str = "pallas"
                        ) -> RunConfig:
    """``duffing_rbf128_preset`` with ``bench.py``'s overrides
    (``BENCH_PRESET=duffing_rbf128``, ``bench.py:52-110``): f32, horizon
    20, the plant switch at ``steps // 2`` and 50x50 data with the
    preset's ranges; the lift (126 k-means centers + the state, nlift 128)
    and the Woodbury estimator are the preset's. The bench samples its
    8192 scenarios with x0 ~ U[-2, 2]^2 and param_scale 0.15."""
    return _bench_overrides(duffing_rbf128_preset(), steps, qp_backend)


def tank_mimo_bench_config(steps: int = 200, qp_backend: str = "pallas"
                           ) -> RunConfig:
    """``tank_mimo_preset`` with ``bench.py``'s overrides
    (``BENCH_PRESET=tank_mimo``, ``bench.py:47-110``): f32, horizon 20,
    the plant switch at ``steps // 2`` and 50x50 data with the preset's
    ``u_range`` and ``clamp_x0``; the window of 256 refit every step, as
    the preset has it. The bench samples its 8192 scenarios with x0 ~
    U[0, 2]^2 and param_scale 0.15. ``qp_backend='pallas'`` inverts the
    dense 40 x 40 KKT and runs the box-ADMM kernel; ``'xla'`` builds the
    output-space (low-rank) inverse and runs the plain ADMM."""
    return _bench_overrides(tank_mimo_preset(), steps, qp_backend)


def vdp_bench_config(steps: int = 200, qp_backend: str = "pallas"
                     ) -> RunConfig:
    """``vdp_lifted_preset`` with ``bench.py``'s overrides
    (``BENCH_PRESET=vanderpol``, the JAX bench's lifted-tracking workload):
    lifted tracking at N = 20 (B1 at nx = 20), the fallback encoder, the
    square-root RLS. The bench samples its 8192 scenarios with x0 ~
    U[-2, 2]^2 and param_scale 0.15."""
    return _bench_overrides(vdp_lifted_preset(), steps, qp_backend)


def vdp_rbf_bench_config(steps: int = 200, qp_backend: str = "pallas"
                         ) -> RunConfig:
    """``vanderpol_rbf_preset`` with ``bench.py``'s overrides
    (``BENCH_PRESET=vanderpol_rbf``): output tracking at N = 20, the
    state-augmented thinplate-eps RBF lift (nlift 10) and the storage
    method. The bench samples its 8192 scenarios with x0 ~ U[-2, 2]^2 and
    param_scale 0.15."""
    return _bench_overrides(vanderpol_rbf_preset(), steps, qp_backend)


def revise2_duffing_bench_config(steps: int = 200,
                                 qp_backend: str = "pallas") -> RunConfig:
    """``revise2_duffing_preset`` with ``bench.py``'s overrides
    (``BENCH_PRESET=revise2_duffing``): f32, N = 20 (B1 at nx = 20), the
    switch at ``steps // 2`` and 50x50 data; the per-step DARE terminal
    synthesis, the SM RLS warm-started from the batch Grams, the MATLAB
    RK4, the fallback encoder with the state (nlift 10). The bench samples
    its 8192 scenarios with x0 ~ U[-2, 2]^2 and param_scale 0.15."""
    return _bench_overrides(revise2_duffing_preset(), steps, qp_backend)


def revise2_vdp_bench_config(steps: int = 200, qp_backend: str = "pallas"
                             ) -> RunConfig:
    """``revise2_vdp_preset`` with ``bench.py``'s overrides
    (``BENCH_PRESET=revise2_vdp``): f32, N = 20, the switch at
    ``steps // 2``, 50x50 data; lifted tracking (py = nlift = 8) with the
    full DARE P injected, the square-root RLS. x0 ~ U[-2, 2]^2 in the
    bench (the preset's own x0 = [1, 1] is its single-run start)."""
    return _bench_overrides(revise2_vdp_preset(), steps, qp_backend)


def toy1d_bench_config(steps: int = 200, qp_backend: str = "pallas"
                       ) -> RunConfig:
    """``toy1d_preset`` with ``bench.py``'s overrides
    (``BENCH_PRESET=toy1d``): f32, N = 20, 50x50 data in [-1, 1], the
    switch at ``steps // 2`` (the plant has none: theta1 = theta0)."""
    return _bench_overrides(toy1d_preset(), steps, qp_backend)
