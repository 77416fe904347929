"""KMAE (Koopman-consistent autoencoder) training on torch autograd
(counterpart of ``koopmanx/train/kmae.py``).

The reference's training loop (``DeepLearning_KoopmanControl_Approach3.py:
378-566``): each minibatch re-encodes the whole snapshot set, fits (A, B)
by EDMD inside the graph (gradients flow through the least squares),
blends ``A = eta A_hat + (1 - eta) A_prev`` (eta = 0.5, :498-501), then
minimizes

  Loss = a1 L_rec + a2 L_lin + a3 L_pred + a4 sum|w|

over multi-step rollouts of ``pred_horizon`` steps on a minibatch of
trajectory windows (:503-538); past ``rec_only_after_epoch`` only L_rec
is kept (:549-552). Adam, lr 1e-3 (:58).

Where JAX scans the horizon, this loops over it in Python on batched
tensors; where JAX returns a new state from each step, the step here
updates the modules and the optimizer in place and returns the state with
the new carried (A, B), detached.

Data parallelism (the JAX package's ``axis_name``): given the process
group of a mesh (``parallel.make_mesh(...).get_group('data')``), each
rank holds a block of the snapshots and windows, the fit's Grams are
summed over the group before the ridge is added (every rank fits against
the whole data set), and the gradients and the loss are averaged over it
before the optimizer's step. The sum's gradient is the sum over the group
of the ranks' cotangents, as JAX's transpose of ``psum`` is, so the
averaged gradient is the whole batch's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import Tensor

from ..device import DeviceLike, resolve_device
from ..lifts.mlp import MLP, mlp_init
from ..ops.linalg import spd_inverse
from ..parallel.sharded import psum_many


@dataclasses.dataclass(frozen=True)
class KMAEConfig:
    pred_horizon: int = 6
    alpha_rec: float = 1.0
    alpha_lin: float = 50.0
    alpha_pred: float = 50.0
    alpha_l1: float = 1e-6
    eta: float = 0.5  # EDMD blend with the previous (A, B)
    lr: float = 1e-3
    epochs: int = 20
    rec_only_after_epoch: Optional[int] = 5  # DeepLearning...py:549-552
    ridge: float = 1e-8  # Tikhonov ridge of the differentiable fit
    # 'rollout': z_p = A^p z_0 + sum_s A^{p-s} B u_{s-1}, the true linear
    # rollout (the reference's inference-side loss, duffing.py:201);
    # 'legacy_train': the reference training loop's sum_s A^{s-1} B u_{s-1}
    # (DeepLearning...py:525), which agrees with it only at p = 1
    lin_exponent: str = "rollout"


class KMAEParams(NamedTuple):
    encoder: MLP
    decoder: MLP

    def leaves(self) -> List[Tensor]:
        """W1, b1, ... of the encoder, then of the decoder: the leaf order
        of the JAX package's parameter pytree."""
        return [t for mlp in self for pair in mlp.params() for t in pair]


class KMAEState(NamedTuple):
    params: KMAEParams
    opt_state: torch.optim.Optimizer  # over ``params.leaves()``, in order
    a_prev: Tensor
    b_prev: Tensor


# ``params -> optimizer``, any torch optimizer; a checkpoint (the JAX
# package's ``.npz``, whose optimizer leaves are optax Adam's) needs an
# Adam or AdamW without amsgrad (``train/state.py``)
OptimizerFactory = Callable[[List[Tensor]], torch.optim.Optimizer]


def adam(cfg: KMAEConfig) -> OptimizerFactory:
    """``optax.adam(cfg.lr)``'s update rule: b1 0.9, b2 0.999, eps 1e-8
    outside the square root; optax's ``count`` is torch's ``step``."""
    return lambda params: torch.optim.Adam(params, lr=cfg.lr,
                                           betas=(0.9, 0.999), eps=1e-8)


def differentiable_edmd(zx: Tensor, zy: Tensor, u: Tensor, ridge: float,
                        group=None):
    """(A, B) from ``min ||V K^T - Zy||`` with V = [Zx U], by the
    ridge-regularized normal equations, differentiable in Zx, Zy and U
    (the reference's pinv at DeepLearning...py:493-497). The ridged Gram
    is inverted by the pivot-free Gauss-Jordan ``spd_inverse`` (block 1),
    whose gradient is that of its elementary operations, as in JAX.

    With a process ``group`` the Grams V'V and V'Zy are summed over its
    ranks before the ridge is added once, so that every rank fits against
    the whole data set (a rank's own block may hold fewer snapshots than
    nlift + m)."""
    v = torch.cat([zx, u], dim=-1)  # (S, N+m)
    d = v.shape[-1]
    g = v.T @ v
    vty = v.T @ zy
    if group is not None:
        g, vty = psum_many([g, vty], group)
    g = g + ridge * torch.eye(d, dtype=v.dtype, device=v.device)
    k = (spd_inverse(g) @ vty).T  # (N, N+m)
    nlift = zx.shape[-1]
    return k[:, :nlift], k[:, nlift:]


def multi_step_loss(params: KMAEParams, a: Tensor, b: Tensor, x_win: Tensor,
                    u_win: Tensor, cfg: KMAEConfig):
    """(L_rec, L_lin, L_pred) over windows x_win (B, H+1, n), u_win
    (B, H, m): L_lin_p = ||rollout_p - Enc(x_p)||^2 in the lifted space,
    L_pred_p = ||Dec(rollout_p) - x_p||^2, each summed over p and divided
    by ``pred_horizon``, then averaged over the batch."""
    enc, dec = params
    z_all = enc(x_win)  # (B, H+1, N)
    l_rec = ((dec(z_all[:, 0]) - x_win[:, 0]) ** 2).sum(-1)  # (B,)
    lin, pred = [], []

    def emit(z_pred, s):
        lin.append(((z_pred - z_all[:, s + 1]) ** 2).sum(-1))
        pred.append(((dec(z_pred) - x_win[:, s + 1]) ** 2).sum(-1))

    if cfg.lin_exponent == "legacy_train":
        # z_pred_p = A^p z_0 + sum_{s=1..p} A^{s-1} B u_{s-1}: carry A^p z_0,
        # A^{s-1} as a matrix and the running input sum
        z0p, acc = z_all[:, 0], torch.zeros_like(z_all[:, 0])
        apow = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        for s in range(u_win.shape[1]):
            acc = acc + u_win[:, s] @ (apow @ b).T
            z0p = z0p @ a.T
            emit(z0p + acc, s)
            apow = a @ apow
    else:
        z = z_all[:, 0]
        for s in range(u_win.shape[1]):
            z = z @ a.T + u_win[:, s] @ b.T
            emit(z, s)
    l_lin = (torch.stack(lin).sum(0) / cfg.pred_horizon).mean()
    l_pred = (torch.stack(pred).sum(0) / cfg.pred_horizon).mean()
    return l_rec.mean(), l_lin, l_pred


def l1_penalty(params: KMAEParams) -> Tensor:
    """sum |w| over every weight and bias. |w| is written as a select on
    w >= 0, whose derivative at 0 is 1, as ``jnp.abs``'s is (torch.abs's
    is 0 there, and the biases start at 0)."""
    return sum(torch.where(p >= 0, p, -p).sum() for p in params.leaves())


def kmae_loss(params: KMAEParams, a_prev: Tensor, b_prev: Tensor,
              x_snap: Tensor, y_snap: Tensor, u_snap: Tensor, x_win: Tensor,
              u_win: Tensor, cfg: KMAEConfig, rec_only: bool = False,
              group=None):
    """The loss and its parts; ``aux`` holds the blended (A, B), which
    become the next step's ``a_prev``/``b_prev`` in both modes. With a
    process ``group``, this rank's loss on its block, the fit taken over
    the whole data set (:func:`differentiable_edmd`)."""
    enc = params.encoder
    a_hat, b_hat = differentiable_edmd(enc(x_snap), enc(y_snap), u_snap,
                                       cfg.ridge, group)
    a = cfg.eta * a_hat + (1.0 - cfg.eta) * a_prev  # DeepLearning...py:498
    b = cfg.eta * b_hat + (1.0 - cfg.eta) * b_prev
    l_rec, l_lin, l_pred = multi_step_loss(params, a, b, x_win, u_win, cfg)
    if rec_only:
        loss = cfg.alpha_rec * l_rec
    else:
        loss = (cfg.alpha_rec * l_rec + cfg.alpha_lin * l_lin
                + cfg.alpha_pred * l_pred + cfg.alpha_l1 * l1_penalty(params))
    return loss, {"l_rec": l_rec, "l_lin": l_lin, "l_pred": l_pred,
                  "a": a, "b": b}


def make_windows(x: Tensor, y: Tensor, u: Tensor, n_step: int, horizon: int):
    """Trajectory-major snapshots cut into (windows, H+1, n) and
    (windows, H, m) prediction windows that never cross a trajectory:
    ``n_step - horizon`` windows a trajectory, starting at 0, 1, ..."""
    n, m = x.shape[-1], u.shape[-1]
    n_traj = x.shape[0] // n_step
    xs = x.reshape(n_traj, n_step, n)
    ys = y.reshape(n_traj, n_step, n)
    us = u.reshape(n_traj, n_step, m)
    full = torch.cat([xs, ys[:, -1:]], dim=1)  # x_0..x_T
    starts = torch.arange(n_step - horizon, device=x.device)[:, None]
    wx = full[:, starts + torch.arange(horizon + 1, device=x.device)]
    wu = us[:, starts + torch.arange(horizon, device=x.device)]
    return wx.reshape(-1, horizon + 1, n), wu.reshape(-1, horizon, m)


def make_train_step(cfg: KMAEConfig,
                    optimizer: Optional[OptimizerFactory] = None,
                    group=None):
    """One KMAE optimizer step, and the optimizer factory that
    :func:`init_state` uses (``optimizer``, else :func:`adam`).

    ``train_step(state, x_snap, y_snap, u_snap, x_win, u_win, rec_only)``
    backpropagates the loss, steps the state's optimizer (its modules
    change in place) and returns ``(state, loss, aux)`` with the blended
    (A, B) as the new ``a_prev``/``b_prev``; loss and aux are detached, so
    no step's graph outlives it.

    With a process ``group`` (data parallelism: each rank passes its
    block of the snapshots and windows and the same state), the gradients
    and the loss are averaged over its ranks, in one ``all_reduce``,
    before the step: every rank takes the same step."""
    factory = adam(cfg) if optimizer is None else optimizer

    def train_step(state: KMAEState, x_snap, y_snap, u_snap, x_win, u_win,
                   rec_only: bool = False):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss, aux = kmae_loss(state.params, state.a_prev, state.b_prev,
                              x_snap, y_snap, u_snap, x_win, u_win, cfg,
                              rec_only, group)
        loss.backward()
        if group is not None:
            loss = _pmean_grads(state.params.leaves(), loss.detach(), group)
        opt.step()
        aux = {k: v.detach() for k, v in aux.items()}
        return (state._replace(a_prev=aux["a"], b_prev=aux["b"]),
                loss.detach(), aux)

    return train_step, factory


def _pmean_grads(leaves: List[Tensor], loss: Tensor, group) -> Tensor:
    """Average the leaves' gradients (in place) and ``loss`` over the
    ranks of ``group`` (``jax.lax.pmean``: the sum, then divided by the
    group's size); returns the averaged loss."""
    world = dist.get_world_size(group)
    with torch.no_grad():
        summed = psum_many([p.grad for p in leaves] + [loss], group)
        for p, g in zip(leaves, summed):
            p.grad.copy_(g / world)
    return summed[-1] / world


def init_state(gen: torch.Generator, cfg: KMAEConfig, n: int, nlift: int,
               hidden: int = 100, dtype: torch.dtype = torch.float32,
               optimizer: Optional[OptimizerFactory] = None,
               device: DeviceLike = None) -> KMAEState:
    """A fresh state drawn from ``gen`` on the CPU, then moved to
    ``device`` (the card unless the caller asks for the CPU): the
    reference's autoencoder (duffing.py:21-38), encoder n-h-h-h-nlift and
    decoder nlift-h-h-h-n, He-initialized, then
    A0 ~ U[0, 1)^(nlift x nlift) / nlift and B0 ~ U[0, 1)^(nlift x 1) / nlift.
    The reference seeds the blend with unscaled uniform draws
    (duffing.py:107-108), spectral radius ~nlift/2, which overflows the
    multi-step rollout in float32; the first blend with the refit washes
    the seed out either way."""
    dev = resolve_device(device)
    enc = mlp_init(gen, (n, hidden, hidden, hidden, nlift), dtype=dtype)
    dec = mlp_init(gen, (nlift, hidden, hidden, hidden, n), dtype=dtype)
    params = KMAEParams(encoder=enc.to(dev), decoder=dec.to(dev))
    a0 = torch.rand((nlift, nlift), generator=gen, dtype=dtype) / nlift
    b0 = torch.rand((nlift, 1), generator=gen, dtype=dtype) / nlift
    factory = make_train_step(cfg, optimizer)[1]
    return KMAEState(params=params, opt_state=factory(params.leaves()),
                     a_prev=a0.to(dev), b_prev=b0.to(dev))

