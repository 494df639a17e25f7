"""LaLiGAN adversarial training: autoencoder, Lie generator and
discriminator.

The port's copy of symmetry_ode_discovery_tpu/training/lassi.py. As there:
- ONE combined loss (reconstruction, the generator's adversarial loss, the
  generator's regularisers and the discriminator's loss on detached
  latents, and the joint SINDy terms), differentiated once, and the Adam
  groups (autoencoder, discriminator, generator, the SINDy coefficients on
  the Adam branch; the frozen rest is not a parameter here); so the
  discriminator's gradient comes from its own loss AND the adversarial one.
  Adam is optax's formula (``Adam``);
- sequential thresholding of the generator every gan_st_freq epochs;
- batches are random gathers from whole-dataset device tensors, the last
  partial batch dropped, one batch of the whole set when it is smaller than
  batch_size.

Joint SINDy-in-latent (``include_sindy``, the rd/sym_eq.cfg path) has two
branches, as in the JAX package:
- w_sindy_x > 0, the Adam branch: Xi is a parameter of its own Adam group,
  its learning rate x10 after each of the first three epochs (the schedule
  counts optimizer steps, so the trainer needs ``steps_per_epoch``); the
  loss adds w_sindy_z |Theta(z) Xi^T - dz|^2, w_sindy_x twice over
  |J_dec(z) dz_pred - dx|^2 (the JAX package applies it twice) and the L1
  of Xi; Xi is thresholded every st_freq epochs;
- w_sindy_x == 0, the least-squares branch: each batch solves the latent
  regression afresh (ridge rows, five masked solves and thresholds), under
  the constraint in the null space Q of the generator's truncated basis,
  which is recomputed only when the generator drifted by more than 0.1, on
  an epoch's last batch, or on first use (the carried Q stays stale in
  between, as the JAX package's lax.cond keeps it); the loss adds w_sindy_z
  times the residual with the solution held constant.
Both read dz = J_enc(x) dx in eval mode on the running statistics the step
started from: a copy taken before the train-mode forward, which moves the
module's own in place (the JAX package passes the step's batch_stats in and
returns the new ones beside the loss).

Random draws come from torch generators: the initialisation from a CPU
generator seeded with the run's seed (the same init on the CPU and on the
card), each epoch's permutation and coefficients from a generator on the
data's device, and every evaluation's from a generator seeded by its epoch,
so logging never moves the training stream. ``LassiTrainer.epoch`` takes the
permutation and the coefficient draws in their place (``perm``, ``coef``),
which is how the JAX package's draws are replayed.

Data-parallel training (``dp``, a parallel/dp.DataParallel; the JAX
package's ``dp_mesh``): one trainer a rank, each with the whole dataset and
the same parameters. Each batch's permutation and coefficient draws are
the global batch's, from the same generator on every rank, which takes its
contiguous slice of the rows; every mean over the batch, the BatchNorm
statistics and the generator's centring are the global batch's (a
differentiable all-reduce each), the gradients are all-reduced before the
one Adam step, and the least-squares branch gathers the batch's latent
rows, so its solve and its stale-Q carry are the single-device ones on
every rank. Evaluation is not sharded.

The JAX package's faults (ADVICE.md) are not reproduced: the EMA of the
autoencoder is updated after the NaN check, a resume from a snapshot without
an EMA starts the EMA from the resumed parameters, no heartbeat thread is
started, and a NaN validation metric never becomes the best snapshot
(utils/checkpoint.py).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import lie_generator as lg
from ..models.mlp import BatchNorm, init_flax_
from ..ops.constraint import get_Q_padded, m_weight_tensor
from ..ops.library import FunctionLibrary
from ..ops.linalg import masked_lstsq_per_dim, min_norm_lstsq, ridge_augment
from ..utils import watchdog


def bce(p: torch.Tensor, target: float, mean=torch.mean) -> torch.Tensor:
    """torch.nn.BCELoss on probabilities, with its log clamped at -100 but
    the 1/p (1/(1-p)) gradient flowing in the saturated regime, and p == 0
    NaN-free (a double where). ``F.binary_cross_entropy`` clamps the
    gradient as well, so it is not this function. ``mean``: the batch mean
    (a data-parallel one)."""
    def log100(q):
        pos = q > 0
        safe = torch.where(pos, q, torch.ones_like(q))
        return torch.where(pos, torch.clamp(torch.log(safe), min=-100.0),
                           torch.full_like(q, -100.0))

    return -mean(target * log100(p) + (1 - target) * log100(1 - p))


@dataclasses.dataclass(frozen=True)
class LassiHParams:
    num_epochs: int = 100
    batch_size: int = 256
    lr_ae: float = 1e-3
    lr_d: float = 1e-3
    lr_g: float = 1e-3
    w_recon: float = 1.0
    w_gan: float = 1.0
    w_reg_norm: float = 1e-2
    w_reg_sim: float = 1e-2
    w_reg_ortho: float = 0.0
    w_reg_closure: float = 0.0
    use_original_x: bool = False
    gan_st_freq: int = 5
    gan_st_thres: float = 0.3
    # decay of an exponential moving average of the autoencoder's
    # parameters, which then are the final ones; 0 disables it
    ae_ema: float = 0.0
    # joint SINDy-in-latent
    include_sindy: bool = False
    eq_constraint: bool = False
    poly_order: int = 2
    w_sindy_z: float = 1e-3
    w_sindy_x: float = 1e-1
    w_sindy_reg: float = 1e-1
    sindy_reg_type: str = "l1"
    lr_sindy: float = 1e-3
    st_freq: int = 100
    threshold: float = 0.1


class Adam:
    """optax.adam(lr) on a list of tensors, in optax's formula: mu = (1 -
    b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the update -lr * mu_hat /
    (sqrt(nu_hat) + eps) with mu_hat = mu / (1 - b1^t), nu_hat = nu / (1 -
    b2^t), the corrections in the parameters' precision, added to the
    parameters. ``lr`` is a number or a function of the count of earlier
    steps (optax's schedule)."""

    def __init__(self, params: List[torch.Tensor], lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = list(params), lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        if not self.params:
            return
        b1, b2 = self.b1, self.b2
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, g2)
        # 1 - b^t in the parameters' precision (f32: optax's weak-typed power)
        f = np.float64 if self.params[0].dtype == torch.float64 else np.float32
        t = np.int32(self.count)
        bc1 = float(f(1) - f(b1) ** t)
        bc2 = float(f(1) - f(b2) ** t)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        lr = self.lr(self.count - 1) if callable(self.lr) else self.lr
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def state(self) -> dict:
        return {"mu": list(self.mu), "nu": list(self.nu),
                "count": torch.tensor(self.count, dtype=torch.int64)}

    @torch.no_grad()
    def load(self, state: dict):
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(torch.as_tensor(src))
        self.count = int(state["count"])


_METRICS = ("loss_ae", "loss_ae_rel", "loss_d_fake", "loss_d_real", "loss_g",
            "loss_reg_closure", "loss_reg_norm", "loss_reg_ortho")
_SV_CUTOFF = 5e-3  # get_Q_padded's null-space cutoff


def sindy_lr_schedule(lr: float, steps_per_epoch: int, dtype=torch.float32):
    """optax.piecewise_constant_schedule(lr, {1, 2, 3 x steps_per_epoch:
    10}) as a function of the count of earlier steps: lr times 10 for each
    boundary the count reached, the products rounded in ``dtype``."""
    f = np.float64 if dtype == torch.float64 else np.float32

    def fn(count: int) -> float:
        v = f(lr)
        for b in (1, 2, 3):
            if count >= b * steps_per_epoch:
                v = v * f(10.0)
        return float(v)

    return fn


class LassiTrainer:
    """The models, their optimiser groups, the joint SINDy state and one
    epoch of training.

    ``ae`` (models.autoencoder.AutoEncoder), ``disc``
    (models.discriminator.Discriminator), the generator state and, with
    include_sindy, ``sindy`` (a dict of tensors: "Xi", "mask", and on the
    least-squares branch "resid", and "Q" and "L_prev" under the
    constraint) live on ``device``; ``init(seed)`` draws the parameters as
    flax does, or ``load_state`` sets them (convert.lassi_from_jax). The
    Adam branch needs ``steps_per_epoch`` for its learning-rate schedule.
    ``dp``: this rank of a data-parallel run (module docstring)."""

    def __init__(self, ae, spec: lg.GeneratorSpec, disc, hp: LassiHParams, device=None,
                 steps_per_epoch: Optional[int] = None, dp=None):
        from .. import resolve_device

        self.device = resolve_device(device)
        self.ae, self.disc = ae.to(self.device), disc.to(self.device)
        self.dp = dp
        for m in self.ae.modules():
            if isinstance(m, BatchNorm):
                m.dp = dp
        self.spec, self.hp = spec, hp
        self.g_state = None
        self.opt = None
        self.sindy = None
        self.sindy_adam = hp.include_sindy and hp.w_sindy_x > 0.0
        self.sindy_lstsq = hp.include_sindy and hp.w_sindy_x == 0.0
        names = list(_METRICS)
        if hp.include_sindy:
            self.library = FunctionLibrary(ae.cfg.latent_dim, hp.poly_order)
            self.W = (torch.as_tensor(m_weight_tensor(self.library), device=self.device)
                      if hp.eq_constraint else None)
            names.append("loss_sindy_z")
            if self.sindy_adam:
                names.append("loss_sindy_x")
                if hp.sindy_reg_type == "l1":
                    names.append("loss_sindy_reg")
        self.metric_names = tuple(sorted(names))
        if self.sindy_adam and not steps_per_epoch:
            raise ValueError(
                "LassiTrainer with the Adam joint-SINDy loss (include_sindy and w_sindy_x > 0) "
                "requires steps_per_epoch=<batches per epoch> so the SINDy lr schedule fires "
                "at epoch boundaries")
        self.steps_per_epoch = steps_per_epoch or 1
        self._q_sv = {"recomputes": 0, "min_above": None, "max_below": None}

    # --- state ---

    def init(self, seed: int, dtype: torch.dtype = torch.float32):
        """Parameters drawn from a CPU generator seeded ``seed``, in the
        order autoencoder, generator, discriminator (flax's initialisers;
        standard-normal Li), then the Adam branch's standard-normal Xi;
        fresh optimiser state; all in ``dtype`` (float64: the float32 init
        widened, to run the same training without its rounding)."""
        gen = torch.Generator().manual_seed(int(seed))
        ae_cpu = init_flax_(copy.deepcopy(self.ae).cpu(), gen)
        g_state = lg.init_generator(self.spec, gen, "cpu")
        disc_cpu = init_flax_(copy.deepcopy(self.disc).cpu(), gen)
        sindy = None
        if self.sindy_adam:
            d, p = self.ae.cfg.latent_dim, self.library.n_terms
            sindy = {"Xi": torch.randn((d, p), generator=gen), "mask": torch.ones((d, p))}
        self.load_state(ae_cpu.state_dict(), disc_cpu.state_dict(), g_state, sindy, dtype)

    def _fresh_sindy(self, g_state) -> Optional[dict]:
        """The joint state at the start: Xi zero and the mask all ones; on
        the least-squares branch the residual 0 and, under the constraint, Q
        zero and L_prev infinite (so the first batch computes Q)."""
        if not self.hp.include_sindy:
            return None
        d, p = self.ae.cfg.latent_dim, self.library.n_terms
        out = {"Xi": torch.zeros((d, p)), "mask": torch.ones((d, p))}
        if self.sindy_lstsq:
            out["resid"] = torch.zeros(())
            if self.hp.eq_constraint:
                n_ch = len(lg.get_full_basis_list(self.spec, g_state))
                out["Q"] = torch.zeros((d * p, d * p))
                out["L_prev"] = torch.full((n_ch, d, d), float("inf"))
        return out

    def load_state(self, ae_sd: dict, disc_sd: dict, g_state: lg.GeneratorState,
                   sindy: Optional[dict] = None, dtype: torch.dtype = torch.float32):
        """Set the models' parameters and statistics, the generator state and
        the joint SINDy state (``sindy``, as convert.lassi_from_jax gives it;
        the fresh state of ``_fresh_sindy`` when None), copied to the device
        in ``dtype`` (float32, or float64 to hold the port's arithmetic to
        the reference's without rounding), and start the optimisers
        afresh."""
        dev = self.device
        self.ae.to(dtype).load_state_dict(ae_sd)
        self.disc.to(dtype).load_state_dict(disc_sd)
        learn = lg.trainable_filter(self.spec, g_state)
        t = lambda a: torch.as_tensor(a).to(device=dev, dtype=dtype).clone()
        self.g_state = lg.GeneratorState(
            Li=tuple(t(a).requires_grad_(f) for a, f in zip(g_state.Li, learn.Li)),
            sigma=tuple(t(a) for a in g_state.sigma),
            struct_const=tuple(t(a).requires_grad_(f)
                               for a, f in zip(g_state.struct_const, learn.struct_const)),
            masks=tuple(t(a) for a in g_state.masks))
        if self.hp.include_sindy:
            fresh = self._fresh_sindy(g_state)
            self.sindy = {k: t(v) for k, v in dict(fresh, **(sindy or {})).items()}
            self.sindy["Xi"].requires_grad_(self.sindy_adam)
        hp = self.hp
        self.opt = {"ae": Adam(list(self.ae.parameters()), hp.lr_ae),
                    "d": Adam(list(self.disc.parameters()), hp.lr_d),
                    "g": Adam(self._g_params(), hp.lr_g)}
        if self.sindy_adam:
            self.opt["sindy"] = Adam([self.sindy["Xi"]], sindy_lr_schedule(
                hp.lr_sindy, self.steps_per_epoch, dtype))

    def _g_params(self) -> List[torch.Tensor]:
        learn = lg.trainable_filter(self.spec, self.g_state)
        return ([t for t, f in zip(self.g_state.Li, learn.Li) if f]
                + [t for t, f in zip(self.g_state.struct_const, learn.struct_const) if f])

    def set_threshold(self):
        self.g_state = lg.set_threshold(self.spec, self.g_state, self.hp.gan_st_thres)

    @torch.no_grad()
    def set_sindy_threshold(self):
        """The Adam branch's sequential thresholding: the mask keeps the
        entries of Xi above the threshold that it kept already."""
        s = self.sindy
        s["mask"] = ((s["Xi"].abs() > self.hp.threshold) & (s["mask"] > 0)).to(s["mask"].dtype)

    def state(self) -> dict:
        """Everything an epoch reads and writes, as a tree of tensors (the
        live ones: clone it to keep it)."""
        g = self.g_state
        out = {"ae": self.ae.state_dict(), "d": self.disc.state_dict(),
               "g": {"Li": list(g.Li), "sigma": list(g.sigma),
                     "struct_const": list(g.struct_const), "masks": list(g.masks)},
               "opt": {k: o.state() for k, o in self.opt.items()}}
        if self.sindy is not None:
            out["sindy"] = dict(self.sindy)
        return out

    @torch.no_grad()
    def restore(self, state: dict):
        """Set every tensor of ``state()`` from ``state`` (values copied)."""
        self.ae.load_state_dict(state["ae"])
        self.disc.load_state_dict(state["d"])
        g = self.g_state
        for field in ("Li", "sigma", "struct_const", "masks"):
            for dst, src in zip(getattr(g, field), state["g"][field]):
                dst.copy_(torch.as_tensor(src))
        for k, o in self.opt.items():
            o.load(state["opt"][k])
        if self.sindy is not None:
            for k, dst in self.sindy.items():
                dst.copy_(torch.as_tensor(state["sindy"][k]))

    # --- the null space's singular values at the cutoff ---

    def _note_q_sv(self, S: torch.Tensor):
        inf = torch.full((), float("inf"), dtype=S.dtype, device=S.device)
        above = torch.where(S > _SV_CUTOFF, S, inf).min()
        below = torch.where(S <= _SV_CUTOFF, S, -inf).max()
        q = self._q_sv
        q["recomputes"] += 1
        q["min_above"] = above if q["min_above"] is None else torch.minimum(q["min_above"], above)
        q["max_below"] = below if q["max_below"] is None else torch.maximum(q["max_below"], below)

    def q_sv_margin(self) -> dict:
        """Over the training steps' recomputes of Q so far: their
        count, the smallest singular value above the 5e-3 cutoff (kept in
        the rank) and the largest at or below it (dropped: its column spans
        the null space), None where there was none."""
        q = self._q_sv
        val = lambda t: None if t is None or not math.isfinite(float(t)) else float(t)
        return {"recomputes": q["recomputes"], "cutoff": _SV_CUTOFF,
                "min_kept_above_cutoff": val(q["min_above"]),
                "max_dropped_at_or_below_cutoff": val(q["max_below"])}

    # --- loss ---

    def loss_fn(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                coef=None, train: bool = True, dx: Optional[torch.Tensor] = None,
                is_last: bool = False):
        """(loss, metrics) of one batch x (batch, n_comps, input_dim), and dx
        for the joint SINDy terms. With ``train`` the BatchNorms use and
        update the batch's statistics. ``coef`` replaces the generator's
        coefficient draws (one per group index). ``is_last``: the epoch's
        last batch, on which the constrained least-squares branch recomputes
        Q."""
        loss, m, _ = self._loss(x, generator, coef, train, dx, is_last)
        return loss, m

    def _loss(self, x, generator, coef, train, dx, is_last):
        """loss_fn's (loss, metrics) and the joint SINDy state after the
        batch (the state itself without include_sindy). In a data-parallel
        training step x and dx are this rank's rows, and every mean is the
        global batch's."""
        hp, spec, g_state = self.hp, self.spec, self.g_state
        dp = self.dp if train else None
        mean = torch.mean if dp is None else dp.mean
        m: Dict[str, torch.Tensor] = {}
        # the running statistics the step starts from, before the train-mode
        # forward moves them: the joint terms' eval-mode encoder reads these
        stats = self.ae.stats() if hp.include_sindy else None
        z, xhat = self.ae(x, train)
        loss_ae = mean((xhat - x) ** 2)
        m["loss_ae"] = loss_ae
        m["loss_ae_rel"] = loss_ae / mean(x ** 2)
        loss = hp.w_recon * loss_ae

        zt = lg.generator_forward(spec, g_state, generator, z, coef=coef, dp=dp)
        xt = self.ae.decode(zt) if hp.use_original_x else None
        loss_g = bce(self.disc(zt, None, xt), 1.0, mean)
        m["loss_g"] = loss_g
        loss = loss + hp.w_gan * loss_g

        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if not _isclose0(hp.w_reg_norm):
            r = lg.reg_norm(spec, g_state)
            loss = loss + hp.w_reg_norm * r
        elif not _isclose0(hp.w_reg_sim):
            # the data-similarity alternative
            cos = (zt * z).sum(-1) / (torch.linalg.norm(zt, dim=-1)
                                      * torch.linalg.norm(z, dim=-1) + 1e-12)
            r = torch.abs(mean(cos))
            loss = loss + hp.w_reg_sim * r
        else:
            r = zero
        m["loss_reg_norm"] = r
        r = zero
        if not _isclose0(hp.w_reg_ortho):
            r = lg.reg_ortho(spec, g_state)
            loss = loss + hp.w_reg_ortho * r
        m["loss_reg_ortho"] = r
        r = zero
        if not _isclose0(hp.w_reg_closure):
            r = lg.reg_closure(spec, g_state)
            loss = loss + hp.w_reg_closure * r
        m["loss_reg_closure"] = r

        x_d = xhat.detach() if hp.use_original_x else None
        xt_d = xt.detach() if hp.use_original_x else None
        loss_d_real = bce(self.disc(z.detach(), None, x_d), 1.0, mean)
        loss_d_fake = bce(self.disc(zt.detach(), None, xt_d), 0.0, mean)
        m["loss_d_real"] = loss_d_real
        m["loss_d_fake"] = loss_d_fake
        loss = loss + (loss_d_real + loss_d_fake) / 2

        new_sindy = self.sindy
        if self.sindy_adam:
            dz = self.ae.compute_dz(x, dx, stats)
            Xi = self.sindy["Xi"] * self.sindy["mask"]
            dz_pred = self.library(z) @ Xi.T
            dx_pred = self.ae.compute_dx(z, dz_pred)
            loss_sindy_z = mean((dz_pred - dz) ** 2)
            # w_sindy_x applied twice, as the JAX package (and the
            # reference) does
            loss_sindy_x = hp.w_sindy_x * mean((dx_pred - dx) ** 2)
            m["loss_sindy_z"] = loss_sindy_z
            m["loss_sindy_x"] = loss_sindy_x
            loss = loss + hp.w_sindy_z * loss_sindy_z + hp.w_sindy_x * loss_sindy_x
            if hp.sindy_reg_type == "l1":
                l1 = torch.sum(torch.abs(self.sindy["Xi"]))
                m["loss_sindy_reg"] = l1
                loss = loss + hp.w_sindy_reg * l1
        elif self.sindy_lstsq:
            resid, new_sindy = self._sindy_lstsq_update(x, dx, stats, is_last, train, dp)
            m["loss_sindy_z"] = resid
            loss = loss + hp.w_sindy_z * resid
        return loss, m, new_sindy

    def _sindy_lstsq_update(self, x, dx, stats, is_last: bool, train: bool, dp=None):
        """(residual, new joint state) of the least-squares branch: Q
        recomputed where the JAX package's lax.cond does (drift of the
        truncated basis over 0.1, the last batch, or the infinite L_prev of
        the start), five masked solves and thresholds on the ridge-augmented
        latent regression, and the residual with the solution held
        constant (its gradient reaches the encoder through Theta(z) and
        dz only). With ``dp`` the regression is solved on the global
        batch's rows, gathered from every rank."""
        hp, carry = self.hp, self.sindy
        z = self.ae.encode(x, False, stats)
        dz = self.ae.compute_dz(x, dx, stats)
        z0, dz0 = z[:, 0], dz[:, 0]
        d, p = self.ae.cfg.latent_dim, self.library.n_terms
        new = {}
        Q = None
        if hp.eq_constraint:
            L_list = lg.get_full_basis_list(self.spec, self.g_state)
            rd = L_list[0].shape[-1] // self.ae.cfg.n_comps
            L_trunc = torch.stack([Li[:rd, :rd] for Li in L_list]).detach()
            drift = torch.linalg.vector_norm(L_trunc - carry["L_prev"])
            recompute = is_last or bool((drift > 0.1) | torch.isinf(carry["L_prev"]).any())
            if recompute:
                Q, S = get_Q_padded(self.W, L_trunc, _SV_CUTOFF, return_s=True)
                if train:
                    self._note_q_sv(S)
                new["L_prev"] = L_trunc
            else:
                Q, new["L_prev"] = carry["Q"], carry["L_prev"]
            new["Q"] = Q
        with torch.no_grad():
            zg, dzg = z0.detach(), dz0.detach()
            if dp is not None:
                zg, dzg = dp.gather_rows(zg), dp.gather_rows(dzg)
            A, B = ridge_augment(self.library(zg), dzg, hp.w_sindy_reg)
            mask = torch.ones((d, p), dtype=z.dtype, device=z.device)
            for _ in range(5):
                if Q is not None:
                    Qm = (Q * mask.reshape(-1)[:, None]).reshape(d, p, -1)
                    AQ = torch.einsum("mp,dpq->dmq", A, Qm).reshape(d * A.shape[0], -1)
                    sol = min_norm_lstsq(AQ, B.T.reshape(-1))
                    Xi = (Q @ sol).reshape(d, p)
                else:
                    Xi = masked_lstsq_per_dim(A, B, mask)
                mask = ((Xi.abs() > hp.threshold) & (mask > 0)).to(mask.dtype)
            Xi_c = Xi * mask
        mean = torch.mean if dp is None else dp.mean
        resid = mean((self.library(z0) @ Xi_c.T - dz0) ** 2)
        new.update(Xi=Xi, mask=mask, resid=resid.detach())
        return resid, new

    def step(self, x: torch.Tensor, generator=None, coef=None, dx=None,
             is_last: bool = False) -> Dict[str, torch.Tensor]:
        """One batch: the combined loss, one backward, the Adam updates and
        the joint SINDy state carried on. Returns the batch's metrics
        (detached, on the device)."""
        loss, m, new_sindy = self._loss(x, generator, coef, True, dx, is_last)
        groups = {name: o.params for name, o in self.opt.items()}
        flat = [p for ps in groups.values() for p in ps]
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        if self.dp is not None:
            grads = self.dp.average_grads(grads)
        k = 0
        for name, ps in groups.items():
            self.opt[name].step(grads[k:k + len(ps)])
            k += len(ps)
        if self.sindy_lstsq:
            self.sindy = new_sindy
        return {key: v.detach() for key, v in m.items()}

    def epoch(self, x_data: torch.Tensor, generator: Optional[torch.Generator] = None,
              perm: Optional[torch.Tensor] = None, coef=None, per_batch: bool = False,
              dx_data: Optional[torch.Tensor] = None):
        """One epoch over random batches of x_data (n, n_comps, input_dim)
        and dx_data (the joint SINDy terms' derivatives, same shape): bs =
        min(batch_size, n), n // bs batches, the permutation from
        ``generator`` (on x_data's device) or ``perm`` (n_batches, bs); each
        batch's coefficients from ``generator`` or ``coef[i]`` (one draw per
        group index). Returns the mean of each metric over the batches as a
        tensor, with each batch's (a (n_batches,) tensor per metric) too when
        ``per_batch``. Data parallel, each rank takes its slice of every
        batch of the permutation; the draws and the metrics are global."""
        n = x_data.shape[0]
        bs = min(self.hp.batch_size, n)
        nb = n // bs
        if perm is None:
            perm = torch.randperm(n, generator=generator, device=generator.device)
            perm = perm[: nb * bs].reshape(nb, bs).to(x_data.device)
        else:
            perm = torch.as_tensor(perm, dtype=torch.long, device=x_data.device)
        if self.dp is not None:
            perm = perm[:, self.dp.rows(perm.shape[1])]
        rows = []
        for i in range(nb):
            ci = None if coef is None else coef[i]
            dxi = None if dx_data is None else dx_data[perm[i]]
            rows.append(self.step(x_data[perm[i]], generator, ci, dxi, is_last=i == nb - 1))
        stacked = {k: torch.stack([r[k] for r in rows]) for k in self.metric_names}
        mean = {k: v.mean() for k, v in stacked.items()}
        return (mean, stacked) if per_batch else mean

    @torch.no_grad()
    def eval_metrics(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                     coef=None, dx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The loss components on x (and dx) in eval mode (running
        statistics), with the joint SINDy state as it stands."""
        _, m, _ = self._loss(x, generator, coef, False, dx, False)
        return {k: m[k] for k in self.metric_names}


def _isclose0(w: float) -> bool:
    return abs(w) <= 1e-8  # np.isclose(w, 0.0)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return type(tree)((k, _clone(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def eval_generator(device, epoch: int) -> torch.Generator:
    """The draws of an evaluation after ``epoch``: independent of the
    training stream, so logging and saving never move it."""
    return torch.Generator(device=device).manual_seed(17 * 1000003 + int(epoch))


def train_lassi(trainer: LassiTrainer, x_train: torch.Tensor, x_val: Optional[torch.Tensor],
                seed: int, log_interval: int = 1, print_li: bool = False,
                verbose: bool = True, logger=None, save_interval: int = 0,
                save_dir: Optional[str] = None, resume: bool = False,
                max_snapshots: int = 3, root: str = "saved_models",
                epoch_hook=None, dx_train: Optional[torch.Tensor] = None,
                dx_val: Optional[torch.Tensor] = None, batch_hook=None) -> List[dict]:
    """The training loop; returns the per-epoch metric history, and leaves
    the trained models in ``trainer`` (with ae_ema, the EMA parameters).

    Parameters come from ``trainer.init(seed)`` unless ``trainer`` already
    holds a state; the epochs' draws from a generator on x_train's device
    seeded with ``seed``. ``dx_train`` and ``dx_val`` are the windows'
    derivatives for the joint SINDy terms (x's own in their place when
    None, as the JAX package's placeholder). After each epoch: thresholding
    of the generator every gan_st_freq epochs and, on the joint Adam
    branch, of Xi every st_freq epochs, the NaN check (a NaN metric restores the last finite state and
    stops), the EMA, logging (``logger.log``), the eval line and Li when
    verbose, and every ``save_interval`` epochs a snapshot of the whole state
    (models, optimisers, generator states, history, EMA) under
    ``root/save_dir`` with the held-out reconstruction, pruned to the newest
    ``max_snapshots`` and the best. ``resume`` continues from the newest
    snapshot, bit-identical to an uninterrupted run. ``epoch_hook(epoch,
    seconds)`` is called after each epoch's device work, ``batch_hook(epoch,
    per_batch)`` with its per-batch metrics (a (n_batches,) tensor per
    metric, as ``LassiTrainer.epoch`` returns them). Data parallel
    (``trainer.dp``), every rank runs the loop on the whole x_train with
    the same seed; rank 0 alone prints, logs and writes snapshots."""
    import time

    from ..utils import checkpoint as ckpt

    hp = trainer.hp
    if trainer.dp is not None and trainer.dp.rank != 0:
        verbose, logger, save_interval = False, None, 0
    dev = x_train.device
    if hp.include_sindy:  # x's own in place of missing derivatives, as in the JAX package
        dx_train = x_train if dx_train is None else dx_train
        dx_val = x_val if dx_val is None else dx_val
    train_kw = {"dx_data": dx_train} if hp.include_sindy else {}
    if trainer.g_state is None:
        trainer.init(seed)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    ae_params = lambda: list(trainer.ae.parameters())
    ema = [p.detach().clone() for p in ae_params()] if hp.ae_ema > 0.0 else None
    history: List[dict] = []
    start_epoch = 0
    if resume and save_dir is not None:
        found = ckpt.latest_train_state(save_dir, root)
        if found is not None:
            path, start_epoch = found
            like = {"trainer": trainer.state(), "generator": gen.get_state()}
            state, history, extra = ckpt.load_train_state(path, like)
            trainer.restore(state["trainer"])
            gen.set_state(state["generator"])
            if ema is not None:
                if extra.get("ema_ae") is not None:
                    ema = [t.to(dev) for t in extra["ema_ae"]]
                else:  # a snapshot without an EMA: start it from the resumed AE
                    ema = [p.detach().clone() for p in ae_params()]
            if verbose:
                print(f"Resumed from {path} (epochs done: {start_epoch})")
        elif verbose:
            print(f"resume requested but no train_state_ep*.npz under {root}/{save_dir}; "
                  "starting fresh")
    prev = _clone(trainer.state())
    for epoch in range(start_epoch, hp.num_epochs):
        t0 = time.perf_counter()
        if batch_hook is None:
            mean = trainer.epoch(x_train, gen, **train_kw)
        else:
            mean, per_batch = trainer.epoch(x_train, gen, per_batch=True, **train_kw)
            batch_hook(epoch, per_batch)
        if hp.gan_st_freq > 0 and (epoch + 1) % hp.gan_st_freq == 0:
            trainer.set_threshold()
        if trainer.sindy_adam and hp.st_freq > 0 and (epoch + 1) % hp.st_freq == 0:
            trainer.set_sindy_threshold()
        metrics = {k: float(v) for k, v in mean.items()}  # waits for the epoch
        watchdog.beat()
        if epoch_hook is not None:
            epoch_hook(epoch, time.perf_counter() - t0)
        if any(math.isnan(v) for v in metrics.values()):
            print(f"NaN encountered at epoch {epoch}; stopping with the last finite state "
                  f"(epoch {epoch - 1}).")
            trainer.restore(prev)
            break
        if ema is not None:
            with torch.no_grad():
                for e, p in zip(ema, ae_params()):
                    e.copy_(hp.ae_ema * e + (1.0 - hp.ae_ema) * p)
        prev = _clone(trainer.state())
        history.append(metrics)
        if logger is not None:
            logger.log(metrics, step=epoch)
        if verbose and (epoch + 1) % log_interval == 0:
            print(", ".join([f"Epoch {epoch}"] + [f"{k}: {v:.4f}" for k, v in metrics.items()]),
                  flush=True)
            if x_val is not None:
                em = trainer.eval_metrics(x_val, eval_generator(dev, epoch), dx=dx_val)
                print(", ".join([f"Epoch {epoch} test"]
                                + [f"{k}: {float(v):.4f}" for k, v in em.items()]), flush=True)
            if print_li:
                for L in lg.getLi(trainer.spec, trainer.g_state):
                    print(L.detach().cpu().numpy())
        if save_interval > 0 and save_dir is not None and (epoch + 1) % save_interval == 0:
            val_metric = None
            if x_val is not None:
                with _swapped(trainer.ae, ema):
                    em = trainer.eval_metrics(x_val, eval_generator(dev, epoch), dx=dx_val)
                val_metric = float(em["loss_ae_rel"])
            ckpt.save_train_state(
                ckpt.train_state_path(save_dir, epoch + 1, root),
                {"trainer": trainer.state(), "generator": gen.get_state()}, history,
                val_metric=val_metric, ema_ae=ema)
            ckpt.prune_train_states(save_dir, keep=max_snapshots, root=root)
    if ema is not None:
        with torch.no_grad():
            for e, p in zip(ema, ae_params()):
                p.copy_(e)
    return history


class _swapped:
    """The autoencoder's parameters replaced by ``params`` inside the block
    (nothing when None)."""

    def __init__(self, ae, params):
        self.ae, self.params, self.saved = ae, params, None

    def __enter__(self):
        if self.params is not None:
            ps = list(self.ae.parameters())
            self.saved = [p.detach().clone() for p in ps]
            with torch.no_grad():
                for p, e in zip(ps, self.params):
                    p.copy_(e)

    def __exit__(self, *exc):
        if self.saved is not None:
            with torch.no_grad():
                for p, s in zip(self.ae.parameters(), self.saved):
                    p.copy_(s)
