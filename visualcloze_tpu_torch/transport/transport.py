"""Rectified-flow transport (counterpart of
visualcloze_tpu/transport/transport.py): training losses and the
prediction-type conversions of the samplers.

Everything the model sees is flux time (t = 1 noise, t = 0 data); only the
path-plan calls convert (u = 1 - t). Randomness comes from an explicit
torch.Generator; `t` and `noise` can be handed in instead (the tests hand in
the values JAX drew), and so can sample_t's base draws.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from ..ops.schedule import shift_training_time
from . import path as path_mod


class ModelType(enum.Enum):
    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()


class PathType(enum.Enum):
    LINEAR = enum.auto()
    GVP = enum.auto()
    VP = enum.auto()


_PATHS = {
    PathType.LINEAR: path_mod.ICPlan,
    PathType.GVP: path_mod.GVPCPlan,
    PathType.VP: path_mod.VPCPlan,
}


@dataclass(frozen=True)
class Transport:
    model_type: ModelType = ModelType.VELOCITY
    path_type: PathType = PathType.LINEAR
    train_eps: float = 0.0
    sample_eps: float = 0.0
    snr_type: str = "uniform"
    do_shift: bool = True

    @property
    def path(self):
        return _PATHS[self.path_type]()

    def sample_t(self, batch: int, image_seq_len: int, generator: torch.Generator | None = None,
                 device=None, base: torch.Tensor | None = None) -> torch.Tensor:
        """Flux-time t, (batch,) fp32: uniform / uniform_a_b (base ~ U[0, 1))
        or lognorm (base ~ N(0, 1), t = sigmoid(base)), then the resolution
        shift. `base` replaces the draw."""
        t0, t1 = 0.0, 1.0
        if self.snr_type.startswith("uniform"):
            if "_" in self.snr_type:
                _, a, b = self.snr_type.split("_")
                t0, t1 = float(a), float(b)
            if base is None:
                base = torch.rand((batch,), generator=generator, device=device)
            t = base * (t1 - t0) + t0
        elif self.snr_type == "lognorm":
            if base is None:
                base = torch.randn((batch,), generator=generator, device=device)
            t = torch.sigmoid(base) * (t1 - t0) + t0
        else:
            raise NotImplementedError(f"snr_type {self.snr_type}")
        if self.do_shift:
            t = shift_training_time(t, image_seq_len)
        return t

    def training_losses(
        self,
        model_fn,
        x1: torch.Tensor,
        model_kwargs: dict | None = None,
        cond: torch.Tensor | None = None,
        img_mask: torch.Tensor | None = None,
        t: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> dict:
        """Masked velocity-matching loss: model_fn(concat(x_t, cond),
        timesteps=t, **model_kwargs) against the flux-time velocity x0 - x1,
        summed over real tokens and channels and divided by their count.
        Returns dict(loss (B,), task_loss (B,) detached, t (B,))."""
        if self.model_type != ModelType.VELOCITY:
            raise NotImplementedError("training supports velocity prediction (reference parity)")
        if t is None:
            t = self.sample_t(x1.shape[0], x1.shape[1], generator, device=x1.device)
        if noise is None:
            noise = torch.randn(x1.shape, generator=generator, dtype=torch.float32, device=x1.device).to(x1.dtype)
        x0 = noise
        u = 1.0 - t  # data time for the path plan
        xt = self.path.compute_xt(u, x0, x1)
        target = -self.path.compute_ut(u, x0, x1)  # flux-time velocity
        model_in = torch.cat([xt, cond], dim=-1) if cond is not None else xt
        pred = model_fn(model_in, timesteps=t, **(model_kwargs or {}))
        diff = (pred - target).to(torch.float32)
        if img_mask is not None:
            diff = diff * img_mask[..., None]
            denom = img_mask.sum(dim=1).to(torch.float32) * diff.shape[-1]
            task_loss = diff.square().sum(dim=(1, 2)) / denom
        else:
            task_loss = diff.square().mean(dim=tuple(range(1, diff.dim())))
        return {"loss": task_loss, "task_loss": task_loss.detach(), "t": t}


    # ----------------------------- conversions -----------------------------

    def velocity_from_model(self, model_out, x, t):
        """The model's prediction type mapped to flux-time velocity at flux t."""
        u = 1.0 - t
        if self.model_type == ModelType.VELOCITY:
            return model_out
        if self.model_type == ModelType.SCORE:  # data-time velocity from the score, sign flipped
            return -self.path.get_velocity_from_score(model_out, x, u)
        if self.model_type == ModelType.NOISE:
            sigma_t, _ = self.path.compute_sigma_t(path_mod.expand_t(u, x))
            return -self.path.get_velocity_from_score(model_out / -sigma_t, x, u)
        raise NotImplementedError(self.model_type)

    def score_from_velocity(self, velocity_flux, x, t):
        """The score at flux time t from a flux-time velocity prediction."""
        return self.path.get_score_from_velocity(-velocity_flux, x, 1.0 - t)


def create_transport(
    path_type: str = "Linear",
    prediction: str = "velocity",
    loss_weight=None,
    train_eps: float | None = None,
    sample_eps: float | None = None,
    snr_type: str = "uniform",
    do_shift: bool = True,
) -> Transport:
    """The reference's factory: path type, prediction and the eps defaults."""
    model_type = {
        "noise": ModelType.NOISE,
        "score": ModelType.SCORE,
        "velocity": ModelType.VELOCITY,
    }[prediction]
    ptype = {"Linear": PathType.LINEAR, "GVP": PathType.GVP, "VP": PathType.VP}[path_type]
    if ptype == PathType.VP:
        train_eps = 1e-5 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    elif model_type != ModelType.VELOCITY:
        train_eps = 1e-3 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    else:
        train_eps, sample_eps = 0.0, 0.0
    return Transport(model_type=model_type, path_type=ptype, train_eps=train_eps,
                     sample_eps=sample_eps, snr_type=snr_type, do_shift=do_shift)
