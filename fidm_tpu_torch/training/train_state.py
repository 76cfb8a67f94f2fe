"""Train state, optimizer, and the train and eval steps (PyTorch port of
`fidm_tpu/training/train_state.py`).

One step: q_sample -> known-region injection -> UNet forward (the attention
kernel on the card) -> masked MSE -> backward -> global-norm clip -> AdamW,
all on the device; the metrics come back as device tensors, so a step never
waits for the card (the loop reads them once per epoch).

- `TrainDraws` is the step's randomness: timesteps, diffusion noise,
  injection noise and label drops, each from a `torch.Generator` seeded from
  (seed, path of indices) through `numpy.random.SeedSequence`, where the JAX
  step splits and folds a threefry key. The step folds in its update count,
  the loss evaluation folds in 0 (and 1 for label drops), accumulation
  splits one child per microbatch, as the JAX step does with its key.
- `make_optimizer` is optax's `chain(clip_by_global_norm(c), adamw(lr, b1,
  b2, eps=1e-8, weight_decay))` written out: the clip multiplies every
  gradient by c / norm when norm >= c and leaves them as they are
  otherwise (`torch.nn.utils.clip_grad_norm_` multiplies by c / (norm +
  1e-6), another function); Adam's moments, bias corrections and
  `m / (sqrt(v) + eps)`; the decay `wd * param` added after Adam; and the
  step `-lr(count) * update` with the count of the updates before this one.
  `param_mask` freezes: a masked-out parameter gets no update at all, and
  the clip's norm is taken over the trainable gradients only.
- The parameters live in the model and are updated in place. With
  `param_transform` (LoRA) the trained tensors are other tensors, and
  `param_transform(params)` gives the model weights they stand for
  (`models.layers.weight_overrides`), applied for the forward and the
  backward of the step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..diffusion import gaussian as gd
from ..diffusion.losses import training_losses
from ..diffusion.schedules import DiffusionSchedule
from ..models.layers import weight_overrides

__all__ = ["TrainDraws", "TrainState", "Optimizer", "make_optimizer", "global_norm",
           "clip_by_global_norm", "make_train_step", "make_eval_step"]

# the child index base of `TrainDraws.split`, apart from every fold index a
# loop uses (epochs, update counts, batches, 0, 1 and 10_000)
_SPLIT = 1 << 40


class TrainDraws:
    """The random draws of training from one integer seed and a path of
    indices. `fold(i)` is the child at index i; each draw seeds a
    `torch.Generator` on `device` from (seed, path, stream), so the same
    path gives the same tensors in any order of calls."""

    def __init__(self, seed: int, device, path: Sequence[int] = ()):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.path = tuple(int(i) for i in path)

    def fold(self, index: int) -> "TrainDraws":
        return TrainDraws(self.seed, self.device, self.path + (int(index),))

    def split(self, n: int) -> List["TrainDraws"]:
        return [self.fold(_SPLIT + i) for i in range(n)]

    def generator(self, stream: int = 3) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, len(self.path), *self.path, stream])
        g = torch.Generator(device=self.device)
        g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
        return g

    def timesteps(self, batch: int, num_timesteps: int) -> torch.Tensor:
        return torch.randint(0, num_timesteps, (batch,), generator=self.generator(0),
                             device=self.device)

    def noise(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator(1), device=self.device)

    def inject(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator(2), device=self.device)


def _as_draws(draws, device) -> TrainDraws:
    """An integer seed becomes the root `TrainDraws` on `device`; a draws
    object (this module's or a test's stand-in) passes through."""
    if isinstance(draws, (int, np.integer)):
        return TrainDraws(int(draws), device)
    return draws


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, a 0-d device tensor."""
    norms = torch._foreach_norm(list(tensors))
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's `clip_by_global_norm`: every gradient times max_norm / norm
    when norm >= max_norm, unchanged otherwise. No host sync."""
    grads = list(grads)
    norm = global_norm(grads)
    coef = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(grads, coef)


class Optimizer:
    """AdamW after a global-norm clip, with optax's arithmetic; `update`
    changes the parameters in place. The state is a dict of the update
    count (a host int) and the two moments of each trainable parameter."""

    def __init__(self, lr_schedule: Callable[[int], float], weight_decay: float = 0.01,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float = 1.0, param_mask=None):
        self.lr_schedule = lr_schedule
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip
        self.param_mask = param_mask

    def trainable(self, params: Dict[str, torch.Tensor]) -> List[str]:
        """The names of the parameters the optimizer updates."""
        if self.param_mask is None:
            return list(params)
        mask = self.param_mask(params) if callable(self.param_mask) else self.param_mask
        return [k for k in params if mask[k]]

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        keys = self.trainable(params)
        return {"count": 0,
                "mu": {k: torch.zeros_like(params[k]) for k in keys},
                "nu": {k: torch.zeros_like(params[k]) for k in keys}}

    def adam_updates(self, grads: List[torch.Tensor], state: Dict, keys: List[str],
                     params: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax's `adamw` updates for (already clipped) gradients, without
        the learning rate: m_hat / (sqrt(v_hat) + eps) + wd * param. Advances
        the moments in `state` (not its count)."""
        b1, b2 = self.b1, self.b2
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** count)
        nu_hat = torch._foreach_div(nu, 1.0 - b2 ** count)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(params, self.weight_decay))
        return updates

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict,
               params: Dict[str, torch.Tensor]) -> None:
        keys = self.trainable(params)
        p = [params[k] for k in keys]
        g = clip_by_global_norm([grads[k] for k in keys], self.grad_clip)
        updates = self.adam_updates(g, state, keys, p)
        # the schedule at the count of the updates made before this one
        torch._foreach_add_(p, torch._foreach_mul(updates, -self.lr_schedule(state["count"])))
        state["count"] += 1


def make_optimizer(lr_schedule, weight_decay: float = 0.01, b1: float = 0.9,
                   b2: float = 0.999, grad_clip: float = 1.0, param_mask=None) -> Optimizer:
    """AdamW (eps 1e-8) after a global-norm clip; `param_mask` (a dict of
    bools by parameter name, or a callable params -> such a dict) freezes
    the False entries: they get exactly zero update."""
    return Optimizer(lr_schedule, weight_decay, b1, b2, 1e-8, grad_clip, param_mask)


@dataclasses.dataclass
class TrainState:
    """The model, its trained tensors (updated in place), the optimizer and
    its state, the update count and the optional EMA of the parameters.

    `params` are the model's own parameters (`dict(model.named_parameters())`)
    or, with LoRA, the adapter's tensors; `ema_params` (from
    `training.ema.init_ema`) is kept by `make_train_step(ema_decay=...)`."""

    model: nn.Module
    params: Dict[str, torch.Tensor]
    tx: Optimizer
    opt_state: Dict
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, params: Dict[str, torch.Tensor], tx: Optimizer,
               ema_params=None) -> "TrainState":
        return cls(model, params, tx, tx.init(params), 0, ema_params)

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
        self.tx.update(grads, self.opt_state, self.params)
        self.step += 1
        return self

    def state_dict(self) -> Dict:
        """The checkpointed tree: every tensor of the state, the counts, and
        the EMA (None without one)."""
        return {"params": dict(self.params),
                "opt_state": {"count": self.opt_state["count"],
                              "mu": dict(self.opt_state["mu"]),
                              "nu": dict(self.opt_state["nu"])},
                "step": self.step,
                "ema_params": None if self.ema_params is None else dict(self.ema_params)}

    @torch.no_grad()
    def load_state_dict(self, tree: Dict) -> "TrainState":
        """Copy a checkpointed tree into this state's tensors (same names
        and shapes; raises KeyError on a missing one)."""

        def copy(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str):
            missing = sorted(set(dst) ^ set(src))
            if missing:
                raise KeyError(f"{what}: names differ from the checkpoint's: {missing[:5]}")
            for k, t in dst.items():
                t.copy_(src[k])

        copy(self.params, tree["params"], "params")
        copy(self.opt_state["mu"], tree["opt_state"]["mu"], "optimizer mu")
        copy(self.opt_state["nu"], tree["opt_state"]["nu"], "optimizer nu")
        self.opt_state["count"] = int(tree["opt_state"]["count"])
        self.step = int(tree["step"])
        if self.ema_params is not None and tree.get("ema_params") is not None:
            copy(self.ema_params, tree["ema_params"], "ema_params")
        return self


_BATCH_KEYS = ("image", "masked_image", "mask", "label")


def _device_batch(batch, device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device` (tensors already there pass
    through without a copy)."""
    return {k: torch.as_tensor(np.ascontiguousarray(batch[k]) if isinstance(batch[k], np.ndarray)
                               else batch[k], device=device)
            for k in _BATCH_KEYS if k in batch}


def _loss_for_batch(model, sched: DiffusionSchedule, batch, draws, *, loss_type, var_type,
                    mean_type, use_injection, injection_schedule, vb_weight,
                    loss_weight="none", loss_weight_gamma=None, label_dropout=0.0,
                    null_label=None, use_labels=True):
    d = draws.fold(0)
    image = batch["image"]
    t = d.timesteps(image.shape[0], sched.num_timesteps)

    # class-conditional training: the labels pass through, a fraction
    # dropped to the null token (classifier-free guidance);
    # use_labels=False ignores a label-bearing loader
    y = batch.get("label") if use_labels else None
    if y is not None and label_dropout > 0.0:
        if null_label is None:
            raise ValueError("label_dropout requires null_label")
        from ..sampling.cfg import drop_labels

        y = drop_labels(draws.fold(1).generator(), y, label_dropout, null_label)

    def model_fn(x_t, tt, masked_image, mask):
        if y is not None:
            return model(x_t, tt, masked_image, mask, y)
        return model(x_t, tt, masked_image, mask)

    masked_image = batch["masked_image"]
    inject = use_injection and masked_image is not None
    terms = training_losses(
        sched, model_fn, image, t, d.noise(image.shape),
        inject_noise=d.inject(image.shape) if inject else None,
        mask=batch["mask"], masked_image=masked_image, loss_type=loss_type,
        var_type=var_type, mean_type=mean_type, use_injection=use_injection,
        injection_schedule=injection_schedule, vb_weight=vb_weight,
        loss_weight=loss_weight, loss_weight_gamma=loss_weight_gamma)
    return terms["loss"], terms


def make_train_step(
    sched: DiffusionSchedule,
    *,
    loss_type=gd.LossType.MSE,
    var_type=gd.ModelVarType.LEARNED_RANGE,
    mean_type=gd.ModelMeanType.EPSILON,
    use_injection: bool = True,
    injection_schedule: str = "all",
    vb_weight: float = 0.0,
    loss_weight: str = "none",
    loss_weight_gamma=None,
    param_transform: Optional[Callable] = None,
    ema_decay: Optional[float] = None,
    label_dropout: float = 0.0,
    null_label: Optional[int] = None,
    use_labels: bool = True,
    accum_steps: int = 1,
):
    """step(state, batch, draws) -> (state, metrics), updating the state in
    place. `batch` is a dict of NHWC arrays or tensors {image, masked_image,
    mask[, label]}; `draws` is an integer seed or a `TrainDraws`, into which
    the step folds its update count, so one seed drives an epoch.

    A "label" in the batch goes to the model as `y`; `label_dropout` > 0
    replaces labels by `null_label` at that rate; `use_labels=False` ignores
    them. `accum_steps` > 1 splits the batch into that many microbatches
    along axis 0, each with its own draws, averages their gradients, losses
    and terms, and makes one update. `param_transform(params)` maps the
    trained tensors to model weights (a dict module -> weight, see
    `models.layers.weight_overrides`), e.g. LoRA's factors merged onto a
    frozen base. The model runs in train() mode with dropout off, as the
    JAX step runs it.

    Metrics, as device tensors: loss, mse, grad_norm (before the clip),
    mask_coverage, and vb when the loss has it."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    loss_kw = dict(loss_type=loss_type, var_type=var_type, mean_type=mean_type,
                   use_injection=use_injection, injection_schedule=injection_schedule,
                   vb_weight=vb_weight, loss_weight=loss_weight,
                   loss_weight_gamma=loss_weight_gamma, label_dropout=label_dropout,
                   null_label=null_label, use_labels=use_labels)

    def step(state: TrainState, batch, draws):
        device = next(iter(state.params.values())).device
        batch = _device_batch(batch, device)
        draws = _as_draws(draws, device).fold(state.step)
        state.model.train()
        names = list(state.params)
        leaves = [state.params[k] for k in names]

        def value_and_grad(mb, d):
            overrides = param_transform(state.params) if param_transform is not None else {}
            with weight_overrides(overrides):
                loss, terms = _loss_for_batch(state.model, sched, mb, d, **loss_kw)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            return loss.detach(), {k: v.detach() for k, v in terms.items()}, grads

        if accum_steps == 1:
            loss, terms, grads = value_and_grad(batch, draws)
        else:
            B = batch["image"].shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} not divisible by accum_steps {accum_steps}")
            micro = {k: v.reshape((accum_steps, B // accum_steps) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = loss = terms = None
            for i, d in enumerate(draws.split(accum_steps)):
                l, tm, g = value_and_grad({k: v[i] for k, v in micro.items()}, d)
                if grads is None:
                    grads, loss, terms = g, l, tm
                else:
                    torch._foreach_add_(grads, g)
                    loss = loss + l
                    terms = {k: terms[k] + tm[k] for k in terms}
            inv = 1.0 / accum_steps
            torch._foreach_mul_(grads, inv)
            loss = loss * inv
            terms = {k: v * inv for k, v in terms.items()}
        grad_norm = global_norm(grads)
        state.apply_gradients(dict(zip(names, grads)))
        if ema_decay is not None and state.ema_params is not None:
            from .ema import update_ema

            update_ema(state.ema_params, state.params, ema_decay)
        metrics = {
            "loss": loss,
            "mse": terms.get("mse", loss),
            "grad_norm": grad_norm,
            # the fraction of pixels being inpainted
            "mask_coverage": batch["mask"].mean(),
        }
        if "vb" in terms:
            metrics["vb"] = terms["vb"]
        return state, metrics

    return step


def make_eval_step(
    sched: DiffusionSchedule,
    *,
    loss_type=gd.LossType.MSE,
    var_type=gd.ModelVarType.LEARNED_RANGE,
    mean_type=gd.ModelMeanType.EPSILON,
    use_injection: bool = True,
    injection_schedule: str = "all",
    vb_weight: float = 0.0,
    loss_weight: str = "none",
    loss_weight_gamma=None,
    param_transform: Optional[Callable] = None,
    use_labels: bool = True,
):
    """step(state, batch, draws) -> {"loss", "mse"}: the validation loss,
    without gradients, with `draws` used as given (no update count folded
    in)."""

    @torch.no_grad()
    def step(state: TrainState, batch, draws):
        device = next(iter(state.params.values())).device
        batch = _device_batch(batch, device)
        overrides = param_transform(state.params) if param_transform is not None else {}
        with weight_overrides(overrides):
            loss, terms = _loss_for_batch(
                state.model, sched, batch, _as_draws(draws, device),
                loss_type=loss_type, var_type=var_type, mean_type=mean_type,
                use_injection=use_injection, injection_schedule=injection_schedule,
                vb_weight=vb_weight, loss_weight=loss_weight,
                loss_weight_gamma=loss_weight_gamma, use_labels=use_labels)
        return {"loss": loss, "mse": terms.get("mse", loss)}

    return step
