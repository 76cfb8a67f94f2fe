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
  the clip's norm is taken over the trainable gradients only (under a mesh
  too: the optimizer takes that norm itself, over the fsdp shards).
- The parameters live in the model and are updated in place. With
  `param_transform` (LoRA) the trained tensors are other tensors, and
  `param_transform(params)` gives the model weights they stand for
  (`models.layers.weight_overrides`), applied for the forward and the
  backward of the step.
- Under a mesh (`parallel.create_mesh`, one process per rank) each rank's
  batch is its rows of the global batch, and its draws are its rows of the
  draws of the global batch (`parallel.collectives.RowDraws`), so the ranks
  together take the one-process step; the gradients are averaged over the
  ranks before the clip, and the metrics are global means, the same on
  every rank. A state made from `parallel.shard_params(..., use_fsdp=True)`
  (`TrainState.create(..., specs=specs)`) holds the sharded parameters and
  their moments as this rank's shards: the step gathers them into the model
  for the forward and backward, reduce-scatters their gradients, and leaves
  an empty placeholder in the model between steps (ZeRO-3).
- A mesh with a "model" axis (`parallel/tp.py`): a state from
  `parallel.tp_shard_params(model, mesh)` holds this rank's Megatron slices
  (the model computes its part of each block, the ranks of a model group
  take the same rows and draws, and a slice's gradient and moments stay this
  rank's); `make_train_step(spatial=True)` with a replicated state trains on
  this rank's block of H rows of its rows (`parallel.shard_batch(...,
  spatial=True)`), its draws that block of its rows' draws, the loss's sums
  completed over the axis, and every gradient summed over it. LoRA runs
  under both: over a tensor-parallel base (`TrainState.model_specs`) each
  rank adds its slice of every delta (`lora.lora_weights(..., specs,
  mesh)`), so the adapter's gradients are partial sums, summed over the
  axis as spatial partitioning sums every gradient.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..diffusion import gaussian as gd
from ..diffusion.losses import training_losses
from ..diffusion.schedules import DiffusionSchedule
from ..models.layers import weight_overrides
from ..parallel.mesh import row_ranks

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


def _clip(grads: List[torch.Tensor], max_norm: float, norm: torch.Tensor) -> List[torch.Tensor]:
    coef = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(grads, coef)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's `clip_by_global_norm`: every gradient times max_norm / norm
    when norm >= max_norm, unchanged otherwise. No host sync."""
    grads = list(grads)
    return _clip(grads, max_norm, global_norm(grads))


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
               params: Dict[str, torch.Tensor], specs: Optional[Dict] = None,
               mesh=None) -> None:
        """One update in place. The clip's norm is that of the trainable
        gradients; where `specs` make some of them this rank's fsdp shards,
        the norm of the whole (the shards' squares summed over `mesh`'s fsdp
        axis), the same on every rank."""
        from ..parallel.collectives import global_grad_norm

        keys = self.trainable(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        g = _clip(g, self.grad_clip, global_grad_norm(keys, g, specs, mesh))
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
    `training.ema.init_ema`) is kept by `make_train_step(ema_decay=...)`.
    `specs` (from `parallel.shard_params`) are the placements of `params`
    over a mesh's fsdp axis: a `Shard(d)` entry of `params` is this rank's
    shard, and so are its moments and its EMA; None means every tensor is
    whole. `model_specs` are the placements of the model's own parameters
    where `params` are other tensors: the specs of `parallel.tp_shard_params(
    model, mesh)` for a LoRA adapter over a tensor-parallel frozen base
    (None: the model is whole, or its tensors are `params`)."""

    model: nn.Module
    params: Dict[str, torch.Tensor]
    tx: Optimizer
    opt_state: Dict
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    specs: Optional[Dict] = None
    model_specs: Optional[Dict] = None

    @classmethod
    def create(cls, model: nn.Module, params: Dict[str, torch.Tensor], tx: Optimizer,
               ema_params=None, specs=None, model_specs=None) -> "TrainState":
        return cls(model, params, tx, tx.init(params), 0, ema_params, specs, model_specs)

    def apply_gradients(self, grads: Dict[str, torch.Tensor], mesh=None) -> "TrainState":
        """One optimizer update; `grads` in the state's layout (`mesh`: the
        mesh of the state's fsdp shards)."""
        self.tx.update(grads, self.opt_state, self.params, self.specs, mesh)
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
                    null_label=None, use_labels=True, spatial=None):
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

        rows = getattr(draws, "rows", None)
        if rows is None:
            y = drop_labels(draws.fold(1).generator(), y, label_dropout, null_label)
        else:  # this rank's rows of the global batch's drops
            y_all = torch.zeros((rows.total,) + tuple(y.shape[1:]), dtype=y.dtype,
                                device=y.device)
            y_all[rows.lo:rows.hi] = y
            y = rows.of(drop_labels(draws.fold(1).generator(), y_all, label_dropout,
                                    null_label))

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
        loss_weight=loss_weight, loss_weight_gamma=loss_weight_gamma,
        spatial=spatial)
    return terms["loss"], terms


def _mesh_inputs(state, batch, draws, mesh, spatial: bool = False):
    """The step's batch on the state's device and its draws; under a mesh
    the draws are this rank's rows of the global batch's (and, `spatial`,
    this rank's block of H rows of them)."""
    device = next(iter(state.params.values())).device
    batch = _device_batch(batch, device)
    draws = _as_draws(draws, device)
    if mesh is not None:
        from ..parallel.collectives import RowDraws, SpatialDraws, rank_hblock, rank_rows

        draws = RowDraws(draws, rank_rows(mesh, batch["image"].shape[0]))
        if spatial:
            draws = SpatialDraws(draws, rank_hblock(mesh, batch["image"].shape[1]))
    return device, batch, draws


def _check_specs(state, mesh):
    """The state's fsdp-sharded names (none without a mesh, where a sharded
    state is an error); a state of model slices must be its model's own."""
    from ..parallel.collectives import model_sharded_names, sharded_names

    names = sharded_names(state.specs)
    if names and mesh is None:
        raise ValueError("the state holds fsdp shards (specs from parallel.shard_params): "
                         "build the step with mesh=")
    model = model_sharded_names(state.specs)
    if (model or model_sharded_names(state.model_specs)) and mesh is None:
        raise ValueError("the state holds model-axis slices (specs from "
                         "parallel.tp_shard_params): build the step with mesh=")
    if model:
        own = dict(state.model.named_parameters())
        if any(own[k].shape != state.params[k].shape for k in model):
            raise ValueError("the state's model-axis slices are not its model's parameters: "
                             "build the state from parallel.tp_shard_params(model, mesh)")
    return names


def _model_specs(state):
    """The placements of the state's model: its own `model_specs` (a LoRA
    base), else those of its parameters."""
    return state.specs if state.model_specs is None else state.model_specs


def _model_axis(state, mesh, spatial: bool):
    """The model-axis context of a step's forward and backward (`tp.attach`,
    or nothing): "tp" for a model of slices, "spatial" for spatial=True."""
    from ..parallel.collectives import model_sharded_names

    specs = _model_specs(state)
    tp = bool(model_sharded_names(specs))
    if mesh is None or not (tp or spatial):
        return contextlib.nullcontext()
    from ..parallel.mesh import axis_size
    from ..parallel.tp import attach

    if axis_size(mesh, "model") <= 1:
        raise ValueError("a state of model-axis slices needs a mesh with a 'model' axis")
    if tp and spatial:
        raise ValueError("a state of model-axis slices and spatial=True both use the "
                         "mesh's 'model' axis: pick one latency-scaling layout")
    return attach(state.model, mesh, "spatial" if spatial else "tp", specs)


def _check_spatial(mesh, spatial: bool) -> None:
    """spatial=True needs a mesh with a "model" axis of more than one rank."""
    if not spatial:
        return
    from ..parallel.mesh import axis_size

    if mesh is None:
        raise ValueError("spatial=True requires a mesh")
    if axis_size(mesh, "model") <= 1:
        raise ValueError(
            f"spatial=True needs a 'model' mesh axis > 1; mesh is "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")


def _reduce_and_apply(state: TrainState, names: List[str], grads: List[torch.Tensor],
                      mesh, spatial: bool = False) -> torch.Tensor:
    """A step's gradients (one per name of `state.params`) averaged over the
    ranks into the state's layout (as they are without a mesh), then one
    optimizer update; returns the global norm of all of them before the
    clip, the step's `grad_norm`. They are partial sums over the model axis
    under spatial partitioning and for the trained tensors over a base of
    model slices (`model_specs`: a LoRA adapter)."""
    from ..parallel.collectives import global_grad_norm, model_sharded_names, reduce_gradients

    partial = spatial or bool(model_sharded_names(state.model_specs))
    grads = reduce_gradients(names, grads, state.specs, mesh, partial)
    grad_norm = global_grad_norm(names, grads, state.specs, mesh)
    state.apply_gradients(dict(zip(names, grads)), mesh)
    return grad_norm


def _global_means(values: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """0-d metrics -> their means over the ranks (one collective); as they
    are without a mesh."""
    if mesh is None:
        return values
    from ..parallel.collectives import mean_over_ranks

    keys = list(values)
    vec = torch.stack([values[k].float() for k in keys])
    mean_over_ranks([vec], mesh)
    return {k: vec[i] for i, k in enumerate(keys)}


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
    mesh=None,
    param_transform: Optional[Callable] = None,
    ema_decay: Optional[float] = None,
    label_dropout: float = 0.0,
    null_label: Optional[int] = None,
    use_labels: bool = True,
    accum_steps: int = 1,
    spatial: bool = False,
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

    `mesh` (a `parallel.create_mesh` mesh; every rank calls the step): the
    batch is this rank's rows of the global batch (`DataLoader(
    process_local=True)` yields them; `parallel.shard_batch` cuts them from
    a whole batch), the draws its rows of the global draws, microbatch i its
    rows of global microbatch i; the gradients are averaged over the ranks
    before the clip; fsdp-sharded tensors of the state are gathered for the
    forward and their gradients reduce-scattered. In one rank the step is
    the unmeshed step bit for bit. Over a "model" axis, a state from
    `parallel.tp_shard_params` trains tensor-parallel, and `spatial=True`
    (with a replicated state and a `shard_batch(..., spatial=True)` batch)
    trains on this rank's block of H rows (see the module doc). LoRA runs
    under both: tensor-parallel, the state holds the adapter with
    `model_specs` the frozen base's slices, and `param_transform` must hand
    each rank its slice of every delta (`lora.lora_weights(model, cfg, l,
    specs, mesh)`); spatial, the base is whole. The returned step's
    `spatial` attribute tells `fit` to cut its H blocks.

    Metrics, as device tensors (global means under a mesh): loss, mse,
    grad_norm (before the clip), mask_coverage, and vb when the loss has it."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    _check_spatial(mesh, spatial)
    loss_kw = dict(loss_type=loss_type, var_type=var_type, mean_type=mean_type,
                   use_injection=use_injection, injection_schedule=injection_schedule,
                   vb_weight=vb_weight, loss_weight=loss_weight,
                   loss_weight_gamma=loss_weight_gamma, label_dropout=label_dropout,
                   null_label=null_label, use_labels=use_labels)

    def microbatches(batch):
        """accum_steps microbatches of this rank's rows."""
        B = batch["image"].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} not divisible by accum_steps {accum_steps}")
        if mesh is None or row_ranks(mesh) == 1:
            micro = {k: v.reshape((accum_steps, B // accum_steps) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            return [{k: v[i] for k, v in micro.items()} for i in range(accum_steps)]
        from ..parallel.collectives import gather_rows, rank_rows

        # microbatch i of the GLOBAL batch, and this rank's rows of it
        lo, hi, total = rank_rows(mesh, B)
        full = {k: gather_rows(v, mesh) for k, v in batch.items()}
        Bm, m = total // accum_steps, B // accum_steps
        r0 = lo // accum_steps
        return [{k: v[i * Bm + r0: i * Bm + r0 + m] for k, v in full.items()}
                for i in range(accum_steps)]

    def step(state: TrainState, batch, draws):
        from ..parallel.collectives import gathered, model_group

        spatial_group = model_group(mesh) if spatial else None
        sharded = set(_check_specs(state, mesh))
        if sharded and param_transform is not None:
            raise ValueError("fsdp-sharded trained tensors with param_transform: shard "
                             "only the model's own parameters")
        device, batch, draws = _mesh_inputs(state, batch, draws, mesh, spatial)
        draws = draws.fold(state.step)
        state.model.train()
        names = list(state.params)

        with gathered(state.model, state.params, state.specs, mesh), \
                _model_axis(state, mesh, spatial):
            model_params = dict(state.model.named_parameters()) if sharded else {}
            leaves = [model_params[k] if k in sharded else state.params[k] for k in names]

            def value_and_grad(mb, d):
                overrides = (param_transform(state.params) if param_transform is not None
                             else {})
                with weight_overrides(overrides):
                    loss, terms = _loss_for_batch(state.model, sched, mb, d,
                                                  spatial=spatial_group, **loss_kw)
                    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
                return loss.detach(), {k: v.detach() for k, v in terms.items()}, grads

            if accum_steps == 1:
                loss, terms, grads = value_and_grad(batch, draws)
            else:
                grads = loss = terms = None
                for mb, d in zip(microbatches(batch), draws.split(accum_steps)):
                    l, tm, g = value_and_grad(mb, d)
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
        grad_norm = _reduce_and_apply(state, names, grads, mesh, spatial)
        if ema_decay is not None and state.ema_params is not None:
            from .ema import update_ema

            update_ema(state.ema_params, state.params, ema_decay)
        means = {"loss": loss, "mse": terms.get("mse", loss),
                 # the fraction of pixels being inpainted
                 "mask_coverage": batch["mask"].mean()}
        if "vb" in terms:
            means["vb"] = terms["vb"]
        means = _global_means(means, mesh)
        metrics = {"loss": means["loss"], "mse": means["mse"], "grad_norm": grad_norm,
                   "mask_coverage": means["mask_coverage"]}
        if "vb" in means:
            metrics["vb"] = means["vb"]
        return state, metrics

    step.spatial = spatial
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
    mesh=None,
    param_transform: Optional[Callable] = None,
    use_labels: bool = True,
    spatial: bool = False,
):
    """step(state, batch, draws) -> {"loss", "mse"}: the validation loss,
    without gradients, with `draws` used as given (no update count folded
    in). Under `mesh` the batch and the draws are this rank's rows, as in
    `make_train_step`, and the losses are the global means, the same on
    every rank; a model of model-axis slices runs tensor-parallel, and
    `spatial=True` takes this rank's block of H rows of its rows, as the
    train step does (LoRA's `param_transform` too, as there)."""
    _check_spatial(mesh, spatial)

    @torch.no_grad()
    def step(state: TrainState, batch, draws):
        from ..parallel.collectives import gathered, model_group

        _check_specs(state, mesh)
        device, batch, draws = _mesh_inputs(state, batch, draws, mesh, spatial)
        with gathered(state.model, state.params, state.specs, mesh), \
                _model_axis(state, mesh, spatial):
            overrides = param_transform(state.params) if param_transform is not None else {}
            with weight_overrides(overrides):
                loss, terms = _loss_for_batch(
                    state.model, sched, batch, draws,
                    loss_type=loss_type, var_type=var_type, mean_type=mean_type,
                    use_injection=use_injection, injection_schedule=injection_schedule,
                    vb_weight=vb_weight, loss_weight=loss_weight,
                    loss_weight_gamma=loss_weight_gamma, use_labels=use_labels,
                    spatial=model_group(mesh) if spatial else None)
        return _global_means({"loss": loss, "mse": terms.get("mse", loss)}, mesh)

    step.spatial = spatial
    return step
