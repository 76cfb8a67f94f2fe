"""The port's train step, optimizer, schedules, EMA, remat and LoRA against
the JAX package's.

One float32 train step on a tiny UNet (16², width 32, `channel_mult`
(1, 2), every leaf of the JAX init perturbed so that no zero-initialised
conv hides a path): the loss and every gradient against `jax.value_and_grad`
of the JAX step's `_loss_for_batch` (inside `make_train_step`), with the port fed the draws the JAX step
makes (`JaxTrainDraws`: `fold_in(key, step)`, then `fold_in(·, 0)` split
into the timestep and loss keys, the loss key split into the noise and
injection keys). Then the optimizer on those gradients against optax, the
clip and the AdamW update apart (Adam's first update is nearly lr·sign(g),
so comparing parameters after a step would magnify rounding where a
gradient is near zero), and three steps of both trainers, loss by loss.
Two JAX models are compiled here (the init and the train step, whose
optimizer keeps the gradients it receives: the JAX step's own
`value_and_grad`), and three optax updates on one flat vector, each jitted
once. Torch runs on one intra-op thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.lora import init_lora as jax_init_lora
from fidm_tpu.lora import lora_param_count as jax_lora_param_count
from fidm_tpu.lora import merge_lora as jax_merge_lora
from fidm_tpu.lora import select_lora_targets as jax_select_lora_targets
from fidm_tpu.models import InpaintingUNet as JaxInpaintingUNet
from fidm_tpu.training import TrainState as JaxTrainState
from fidm_tpu.training import make_lr_schedule as jax_make_lr_schedule
from fidm_tpu.training import make_optimizer as jax_make_optimizer
from fidm_tpu.training import make_train_step as jax_make_train_step
from fidm_tpu.training.ema import update_ema as jax_update_ema
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.lora import (flatten_lora, init_lora, lora_param_count, lora_weights,
                                 merge_lora, select_lora_targets)
from fidm_tpu_torch.models import InpaintingUNet
from fidm_tpu_torch.models.layers import weight_overrides
from fidm_tpu_torch.models.weights import state_dict_from_jax
from fidm_tpu_torch.training import (TrainDraws, TrainState, init_ema, make_lr_schedule,
                                     make_optimizer, make_train_step, update_ema)
from fidm_tpu_torch.training import train_state as port_train_state

from _torch_port_common import JCFG, PCFG, perturbed_jax_variables

B = 2
LR = 1e-3
LOSS_KW = dict(use_injection=True, injection_schedule="all", vb_weight=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (and one BLAS thread) for this module: the test
    run shares the CPU between its workers."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


class JaxTrainDraws:
    """`TrainDraws`' interface over a JAX key, drawing what the JAX step
    draws: fold -> fold_in, split -> jax.random.split; on the key of one loss
    evaluation (already folded with 0) the timestep and loss keys are its
    split, the noise and injection keys the loss key's split."""

    def __init__(self, key):
        self.key = key

    def fold(self, index):
        return JaxTrainDraws(jax.random.fold_in(self.key, index))

    def split(self, n):
        return [JaxTrainDraws(k) for k in jax.random.split(self.key, n)]

    def _keys(self):
        t_key, loss_key = jax.random.split(self.key)
        return (t_key, *jax.random.split(loss_key))

    def timesteps(self, batch, num_timesteps):
        return _t(jax.random.randint(self._keys()[0], (batch,), 0, num_timesteps)).long()

    def noise(self, shape):
        return _t(jax.random.normal(self._keys()[1], tuple(shape), jnp.float32))

    def inject(self, shape):
        return _t(jax.random.normal(self._keys()[2], tuple(shape), jnp.float32))


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    s = JCFG.image_size
    img = (0.5 * rng.standard_normal((B, s, s, 3))).astype(np.float32)
    mask = np.zeros((B, s, s, 1), np.float32)
    mask[0, 4:12, 2:10] = 1.0
    mask[1, :8] = 1.0
    return {"image": img, "masked_image": img * (1 - mask), "mask": mask}


def _recording(tx):
    """`tx`, keeping in its state the gradients each update receives: what
    the JAX step's `jax.value_and_grad` of `_loss_for_batch` gave, before
    the clip."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def setup():
    """The JAX variables, the schedules, a batch, and three steps of the JAX
    trainer (one compile) at lr 1e-3 from one key: each step's metrics, and
    the first step's gradients."""
    variables = perturbed_jax_variables(JCFG, seed=3)
    jsched = JaxSchedule.create("quadratic", 1000)
    psched = DiffusionSchedule.create("quadratic", 1000, device="cpu")
    batch = _batch()
    key = jax.random.PRNGKey(7)
    jstate = JaxTrainState.create(
        apply_fn=JaxInpaintingUNet(JCFG).apply, params=variables["params"],
        tx=_recording(jax_make_optimizer(optax.constant_schedule(LR))))
    jstep = jax_make_train_step(jsched, donate=False)
    metrics, grads = [], None
    for _ in range(3):
        jstate, m = jstep(jstate, batch, key)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = jax.tree_util.tree_map(np.asarray, jstate.opt_state[1])
    assert int(jstate.step) == 3
    return dict(variables=variables, jsched=jsched, psched=psched, batch=batch, key=key,
                metrics=metrics, grads=grads)


def _port_model(variables, **cfg):
    model = InpaintingUNet(dataclasses.replace(PCFG, **cfg))
    model.load_state_dict(state_dict_from_jax(variables, PCFG), strict=True)
    return model


def _port_grads(model, psched, batch, draws, **kw):
    batch = port_train_state._device_batch(batch, "cpu")
    params = dict(model.named_parameters())
    loss, terms = port_train_state._loss_for_batch(model, psched, batch, draws, **{
        **dict(loss_type=port_train_state.gd.LossType.MSE,
               var_type=port_train_state.gd.ModelVarType.LEARNED_RANGE,
               mean_type=port_train_state.gd.ModelMeanType.EPSILON), **LOSS_KW, **kw})
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, terms, dict(zip(params, grads))


def test_loss_and_gradients_match_jax(setup):
    """Every gradient within 2e-5 of its tensor's largest (float32 sums in
    another order through 60 layers) plus 1e-7, the loss within 1e-5. The
    1e-7 is for the biases that feed a GroupNorm of one channel per group
    (width 32, 32 groups): their gradient is 0 in exact arithmetic, and both
    sides return rounding noise of about 1e-8 there; every other tensor's
    largest gradient is above 1e-3."""
    model = _port_model(setup["variables"])
    loss, terms, grads = _port_grads(model, setup["psched"], setup["batch"],
                                     JaxTrainDraws(setup["key"]).fold(0))
    ref_loss = setup["metrics"][0]
    assert abs(float(loss.detach()) - ref_loss["loss"]) <= 1e-5 * abs(ref_loss["loss"])
    assert abs(float(terms["mse"]) - ref_loss["mse"]) <= 1e-5 * abs(ref_loss["loss"])
    ref = state_dict_from_jax({"params": setup["grads"]}, PCFG)
    assert set(ref) == set(grads)
    for name, g in grads.items():
        bound = 2e-5 * ref[name].abs().max().item() + 1e-7
        assert (g - ref[name]).abs().max().item() <= bound, name


def _leaves(tree):
    """The tree's arrays in JAX's leaf order, as torch tensors, and their
    concatenation as one numpy vector: the optimizer is elementwise but for
    the clip's norm, so optax runs on the one vector (one small program)
    and the port on the tensors."""
    leaves = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(tree)]
    return [torch.from_numpy(a.copy()) for a in leaves], np.concatenate([a.ravel() for a in leaves])


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors]).numpy()


def test_clip_matches_optax(setup):
    """The clip alone: scaled by max_norm / norm above the bound, the same
    tensors below it."""
    clip = jax.jit(lambda g: optax.clip_by_global_norm(1.0).update(g, optax.EmptyState())[0])
    for factor in (1.0, 1e-3):
        grads, flat = _leaves(jax.tree_util.tree_map(lambda g: g * np.float32(factor),
                                                     setup["grads"]))
        ref = np.asarray(clip({"g": flat})["g"])
        norm = port_train_state.global_norm(grads).item()
        ours = port_train_state.clip_by_global_norm(grads, 1.0)
        assert (norm > 1.0) == (factor == 1.0)
        if norm < 1.0:
            assert all(torch.equal(o, g) for o, g in zip(ours, grads))
        np.testing.assert_allclose(_flat(ours), ref, rtol=2e-6, atol=1e-9)


def test_adamw_updates_match_optax(setup):
    """The AdamW half on the same (clipped) gradients, three updates, each
    against optax.adamw's at a learning rate of 1, without the clip."""
    params, flat_params = _leaves(setup["variables"]["params"])
    tx = optax.adamw(1.0, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    opt_state = tx.init({"w": flat_params})
    tx_update = jax.jit(tx.update)
    names = [str(i) for i in range(len(params))]
    ours = make_optimizer(make_lr_schedule("none", 1.0, 10))
    state = ours.init(dict(zip(names, params)))
    rng = np.random.default_rng(5)
    for i, scale in enumerate((1.0, 0.5, -0.3)):
        grads, flat = _leaves(jax.tree_util.tree_map(
            lambda g: (scale * g + 1e-3 * rng.standard_normal(g.shape)).astype(np.float32),
            setup["grads"]))
        updates, opt_state = tx_update({"w": flat}, opt_state, {"w": flat_params})
        got = ours.adam_updates(grads, state, names, params)
        state["count"] += 1
        np.testing.assert_allclose(-_flat(got), np.asarray(updates["w"]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"update {i}")


def test_optimizer_chain_matches_jax_make_optimizer(setup):
    """The whole chain, clip then AdamW, three updates at lr 1e-3: each
    parameter's change against optax's, to 1e-3 of the learning rate."""
    params, flat_params = _leaves(setup["variables"]["params"])
    tx = jax_make_optimizer(optax.constant_schedule(LR))
    opt_state = tx.init({"w": flat_params})
    tx_update = jax.jit(tx.update)
    names = [str(i) for i in range(len(params))]
    sd = dict(zip(names, params))
    ours = make_optimizer(make_lr_schedule("none", LR, 10))
    state = ours.init(sd)
    for scale in (1.0, 2.0, -0.5):
        grads, flat = _leaves(jax.tree_util.tree_map(lambda g: (scale * g).astype(np.float32),
                                                     setup["grads"]))
        updates, opt_state = tx_update({"w": flat}, opt_state, {"w": flat_params})
        before = _flat(list(sd.values()))
        ours.update(dict(zip(names, grads)), state, sd)
        flat_params = flat_params + np.asarray(updates["w"])
        np.testing.assert_allclose(_flat(list(sd.values())) - before, np.asarray(updates["w"]),
                                   rtol=0, atol=1e-3 * LR)
    assert state["count"] == 3


def test_three_train_steps_track_jax(setup):
    """Both trainers from the same weights and key, three steps at lr 1e-3
    on one batch: loss and gradient norm step by step, within 1e-4 (the
    updates of gradients near zero, about lr·sign(g), carry float32
    rounding into the next step's weights)."""
    model = _port_model(setup["variables"])
    pstate = TrainState.create(model, dict(model.named_parameters()),
                               make_optimizer(make_lr_schedule("none", LR, 10)))
    pstep = make_train_step(setup["psched"])
    draws = JaxTrainDraws(setup["key"])
    for i, jm in enumerate(setup["metrics"]):
        pstate, pm = pstep(pstate, setup["batch"], draws)
        assert set(pm) == set(jm) == {"loss", "mse", "grad_norm", "mask_coverage"}
        for k in ("loss", "grad_norm", "mask_coverage"):
            assert abs(float(pm[k]) - jm[k]) <= 1e-4 * abs(jm[k]), (i, k)
        assert all(m.ndim == 0 for m in pm.values())
    assert pstate.step == 3


@pytest.mark.parametrize("kind,warmup,total", [("cosine", 0, 30), ("cosine", 6, 30),
                                               ("cosine", 40, 30), ("step", 0, 30),
                                               ("step", 0, 2), ("none", 0, 30)])
def test_lr_schedules_match_optax(kind, warmup, total):
    """Every count from 0 past the end; warmup past the total is clamped."""
    ours = make_lr_schedule(kind, 2e-4, total, warmup, 0.05)
    ref = jax_make_lr_schedule(kind, 2e-4, total, warmup, 0.05)
    for count in range(total + 4):
        # optax evaluates in float32, the port in float64
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-5, abs=1e-12), count
    if warmup:
        assert ours(0) == 0.0


def test_lr_schedule_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_lr_schedule("linear", 1e-4, 10)


def test_ema_matches_jax():
    rng = np.random.default_rng(9)
    ema = {"a": rng.standard_normal((3, 4)).astype(np.float32),
           "b": rng.standard_normal((5,)).astype(np.float32)}
    params = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in ema.items()}
    ref = jax_update_ema(ema, params, 0.9)
    ours = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    live = {k: torch.from_numpy(v) for k, v in params.items()}
    assert update_ema(ours, live, 0.9) is ours
    for k in ema:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
    snap = init_ema(live)
    live["a"].add_(1.0)
    assert not torch.equal(snap["a"], live["a"])  # a copy, not an alias


def _fresh(variables, **cfg):
    model = _port_model(variables, **cfg)
    return TrainState.create(model, dict(model.named_parameters()),
                             make_optimizer(make_lr_schedule("none", LR, 10)))


def test_gradient_accumulation_matches_manual_average(setup):
    """accum_steps=2: one update with the mean of the two microbatches'
    gradients (each with its own draws), and the mean loss."""
    batch, psched = setup["batch"], setup["psched"]
    state = _fresh(setup["variables"])
    draws = TrainDraws(4, "cpu")
    state, metrics = make_train_step(psched, accum_steps=2)(state, batch, draws)
    manual = _fresh(setup["variables"])
    subs = draws.fold(0).split(2)
    losses, grads = [], []
    for i, d in enumerate(subs):
        mb = {k: v[i:i + 1] for k, v in batch.items()}
        loss, _, g = _port_grads(manual.model, psched, mb, d)
        losses.append(float(loss))
        grads.append(g)
    avg = {k: (grads[0][k] + grads[1][k]) * 0.5 for k in grads[0]}
    manual.apply_gradients(avg)
    assert float(metrics["loss"]) == pytest.approx(np.mean(losses), rel=1e-6)
    for k in avg:
        torch.testing.assert_close(state.params[k], manual.params[k], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(psched, accum_steps=3)(state, batch, draws)


def test_labels_pass_through_and_drop_at_p_0_and_1(setup):
    """A class-conditional model: label_dropout 1 gives the loss of all-null
    labels, no dropout the loss of the labels as given; use_labels=False
    ignores a label key, which an unconditional model otherwise refuses."""
    psched = setup["psched"]
    torch.manual_seed(0)
    model = InpaintingUNet(dataclasses.replace(PCFG, num_classes=3))
    with torch.no_grad():  # no zero-initialised conv: the labels must reach the output
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    batch = dict(setup["batch"], label=np.array([0, 1]))
    draws = TrainDraws(2, "cpu")

    def loss(b, **kw):
        b = port_train_state._device_batch(b, "cpu")
        return float(port_train_state._loss_for_batch(
            model, psched, b, draws, loss_type=port_train_state.gd.LossType.MSE,
            var_type=port_train_state.gd.ModelVarType.LEARNED_RANGE,
            mean_type=port_train_state.gd.ModelMeanType.EPSILON, **LOSS_KW, **kw)[0])

    null = dict(batch, label=np.array([2, 2]))
    assert loss(batch, label_dropout=1.0, null_label=2) == loss(null)
    assert loss(batch) != loss(null)
    assert loss(batch, label_dropout=0.0, null_label=2) == loss(batch)
    uncond = _port_model(setup["variables"])
    with pytest.raises(ValueError, match="num_classes"):
        make_train_step(psched)(TrainState.create(uncond, dict(uncond.named_parameters()),
                                                  make_optimizer(lambda c: LR)), batch, 0)
    state = _fresh(setup["variables"])
    _, m = make_train_step(psched, use_labels=False)(state, batch, 0)
    assert np.isfinite(float(m["loss"]))


def test_param_mask_freezes_instead_of_gradient_ascent():
    """Masked-out parameters get exactly zero update, with a dict mask or a
    callable one; the clip's norm covers the trainable gradients only."""
    for mask in ({"frozen": False, "trainable": True},
                 lambda p: {"frozen": False, "trainable": True}):
        params = {"frozen": torch.ones(()), "trainable": torch.ones(())}
        tx = make_optimizer(lambda c: 0.1, param_mask=mask)
        state = tx.init(params)
        assert set(state["mu"]) == {"trainable"}
        tx.update({"frozen": torch.tensor(0.5), "trainable": torch.tensor(0.5)}, state, params)
        assert params["frozen"].item() == 1.0
        assert params["trainable"].item() != 1.0


@pytest.mark.parametrize("policy", ["full", "convs"])
def test_remat_gives_the_same_gradients(setup, policy):
    """Rematerialised blocks recompute the same function: the loss and
    every gradient equal the plain model's."""
    draws = TrainDraws(6, "cpu").fold(0)
    plain = _port_grads(_port_model(setup["variables"]), setup["psched"], setup["batch"], draws)
    remat = _port_grads(_port_model(setup["variables"], remat=True, remat_policy=policy),
                        setup["psched"], setup["batch"], draws)
    assert float(remat[0]) == float(plain[0])
    for k in plain[2]:
        torch.testing.assert_close(remat[2][k], plain[2][k], rtol=1e-6, atol=1e-8)


def test_remat_policy_is_checked_and_inference_skips_checkpoints(setup):
    with pytest.raises(ValueError, match="remat_policy"):
        InpaintingUNet(dataclasses.replace(PCFG, remat=True, remat_policy="dots"))
    model = _port_model(setup["variables"], remat=True, remat_policy="full")
    x = torch.from_numpy(setup["batch"]["image"])
    t = torch.tensor([3, 700])
    mi, m = (torch.from_numpy(setup["batch"][k]) for k in ("masked_image", "mask"))
    with torch.no_grad():
        out = model(x, t, mi, m)
    torch.testing.assert_close(out, _port_model(setup["variables"])(x, t, mi, m).detach(),
                               rtol=0, atol=0)


def test_dropout_is_off_in_train_mode_unless_asked(setup):
    """As in the JAX step, which never passes deterministic=False."""
    model = _port_model(setup["variables"], dropout=0.5).train()
    x = torch.from_numpy(setup["batch"]["image"])
    t = torch.tensor([3, 700])
    mi, m = (torch.from_numpy(setup["batch"][k]) for k in ("masked_image", "mask"))
    with torch.no_grad():
        a, b = model(x, t, mi, m), model(x, t, mi, m)
        c = model(x, t, mi, m, deterministic=False)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_train_draws_are_a_function_of_their_path():
    d = TrainDraws(3, "cpu")
    assert torch.equal(d.fold(1).fold(0).noise((2, 4)), d.fold(1).fold(0).noise((2, 4)))
    assert not torch.equal(d.fold(1).noise((2, 4)), d.fold(2).noise((2, 4)))
    assert not torch.equal(d.fold(1).noise((2, 4)), d.fold(1).inject((2, 4)))
    assert not torch.equal(d.fold(0).noise((8,)), d.split(2)[0].noise((8,)))
    t = d.timesteps(64, 1000)
    assert t.dtype == torch.int64 and 0 <= t.min() and t.max() < 1000
    assert not torch.equal(TrainDraws(4, "cpu").noise((8,)), d.noise((8,)))


# ------------------------------------------------------------------- LoRA


def test_lora_targets_and_count_match_jax(setup):
    params = setup["variables"]["params"]
    jax_targets = ["/".join(p) for p in jax_select_lora_targets(params)]
    assert select_lora_targets(PCFG) == jax_targets
    assert len(jax_targets) == 8  # qkv and proj of 4 attention blocks
    lora = jax_init_lora(jax.random.PRNGKey(0), params, rank=4)
    model = _port_model(setup["variables"])
    ours = init_lora(0, model, PCFG, rank=4)
    assert lora_param_count(ours) == jax_lora_param_count(lora)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(np.shape(v)) for k, v in flatten_lora(lora).items()}


def test_lora_merge_on_a_jax_tree_carried_across(setup):
    """JAX's adapter (b made non-zero) merged by both packages: the same
    weights; and the port's training path (weight overrides) gives the
    forward of the merged state dict."""
    params = jax.tree_util.tree_map(np.asarray, setup["variables"]["params"])
    lora = jax_init_lora(jax.random.PRNGKey(1), params, rank=4, alpha=8.0)
    rng = np.random.default_rng(3)
    lora = {k: {kk: (np.asarray(vv) + (0.05 * rng.standard_normal(np.shape(vv))
                                        if kk == "b" else 0.0)).astype(np.float32)
                for kk, vv in v.items()} for k, v in lora.items()}
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, jax_merge_lora(params, jax.tree_util.tree_map(jnp.asarray, lora)))}, PCFG)
    base = state_dict_from_jax(setup["variables"], PCFG)
    ours = merge_lora(base, lora, PCFG)
    moved = [k for k in base if not torch.equal(ours[k], base[k])]
    assert len(moved) == 8 and all(k.endswith(("qkv.weight", "proj_out.weight")) for k in moved)
    for k in ref:
        torch.testing.assert_close(ours[k], ref[k], rtol=1e-6, atol=1e-6)
    model = _port_model(setup["variables"])
    merged_model = InpaintingUNet(PCFG)
    merged_model.load_state_dict(ours)
    x = torch.from_numpy(setup["batch"]["image"])
    t = torch.tensor([3, 700])
    mi, m = (torch.from_numpy(setup["batch"][k]) for k in ("masked_image", "mask"))
    with torch.no_grad(), weight_overrides(lora_weights(model, PCFG, flatten_lora(lora))):
        out = model(x, t, mi, m)
    torch.testing.assert_close(out, merged_model(x, t, mi, m).detach(), rtol=1e-5, atol=1e-6)


def test_lora_training_moves_only_the_adapter(setup):
    """b starts at zero (the merged model is the base bit for bit); a LoRA
    step trains the adapter and leaves every base parameter as it was."""
    model = _port_model(setup["variables"]).requires_grad_(False)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    lora = init_lora(2, model, PCFG, rank=4)
    merged0 = merge_lora(base, lora, PCFG)
    assert all(torch.equal(merged0[k], base[k]) for k in base)
    for v in lora.values():
        v.requires_grad_(True)
    before = {k: v.clone() for k, v in lora.items()}
    state = TrainState.create(model, lora, make_optimizer(make_lr_schedule("none", LR, 10)))
    step = make_train_step(setup["psched"], param_transform=lambda p: lora_weights(model, PCFG, p))
    for _ in range(2):
        state, metrics = step(state, setup["batch"], 0)
        assert float(metrics["grad_norm"]) > 0
    assert all(torch.equal(model.state_dict()[k], base[k]) for k in base)
    assert any(not torch.equal(lora[k], before[k]) for k in lora if k.endswith("/b"))
