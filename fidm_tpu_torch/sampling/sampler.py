"""DDIM and DPM-Solver++(2M) inpainting samplers (PyTorch port).

Counterpart of the DDIM and `dpm++2m` / `dpm++2m-sde` branches of
`fidm_tpu/sampling/sampler.py`: the same float64 host coefficient tables,
copied once to the device as float32, then a Python loop over the steps. The
loop reads per-step coefficients as device scalars and decides on the host
which draws a step needs (from the host tables), so it never waits on the
device. `strength` < 1 (refinement) starts from the clean image noised to the
truncated grid's first timestep.

Noise contract. Three draws, as in the JAX sampler: the initial state, one
draw per step index, and the injection noise keyed by the TARGET timestep of
the injection (so the same seed and timestep give the same noise, the
reference's ground-truth noise cache). `GeneratorNoise` makes them from
`torch.Generator`s seeded from the caller's integer seed, or from one seed
per batch row (the serving determinism contract: row i equals the batch-1
run with seed i); tests pass any object with the same three methods.

Feature caching (`encoder_cache_period` > 1): the key steps come from a host
numpy mask over the grid (`_cache_keymask`), so choosing between the full and
the cached model call is a Python `if` that never waits on the device. Key
steps call `full_fn` and keep its cache, the other steps call `cached_fn`
with it (`cache_apply`); with `cache_branch=-1` they reuse the previous raw
model output and run no model.

Trajectories, guidance and the other methods are not ported and raise
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..diffusion import gaussian as gd
from ..diffusion.schedules import DiffusionSchedule, timestep_sequence

__all__ = ["SamplerConfig", "inpaint_sample", "host_alphas_cumprod", "GeneratorNoise",
           "nonuniform_keysteps", "keysteps_from_spec"]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """The JAX package's sampler configuration, field for field; see
    `fidm_tpu.sampling.SamplerConfig` for what each field means."""

    method: str = "ddim"
    num_steps: Optional[int] = 100
    timesteps: Optional[tuple] = None
    time_spacing: str = "uniform"
    eta: float = 0.0
    clip_denoised: bool = True
    injection: bool = True
    injection_point: str = "post"        # "post" (eval-script) | "pre" (library)
    injection_schedule: str = "all"      # "all" | "high" | "low"
    final_blend: bool = True
    mean_type: gd.ModelMeanType = gd.ModelMeanType.EPSILON
    var_type: gd.ModelVarType = gd.ModelVarType.LEARNED_RANGE
    encoder_cache_period: int = 1
    encoder_cache_tail: int = 0
    cache_branch: int = 0
    cache_keysteps: Optional[Tuple[int, ...]] = None
    trajectory_every: int = 0
    strength: float = 1.0
    unipc_order: int = 2
    unipc_corrector: bool = True
    jump_length: int = 10
    jump_n_sample: int = 10
    output_dtype: str = "float32"


def host_alphas_cumprod(sched: DiffusionSchedule) -> np.ndarray:
    """Float64 cumulative alphas for the coefficient tables, from the
    schedule's float64 host betas (the device tables are rounded to f32)."""
    return np.cumprod(1.0 - sched.betas_host, axis=0)


def _injection_gate(ts: np.ndarray, schedule: str, T: int) -> np.ndarray:
    if schedule == "all":
        return np.ones_like(ts, dtype=np.float64)
    half = T // 2
    if schedule == "high":
        return (ts >= half).astype(np.float64)
    if schedule == "low":
        return (ts < half).astype(np.float64)
    raise ValueError(f"unknown injection_schedule: {schedule}")


def _cache_keymask(cfg: SamplerConfig, K: int) -> np.ndarray:
    """Host boolean mask over the K steps: True = run the full model.

    The periodic gate (`step % period == 0`, or one of the last
    `encoder_cache_tail` steps), or `cfg.cache_keysteps` as an explicit grid:
    strictly ascending, in range, and holding step 0, which fills the cache
    before any cached step reads it."""
    if cfg.cache_keysteps is None:
        steps = np.arange(K)
        return (steps % cfg.encoder_cache_period == 0) | (
            steps >= K - cfg.encoder_cache_tail)
    ks = np.asarray(cfg.cache_keysteps, dtype=np.int64)
    if ks.ndim != 1 or ks.size == 0 or (np.diff(ks) <= 0).any():
        raise ValueError(
            "cache_keysteps must be a non-empty strictly ascending tuple, "
            f"got {cfg.cache_keysteps!r}")
    if ks[0] != 0:
        raise ValueError(
            "cache_keysteps must include step 0: the feature cache is "
            "zero-initialized and must be written before it is read")
    if ks[-1] >= K:
        raise ValueError(
            f"cache_keysteps out of range: max index {int(ks[-1])} vs "
            f"{K} steps in this grid")
    mask = np.zeros(K, dtype=bool)
    mask[ks] = True
    return mask


def nonuniform_keysteps(K: int, n_key: int, *, center: float = 0.5,
                        power: float = 1.2) -> Tuple[int, ...]:
    """A non-uniform full-evaluation grid for `SamplerConfig.cache_keysteps`
    (DeepCache's non-uniform 1:N strategy, arXiv:2312.00858 §4.2): n_key
    full evaluations with a power-law density around `center` (a fraction of
    the chain, 0 = high noise, 1 = fine detail); power > 1 concentrates them
    near the center. Step 0 is always included and rounding duplicates are
    dropped, so the grid can be shorter than n_key."""
    if not 1 <= n_key <= K:
        raise ValueError(f"n_key must be in [1, {K}], got {n_key}")
    if not 0.0 <= center <= 1.0:
        raise ValueError(f"center must be in [0, 1], got {center}")
    if power <= 0:
        raise ValueError(f"power must be positive, got {power}")
    u = np.linspace(-1.0, 1.0, n_key)
    c = center * (K - 1)
    radius = max(c, (K - 1) - c)
    idx = np.round(c + np.sign(u) * np.abs(u) ** power * radius)
    idx = np.clip(idx, 0, K - 1).astype(np.int64)
    idx = np.unique(np.concatenate(([0], idx)))
    return tuple(int(i) for i in idx)


def keysteps_from_spec(spec: str, K: int) -> Tuple[int, ...]:
    """A cache schedule from a CLI spec against a K-step chain: an explicit
    comma list of ascending step indices ('0,3,7,12'), or 'N@center:power'
    for an N-evaluation `nonuniform_keysteps` grid (':power' optional,
    default 1.2)."""
    spec = spec.strip()
    if "@" in spec:
        n, _, cp = spec.partition("@")
        c, _, p = cp.partition(":")
        return nonuniform_keysteps(K, int(n), center=float(c),
                                   power=float(p) if p else 1.2)
    return tuple(int(s) for s in spec.split(","))


def _respaced_seq(sched: DiffusionSchedule, cfg: SamplerConfig,
                  acp: np.ndarray) -> np.ndarray:
    """The descending timestep grid (explicit > spaced > full); strength < 1
    keeps only the last round(strength * K) entries."""
    T = sched.num_timesteps
    if cfg.timesteps is not None:
        seq = np.asarray(cfg.timesteps, dtype=np.int64)
        if not (np.diff(seq) < 0).all():
            raise ValueError("timesteps must be descending")
    else:
        K = cfg.num_steps or T
        seq = (np.arange(T)[::-1] if K >= T else
               timestep_sequence(T, K, cfg.time_spacing, alphas_cumprod=acp))
    if not 0.0 < cfg.strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {cfg.strength}")
    if cfg.strength < 1.0:
        k = max(1, int(round(cfg.strength * len(seq))))
        seq = seq[len(seq) - k:]
    return seq


def _ddim_tables(sched: DiffusionSchedule, cfg: SamplerConfig) -> Dict[str, np.ndarray]:
    """Per-step float64 coefficient tables for the respaced DDIM loop."""
    T = sched.num_timesteps
    acp = host_alphas_cumprod(sched)
    seq = _respaced_seq(sched, cfg, acp)

    a_t = acp[seq]
    a_prev = np.append(acp[seq[1:]], 1.0)  # last step's "previous" is x_0
    sigma = cfg.eta * np.sqrt((1 - a_prev) / (1 - a_t)) * np.sqrt(1 - a_t / a_prev)
    # posterior mean coefficients of the respaced chain, used to invert a
    # PREVIOUS_X model's output into pred_x0 (`_x0_eps_from_raw`)
    betas_r = 1.0 - a_t / a_prev
    post_c1 = betas_r * np.sqrt(a_prev) / (1.0 - a_t)
    post_c2 = (1.0 - a_prev) * np.sqrt(1.0 - betas_r) / (1.0 - a_t)
    return {
        "t": seq.astype(np.int32),
        "sqrt_one_minus_a_t": np.sqrt(1 - a_t),
        "sqrt_a_t": np.sqrt(a_t),
        "sqrt_a_prev": np.sqrt(a_prev),
        "dir_coef": np.sqrt(np.maximum(1 - a_prev - sigma**2, 0.0)),
        "sigma": sigma,
        # stochastic noise only when t > 0 and eta > 0
        "noise_gate": (seq > 0).astype(np.float64) * (1.0 if cfg.eta > 0 else 0.0),
        # inject at the *previous* level after the update, skip at the final
        # step. The high/low schedule gates on the CURRENT level even though
        # the post-injection lands at seq[i+1] (reference semantics)
        "inject_gate": (seq > 0).astype(np.float64)
        * _injection_gate(seq, cfg.injection_schedule, T),
        "inject_sqrt_a": np.sqrt(a_prev),
        "inject_sqrt_1ma": np.sqrt(1 - a_prev),
        "inject_t": np.append(seq[1:], 0).astype(np.int32),
        # pre-injection (library mode) uses the *current* level t
        "pre_inject_gate": _injection_gate(seq, cfg.injection_schedule, T),
        "pre_inject_sqrt_a": np.sqrt(a_t),
        "pre_inject_sqrt_1ma": np.sqrt(1 - a_t),
        "xprev_inv_c1": 1.0 / post_c1,
        "xprev_c2c1": post_c2 / post_c1,
        "step": np.arange(len(seq), dtype=np.int32),
    }


def _dpm_tables(sched: DiffusionSchedule, cfg: SamplerConfig) -> Dict[str, np.ndarray]:
    """Per-step float64 tables for DPM-Solver++(2M) and its SDE variant
    (Lu et al. 2022, arXiv:2211.01095), the JAX package's numpy code.

    With lambda = log(alpha/sigma) and h_i = lambda_prev - lambda_cur:
        D_hat_i = (1 + c_i) * D_i - c_i * D_{i-1},   c_i = h_i / (2 h_{i-1})
        x_prev  = (sigma_prev/sigma_cur) * x + alpha_prev*(1 - e^{-h_i}) * D_hat_i
    c_0 = 0 (the first step is first order) and the final step to
    alpha_bar_prev = 1 is first order too, collapsing x to the x0
    prediction. The SDE variant contracts the linear term by e^{-2h} and adds
    fresh noise of matching variance (`sde_noise`, 0 at the final step).
    `eta` is ignored; the injection tables are the DDIM loop's.
    """
    base = _ddim_tables(sched, dataclasses.replace(cfg, eta=0.0))
    a_t = base["sqrt_a_t"].astype(np.float64) ** 2
    a_prev = base["sqrt_a_prev"].astype(np.float64) ** 2
    alpha_t, sigma_t = np.sqrt(a_t), np.sqrt(1.0 - a_t)
    alpha_p, sigma_p = np.sqrt(a_prev), np.sqrt(1.0 - a_prev)
    with np.errstate(divide="ignore"):
        lam_t = 0.5 * (np.log(a_t) - np.log1p(-a_t))
        lam_p = 0.5 * (np.log(a_prev) - np.log1p(-a_prev))  # +inf at a_prev=1
    h = lam_p - lam_t
    h_prev = np.concatenate([[np.inf], h[:-1]])  # i=0: c -> 0 (first-order)
    corr = np.where(np.isfinite(h), h / (2.0 * h_prev), 0.0)
    base["corr"] = corr
    base["coef_x"] = sigma_p / sigma_t
    # alpha_p * (1 - exp(-h)) in a form finite at h = inf
    base["coef_D"] = alpha_p - sigma_p * alpha_t / sigma_t
    if cfg.method == "dpm++2m-sde":
        # x_prev = (sigma_p/sigma_t) e^{-h} x + alpha_p (1-e^{-2h}) D_hat
        #          + sigma_p sqrt(1-e^{-2h}) z, with exp(-h) =
        # (sigma_p alpha_t)/(sigma_t alpha_p), 0 at the final step
        exp_mh = np.where(
            a_prev < 1.0, (sigma_p / sigma_t) * (alpha_t / np.maximum(alpha_p, 1e-30)), 0.0
        )
        base["coef_x"] = (sigma_p / sigma_t) * exp_mh
        base["coef_D"] = alpha_p * (1.0 - exp_mh**2)
        base["sde_noise"] = sigma_p * np.sqrt(1.0 - exp_mh**2)
    for unused in ("dir_coef", "sigma", "noise_gate", "sqrt_a_prev"):
        del base[unused]
    return base


def _to_device_xs(tables: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The tables as int32 / float32 tensors on `device`. To CUDA by pinned,
    non-blocking copies: a blocking copy would wait for every kernel already
    queued (the server's batch in flight)."""
    xs = {}
    for k, v in tables.items():
        t = torch.from_numpy(v.astype(np.int32 if v.dtype.kind == "i" else np.float32))
        xs[k] = (t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                 else t.to(device))
    return xs


def _x0_eps_from_raw(raw, x, s, cfg: SamplerConfig):
    """(pred_x0, eps) from the model's raw 3-channel output per mean_type.

    EPSILON keeps the reference behavior: the DDIM direction term uses the
    raw eps, not an eps re-derived from the clipped x0.
    """
    if cfg.mean_type == gd.ModelMeanType.EPSILON:
        pred_x0 = (x - s["sqrt_one_minus_a_t"] * raw) / s["sqrt_a_t"]
        return pred_x0, raw
    if cfg.mean_type == gd.ModelMeanType.VELOCITY:
        pred_x0 = s["sqrt_a_t"] * x - s["sqrt_one_minus_a_t"] * raw
    elif cfg.mean_type == gd.ModelMeanType.START_X:
        pred_x0 = raw
    elif cfg.mean_type == gd.ModelMeanType.PREVIOUS_X:
        pred_x0 = s["xprev_inv_c1"] * raw - s["xprev_c2c1"] * x
    else:
        raise NotImplementedError(cfg.mean_type)
    eps = (x - s["sqrt_a_t"] * pred_x0) / s["sqrt_one_minus_a_t"]
    return pred_x0, eps


def _maybe_pre_inject(x, s, gt, keep, noise):
    noised = s["pre_inject_sqrt_a"] * gt + s["pre_inject_sqrt_1ma"] * noise
    injected = keep * noised + (1.0 - keep) * x
    return x + s["pre_inject_gate"] * (injected - x)


def _maybe_post_inject(x, s, gt, keep, noise):
    noised = s["inject_sqrt_a"] * gt + s["inject_sqrt_1ma"] * noise
    injected = (1.0 - keep) * x + keep * noised
    return x + s["inject_gate"] * (injected - x)


def _finalize_output(x, cfg: SamplerConfig):
    """Apply cfg.output_dtype. "uint8" is the reference's toU8:
    ((x+1)*127.5).clamp(0,255) then a truncating cast."""
    if cfg.output_dtype == "float32":
        return x
    if cfg.output_dtype == "uint8":
        return torch.clamp((x + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)
    raise ValueError(f"output_dtype must be 'float32' or 'uint8', got {cfg.output_dtype!r}")


def _check_seed(seed) -> int:
    if not isinstance(seed, (int, np.integer)) or isinstance(seed, bool) or seed < 0:
        raise ValueError(f"seed must be a non-negative integer, got {seed!r}")
    return int(seed)


class GeneratorNoise:
    """The sampler's three noise draws from one integer seed, or from one
    seed per batch row.

    Each draw seeds its own `torch.Generator` on `device` from
    (seed, stream, index): stream 0 is the initial state, 1 the per-step
    noise by step index, 2 the injection noise by timestep. The same seed
    and index give the same tensor in any order of calls.

    With a sequence of B seeds, row i of every [B, ...] draw comes from seed
    i alone, into its slice of one tensor, so it is bit-equal to the batch-1
    draw of `GeneratorNoise(seeds[i])` whatever else shares the batch (the
    port's counterpart of the JAX sampler's per-sample keys). A draw whose
    batch is not B raises ValueError.
    """

    def __init__(self, seed: Union[int, Sequence[int]], device):
        if isinstance(seed, (int, np.integer)):
            self.seed, self.seeds = _check_seed(seed), None
        else:
            self.seed, self.seeds = None, tuple(_check_seed(s) for s in seed)
            if not self.seeds:
                raise ValueError("seed sequence must not be empty")
        self.device = torch.device(device)

    def _generator(self, seed: int, stream: int, index: int) -> torch.Generator:
        state = np.random.SeedSequence([seed, stream, int(index)])
        g = torch.Generator(device=self.device)
        g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
        return g

    def _draw(self, stream: int, index: int, shape) -> torch.Tensor:
        shape = tuple(shape)
        if self.seeds is None:
            return torch.randn(shape, generator=self._generator(self.seed, stream, index),
                               device=self.device, dtype=torch.float32)
        if shape[0] != len(self.seeds):
            raise ValueError(
                f"per-row seed batch {len(self.seeds)} != input batch {shape[0]} "
                "(pass one seed per row, or a single seed)")
        out = torch.empty(shape, device=self.device, dtype=torch.float32)
        for row, seed in zip(out, self.seeds):
            torch.randn(shape[1:], generator=self._generator(seed, stream, index),
                        out=row)
        return out

    def init(self, shape) -> torch.Tensor:
        return self._draw(0, 0, shape)

    def step(self, index: int, shape) -> torch.Tensor:
        return self._draw(1, index, shape)

    def inject(self, timestep: int, shape) -> torch.Tensor:
        return self._draw(2, timestep, shape)


_PORTED_METHODS = ("ddim", "dpm++2m", "dpm++2m-sde")


def _check_ported(cfg: SamplerConfig, cond_fn):
    if cond_fn is not None and cfg.method in ("dpm++2m", "dpm++2m-sde"):
        raise ValueError(
            "classifier guidance (cond_fn) is defined for ddim/ddpm/repaint; "
            "the DPM-Solver++ updates have no reference-guided form")
    if cfg.method not in _PORTED_METHODS:
        raise NotImplementedError(f"sampler method {cfg.method!r} is not ported yet")
    if cfg.cache_keysteps is not None and cfg.encoder_cache_period <= 1:
        raise ValueError(
            "cache_keysteps requires encoder_cache_period > 1 (the period "
            "enables caching; the explicit grid then replaces the gate)")
    if cfg.trajectory_every:
        raise NotImplementedError("trajectory_every is not ported yet")
    if cond_fn is not None:
        raise NotImplementedError("classifier guidance (cond_fn) is not ported yet")
    if cfg.injection_point not in ("post", "pre"):
        raise ValueError(f"unknown injection_point: {cfg.injection_point}")


def _initial_state(sched: DiffusionSchedule, cfg: SamplerConfig, first_t: int,
                   gt: torch.Tensor, x_init: Optional[torch.Tensor], noise) -> torch.Tensor:
    """The loop's starting state. With strength < 1 the clean image (x_init,
    else gt) q-sampled to the truncated grid's first timestep (SDEdit);
    otherwise x_init, else a standard normal draw."""
    if cfg.strength < 1.0:
        clean = x_init if x_init is not None else gt
        a0 = float(host_alphas_cumprod(sched)[first_t])
        return (math.sqrt(a0) * clean.to(torch.float32)
                + math.sqrt(1.0 - a0) * noise.init(gt.shape))
    x = x_init if x_init is not None else noise.init(gt.shape)
    return x.to(torch.float32)


def inpaint_sample(
    apply_fn: Callable,
    sched: DiffusionSchedule,
    cfg: SamplerConfig,
    *,
    gt: torch.Tensor,
    mask: torch.Tensor,
    noise,
    x_init: Optional[torch.Tensor] = None,
    cache_apply: Optional[Tuple[Callable, Callable]] = None,
    cond_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Run the DDIM or DPM-Solver++(2M) inpainting reverse process.

    Args:
      apply_fn: (x, t[B], masked_image, mask) -> model output (NHWC, f32).
      gt: ground-truth images [B,H,W,3] in [-1,1], float32, on the device.
      mask: [B,H,W,1], 1 = inpaint (hole), 0 = keep.
      noise: the noise source (`GeneratorNoise` or any object with its
        `init(shape)`, `step(index, shape)` and `inject(timestep, shape)`).
      x_init: optional starting state (default N(0, 1)); with cfg.strength
        < 1 it is instead the CLEAN image to refine (default gt).
      cache_apply: with cfg.encoder_cache_period > 1 and cfg.cache_branch
        != -1, the pair (full_fn, cached_fn): full_fn(x, t, masked_image,
        mask) -> (out, cache) on key steps, cached_fn(x, t, masked_image,
        mask, cache) -> out on the others.

    Returns:
      Inpainted images [B,H,W,3]; with cfg.final_blend the known pixels are
      exactly `gt`.
    """
    _check_ported(cfg, cond_fn)
    B = gt.shape[0]
    keep = (1.0 - mask).to(gt.dtype)
    masked_image = gt * keep
    ddim = cfg.method == "ddim"
    tables = _ddim_tables(sched, cfg) if ddim else _dpm_tables(sched, cfg)
    xs = _to_device_xs(tables, gt.device)
    pre = cfg.injection and cfg.injection_point == "pre"
    post = cfg.injection and cfg.injection_point == "post"

    K = len(tables["t"])
    # key steps by a host mask (after the strength truncation); step 0 is
    # always one, so `out` and `cache` are set before a cached step reads them
    is_key = _cache_keymask(cfg, K) if cfg.encoder_cache_period > 1 else None
    full_fn = cached_fn = cache = None
    if is_key is not None and cfg.cache_branch != -1:
        if cache_apply is None:
            raise ValueError(
                "cfg.encoder_cache_period > 1 requires cache_apply=(full_fn, cached_fn)")
        full_fn, cached_fn = cache_apply

    x = _initial_state(sched, cfg, int(tables["t"][0]), gt, x_init, noise)
    # dpm: the previous x0 prediction, read only where corr > 0 (never at
    # step 0)
    prev_x0 = None if ddim else torch.zeros_like(x)
    for i in range(K):
        s = {k: v[i] for k, v in xs.items()}
        # a step whose host gate is 0 adds exactly nothing; skip its draw
        if pre and tables["pre_inject_gate"][i] > 0:
            x = _maybe_pre_inject(x, s, gt, keep,
                                  noise.inject(int(tables["t"][i]), gt.shape))
        t = s["t"].expand(B)
        if full_fn is None:
            # no feature cache: every step, or (output reuse) the key steps
            # run the model; the others keep the previous raw output
            if is_key is None or is_key[i]:
                out = apply_fn(x, t, masked_image, mask)
        elif is_key[i]:
            out, cache = full_fn(x, t, masked_image, mask)
        else:
            out = cached_fn(x, t, masked_image, mask, cache)
        raw = out[..., :3]  # learned variance is unused by DDIM and DPM-Solver
        pred_x0, eps = _x0_eps_from_raw(raw, x, s, cfg)
        if ddim:
            if cfg.clip_denoised:
                pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
                if cfg.mean_type != gd.ModelMeanType.EPSILON:
                    eps = (x - s["sqrt_a_t"] * pred_x0) / s["sqrt_one_minus_a_t"]
            x = s["sqrt_a_prev"] * pred_x0 + s["dir_coef"] * eps
            if tables["noise_gate"][i] > 0:
                x = x + s["noise_gate"] * s["sigma"] * noise.step(i, x.shape)
        else:
            if cfg.clip_denoised:
                pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
            d_hat = (1.0 + s["corr"]) * pred_x0 - s["corr"] * prev_x0
            x = s["coef_x"] * x + s["coef_D"] * d_hat
            if "sde_noise" in tables and tables["sde_noise"][i] > 0:
                x = x + s["sde_noise"] * noise.step(i, x.shape)
            prev_x0 = pred_x0
        if post and tables["inject_gate"][i] > 0:
            x = _maybe_post_inject(x, s, gt, keep,
                                   noise.inject(int(tables["inject_t"][i]), gt.shape))

    if cfg.final_blend:
        x = x * mask + gt * keep
    return _finalize_output(x, cfg)
