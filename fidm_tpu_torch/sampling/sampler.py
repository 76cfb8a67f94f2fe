"""The inpainting and unconditional samplers (PyTorch port).

Counterpart of `fidm_tpu/sampling/sampler.py`, every method: DDIM, DDPM
(respaced as SpacedDiffusion), DPM-Solver++(2M) and its SDE variant,
DPM-Solver++(3M), UniPC, RePaint's time-travel resampling and multistep
consistency sampling; classifier guidance (`cond_fn`) for ddim, ddpm and
repaint; trajectories (`trajectory_every`); refinement (`strength` < 1,
starting from the clean image noised to the truncated grid's first
timestep); feature caching. The same float64 host coefficient tables as the
JAX sampler are copied once to the device as float32, then a Python loop
runs the steps. Every branch of the loop is decided on the host from the
tables (which draws a step needs, which history a multistep solver reads,
whether a repaint row denoises or renoises, which steps are key steps or
trajectory frames), so the loop never waits on the device.

Noise contract. Three draws, as in the JAX sampler: the initial state, one
draw per step index (per table row: repaint's renoise rows draw too), and
the injection noise keyed by the TARGET timestep of the injection (so the
same seed and timestep give the same noise, the reference's ground-truth
noise cache; a level that repaint revisits gets the same injection noise).
`sample()` takes the first two only. `GeneratorNoise` makes them from
`torch.Generator`s seeded from the caller's integer seed, or from one seed
per batch row (the serving determinism contract: row i equals the batch-1
run with seed i); tests pass any object with the same methods.

Feature caching (`encoder_cache_period` > 1): the key steps come from a host
numpy mask over the grid (`_cache_keymask`). Key steps call `full_fn` and
keep its cache, the other steps call `cached_fn` with it (`cache_apply`);
with `cache_branch=-1` they reuse the previous raw model output and run no
model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..diffusion import gaussian as gd
from ..diffusion.schedules import DiffusionSchedule, timestep_sequence

__all__ = ["SamplerConfig", "inpaint_sample", "sample", "host_alphas_cumprod",
           "repaint_level_sequence", "GeneratorNoise", "nonuniform_keysteps",
           "keysteps_from_spec"]


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


def _dpm3m_tables(sched: DiffusionSchedule, cfg: SamplerConfig) -> Dict[str, np.ndarray]:
    """Per-step float64 tables for DPM-Solver++(3M), third-order multistep in
    data-prediction form (arXiv:2211.01095; diffusers'
    `multistep_dpm_solver_third_order_update`), the JAX package's numpy code.

    With h the current log-SNR step, h0/h1 the two before it, r0 = h0/h,
    r1 = h1/h and m0/m1/m2 the last three x0 predictions:
        D1_0 = (m0 - m1)/r0,  D1_1 = (m1 - m2)/r1
        D1   = D1_0 + r0/(r0+r1) * (D1_0 - D1_1),  D2 = (D1_0 - D1_1)/(r0 + r1)
        x <- (sigma_p/sigma_t) x + alpha_p(1 - e^{-h}) m0
             + alpha_p((e^{-h}-1)/h + 1) D1 - alpha_p((e^{-h}-1+h)/h^2 - 1/2) D2
    Step 0 is first order, step 1 the 2M update (c2 = phi1/2, D1 = D1_0), the
    final step to alpha_bar = 1 first order (x = m0), and with fewer than 15
    steps the second-to-last step drops to 2M too (diffusers'
    lower_order_second). `eta` is ignored; the injection tables are DDIM's.
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
    h0 = np.concatenate([[np.inf], h[:-1]])
    h1 = np.concatenate([[np.inf], h0[:-1]])
    step_i = np.arange(len(h))
    finite = np.isfinite(h)
    ord3 = finite & (step_i >= 2) & np.isfinite(h0) & np.isfinite(h1)
    if len(h) < 15:
        ord3 &= step_i != len(h) - 2
    ord2 = finite & (step_i >= 1) & np.isfinite(h0) & ~ord3
    h_safe = np.where(finite, h, 1.0)
    exp_mh = np.where(finite, np.exp(-h_safe), 0.0)
    phi1 = alpha_p - sigma_p * alpha_t / sigma_t  # alpha_p(1-e^{-h}), finite
    base["coef_x"] = sigma_p / sigma_t
    base["phi1"] = phi1
    base["c2"] = np.where(
        ord3, alpha_p * ((exp_mh - 1.0) / h_safe + 1.0),
        np.where(ord2, 0.5 * phi1, 0.0),
    )
    base["c3"] = np.where(
        ord3, alpha_p * ((exp_mh - 1.0 + h_safe) / h_safe**2 - 0.5), 0.0
    )
    with np.errstate(invalid="ignore"):
        base["inv_r0"] = np.where(ord2 | ord3, h_safe / h0, 0.0)  # 1/r0
        base["inv_r1"] = np.where(ord3, h_safe / h1, 0.0)         # 1/r1
        base["w"] = np.where(ord3, h0 / (h0 + h1), 0.0)     # r0/(r0+r1)
        base["inv_r01"] = np.where(ord3, h_safe / (h0 + h1), 0.0)
    for unused in ("dir_coef", "sigma", "noise_gate", "sqrt_a_prev"):
        del base[unused]
    return base


def _unipc_b_coeffs(h: float, order: int) -> np.ndarray:
    """UniPC's right-hand side b_k = h*phi_{k+1}(-h) * k! / B(h), k=1..order
    (arXiv:2302.04867 eq. 14-16, data-prediction form, B(h) = e^{-h} - 1, the
    "bh2" variant), by the expm1 recurrence phi_{k+1}(z) = (phi_k(z) - 1/k!)/z."""
    hh = -h
    h_phi_1 = np.expm1(hh)
    B_h = h_phi_1  # bh2
    b = np.empty(order)
    h_phi_k = h_phi_1 / hh - 1.0
    fact = 1.0
    for i in range(1, order + 1):
        b[i - 1] = h_phi_k * fact / B_h
        fact *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / fact
    return b


def _unipc_rhos(rks: np.ndarray, h: float, order: int,
                corrector: bool) -> np.ndarray:
    """Solve UniPC's Vandermonde system R rho = b in float64. rks: the
    order-1 normalised previous-point offsets and a trailing 1.0 for the new
    point; the predictor solves the top-left (order-1)^2 block, the
    corrector the whole system (the low orders as diffusers' scheduler)."""
    R = np.vstack([rks ** k for k in range(order)])
    b = _unipc_b_coeffs(h, order)
    if corrector:
        if order == 1:
            return np.array([0.5])
        return np.linalg.solve(R, b)
    if order == 2:
        return np.array([0.5])
    return np.linalg.solve(R[:-1, :-1], b[:-1])


def _unipc_tables(sched: DiffusionSchedule, cfg: SamplerConfig) -> Dict[str, np.ndarray]:
    """Per-step float64 tables for UniPC (arXiv:2302.04867), data-prediction
    form, the JAX package's numpy code.

    Step i makes one model evaluation at (x_i, t_i), its x0 prediction
    m_new, then
      x_corr = c_coef_x*last_x + c_coef_m0*hist0
               + sum_j c_c[j]*(hist_j - hist0) + c_new*(m_new - hist0)
      x_next = p_coef_x*x_corr + p_coef_m0*m_new + sum_j p_c[j]*(hist_j - m_new)
    (the corrector UniC from step 1 on, `c_on`; the predictor UniP). The
    predictor's order is min(unipc_order, i+1, K-i); the corrector at step i
    takes the order of the predictor that made x_i.
    """
    order = int(cfg.unipc_order)
    if not 1 <= order <= 3:
        raise ValueError(f"unipc_order must be 1, 2, or 3, got {order}")
    base = _ddim_tables(sched, dataclasses.replace(cfg, eta=0.0))
    a_t = base["sqrt_a_t"].astype(np.float64) ** 2
    a_prev = base["sqrt_a_prev"].astype(np.float64) ** 2
    alpha_t, sigma_t = np.sqrt(a_t), np.sqrt(1.0 - a_t)
    alpha_p, sigma_p = np.sqrt(a_prev), np.sqrt(1.0 - a_prev)
    with np.errstate(divide="ignore"):
        lam = 0.5 * (np.log(a_t) - np.log1p(-a_t))
        lam_p = 0.5 * (np.log(a_prev) - np.log1p(-a_prev))  # +inf at a_prev=1
    K = len(lam)
    D = max(order - 1, 1)  # history depth consumed by the predictor
    p_c = np.zeros((K, D))
    c_c = np.zeros((K, D))
    c_new = np.zeros(K)
    c_on = np.zeros(K)
    c_coef_x = np.zeros(K)
    c_coef_m0 = np.zeros(K)
    p_order = np.zeros(K, dtype=np.int64)
    for i in range(K):
        p_order[i] = min(order, i + 1, K - i)
    # predictor coefficients, step i -> i+1 (h may be inf on the last step)
    h = lam_p - lam
    finite = np.isfinite(h)
    h_safe = np.where(finite, h, 1.0)
    exp_mh = np.where(finite, np.exp(-h_safe), 0.0)
    p_coef_x = np.where(finite, sigma_p / sigma_t, 0.0)
    p_coef_m0 = alpha_p * (1.0 - exp_mh)
    B_h = exp_mh - 1.0  # bh2: B(hh) = expm1(hh), hh = -h
    for i in range(K):
        p = int(p_order[i])
        if p < 2 or not finite[i]:
            continue
        rks = np.array([(lam[i - j] - lam[i]) / h[i] for j in range(1, p)]
                       + [1.0])
        rhos = _unipc_rhos(rks, h[i], p, corrector=False)
        for j in range(p - 1):
            p_c[i, j] = -alpha_p[i] * B_h[i] * rhos[j] / rks[j]
    # corrector at step i rebuilds the sample at t_i over [t_{i-1}, t_i]
    if cfg.unipc_corrector:
        for i in range(1, K):
            co = int(p_order[i - 1])  # order of the predictor that made x_i
            h_c = lam[i] - lam[i - 1]
            rks = np.array(
                [(lam[i - 1 - j] - lam[i - 1]) / h_c for j in range(1, co)]
                + [1.0])
            rhos = _unipc_rhos(rks, h_c, co, corrector=True)
            c_on[i] = 1.0
            c_coef_x[i] = sigma_t[i] / sigma_t[i - 1]
            c_coef_m0[i] = alpha_t[i] * -np.expm1(-h_c)
            B_hc = np.expm1(-h_c)
            for j in range(co - 1):
                c_c[i, j] = -alpha_t[i] * B_hc * rhos[j] / rks[j]
            c_new[i] = -alpha_t[i] * B_hc * rhos[co - 1]
    base["p_coef_x"] = p_coef_x
    base["p_coef_m0"] = p_coef_m0
    base["c_coef_x"] = c_coef_x
    base["c_coef_m0"] = c_coef_m0
    base["c_new"] = c_new
    base["c_on"] = c_on
    for j in range(D):
        base[f"p_c{j}"] = p_c[:, j]
        base[f"c_c{j}"] = c_c[:, j]
    for unused in ("dir_coef", "sigma", "noise_gate", "sqrt_a_prev"):
        del base[unused]
    return base


def _ddpm_tables(sched: DiffusionSchedule, cfg: SamplerConfig) -> Dict[str, np.ndarray]:
    """Per-step float64 tables for the ancestral loop, respaced when
    num_steps < T (SpacedDiffusion: the retained steps define a chain with
    beta'_k = 1 - acp[t_k]/acp[t_{k-1}], whose posterior is recomputed).
    Post-injection lands on the previous retained level."""
    T = sched.num_timesteps
    acp = host_alphas_cumprod(sched)
    seq = _respaced_seq(sched, cfg, acp)

    a_cur = acp[seq]
    a_prev = np.append(acp[seq[1:]], 1.0)  # previous retained level
    betas_r = 1.0 - a_cur / a_prev
    post_var = betas_r * (1.0 - a_prev) / (1.0 - a_cur)
    # the log-variance clipped as the reference clips it: the step that
    # lands at x0 takes the next step's value in place of log(0)
    post_var_for_log = post_var.copy()
    if len(post_var_for_log) > 1:
        post_var_for_log[-1] = post_var_for_log[-2]
    post_logvar = np.log(np.maximum(post_var_for_log, 1e-20))
    a_inj = a_prev
    return {
        "post_coef1": betas_r * np.sqrt(a_prev) / (1.0 - a_cur),
        "post_coef2": (1.0 - a_prev) * np.sqrt(1.0 - betas_r) / (1.0 - a_cur),
        "post_logvar": post_logvar,
        "log_beta": np.log(np.maximum(betas_r, 1e-20)),
        "sqrt_a_t": np.sqrt(a_cur),
        "sqrt_one_minus_a_t": np.sqrt(1.0 - a_cur),
        "t": seq.astype(np.int32),
        # no noise on the transition that lands at x0 (a_prev == 1), keyed
        # to the target level: under "trailing" spacing the last retained
        # step has t > 0 and is still the terminal transition
        "noise_gate": (a_prev < 1.0).astype(np.float64),
        "inject_gate": (seq > 0).astype(np.float64)
        * _injection_gate(seq, cfg.injection_schedule, T),
        "inject_sqrt_a": np.sqrt(a_inj),
        "inject_sqrt_1ma": np.sqrt(1 - a_inj),
        "inject_t": np.append(seq[1:], 0).astype(np.int32),
        "pre_inject_gate": _injection_gate(seq, cfg.injection_schedule, T),
        "pre_inject_sqrt_a": np.sqrt(acp[seq]),
        "pre_inject_sqrt_1ma": np.sqrt(1 - acp[seq]),
        "step": np.arange(len(seq), dtype=np.int32),
    }


def repaint_level_sequence(K: int, jump_length: int,
                           jump_n_sample: int) -> np.ndarray:
    """RePaint's time-travel visit order over K retained levels (0 the
    noisiest, K-1 the least noisy; arXiv:2201.09865 §4.2): denoising moves
    +1; at every `jump_length`-th level the walk goes back `jump_length`
    levels one at a time and denoises again, `jump_n_sample - 1` extra
    times per jump site. `jump_n_sample <= 1` or `jump_length <= 0` gives
    `arange(K)` (plain respaced DDPM)."""
    if jump_length <= 0 or jump_n_sample <= 1 or K <= 1:
        return np.arange(K)
    jumps = {k: jump_n_sample - 1 for k in range(jump_length, K, jump_length)}
    levels = [0]
    k = 0
    while k < K - 1:
        k += 1
        levels.append(k)
        if jumps.get(k, 0) > 0:
            jumps[k] -= 1
            for _ in range(jump_length):
                k -= 1
                levels.append(k)
    return np.asarray(levels, dtype=np.int64)


def _repaint_tables(sched: DiffusionSchedule, cfg: SamplerConfig) -> Dict[str, np.ndarray]:
    """Per-transition tables for RePaint: each row is a denoise step (row L
    of `_ddpm_tables`, the L -> L+1 ancestral step, reused verbatim) or a
    renoise step (one forward q step back to the noisier level:
    x <- sqrt(acp_tgt/acp_cur) x + sqrt(1 - acp_tgt/acp_cur) z), after which
    post-injection pins the known region at the target level. With
    jump_n_sample <= 1 the tables are `_ddpm_tables`'."""
    T = sched.num_timesteps
    acp = host_alphas_cumprod(sched)
    seq = _respaced_seq(sched, cfg, acp)
    K = len(seq)
    base = _ddpm_tables(sched, cfg)
    levels = repaint_level_sequence(K, cfg.jump_length, cfg.jump_n_sample)
    # transitions between consecutive visited levels, plus the final denoise
    # from level K-1 to x0 (pseudo-level K)
    cur = np.append(levels[:-1], K - 1)
    nxt = np.append(levels[1:], K)
    down = nxt == cur + 1
    up = ~down
    if not (nxt[up] == cur[up] - 1).all():
        raise AssertionError("walk must move one level at a time")
    N = len(cur)

    rows = {}
    for k in ("t", "pre_inject_gate", "pre_inject_sqrt_a", "pre_inject_sqrt_1ma"):
        rows[k] = np.asarray(base[k])[cur]
    # denoise-only fields, zero on renoise rows
    for k in ("post_coef1", "post_coef2", "post_logvar", "log_beta",
              "sqrt_a_t", "sqrt_one_minus_a_t", "noise_gate",
              "inject_gate", "inject_sqrt_a", "inject_sqrt_1ma", "inject_t"):
        v = np.asarray(base[k])
        out = np.zeros(N, dtype=v.dtype)
        out[down] = v[cur[down]]
        rows[k] = out
    a_cur = acp[seq[cur[up]]]
    a_tgt = acp[seq[nxt[up]]]
    ratio = a_tgt / a_cur
    keep_ = np.zeros(N)
    std_ = np.zeros(N)
    keep_[up] = np.sqrt(ratio)
    std_[up] = np.sqrt(1.0 - ratio)
    rows["renoise_keep"] = keep_
    rows["renoise_std"] = std_
    # post-injection after a renoise pins the known region at the target
    # level (always t > 0 there)
    t_tgt = seq[nxt[up]]
    rows["inject_gate"][up] = _injection_gate(t_tgt, cfg.injection_schedule, T)
    rows["inject_sqrt_a"][up] = np.sqrt(a_tgt)
    rows["inject_sqrt_1ma"][up] = np.sqrt(1.0 - a_tgt)
    rows["inject_t"][up] = t_tgt
    rows["is_denoise"] = down.astype(np.int32)
    rows["step"] = np.arange(N, dtype=np.int32)
    return rows


def _consistency_seq(sched: DiffusionSchedule, cfg: SamplerConfig) -> tuple:
    """The K-evaluation grid of method="consistency": the first K of the K+1
    consistency-grid boundaries (the last, 0, is only a renoise target), with
    rounding duplicates dropped; an explicit cfg.timesteps wins."""
    if cfg.timesteps is not None:
        return cfg.timesteps
    from ..distill.consistency import consistency_grid

    K = cfg.num_steps or sched.num_timesteps
    seq = consistency_grid(sched.num_timesteps, K)[:K]
    seq = seq[np.concatenate(([True], np.diff(seq) < 0))]
    return tuple(int(t) for t in seq)


def _consistency_tables(sched: DiffusionSchedule, cfg: SamplerConfig) -> Dict[str, np.ndarray]:
    """Multistep consistency sampling runs on the DDIM tables of its own grid
    (`_consistency_seq`): sqrt_a_prev scales the x0 prediction and
    inject_sqrt_1ma, 0 on the last step, is the renoise std."""
    return _ddim_tables(sched, dataclasses.replace(
        cfg, eta=0.0, timesteps=_consistency_seq(sched, cfg)))


_METHOD_TABLES = {"ddim": _ddim_tables, "ddpm": _ddpm_tables, "dpm++2m": _dpm_tables,
                  "dpm++2m-sde": _dpm_tables, "dpm++3m": _dpm3m_tables,
                  "unipc": _unipc_tables, "repaint": _repaint_tables,
                  "consistency": _consistency_tables}


def _method_tables(sched: DiffusionSchedule, cfg: SamplerConfig) -> Dict[str, np.ndarray]:
    """The host tables cfg.method runs on, one row per loop step (repaint:
    the rows with `is_denoise` evaluate the model, the others renoise)."""
    if cfg.method not in _METHOD_TABLES:
        raise ValueError(f"unknown method: {cfg.method}")
    return _METHOD_TABLES[cfg.method](sched, cfg)


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


def _x0_from_raw(raw, x, s, cfg: SamplerConfig):
    """The x0 prediction from the model's raw 3-channel output per mean_type."""
    if cfg.mean_type == gd.ModelMeanType.EPSILON:
        return (x - s["sqrt_one_minus_a_t"] * raw) / s["sqrt_a_t"]
    if cfg.mean_type == gd.ModelMeanType.VELOCITY:
        return s["sqrt_a_t"] * x - s["sqrt_one_minus_a_t"] * raw
    if cfg.mean_type == gd.ModelMeanType.START_X:
        return raw
    if cfg.mean_type == gd.ModelMeanType.PREVIOUS_X:
        return s["xprev_inv_c1"] * raw - s["xprev_c2c1"] * x
    raise NotImplementedError(cfg.mean_type)


def _x0_eps_from_raw(raw, x, s, cfg: SamplerConfig):
    """(pred_x0, eps) from the model's raw 3-channel output per mean_type.

    EPSILON keeps the reference behavior: the DDIM direction term uses the
    raw eps, not an eps re-derived from the clipped x0.
    """
    pred_x0 = _x0_from_raw(raw, x, s, cfg)
    if cfg.mean_type == gd.ModelMeanType.EPSILON:
        return pred_x0, raw
    return pred_x0, (x - s["sqrt_a_t"] * pred_x0) / s["sqrt_one_minus_a_t"]


def _clipped_x0(raw, x, s, cfg: SamplerConfig):
    pred_x0 = _x0_from_raw(raw, x, s, cfg)
    return torch.clamp(pred_x0, -1.0, 1.0) if cfg.clip_denoised else pred_x0


def _ddpm_mean_logvar(out, x, s, cfg: SamplerConfig):
    """Posterior mean and log-variance of one ancestral step from the model
    output, on the (possibly respaced) per-step tables: the in-loop
    `p_mean_variance`."""
    raw, var_values = gd.split_model_output(out, cfg.var_type)
    if cfg.mean_type == gd.ModelMeanType.PREVIOUS_X:
        return raw, _ddpm_logvar(var_values, x, s, cfg)  # the model predicts x_{t-1}
    mean = s["post_coef1"] * _clipped_x0(raw, x, s, cfg) + s["post_coef2"] * x
    return mean, _ddpm_logvar(var_values, x, s, cfg)


def _ddpm_logvar(var_values, x, s, cfg: SamplerConfig):
    if cfg.var_type == gd.ModelVarType.LEARNED_RANGE:
        frac = (var_values + 1.0) / 2.0
        return frac * s["log_beta"] + (1.0 - frac) * s["post_logvar"]
    if cfg.var_type == gd.ModelVarType.LEARNED:
        return var_values
    if cfg.var_type == gd.ModelVarType.FIXED_LARGE:
        # beta_t (the reference's t=0 entry differs, under a zero noise gate)
        return s["log_beta"].expand(x.shape)
    return s["post_logvar"].expand(x.shape)  # FIXED_SMALL


def _cond_grad(cond_fn, x, s):
    """cond_fn(x, t[B]) -> grad log p(y | x_t), called with autograd on: on a
    leaf copy of x that requires grad, so a cond_fn may differentiate a
    classifier with `torch.autograd.grad`. Not under `torch.inference_mode()`,
    whose tensors cannot be saved for backward."""
    with torch.enable_grad():
        grad = cond_fn(x.detach().requires_grad_(True), s["t"].expand(x.shape[0]))
    return grad.detach()


def _guide_eps(cond_fn, x, s, pred_x0):
    """`condition_score` in the loop: eps from the (clipped) x0 prediction,
    shifted by -sqrt(1 - alpha_bar) * grad, and x0 re-derived (no re-clip)."""
    grad = _cond_grad(cond_fn, x, s)
    eps = (x - s["sqrt_a_t"] * pred_x0) / s["sqrt_one_minus_a_t"]
    eps = eps - s["sqrt_one_minus_a_t"] * grad
    pred_x0 = (x - s["sqrt_one_minus_a_t"] * eps) / s["sqrt_a_t"]
    return pred_x0, eps


def _guide_mean(cond_fn, x, s, mean, logvar):
    """`condition_mean` in the loop: the posterior mean shifted by
    variance * grad."""
    return mean + torch.exp(logvar) * _cond_grad(cond_fn, x, s)


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

    def fill(self, stream: int, index: int, out: torch.Tensor) -> torch.Tensor:
        """Write the (stream, index) draw into `out`, a float32 tensor on the
        source's device of the draw's shape, and return it: the same values as
        the draw itself (a sampling program fills its static buffers so)."""
        if self.seeds is None:
            return torch.randn(out.shape, generator=self._generator(self.seed, stream, index),
                               out=out)
        if out.shape[0] != len(self.seeds):
            raise ValueError(
                f"per-row seed batch {len(self.seeds)} != input batch {out.shape[0]} "
                "(pass one seed per row, or a single seed)")
        for row, seed in zip(out, self.seeds):
            torch.randn(out.shape[1:], generator=self._generator(seed, stream, index),
                        out=row)
        return out

    def _draw(self, stream: int, index: int, shape) -> torch.Tensor:
        return self.fill(stream, index, torch.empty(tuple(shape), device=self.device,
                                                    dtype=torch.float32))

    def init(self, shape) -> torch.Tensor:
        return self._draw(0, 0, shape)

    def step(self, index: int, shape) -> torch.Tensor:
        return self._draw(1, index, shape)

    def inject(self, timestep: int, shape) -> torch.Tensor:
        return self._draw(2, timestep, shape)


_UNGUIDED = ("dpm++2m", "dpm++2m-sde", "dpm++3m", "unipc", "consistency")


def _check_config(cfg: SamplerConfig, cond_fn):
    if cond_fn is not None and cfg.method in _UNGUIDED:
        raise ValueError(
            "classifier guidance (cond_fn) is defined for ddim/ddpm/repaint; "
            "the DPM-Solver++/UniPC/consistency updates have no "
            "reference-guided form")
    if cfg.cache_keysteps is not None and cfg.encoder_cache_period <= 1:
        raise ValueError(
            "cache_keysteps requires encoder_cache_period > 1 (the period "
            "enables caching; the explicit grid then replaces the gate)")
    if cfg.injection_point not in ("post", "pre"):
        raise ValueError(f"unknown injection_point: {cfg.injection_point}")
    if cfg.method == "repaint" and cfg.encoder_cache_period > 1:
        raise ValueError("encoder_cache_period is not supported with method='repaint'")


def _initial_state(sched: DiffusionSchedule, cfg: SamplerConfig, first_t: int, shape,
                   clean: Optional[torch.Tensor], x_init: Optional[torch.Tensor],
                   noise) -> torch.Tensor:
    """The loop's starting state. With strength < 1 the clean image q-sampled
    to `first_t`, the truncated grid's first timestep (SDEdit), defined for
    the methods whose grids truncate; otherwise x_init, else a standard
    normal draw."""
    if cfg.strength < 1.0:
        if cfg.method in ("repaint", "consistency"):
            raise ValueError(
                f"strength < 1 is defined for ddim/ddpm/dpm methods, not "
                f"{cfg.method!r}")
        a0 = float(host_alphas_cumprod(sched)[first_t])
        return (math.sqrt(a0) * clean.to(torch.float32)
                + math.sqrt(1.0 - a0) * noise.init(shape))
    x = x_init if x_init is not None else noise.init(shape)
    return x.to(torch.float32)


def _traj_recorder(cfg: SamplerConfig, K: int, x: torch.Tensor):
    """(frames, record) for cfg.trajectory_every = k > 0: one preallocated
    float32 [N, *x.shape] buffer, N = (K-1)//k + 1, and `record(frames, x,
    i)`, which copies x into slot i // k after steps k-1, 2k-1, ... and the
    last (a host decision). With trajectory off, (None, a no-op)."""
    k = cfg.trajectory_every
    if k <= 0:
        return None, lambda frames, x, i: None
    if K <= 0:
        raise ValueError("trajectory_every > 0 needs at least one step")
    frames = torch.zeros(((K - 1) // k + 1,) + tuple(x.shape), dtype=torch.float32,
                         device=x.device)

    def record(frames, x, i):
        if (i + 1) % k == 0 or i == K - 1:
            frames[i // k].copy_(x)

    return frames, record


def _draw_step(noise, tables, gate: str, i: int, x):
    """noise.step(i) for step i, or None where the host gate `gate` is 0 and
    the draw would be multiplied by 0."""
    return noise.step(i, x.shape) if tables[gate][i] > 0 else None


def _shared_update(cfg: SamplerConfig, tables, noise, cond_fn, extract_raw):
    """(aux0, update) for the methods whose step is the same in
    `inpaint_sample` and `sample`: all but DDIM, whose eps differs between
    the two (each entry point keeps its own). `tables` are the method's host
    tables; `extract_raw(out)` is the one caller-specific part.
    `update(x, aux, s, out, i)` -> (x, aux); the repaint update gets
    out=None on its renoise rows, which run no model."""
    if cfg.method in ("ddpm", "repaint"):
        def update(x, aux, s, out, i):
            if out is None:  # a repaint renoise row
                return s["renoise_keep"] * x + s["renoise_std"] * noise.step(i, x.shape), aux
            mean, logvar = _ddpm_mean_logvar(out, x, s, cfg)
            if cond_fn is not None:
                mean = _guide_mean(cond_fn, x, s, mean, logvar)
            z = _draw_step(noise, tables, "noise_gate", i, x)
            if z is None:
                return mean, aux
            return mean + s["noise_gate"] * torch.exp(0.5 * logvar) * z, aux

        return None, update

    if cfg.method in ("dpm++2m", "dpm++2m-sde"):
        sde = cfg.method == "dpm++2m-sde"

        def update(x, prev_x0, s, out, i):
            pred_x0 = _clipped_x0(extract_raw(out), x, s, cfg)
            # the previous x0 prediction is read only where corr != 0 (never
            # at step 0)
            d_hat = (pred_x0 if tables["corr"][i] == 0 else
                     (1.0 + s["corr"]) * pred_x0 - s["corr"] * prev_x0)
            x = s["coef_x"] * x + s["coef_D"] * d_hat
            if sde and tables["sde_noise"][i] > 0:
                x = x + s["sde_noise"] * noise.step(i, x.shape)
            return x, pred_x0

        return None, update

    if cfg.method == "dpm++3m":
        def update(x, aux, s, out, i):
            m1, m2 = aux
            pred_x0 = _clipped_x0(extract_raw(out), x, s, cfg)
            x_new = s["coef_x"] * x + s["phi1"] * pred_x0
            # the host tables say which history the step reads: none at
            # first order, m1 at second, m1 and m2 at third
            if tables["inv_r1"][i] != 0:
                d1_0 = s["inv_r0"] * (pred_x0 - m1)
                d1_1 = s["inv_r1"] * (m1 - m2)
                d1 = d1_0 + s["w"] * (d1_0 - d1_1)
                d2 = s["inv_r01"] * (d1_0 - d1_1)
                x_new = x_new + s["c2"] * d1 - s["c3"] * d2
            elif tables["inv_r0"][i] != 0:
                x_new = x_new + s["c2"] * (s["inv_r0"] * (pred_x0 - m1))
            return x_new, (pred_x0, m1)

        return (None, None), update

    if cfg.method == "unipc":
        depth = max(int(cfg.unipc_order), 1)   # history entries carried
        width = max(int(cfg.unipc_order) - 1, 1)  # coefficient slots

        def update(x, aux, s, out, i):
            last_x, hist = aux
            m_new = _clipped_x0(extract_raw(out), x, s, cfg)
            # UniC: rebuild this level's sample from last_x with the
            # evaluation just made (off at step 0). A history entry is read
            # only where its host coefficient is nonzero, so the entries not
            # yet filled (None) are never read
            if tables["c_on"][i] > 0:
                x_c = (s["c_coef_x"] * last_x + s["c_coef_m0"] * hist[0]
                       + s["c_new"] * (m_new - hist[0]))
                for j in range(min(width, depth - 1)):
                    if tables[f"c_c{j}"][i] != 0:
                        x_c = x_c + s[f"c_c{j}"] * (hist[j + 1] - hist[0])
                x = x + s["c_on"] * (x_c - x)
            # UniP: step the corrected sample to the next level
            x_next = s["p_coef_x"] * x + s["p_coef_m0"] * m_new
            for j in range(width):
                if tables[f"p_c{j}"][i] != 0:
                    x_next = x_next + s[f"p_c{j}"] * (hist[j] - m_new)
            return x_next, (x, (m_new,) + hist[:-1])

        # (the sample each predictor steps from, x0 predictions newest first)
        return (None, (None,) * depth), update

    if cfg.method == "consistency":
        # multistep consistency sampling (Song et al. 2023, Alg. 1, VP form):
        # each step maps to x0 under the student's mean type, then renoises
        # to the next level of its grid, never uniform respacing
        def update(x, aux, s, out, i):
            x_new = s["sqrt_a_prev"] * _clipped_x0(extract_raw(out), x, s, cfg)
            z = _draw_step(noise, tables, "inject_sqrt_1ma", i, x)
            return (x_new if z is None else x_new + s["inject_sqrt_1ma"] * z), aux

        return None, update

    raise ValueError(f"unknown method: {cfg.method}")


def _model_caller(cfg: SamplerConfig, K: int, apply_fn: Callable,
                  cache_apply: Optional[Tuple[Callable, Callable]]):
    """call(x, t, i) -> the model output at step i. With feature caching the
    key steps come from a host mask (`_cache_keymask`), so choosing between
    the full and the cached call never waits on the device: key steps call
    `full_fn` and keep its cache, the others `cached_fn` with it; with
    `cache_branch=-1` they reuse the previous raw output and run no model.
    Step 0 is always a key step."""
    if cfg.encoder_cache_period <= 1:
        return lambda x, t, i: apply_fn(x, t)
    is_key = _cache_keymask(cfg, K)
    held = {}
    if cfg.cache_branch == -1:
        def call(x, t, i):
            if is_key[i]:
                held["out"] = apply_fn(x, t)
            return held["out"]
        return call
    if cache_apply is None:
        raise ValueError(
            "cfg.encoder_cache_period > 1 requires cache_apply=(full_fn, cached_fn)")
    full_fn, cached_fn = cache_apply

    def call(x, t, i):
        if is_key[i]:
            out, held["cache"] = full_fn(x, t)
            return out
        return cached_fn(x, t, held["cache"])

    return call


def _run(cfg, tables, x, aux, update, call, before=None, after=None, xs=None):
    """The loop: per step, `before` (pre-injection), the model call (skipped
    on repaint's renoise rows), the method's update, `after`
    (post-injection), the trajectory frame. Every branch is a host decision;
    the loop never reads a device value back. `xs` are the tables on the
    device, uploaded here when None. Returns (x, frames or None)."""
    if xs is None:
        xs = _to_device_xs(tables, x.device)
    K = len(tables["t"])
    runs_model = tables.get("is_denoise", np.ones(K, np.int32))
    frames, record = _traj_recorder(cfg, K, x)
    B = x.shape[0]
    for i in range(K):
        s = {k: v[i] for k, v in xs.items()}
        if before is not None:
            x = before(x, s, i)
        out = call(x, s["t"].expand(B), i) if runs_model[i] else None
        x, aux = update(x, aux, s, out, i)
        if after is not None:
            x = after(x, s, i)
        record(frames, x, i)
    return x, frames


def _result(x, frames, cfg: SamplerConfig):
    x = _finalize_output(x, cfg)
    return (x, frames) if cfg.trajectory_every > 0 else x


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
    device_tables: Optional[Dict[str, torch.Tensor]] = None,
):
    """Run the inpainting reverse process.

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
      cond_fn: optional classifier guidance, (x, t[B]) -> grad log p(y|x_t),
        for methods ddim, ddpm and repaint: DDPM shifts the posterior mean by
        variance * grad (`condition_mean`), DDIM shifts eps by
        -sqrt(1 - alpha_bar) * grad and re-derives x0 (`condition_score`).
        It is called with autograd enabled on a copy of x that requires
        grad; run the sampler under `torch.no_grad()`, not
        `torch.inference_mode()`, when it takes a gradient.
      device_tables: the method's host tables already on gt's device,
        `_to_device_xs(_method_tables(sched, cfg), device)`, for a caller
        that uploads them once (a sampling program, whose graph must not
        copy from host memory); uploaded per call when None.

    Returns:
      Inpainted images [B,H,W,3]; with cfg.final_blend the known pixels are
      exactly `gt`. With cfg.trajectory_every = k > 0, `(images,
      trajectory)`: trajectory is [N,B,H,W,3] float32, the state after steps
      k-1, 2k-1, ... and the last, before the final blend.
    """
    _check_config(cfg, cond_fn)
    keep = (1.0 - mask).to(gt.dtype)
    masked_image = gt * keep
    tables = _method_tables(sched, cfg)
    x = _initial_state(sched, cfg, int(tables["t"][0]), gt.shape,
                       x_init if x_init is not None else gt, x_init, noise)
    if cfg.method == "ddim":
        aux0 = None

        def update(x, aux, s, out, i):
            # learned variance is unused by DDIM; the raw eps drives the
            # direction term (eval-script semantics)
            pred_x0, eps = _x0_eps_from_raw(out[..., :3], x, s, cfg)
            if cfg.clip_denoised:
                pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
                if cfg.mean_type != gd.ModelMeanType.EPSILON:
                    eps = (x - s["sqrt_a_t"] * pred_x0) / s["sqrt_one_minus_a_t"]
            if cond_fn is not None:
                pred_x0, eps = _guide_eps(cond_fn, x, s, pred_x0)
            x = s["sqrt_a_prev"] * pred_x0 + s["dir_coef"] * eps
            if tables["noise_gate"][i] > 0:
                x = x + s["noise_gate"] * s["sigma"] * noise.step(i, x.shape)
            return x, aux
    else:
        aux0, update = _shared_update(cfg, tables, noise, cond_fn,
                                      extract_raw=lambda out: out[..., :3])

    full = None
    if cache_apply is not None:
        full_fn, cached_fn = cache_apply
        full = (lambda x, t: full_fn(x, t, masked_image, mask),
                lambda x, t, cache: cached_fn(x, t, masked_image, mask, cache))
    call = _model_caller(cfg, len(tables["t"]),
                         lambda x, t: apply_fn(x, t, masked_image, mask), full)

    # a step whose host gate is 0 adds exactly nothing; its draw is skipped.
    # Injection noise is keyed by timestep: a level that repaint revisits
    # gets the same injection noise again (the reference's noise cache)
    before = after = None
    if cfg.injection and cfg.injection_point == "pre":
        def before(x, s, i):
            if tables["pre_inject_gate"][i] <= 0:
                return x
            return _maybe_pre_inject(x, s, gt, keep,
                                     noise.inject(int(tables["t"][i]), gt.shape))
    if cfg.injection and cfg.injection_point == "post":
        def after(x, s, i):
            if tables["inject_gate"][i] <= 0:
                return x
            return _maybe_post_inject(x, s, gt, keep,
                                      noise.inject(int(tables["inject_t"][i]), gt.shape))

    x, frames = _run(cfg, tables, x, aux0, update, call, before, after, device_tables)
    if cfg.final_blend:
        x = x * mask + gt * keep
    return _result(x, frames, cfg)


def sample(
    apply_fn: Callable,
    sched: DiffusionSchedule,
    cfg: SamplerConfig,
    *,
    shape,
    noise,
    x_init: Optional[torch.Tensor] = None,
    cache_apply: Optional[Tuple[Callable, Callable]] = None,
    cond_fn: Optional[Callable] = None,
):
    """Unconditional generation (the 3-channel base model), library
    semantics: the reference's `p_sample_loop` / `ddim_sample_loop` with no
    injection and no blend.

    apply_fn(x, t[B]) -> model output. `noise` needs only `init(shape)` and
    `step(index, shape)`; the tables go to the device of its init draw (or
    of x_init). With cfg.encoder_cache_period > 1, cache_apply =
    (full_fn(x, t) -> (out, cache), cached_fn(x, t, cache) -> out).
    `cond_fn` as in `inpaint_sample`. cfg.strength < 1 refines `x_init`,
    which it then needs. Returns [B,H,W,3], or `(images, trajectory)` with
    cfg.trajectory_every > 0.

    Its DDIM step is the library's, not the inpainting loop's: the learned
    variance is split off with `split_model_output` and eps is always
    re-derived from the (clipped) x0.
    """
    _check_config(cfg, cond_fn)
    if cfg.strength < 1.0 and x_init is None:
        raise ValueError(
            "strength < 1 on the unconditional sampler needs x_init "
            "(the clean image to refine)")
    tables = _method_tables(sched, cfg)
    x = _initial_state(sched, cfg, int(tables["t"][0]), tuple(shape), x_init, x_init, noise)

    def extract_raw(out):
        return gd.split_model_output(out, cfg.var_type)[0]
    if cfg.method == "ddim":
        aux0 = None

        def update(x, aux, s, out, i):
            pred_x0 = _clipped_x0(extract_raw(out), x, s, cfg)
            eps = (x - s["sqrt_a_t"] * pred_x0) / s["sqrt_one_minus_a_t"]
            if cond_fn is not None:
                pred_x0, eps = _guide_eps(cond_fn, x, s, pred_x0)
            x = s["sqrt_a_prev"] * pred_x0 + s["dir_coef"] * eps
            if tables["noise_gate"][i] > 0:
                x = x + s["noise_gate"] * s["sigma"] * noise.step(i, x.shape)
            return x, aux
    else:
        aux0, update = _shared_update(cfg, tables, noise, cond_fn, extract_raw)

    call = _model_caller(cfg, len(tables["t"]), apply_fn, cache_apply)
    x, frames = _run(cfg, tables, x, aux0, update, call)
    return _result(x, frames, cfg)
