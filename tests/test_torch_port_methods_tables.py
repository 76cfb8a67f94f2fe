"""The host tables of the port's DDPM, DPM-Solver++(3M), UniPC, RePaint and
consistency samplers against the JAX package's: the same float64 numpy code
on both sides, bit-equal.
"""
import numpy as np
import pytest

from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.distill.consistency import consistency_grid
from fidm_tpu.sampling import sampler as jax_sampler
from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.distill.consistency import consistency_grid as port_consistency_grid
from fidm_tpu_torch.sampling import sampler as port_sampler

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_methods_common import _configs, _schedules


def _assert_tables_equal(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("kw", [
    dict(num_steps=100),
    dict(num_steps=50, time_spacing="trailing"),
    dict(num_steps=None),
    dict(num_steps=None, timesteps=(999, 874, 749, 624, 499, 374, 249, 124, 0)),
    dict(num_steps=100, strength=0.3),
], ids=["uniform", "trailing", "full", "explicit", "strength"])
def test_ddpm_tables_bit_equal(kw):
    jcfg, pcfg = _configs(method="ddpm", injection_schedule="high", **kw)
    jsched, psched = _schedules()
    _assert_tables_equal(port_sampler._ddpm_tables(psched, pcfg),
                         jax_sampler._ddpm_tables(jsched, jcfg))


@pytest.mark.parametrize("k,spacing", [(20, "uniform"), (12, "uniform"), (20, "lambda")])
def test_dpm3m_tables_bit_equal(k, spacing):
    jcfg, pcfg = _configs(method="dpm++3m", num_steps=k, time_spacing=spacing)
    jsched, psched = _schedules()
    _assert_tables_equal(port_sampler._dpm3m_tables(psched, pcfg),
                         jax_sampler._dpm3m_tables(jsched, jcfg))


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("corrector", [True, False])
def test_unipc_tables_bit_equal(order, corrector):
    jcfg, pcfg = _configs(method="unipc", num_steps=10, unipc_order=order,
                          unipc_corrector=corrector)
    jsched, psched = _schedules()
    _assert_tables_equal(port_sampler._unipc_tables(psched, pcfg),
                         jax_sampler._unipc_tables(jsched, jcfg))


@pytest.mark.parametrize("K,length,n", [(250, 10, 10), (100, 5, 3), (7, 3, 2), (20, 0, 5),
                                        (20, 4, 1)])
def test_repaint_level_sequence_bit_equal(K, length, n):
    np.testing.assert_array_equal(port_sampler.repaint_level_sequence(K, length, n),
                                  jax_sampler.repaint_level_sequence(K, length, n))


@pytest.mark.parametrize("preset", [dict(num_steps=250, jump_length=10, jump_n_sample=10),
                                    dict(num_steps=100, jump_length=5, jump_n_sample=3)],
                         ids=["repaint-250", "repaint-100-light"])
def test_repaint_tables_bit_equal(preset):
    jcfg, pcfg = _configs(method="repaint", **preset)
    jsched, psched = _schedules()
    ours = port_sampler._repaint_tables(psched, pcfg)
    _assert_tables_equal(ours, jax_sampler._repaint_tables(jsched, jcfg))
    # repaint-250: 2501 model evaluations among its rows; repaint-100-light 301
    n_eval = {250: 2501, 100: 301}[preset["num_steps"]]
    assert ours["is_denoise"].sum() == n_eval


def test_repaint_without_jumps_is_ddpm():
    _, pcfg = _configs(method="repaint", num_steps=20, jump_length=5, jump_n_sample=1)
    _, psched = _schedules()
    ours = port_sampler._repaint_tables(psched, pcfg)
    ddpm = port_sampler._ddpm_tables(psched, pcfg)
    assert ours["is_denoise"].all()
    for k, v in ddpm.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.mark.parametrize("k", [1, 2, 1000, 1500])
def test_consistency_seq_bit_equal(k):
    for T in (50, 1000):
        jcfg, pcfg = _configs(method="consistency", num_steps=k)
        ours = port_sampler._consistency_seq(DiffusionSchedule.create("linear", T, device="cpu"),
                                             pcfg)
        assert ours == jax_sampler._consistency_seq(JaxSchedule.create("linear", T), jcfg)
        for steps in (1, 2, k):
            np.testing.assert_array_equal(port_consistency_grid(T, steps),
                                          consistency_grid(T, steps))
