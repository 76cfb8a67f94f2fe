"""Shared pieces of the sampler-method tests (`test_torch_port_methods*.py`):
sampler configurations and schedules in both packages.
"""
from fidm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from fidm_tpu.diffusion.gaussian import ModelMeanType as JaxMeanType
from fidm_tpu.diffusion.gaussian import ModelVarType as JaxVarType
from fidm_tpu.sampling import SamplerConfig as JaxSamplerConfig
from fidm_tpu_torch.diffusion import DiffusionSchedule, ModelMeanType, ModelVarType
from fidm_tpu_torch.sampling import SamplerConfig


def _configs(**kw):
    """The same sampler configuration in both packages; mean_type and
    var_type by enum name."""
    jkw, pkw = dict(kw), dict(kw)
    if "mean_type" in kw:
        jkw["mean_type"] = JaxMeanType[kw["mean_type"]]
        pkw["mean_type"] = ModelMeanType[kw["mean_type"]]
    if "var_type" in kw:
        jkw["var_type"] = JaxVarType[kw["var_type"]]
        pkw["var_type"] = ModelVarType[kw["var_type"]]
    return JaxSamplerConfig(**jkw), SamplerConfig(**pkw)


def _schedules(name="quadratic", T=1000):
    return JaxSchedule.create(name, T), DiffusionSchedule.create(name, T, device="cpu")
