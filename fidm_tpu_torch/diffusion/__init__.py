from .gaussian import ModelMeanType, ModelVarType
from .schedules import DiffusionSchedule, ddim_timestep_sequence, get_named_beta_schedule

__all__ = ["DiffusionSchedule", "ModelMeanType", "ModelVarType",
           "ddim_timestep_sequence", "get_named_beta_schedule"]
