from .gaussian import LossType, ModelMeanType, ModelVarType, noised_ground_truth
from .schedules import DiffusionSchedule, ddim_timestep_sequence, get_named_beta_schedule

__all__ = ["DiffusionSchedule", "LossType", "ModelMeanType", "ModelVarType",
           "ddim_timestep_sequence", "get_named_beta_schedule", "noised_ground_truth"]
