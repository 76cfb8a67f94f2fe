from .lora import (
    DEFAULT_TARGETS,
    flatten_lora,
    init_lora,
    is_lora,
    lora_param_count,
    lora_weights,
    merge_lora,
    select_lora_targets,
)

__all__ = ["DEFAULT_TARGETS", "flatten_lora", "init_lora", "is_lora", "lora_param_count",
           "lora_weights", "merge_lora", "select_lora_targets"]
