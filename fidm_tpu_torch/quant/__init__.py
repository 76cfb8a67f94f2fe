from .calibrate import (
    DEFAULT_GRID,
    collect_input_moments,
    quantize_params_calibrated,
    quantize_tensor_calibrated,
)
from .int8 import (
    dequantize_params,
    dequantize_tensor,
    quantize_params,
    quantize_tensor,
    quantized_size_bytes,
)
from .npz import flatten_quantized, load_quantized, load_quantized_state_dict, save_quantized

__all__ = [
    "DEFAULT_GRID",
    "collect_input_moments",
    "dequantize_params",
    "dequantize_tensor",
    "flatten_quantized",
    "load_quantized",
    "load_quantized_state_dict",
    "quantize_params",
    "quantize_params_calibrated",
    "quantize_tensor",
    "quantize_tensor_calibrated",
    "quantized_size_bytes",
    "save_quantized",
]
