from .uq32 import float_to_uq32, uq32_to_float, uq32_top_bits
from .checkpoint import save_checkpoint, load_checkpoint, dump_arr, load_arr
from .watchdog import make_guarded_step
from .metrics import MetricsLogger, summarize
from .profiling import trace
from .roofline import speed_of_light, DEVICE_SPECS
from .compile_cache import enable_compile_cache

__all__ = [
    "float_to_uq32",
    "uq32_to_float",
    "uq32_top_bits",
    "save_checkpoint",
    "load_checkpoint",
    "dump_arr",
    "load_arr",
    "make_guarded_step",
    "MetricsLogger",
    "summarize",
    "trace",
    "speed_of_light",
    "DEVICE_SPECS",
    "enable_compile_cache",
]
