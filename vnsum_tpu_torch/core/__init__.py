from .config import APPROACHES, EvalConfig, GenerationConfig, PipelineConfig, approach_defaults
from .profiling import Tracer, annotate, device_profile

__all__ = ["APPROACHES", "EvalConfig", "GenerationConfig", "PipelineConfig", "Tracer",
           "annotate", "approach_defaults", "device_profile"]
