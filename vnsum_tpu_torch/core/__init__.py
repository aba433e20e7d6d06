from .config import APPROACHES, EvalConfig, GenerationConfig, PipelineConfig, approach_defaults

__all__ = ["APPROACHES", "EvalConfig", "GenerationConfig", "PipelineConfig", "approach_defaults"]
