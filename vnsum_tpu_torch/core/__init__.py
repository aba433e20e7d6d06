from .config import APPROACHES, GenerationConfig, PipelineConfig, approach_defaults

__all__ = ["APPROACHES", "GenerationConfig", "PipelineConfig", "approach_defaults"]
