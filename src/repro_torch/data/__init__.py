from .pipeline import DataConfig, SyntheticPipeline, synthetic_batch

__all__ = ["DataConfig", "SyntheticPipeline", "synthetic_batch"]
