from .pipeline import DataPipeline, SyntheticCorpus

__all__ = ["DataPipeline", "SyntheticCorpus"]
