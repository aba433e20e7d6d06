from .rouge import RougeScorer

__all__ = ["RougeScorer"]
