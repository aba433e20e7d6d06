from .base import Strategy, StrategyResult, get_strategy, split_by_token_budget
from .mapreduce import MapReduceStrategy
from .truncated import TruncatedStrategy

__all__ = [
    "Strategy",
    "StrategyResult",
    "get_strategy",
    "split_by_token_budget",
    "MapReduceStrategy",
    "TruncatedStrategy",
]
