from .base import Strategy, StrategyResult, get_strategy, split_by_token_budget
from .critique import MapReduceCritiqueStrategy
from .hierarchical import HierarchicalStrategy
from .iterative import IterativeStrategy
from .mapreduce import MapReduceStrategy
from .skeleton import SkeletonStrategy
from .truncated import TruncatedStrategy

__all__ = [
    "Strategy",
    "StrategyResult",
    "get_strategy",
    "split_by_token_budget",
    "MapReduceStrategy",
    "MapReduceCritiqueStrategy",
    "IterativeStrategy",
    "TruncatedStrategy",
    "HierarchicalStrategy",
    "SkeletonStrategy",
]
