from .embedding import BertScore, EmbeddingModel, bert_scores, cosine_similarities
from .geval import LLMJudge
from .rouge import RougeScorer
from .semantic import SemanticEvaluator, load_summary_dir

__all__ = [
    "BertScore",
    "EmbeddingModel",
    "bert_scores",
    "cosine_similarities",
    "LLMJudge",
    "RougeScorer",
    "SemanticEvaluator",
    "load_summary_dir",
]
