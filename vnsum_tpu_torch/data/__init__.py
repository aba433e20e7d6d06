from .dataset import DocStats, DocumentDataset, analyze_documents

__all__ = ["DocStats", "DocumentDataset", "analyze_documents"]
