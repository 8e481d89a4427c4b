from .index import FeatureIndex
from .search import knn_blend

__all__ = ["FeatureIndex", "knn_blend"]
