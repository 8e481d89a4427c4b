from .index import FeatureIndex, build_index, train_kmeans
from .search import knn_blend

__all__ = ["FeatureIndex", "build_index", "knn_blend", "train_kmeans"]
