from . import codecs, distances
from .distances import COSINE, EUCLIDEAN, MANHATTAN, Metric, by_name

__all__ = ["codecs", "distances", "COSINE", "EUCLIDEAN", "MANHATTAN", "Metric", "by_name"]
