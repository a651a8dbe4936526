from .progress import BuildStep, CallbackProgress, InsertItemsStep, NoProgress
from .stats import BuildStats
from .tracing import span

__all__ = ["BuildStep", "CallbackProgress", "InsertItemsStep", "NoProgress", "BuildStats", "span"]
