"""Request-level serving layer: micro-batching engine over any pipeline."""

from .engine import Completion, ServingConfig, ServingEngine, ServingStats

__all__ = ["Completion", "ServingConfig", "ServingEngine", "ServingStats"]
