"""Incremental aggregation (``define aggregation``) and its device bank."""

from siddhi_tpu_torch.aggregation.runtime import AggregationRuntime

__all__ = ["AggregationRuntime"]
