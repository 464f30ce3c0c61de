"""Shared by the span readers: the mean of one of the port's stages
(``observability/trace.py``) over the window, from its histogram's sum
and count (exact, unlike its bucketed quantiles)."""


def mean_ms(ctx, stage: str, engine=None):
    spans = ctx.get("spans")
    if not spans or stage not in spans:
        return None
    if engine is not None and engine not in ctx.get("span_engines", ()):
        return None
    count, sum_ms = spans[stage]
    return sum_ms / count if count else None
