"""Histogram quantile estimation by bucket interpolation.

THE quantile implementation: `tools/metrics_dump.py`'s p50/p95/p99
columns, the SLO engine (slo.py), and `tools/slo_report.py` all call
into this file — one estimator, so an SLO verdict and an operator's
dump can never disagree about what "p95 TTFT" means.

Semantics follow Prometheus `histogram_quantile`: within the bucket
containing the target rank, the value is linearly interpolated between
the previous bound and the bucket's upper bound (the lowest bucket
interpolates from 0). A rank landing in the +Inf overflow bucket clamps
to the largest finite bound — the estimator never invents a value above
what the buckets can support.

Deliberately STANDALONE like metrics.py: stdlib only, no
package-relative imports, loadable via
importlib.util.spec_from_file_location on machines without jax.

Port: a copy of `paddle_tpu/observability/quantiles.py`, which imports no
JAX either. Its relative imports stay inside paddle_tpu_torch.
"""

from __future__ import annotations

__all__ = ["quantile_from_cumulative", "quantiles_from_cumulative",
           "quantiles_from_sample", "DEFAULT_QS"]

# the columns metrics_dump prints and the SLO defaults reference
DEFAULT_QS = (0.5, 0.95, 0.99)


def _norm_buckets(buckets):
    """-> ([(finite_le, cum), ...] sorted, total_count). Accepts the
    [(le, cum), ...] shape of Histogram.cumulative_buckets() and the
    [[le, cum], ...] shape of a metrics snapshot sample, with le either
    a float or the string '+Inf'."""
    finite = []
    total = 0
    for le, cum in buckets:
        cum = int(cum)
        if isinstance(le, str) and le.strip() in ("+Inf", "inf", "Inf"):
            total = max(total, cum)
            continue
        le = float(le)
        if le == float("inf"):
            total = max(total, cum)
            continue
        finite.append((le, cum))
        total = max(total, cum)
    finite.sort()
    return finite, total


def quantile_from_cumulative(buckets, q):
    """Estimate the q-quantile (q in [0, 1]) from cumulative histogram
    buckets ([(le, cumulative_count), ...], '+Inf' last as emitted by
    Histogram.cumulative_buckets() / snapshot samples). Returns None for
    an empty histogram."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    finite, total = _norm_buckets(buckets)
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_cum = 0.0, 0
    for le, cum in finite:
        if cum >= rank:
            in_bucket = cum - prev_cum
            if in_bucket <= 0:
                return le
            frac = (rank - prev_cum) / in_bucket
            return prev_le + (le - prev_le) * min(max(frac, 0.0), 1.0)
        prev_le, prev_cum = le, cum
    # rank fell in the +Inf overflow: clamp to the largest finite bound
    # (None when the histogram has no finite bounds at all)
    return finite[-1][0] if finite else None


def quantiles_from_cumulative(buckets, qs=DEFAULT_QS):
    """{q: estimate_or_None} for several quantiles at once."""
    return {q: quantile_from_cumulative(buckets, q) for q in qs}


def quantiles_from_sample(sample, qs=DEFAULT_QS):
    """Same, from one histogram sample dict of a metrics snapshot
    ({'buckets': [[le, cum], ...], 'count': n, ...})."""
    return quantiles_from_cumulative(sample.get("buckets") or (), qs)
