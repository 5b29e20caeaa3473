"""The columnar cluster core's device program (`columnar`: the
gang-readiness aggregate) and the port's metrics registry (`metrics`).

`job_counts` and `job_counts_reference` load `columnar` on first use:
`obs/profile.py` imports `core.metrics`, and `columnar` registers its
bucket factory with `obs/profile.py`, so importing `columnar` here, eagerly,
would go round in a circle."""

__all__ = ["job_counts", "job_counts_reference"]


def __getattr__(name):
    if name in __all__:
        from . import columnar

        return getattr(columnar, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
