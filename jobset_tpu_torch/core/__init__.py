"""The columnar cluster core's device program: the gang-readiness
aggregate."""

from .columnar import job_counts, job_counts_reference

__all__ = ["job_counts", "job_counts_reference"]
