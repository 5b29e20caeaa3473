"""The port's observability: the span tracer (`trace`), kernel-family
compile and transfer accounting (`profile`), and the reader of the control
plane's debug bundles (`bundle`)."""

from .bundle import BUNDLE_SCHEMA_VERSION, load_bundle

__all__ = ["BUNDLE_SCHEMA_VERSION", "load_bundle"]
