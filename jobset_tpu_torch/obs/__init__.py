"""The port's reader of the control plane's debug bundles."""

from .bundle import BUNDLE_SCHEMA_VERSION, load_bundle

__all__ = ["BUNDLE_SCHEMA_VERSION", "load_bundle"]
