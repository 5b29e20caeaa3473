"""Reading the control plane's debug bundles: the policy corpus's source.

Counterpart of the reader half of `jobset_tpu/obs/bundle.py` (a bundle
is a gzip'd tar of JSON members and ``metrics.prom``, with a manifest).
Writing bundles stays with the reference's control plane.
"""

from __future__ import annotations

import json
import tarfile

# Semantic bundle-content version stamped into the manifest. Major bumps
# mean a consumer written against this module cannot safely parse the
# members (load_bundle REJECTS unknown majors — the policy plane's corpus
# builder needs a stable contract across controller generations); minor
# bumps are additive (1.1 added per-timeline `placements` records; 1.2
# added the manifest `lint` block; 1.3 added the race-rule counts
# (RACE001-003) and per-rule `timingMs` inside that block — the race-
# detection plane's debt is now part of every postmortem; 1.4 added
# `tsdb.json` + `alerts.json`, the telemetry plane's full snapshot and
# alert state/transition log, `{"enabled": false}` when the controller
# runs without --telemetry; 1.5 added `profile.json`, the continuous
# profiler's hotspot/lock/JIT snapshot, same `enabled` convention for
# controllers running without --profile).
# Bundles written before the stamp existed are treated as "1.0".
BUNDLE_SCHEMA_VERSION = "1.5"


def load_bundle(path: str) -> dict:
    """Parse a debug bundle back into ``{member_name: payload}`` (JSON
    members decoded, ``metrics.prom`` as text). Raises ValueError on a
    tarball that is not a debug bundle or whose manifest disagrees with
    its contents."""
    out: dict[str, object] = {}
    with tarfile.open(path, "r:gz") as tar:
        for member in tar.getmembers():
            fileobj = tar.extractfile(member)
            if fileobj is None:
                continue
            data = fileobj.read()
            if member.name.endswith(".json"):
                out[member.name] = json.loads(data)
            else:
                out[member.name] = data.decode()
    manifest = out.get("manifest.json")
    if not isinstance(manifest, dict) or "members" not in manifest:
        raise ValueError(f"{path!r} is not a debug bundle (no manifest)")
    version = str(manifest.get("schemaVersion", "1.0"))
    major = version.partition(".")[0]
    if major != BUNDLE_SCHEMA_VERSION.partition(".")[0]:
        raise ValueError(
            f"debug bundle {path!r} has schemaVersion {version}; this "
            f"build understands major "
            f"{BUNDLE_SCHEMA_VERSION.partition('.')[0]} "
            f"(current {BUNDLE_SCHEMA_VERSION}) — re-capture the bundle "
            f"with a matching controller"
        )
    missing = [m for m in manifest["members"] if m not in out]
    if missing:
        raise ValueError(
            f"debug bundle {path!r} is missing members {missing}"
        )
    return out
