"""Versioned on-disk artifacts for the port's serving stack.

`ArtifactStore` is the one persistence surface: content-addressed circuit
bundles, stored span-launch units (`repro_torch.runtime.aot`), and one
JSON manifest naming them (tenants, QoS, executable provenance, an
optional whole-fleet section).  Its layout is the reference's, so either
package reads a store the other wrote.  `load_legacy_registry_dir`
reads the flat per-tenant bundle directories written before the store.
"""
from repro_torch.serve.artifacts.store import (  # noqa: F401
    CIRCUIT_SUFFIX,
    EXECUTABLE_SUFFIX,
    MANIFEST_NAME,
    STORE_FORMAT_VERSION,
    STORE_KIND,
    ArtifactStore,
    load_legacy_registry_dir,
)

__all__ = [
    "ArtifactStore",
    "CIRCUIT_SUFFIX",
    "EXECUTABLE_SUFFIX",
    "MANIFEST_NAME",
    "STORE_FORMAT_VERSION",
    "STORE_KIND",
    "load_legacy_registry_dir",
]
