"""Versioned on-disk artifacts for the port's serving stack.

`ArtifactStore` is the one persistence surface: content-addressed circuit
bundles, stored span-launch units (`repro_torch.runtime.aot`), and one
JSON manifest naming them (tenants, QoS, executable provenance, an
optional whole-fleet section).  Its layout is the reference's, so either
package reads a store the other wrote.
"""
from repro_torch.serve.artifacts.store import (  # noqa: F401
    CIRCUIT_SUFFIX,
    EXECUTABLE_SUFFIX,
    MANIFEST_NAME,
    STORE_FORMAT_VERSION,
    STORE_KIND,
    ArtifactStore,
)

__all__ = [
    "ArtifactStore",
    "CIRCUIT_SUFFIX",
    "EXECUTABLE_SUFFIX",
    "MANIFEST_NAME",
    "STORE_FORMAT_VERSION",
    "STORE_KIND",
]
