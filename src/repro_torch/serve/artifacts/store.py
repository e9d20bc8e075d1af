"""One versioned, content-addressed store for every serving artifact.

The port's own copy of the reference's `ArtifactStore`, on the same
layout, so a store either package writes, the other reads::

    <root>/manifest.json            # the only mutable file (atomic swap)
    <root>/objects/<digest>.circuit.npz   # circuit bundles, content-addressed
    <root>/objects/<key>.exec             # stored span-launch units

Objects are immutable and named by content — identical circuits stored
for two tenants (or two hosts) share one file, and a re-save never
rewrites bytes that are already present.  All naming lives in the
manifest: tenant → member objects (+ pinned QoS), executable key →
payload (+ backend/format provenance), and an optional ``fleet`` section
describing a whole multi-host stack.  The port's executables are
span-launch units (`repro_torch.runtime.aot`); the reference's are XLA
executables, and each package's server skips the other's entries by
backend and format.

The manifest is versioned like the circuit bundles: `ArtifactStore`
refuses kinds/versions it does not know, and every mutation rewrites it
atomically (tmp + rename) so a crashed export never leaves a half-valid
store — at worst orphaned objects, which the next `put_registry` garbage
collects.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import tempfile
from typing import Mapping

import numpy as np

from repro_torch.core.api import ServableCircuit, load_servable, save_servable

MANIFEST_NAME = "manifest.json"
STORE_KIND = "tiny-classifier-circuits/artifact-store"
STORE_FORMAT_VERSION = 1
_READABLE_STORE_VERSIONS = (1,)
OBJECTS_DIR = "objects"

# same suffix the registry layer has always used — an object file *is* a
# ServableCircuit bundle, only its name changed from tenant to digest
CIRCUIT_SUFFIX = ".circuit.npz"
EXECUTABLE_SUFFIX = ".exec"

# the ensemble-member suffix tenant names may not end in
ENSEMBLE_SEP = "@m"
_MEMBER_SUFFIX = re.compile(r"^(.+)@m(0|[1-9]\d*)$")


def _bundle_digest(sc: ServableCircuit) -> str:
    """Content digest of everything a bundle persists.

    Unlike `repro_torch.serve.planning.circuit_digest` (which hashes only what
    changes a *launch*), this includes the v2 provenance fields — two
    circuits differing only in lineage or drift-reference stats must not
    collapse to one stored object, or a reload would lose the audit
    trail the online-evolution loop depends on."""
    h = hashlib.sha256()
    h.update(
        json.dumps(
            {
                "spec": [int(sc.spec.n_inputs), int(sc.spec.n_nodes),
                         int(sc.spec.n_outputs),
                         [int(op) for op in sc.spec.fn_set]],
                "encoder": [sc.encoder.strategy, int(sc.encoder.bits)],
                "n_classes": int(sc.n_classes),
                "lineage": sc.lineage,
            },
            sort_keys=True,
        ).encode()
    )
    for arr, dt in (
        (sc.genome.gate_fn, np.int32),
        (sc.genome.edge_src, np.int32),
        (sc.genome.out_src, np.int32),
        (sc.encoder.thresholds, np.float32),
        (sc.encoder.codes, np.uint8),
    ):
        h.update(np.ascontiguousarray(np.asarray(arr, dt)).tobytes())
    if sc.ref_stats is not None:
        h.update(np.ascontiguousarray(
            np.asarray(sc.ref_stats, np.float32)).tobytes())
    return h.hexdigest()[:24]


def _validate_tenant_names(tenants) -> None:
    """The reference's naming contract: validate every name *before*
    anything touches disk, so a bad registry never leaves a partial store
    behind."""
    for tenant in tenants:
        if os.sep in tenant or tenant.startswith("."):
            raise ValueError(
                f"tenant name {tenant!r} is not filesystem-safe"
            )
        if _MEMBER_SUFFIX.match(tenant):
            raise ValueError(
                f"tenant name {tenant!r} ends in the reserved "
                f"'{ENSEMBLE_SEP}<digits>' ensemble-member suffix"
            )


class ArtifactStore:
    """Versioned, content-addressed persistence root (see module doc).

    Thread-unsafe by design: stores are mutated by one exporter at a
    time (a host snapshotting itself, a router exporting its fleet);
    readers only ever see a complete manifest thanks to the atomic swap.
    """

    def __init__(self, root: str):
        self.root = str(root)
        path = os.path.join(self.root, MANIFEST_NAME)
        if os.path.exists(path):
            with open(path) as f:
                m = json.load(f)
            if m.get("kind") != STORE_KIND:
                raise ValueError(
                    f"{path}: not an artifact-store manifest "
                    f"(kind={m.get('kind')!r})"
                )
            if m.get("format_version") not in _READABLE_STORE_VERSIONS:
                raise ValueError(
                    f"{path}: unsupported store format version "
                    f"{m.get('format_version')!r} (this build reads "
                    f"{list(_READABLE_STORE_VERSIONS)})"
                )
            self._manifest = m
        else:
            self._manifest = {
                "kind": STORE_KIND,
                "format_version": STORE_FORMAT_VERSION,
                "registry": {"tenants": {}, "order": []},
                "executables": {},
                "fleet": None,
            }

    # -- layout helpers ------------------------------------------------
    @staticmethod
    def is_store(path: str) -> bool:
        """True when ``path`` holds a store manifest."""
        return os.path.exists(os.path.join(str(path), MANIFEST_NAME))

    def _abs(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def _ensure_objects_dir(self) -> str:
        d = os.path.join(self.root, OBJECTS_DIR)
        os.makedirs(d, exist_ok=True)
        return d

    def flush(self) -> str:
        """Atomically publish the manifest (write-temp + rename)."""
        os.makedirs(self.root, exist_ok=True)
        dest = os.path.join(self.root, MANIFEST_NAME)
        fd, tmp = tempfile.mkstemp(
            dir=self.root, prefix=".manifest-", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._manifest, f, indent=1, sort_keys=True)
            os.replace(tmp, dest)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return dest

    # -- circuits ------------------------------------------------------
    def put_circuit(
        self, circuit: ServableCircuit, *, validated_backend: str = "torch-ref",
    ) -> str:
        """Store one circuit bundle; returns its manifest-relative object
        path.  Content-addressed: storing an identical circuit twice (or
        for two tenants) writes one file."""
        rel = os.path.join(
            OBJECTS_DIR, _bundle_digest(circuit) + CIRCUIT_SUFFIX
        )
        full = self._abs(rel)
        if not os.path.exists(full):
            self._ensure_objects_dir()
            save_servable(circuit, full, validated_backend=validated_backend)
        return rel

    def get_circuit(self, rel: str) -> ServableCircuit:
        return load_servable(self._abs(rel))

    # -- registry section ----------------------------------------------
    def put_registry(
        self, registry, *, validated_backend: str = "torch-ref",
    ) -> list[str]:
        """Snapshot a `CircuitRegistry`: write every member's bundle
        object, point the manifest's registry section at them (insertion
        order and pinned QoS preserved), drop tenants no longer
        registered, and garbage-collect unreferenced objects.  Returns
        the absolute path written for each member (one entry per member,
        shared objects repeat)."""
        from repro_torch.serve.circuits.registry import DEFAULT_QOS

        catalog = registry.catalog()
        _validate_tenant_names(catalog.tenants)
        written: list[str] = []
        tenants: dict[str, dict] = {}
        for tenant, members in zip(catalog.tenants, catalog.members):
            rels = []
            for sc in members:
                rel = self.put_circuit(
                    sc, validated_backend=validated_backend
                )
                rels.append(rel)
                written.append(self._abs(rel))
            qos = registry.qos(tenant)
            tenants[tenant] = {
                "members": rels,
                "qos": (None if qos == DEFAULT_QOS
                        else dataclasses.asdict(qos)),
            }
        self._manifest["registry"] = {
            "tenants": tenants,
            "order": list(catalog.tenants),
        }
        self.gc()
        self.flush()
        return written

    def load_registry(self):
        """Rebuild a `CircuitRegistry` from the manifest's registry
        section — tenant names, member order, insertion order, and pinned
        QoS all come back verbatim; circuits predict bit-identically."""
        from repro_torch.serve.circuits.registry import CircuitRegistry, TenantQoS

        section = self._manifest.get("registry") or {"tenants": {}, "order": []}
        reg = CircuitRegistry()
        tenants = section["tenants"]
        for tenant in section.get("order") or sorted(tenants):
            entry = tenants[tenant]
            reg.add_ensemble(
                tenant, [self.get_circuit(rel) for rel in entry["members"]]
            )
            if entry.get("qos"):
                reg.set_qos(tenant, TenantQoS(**entry["qos"]))
        return reg

    # -- executables ---------------------------------------------------
    def put_executable(
        self, key: str, payload: bytes, *,
        backend: str, aot_format: str, aot_format_version: int,
        spec: "tuple | list", device_kind: str = "",
    ) -> str:
        """Store one serialized executable (the port's: a span-launch
        unit) under its cache key ``(backend, shard content hash, span
        bucket)`` (see `repro_torch.runtime.aot.executable_key`).
        ``spec`` is the `SpanLaunchSpec` shape tuple, kept so a booting
        host can reconstruct launch buffers without recompiling."""
        if "/" in key or os.sep in key or key.startswith("."):
            raise ValueError(f"executable key {key!r} is not filesystem-safe")
        rel = os.path.join(OBJECTS_DIR, key + EXECUTABLE_SUFFIX)
        self._ensure_objects_dir()
        with open(self._abs(rel), "wb") as f:
            f.write(payload)
        self._manifest["executables"][key] = {
            "path": rel,
            "backend": backend,
            "format": aot_format,
            "format_version": int(aot_format_version),
            "spec": [int(v) for v in spec],
            "device_kind": device_kind,
        }
        self.flush()
        return rel

    def get_executable(self, key: str) -> bytes:
        """The serialized payload for ``key``.  Raises KeyError when the
        manifest has no such key and OSError when the manifest points at
        a missing object file — boot paths treat either as "compile the
        shard instead" and log the reason."""
        entry = self._manifest["executables"][key]
        with open(self._abs(entry["path"]), "rb") as f:
            return f.read()

    def executable_entries(self) -> dict[str, dict]:
        """Manifest view of every stored executable (key → provenance)."""
        return dict(self._manifest["executables"])

    # -- fleet section --------------------------------------------------
    def put_fleet(self, fleet: "dict | None") -> None:
        """Attach (or clear) the fleet section: a JSON description of a
        whole multi-host stack (the fleet layer writes and reads it — the
        store only guarantees it round-trips)."""
        self._manifest["fleet"] = fleet
        self.flush()

    def fleet(self) -> "dict | None":
        return self._manifest.get("fleet")

    # -- maintenance ----------------------------------------------------
    def _referenced(self) -> set[str]:
        refs: set[str] = set()
        section = self._manifest.get("registry") or {}
        for entry in (section.get("tenants") or {}).values():
            refs.update(entry["members"])
        for entry in self._manifest["executables"].values():
            refs.add(entry["path"])
        # the fleet section is opaque JSON to the store; the reference's
        # fleet artifact references circuits only through the registry
        # section, but scan dict-shaped per-host member lists defensively
        # so another fleet layout never loses objects
        fleet = self._manifest.get("fleet") or {}
        hosts = fleet.get("hosts")
        if isinstance(hosts, Mapping):
            for host in hosts.values():
                for entry in (host.get("tenants") or {}).values():
                    refs.update(entry["members"])
        return {os.path.normpath(r) for r in refs}

    def gc(self) -> list[str]:
        """Delete object files nothing in the manifest references (stale
        circuits after a prune, executables after a re-key).  Returns the
        removed paths."""
        obj_dir = os.path.join(self.root, OBJECTS_DIR)
        if not os.path.isdir(obj_dir):
            return []
        refs = self._referenced()
        removed = []
        for fname in sorted(os.listdir(obj_dir)):
            rel = os.path.normpath(os.path.join(OBJECTS_DIR, fname))
            if (fname.endswith((CIRCUIT_SUFFIX, EXECUTABLE_SUFFIX))
                    and rel not in refs):
                os.remove(os.path.join(obj_dir, fname))
                removed.append(rel)
        return removed


# --------------------------------------------------------------------------
# legacy flat-directory reader (pre-store save_dir layout)
# --------------------------------------------------------------------------


def load_legacy_registry_dir(path: str):
    """Rebuild a registry from a flat directory of per-tenant bundles —
    the layout `CircuitRegistry.save_dir` wrote before the store existed
    (``<tenant>.circuit.npz`` / ``<tenant>@m<idx>.circuit.npz``).

    '@m<digits>' is only an ensemble member marker when the files form a
    well-formed ensemble (members 0..k-1, k >= 2, no zero-padding — the
    only shape save_dir ever wrote); any other stem is a plain tenant
    name verbatim, so directories written before the suffix was reserved
    (tenants like 'model@v2' or 'exp@2') restore under their original
    names.  Bundles written by either package load (the port's own copy of
    the reference's reader)."""
    from repro_torch.serve.circuits.registry import CircuitRegistry

    reg = CircuitRegistry()
    candidates: dict[str, list[tuple[int, str, str]]] = {}
    grouped: dict[str, list[tuple[str, str]]] = {}  # (stem, path)
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(CIRCUIT_SUFFIX):
            continue
        stem = fname[: -len(CIRCUIT_SUFFIX)]
        full = os.path.join(path, fname)
        m = _MEMBER_SUFFIX.match(stem)
        if m:
            candidates.setdefault(m.group(1), []).append(
                (int(m.group(2)), stem, full)
            )
        else:
            grouped[stem] = [(stem, full)]
    for tenant, found in candidates.items():
        found.sort()
        if (tenant not in grouped  # a plain '<tenant>' bundle wins
                and len(found) >= 2
                and [i for i, _, _ in found] == list(range(len(found)))
                and all(s == f"{tenant}{ENSEMBLE_SEP}{i}"
                        for i, s, _ in found)):  # no zero-padding
            grouped[tenant] = [(s, p) for _, s, p in found]
        else:  # legacy plain names that merely look like members —
            # restore under their original stems, verbatim
            for _, stem, p in found:
                grouped[stem] = [(stem, p)]
    for tenant, entries in grouped.items():
        circuits = [load_servable(p) for _, p in entries]
        try:
            reg.add_ensemble(tenant, circuits)
        except ValueError:
            if len(entries) == 1:
                raise
            # a member-shaped group that is not actually a coherent
            # ensemble (mismatched widths/classes) can only be legacy
            # plain tenants — restore them individually, verbatim
            for (stem, _), sc in zip(entries, circuits):
                reg.add(stem, sc)
    return reg
