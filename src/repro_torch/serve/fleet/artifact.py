"""FleetArtifact: one bundle that boots a whole cluster cold.

The fleet section of an `ArtifactStore` manifest, typed.  An exported
fleet is everything a restart needs, in one content-addressed directory:

  * the **circuits** — every tenant's member bundles (the store's
    registry section, written once for the whole cluster);
  * the **fleet plan** — tenant → host assignment, pins and plan
    generation, so the router's routing table comes back verbatim
    instead of being re-derived (a re-derivation could shuffle tenants
    the operator had deliberately migrated);
  * one **host config** per member — backend, shard policy, the *exact*
    serving placement (tenant → per-member ``(shard, slot)`` pairs,
    which may be a sticky-recompiled layout no fresh compile would
    reproduce), and the span buckets its traffic actually used;
  * the **executables** — the port's span-launch units
    (`repro_torch.runtime.aot`) keyed by ``(backend, shard content hash,
    span bucket)``, which is why the exact placement matters: identical
    slot order → identical shard hashes → the keys match and a booting
    host loads them with **no program compiled**.

`ServingHost.boot_from_artifact` rebuilds one member from this;
`FleetRouter.boot_from_artifact` rebuilds the cluster.  Both degrade
gracefully: a placement that no longer covers the stored circuits falls
back to a fresh compile, a backend without units (``"torch-ref"``, the
CPU) runs eagerly from its first tick — each with the reason logged.

The manifest section is the reference's, so either package reads a fleet
the other exported (a host config's ``backend`` names the package's own
backend, and each server skips the other's executables).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

FLEET_KIND = "tiny-classifier-circuits/fleet"
FLEET_FORMAT_VERSION = 1
# versions this reader accepts; bump FLEET_FORMAT_VERSION and extend when
# the schema changes compatibly
_READABLE_FLEET_VERSIONS = (1,)


@dataclasses.dataclass(frozen=True)
class HostConfig:
    """One host's serving shape, exactly as exported.

    ``placement`` maps tenant → one ``(shard, slot)`` pair per ensemble
    member; ``tenants`` preserves registration order (slot layout of a
    fresh compile depends on it); ``spans`` are the launch buckets the
    host's traffic actually produced — the shapes worth preloading.
    """

    host_id: str
    backend: str
    n_shards: int
    span_align: int
    assignment_mode: str
    stable_shapes: bool
    tenants: tuple[str, ...]
    placement: Mapping[str, tuple]
    spans: tuple[int, ...]

    def to_manifest(self) -> dict:
        return {
            "backend": self.backend,
            "n_shards": int(self.n_shards),
            "span_align": int(self.span_align),
            "assignment_mode": self.assignment_mode,
            "stable_shapes": bool(self.stable_shapes),
            "tenants": list(self.tenants),
            "placement": {
                t: [list(map(int, pair)) for pair in pairs]
                for t, pairs in self.placement.items()
            },
            "spans": [int(s) for s in self.spans],
        }

    @classmethod
    def from_manifest(cls, host_id: str, d: Mapping) -> "HostConfig":
        return cls(
            host_id=host_id,
            backend=str(d["backend"]),
            n_shards=int(d["n_shards"]),
            span_align=int(d["span_align"]),
            assignment_mode=str(d.get("assignment_mode", "round_robin")),
            stable_shapes=bool(d.get("stable_shapes", True)),
            tenants=tuple(d["tenants"]),
            placement={
                t: tuple(tuple(int(v) for v in pair) for pair in pairs)
                for t, pairs in d["placement"].items()
            },
            spans=tuple(int(s) for s in d.get("spans", ())),
        )


@dataclasses.dataclass(frozen=True)
class FleetArtifact:
    """The typed fleet section of an artifact store manifest."""

    generation: int
    content_hash: str
    hosts: tuple[str, ...]
    assignment: Mapping[str, str]
    pins: Mapping[str, str]
    host_configs: Mapping[str, HostConfig]

    def to_manifest(self) -> dict:
        return {
            "kind": FLEET_KIND,
            "format_version": FLEET_FORMAT_VERSION,
            "generation": int(self.generation),
            "content_hash": self.content_hash,
            "hosts": list(self.hosts),
            "assignment": dict(self.assignment),
            "pins": dict(self.pins),
            "host_configs": {
                h: cfg.to_manifest() for h, cfg in self.host_configs.items()
            },
        }

    @classmethod
    def from_manifest(cls, d: Mapping) -> "FleetArtifact":
        if d.get("kind") != FLEET_KIND:
            raise ValueError(
                f"not a fleet artifact section (kind={d.get('kind')!r})"
            )
        version = int(d.get("format_version", 0))
        if version not in _READABLE_FLEET_VERSIONS:
            raise ValueError(
                f"unsupported fleet format version {version} (this build "
                f"reads {_READABLE_FLEET_VERSIONS})"
            )
        return cls(
            generation=int(d["generation"]),
            content_hash=str(d["content_hash"]),
            hosts=tuple(d["hosts"]),
            assignment=dict(d["assignment"]),
            pins=dict(d.get("pins", {})),
            host_configs={
                h: HostConfig.from_manifest(h, cfg)
                for h, cfg in d["host_configs"].items()
            },
        )

    def save(self, store) -> None:
        store.put_fleet(self.to_manifest())

    @classmethod
    def load(cls, store) -> "FleetArtifact":
        """Read the fleet section of ``store`` (ValueError when the store
        holds none, or one this build cannot read)."""
        section = store.fleet()
        if section is None:
            raise ValueError(
                f"artifact store at {store.root!r} has no fleet section — "
                "export one with FleetRouter.export_fleet()"
            )
        return cls.from_manifest(section)
