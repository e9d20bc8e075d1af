"""Multi-tenant circuit catalog: who is registered, nothing else.

`CircuitRegistry` is the serving stack's *catalog*: a thread-safe tenant
table with hot add/remove, ensemble groups (k member circuits voting
under one logical tenant) and per-tenant QoS.  Placement and stacking are
the `repro_torch.serve.planning` compiler's job, fed by immutable
`catalog()` snapshots.  Mutation (add/remove/replace) bumps a monotonic
``generation`` so plan consumers know exactly when a compiled
`CompiledPlan` — and any device upload keyed on it — is stale.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Iterator, Sequence

from repro_torch.core.api import ServableCircuit
from repro_torch.core.genome import validate_genome
from repro_torch.serve.planning import Catalog

@dataclasses.dataclass(frozen=True)
class TenantQoS:
    """Per-tenant quality-of-service knobs for a deadline scheduler.

    A scheduler reads these live (no registry generation bump — QoS never
    changes the compiled launch tensors):

      * ``max_batch`` — rows the scheduler coalesces for this tenant per
        fused launch; a backlogged tenant contributes at most this many
        rows to any launch, so its queue cannot crowd out other tenants.
      * ``max_wait_s`` — longest a request may sit queued before the
        scheduler fires a launch regardless of batch fill or deadlines.
      * ``default_deadline_s`` — deadline assigned to submits that do not
        carry an explicit one.
    """

    max_batch: int = 256
    max_wait_s: float = 0.005
    default_deadline_s: float = 0.100

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_s < 0 or self.default_deadline_s <= 0:
            raise ValueError(
                "max_wait_s must be >= 0 and default_deadline_s > 0, got "
                f"({self.max_wait_s}, {self.default_deadline_s})"
            )


DEFAULT_QOS = TenantQoS()


class CircuitRegistry:
    """Thread-safe tenant catalog with hot add/remove and ensembles."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, tuple[ServableCircuit, ...]] = {}
        self._qos: dict[str, TenantQoS] = {}
        self._generation = 0

    # -- mutation ------------------------------------------------------
    def add(self, tenant: str, circuit: ServableCircuit,
            replace: bool = False, qos: TenantQoS | None = None) -> int:
        """Register (or with replace=True, hot-swap) a tenant's circuit.
        Returns the new registry generation.  ``qos`` optionally pins the
        tenant's serving QoS (defaults to `DEFAULT_QOS`; a hot-swap without
        an explicit qos keeps the existing one)."""
        return self.add_ensemble(tenant, (circuit,), replace=replace, qos=qos)

    def add_ensemble(
        self, tenant: str, circuits: Sequence[ServableCircuit],
        replace: bool = False, qos: TenantQoS | None = None,
    ) -> int:
        """Register k member circuits voting under one logical tenant.

        Members may differ in genome, gate count and even encoding
        strategy, but must agree on the raw feature width (they all see
        the same float rows) and the class count (their votes share one
        label space).  At serve time each member evaluates in its own
        launch slot and the decoded class ids are majority-voted per row
        (ties toward the lowest class id), so an odd k is the sensible
        choice.  A plain `add` is the k=1 special case."""
        members = tuple(circuits)
        if not members:
            raise ValueError(f"tenant {tenant!r}: ensemble needs >= 1 member")
        for i, sc in enumerate(members):
            if not validate_genome(sc.genome, sc.spec):
                raise ValueError(
                    f"tenant {tenant!r}: member {i} genome fails validation"
                )
        feats = {sc.encoder.n_features for sc in members}
        if len(feats) > 1:
            raise ValueError(
                f"tenant {tenant!r}: ensemble members disagree on feature "
                f"width {sorted(feats)}"
            )
        classes = {sc.n_classes for sc in members}
        if len(classes) > 1:
            raise ValueError(
                f"tenant {tenant!r}: ensemble members disagree on class "
                f"count {sorted(classes)}"
            )
        with self._lock:
            if tenant in self._entries and not replace:
                raise KeyError(f"tenant {tenant!r} already registered")
            self._entries[tenant] = members
            if qos is not None:
                self._qos[tenant] = qos
            self._generation += 1
            return self._generation

    def remove(self, tenant: str) -> int:
        with self._lock:
            del self._entries[tenant]
            self._qos.pop(tenant, None)
            self._generation += 1
            return self._generation

    # -- QoS -----------------------------------------------------------
    def qos(self, tenant: str) -> TenantQoS:
        """The tenant's serving QoS (DEFAULT_QOS unless pinned).

        Raises KeyError for unregistered tenants so schedulers cannot
        silently queue work for a tenant that will never be served."""
        with self._lock:
            if tenant not in self._entries:
                raise KeyError(f"unknown tenant {tenant!r}")
            return self._qos.get(tenant, DEFAULT_QOS)

    def set_qos(self, tenant: str, qos: TenantQoS) -> None:
        """Re-pin a registered tenant's QoS.  Takes effect on the next
        scheduler poll; does not bump the registry generation (QoS never
        changes the compiled launch tensors)."""
        with self._lock:
            if tenant not in self._entries:
                raise KeyError(f"unknown tenant {tenant!r}")
            self._qos[tenant] = qos

    # -- persistence ---------------------------------------------------
    def save_dir(self, path: str, *, validated_backend: str = "torch-ref") -> list[str]:
        """Deprecated alias of ``ArtifactStore(path).put_registry(self)``,
        as in the reference: the directory becomes a snapshot of the
        registry in the store's layout (tenants no longer registered are
        dropped and their bundles collected).  Returns one written bundle
        path per member.  Names ending in the reserved ``@m<digits>``
        member suffix are refused."""
        warnings.warn(
            "CircuitRegistry.save_dir() is deprecated; use "
            "repro_torch.serve.artifacts.ArtifactStore(path).put_registry(registry)",
            DeprecationWarning, stacklevel=2,
        )
        from repro_torch.serve.artifacts import ArtifactStore

        return ArtifactStore(path).put_registry(self, validated_backend=validated_backend)

    @classmethod
    def load_dir(cls, path: str) -> "CircuitRegistry":
        """Deprecated alias of ``ArtifactStore(path).load_registry()``, as
        in the reference: a store manifest loads through `ArtifactStore`,
        a legacy flat directory of ``<tenant>.circuit.npz`` bundles through
        `repro_torch.serve.artifacts.load_legacy_registry_dir`."""
        warnings.warn(
            "CircuitRegistry.load_dir() is deprecated; use "
            "repro_torch.serve.artifacts.ArtifactStore(path).load_registry() "
            "(or load_legacy_registry_dir for pre-store directories)",
            DeprecationWarning, stacklevel=2,
        )
        from repro_torch.serve.artifacts import ArtifactStore, load_legacy_registry_dir

        if ArtifactStore.is_store(path):
            return ArtifactStore(path).load_registry()
        return load_legacy_registry_dir(path)

    # -- queries -------------------------------------------------------
    def __contains__(self, tenant: str) -> bool:
        return tenant in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[str]:
        return iter(tuple(self._entries))

    def get(self, tenant: str) -> ServableCircuit:
        """The tenant's primary (first-registered) member circuit — the
        one whose encoder defines the tenant's feature width."""
        return self._entries[tenant][0]

    def members(self, tenant: str) -> tuple[ServableCircuit, ...]:
        """All member circuits behind one logical tenant (length 1 for
        plain tenants)."""
        return self._entries[tenant]

    @property
    def generation(self) -> int:
        return self._generation

    def catalog(self) -> Catalog:
        """Immutable snapshot of the tenant table for plan compilation.

        This is the registry's entire contract with the planning layer:
        a consumer holding a `Catalog` never observes a half-updated
        registry, and two snapshots with the same generation are
        identical."""
        with self._lock:
            return Catalog(
                tenants=tuple(self._entries),
                members=tuple(self._entries.values()),
                generation=self._generation,
            )
