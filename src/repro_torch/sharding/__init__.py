"""Sharding over a `torch.distributed` device mesh: the reference's spec
trees (`params`), the port's partition and the ambient mesh (`specs`), and
the collectives over mesh axes (`collectives`)."""
from repro_torch.sharding.specs import (  # noqa: F401
    Mesh,
    MeshAxes,
    constrain,
    logical,
    maybe_constrain,
    spec_for,
    use_mesh_axes,
)
