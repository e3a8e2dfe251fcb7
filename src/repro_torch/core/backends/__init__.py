from repro_torch.core.backends.base import COLLECTIVE_CAPS, Backend
from repro_torch.core.backends.craympi import CrayMpiBackend
from repro_torch.core.backends.exampi import ExaMpiBackend
from repro_torch.core.backends.fabric import Fabric
from repro_torch.core.backends.fabricdirect import FabricDirectBackend
from repro_torch.core.backends.mpich import MpichBackend
from repro_torch.core.backends.openmpi import OpenMpiBackend

BACKENDS = {
    "mpich": MpichBackend,
    "craympi": CrayMpiBackend,
    "openmpi": OpenMpiBackend,
    "exampi": ExaMpiBackend,
    "fabric": FabricDirectBackend,
}


def make_backend(name: str, fabric: Fabric, rank: int, world_size: int) -> Backend:
    return BACKENDS[name](fabric, rank, world_size)


def backend_family(name: str) -> str:
    """Implementation family of a flavor (restart capability translation)."""
    return BACKENDS[name].family


__all__ = ["Backend", "COLLECTIVE_CAPS", "Fabric", "BACKENDS",
           "make_backend", "backend_family",
           "MpichBackend", "CrayMpiBackend", "OpenMpiBackend", "ExaMpiBackend",
           "FabricDirectBackend"]
