"""Executors: how the serving steps run on a device."""
from repro_torch.exec.base import Executor  # noqa: F401
from repro_torch.exec.local import LocalExecutor  # noqa: F401
from repro_torch.exec.mesh import MeshExecutor  # noqa: F401
