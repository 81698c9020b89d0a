# Importing this package registers the built-in backend plugins.
#
# The simulated platforms (serverless://, hpc://, federated://) and the
# wall-clock thread pool (local://) register eagerly, as in the reference.
# The torch device backend is registered lazily, as the reference registers
# its jax backend: the "torch" scheme resolves to a factory that imports
# torchdevice on first use.
from repro_torch.pilot.api import register_backend
from repro_torch.pilot.backends.federated import FederatedBackend
from repro_torch.pilot.backends.hpcsim import HpcSimBackend
from repro_torch.pilot.backends.local import LocalBackend
from repro_torch.pilot.backends.serverless import ServerlessSimBackend

__all__ = ["LocalBackend", "ServerlessSimBackend", "HpcSimBackend",
           "FederatedBackend", "TorchDeviceBackend"]


def _torchdevice_factory(**kwargs):
    from repro_torch.pilot.backends.torchdevice import TorchDeviceBackend
    return TorchDeviceBackend(**kwargs)


register_backend("torch", _torchdevice_factory)


def __getattr__(name):
    if name == "TorchDeviceBackend":
        from repro_torch.pilot.backends.torchdevice import TorchDeviceBackend
        return TorchDeviceBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
