"""Device resolution, parameter-tree helpers and the dtype policy shared
by the port."""
from repro_torch.common.dtypes import DEFAULT_POLICY, DTypePolicy

__all__ = ["DTypePolicy", "DEFAULT_POLICY"]
