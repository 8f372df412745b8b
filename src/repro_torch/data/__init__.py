"""Synthetic data of the port (numpy, shared logic with the reference)."""
from repro_torch.data.synthetic import (  # noqa: F401
    ClassClusterData, DeviceDataSource, TokenData, augment_batch,
    label_skew_partition,
)
