from diner_tpu_torch.data.contract import (SAMPLE_KEYS, collate,
                                           to_device_batch, validate_sample)
from diner_tpu_torch.data.loader import BatchLoader, process_local_slice
from diner_tpu_torch.data.synthetic import SyntheticSphereDataset

__all__ = ["SAMPLE_KEYS", "BatchLoader", "SyntheticSphereDataset", "collate",
           "process_local_slice", "to_device_batch", "validate_sample"]
