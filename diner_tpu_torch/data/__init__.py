from diner_tpu_torch.data.loader import BatchLoader, process_local_slice
from diner_tpu_torch.data.synthetic import (SyntheticSphereDataset, collate,
                                            validate_sample)

__all__ = ["BatchLoader", "SyntheticSphereDataset", "collate",
           "process_local_slice", "validate_sample"]
