from diner_tpu_torch.data.synthetic import (SyntheticSphereDataset, collate,
                                            validate_sample)

__all__ = ["SyntheticSphereDataset", "collate", "validate_sample"]
