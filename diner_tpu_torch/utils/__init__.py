from diner_tpu_torch.utils.stats import weighted_mean_and_std

__all__ = ["weighted_mean_and_std"]
