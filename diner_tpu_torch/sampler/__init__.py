from diner_tpu_torch.sampler.depth_guided import (anchor_ids, fill_uniform,
                                                  gather_priors,
                                                  sample_depthguided,
                                                  sample_stratified,
                                                  surface_likelihoods)

__all__ = ["anchor_ids", "fill_uniform", "gather_priors",
           "sample_depthguided", "sample_stratified", "surface_likelihoods"]
