from reference.losses.losses import (VGG_SLICE_WEIGHTS, antibias_loss,
                                           l1_loss, mse_loss,
                                           vgg_perceptual_loss)

__all__ = ["VGG_SLICE_WEIGHTS", "antibias_loss", "l1_loss", "mse_loss",
           "vgg_perceptual_loss"]
